"""The port's blockwise attention against the JAX reference on the CPU.

Above 2048 rows both packages take the blockwise online softmax: 1024-row
query and kv blocks, float32 softmax state, only the window-adjacent kv
blocks under a sliding window, each kv block's step recomputed in the
backward.  The same numpy inputs and cotangent go through the JAX `attend`
under `jax.vjp` and the port's `attend` under autograd; the forward and the
gradients of q, k and v agree within 1e-5 (float32; the frameworks sum in
different orders).  A reduced qwen3-8b train step at 2304 rows is held
against the reference's `make_train_step`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import host_batch_slice as jax_batch_slice
from repro.train.train_step import TrainConfig as JaxTrainConfig
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               host_batch_slice, init_adamw, make_train_step)

torch.set_num_threads(1)

ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4     # one AdamW step of lr 1e-4 may flip sign near eps

# (heads, kv heads, query rows - kv rows, mask, softcap)
CASES = {
    "causal": (4, 4, 0, dict(causal=True), None),
    "causal_gqa": (4, 2, 0, dict(causal=True), None),
    "window1500_gqa": (4, 2, 0, dict(causal=True, window=1500), None),
    "window3000_gqa": (4, 2, 0, dict(causal=True, window=3000), None),
    "softcap50_gqa": (4, 2, 0, dict(causal=True), 50.0),
    "s_ne_t_gqa": (4, 2, 300, dict(causal=True), None),
}


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got.detach()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("s", [2304, 4096])
@pytest.mark.parametrize("case", list(CASES))
def test_blockwise_forward_and_grads_match_jax(s, case):
    h, hkv, less, mask, cap = CASES[case]
    t = s - less
    d = 16
    rng = np.random.default_rng(s + len(case))
    q = rng.standard_normal((1, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    ct = rng.standard_normal((1, s, h, d)).astype(np.float32)
    spec_j, spec_t = jattn.MaskSpec(**mask), tattn.MaskSpec(**mask)

    def jf(q, k, v):
        return jattn.attend(q, k, v, jnp.arange(s), jnp.arange(t), spec_j,
                            cap)
    ref, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(ct))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = tattn.BLOCKWISE.calls
    out = tattn.attend(tq, tk, tv, None, None, spec_t, cap)
    assert tattn.BLOCKWISE.calls == before + 1
    (out * torch.from_numpy(ct)).sum().backward()
    assert tattn.BLOCKWISE.calls == before + 1     # the backward recomputes
    close(out, ref, ATOL)                          # blocks, not the call
    for got, r in zip((tq, tk, tv), ref_grads):
        close(got.grad, r, ATOL)


def test_blockwise_without_autograd_matches_jax_forward():
    """A CPU prefill over 2304 rows: the blockwise path without autograd
    (no recomputation) gives the same forward."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 2304, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2304, 1, 16)).astype(np.float32)
            for _ in range(2))
    spec = dict(causal=True, window=1500)
    ref = jattn.attend(*map(jnp.asarray, (q, k, v)), jnp.arange(2304),
                       jnp.arange(2304), jattn.MaskSpec(**spec), 30.0)
    with torch.inference_mode():
        got = tattn.attend(*map(torch.from_numpy, (q, k, v)), None, None,
                           tattn.MaskSpec(**spec), 30.0)
    close(got, ref, ATOL)


def test_window_visits_only_the_adjacent_kv_blocks(monkeypatch):
    """At 4096 rows and window 1500 each query block visits
    min(4, ceil((1500 + 1024) / 1024) + 1) = 4 kv blocks; at window 500,
    3; causal without a window, all 4."""
    visits = []
    step = tattn._kv_step

    def counting(*args):
        visits.append(1)
        return step(*args)
    monkeypatch.setattr(tattn, "_kv_step", counting)
    x = torch.zeros(1, 4096, 1, 16)
    for window, per_block in ((1500, 4), (500, 3), (None, 4)):
        visits.clear()
        tattn.attend(x, x, x, None, None,
                     tattn.MaskSpec(causal=True, window=window))
        assert len(visits) == 4 * per_block


def test_train_step_at_2304_rows_matches_jax():
    """Reduced qwen3-8b, fp32, one step of 1 x 2304 tokens from the same
    numpy init: every attention layer takes the blockwise path, inside the
    per-layer recomputation, on both sides."""
    b, s = 1, 2304
    cfg_j, cfg_t = jax_reduced("qwen3-8b"), reduced_config("qwen3-8b")
    model_j = jax_build(cfg_j, remat=True)
    pj = model_j.init(jax.random.PRNGKey(0))
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=1)
    step_j = jax.jit(jax_train_step(
        model_j, JaxTrainConfig(optimizer=jopt.AdamWConfig(**opt_kw))))
    step_t = make_train_step(build_model(cfg_t, remat=True),
                             TrainConfig(optimizer=AdamWConfig(**opt_kw)))
    dj = JaxDataConfig(vocab_size=cfg_t.vocab_size, seq_len=s,
                       global_batch=b)
    dt = DataConfig(vocab_size=cfg_t.vocab_size, seq_len=s, global_batch=b)
    pj, _, mj = step_j(pj, jopt.init_adamw(pj), {"tokens": jnp.asarray(
        jax_batch_slice(dj, 0, 0, b)["tokens"])})
    before = tattn.BLOCKWISE.calls
    pt, _, mt = step_t(pt, init_adamw(pt), host_batch_slice(dt, 0, 0, b))
    # forward and recomputation of every layer
    assert tattn.BLOCKWISE.calls - before == 2 * cfg_t.num_layers
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=LOSS_RTOL)
    final = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj),
                            device="cpu")
    for p, r in zip(pt.parameters(), final.parameters()):
        close(p, r.detach().numpy(), PARAM_ATOL)
