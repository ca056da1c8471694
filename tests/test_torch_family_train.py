"""Training of the moe, ssm, hybrid, vlm and audio families against the JAX
reference on the CPU: `Model.loss` and every parameter's gradient against
`jax.value_and_grad(model.loss)`, 3-step trajectories against
`make_train_step`, the frontend streams of `train.data`, the train
launcher, and one loss and one prefill for every config of the registry.

Tolerances (fp32): those of tests/test_torch_train.py: 1e-5 relative on
losses, 1e-5 absolute plus 1e-4 relative on the gradients of one loss,
2e-4 on params after several AdamW steps (a gradient of the order of eps
can flip the sign of its update, whose size is the learning rate)."""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import host_batch_slice as jax_batch_slice
from repro.train.train_step import TrainConfig as JaxTrainConfig
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               host_batch_slice, init_adamw, make_train_step)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 2e-4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def reference_key(name):
    """The reference's stream key (`_rng_for`), salted per process."""
    return hash(name) & 0x7FFFFFFF


def close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


def data_configs(cfg, seq, batch, seed=0):
    """The reference's and the port's DataConfig, as the launchers build
    them."""
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
              seed=seed, num_image_tokens=cfg.num_image_tokens,
              encoder_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
              d_model=cfg.d_model)
    return JaxDataConfig(**kw), DataConfig(**kw)


def batches(cfg, seq, batch, step=0):
    """The same batch for both sides: (jax dict, torch dict)."""
    dj, dt = data_configs(cfg, seq, batch)
    bj = jax_batch_slice(dj, step, 0, batch)
    bt = host_batch_slice(dt, step, 0, batch, key=reference_key)
    return {k: jnp.asarray(v) for k, v in bj.items()}, bt


# ---------------------------------------------------------------------- #
# losses and gradients
# ---------------------------------------------------------------------- #

LOSS_CASES = [("qwen2-moe-a2.7b", 24), ("mixtral-8x7b", 24),
              ("mamba2-780m", 32), ("mamba2-780m", 20),
              ("zamba2-1.2b", 32), ("zamba2-1.2b", 20),
              ("paligemma-3b", 12), ("whisper-medium", 12)]


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(name, seq):
    """JAX's (loss, token loss, grads as numpy) of reduced `name` on a
    batch of 2 x seq, jitted; computed once for both remat settings of the
    port (the reference's remat changes no value)."""
    model_j = jax_build(jax_reduced(name))
    pj = model_j.init(jax.random.PRNGKey(1))
    bj, _ = batches(reduced_config(name), seq, 2)
    (ref, tok), grads = jax.jit(jax.value_and_grad(
        model_j.loss, has_aux=True))(pj, bj)
    return (float(ref), float(tok), jax.tree.map(np.asarray, pj),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("name,seq", LOSS_CASES)
@pytest.mark.parametrize("remat", [False, True])
def test_model_loss_and_param_grads_match_jax(name, seq, remat):
    """Sequences of 32 are a multiple of the reduced SSM chunk (16): the
    chunked scan; 20 is not: the sequential recurrence.  For a config with
    experts total - token loss = 0.01 * aux, which is not 0."""
    cfg_t = reduced_config(name)
    ref, ref_tok, tree, grads_j = reference_loss_and_grads(name, seq)
    pt = from_jax_params(cfg_t, tree, device="cpu")
    _, bt = batches(cfg_t, seq, 2)
    got, tok = build_model(cfg_t, remat=remat).loss(pt, bt)
    got.backward()
    close(got, ref, 0.0, LOSS_RTOL)
    close(tok, ref_tok, 0.0, LOSS_RTOL)
    if cfg_t.num_experts:
        aux = ref - ref_tok
        assert aux > 1e-4
        assert float((got - tok).detach()) == pytest.approx(aux, rel=1e-3)
    else:
        assert torch.equal(got, tok)
    gj = from_jax_params(cfg_t, grads_j, device="cpu")
    for (n, p), (_, g) in zip(pt.named_parameters(), gj.named_parameters()):
        assert p.grad is not None, n
        close(p.grad, g.detach().numpy(), GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "mamba2-780m",
                                  "zamba2-1.2b", "paligemma-3b",
                                  "whisper-medium"])
def test_three_step_trajectory_matches_jax(name):
    """Reduced configs, fp32, the launcher's optimizer settings and remat,
    the same numpy init and the same batches (frontends included)."""
    steps, b, s = 3, 2, 16
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    model_j = jax_build(cfg_j, remat=True)
    pj = model_j.init(jax.random.PRNGKey(2))
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=steps)
    step_j = jax.jit(jax_train_step(
        model_j, JaxTrainConfig(optimizer=jopt.AdamWConfig(**opt_kw))))
    step_t = make_train_step(build_model(cfg_t, remat=True),
                             TrainConfig(optimizer=AdamWConfig(**opt_kw)))
    oj, ot = jopt.init_adamw(pj), init_adamw(pt)
    for i in range(steps):
        bj, bt = batches(cfg_t, s, b, step=i)
        pj, oj, mj = step_j(pj, oj, bj)
        pt, ot, mt = step_t(pt, ot, bt)
        close(mt["loss"], mj["loss"], 0.0, LOSS_RTOL)
        close(mt["token_loss"], mj["token_loss"], 0.0, LOSS_RTOL)
    final = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj),
                            device="cpu")
    for p, r in zip(pt.parameters(), final.parameters()):
        close(p, r.detach().numpy(), PARAM_ATOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_builds_trains_and_prefills(name):
    """Reduced, on the CPU: a finite loss whose gradient reaches every
    parameter, then a prefill's last-position logits."""
    cfg = reduced_config(name)
    model = build_model(cfg, remat=True)
    params = model.init(0, device="cpu")
    _, dt = data_configs(cfg, 16, 2)
    batch = host_batch_slice(dt, 0, 0, 2)
    loss, _ = model.loss(params, batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params.parameters())
    with torch.inference_mode():
        state = model.init_decode_state(2, 64, device="cpu")
        _, logits = model.prefill(params, batch, state)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_train_step_casts_frontend_embeddings_to_the_compute_dtype():
    """bf16 compute from fp32 masters: the float32 patches are cast (a
    bf16 weight cannot multiply a float32 row), the tokens are not."""
    cfg = reduced_config("paligemma-3b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    _, dt = data_configs(cfg, 8, 2)
    batch = host_batch_slice(dt, 0, 0, 2)
    assert batch["patch_embed"].dtype == torch.float32
    seen = {}
    orig = model.loss

    def loss(p, b):
        seen.update({k: v.dtype for k, v in b.items()})
        return orig(p, b)
    model.loss = loss
    step = make_train_step(model, TrainConfig(compute_dtype=torch.bfloat16))
    _, _, metrics = step(params, init_adamw(params), batch)
    assert seen == {"tokens": torch.int64, "patch_embed": torch.bfloat16}
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-medium"])
@pytest.mark.parametrize("step,lo,hi", [(0, 0, 2), (3, 1, 4)])
def test_frontend_streams_equal_the_reference_draw(name, step, lo, hi):
    """Given the reference's in-process key, every entry equals its draw
    (tokens, and patch_embed or audio_embed)."""
    dj, dt = data_configs(reduced_config(name), 8, 4, seed=5)
    ref = jax_batch_slice(dj, step, lo, hi)
    got = host_batch_slice(dt, step, lo, hi, key=reference_key)
    assert set(got) == set(ref) and len(got) == 2
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert got["tokens"].dtype == torch.int64
    emb = [k for k in got if k != "tokens"][0]
    assert got[emb].dtype == torch.float32


STREAM_SCRIPT = textwrap.dedent("""
    import hashlib
    from repro_torch.train.data import DataConfig, host_batch_slice
    dc = DataConfig(100, 8, 2, 0, num_image_tokens=4, encoder_seq=3,
                    d_model=8)
    for key in (None, lambda n: hash(n) & 0x7FFFFFFF):
        kw = {} if key is None else {"key": key}
        out = host_batch_slice(dc, 0, 0, 2, **kw)
        print(hashlib.sha256(b"".join(out[k].numpy().tobytes()
                                      for k in sorted(out))).hexdigest())
""")


def test_default_stream_is_the_same_in_every_process():
    """Two interpreters with different hash salts: the default key gives
    one stream; the reference's key gives two."""
    outs = []
    for salt in ("1", "2"):
        proc = subprocess.run(
            [sys.executable, "-c", STREAM_SCRIPT], capture_output=True,
            text=True, timeout=120, check=True,
            env=dict(os.environ, PYTHONPATH=SRC, PYTHONHASHSEED=salt))
        outs.append(proc.stdout.split())
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] != outs[1][1]


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b", "paligemma-3b",
                                  "whisper-medium"])
def test_launch_train_runs_every_family_on_cpu(capsys, tmp_path, name):
    rc = launch_train.main(["--arch", name, "--reduced", "--device", "cpu",
                            "--steps", "2", "--global-batch", "2", "--seq",
                            "16", "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    losses = [float(l.split()[3]) for l in out if l.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out[-1].startswith("done at step 2;")
