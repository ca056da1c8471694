"""The port's training path against the JAX reference on the CPU: the token
stream, the chunked next-token loss and its gradient, attention gradients,
AdamW, a 5-step trajectory of reduced qwen3-8b from the same numpy init, and
data-parallel training over gloo at world 4 against one rank.

Tolerances (fp32 throughout; the frameworks sum in different orders):
1e-5 on losses and on gradients of one function, 1e-6 relative on AdamW
states after three steps.  Params after several AdamW steps are compared at
2e-4: where a gradient is of the order of eps, a last-bit difference can
flip the sign of its update, whose size is the learning rate (<= 1e-4 per
step here)."""
import os
import re
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import host_batch_slice as jax_batch_slice
from repro.train.train_step import TrainConfig as JaxTrainConfig
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import flash_attention
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               adamw_update, host_batch_slice, init_adamw,
                               loss_and_grad, lr_schedule, make_train_step)
from repro_torch.train.optimizer import AdamWState

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
STATE_RTOL = 1e-6
PARAM_ATOL = 2e-4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def lm_pair(name, remat=False, seed=0):
    cfg_j, cfg_t = jax_reduced(name), reduced_config(name)
    model_j = jax_build(cfg_j, remat=remat)
    pj = model_j.init(jax.random.PRNGKey(seed))
    pt = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, model_j, pj, pt


def close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,step,lo,hi", [(0, 0, 0, 4), (3, 7, 2, 5),
                                             (1, 2, 4, 4)])
def test_token_batches_equal_the_reference(seed, step, lo, hi):
    jc = JaxDataConfig(vocab_size=1000, seq_len=16, global_batch=8,
                       seed=seed)
    tc = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=seed)
    ref = jax_batch_slice(jc, step, lo, hi)["tokens"]
    got = host_batch_slice(tc, step, lo, hi)["tokens"]
    assert got.dtype == torch.int64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------- #
# loss and gradients
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["qwen3-8b", "gemma2-2b"])
@pytest.mark.parametrize("s,masked", [(20, False), (600, False),
                                      (600, True)])
def test_next_token_loss_and_grad_match_jax(name, s, masked):
    """s = 600 runs two LOSS_CHUNK chunks, the second padded."""
    cfg_j, cfg_t, _, pj, pt = lm_pair(name)
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, s), dtype=np.int32)
    mask = (rng.random((2, s)) > 0.3).astype(np.int32) if masked else None

    def jloss(hh):
        return jtf.next_token_loss(pj, cfg_j, hh, jnp.asarray(tokens),
                                   None if mask is None
                                   else jnp.asarray(mask))
    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    got = ttf.next_token_loss(pt, cfg_t, th, torch.from_numpy(tokens),
                              None if mask is None
                              else torch.from_numpy(mask))
    got.backward()
    close(got, ref, 0.0, LOSS_RTOL)
    close(th.grad, ref_grad, GRAD_ATOL)


@pytest.mark.parametrize("name", ["qwen3-8b", "gemma2-2b"])
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_param_grads_match_jax(name, remat):
    cfg_j, cfg_t, model_j, pj, pt = lm_pair(name, remat=remat)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 24), dtype=np.int32)
    (ref, _), grads_j = jax.value_and_grad(model_j.loss, has_aux=True)(
        pj, {"tokens": jnp.asarray(tokens)})
    got, tok = build_model(cfg_t, remat=remat).loss(
        pt, {"tokens": torch.from_numpy(tokens).long()})
    got.backward()
    close(got, ref, 0.0, LOSS_RTOL)
    assert torch.equal(got, tok)
    gj = from_jax_params(cfg_t, jax.tree.map(np.asarray, grads_j),
                         device="cpu")
    for (n, p), (_, g) in zip(pt.named_parameters(), gj.named_parameters()):
        close(p.grad, g.detach().numpy(), GRAD_ATOL, 1e-4)


def test_remat_gives_the_same_gradients():
    cfg = reduced_config("gemma2-2b")
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16))).long()}
    grads = []
    for remat in (False, True):
        model = build_model(cfg, remat=remat)
        params = model.init(3, device="cpu")
        _, g, _ = loss_and_grad(model, params, tokens, TrainConfig())
        grads.append(g)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("spec,cap", [
    (dict(causal=True), None), (dict(causal=True, window=5), 20.0),
    (dict(causal=False), None), (dict(causal=True, prefix_len=4), None)])
def test_attend_gradients_match_jax_grad_of_direct_attend(spec, cap):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 12, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    ct = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = jnp.arange(12)

    def jf(q, k, v):
        out = jattn._direct_attend(q, k, v, pos, pos,
                                   jattn.MaskSpec(**spec), cap)
        return (out * ct).sum()
    ref = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.attend(tq, tk, tv, None, None, tattn.MaskSpec(**spec), cap)
    (out * torch.from_numpy(ct)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        close(t.grad, r, GRAD_ATOL)


def test_flash_wrapper_refuses_inputs_that_require_grad():
    q = torch.randn(1, 4, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, k, k)


def test_attend_under_autograd_beyond_the_direct_path_raises():
    """Beyond 2048 rows under autograd `attend` no longer raises: it takes
    the blockwise path, which agrees with the direct path on the same
    inputs, forward and gradient (tests/test_torch_attention.py holds it
    against the JAX reference)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2049, 2, 16, generator=gen, requires_grad=True)
    k = torch.randn(1, 2049, 1, 16, generator=gen)
    spec = tattn.MaskSpec(causal=True)
    before = tattn.BLOCKWISE.calls
    out = tattn.attend(q, k, k, None, None, spec)
    assert tattn.BLOCKWISE.calls == before + 1
    (grad,) = torch.autograd.grad(out.sum(), q)
    pos = torch.arange(2049)
    q2 = q.detach().requires_grad_()
    ref = tattn._direct_attend(q2, k, k, pos, pos, spec, None)
    (ref_grad,) = torch.autograd.grad(ref.sum(), q2)
    close(out, ref.detach(), GRAD_ATOL)
    close(grad, ref_grad, GRAD_ATOL)


# ---------------------------------------------------------------------- #
# AdamW
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("step", [0, 3, 10, 11, 60, 500])
def test_lr_schedule_matches_jax(step):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    ref = jopt.lr_schedule(jopt.AdamWConfig(lr=1e-3, warmup_steps=10,
                                            total_steps=100),
                           jnp.asarray(step, jnp.int32))
    assert lr_schedule(cfg, step) == pytest.approx(float(ref), rel=1e-6)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "n": (5,), "v": (3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    pj, sj = dict(params), jopt.init_adamw(params)
    pt = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                 for k, v in params.items()})
    st = init_adamw(pt)
    for i in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        pj, sj, mj = jopt.adamw_update(jopt.AdamWConfig(**cfg_kw),
                                       grads, sj, pj)
        pt, st, mt = adamw_update(AdamWConfig(**cfg_kw),
                                  {k: torch.tensor(g)
                                   for k, g in grads.items()}, st, pt)
        assert st.step == int(sj.step) == i + 1
        assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
        close(mt["grad_norm"], mj["grad_norm"], 0.0, STATE_RTOL)
        for k in shapes:
            close(pt[k], pj[k], 1e-7, STATE_RTOL)
            close(st.mu[k], sj.mu[k], 1e-9, STATE_RTOL)
            close(st.nu[k], sj.nu[k], 1e-12, STATE_RTOL)
    assert isinstance(st, AdamWState)


# ---------------------------------------------------------------------- #
# the train step
# ---------------------------------------------------------------------- #

def test_five_step_trajectory_matches_jax():
    """Reduced qwen3-8b, fp32, the launcher's optimizer settings, the same
    numpy init and the same token batches on both sides."""
    steps, b, s = 5, 4, 32
    cfg_j, cfg_t, model_j, pj, pt = lm_pair("qwen3-8b", remat=True)
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=steps)
    step_j = jax.jit(jax_train_step(
        model_j, JaxTrainConfig(optimizer=jopt.AdamWConfig(**opt_kw))))
    step_t = make_train_step(build_model(cfg_t, remat=True),
                             TrainConfig(optimizer=AdamWConfig(**opt_kw)))
    oj, ot = jopt.init_adamw(pj), init_adamw(pt)
    dj = JaxDataConfig(vocab_size=cfg_t.vocab_size, seq_len=s,
                       global_batch=b)
    dt = DataConfig(vocab_size=cfg_t.vocab_size, seq_len=s, global_batch=b)
    for i in range(steps):
        pj, oj, mj = step_j(pj, oj, {"tokens": jnp.asarray(
            jax_batch_slice(dj, i, 0, b)["tokens"])})
        pt, ot, mt = step_t(pt, ot, host_batch_slice(dt, i, 0, b))
        close(mt["loss"], mj["loss"], 0.0, LOSS_RTOL)
        close(mt["token_loss"], mj["token_loss"], 0.0, LOSS_RTOL)
    final = from_jax_params(cfg_t, jax.tree.map(np.asarray, pj),
                            device="cpu")
    for p, r in zip(pt.parameters(), final.parameters()):
        close(p, r.detach().numpy(), PARAM_ATOL)


def test_microbatches_average_to_the_whole_batch():
    cfg = reduced_config("qwen3-8b")
    model = build_model(cfg)
    batch = host_batch_slice(DataConfig(cfg.vocab_size, 16, 4), 0, 0, 4)
    out = []
    for n in (1, 2):
        params = model.init(0, device="cpu")
        loss, grads, tok = loss_and_grad(model, params, batch,
                                         TrainConfig(microbatches=n))
        out.append((loss, grads))
    close(out[1][0], out[0][0].numpy(), 0.0, LOSS_RTOL)
    for k in out[0][1]:
        close(out[1][1][k], out[0][1][k].numpy(), GRAD_ATOL)


# ---------------------------------------------------------------------- #
# data parallel over gloo, and the launcher
# ---------------------------------------------------------------------- #

DP_SCRIPT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    STEPS, B, S, WORLD = 2, 4, 32, 4

    def worker(rank, port, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", world_size=WORLD, rank=rank,
                                init_method=f"tcp://localhost:{port}")
        from repro_torch.comms import P2P, CollectiveContext
        from repro_torch.configs import reduced_config
        from repro_torch.models import build_model
        from repro_torch.train import (AdamWConfig, DataConfig,
                                       TrainConfig, host_batch_slice,
                                       init_train_state, make_train_step)
        cfg = reduced_config("qwen3-8b")
        model = build_model(cfg, remat=True)
        tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                                               total_steps=STEPS))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                        global_batch=B)
        red = CollectiveContext({"data": WORLD}).bucketed_allreduce(
            "data", P2P(), wire_dtype=None)

        def pipeline(tree):
            return {k: v / WORLD for k, v in red(tree).items()}

        def nccl_style(tree):
            for v in tree.values():
                dist.all_reduce(v)
            return {k: v / WORLD for k, v in tree.items()}

        res = {}
        for name, hook in (("pipeline", pipeline), ("torch", nccl_style)):
            params, opt = init_train_state(model, 0, "cpu")
            step = make_train_step(model, tc, grad_reduce=hook)
            per = B // WORLD
            for i in range(STEPS):
                batch = host_batch_slice(dc, i, rank * per, (rank + 1) * per)
                params, opt, m = step(params, opt, batch)
                res[f"{name}/loss{i}"] = m["loss"].numpy()
            for n, p in params.named_parameters():
                res[f"{name}/{n}"] = p.detach().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]),
                 nprocs=WORLD, join=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_data_parallel_world4_matches_one_rank(tmp_path):
    (tmp_path / "dp.py").write_text(DP_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "dp.py"), str(_free_port()),
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    # one rank over the whole global batch
    cfg = reduced_config("qwen3-8b")
    model = build_model(cfg, remat=True)
    params, opt = model.init(0, device="cpu"), None
    opt = init_adamw(params)
    step = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=2)))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    losses = []
    for i in range(2):
        params, opt, m = step(params, opt, host_batch_slice(dc, i, 0, 4))
        losses.append(float(m["loss"]))
    for name in ("pipeline", "torch"):
        for r in range(4):
            for i in range(2):
                assert float(ranks[r][f"{name}/loss{i}"]) == \
                    pytest.approx(losses[i], rel=LOSS_RTOL)
            for n, p in params.named_parameters():
                # the replicas stay identical, and close to one rank's run
                np.testing.assert_array_equal(ranks[r][f"{name}/{n}"],
                                              ranks[0][f"{name}/{n}"])
                close(p, ranks[r][f"{name}/{n}"], PARAM_ATOL)


def test_launch_train_pipeline_at_world4_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--data-parallel", "4", "--collectives",
         "pipeline", "--steps", "2", "--global-batch", "4", "--seq", "32",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert re.fullmatch(r"done at step 2; stragglers: \d+; link faults "
                        r"repaired: False", lines[-1]), out.stdout
    assert any(l.startswith("  axis data: data-ring4") for l in lines)
    assert sum(l.startswith("step ") for l in lines) == 2


def test_launch_train_one_rank_runs_no_collective(capsys, tmp_path):
    records = launch_train.run(launch_train.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "2", "--global-batch",
         "2", "--seq", "16", "--collectives", "pipeline", "--ckpt-dir",
         str(tmp_path)]))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "data-parallel 1: no collective runs"
    assert re.fullmatch(r"done at step 2; stragglers: \d+; link faults "
                        r"repaired: False", out[-1])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)


def test_launch_train_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--reduced", "--steps", "1",
                           "--data-parallel", "2", "--global-batch", "2"])


def test_trace_tool_refuses_to_run_without_a_card():
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "tools/trace_torch_train.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout == ""

