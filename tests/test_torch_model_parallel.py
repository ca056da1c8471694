"""The port's model axis on the CPU over gloo ranks: tensor-parallel
prefill and decode of the dense, moe, vlm and audio families at mp 2 and
4 against the JAX reference on one device (the same weights, carried by
from_jax_params), FSDP+TP training at (data, model) = (2, 2) and (1, 4)
against the reference's one-device train step on the same global batch
(and, under the supervisor, a crash restored from each rank's shards),
the tree broadcast of serving's parameters over the model axis (healthy,
with a failed link, and over the model groups of a (2, 2) mesh), and both
launchers' --model-parallel paths, every family.  The ssm and hybrid
families' parity runs through this harness from
tests/test_torch_ssm_model_parallel.py.

The ranks run in a subprocess (`torch.multiprocessing`, one thread each)
that writes what the test compares.  Tolerances (float32; the ranks sum
partial products in another order than one device): 1e-4 on logits, as
the port's other logits tests; the train trajectory to those of
tests/test_torch_train.py: 1e-5 on losses, 2e-4 on params, and the AdamW
moments 1e-6 relative above the absolute difference the gradients'
tolerance (1e-5) carries into them over three steps (mu sums
(1 - b1) b1^k g, nu sums (1 - b2) b2^k g^2; one rank of the port differs
from the reference by as much, since the gradients are summed in another
order); the broadcast bit for bit."""
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
from repro.models import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import host_batch_slice as jax_batch_slice
from repro.train.train_step import TrainConfig as JaxTrainConfig
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.models import build_model

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
STATE_RTOL = 1e-6
PARAM_ATOL = 2e-4
B1, B2 = 0.9, 0.95              # AdamWConfig's defaults, on both sides
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TP_ARCHS = ["qwen3-8b", "qwen2-moe-a2.7b", "paligemma-3b", "whisper-medium"]
TRAIN_ARCHS = ["qwen3-8b", "qwen2-moe-a2.7b"]
B, S, DECODE_STEPS, TRAIN_STEPS = 2, 12, 3, 3

RANKS_SCRIPT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def nested(flat):
        tree = {}
        for key, value in flat.items():
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
        return tree

    def whole(t):
        from torch.distributed.tensor import DTensor
        return t.full_tensor() if isinstance(t, DTensor) else t

    def serve_job(rank, world, out, archs):
        from repro_torch.comms import P2P, CollectiveContext, tree_broadcast
        from repro_torch.configs import reduced_config
        from repro_torch.convert import from_jax_params
        from repro_torch.launch import sharding as sh
        from repro_torch.launch.mesh import make_mesh, mesh_axis_sizes
        from repro_torch.models import attention, build_model
        mesh = make_mesh(1, world, "cpu")
        sizes = mesh_axis_sizes(mesh)
        res = {}
        head_dim_calls = [0]
        route = attention._attend_head_dim

        def counted(*args):
            head_dim_calls[0] += 1
            return route(*args)
        attention._attend_head_dim = counted
        for key in archs:       # an arch, or "arch:tag" for another input
            cfg = reduced_config(key.split(":")[0])
            model = build_model(cfg)
            params = from_jax_params(cfg, nested(dict(np.load(
                os.path.join(out, key + ".npz")))), device="cpu")
            sh.distribute_module(params, mesh,
                                 sh.serving_param_specs(params, sizes))
            feed = {k: torch.from_numpy(v) for k, v in
                    np.load(os.path.join(out, key + "_in.npz")).items()}
            steps = int(feed.pop("decode_steps", DECODE_STEPS))
            head_dim_calls[0] = 0
            s = feed["tokens"].shape[1]
            prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
            state = model.init_decode_state(B, s + prefix + 8,
                                            device="cpu")
            state = sh.distribute_tree(state, mesh, sh.decode_state_specs(
                state, cfg, sizes))
            with torch.no_grad():
                state, logits = model.prefill(params, feed, state)
                logits = whole(logits)
                res[key + "/prefill"] = logits.numpy()
                for i in range(steps):
                    tok = torch.argmax(logits[:, -1], -1)[:, None]
                    res[f"{key}/tok{i}"] = tok.numpy()
                    logits, state = model.decode_step(params, tok, state,
                                                      s + prefix + i)
                    logits = whole(logits)
                    res[f"{key}/decode{i}"] = logits.numpy()
            res[key + "/head_dim_calls"] = np.int64(head_dim_calls[0])
        # the params' tree broadcast over the model axis: rank 0's leaves
        # reach every rank, over the healthy and the degraded program
        ctx = CollectiveContext({"data": 1, "model": world})
        comm = P2P(mesh.get_group("model"))
        gen = torch.Generator().manual_seed(100 + rank)
        leaves = [torch.randn(shape, generator=gen) for shape in
                  ((64, 48), (5,), (3, 7, 11))]
        progs = [("healthy", ctx.broadcast_program("model", root=0))]
        if world > 2:
            ctx.hot_swap("@fail(0-1)")
            progs.append(("fail01", ctx.broadcast_program("model", root=0)))
        for tag, prog in progs:
            for j, x in enumerate(leaves):
                res[f"bcast/{tag}/{j}/sent"] = x.numpy()
                res[f"bcast/{tag}/{j}/got"] = tree_broadcast(
                    x, prog, comm).numpy()
        if world == 4:
            # over the model groups {0, 1} and {2, 3} of a (2, 2) mesh: the
            # group's ranks map to global ranks
            sub = make_mesh(2, 2, "cpu")
            prog = CollectiveContext({"data": 2, "model": 2}) \
                .broadcast_program("model", root=0)
            comm = P2P(sub.get_group("model"))
            for j, x in enumerate(leaves):
                res[f"sub/{j}/got"] = tree_broadcast(x, prog, comm).numpy()
        return res

    def train_job(rank, world, dp, out, archs):
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import reduced_config
        from repro_torch.convert import from_jax_params
        from repro_torch.launch import sharding as sh
        from repro_torch.launch.mesh import make_mesh, mesh_axis_sizes
        from repro_torch.launch.train import _placed_batch
        from repro_torch.models import build_model
        from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                       host_batch_slice, init_adamw,
                                       make_train_step)
        mesh = make_mesh(dp, world // dp, "cpu")
        sizes = mesh_axis_sizes(mesh)
        data_rank = mesh.get_local_rank("data")
        res = {}
        for arch in archs:
            cfg = reduced_config(arch)
            model = build_model(cfg, remat=True)
            params = from_jax_params(cfg, nested(dict(np.load(
                os.path.join(out, arch + ".npz")))), device="cpu")
            sh.distribute_module(params, mesh, sh.param_specs(params, sizes))
            opt = init_adamw(params)
            step = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
                lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)))
            dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4)
            per = 4 // dp
            for i in range(TRAIN_STEPS):
                rows = host_batch_slice(dc, i, data_rank * per,
                                        (data_rank + 1) * per)
                params, opt, m = step(params, opt,
                                      _placed_batch(rows, 4, mesh))
                res[f"{arch}/loss{i}"] = np.float32(m["loss"])
                res[f"{arch}/token_loss{i}"] = np.float32(m["token_loss"])
            for n, p in params.named_parameters():
                assert isinstance(p, DTensor)
                res[f"{arch}/param/{n}"] = whole(p.detach()).numpy()
                res[f"{arch}/mu/{n}"] = whole(opt.mu[n]).numpy()
                res[f"{arch}/nu/{n}"] = whole(opt.nu[n]).numpy()
        res["supervised"] = supervised(rank, mesh, sizes, data_rank, dp,
                                       out, archs[0])
        return res

    def supervised(rank, mesh, sizes, data_rank, dp, out, arch):
        # [(step, loss)] under TrainSupervisor with placed state, a
        # checkpoint every 2 steps into this rank's directory, and a crash
        # once after step 2 is computed: the supervisor restores each
        # rank's shards of step 2 and replays
        from repro_torch.configs import reduced_config
        from repro_torch.convert import from_jax_params
        from repro_torch.launch import sharding as sh
        from repro_torch.launch.train import _placed_batch
        from repro_torch.models import build_model
        from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                       TrainSupervisor, host_batch_slice,
                                       init_adamw, make_train_step)
        cfg = reduced_config(arch)
        model = build_model(cfg, remat=True)
        params = from_jax_params(cfg, nested(dict(np.load(
            os.path.join(out, arch + ".npz")))), device="cpu")
        sh.distribute_module(params, mesh, sh.param_specs(params, sizes))
        step = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
            lr=1e-3, warmup_steps=10, total_steps=4)))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=4)
        per, seen = 4 // dp, []

        def step_fn(i, state):
            rows = host_batch_slice(dc, i, data_rank * per,
                                    (data_rank + 1) * per)
            p, o, m = step(*state, _placed_batch(rows, 4, mesh))
            seen.append((i, float(m["loss"])))
            if i == 2 and len(seen) == 3:
                raise RuntimeError("injected crash after the step")
            return (p, o), m

        sup = TrainSupervisor(ckpt_dir=os.path.join(out, f"ckpt{rank}"),
                              ckpt_every=2, max_restarts=1)
        sup.run(state=(params, init_adamw(params)), num_steps=4,
                step_fn=step_fn, log_every=0, log=lambda *a: None)
        return np.array(seen)

    def worker(rank, world, dp, port, job, out, archs):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", world_size=world, rank=rank,
                                init_method=f"tcp://localhost:{port}")
        if job == "serve":
            res = serve_job(rank, world, out, archs)
        else:
            res = train_job(rank, world, dp, out, archs)
        np.savez(os.path.join(out, f"{job}{world}x{dp}_rank{rank}.npz"),
                 **res)
        dist.destroy_process_group()

    B, S, DECODE_STEPS, TRAIN_STEPS = %(consts)s

    if __name__ == "__main__":
        job, world, dp, port, out = sys.argv[1:6]
        mp.spawn(worker, args=(int(world), int(dp), int(port), job, out,
                               sys.argv[6].split(",")),
                 nprocs=int(world), join=True)
""") % {"consts": f"{B}, {S}, {DECODE_STEPS}, {TRAIN_STEPS}"}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def jax_pair(arch, seed=0):
    """(jax cfg, port cfg, jax params, port module) with equal weights; the
    norms (zero at init) get random values so (1 + w) is exercised."""
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    tree = jax.tree.map(np.asarray, jax_build(cfg_j).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        last = path[-1].key
        if last.startswith("ln_") or last in ("q_norm", "k_norm",
                                              "final_norm", "enc_norm"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg_j, cfg_t, tree, from_jax_params(cfg_t, tree, device="cpu")


def feed_of(cfg, seed=1):
    rng = np.random.default_rng(seed)
    feed = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
        np.int64)}
    if cfg.family == "vlm":
        feed["patch_embed"] = (rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    if cfg.family == "audio":
        feed["audio_embed"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return feed


def run_ranks(tmp_path, job, world, dp, archs):
    (tmp_path / "ranks.py").write_text(RANKS_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "ranks.py"), job, str(world),
         str(dp), str(_free_port()), str(tmp_path), ",".join(archs)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-4000:]
    return [dict(np.load(tmp_path / f"{job}{world}x{dp}_rank{r}.npz"))
            for r in range(world)]


# ---------------------------------------------------------------------- #
# tensor-parallel prefill and decode, and the params' broadcast
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("mp", [2, 4])
def test_tp_prefill_and_decode_match_jax_and_one_rank(mp, tmp_path):
    refs = {}
    for arch in TP_ARCHS:
        cfg_j, cfg_t, tree, pt = jax_pair(arch)
        feed = feed_of(cfg_t)
        np.savez(tmp_path / f"{arch}.npz", **flat(tree))
        np.savez(tmp_path / f"{arch}_in.npz", **feed)
        prefix = cfg_t.num_image_tokens if cfg_t.family == "vlm" else 0
        mj = jax_build(cfg_j)
        _, ref = mj.prefill(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
             for k, v in feed.items()},
            mj.init_decode_state(B, S + prefix + 8))
        # one rank of the port: the greedy tokens and decode logits
        model = build_model(cfg_t)
        state = model.init_decode_state(B, S + prefix + 8, device="cpu")
        with torch.no_grad():
            state, logits = model.prefill(
                pt, {k: torch.from_numpy(v) for k, v in feed.items()},
                state)
            one = []
            for i in range(DECODE_STEPS):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                logits, state = model.decode_step(pt, tok, state,
                                                  S + prefix + i)
                one.append((tok.numpy(), logits.numpy()))
        refs[arch] = (np.asarray(ref), one)
    ranks = run_ranks(tmp_path, "serve", mp, 1, TP_ARCHS)
    got = ranks[0]
    for arch, (ref, one) in refs.items():
        np.testing.assert_allclose(got[arch + "/prefill"], ref,
                                   atol=LOGIT_ATOL, rtol=0, err_msg=arch)
        for i, (tok, logits) in enumerate(one):
            np.testing.assert_array_equal(got[f"{arch}/tok{i}"], tok,
                                          err_msg=arch)
            np.testing.assert_allclose(got[f"{arch}/decode{i}"], logits,
                                       atol=LOGIT_ATOL, rtol=0,
                                       err_msg=arch)
    # the broadcast: every rank holds model rank 0's leaves, bit for bit
    if mp == 4:
        for j in range(3):
            for r in range(mp):
                np.testing.assert_array_equal(
                    ranks[r][f"sub/{j}/got"],
                    ranks[r - r % 2][f"bcast/healthy/{j}/sent"])
    tags = {k.split("/")[1] for k in got if k.startswith("bcast/")}
    assert tags == ({"healthy", "fail01"} if mp > 2 else {"healthy"})
    for tag in tags:
        for j in range(3):
            sent = ranks[0][f"bcast/{tag}/{j}/sent"]
            for r in range(mp):
                assert not r or not np.array_equal(
                    ranks[r][f"bcast/{tag}/{j}/sent"], sent)
                np.testing.assert_array_equal(
                    ranks[r][f"bcast/{tag}/{j}/got"], sent)


HEAD_DIM_ARCHS = ["qwen3-8b", "gemma2-2b"]
HEAD_DIM_STEPS = 4


def test_tp_decode_over_a_head_dim_cache_matches_jax_and_one_rank(
        tmp_path):
    """At mp 4 the reduced models' 2 kv heads do not divide "model", so
    the cache lies split on head_dim (`decode_state_specs`) and every
    decode step contracts each rank's slice and all-reduces the logits
    (`attention._attend_head_dim`, once per layer and step), the cache
    never gathered.  4 greedy tokens equal the plain path's and the
    reference's, every decode step's logits within LOGIT_ATOL of both;
    gemma2-2b adds its softcap and sliding window to the route."""
    refs = {}
    for arch in HEAD_DIM_ARCHS:
        cfg_j, cfg_t, tree, pt = jax_pair(arch)
        feed = feed_of(cfg_t)
        np.savez(tmp_path / f"{arch}.npz", **flat(tree))
        np.savez(tmp_path / f"{arch}_in.npz", decode_steps=HEAD_DIM_STEPS,
                 **feed)
        mj = jax_build(cfg_j)
        params = jax.tree.map(jnp.asarray, tree)
        jstate, jlogits = mj.prefill(
            params, {"tokens": jnp.asarray(feed["tokens"], jnp.int32)},
            mj.init_decode_state(B, S + 8))
        model = build_model(cfg_t)
        state = model.init_decode_state(B, S + 8, device="cpu")
        steps = []
        with torch.no_grad():
            state, logits = model.prefill(
                pt, {"tokens": torch.from_numpy(feed["tokens"])}, state)
            for i in range(HEAD_DIM_STEPS):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                jtok = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None]
                np.testing.assert_array_equal(tok.numpy(), jtok)
                logits, state = model.decode_step(pt, tok, state, S + i)
                jlogits, jstate = mj.decode_step(
                    params, jnp.asarray(jtok, jnp.int32), jstate,
                    jnp.asarray(S + i, jnp.int32))
                steps.append((tok.numpy(), logits.numpy(),
                              np.asarray(jlogits)))
        refs[arch] = steps
    got = run_ranks(tmp_path, "serve", 4, 1, HEAD_DIM_ARCHS)[0]
    for arch, steps in refs.items():
        assert got[arch + "/head_dim_calls"] == \
            reduced_config(arch).num_layers * HEAD_DIM_STEPS, arch
        for i, (tok, logits, jlogits) in enumerate(steps):
            np.testing.assert_array_equal(got[f"{arch}/tok{i}"], tok,
                                          err_msg=arch)
            for want in (logits, jlogits):
                np.testing.assert_allclose(got[f"{arch}/decode{i}"], want,
                                           atol=LOGIT_ATOL, rtol=0,
                                           err_msg=f"{arch} step {i}")


# ---------------------------------------------------------------------- #
# FSDP + TP training
# ---------------------------------------------------------------------- #

def moment_atol(kind, ported, name):
    """The absolute difference a gradient difference of GRAD_ATOL makes in
    a moment after TRAIN_STEPS steps: (1 - b1^n) GRAD_ATOL in mu, and
    2 (1 - b2^n) g_max GRAD_ATOL in nu, g_max bounded by the reference's
    sqrt(nu / (1 - b2^n))."""
    n = TRAIN_STEPS
    if kind == "mu":
        return (1 - B1 ** n) * GRAD_ATOL
    nu = dict(ported["nu"].named_parameters())[name].detach()
    g_max = float(torch.sqrt(nu.max() / (1 - B2 ** n)))
    return 2 * (1 - B2 ** n) * g_max * GRAD_ATOL


def jax_train_refs(arch, tree):
    """The reference's one-device train step from `tree`, TRAIN_STEPS
    steps of 4 x 32 tokens: ([(loss, token loss)], the params and AdamW
    moments after them as port modules)."""
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    step_j = jax.jit(jax_train_step(
        jax_build(cfg_j, remat=True),
        JaxTrainConfig(optimizer=jopt.AdamWConfig(**opt_kw))))
    pj = jax.tree.map(jnp.asarray, tree)
    oj = jopt.init_adamw(pj)
    dj = JaxDataConfig(vocab_size=cfg_t.vocab_size, seq_len=32,
                       global_batch=4)
    losses = []
    for i in range(TRAIN_STEPS):
        pj, oj, mj = step_j(pj, oj, {"tokens": jnp.asarray(
            jax_batch_slice(dj, i, 0, 4)["tokens"])})
        losses.append((float(mj["loss"]), float(mj["token_loss"])))
    ported = {
        "param": from_jax_params(cfg_t, jax.tree.map(np.asarray, pj),
                                 device="cpu"),
        "mu": from_jax_params(cfg_t, jax.tree.map(np.asarray, oj.mu),
                              device="cpu"),
        "nu": from_jax_params(cfg_t, jax.tree.map(np.asarray, oj.nu),
                              device="cpu")}
    return losses, ported


def check_train(got, refs, first):
    """Rank 0's records against the references of every arch, and the
    supervised run of `first` (the harness's first arch)."""
    # the crash after step 2: each rank restores its own shards of the
    # checkpoint at step 2 and replays step 2 as the first pass ran it
    seen = got["supervised"]
    assert seen[:, 0].tolist() == [0, 1, 2, 2, 3]
    assert seen[3, 1] == pytest.approx(seen[2, 1], rel=LOSS_RTOL)
    assert seen[0, 1] == pytest.approx(refs[first][0][0][0], rel=LOSS_RTOL)
    for arch, (losses, ported) in refs.items():
        for i, (loss, token_loss) in enumerate(losses):
            assert float(got[f"{arch}/loss{i}"]) == pytest.approx(
                loss, rel=LOSS_RTOL)
            assert float(got[f"{arch}/token_loss{i}"]) == pytest.approx(
                token_loss, rel=LOSS_RTOL)
        for kind, module in ported.items():
            for n, p in module.named_parameters():
                want = p.detach().numpy()
                if kind == "param":
                    np.testing.assert_allclose(got[f"{arch}/param/{n}"],
                                               want, atol=PARAM_ATOL,
                                               rtol=0, err_msg=n)
                else:
                    np.testing.assert_allclose(got[f"{arch}/{kind}/{n}"],
                                               want, rtol=STATE_RTOL,
                                               atol=moment_atol(kind, ported,
                                                                n),
                                               err_msg=n)


@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 4)])
def test_fsdp_tp_train_matches_the_reference(dp, mp, tmp_path):
    refs = {}
    for arch in TRAIN_ARCHS:
        _, _, tree, _ = jax_pair(arch)
        np.savez(tmp_path / f"{arch}.npz", **flat(tree))
        refs[arch] = jax_train_refs(arch, tree)
    got = run_ranks(tmp_path, "train", dp * mp, dp, TRAIN_ARCHS)[0]
    check_train(got, refs, TRAIN_ARCHS[0])


# ---------------------------------------------------------------------- #
# the launchers
# ---------------------------------------------------------------------- #

def launch(module, *argv, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", *argv],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=SRC))


def test_launch_serve_model_parallel_survives_injected_link_fault():
    """The reference's red test (tests/test_serve.py), run on the port."""
    out = launch("serve", "--arch", "qwen3-8b", "--reduced", "--device",
                 "cpu", "--model-parallel", "4", "--requests", "2",
                 "--new-tokens", "4", "--inject-fault", "0-1")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[repair] injected link 0-1 failed" in out.stdout
    assert "[repair] axis model broadcast" in out.stdout
    assert "params distributed via tree broadcast (root=0, axis=model, " \
        "4 devices)" in out.stdout
    assert out.stdout.count("req ") == 2


def test_launch_train_model_parallel_runs_to_the_end(tmp_path):
    out = launch("train", "--reduced", "--device", "cpu", "--data-parallel",
                 "2", "--model-parallel", "2", "--steps", "2",
                 "--global-batch", "4", "--seq", "16", "--ckpt-dir",
                 str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "mesh: {'data': 2, 'model': 2}"
    assert re.fullmatch(r"done at step 2; stragglers: \d+; link faults "
                        r"repaired: False", lines[-1]), out.stdout
    assert sorted(os.listdir(tmp_path)) == [f"rank{r}" for r in range(4)]


def test_launch_train_pipeline_refuses_model_parallel():
    out = launch("train", "--reduced", "--device", "cpu", "--collectives",
                 "pipeline", "--model-parallel", "2")
    assert out.returncode != 0
    assert "--collectives pipeline requires --model-parallel 1" in out.stderr


@pytest.mark.parametrize("module,arch", [("train", "mamba2-780m"),
                                         ("serve", "zamba2-1.2b")])
def test_launchers_refuse_ssm_and_hybrid_model_parallel(module, arch,
                                                         tmp_path):
    """The ssm and hybrid families at --model-parallel 2 (the name is kept
    from when both launchers refused them): exit 0 with finite losses, or
    every request served, through the chunked scan (--seq, --prompt-len
    32 of the reduced chunk 16)."""
    if module == "train":
        out = launch(module, "--arch", arch, "--reduced", "--device", "cpu",
                     "--model-parallel", "2", "--steps", "2",
                     "--global-batch", "2", "--seq", "32", "--ckpt-dir",
                     str(tmp_path))
    else:
        out = launch(module, "--arch", arch, "--reduced", "--device", "cpu",
                     "--model-parallel", "2", "--requests", "2",
                     "--new-tokens", "3", "--prompt-len", "32")
    assert out.returncode == 0, out.stderr[-3000:]
    if module == "train":
        losses = [float(m) for m in re.findall(r"^step \d+: loss (\S+)",
                                               out.stdout, re.M)]
        assert len(losses) == 2 and all(np.isfinite(losses)), out.stdout
        assert out.stdout.splitlines()[0] == "mesh: {'data': 1, 'model': 2}"
    else:
        assert out.stdout.count("-> 3 new tokens") == 2, out.stdout
