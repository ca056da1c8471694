"""The ssm and hybrid families over the model axis on the CPU: reduced
mamba2-780m and zamba2-1.2b served tensor-parallel at mp 2, 4 and 3
(prefill and 3 greedy decode steps) and trained FSDP+TP at (data, model)
= (2, 2), (1, 4) and (1, 3), against the JAX reference on one device
with the same weights (from_jax_params), through the gloo harness of
tests/test_torch_model_parallel.py.  Prompts of 32 tokens (a multiple of
the reduced ssm_chunk 16: the chunked scan, `ssd_chunked`) and of 12 (the
sequential recurrence, `ssd_reference`); training's 32-token rows take
the chunked scan.  Norms, per-head vectors and conv biases are drawn at
random, so a rank that slices the wrong heads shows.

Without ranks: the placed mixer's per-rank arithmetic (`mamba2_rank`,
`gated_norm_rank`) for r = 0..M-1 in one process, the norm's all-reduce a
sum over r and the out_proj partials summed, against `mamba2_forward`.
And `Model.init_leaves`, which places a model as it is made, against
`Model.init` for the families whose init fills a constant (Mamba2's D).

Tolerances as in tests/test_torch_model_parallel.py (float32; ranks sum
partial products in another order): 1e-4 on logits, 1e-5 on losses, 2e-4
on params, the AdamW moments as stated there; the per-rank arithmetic
1e-5.  Training's losses, params and moments are held to the reference,
but for one leaf (`F64_HELD`): the reference's first moment of zamba2's
`embed` misses the stated tolerance on one device as on every mesh, and
is held instead to a float64 run of the port's one-device step, which
the reference's other moments and all the port's float32 ones hold
(`test_one_device_moments_hold_a_float64_run`).  The reference casts to
float32 throughout, so it has no float64 run of its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               host_batch_slice, init_adamw, make_train_step)
from test_torch_model_parallel import (B, DECODE_STEPS, LOGIT_ATOL,
                                       STATE_RTOL, TRAIN_STEPS, check_train,
                                       flat, jax_train_refs, moment_atol,
                                       run_ranks)
from test_torch_ssm import mamba_pair

torch.set_num_threads(1)

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
PROMPTS = (32, 12)          # the chunked scan, the sequential recurrence
RANK_ATOL = 1e-5
# (kind, name) of the one moment held to the port's float64 run, not to
# the reference (ROADMAP Queue C)
F64_HELD = {"zamba2-1.2b": ("mu", "embed")}


def ssm_tree(arch, seed=0):
    """The reference's init with its zero or one vectors (norms, A_log,
    dt_bias, conv_b, D) drawn at random."""
    tree = jax.tree.map(np.asarray, jax_build(jax_reduced(arch)).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        last = path[-1].key
        if last.startswith("ln") or last in ("final_norm", "norm_w",
                                             "A_log", "dt_bias", "conv_b"):
            return (0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        if last == "D":
            return (1 + 0.3 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, tree)


def jax_serve(arch, tree, tokens):
    """The reference's prefill and DECODE_STEPS greedy steps: ([prefill
    logits, decode logits...], [greedy tokens])."""
    model = jax_build(jax_reduced(arch))
    s = tokens.shape[1]
    params = jax.tree.map(jnp.asarray, tree)
    state, logits = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)},
        model.init_decode_state(B, s + 8))
    decode = jax.jit(model.decode_step)
    out, toks = [np.asarray(logits)], []
    for i in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        toks.append(tok)
        logits, state = decode(params, jnp.asarray(tok, jnp.int32), state,
                               jnp.asarray(s + i, jnp.int32))
        out.append(np.asarray(logits))
    return out, toks


@pytest.mark.parametrize("mp", [2, 4, 3])
def test_tp_prefill_and_decode_match_jax(mp, tmp_path):
    """At mp 3 neither arch's 8 SSM heads divide "model": every rank runs
    the whole mixer (`_mamba2_sharded`'s replicated route)."""
    refs = {}
    for arch in ARCHS:
        tree = ssm_tree(arch)
        for s in PROMPTS:
            key = f"{arch}:{s}"
            tokens = np.random.default_rng(s).integers(
                1, jax_reduced(arch).vocab_size, (B, s)).astype(np.int64)
            np.savez(tmp_path / f"{key}.npz", **flat(tree))
            np.savez(tmp_path / f"{key}_in.npz", tokens=tokens)
            refs[key] = jax_serve(arch, tree, tokens)
    got = run_ranks(tmp_path, "serve", mp, 1, list(refs))[0]
    for key, (logits, toks) in refs.items():
        np.testing.assert_allclose(got[key + "/prefill"], logits[0],
                                   atol=LOGIT_ATOL, rtol=0, err_msg=key)
        for i, tok in enumerate(toks):
            np.testing.assert_array_equal(got[f"{key}/tok{i}"], tok,
                                          err_msg=key)
            np.testing.assert_allclose(got[f"{key}/decode{i}"],
                                       logits[i + 1], atol=LOGIT_ATOL,
                                       rtol=0, err_msg=f"{key} step {i}")


def one_device_moments(arch, tree, dtype=torch.float32):
    """The AdamW moments after the port's one-device train step (the
    harness's steps and batches) in `dtype`, as float32 modules of the
    params' names."""
    cfg = reduced_config(arch)
    params = from_jax_params(cfg, tree, device="cpu").to(dtype)
    opt = init_adamw(params)
    step = make_train_step(build_model(cfg, remat=True), TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                              total_steps=TRAIN_STEPS), compute_dtype=dtype))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    for i in range(TRAIN_STEPS):
        params, opt, _ = step(params, opt, host_batch_slice(dc, i, 0, 4))
    out = {}
    for kind in ("mu", "nu"):
        module = from_jax_params(cfg, tree, device="cpu")
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(getattr(opt, kind)[n])
        out[kind] = module
    return out


def train_refs(arch, tree):
    """`jax_train_refs`, its `F64_HELD` moment replaced by the port's
    float64 run's."""
    losses, ported = jax_train_refs(arch, tree)
    if arch in F64_HELD:
        kind, name = F64_HELD[arch]
        exact = one_device_moments(arch, tree, torch.float64)[kind]
        with torch.no_grad():
            dict(ported[kind].named_parameters())[name].copy_(
                dict(exact.named_parameters())[name])
    return losses, ported


@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 4), (1, 3)])
def test_fsdp_tp_train_matches_the_reference(dp, mp, tmp_path):
    """The gathered in_proj's gradient differs per rank (its heads' rows
    and its share of B and C): it must come back a partial sum, or the
    other ranks' B and C terms are lost and the params drift.  At (2, 2)
    each rank's 2 x 32 rows gather in_proj's output, at (1, 4) its 4 x 32
    rows gather the weight (`_mamba2_sharded`).  At (1, 3) the 8 heads do
    not divide "model" and every rank runs the whole mixer: its weights'
    gradients must come back replicated, not summed over the 3 ranks."""
    refs = {}
    for arch in ARCHS:
        tree = ssm_tree(arch)
        np.savez(tmp_path / f"{arch}.npz", **flat(tree))
        refs[arch] = train_refs(arch, tree)
    got = run_ranks(tmp_path, "train", dp * mp, dp, ARCHS)[0]
    check_train(got, refs, ARCHS[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_moments_hold_a_float64_run(arch):
    """The port's one-device float32 step and the reference's against the
    port's step in float64, at the moments' stated tolerances: every leaf
    of both, but the reference's `F64_HELD` one, which misses, and which
    the port's float32 step comes nearer."""
    tree = ssm_tree(arch)
    f64 = one_device_moments(arch, tree, torch.float64)
    sides = {"port": one_device_moments(arch, tree),
             "reference": jax_train_refs(arch, tree)[1]}
    for kind in ("mu", "nu"):
        want = {n: w.detach().numpy() for n, w in
                f64[kind].named_parameters()}
        for side, got in sides.items():
            for n, p in got[kind].named_parameters():
                if side == "reference" and F64_HELD.get(arch) == (kind, n):
                    port = dict(sides["port"][kind].named_parameters())[n]
                    gap = np.abs(p.detach().numpy() - want[n]).max()
                    near = np.abs(port.detach().numpy() - want[n]).max()
                    print(f"{arch} {kind} {n}: max |float32 - float64| "
                          f"reference {gap:.4g}, port {near:.4g}; atol "
                          f"{moment_atol(kind, f64, n):.4g}, max |float64| "
                          f"{np.abs(want[n]).max():.4g}")
                    assert gap > near, n
                    continue
                np.testing.assert_allclose(
                    p.detach().numpy(), want[n], rtol=STATE_RTOL,
                    atol=moment_atol(kind, f64, n), err_msg=f"{side} {n}")


# ---------------------------------------------------------------------- #
# without ranks
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("route", ["weight", "output"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("s", [32, 12, 1])
def test_per_rank_arithmetic_sums_to_the_mixer(m, s, route):
    """Each rank's heads from the whole weights, the norm's mean of
    squares summed over the ranks, the out_proj partials summed: the
    plain mixer's output within 1e-5 (bit-equal at m = 1), and its new
    states, the SSM state's heads and the conv state's channels, put
    together from the ranks'.  The rank's in_proj rows by either route
    of `_mamba2_sharded`: its rows of the weight, or its rows of the
    whole projection."""
    cfg_j, cfg = jax_reduced("mamba2-780m"), reduced_config("mamba2-780m")
    _, p = mamba_pair(cfg_j, cfg)
    din, h, _, _ = tssm.ssm_dims(cfg)
    dl, hl = din // m, h // m
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    conv, ssm = tssm.init_ssm_state(cfg, 2, device="cpu")
    conv = torch.from_numpy(rng.standard_normal(conv.shape).astype(
        np.float32))
    ssm = torch.from_numpy(rng.standard_normal(ssm.shape).astype(np.float32))

    def proj(r):
        own, _ = tssm.rank_ranges(cfg, r, m)
        if route == "weight":
            return F.linear(x, tssm.take(p.in_proj.weight, own, 0))
        return tssm.take(p.in_proj(x), own, 2)
    with torch.no_grad():
        ref, (ref_conv, ref_ssm) = tssm.mamba2_forward(p, cfg, x, (conv, ssm))
        ranks = [tssm.mamba2_rank(
            proj(r), p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, cfg, r, m,
            conv, ssm[:, r * hl:(r + 1) * hl]) for r in range(m)]
        total = sum(torch.mean(yz.float() ** 2, dim=-1, keepdim=True)
                    * (dl / din) for yz, _, _ in ranks)
        out = sum(F.linear(
            tssm.gated_norm_rank(yz, p.norm_w[r * dl:(r + 1) * dl], din,
                                 cfg.norm_eps,
                                 None if m == 1 else (lambda _: total)),
            p.out_proj.weight[:, r * dl:(r + 1) * dl])
            for r, (yz, _, _) in enumerate(ranks))
    if m == 1:
        assert torch.equal(out, ref)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=RANK_ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        torch.cat([st for _, _, st in ranks], dim=1).numpy(),
        ref_ssm.numpy(), atol=RANK_ATOL, rtol=0)
    np.testing.assert_allclose(
        torch.cat([c[..., :dl] for _, c, _ in ranks]
                  + [ranks[0][1][..., dl:]], dim=-1).numpy(),
        ref_conv.numpy(), atol=RANK_ATOL, rtol=0)


def test_rank_ranges_cover_each_segment_once():
    """Over the ranks, z, x and dt are split and B, C kept whole: every
    in_proj row and conv channel is some rank's, and those of B and C are
    every rank's."""
    cfg = reduced_config("zamba2-1.2b")
    din, h, _, n = tssm.ssm_dims(cfg)
    out = 2 * din + 2 * n + h
    for m in (1, 2, 4, 8):
        rows = np.zeros(out, int)
        chans = np.zeros(din + 2 * n, int)
        for r in range(m):
            rr, cc = tssm.rank_ranges(cfg, r, m)
            for lo, hi in rr:
                rows[lo:hi] += 1
            for lo, hi in cc:
                chans[lo:hi] += 1
        bc = slice(2 * din, 2 * din + 2 * n)
        assert (rows[bc] == m).all() and (np.delete(rows, np.r_[bc]) == 1
                                          ).all()
        assert (chans[din:] == m).all() and (chans[:din] == 1).all()
    t = torch.arange(10.0)
    assert tssm.take(t, [(0, 3), (3, 5)], 0).data_ptr() == t.data_ptr()
    assert tssm.take(t, [(0, 2), (6, 8)], 0).tolist() == [0, 1, 6, 7]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b", "qwen3-8b"])
def test_init_leaves_equal_init(arch):
    """One parameter at a time, as the launchers place a model: the same
    tensors as `init`, Mamba2's D (filled with 1) included."""
    model = build_model(reduced_config(arch))
    whole = dict(model.init(3, device="cpu").named_parameters())
    _, leaves = model.init_leaves(3, device="cpu")
    got = dict(leaves)
    assert sorted(got) == sorted(whole)
    for name, t in got.items():
        assert torch.equal(t, whole[name]), name
    if arch != "qwen3-8b":
        assert torch.all(got["layers.0.mamba.D"] == 1)
