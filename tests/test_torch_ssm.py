"""The port's Mamba2/Zamba2 serving path against the JAX reference on the
CPU, with the same numpy inputs and the same weights (carried across by
from_jax_params).

On CPU tensors the SSD wrapper computes its plain version
(repro_torch.kernels.ref.ssd_chunk_intra_heads_reference); it is held here
against the Pallas kernel in interpret mode over the sweep of
tests/test_kernels.py, `y` and `states` both.  The CUDA kernel itself is
held against the same plain version on the card by chip_smoke.py.

Tolerances, float32 throughout unless stated:
* SSD block: atol 1e-4 + rtol 1e-4 (the plain version sums cumsum(dt*a) in
  float64, the Pallas kernel in float32: differences of ~1e-5 relative in
  the decay, on outputs up to ~60); bf16 inputs: y within 1e-3 + 2**-7 of
  its size (one bf16 rounding of float32 values that agree to ~1e-5), states
  (float32) as above;
* primitives (conv, sequential recurrence): 1e-5;
* ssd_chunked, mamba2_forward, logits: 1e-4 (summation order).
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.kernels.ref import ssd_chunk_reference as jax_ssd_chunk_reference
from repro.kernels.ssd_scan import ssd_chunk_intra as jax_ssd_chunk_intra
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import (SSD_BWD_KERNEL, SSD_KERNEL,
                                 SSD_STATE_BWD_KERNEL, SSD_STATE_KERNEL,
                                 build,
                                 ssd_chunk_intra, ssd_chunk_intra_heads,
                                 ssd_chunk_reference)
from repro_torch.kernels.ssd_scan import ARGTYPES
from repro_torch.models import build_model
from repro_torch.models import hybrid as thy
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

SSD_TOL = dict(atol=1e-4, rtol=1e-4)
SSD_TOL_BF16_Y = dict(atol=1e-3, rtol=2.0 ** -7)
PRIM_ATOL = 1e-5
ATOL = 1e-4


def close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


def ssd_inputs(bh, s, p, n, seed=0):
    """x, dt (softplus of a normal), a (-exp of a normal), b, c as float32
    numpy arrays: the distributions of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(bh)).astype(np.float32)
    b = rng.standard_normal((bh, s, n)).astype(np.float32)
    c = rng.standard_normal((bh, s, n)).astype(np.float32)
    return x, dt, a, b, c


# ---------------------------------------------------------------------- #
# the SSD intra-chunk block
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(2, 64, 8, 16, 32), (3, 128, 16, 32, 32),
                                   (1, 256, 32, 16, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_intra_plain_matches_jax_kernel(shape, dtype):
    bh, s, p, n, q = shape
    x, dt, a, b, c = ssd_inputs(bh, s, p, n)
    jx = [jnp.asarray(v).astype(getattr(jnp, dtype)) for v in (x, dt, b, c)]
    tx = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in (x, dt, b, c)]
    yj, sj = jax_ssd_chunk_intra(jx[0], jx[1], jnp.asarray(a), jx[2], jx[3],
                                 chunk=q, interpret=True)
    yt, st = ssd_chunk_intra(tx[0], tx[1], torch.from_numpy(a), tx[2], tx[3],
                             q)
    assert yt.dtype == tx[0].dtype and yt.shape == (bh, s, p)
    assert st.dtype == torch.float32 and st.shape == (bh, s // q, p, n)
    y_tol = SSD_TOL if dtype == "float32" else SSD_TOL_BF16_Y
    close(yt, yj.astype(jnp.float32), **y_tol)
    close(st, sj, **SSD_TOL)


def test_ssd_chunk_reference_matches_jax_oracle():
    x, dt, a, b, c = ssd_inputs(1, 32, 8, 16, seed=1)
    h = 4
    xs = np.broadcast_to(x[0][:, None, :], (32, h, 8)).copy() \
        * np.arange(1, h + 1, dtype=np.float32)[None, :, None]
    dts = np.repeat(dt[0][:, None], h, axis=1)
    aa = np.linspace(-2.0, -0.1, h).astype(np.float32)
    ref = jax_ssd_chunk_reference(*(jnp.asarray(v) for v in
                                    (xs, dts, aa, b[0], c[0])))
    got = ssd_chunk_reference(*(torch.from_numpy(v) for v in
                                (xs, dts, aa, b[0], c[0])))
    close(got, ref, atol=1e-5, rtol=1e-5)


def test_ssd_chunk_intra_each_chunk_matches_single_chunk_oracle():
    """Every block of the plain version against the one-chunk oracle on
    its slice, with the per-chunk state of ssd_chunked's step 2."""
    bh, s, p, n, q = 2, 64, 8, 16, 16
    x, dt, a, b, c = (torch.from_numpy(v) for v in ssd_inputs(bh, s, p, n, 2))
    y, states = ssd_chunk_intra(x, dt, a, b, c, q)
    for i in range(bh):
        for j in range(s // q):
            sl = slice(j * q, (j + 1) * q)
            ref = ssd_chunk_reference(x[i, sl, None], dt[i, sl, None],
                                      a[i, None], b[i, sl], c[i, sl])[:, 0]
            close(y[i, sl], ref, **SSD_TOL)
            cum = torch.cumsum(dt[i, sl] * a[i], 0)
            decay = torch.exp(cum[-1] - cum)
            ref_st = (x[i, sl] * dt[i, sl, None]).T @ (b[i, sl] * decay[:, None])
            close(states[i, j], ref_st, **SSD_TOL)


def test_ssd_heads_layout_with_shared_b_c_views_equals_flat_layout():
    """x as a transposed view of [B,S,H,P], b and c shared by every head
    (a head stride of 0), outputs written into transposed views: the same
    values as the flat layout with the copies made."""
    bs, s, h, p, n, q = 2, 32, 3, 8, 16, 16
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((bs, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((bs, s, h))))
                          .astype(np.float32))
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(np.float32)))
    b, c = (torch.from_numpy(rng.standard_normal((bs, s, n)).astype(np.float32))
            for _ in range(2))
    views = (x.transpose(1, 2), dt.transpose(1, 2), a.expand(bs, h),
             b[:, None], c[:, None])
    y, states = ssd_chunk_intra_heads(*views, q)
    assert y.shape == (bs, h, s, p) and states.shape == (bs, h, s // q, p, n)
    ry, rs = ssd_chunk_intra(
        x.transpose(1, 2).reshape(bs * h, s, p),
        dt.transpose(1, 2).reshape(bs * h, s), a.repeat(bs),
        b.repeat_interleave(h, 0), c.repeat_interleave(h, 0), q)
    torch.testing.assert_close(y.reshape(bs * h, s, p), ry, rtol=0, atol=0)
    torch.testing.assert_close(states.reshape(bs * h, s // q, p, n), rs,
                               rtol=0, atol=0)
    # the out= form writes into the caller's views of [B,S,H,P] tensors
    y2 = torch.empty(bs, s, h, p)
    st2 = torch.empty(bs, s // q, h, p, n)
    ssd_chunk_intra_heads(*views, q, y=y2.transpose(1, 2),
                          states=st2.transpose(1, 2))
    torch.testing.assert_close(y2.transpose(1, 2), y, rtol=0, atol=0)
    torch.testing.assert_close(st2.transpose(1, 2), states, rtol=0, atol=0)


def test_ssd_wrapper_on_cpu_takes_plain_path_without_launch():
    x, dt, a, b, c = (torch.from_numpy(v) for v in ssd_inputs(2, 32, 16, 16))
    before = SSD_KERNEL.launches
    ssd_chunk_intra(x, dt, a, b, c, 16)
    assert SSD_KERNEL.launches == before
    assert SSD_KERNEL._lib is None          # nothing was built or loaded


def test_ssd_wrapper_refuses_other_devices_and_bad_arguments():
    x, dt, a, b, c = (torch.from_numpy(v) for v in ssd_inputs(2, 32, 16, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_chunk_intra(*(t.to("meta") for t in (x, dt, a, b, c)), 16)
    with pytest.raises(ValueError, match="divide chunk"):
        ssd_chunk_intra(x, dt, a, b, c, 24)
    with pytest.raises(ValueError, match="share"):
        ssd_chunk_intra(x, dt, a, b.double(), c, 16)
    with pytest.raises(ValueError, match="match"):
        ssd_chunk_intra(x, dt, a, b[:, :16], c[:, :16], 16)
    with pytest.raises(ValueError, match="no backward"):
        ssd_chunk_intra(x.requires_grad_(), dt, a, b, c, 16)


def test_ssd_ctypes_signature_matches_the_c_entry_point():
    """The kernel builds only on the card, so the binding's argument list is
    held here against the C prototype in the source."""
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    params = re.search(r"int repro_ssd_chunk_fwd\((.*?)\)", src,
                       re.S).group(1)
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "int64_t": ctypes.c_int64}
    declared = [c_types[re.sub(r"^const ", "", p.strip()).rsplit(" ", 1)[0]
                        .replace(" *", "*")]
                for p in params.split(",")]
    assert declared == ARGTYPES


# ---------------------------------------------------------------------- #
# SSD model functions
# ---------------------------------------------------------------------- #

def ssd_model_inputs(bs, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    b = rng.standard_normal((bs, s, n)).astype(np.float32)
    c = rng.standard_normal((bs, s, n)).astype(np.float32)
    h0 = rng.standard_normal((bs, h, p, n)).astype(np.float32)
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 48)])
def test_ssd_chunked_matches_jax(with_state, s, chunk):
    x, dt, a, b, c, h0 = ssd_model_inputs(2, s, 3, 16, 32, seed=4)
    init = h0 if with_state else None
    yj, fj = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                              chunk, None if init is None else
                              jnp.asarray(init))
    yt, ft = tssm.ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, b, c)),
                              chunk, None if init is None else
                              torch.from_numpy(init))
    assert yt.shape == x.shape and ft.dtype == torch.float32
    close(yt, yj, ATOL, 1e-5)
    close(ft, fj, ATOL, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_reference_matches_jax(with_state):
    x, dt, a, b, c, h0 = ssd_model_inputs(2, 9, 3, 8, 16, seed=5)
    init = h0 if with_state else None
    yj, fj = jssm.ssd_reference(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                                None if init is None else jnp.asarray(init))
    yt, ft = tssm.ssd_reference(*(torch.from_numpy(v)
                                  for v in (x, dt, a, b, c)),
                                None if init is None else
                                torch.from_numpy(init))
    close(yt, yj, PRIM_ATOL, 1e-5)
    close(ft, fj, PRIM_ATOL, 1e-5)


def test_ssd_chunked_equals_sequential_recurrence():
    """The chunked decomposition (with the kernel's plain version for steps
    1 and 2) against the port's own sequential oracle."""
    x, dt, a, b, c, h0 = (torch.from_numpy(v) for v in
                          ssd_model_inputs(1, 64, 2, 8, 16, seed=6))
    y, f = tssm.ssd_chunked(x, dt, a, b, c, 16, h0)
    ry, rf = tssm.ssd_reference(x, dt, a, b, c, h0)
    close(y, ry.numpy(), ATOL, 1e-5)
    close(f, rf.numpy(), ATOL, 1e-5)


def test_ssd_chunked_under_autograd_takes_plain_path_with_gradients(
        monkeypatch):
    """Inputs that require grad go through the chunked SSD's autograd
    Function (on the card the forward and backward kernels of all four
    steps); on CPU tensors its forward and backward are the plain versions,
    and no kernel launches.  Every gradient, x, dt, a, b and c, equals
    JAX's."""
    x, dt, a, b, c, _ = ssd_model_inputs(1, 32, 2, 8, 16, seed=7)

    def loss_j(*args):
        y, f = jssm.ssd_chunked(*args, 16)
        return (y ** 2).sum() + f.sum()
    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, a, b, c)))
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, b, c)]
    kernels = (SSD_KERNEL, SSD_BWD_KERNEL, SSD_STATE_KERNEL,
               SSD_STATE_BWD_KERNEL)
    before = [k.launches for k in kernels]
    calls = []
    real = tssm.ssd_chunked_bshp

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(type(out[0].grad_fn).__name__)
        return out
    monkeypatch.setattr(tssm, "ssd_chunked_bshp", spy)
    y, f = tssm.ssd_chunked(*ins, 16)
    ((y ** 2).sum() + f.sum()).backward()
    assert calls and "SSDChunked" in calls[0]
    assert [k.launches for k in kernels] == before
    for t, r in zip(ins, gj):
        close(t.grad, r, 1e-3, 1e-4)


def test_ssd_chunked_gradients_stay_finite_when_the_decay_overflows():
    """A chunk whose cumulative decay spans more than float32's exp range
    (here ~-300 over 16 rows, as in a 512-row chunk of mamba2-780m at
    full width): exp of the differences above the diagonal is inf, so the
    plain steps must mask before the exp, or the backward of the masked
    select multiplies 0 by inf.  The gradient equals JAX's, whose _segsum
    masks first."""
    x, dt, a, b, c, _ = ssd_model_inputs(1, 32, 2, 8, 16, seed=8)
    dt = (dt + 1.0).astype(np.float32)
    a = (a * 20.0).astype(np.float32)

    def loss_j(x, dt, b):
        y, f = jssm.ssd_chunked(x, dt, jnp.asarray(a), b, jnp.asarray(c), 16)
        return (y ** 2).sum() + f.sum()
    gj = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, dt, b)))
    xt, dtt, bt = (torch.from_numpy(v).requires_grad_() for v in (x, dt, b))
    y, f = tssm.ssd_chunked(xt, dtt, torch.from_numpy(a), bt,
                            torch.from_numpy(c), 16)
    ((y ** 2).sum() + f.sum()).backward()
    for t, r in zip((xt, dtt, bt), gj):
        assert torch.isfinite(t.grad).all()
        close(t.grad, r, 1e-3, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_bshp_makes_the_mixers_casts(monkeypatch, dtype,
                                                 with_state):
    """`ssd_chunked_bshp` takes the tensors as `mamba2_rank` makes them (x,
    b, c in the compute dtype, dt and a float32, the SSM state float32)
    and makes the dtype contract's casts itself: its y and final state
    equal, bit for bit, those of a call whose inputs were cast first as
    the model cast them (dt, a and the state to float32, b and c to x's
    dtype), and those of a call with dt, a, b, c and the state in float64
    (cast back exactly)."""
    cfg = reduced_config("mamba2-780m")
    seen = []
    real = tssm.ssd_chunked_bshp

    def spy(*args):
        seen.append(args)
        return real(*args)
    monkeypatch.setattr(tssm, "ssd_chunked_bshp", spy)
    gen = torch.Generator().manual_seed(11)
    p = tssm.Mamba2(cfg, dtype=dtype)
    tssm.init_mamba2(p, gen)
    bs, s = 2, 2 * cfg.ssm_chunk
    u = torch.randn(bs, s, cfg.d_model, generator=gen).to(dtype)
    state = None
    if with_state:
        conv, ssm = tssm.init_ssm_state(cfg, bs, dtype, "cpu")
        state = (conv, torch.randn(ssm.shape, generator=gen))
    with torch.no_grad():
        tssm.mamba2_forward(p, cfg, u, state)
    (x, dt, a, b, c, chunk, init), = seen
    assert x.dtype == b.dtype == c.dtype == dtype
    assert dt.dtype == a.dtype == torch.float32
    y, f = real(x, dt, a, b, c, chunk, init)
    cast = real(x, dt.float(), a.float(), b.to(x.dtype), c.to(x.dtype), chunk,
                None if init is None else init.float())
    wide = real(x, dt.double(), a.double(), b.double(), c.double(), chunk,
                None if init is None else init.double())
    for ry, rf in (cast, wide):
        assert ry.dtype == dtype and rf.dtype == torch.float32
        assert torch.equal(y, ry) and torch.equal(f, rf)


@pytest.mark.parametrize("s,with_state", [(11, False), (11, True),
                                          (1, True)])
def test_causal_conv_matches_jax(s, with_state):
    """Prefill (S > 1) and decode (S = 1) branches; the taps are not
    flipped."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    yj, nj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias),
                               None if st is None else jnp.asarray(st))
    yt, nt = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(bias),
                               None if st is None else torch.from_numpy(st))
    close(yt, yj, PRIM_ATOL)
    close(nt, nj, 0.0)


def mamba_pair(cfg_j, cfg_t, seed=0):
    """JAX init_mamba2 params with the per-head vectors, conv bias and norm
    drawn at random, and the port's Mamba2 with the same weights."""
    pj = jax.tree.map(np.asarray, jssm.init_mamba2(jax.random.PRNGKey(seed),
                                                   cfg_j))
    rng = np.random.default_rng(seed)
    for name in ("A_log", "dt_bias", "conv_b", "norm_w"):
        pj[name] = (0.5 * rng.standard_normal(pj[name].shape)).astype(
            np.float32)
    pj["D"] = (1 + 0.5 * rng.standard_normal(pj["D"].shape)).astype(
        np.float32)
    pt = tssm.Mamba2(cfg_t)
    sd = {k: torch.tensor(v.T if k in ("in_proj", "out_proj") else v)
          for k, v in pj.items()}
    sd["in_proj.weight"] = sd.pop("in_proj")
    sd["out_proj.weight"] = sd.pop("out_proj")
    pt.load_state_dict(sd, strict=True)
    return jax.tree.map(jnp.asarray, pj), pt


@pytest.mark.parametrize("s", [32, 21])
def test_mamba2_forward_with_state_matches_jax(s):
    """S = 32 takes the chunked path (chunk 16), S = 21 the sequential one;
    both continue from a prior state and hand on the next."""
    cfg_j, cfg_t = jax_reduced("mamba2-780m"), reduced_config("mamba2-780m")
    pj, pt = mamba_pair(cfg_j, cfg_t)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    conv, ssm = (np.asarray(t) for t in jssm.init_ssm_state(cfg_j, 2))
    conv = rng.standard_normal(conv.shape).astype(np.float32)
    ssm = rng.standard_normal(ssm.shape).astype(np.float32)
    oj, (cj, sj) = jssm.mamba2_forward(pj, cfg_j, jnp.asarray(x),
                                       (jnp.asarray(conv), jnp.asarray(ssm)))
    with torch.inference_mode():
        ot, (ct, st) = tssm.mamba2_forward(
            pt, cfg_t, torch.from_numpy(x),
            (torch.from_numpy(conv), torch.from_numpy(ssm)))
    close(ot, oj)
    close(ct, cj, PRIM_ATOL)       # in_proj's output: summation order
    close(st, sj, ATOL, 1e-5)


@pytest.mark.parametrize("s", [32, 21])
def test_mamba2_forward_routes_through_the_ssd_block(monkeypatch, s):
    """An aligned prompt calls the SSD block (the kernel on the card) once;
    an unaligned one never does."""
    cfg = reduced_config("mamba2-780m")
    calls = []
    real = tssm.ssd_chunked_bshp
    monkeypatch.setattr(tssm, "ssd_chunked_bshp",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    with torch.inference_mode():
        tssm.mamba2_forward(tssm.Mamba2(cfg), cfg,
                            torch.zeros(1, s, cfg.d_model))
    assert calls == ([{}] if s % cfg.ssm_chunk == 0 else [])


# ---------------------------------------------------------------------- #
# whole models through the Model interface
# ---------------------------------------------------------------------- #

def lm_pair(name, seed=0, **overrides):
    """(jax model, port model, jax params, port module) with equal weights;
    norms, per-head vectors and conv biases drawn at random so every term is
    exercised."""
    cfg_j = jax_reduced(name, **overrides)
    cfg_t = reduced_config(name, **overrides)
    model_j = jax_build(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        last = path[-1].key
        if last.startswith("ln") or last in ("final_norm", "norm_w",
                                             "A_log", "dt_bias", "conv_b"):
            return (0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    pt = from_jax_params(cfg_t, tree, device="cpu")
    return model_j, build_model(cfg_t), jax.tree.map(jnp.asarray, tree), pt


FAMILIES = [("mamba2-780m", {}), ("zamba2-1.2b", {}),
            ("zamba2-1.2b", {"num_layers": 5})]   # 2 sites and a tail


@pytest.mark.parametrize("name,overrides", FAMILIES)
@pytest.mark.parametrize("s", [32, 21])
def test_model_prefill_and_decode_match_jax(name, overrides, s):
    """Prefill logits and 4 greedy decode steps against the JAX Model; S =
    32 is a multiple of the reduced chunk (16), so the SSD block is on the
    path; S = 21 takes the sequential recurrence."""
    model_j, model_t, pj, pt = lm_pair(name, **overrides)
    rng = np.random.default_rng(11)
    b, max_len = 2, 48
    tokens = rng.integers(1, model_t.cfg.vocab_size, (b, s), dtype=np.int32)
    sj = model_j.init_decode_state(b, max_len)
    sj, lj = jax.jit(model_j.prefill)(pj, {"tokens": jnp.asarray(tokens)}, sj)
    decode_j = jax.jit(model_j.decode_step)
    with torch.inference_mode():
        st = model_t.init_decode_state(b, max_len, device="cpu")
        shapes = {k: [tuple(t.shape) for t in v] for k, v in st.items()}
        st, lt = model_t.prefill(pt, {"tokens": torch.from_numpy(tokens)},
                                 st)
        assert lt.shape == (b, 1, model_t.cfg.vocab_size)
        close(lt, lj)
        for index in range(s, s + 4):
            tok = np.array(jnp.argmax(lj[:, -1], axis=-1))[:, None]
            lj, sj = decode_j(pj, jnp.asarray(tok, jnp.int32), sj,
                              jnp.asarray(index, jnp.int32))
            lt, st = model_t.decode_step(pt, torch.from_numpy(tok).long(),
                                         st, index)
            close(lt, lj)
    assert {k: [tuple(t.shape) for t in v] for k, v in st.items()} == shapes
    close(st["ssm"][1], sj["ssm"][1], ATOL, 1e-5)


@pytest.mark.parametrize("name,overrides", FAMILIES)
def test_hybrid_and_ssm_prefill_call_the_ssd_block_once_per_layer(
        monkeypatch, name, overrides):
    cfg = reduced_config(name, **overrides)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    calls = []
    real = tssm.ssd_chunked_bshp
    monkeypatch.setattr(tssm, "ssd_chunked_bshp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        state = model.init_decode_state(2, 40, device="cpu")
        model.prefill(params, {"tokens": torch.ones(2, 32, dtype=torch.long)},
                      state)
        assert len(calls) == cfg.num_layers
        model.decode_step(params, torch.ones(2, 1, dtype=torch.long), state,
                          32)
    assert len(calls) == cfg.num_layers       # decode is sequential


@pytest.mark.parametrize("name,overrides", FAMILIES)
def test_port_init_has_the_reference_param_shapes(name, overrides):
    cfg_j = jax_reduced(name, **overrides)
    tree = jax_build(cfg_j).init(jax.random.PRNGKey(0))
    pt = build_model(reduced_config(name, **overrides)).init(0,
                                                             device="cpu")
    n_j = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in pt.parameters()) == n_j
    mam = pt.layers[0].mamba
    assert tuple(mam.conv_w.shape) == tuple(tree["layers"]["mamba"]["conv_w"]
                                            .shape[1:])
    assert torch.all(mam.D == 1) and torch.all(mam.A_log == 0)
    assert isinstance(pt, thy.HybridLM) == (cfg_j.family == "hybrid")
