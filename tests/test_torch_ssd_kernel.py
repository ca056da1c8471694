"""The SSD kernel's bf16 tensor-core scheme and its launch plan, on the CPU.

The bf16 body of csrc/ssd_chunk.cu runs its three products on the tensor
cores, where both operands are bf16 and the sums are float32.  It keeps B,
C and x exact and carries the float32 operands (S * L * dt for y, B times
the decay and dt for the state) in two bf16 parts, the rounding and the
rounded remainder.  `bf16_kernel_emulation` repeats that arithmetic here; it is
held against the plain version (repro_torch.kernels.ref) and the Pallas
kernel in interpret mode at chip_smoke.py's tolerances, so the scheme is
known to meet them before the card runs it.  The launch plan, what a CUDA
call hands the C entry point, is checked against the model's strided
views.

The backward kernel's oracle, `ref.ssd_chunk_intra_bwd_reference`, is held
to torch.autograd of the plain forward in float64 (1e-12 of each
gradient's size); the backward's launch plan and C prototype as the
forward's.  Steps 3 and 4 (the state passes, `kernels/ssd_state.py`): their
plain backward with the block's (`ref.ssd_state_bwd_reference`) against
autograd of the plain forward in float64; the autograd Function of all four
steps against finite differences (gradcheck) and against autograd of the
chunked SSD's plain steps as `models/ssm.py` ran them before the kernels,
on head-slice views too; their launch plans and C prototypes.

Tolerances (chip_smoke.py's SSD_TOL and SSD_TOL_BF16_Y): states, float32,
atol 1e-4 + rtol 1e-4 (two bf16 parts carry each term to ~2**-16, over up
to 512 terms); y, bf16, atol 1e-3 + rtol 2**-7 (one bf16 rounding of
float32 values that agree to ~1e-5).
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_intra as jax_ssd_chunk_intra
from repro_torch.kernels.build import CSRC
from repro_torch.kernels import ssd_state
from repro_torch.kernels.ops import SSDChunked, ssd_chunked_bshp
from repro_torch.kernels.ref import (ssd_chunk_intra_bwd_reference,
                                     ssd_chunk_intra_heads_reference,
                                     ssd_state_bwd_reference,
                                     ssd_state_reference)
from repro_torch.kernels.ssd_scan import (ARGTYPES, BWD_ARGTYPES, DIMS,
                                          MAX_CHUNK, SCRATCH_DTYPES,
                                          bwd_launch,
                                          bwd_launch_args, bwd_scratch,
                                          bwd_splits, dense_if_unaligned,
                                          launch_args,
                                          ssd_chunk_intra_bwd_heads,
                                          ssd_chunk_intra_heads, work_bytes)

torch.set_num_threads(1)

SSD_TOL = dict(atol=1e-4, rtol=1e-4)
SSD_TOL_BF16_Y = dict(atol=1e-3, rtol=2.0 ** -7)


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


def heads(x, dt, a, b, c) -> tuple:
    """The model's x [B,S,H,P], dt [B,S,H], a [H], b, c [B,S,N] as the
    heads-layout views the SSD kernels read (as `ops.ssd_chunked_bshp`
    forms them): x, dt transposed, a with a batch stride of 0, b and c
    with a head stride of 0."""
    return (x.transpose(1, 2), dt.transpose(1, 2),
            a.expand(x.shape[0], x.shape[2]), b[:, None], c[:, None])


def flat_reference(x, dt, a, b, c, chunk):
    """The plain SSD block in the Pallas layout (x [BH,S,P], dt [BH,S], a
    [BH], b, c [BH,S,N]): one head a row."""
    y, states = ssd_chunk_intra_heads_reference(
        x[:, None], dt[:, None], a[:, None], b[:, None], c[:, None], chunk)
    return y[:, 0], states[:, 0]


def two_parts(v: torch.Tensor):
    """v (float32) as the kernel hands it to the tensor cores: its bf16
    rounding and the bf16 rounding of the remainder, as float32."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def bf16_kernel_emulation(x, dt, a, b, c, chunk):
    """The bf16 kernel's arithmetic in the Pallas layout (x [BH,S,P], dt
    [BH,S], a [BH], b, c [BH,S,N], bf16 x, b, c): S = C B^T in float32 (bf16
    products are exact); v = (S * L) * dt[j] with L from a float64 cumsum,
    each difference rounded to float32 once, masked by a select; y = v x in
    two bf16 parts of v; state^T = v'^T x with v' = (B * exp(cum[-1] -
    cum)) * dt (the y of a query row with C = e_n and cum[-1]), in two bf16
    parts.  Returns (y in bf16, states float32)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    l = s // chunk
    xf = x.float().reshape(bh, l, chunk, p)
    bf = b.float().reshape(bh, l, chunk, n)
    cf = c.float().reshape(bh, l, chunk, n)
    dtf = dt.float().reshape(bh, l, chunk)
    cum = torch.cumsum(dtf * a.float()[:, None, None], -1,
                       dtype=torch.float64)
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).float())
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    v = torch.where(mask, (cf @ bf.transpose(-1, -2)) * decay
                    * dtf[..., None, :], 0.0)
    hi, lo = two_parts(v)
    y = hi @ xf + lo @ xf
    decay = torch.exp((cum[..., -1:] - cum).float())
    hi, lo = two_parts(bf * decay[..., None] * dtf[..., None])
    states = (hi.transpose(-1, -2) @ xf + lo.transpose(-1, -2) @ xf)
    return (y.reshape(bh, s, p).bfloat16(),
            states.transpose(-1, -2).contiguous())


def close(got, ref, atol, rtol):
    if isinstance(ref, torch.Tensor):
        ref = ref.float()
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


def test_two_parts_carry_a_float32_to_2_pow_minus_16():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    hi, lo = two_parts(v)
    assert torch.all((hi + lo - v).abs() <= v.abs() * 2.0 ** -16)
    assert torch.any((hi - v).abs() > v.abs() * 2.0 ** -12)   # hi alone not


@pytest.mark.parametrize("bh,q,p,n", [
    (2, 512, 64, 128),     # mamba2-780m's chunk and widths
    (3, 256, 64, 64),      # zamba2-1.2b's
    (2, 129, 32, 16),      # a chunk no multiple of 16
])
def test_bf16_emulation_meets_the_smoke_tolerances(bh, q, p, n):
    """Against the plain version on bf16 inputs and the Pallas kernel in
    interpret mode, two chunks per row."""
    x, dt, a, b, c = ssd_inputs(bh, 2 * q, p, n, seed=q)
    tx, tb, tc = (torch.from_numpy(v).bfloat16() for v in (x, b, c))
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a)
    y, st = bf16_kernel_emulation(tx, tdt, ta, tb, tc, q)
    ry, rst = flat_reference(tx, tdt, ta, tb, tc, q)
    jx, jb, jc = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, b, c))
    jy, jst = jax_ssd_chunk_intra(jx, jnp.asarray(dt), jnp.asarray(a), jb,
                                  jc, chunk=q, interpret=True)
    assert y.dtype == torch.bfloat16 and y.shape == (bh, 2 * q, p)
    assert st.shape == (bh, 2, p, n)
    for ref_y, ref_st in ((ry, rst), (jy.astype(jnp.float32), jst)):
        close(y, ref_y, **SSD_TOL_BF16_Y)
        close(st, ref_st, **SSD_TOL)


def test_bf16_emulation_is_not_the_one_part_scheme():
    """With v and w B in one bf16 part each, the states miss SSD_TOL: the
    second part is what the tolerance needs."""
    x, dt, a, b, c = ssd_inputs(2, 1024, 64, 128, seed=512)
    tx, tb, tc = (torch.from_numpy(v).bfloat16() for v in (x, b, c))
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a)
    _, rst = flat_reference(tx, tdt, ta, tb, tc, 512)
    cum = torch.cumsum(tdt.reshape(2, 2, 512) * ta[:, None, None], -1,
                       dtype=torch.float64)
    w = tdt.reshape(2, 2, 512) * torch.exp((cum[..., -1:] - cum).float())
    one = (w[..., None] * tb.float().reshape(2, 2, 512, 128)).bfloat16()
    st1 = tx.float().reshape(2, 2, 512, 64).transpose(-1, -2) @ one.float()
    excess = (st1 - rst).abs() - SSD_TOL["atol"] - SSD_TOL["rtol"] * rst.abs()
    assert excess.max() > 0


def model_views(bs, s, h, p, n, dtype, offset=0):
    """The model's views (models/ssm.py): x [B,H,S,P] as a transposed view
    of the [B,S,H,P] slice of xbc, b and c [B,1,S,N] slices of xbc, dt
    [B,H,S] transposed, a [B,H] with a batch stride of 0; `offset` elements
    shift every row of xbc.  And y, states as the chunked SSD's Function
    (`ops.ssd_chunked_bshp`) allocates them, as transposed views, and the
    bf16 work buffer for a chunk of 64."""
    din = h * p
    xbc = torch.zeros(bs, s, offset + din + 2 * n, dtype=dtype)[..., offset:]
    xs, b, c = torch.split(xbc, [din, n, n], dim=-1)
    x = xs.reshape(bs, s, h, p).transpose(1, 2)
    dt = torch.zeros(bs, s, h).transpose(1, 2)
    a = torch.zeros(h).expand(bs, h)
    y = torch.empty(bs, s, h, p, dtype=dtype).transpose(1, 2)
    states = torch.empty(bs, s // 64, h, p, n).transpose(1, 2)
    work = torch.empty(work_bytes(x, 64), dtype=torch.uint8) \
        if dtype == torch.bfloat16 else None
    return x, dt, a, b[:, None], c[:, None], y, states, work


@pytest.mark.parametrize("p", DIMS)
@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_launch_plan_takes_every_p_and_n(p, n, dtype):
    """What a CUDA call hands the C entry point, through the model's
    strided views: dtype, shapes, every stride, and a head stride of 0 for
    the shared b and c."""
    bs, s, h = 2, 128, 3
    x, dt, a, b, c, y, states, work = model_views(bs, s, h, p, n, dtype)
    args = launch_args(x, dt, a, b, c, y, states, work, 64)
    assert len(args) == len(ARGTYPES) - 1          # all but the stream
    assert args[:7] == tuple(t.data_ptr() for t in (x, dt, a, b, c, y,
                                                     states))
    # the work buffer: cum and dt of each (batch, head, chunk), bf16 only
    assert args[7] == (None if work is None else work.data_ptr())
    assert args[8:15] == ({torch.float32: 0, torch.bfloat16: 1}[dtype],
                          bs, h, s, 64, p, n)
    row = h * p + 2 * n                            # xbc's row
    assert args[15:18] == (s * row, p, row) == x.stride()[:3]
    assert args[18:23] == dt.stride() + (0, 1)     # a: batch stride 0
    assert args[23:29] == (s * row, 0, row) * 2    # b, c: shared by heads
    assert args[29:32] == y.stride()[:3] and args[32:] == states.stride()[:3]


def test_ssd_launch_plan_refuses_what_the_kernel_does_not_take():
    views = model_views(1, 128, 2, 64, 64, torch.bfloat16)
    launch_args(*views, 64)
    x, dt, a, b, c, y, states, work = views
    with pytest.raises(ValueError, match="head dim 48"):
        launch_args(*model_views(1, 128, 2, 48, 64, torch.bfloat16), 64)
    with pytest.raises(ValueError, match="state dim 8"):
        launch_args(*model_views(1, 128, 2, 64, 8, torch.bfloat16), 64)
    with pytest.raises(ValueError, match=f"> {MAX_CHUNK}"):
        launch_args(*views, 2 * MAX_CHUNK)
    with pytest.raises(ValueError, match="float32"):
        launch_args(x, dt.double(), a, b, c, y, states, work, 64)
    for short in (None, work[:-16], work[8:]):     # missing, small, unaligned
        with pytest.raises(ValueError, match="work buffer"):
            launch_args(x, dt, a, b, c, y, states, short, 64)
    assert work.numel() == 12 * 64 * 2 * 2         # 2 heads, 2 chunks
    # xbc's rows shifted by one element: bf16 rows 2 bytes off 16
    off = model_views(1, 128, 2, 64, 64, torch.bfloat16, offset=1)
    with pytest.raises(ValueError, match="16 bytes"):
        launch_args(*off, 64)
    # float32 takes any start
    launch_args(*model_views(1, 128, 2, 64, 64, torch.float32, offset=1), 64)


def test_ssd_wrapper_copies_rows_off_16_bytes_to_dense_ones():
    """The wrapper's step before a bf16 launch: each of x, b, c whose rows
    are off 16 bytes becomes a dense copy that the launch plan takes, with
    the same values; aligned ones are passed as they are."""
    x, dt, a, b, c, y, states, work = model_views(
        1, 128, 2, 64, 64, torch.bfloat16, offset=1)
    xbc = torch.arange(x.numel() + 2 * b.numel()).float()
    for t in (x, b, c):
        t.copy_(xbc[:t.numel()].view(t.shape).to(t.dtype))
    dx, db, dc = dense_if_unaligned(x, b, c)
    for got, want in ((dx, x), (db, b), (dc, c)):
        assert got is not want and got.is_contiguous()
        assert torch.equal(got, want)
    launch_args(dx, dt, a, db, dc, y, states, work, 64)
    aligned = model_views(1, 128, 2, 64, 64, torch.bfloat16)
    assert all(got is want for got, want in
               zip(dense_if_unaligned(*aligned[:1], *aligned[3:5]),
                   (aligned[0], aligned[3], aligned[4])))


# ---------------------------------------------------------------------- #
# the backward: its plain version, the autograd Function, the launch plan
# ---------------------------------------------------------------------- #

def heads_inputs(bs, h, g, s, p, n, q, dtype=torch.float64, seed=0,
                 overflow=False):
    """x, dt, a [B,H], b, c [B,G,S,N], dy, dstates in the heads layout;
    `overflow`: dt + 1 and a * 40, a cumulative decay past exp's range."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)
    dt = torch.nn.functional.softplus(rnd(bs, h, s)) + (1.0 if overflow
                                                         else 0.0)
    a = -torch.exp(rnd(h)).expand(bs, h) * (40.0 if overflow else 1.0)
    return (rnd(bs, h, s, p), dt, a, rnd(bs, g, s, n), rnd(bs, g, s, n),
            rnd(bs, h, s, p), rnd(bs, h, s // q, p, n))


def autograd_grads(x, dt, a, b, c, dy, dstates, q):
    """torch.autograd of the plain forward: the oracle of the backward."""
    ins = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    y, st = ssd_chunk_intra_heads_reference(*ins, q)
    ((y * dy).sum() + (st * dstates).sum()).backward()
    return [t.grad for t in ins]


def check_grads(got, ref, rtol):
    """Each gradient within rtol of the largest magnitude of its reference,
    or of 1 where that is smaller (da vanishes when every decay does)."""
    for name, g, r in zip(("dx", "ddt", "da", "db", "dc"), got, ref):
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max() / r.abs().max().clamp_min(1.0)
        assert err <= rtol, (name, err.item())


@pytest.mark.parametrize("q", [1, 16, 64])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("p", DIMS)
@pytest.mark.parametrize("n", DIMS)
def test_bwd_reference_equals_autograd_of_the_plain_forward(q, g, p, n):
    """float64, two chunks a row, dy and dstates both non-zero, b and c
    shared by the 3 heads (G = 1) or one per head (G = H)."""
    inputs = heads_inputs(2, 3, g, 2 * q, p, n, q, seed=q + p + n + g)
    got = ssd_chunk_intra_bwd_reference(*inputs, q)
    ref = autograd_grads(*inputs, q)
    assert [t.shape for t in got[:2] + got[3:]] == \
        [t.shape for t in ref[:2] + ref[3:]]
    check_grads(got, ref, 1e-12)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-5)])
def test_bwd_reference_stays_finite_when_the_decay_overflows(dtype, rtol):
    """A cumulative decay of thousands over 16 rows: exp of the differences
    above the diagonal overflows (float32's range from ~88, float64's from
    ~709), so the plain backward masks before every exp.  Gradients finite
    and equal to autograd's (whose forward masks first too)."""
    inputs = heads_inputs(1, 2, 1, 32, 16, 16, 16, dtype=dtype, seed=8,
                          overflow=True)
    cum = torch.cumsum(inputs[1] * inputs[2][..., None], -1)
    assert (cum[..., 15] - cum[..., 0]).abs().min() > 709
    check_grads(ssd_chunk_intra_bwd_reference(*inputs, 16),
                autograd_grads(*inputs, 16), rtol)


def test_bwd_reference_returns_the_input_dtypes():
    """bf16 x, b, c: dx, db, dc in bf16, ddt and da in float32, as the
    backward kernel writes them."""
    x, dt, a, b, c, dy, st = heads_inputs(1, 2, 1, 32, 16, 32, 16,
                                          dtype=torch.float32)
    got = ssd_chunk_intra_bwd_reference(x.bfloat16(), dt, a, b.bfloat16(),
                                        c.bfloat16(), dy.bfloat16(), st, 16)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]


@pytest.mark.parametrize("with_init", [False, True])
def test_autograd_function_passes_gradcheck(with_init):
    """SSDChunked (all four steps) on CPU tensors in float64: the plain
    forwards and the plain backwards, against finite differences, every
    input and the initial state; two chunks."""
    gen = torch.Generator().manual_seed(3)
    bs, s, h, p, n, q = 1, 8, 2, 3, 4, 4

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)
    ins = [rnd(bs, s, h, p), torch.nn.functional.softplus(rnd(bs, s, h)),
           -torch.exp(rnd(h)), rnd(bs, s, n), rnd(bs, s, n),
           rnd(bs, h, p, n) if with_init else None]
    ins = [None if t is None else t.requires_grad_() for t in ins]
    assert torch.autograd.gradcheck(
        lambda *t: SSDChunked.apply(*t[:5], q, t[5]), ins)


def test_bshp_block_under_autograd_is_the_function():
    """Grad enabled and an input that requires grad: the chunked SSD is
    the Function of all four steps; else (no grad, inference) the kernels'
    direct path, no graph.  The block alone takes no input that requires
    grad: under autograd it runs only inside the Function."""
    x, dt, a, b, c, _, _ = heads_inputs(1, 2, 1, 32, 16, 16, 16,
                                        dtype=torch.float32)
    views = (x.transpose(1, 2), dt.transpose(1, 2), a[0], b[:, 0], c[:, 0])
    y, _ = ssd_chunked_bshp(*views, 16)
    assert y.grad_fn is None
    y, _ = ssd_chunked_bshp(views[0].requires_grad_(), *views[1:], 16)
    assert type(y.grad_fn).__name__ == "SSDChunkedBackward"
    with torch.no_grad():
        assert ssd_chunked_bshp(*views, 16)[0].grad_fn is None
    with pytest.raises(ValueError, match="no backward"):
        ssd_chunk_intra_heads(x.requires_grad_(), dt, a, b, c, 16)


def bwd_views(bs, s, h, p, n, dtype, q=64, g=1, offset=0):
    """The backward's arguments as the Function hands them over: the
    forward's model views (`model_views`), dy and dstates as transposed
    views of [B,S,H,P] and [B,L,H,P,N] gradients, dx and ddt as transposed
    views of [B,S,H,P] and [B,S,H] outputs, and the scratch."""
    x, dt, a, b, c, _, _, _ = model_views(bs, s, h, p, n, dtype, offset)
    if g > 1:
        b = torch.zeros(bs, g, s, n, dtype=dtype)
        c = torch.zeros(bs, g, s, n, dtype=dtype)
    dy = torch.zeros(bs, s, h, p, dtype=dtype).transpose(1, 2)
    dst = torch.zeros(bs, s // q, h, p, n).transpose(1, 2)
    dx = torch.empty(bs, s, h, p, dtype=dtype).transpose(1, 2)
    ddt = torch.empty(bs, s, h).transpose(1, 2)
    splits = bwd_splits(bs, h, g, s // q, -(-q // 64))
    need = bwd_scratch(x, b, q, splits)
    scratch = [torch.empty(need[k], dtype=SCRATCH_DTYPES[k])
               for k in ("da", "part", "rows")]
    work = torch.empty(work_bytes(x, q), dtype=torch.uint8)
    return (x, dt, a, b, c, dy, dst, dx, ddt, *scratch, work), splits


@pytest.mark.parametrize("p", DIMS)
@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_launch_plan_takes_every_p_and_n(p, n, dtype):
    """What a CUDA call hands the backward's C entry point through the
    model's strided views: pointers, dtype, shapes, the head split and
    every stride (b and c by group)."""
    bs, s, h = 2, 128, 3
    views, splits = bwd_views(bs, s, h, p, n, dtype)
    args = bwd_launch_args(*views, 64, splits)
    assert len(args) == len(BWD_ARGTYPES) - 1     # all but the stream
    assert args[:13] == tuple(t.data_ptr() for t in views)
    assert args[13:15] == (None, None)    # no dcum, dc_extra from steps 3-4
    dcum, dc_extra = torch.zeros(bs, h, s), torch.zeros(bs, 1, s, n)
    assert bwd_launch_args(*views, 64, splits, dcum, dc_extra)[13:15] == \
        (dcum.data_ptr(), dc_extra.data_ptr())
    assert args[15:24] == ({torch.float32: 0, torch.bfloat16: 1}[dtype],
                           bs, h, 1, s, 64, p, n, splits)
    x, dt, a, b, c, dy, dst, dx, ddt = views[:9]
    row = h * p + 2 * n
    assert args[24:27] == (s * row, p, row) == x.stride()[:3]
    assert args[27:32] == dt.stride() + (0, 1)    # a: batch stride 0
    assert args[32:38] == b.stride()[:3] + c.stride()[:3]
    assert args[38:] == (dy.stride()[:3] + dst.stride()[:3] +
                         dx.stride()[:3] + ddt.stride())


def test_bwd_launch_plan_refuses_what_the_kernel_does_not_take():
    views, splits = bwd_views(1, 128, 2, 64, 64, torch.bfloat16)
    bwd_launch_args(*views, 64, splits)
    x, dt, a, b, c, dy, dst, dx, ddt, da, part, rows, work = views
    with pytest.raises(ValueError, match="head dim 48"):
        bwd_launch_args(*bwd_views(1, 128, 2, 48, 64, torch.bfloat16)[0],
                        64, 1)
    with pytest.raises(ValueError, match=f"> {MAX_CHUNK}"):
        bwd_launch_args(*views, 2 * MAX_CHUNK, splits)
    with pytest.raises(ValueError, match="splits"):
        bwd_launch_args(*views, 64, 3)
    with pytest.raises(ValueError, match="groups"):
        bwd_launch_args(x, dt, a, b.expand(1, 3, 128, 64), *views[4:], 64, 1)
    with pytest.raises(ValueError, match="float32"):
        bwd_launch_args(x, dt.double(), *views[2:], 64, splits)
    with pytest.raises(ValueError, match="dstates"):
        bwd_launch_args(*views[:6], dst.transpose(-1, -2), *views[7:], 64,
                        splits)
    with pytest.raises(ValueError, match="rows"):
        bwd_launch_args(*views[:11], rows[:-1], work, 64, splits)
    with pytest.raises(ValueError, match="dcum"):
        bwd_launch_args(*views, 64, splits, torch.zeros(1, 2, 127))
    with pytest.raises(ValueError, match="dc_extra"):
        bwd_launch_args(*views, 64, splits, None,
                        torch.zeros(1, 1, 64, 128).transpose(-1, -2))
    for short in (work[:-16], work[8:]):       # small, unaligned
        with pytest.raises(ValueError, match="work buffer"):
            bwd_launch_args(*views[:12], short, 64, splits)
    # xbc's rows shifted by one element: bf16 rows 2 bytes off 16
    with pytest.raises(ValueError, match="16 bytes"):
        bwd_launch_args(*bwd_views(1, 128, 2, 64, 64, torch.bfloat16,
                                   offset=1)[0], 64, 1)
    bwd_launch_args(*bwd_views(1, 128, 2, 64, 64, torch.float32,
                               offset=1)[0], 64, 1)
    # G = H: b and c one per head
    bwd_launch_args(*bwd_views(1, 128, 2, 64, 64, torch.bfloat16, g=2)[0],
                    64, 1)


@pytest.mark.parametrize("bs,h,g,chunks,tiles,want", [
    (2, 48, 1, 8, 8, 3),       # mamba2-780m's train step: 256 -> 768 blocks
    (2, 64, 1, 16, 4, 3),      # zamba2-1.2b's at 4096 rows
    (2, 3, 3, 2, 1, 1),        # G = H: one head a group
    (1, 256, 1, 64, 64, 4),    # at most 64 heads a block
    (1, 48, 1, 1, 1, 48),      # a short sequence: a block a head
])
def test_bwd_splits_fill_the_card(bs, h, g, chunks, tiles, want):
    assert bwd_splits(bs, h, g, chunks, tiles) == want


def test_bwd_ctypes_signature_matches_the_c_entry_point():
    """The backward builds only on the card, so its binding's argument
    list is held here against the C prototype in the source."""
    src = (CSRC / "ssd_chunk.cu").read_text()
    params = re.search(r"int repro_ssd_chunk_bwd\((.*?)\)", src,
                       re.S).group(1)
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "int64_t": ctypes.c_int64}
    declared = [c_types[re.sub(r"^const ", "", p.strip()).rsplit(" ", 1)[0]
                        .replace(" *", "*")]
                for p in params.split(",")]
    assert declared == BWD_ARGTYPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_bwd_wrapper_takes_the_functions_views(dtype, offset):
    """The autograd Function's backward through the backward wrapper on
    the model's views (xbc's rows shifted by `offset` elements): on the CPU
    the plain backward, written into the given views as into the
    Function's own buffers (`SSDChunked.backward`'s transposed views of
    [B,S,...] tensors); and the card's flow around the launch (dense
    copies, scratch, launch plan, the splits' sum) with a stand-in for the
    kernel."""
    bs, s, h, p, n, q = 2, 128, 3, 16, 32, 64
    x, dt, a, b, c, _, _, _ = model_views(bs, s, h, p, n, dtype, offset)
    gen = torch.Generator().manual_seed(offset)
    for t in (x, dt, b, c):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    a = -torch.rand(h, generator=gen)
    dy = torch.randn(bs, s, h, p, generator=gen).to(dtype)
    dst = torch.randn(bs, s // q, h, p, n, generator=gen)
    views = (x, dt, a.expand(bs, h), b, c, dy.transpose(1, 2),
             dst.transpose(1, 2))
    dx = torch.empty(bs, s, h, p, dtype=dtype)
    ddt = torch.empty(bs, s, h)
    db, dc = torch.empty(bs, s, n, dtype=dtype), torch.empty(bs, s, n,
                                                             dtype=dtype)
    _, _, da, _, _ = ssd_chunk_intra_bwd_heads(
        *views, q, dx=dx.transpose(1, 2), ddt=ddt.transpose(1, 2),
        db=db[:, None], dc=dc[:, None])
    for got, want in zip((dx.transpose(1, 2), ddt.transpose(1, 2), da,
                          db[:, None], dc[:, None]),
                         ssd_chunk_intra_bwd_reference(*views, q)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    launched = []
    dcum, dc_extra = torch.zeros(bs, h, s), torch.zeros(bs, 1, s, n)
    bwd_launch(*views, q, dx.transpose(1, 2), ddt.transpose(1, 2),
               torch.empty(bs, h), db[:, None], dc[:, None], launched.append,
               dcum, dc_extra)
    (args,) = launched
    assert len(args) == len(BWD_ARGTYPES) - 1
    # steps 3-4's terms go to the kernel as pointers
    assert args[13:15] == (dcum.data_ptr(), dc_extra.data_ptr())
    assert args[15:24] == ({torch.float32: 0, torch.bfloat16: 1}[dtype],
                           bs, h, 1, s, q, p, n, bwd_splits(bs, h, 1, 2, 1))


# ---------------------------------------------------------------------- #
# steps 3 and 4: the state passes, their plain versions, the Function of
# all four steps, the launch plans
# ---------------------------------------------------------------------- #

def old_plain_chunked(x, dt, a, b, c, q, init=None):
    """The chunked SSD as models/ssm.py ran it before the state kernels:
    the block's plain version (steps 1 and 2) and plain ops for steps 3
    and 4, in the model's layout, differentiable end to end."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    l = s // q
    cdt = x.dtype
    y, st = ssd_chunk_intra_heads_reference(*heads(x, dt, a, b, c), q)
    y_diag, states = y.transpose(1, 2), st.transpose(1, 2)
    da_cs = torch.cumsum((dt * a).reshape(bs, l, q, h), dim=2)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])
    carry = init.to(states.dtype) if init is not None else \
        torch.zeros((bs, h, p, n), dtype=states.dtype)
    entering = []
    for i in range(l):
        entering.append(carry.to(cdt))
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    entering = torch.stack(entering, dim=1)
    state_decay = torch.exp(da_cs).to(cdt)
    c_c = c.to(cdt).reshape(bs, l, q, n)
    y_off = torch.einsum("blqn,blhpn,blqh->blqhp", c_c, entering, state_decay)
    return y_diag + y_off.reshape(bs, s, h, p), carry


def chunked_inputs(bs, s, h, p, n, seed, overflow=False, dtype=torch.float64):
    """x [B,S,H,P], dt, a [H], b, c [B,S,N], init [B,H,P,N], dy, dfinal;
    `overflow`: dt + 1 and a * 40, a decay past exp's range in a chunk."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)
    dt = torch.nn.functional.softplus(rnd(bs, s, h)) + (1.0 if overflow
                                                         else 0.0)
    a = -torch.exp(rnd(h)) * (40.0 if overflow else 1.0)
    return (rnd(bs, s, h, p), dt, a, rnd(bs, s, n), rnd(bs, s, n),
            rnd(bs, h, p, n), rnd(bs, s, h, p), rnd(bs, h, p, n))


def grads_of(fn, ins, init, dy, dfinal):
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    il = None if init is None else init.detach().clone().requires_grad_()
    y, f = fn(*leaves, il)
    torch.autograd.backward((y, f), (dy, dfinal))
    return (y.detach(), f.detach(),
            [t.grad for t in leaves] + ([il.grad] if il is not None else []))


@pytest.mark.parametrize("case", ["two_chunks", "init", "one_chunk",
                                  "one_row_chunks", "overflow",
                                  "head_slice"])
def test_chunked_function_equals_autograd_of_the_plain_steps(case):
    """The Function of all four steps (SSDChunked) on CPU tensors in
    float64: its forward and every gradient (x, dt, a, b, c and the
    initial state) equal torch.autograd of the plain steps 1-4 as
    models/ssm.py ran them before the state kernels (1e-12 of each
    gradient's size).  With an initial state, with L = 1, with chunks of
    one row, with a decay past exp's range, and on the last rank's head
    slice of a [B,S,6,P] tensor (views, b and c whole)."""
    shape = dict(two_chunks=(2, 32, 3, 8, 16, 16),
                 init=(2, 32, 3, 8, 16, 16), one_chunk=(1, 16, 2, 8, 16, 16),
                 one_row_chunks=(1, 6, 2, 4, 8, 1),
                 overflow=(1, 32, 2, 16, 16, 16),
                 head_slice=(2, 32, 6, 8, 16, 16))[case]
    bs, s, h, p, n, q = shape
    x, dt, a, b, c, init, dy, dfin = chunked_inputs(
        bs, s, h, p, n, seed=len(case), overflow=case == "overflow")
    if case != "init":
        init = None
    if case == "head_slice":
        heads = slice(3, 6)
        x, dt, a, dy = x[:, :, heads], dt[:, :, heads], a[heads], \
            dy[:, :, heads]
        dfin = dfin[:, heads]
        assert not x.is_contiguous()
    ins = (x, dt, a, b, c)
    y, f, got = grads_of(lambda *t: ssd_chunked_bshp(*t[:5], q, t[5]), ins,
                         init, dy, dfin)
    ry, rf, ref = grads_of(lambda *t: old_plain_chunked(*t[:5], q, t[5]),
                           ins, init, dy, dfin)
    torch.testing.assert_close(y, ry, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(f, rf, rtol=1e-12, atol=1e-12)
    for name, g, r in zip(("dx", "ddt", "da", "db", "dc", "dinit"), got, ref):
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max() / r.abs().max().clamp_min(1.0)
        assert err <= 1e-12, (name, err.item())


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("with_init,with_dfinal", [(False, False),
                                                   (True, True)])
@pytest.mark.parametrize("q", [1, 16])
def test_state_bwd_reference_equals_autograd_of_the_plain_forward(
        g, with_init, with_dfinal, q):
    """`ssd_state_bwd_reference` and the block's plain backward, given its
    dcs and dc, against autograd of the plain forwards of all four steps in
    the heads layout, float64: b and c shared by the 3 heads (G = 1) or
    one per head (G = H); dfinal zero or not."""
    bs, h, s, p, n = 2, 3, 2 * q, 8, 16
    x, dt, a, b, c, dy, _ = heads_inputs(bs, h, g, s, p, n, q, seed=q + g)
    gen = torch.Generator().manual_seed(5)
    init = torch.randn(bs, h, p, n, generator=gen, dtype=torch.float64) \
        if with_init else None
    dfin = torch.randn(bs, h, p, n, generator=gen, dtype=torch.float64) \
        if with_dfinal else None
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    il = None if init is None else init.clone().requires_grad_()
    y, st = ssd_chunk_intra_heads_reference(*leaves, q)
    y, fin, _, _, _ = ssd_state_reference(y, st, leaves[1], leaves[2],
                                          leaves[4], q, il)
    loss = (y * dy).sum() + (0 if dfin is None else (fin * dfin).sum())
    loss.backward()
    ref = [t.grad for t in leaves] + ([il.grad] if il is not None else [])
    y0, st0 = ssd_chunk_intra_heads_reference(x, dt, a, b, c, q)
    _, _, ent, car, cs = ssd_state_reference(y0, st0, dt, a, c, q, init)
    dst, dcs, dc_state, dinit = ssd_state_bwd_reference(dy, dfin, car, ent,
                                                        cs, c, q)
    got = list(ssd_chunk_intra_bwd_reference(x, dt, a, b, c, dy, dst, q,
                                             dcum=dcs, dc_extra=dc_state))
    got += [dinit] if with_init else []
    check_grads(got, ref, 1e-12)


def test_state_reference_in_bf16_rounds_where_the_model_did():
    """bf16: the entering states and the state decay are rounded to bf16,
    the carries, the final state and cs stay float32, and y is the model's
    old steps 3 and 4 to the bit."""
    x, dt, a, b, c, init, _, _ = chunked_inputs(2, 32, 3, 16, 16, seed=9,
                                                dtype=torch.float32)
    x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    y, f = ssd_chunked_bshp(x, dt, a, b, c, 16, init)
    ry, rf = old_plain_chunked(x, dt, a, b, c, 16, init)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    assert torch.equal(y, ry) and torch.equal(f, rf)
    yd, st = ssd_chunk_intra_heads_reference(*heads(x, dt, a, b, c), 16)
    _, fin, ent, car, cs = ssd_state_reference(
        yd, st, dt.transpose(1, 2), a.expand(2, 3), c[:, None], 16, init)
    assert ent.dtype == torch.bfloat16 and torch.equal(ent, car.bfloat16())
    assert car.dtype == cs.dtype == fin.dtype == torch.float32


def state_views(bs, s, h, p, n, dtype, q=64, offset=0):
    """The state kernels' arguments as the Function hands them over: the
    block's y [B,S,H,P] and states [B,L,H,P,N] as transposed views, dt
    [B,S,H] transposed, a [B,H] with a batch stride of 0, c [B,1,S,N]
    expanded to the heads (head stride 0) from a slice of the conv output
    shifted by `offset` elements, and the dense outputs."""
    l = s // q
    y = torch.zeros(bs, s, h, p, dtype=dtype).transpose(1, 2)
    st = torch.zeros(bs, l, h, p, n).transpose(1, 2)
    dt = torch.zeros(bs, s, h).transpose(1, 2)
    a = torch.zeros(h).expand(bs, h)
    xbc = torch.zeros(bs, s, offset + h * p + 2 * n, dtype=dtype)[..., offset:]
    c = xbc[..., h * p + n:][:, None].expand(bs, h, s, n)
    fin = torch.empty(bs, h, p, n)
    ent = torch.empty(bs, h, l, p, n, dtype=dtype)
    car = torch.empty(bs, h, l, p, n) if dtype == torch.bfloat16 else None
    cs = torch.empty(bs, h, s)
    return y, st, dt, a, c, None, fin, car, ent, cs


@pytest.mark.parametrize("p", DIMS)
@pytest.mark.parametrize("n", DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_launch_plans_take_every_p_and_n(p, n, dtype):
    """What a CUDA call hands the state kernels' C entry points through
    the Function's views: pointers, dtype, shapes, the P-tile, the head
    splits and every stride (c with a head stride of 0)."""
    bs, s, h, q = 2, 128, 3, 64
    y, st, dt, a, c, init, fin, car, ent, cs = state_views(bs, s, h, p, n,
                                                           dtype)
    ptile = ssd_state.ptile_for(bs, h, p)
    args = ssd_state.fwd_launch_args(y, st, dt, a, c, init, fin, car, ent,
                                     cs, q, ptile)
    assert len(args) == len(ssd_state.FWD_ARGTYPES) - 1
    assert args[:10] == (y.data_ptr(), st.data_ptr(), dt.data_ptr(),
                         a.data_ptr(), c.data_ptr(), None, fin.data_ptr(),
                         None if car is None else car.data_ptr(),
                         ent.data_ptr(), cs.data_ptr())
    assert args[10:18] == ({torch.float32: 0, torch.bfloat16: 1}[dtype],
                           bs, h, s, q, p, n, ptile)
    assert args[18:21] == y.stride()[:3] and args[21:24] == st.stride()[:3]
    assert args[24:29] == dt.stride() + (0, 1)      # a: batch stride 0
    assert args[29:] == (c.stride(0), 0, c.stride(2))
    # the backward: dy as the Function's transposed view, c [B,1,S,N]
    dy = torch.zeros(bs, s, h, p, dtype=dtype).transpose(1, 2)
    c1 = c[:, :1]
    dst, dinit = torch.empty(ent.shape), torch.empty(fin.shape)
    dcs, dc = torch.empty(cs.shape), torch.empty(bs, 1, s, n)
    splits = ssd_state.readout_splits(bs, h, 1, s // q, 1)
    part = torch.empty(splits, bs, 1, s, n)
    carries = ent if car is None else car
    args = ssd_state.bwd_launch_args(dy, None, carries, ent, cs, c1, dst,
                                     dinit, dcs, part, dc, q, splits)
    assert len(args) == len(ssd_state.BWD_ARGTYPES) - 1
    assert args[:11] == (dy.data_ptr(), None, carries.data_ptr(),
                         ent.data_ptr(), cs.data_ptr(), c1.data_ptr(),
                         dst.data_ptr(), dinit.data_ptr(), dcs.data_ptr(),
                         part.data_ptr(), dc.data_ptr())
    assert args[11:20] == ({torch.float32: 0, torch.bfloat16: 1}[dtype],
                           bs, h, 1, s, q, p, n, splits)
    assert args[20:] == dy.stride()[:3] + c1.stride()[:3]


def test_state_launch_plans_refuse_what_the_kernels_do_not_take():
    views = state_views(1, 128, 2, 64, 64, torch.bfloat16)
    y, st, dt, a, c, init, fin, car, ent, cs = views
    ssd_state.fwd_launch_args(*views, 64, 64)
    with pytest.raises(ValueError, match="head dim 48"):
        ssd_state.fwd_launch_args(*state_views(1, 128, 2, 48, 64,
                                               torch.bfloat16), 64, 16)
    with pytest.raises(ValueError, match="state dim 8"):
        ssd_state.fwd_launch_args(*state_views(1, 128, 2, 64, 8,
                                               torch.bfloat16), 64, 16)
    with pytest.raises(ValueError, match=f"> {MAX_CHUNK}"):
        ssd_state.fwd_launch_args(*views, 2 * MAX_CHUNK, 64)
    for ptile in (8, 128):
        with pytest.raises(ValueError, match="ptile"):
            ssd_state.fwd_launch_args(*views, 64, ptile)
    with pytest.raises(ValueError, match="float32"):
        ssd_state.fwd_launch_args(y, st, dt.double(), *views[3:], 64, 64)
    with pytest.raises(ValueError, match="carries"):
        ssd_state.fwd_launch_args(*views[:7], None, ent, cs, 64, 64)
    with pytest.raises(ValueError, match="states"):
        ssd_state.fwd_launch_args(y, st.transpose(-1, -2), *views[2:], 64,
                                  64)
    with pytest.raises(ValueError, match="dense"):
        ssd_state.fwd_launch_args(*views[:8], ent.transpose(1, 2), cs, 64,
                                  64)
    # the conv output's rows shifted by one element: c's bf16 rows 2 bytes
    # off 16; float32 takes any start
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_state.fwd_launch_args(*state_views(1, 128, 2, 64, 64,
                                               torch.bfloat16, offset=1),
                                  64, 64)
    ssd_state.fwd_launch_args(*state_views(1, 128, 2, 64, 64, torch.float32,
                                           offset=1), 64, 64)
    # the backward
    dy = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    c1 = c[:, :1]
    outs = (torch.empty(ent.shape), None, torch.empty(cs.shape),
            torch.empty(1, 1, 1, 128, 64), torch.empty(1, 1, 128, 64))
    ssd_state.bwd_launch_args(dy, None, car, ent, cs, c1, *outs, 64, 1)
    with pytest.raises(ValueError, match="splits"):
        ssd_state.bwd_launch_args(dy, None, car, ent, cs, c1, *outs, 64, 3)
    with pytest.raises(ValueError, match="groups"):
        ssd_state.bwd_launch_args(dy, None, car, ent, cs,
                                  c1.expand(1, 3, 128, 64), *outs, 64, 1)
    with pytest.raises(ValueError, match="dc_part"):
        ssd_state.bwd_launch_args(dy, None, car, ent, cs, c1, *outs[:3],
                                  torch.empty(2, 1, 1, 128, 64), outs[4],
                                  64, 1)
    with pytest.raises(ValueError, match="dfinal"):
        ssd_state.bwd_launch_args(dy, torch.empty(1, 2, 64, 64).double(),
                                  car, ent, cs, c1, *outs, 64, 1)
    off = torch.zeros(dy.numel() + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16 bytes"):       # 2 bytes off
        ssd_state.bwd_launch_args(off.view(1, 128, 2, 64).transpose(1, 2),
                                  None, car, ent, cs, c1, *outs, 64, 1)


@pytest.mark.parametrize("entry,argtypes", [
    ("repro_ssd_state_fwd", "FWD_ARGTYPES"),
    ("repro_ssd_state_bwd", "BWD_ARGTYPES")])
def test_state_ctypes_signatures_match_the_c_entry_points(entry, argtypes):
    """The state kernels build only on the card, so each binding's
    argument list is held here against its C prototype in the source."""
    src = (CSRC / "ssd_state.cu").read_text()
    params = re.search(rf"int {entry}\((.*?)\)", src, re.S).group(1)
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "int64_t": ctypes.c_int64}
    declared = [c_types[re.sub(r"^const ", "", p.strip()).rsplit(" ", 1)[0]
                        .replace(" *", "*")]
                for p in params.split(",")]
    assert declared == getattr(ssd_state, argtypes)


@pytest.mark.parametrize("bs,h,p,want", [
    (2, 48, 64, 32),       # mamba2-780m's train step: 96 -> 192 blocks
    (2, 64, 64, 32),       # zamba2-1.2b's: 128 blocks, below the card's 132
    (4, 48, 64, 64),       # 192 blocks at whole tiles
    (2, 3, 64, 16),        # a rank's 3 heads: as fine as it goes
    (1, 8, 16, 16),        # P of 16: one tile
    (4, 48, 128, 64),      # P of 128: at most 64 rows a block
])
def test_forward_walk_splits_p_to_fill_the_card(bs, h, p, want):
    assert ssd_state.ptile_for(bs, h, p) == want


@pytest.mark.parametrize("bs,h,g,chunks,tiles,want", [
    (2, 48, 1, 8, 8, 3),       # mamba2-780m's train step: 128 -> 384 blocks
    (2, 3, 1, 2, 8, 3),        # a rank's 3 heads: a block a head
    (2, 3, 3, 2, 1, 1),        # G = H: one head a group
    (1, 48, 1, 64, 8, 1),      # many chunks: no split
])
def test_readout_backward_splits_heads_to_fill_the_card(bs, h, g, chunks,
                                                        tiles, want):
    assert ssd_state.readout_splits(bs, h, g, chunks, tiles) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_state_bwd_wrapper_takes_the_functions_views(dtype, offset):
    """The state passes' backward on the CPU (the plain version, written
    into the wrapper's buffers, equal to calling it directly), and the
    card's flow around the launch with a stand-in for the kernels: dense
    copies of dy and c where bf16 rows are off 16 bytes, the head splits'
    buffer (dc itself with one split), the launch plan."""
    bs, s, h, p, n, q = 2, 128, 3, 16, 32, 64
    x, dt, a, b, c, init, dy, dfin = chunked_inputs(bs, s, h, p, n, seed=2,
                                                    dtype=torch.float32)
    xbc = torch.zeros(bs, s, offset + 2 * n, dtype=dtype)[..., offset:]
    xbc[..., n:] = c.to(dtype)
    c = xbc[..., n:]
    y, st = ssd_chunk_intra_heads_reference(
        *heads(x.to(dtype), dt, a, b.to(dtype), c), q)
    _, _, ent, car, cs = ssd_state_reference(
        y, st, dt.transpose(1, 2), a.expand(bs, h), c[:, None], q, init)
    dyh = dy.to(dtype).transpose(1, 2)
    got = ssd_state.ssd_state_bwd_heads(dyh, dfin, car, ent, cs, c[:, None],
                                        q)
    for g_, r in zip(got, ssd_state_bwd_reference(dyh, dfin, car, ent, cs,
                                                  c[:, None], q)):
        torch.testing.assert_close(g_, r, rtol=0, atol=0)
    launched = []
    dst, dcs, dc, dinit = (torch.empty(t.shape) for t in got)
    ssd_state.bwd_launch(dyh, dfin, car, ent, cs, c[:, None], q, dst, dcs,
                         dc, dinit, launched.append)
    (args,) = launched
    splits = ssd_state.readout_splits(bs, h, 1, s // q, 1)
    assert args[11:20] == ({torch.float32: 0, torch.bfloat16: 1}[dtype],
                           bs, h, 1, s, q, p, n, splits)
    assert args[10] == dc.data_ptr() and (args[9] == dc.data_ptr()) == (
        splits == 1)
    copied = offset == 1 and dtype == torch.bfloat16
    assert (args[5] != c.data_ptr()) == copied
