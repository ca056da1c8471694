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

Tolerances (chip_smoke.py's SSD_TOL and SSD_TOL_BF16_Y): states, float32,
atol 1e-4 + rtol 1e-4 (two bf16 parts carry each term to ~2**-16, over up
to 512 terms); y, bf16, atol 1e-3 + rtol 2**-7 (one bf16 rounding of
float32 values that agree to ~1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_intra as jax_ssd_chunk_intra
from repro_torch.kernels import ssd_chunk_intra_reference
from repro_torch.kernels.ssd_scan import (ARGTYPES, DIMS, MAX_CHUNK,
                                          dense_if_unaligned, launch_args,
                                          work_bytes)

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
    ry, rst = ssd_chunk_intra_reference(tx, tdt, ta, tb, tc, q)
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
    _, rst = ssd_chunk_intra_reference(tx, tdt, ta, tb, tc, 512)
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
    shift every row of xbc.  And y, states as ops.ssd_chunk_intra_bshp
    allocates them, as transposed views, and the bf16 work buffer for a
    chunk of 64."""
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
