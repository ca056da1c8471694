"""Mamba2 SSD intra-chunk block: the wrappers around the Hopper kernels.

The forward kernel, `csrc/ssd_chunk.cu`'s `repro_ssd_chunk_fwd`, replaces
the Pallas TPU kernel `_ssd_chunk_kernel` / `ssd_chunk_intra` in
src/repro/kernels/ssd_scan.py; its source says what bounds it on an H100
and how the design answers that.  Two entry points share it:

* `ssd_chunk_intra(x, dt, a, b, c, chunk)`: the Pallas kernel's layout,
  x [BH,S,P], dt [BH,S], a [BH], b, c [BH,S,N];
* `ssd_chunk_intra_heads(...)`: x [B,H,S,P] and b, c [B,G,S,N] with G = H
  or 1, read through their strides, so a transposed view of the model's
  [B,S,H,P] activations and b, c shared by every head are never copied;
  y and the states may be written into views given as `y` and `states`.

The backward kernel, `repro_ssd_chunk_bwd` in the same source, has no
Pallas counterpart (the Pallas kernel has no backward): it was added so
that training runs the block on the card.
`ssd_chunk_intra_bwd_heads(x, dt, a, b, c, dy, dstates, chunk)` takes the
heads layout and returns the gradients of x, dt, a, b and c.  Training
reaches both through `ops.ssd_chunked_bshp`, which makes the dtype casts:
dt and a come in the work dtype, and the card refuses others.

On CUDA tensors each wrapper launches its kernel (building the library at
first use) or raises; on CPU tensors each computes its plain version in
`ref.py`, which also takes float64 (the CPU tests' gradcheck).  bfloat16
runs on the tensor cores (wgmma), float32 on the CUDA cores;
`launch_args` and `bwd_launch_args` are the launch plans.
`KERNEL.launches` and `BWD_KERNEL.launches` count launches.  The wrappers
refuse inputs that require grad, so no gradient is silently lost by a
direct call.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .build import contiguous_block, head_strides, rows_aligned
from .ref import (ssd_chunk_intra_bwd_reference,
                  ssd_chunk_intra_heads_reference, work_dtype)

DIMS = (16, 32, 64, 128)        # head dims P and state dims N it takes
MAX_CHUNK = 4096
# repro_ssd_chunk_fwd's C parameters: x, dt, a, b, c, y, states, work;
# dtype, batch, heads, seqlen, chunk, p, n; the strides of x, dt (b, h, s),
# a (b, h), b, c, y (b, h, s), states (b, h, chunk); stream
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 20
            + [ctypes.c_void_p])
TILE = 64                       # the kernel's rows per tile

KERNEL = build.Kernel("ssd_chunk", "repro_ssd_chunk_fwd", ARGTYPES)


def _check(x, dt, a, b, c, chunk, *more) -> None:
    """x, dt, a, b, c in the heads layout, and what `check_call` refuses of
    them and of `more`."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    if dt.shape != (bs, h, s) or a.shape != (bs, h):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if b.shape != c.shape or b.shape[0] != bs or b.shape[2] != s \
            or g not in (1, h):
        raise ValueError(f"b {tuple(b.shape)} / c {tuple(c.shape)} do not "
                         f"match x {tuple(x.shape)}")
    check_dtypes("x, b, c", x, b, c)
    check_call(s, chunk, x, dt, a, b, c, *more)


def check_dtypes(names: str, *tensors) -> None:
    """`tensors` (named `names`) share float32 or bfloat16, or float64 on
    the CPU (the plain versions')."""
    t = tensors[0]
    if len({u.dtype for u in tensors}) != 1 or not (
            t.dtype in build.COMPUTE_DTYPES
            or t.dtype == torch.float64 and t.device.type == "cpu"):
        raise ValueError(f"{names} must share float32 or bfloat16 (or "
                         f"float64 on the CPU), got "
                         f"{[u.dtype for u in tensors]}")


def check_call(s: int, chunk: int, *tensors) -> None:
    """What every SSD wrapper refuses: a chunk that does not divide the
    sequence, tensors on more than one device or on another than cuda or
    cpu, and inputs that require grad (None: an input not given)."""
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    given = [t for t in tensors if t is not None]
    if len({t.device for t in given}) != 1:
        raise ValueError("the SSD kernels' tensors must be on one device")
    if given[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD kernels run on cuda or cpu, not "
                         f"{given[0].device}")
    if any(t.requires_grad for t in given):
        raise ValueError("a direct call of the SSD kernels has no "
                         "backward: inputs that require grad go through "
                         "repro_torch.kernels.ops.ssd_chunked_bshp")


def output(name: str, out: Optional[torch.Tensor], shape: tuple,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A wrapper's output `name`: `out` where the caller gave one (a view
    of that shape and dtype on `device`), else a new tensor."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if out.shape != shape or out.dtype != dtype or out.device != device:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {out.dtype} {tuple(out.shape)}")
    return out


def check_dims(p: int, n: int, chunk: int) -> None:
    """The head and state dims and the chunk the SSD kernels take."""
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"head dim {p} and state dim {n} must be in {DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")


def check_groups(h: int, g: int, splits: int) -> None:
    """b and c (or c) in 1 or H groups, and a backward's head splits."""
    if g not in (1, h):
        raise ValueError(f"the groups of b, c must be 1 or {h}, not {g}")
    if not 1 <= splits <= h // g:
        raise ValueError(f"splits {splits} must be in [1, {h // g}]")


def dense_if_unaligned(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, b, c of `ssd_chunk_intra_heads`, each copied to a dense tensor
    where its rows do not start on 16 bytes (what the bfloat16 kernel's
    loads need), else as given."""
    h = x.shape[1]
    return (x if rows_aligned(x, x.stride()[:3]) else x.contiguous(),
            *(t if rows_aligned(t, head_strides(t, h)) else t.contiguous()
              for t in (b, c)))


def work_bytes(x: torch.Tensor, chunk: int) -> int:
    """Bytes of the bfloat16 kernel's work buffer for x [B,H,S,P]: cum
    (float64) and dt (float32) of every chunk, padded to whole tiles."""
    bs, h, s, _ = x.shape
    return 12 * -(-chunk // TILE) * TILE * bs * h * (s // chunk)


def launch_args(x, dt, a, b, c, y, states, work, chunk: int) -> tuple:
    """repro_ssd_chunk_fwd's arguments but the stream, for checked x, dt
    (float32), a (float32), b, c in `ssd_chunk_intra_heads`' layout, the
    outputs y and states, and `work` (uint8, `work_bytes`; None for
    float32); raises on what the kernel does not take.  Reads no device
    memory."""
    bs, h, s, p = x.shape
    n = b.shape[-1]
    check_dims(p, n, chunk)
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("dt and a must be float32")
    bst, cst = head_strides(b, h), head_strides(c, h)
    if x.dtype == torch.bfloat16 and not all(
            rows_aligned(t, st) for t, st in
            ((x, x.stride()[:3]), (b, bst), (c, cst), (y, y.stride()[:3]))):
        raise ValueError("bfloat16 rows of x, b, c and y must start on "
                         "16 bytes")
    if x.dtype == torch.bfloat16 and (
            work is None or work.numel() * work.element_size()
            < work_bytes(x, chunk) or work.data_ptr() % 16):
        raise ValueError(f"bfloat16 needs a 16-byte aligned work buffer of "
                         f"{work_bytes(x, chunk)} bytes")
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), states.data_ptr(),
            None if work is None else work.data_ptr(),
            build.DTYPE_CODES[x.dtype],
            bs, h, s, chunk, p, n, *x.stride()[:3], *dt.stride(),
            *a.stride(), *bst, *cst, *y.stride()[:3], *states.stride()[:3])


def ssd_chunk_intra_heads(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor, chunk: int, *,
                          y: Optional[torch.Tensor] = None,
                          states: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,H,S,P]; dt: [B,H,S] and a: [B,H] in the work dtype; b, c:
    [B,G,S,N] with G = H or 1 (every head reads the same b, c); any
    strides with the last dim contiguous, on every device (a stride of 0
    broadcasts).  Returns (y [B,H,S,P] in x's dtype, states
    [B,H,S/chunk,P,N] float32, float64 for float64 inputs, which only the
    CPU's plain version takes), written into `y` and `states` when given
    (views of those shapes, last dims contiguous).  On the card, a
    bfloat16 x, b or c whose rows do not start on 16 bytes is copied to a
    dense tensor first, and such a `y` is written through one.  Under a
    dispatch mode (fake tensors, a counter) it runs through the custom op
    `repro_torch::ssd_chunk_intra_heads`; a plain call runs the op's body
    directly."""
    _check(x, dt, a, b, c, chunk)
    bs, h, s, p = x.shape
    n = b.shape[-1]
    y = output("y", y, (bs, h, s, p), x.dtype, x.device)
    states = output("states", states, (bs, h, s // chunk, p, n),
                    work_dtype(x), x.device)
    if any(t.stride(-1) != 1 for t in (x, b, c, y, states)) \
            or states.stride(-2) != n:
        raise ValueError("the last dim of x, b, c, y and the [P, N] block of "
                         "states must be contiguous")
    build.call(torch.ops.repro_torch.ssd_chunk_intra_heads, _ssd, x, dt, a,
               b, c, chunk, y, states)
    return y, states


def _ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, chunk: int, y: torch.Tensor,
         states: torch.Tensor) -> None:
    """The checked call, writing y and states."""
    if x.device.type == "cpu":
        return build.copy_into((y, states), ssd_chunk_intra_heads_reference(
            x, dt, a, b, c, chunk))
    out_y = y
    if x.dtype == torch.bfloat16:
        x, b, c = dense_if_unaligned(x, b, c)
        if not rows_aligned(y, y.stride()[:3]):
            y = torch.empty(y.shape, dtype=x.dtype, device=x.device)
    work = torch.empty(work_bytes(x, chunk), dtype=torch.uint8,
                       device=x.device) if x.dtype == torch.bfloat16 else None
    KERNEL.launch_on(x.device, launch_args(x, dt, a, b, c, y, states, work,
                                           chunk))
    if out_y is not y:
        out_y.copy_(y)


build.mutating_op("repro_torch::ssd_chunk_intra_heads", _ssd,
                  ("y", "states"))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_intra_heads)
def ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *args,
              out_shape=None, **kwargs) -> int:
    """The matmul FLOPs of the plain version, per chunk of Q rows: C.B^T
    once per group of b, c (2 Q Q N), and per head its masked product with
    x dt (2 Q Q P) and the state (2 P Q N):
    2 * B * S * (G Q N + H (Q P + P N))."""
    bs, h, s, p = x_shape
    g, n = b_shape[1], b_shape[-1]
    return 2 * bs * s * (g * chunk * n + h * (chunk * p + p * n))


def ssd_chunk_intra(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's layout: x [BH,S,P], dt [BH,S], a [BH], b, c
    [BH,S,N], dt and a of any float dtype (cast to the work dtype here).
    Returns (y_diag [BH,S,P] in x's dtype, states [BH,S/chunk,P,N]
    float32)."""
    if x.dim() != 3 or dt.dim() != 2 or a.dim() != 1 or b.dim() != 3 \
            or c.dim() != 3:
        raise ValueError("x, dt, a, b, c must be [BH,S,P], [BH,S], [BH], "
                         "[BH,S,N], [BH,S,N]")
    ft = work_dtype(x)
    y, states = ssd_chunk_intra_heads(
        x[:, None], dt.to(ft)[:, None], a.to(ft)[:, None], b[:, None],
        c[:, None], chunk)
    return y[:, 0], states[:, 0]


# ---------------------------------------------------------------------------
# the backward

# repro_ssd_chunk_bwd's C parameters: x, dt, a, b, c, dy, dstates, dx, ddt,
# da, part, rows, work, dcum, dc_extra; dtype, batch, heads, groups,
# seqlen, chunk, p, n, splits; the strides of x, dt (b, h, s), a (b, h),
# b, c (b, g, s), dy (b, h, s), dstates (b, h, chunk), dx, ddt (b, h, s);
# stream
BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                + [ctypes.c_int64] * 26 + [ctypes.c_void_p])
SMS = 132                       # an H100 SXM's streaming multiprocessors
MAX_SPLIT_HEADS = 64            # heads of one block of the dB / dC pass

BWD_KERNEL = build.Kernel("ssd_chunk", "repro_ssd_chunk_bwd", BWD_ARGTYPES)


def bwd_splits(bs: int, h: int, g: int, chunks: int, row_tiles: int) -> int:
    """How many blocks of the dB / dC pass share one group's heads (each
    sums its own heads' dS and writes a partial dB, dC that the wrapper
    adds in order): enough blocks for four a streaming multiprocessor,
    at most MAX_SPLIT_HEADS heads a block, at most one block a head."""
    hpg = h // g
    blocks = bs * g * chunks * 2 * row_tiles
    return min(hpg, max(1, -(-4 * SMS // blocks), -(-hpg // MAX_SPLIT_HEADS)))


def bwd_scratch(x: torch.Tensor, b: torch.Tensor, chunk: int, splits: int
                ) -> dict:
    """Elements of the backward's scratch tensors for x [B,H,S,P], b
    [B,G,S,N]: `rows` (float64), four values a row and head (the rows and
    columns of dM o M summed, the states' decay term, x's share of ddt);
    `part` (float32), each split's dB and dC; `da` (float32), d(dt a) dt
    summed over each chunk."""
    bs, h, s, _ = x.shape
    g, n = b.shape[1], b.shape[-1]
    return dict(rows=4 * bs * h * s, part=2 * splits * bs * g * s * n,
                da=bs * h * (s // chunk))


SCRATCH_DTYPES = dict(rows=torch.float64, part=torch.float32,
                      da=torch.float32)


def bwd_launch_args(x, dt, a, b, c, dy, dstates, dx, ddt, da, part, rows,
                    work, chunk: int, splits: int, dcum=None,
                    dc_extra=None) -> tuple:
    """repro_ssd_chunk_bwd's arguments but the stream, for checked x, dt
    (float32), a (float32) [B,H], b, c [B,G,S,N], dy [B,H,S,P] (x's dtype),
    dstates [B,H,L,P,N] float32, the outputs dx (x's dtype) and ddt
    (float32) in x's and dt's layouts, the scratch `da`, `part`,
    `rows` (`bwd_scratch`, `SCRATCH_DTYPES`) and `work` (uint8,
    `work_bytes`), `dcum` (dense float32 [B,H,S] added to the gradient
    of cum, or None) and `dc_extra` (dense float32 [B,G,S,N] added to the
    first split's dC, or None);
    raises on what the kernel does not take.  Reads no device memory."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    check_dims(p, n, chunk)
    check_groups(h, g, splits)
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("dt and a must be float32")
    if any(t.stride(-1) != 1 for t in (x, b, c, dy, dx)):
        raise ValueError("the last dim of x, b, c, dy and dx must be "
                         "contiguous")
    if not contiguous_block(dstates):
        raise ValueError("dstates' [P, N] blocks must be contiguous and "
                         "start on 16 bytes")
    if x.dtype == torch.bfloat16 and not all(
            rows_aligned(t, t.stride()[:3]) for t in (x, b, c, dy, dx)):
        raise ValueError("bfloat16 rows of x, b, c, dy and dx must start on "
                         "16 bytes")
    need = bwd_scratch(x, b, chunk, splits)
    for name, t in (("rows", rows), ("part", part), ("da", da)):
        if t.dtype != SCRATCH_DTYPES[name] or t.numel() < need[name] or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be {need[name]} contiguous "
                             f"{SCRATCH_DTYPES[name]}")
    if work.numel() * work.element_size() < work_bytes(x, chunk) or \
            work.data_ptr() % 16:
        raise ValueError(f"the backward needs a 16-byte aligned work buffer "
                         f"of {work_bytes(x, chunk)} bytes")
    for name, t, shape in (("dcum", dcum, dt.shape),
                           ("dc_extra", dc_extra, c.shape)):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be dense float32 {tuple(shape)}")
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dy.data_ptr(), dstates.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), part.data_ptr(), rows.data_ptr(),
            work.data_ptr(), *(None if t is None else t.data_ptr()
                               for t in (dcum, dc_extra)),
            build.DTYPE_CODES[x.dtype], bs, h, g, s, chunk, p, n,
            splits, *x.stride()[:3], *dt.stride(), *a.stride(),
            *b.stride()[:3], *c.stride()[:3], *dy.stride()[:3],
            *dstates.stride()[:3], *dx.stride()[:3], *ddt.stride())


def ssd_chunk_intra_bwd_heads(x: torch.Tensor, dt: torch.Tensor,
                              a: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor, dy: torch.Tensor,
                              dstates: torch.Tensor, chunk: int, *,
                              dx: Optional[torch.Tensor] = None,
                              ddt: Optional[torch.Tensor] = None,
                              db: Optional[torch.Tensor] = None,
                              dc: Optional[torch.Tensor] = None,
                              dcum: Optional[torch.Tensor] = None,
                              dc_extra: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The gradients of `ssd_chunk_intra_heads` given dy [B,H,S,P] (x's
    dtype) and dstates [B,H,L,P,N] (float32), for its inputs (x [B,H,S,P],
    dt [B,H,S], a [B,H], b, c [B,G,S,N] with G = H or 1): (dx in x's
    dtype, ddt [B,H,S] and da [B,H] float32 (float64 for float64 inputs),
    db, dc [B,G,S,N] in b's dtype; a group's db, dc summed over its
    heads), written into `dx`,
    `ddt`, `db`, `dc` when given (views of those shapes, last dims
    contiguous).  `dcum` [B,H,S] and `dc_extra` [B,G,S,N] (work dtype,
    optional) are the gradients that steps 3 and 4 of the chunked SSD send
    to cum = cumsum(dt a) and to c (`ssd_state.ssd_state_bwd_heads`): dcum
    is added to the block's own before the reverse cumsum that gives ddt
    and da, dc_extra to dc before its rounding.  Inputs that require grad
    are refused, as by the forward.  On the card, bfloat16 rows off 16
    bytes and dstates whose [P, N] blocks are not dense are copied first.
    Under a dispatch mode it runs through the custom op
    `repro_torch::ssd_chunk_intra_bwd`."""
    _check(x, dt, a, b, c, chunk, dy, dstates)
    bs, h, s, p = x.shape
    n = b.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)}")
    if dstates.shape != (bs, h, s // chunk, p, n):
        raise ValueError(f"dstates must be {(bs, h, s // chunk, p, n)}")
    acc = work_dtype(x)
    dx = output("dx", dx, x.shape, x.dtype, x.device)
    ddt = output("ddt", ddt, dt.shape, acc, x.device)
    db = output("db", db, b.shape, b.dtype, x.device)
    dc = output("dc", dc, c.shape, c.dtype, x.device)
    if any(t.stride(-1) != 1 for t in (dx, db, dc)):
        raise ValueError("the last dim of dx, db and dc must be contiguous")
    da = torch.empty((bs, h), dtype=acc, device=x.device)
    for name, t, shape in (("dcum", dcum, dt.shape), ("dc_extra", dc_extra,
                                                      c.shape)):
        if t is not None and (t.shape != shape or t.dtype != acc):
            raise ValueError(f"{name} must be {acc} {tuple(shape)}")
    build.call(torch.ops.repro_torch.ssd_chunk_intra_bwd, _ssd_bwd, x, dt, a,
               b, c, dy, dstates.to(acc), chunk, dx, ddt, da, db, dc, dcum,
               dc_extra)
    return dx, ddt, da, db, dc


def _ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
             dstates: torch.Tensor, chunk: int, dx: torch.Tensor,
             ddt: torch.Tensor, da: torch.Tensor, db: torch.Tensor,
             dc: torch.Tensor, dcum: Optional[torch.Tensor] = None,
             dc_extra: Optional[torch.Tensor] = None) -> None:
    """The checked backward, writing dx, ddt, da, db and dc."""
    if x.device.type == "cpu":
        return build.copy_into((dx, ddt, da, db, dc),
                               ssd_chunk_intra_bwd_reference(
                                   x, dt, a, b, c, dy, dstates, chunk, dcum,
                                   dc_extra))
    bwd_launch(x, dt, a, b, c, dy, dstates, chunk, dx, ddt, da, db, dc,
               partial(BWD_KERNEL.launch_on, x.device), dcum, dc_extra)


def bwd_launch(x, dt, a, b, c, dy, dstates, chunk: int, dx, ddt, da, db, dc,
               launch: Callable[[tuple], None], dcum=None,
               dc_extra=None) -> None:
    """The card's backward around `launch(args)` (the kernel's launch; a
    stand-in on the CPU in tests): dense copies of what the kernel cannot
    read, the scratch, the launch plan, then the splits' partial dB and dC
    added in order (the kernel adds `dc_extra` into the first split's dC),
    da summed over the chunks, and dx copied back where it was written
    through a dense tensor."""
    out_dx = dx
    if x.dtype == torch.bfloat16:
        x, b, c = dense_if_unaligned(x, b, c)
        if not rows_aligned(dy, dy.stride()[:3]):
            dy = dy.contiguous()
        if not rows_aligned(dx, dx.stride()[:3]):
            dx = torch.empty(dx.shape, dtype=x.dtype, device=x.device)
    if not contiguous_block(dstates):
        dstates = dstates.contiguous()
    bs, h, s, _ = x.shape
    g, n = b.shape[1], b.shape[-1]
    splits = bwd_splits(bs, h, g, s // chunk, -(-chunk // TILE))
    rows, part, da_chunks = (
        torch.empty(n, dtype=SCRATCH_DTYPES[name], device=x.device)
        for name, n in bwd_scratch(x, b, chunk, splits).items())
    work = torch.empty(work_bytes(x, chunk), dtype=torch.uint8,
                       device=x.device)
    dcum, dc_extra = (None if t is None else t.contiguous()
                      for t in (dcum, dc_extra))
    launch(bwd_launch_args(x, dt, a, b, c, dy, dstates, dx, ddt, da_chunks,
                           part, rows, work, chunk, splits, dcum, dc_extra))
    part = part.view(2, splits, bs, g, s, n).sum(1)
    db.copy_(part[0])
    dc.copy_(part[1])
    torch.sum(da_chunks.view(bs, h, -1), -1, out=da)
    if out_dx is not dx:
        out_dx.copy_(dx)


build.mutating_op("repro_torch::ssd_chunk_intra_bwd", _ssd_bwd,
                  ("dx", "ddt", "da", "db", "dc"))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_intra_bwd)
def ssd_bwd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, dy_shape,
                  dstates_shape, chunk, *args, out_shape=None,
                  **kwargs) -> int:
    """The matmul FLOPs of the plain backward, per chunk of Q rows: C.B^T
    again, dC and dB once per group of b, c (3 x 2 Q Q N), and per head
    dM = dy xdt^T and M^T dy (2 x 2 Q Q P) and the states' two terms
    (2 x 2 P Q N): 2 * B * S * (3 G Q N + 2 H (Q P + P N))."""
    bs, h, s, p = x_shape
    g, n = b_shape[1], b_shape[-1]
    return 2 * bs * s * (3 * g * chunk * n + 2 * h * (chunk * p + p * n))
