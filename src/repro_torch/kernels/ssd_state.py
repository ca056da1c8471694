"""Steps 3 and 4 of Mamba2's chunked SSD: the wrappers around the Hopper
kernels of `csrc/ssd_state.cu`.

The chunked SSD (`models/ssm.py:ssd_chunked`) runs the intra-chunk block
(steps 1 and 2, `ssd_scan.py`) and then carries each chunk's state into
the next and reads the entering state out through the decay inside the
chunk.  The reference runs those two steps as plain ops; so did the port,
until their ~180 small operations a layer set the pace of training from
the host.  The kernels replace no TPU kernel.  Two entry points:

* `ssd_state_heads(y, states, dt, a, c, chunk, init)`: the forward, in the
  heads layout of `ssd_scan.ssd_chunk_intra_heads` (y [B,H,S,P] holds the
  block's y_diag and gets y in place; states [B,H,L,P,N] are its chunk
  states; dt, a and init in the work dtype, as the card requires); it
  returns the final state and what the backward needs: the
  entering states, their float32 carries and cs = cumsum(dt a);
* `ssd_state_bwd_heads(dy, dfinal, carries, entering, cs, c, chunk)`: the
  gradients the two steps send to the block's states (dstates), to cs
  (dcs) and to c, and to the initial state; `ops.ssd_chunked_bshp`'s
  autograd Function hands dstates, dcs and dc on to the block's backward.

On CUDA tensors each wrapper launches its kernels (building the library at
first use) or raises; on CPU tensors each computes its plain version in
`ref.py` (`ssd_state_reference`, `ssd_state_bwd_reference`), which also
takes float64.  bfloat16 runs its products on the tensor cores (wgmma),
float32 on the CUDA cores.  `fwd_launch_args` and `bwd_launch_args` are
the launch plans; `STATE_KERNEL.launches` and `STATE_BWD_KERNEL.launches`
count launches.  Under a dispatch mode (fake tensors, a counter) each runs
through its custom op, `repro_torch::ssd_state_fwd` / `::ssd_state_bwd`.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .build import contiguous_block, head_strides, rows_aligned
from .ref import ssd_state_bwd_reference, ssd_state_reference, work_dtype
from .ssd_scan import (SMS, TILE, check_call, check_dims, check_dtypes,
                       check_groups)

PTILES = (64, 32, 16)           # rows of P a block of the state passes takes

# repro_ssd_state_fwd's C parameters: y, states, dt, a, c, init, fin,
# carries, entering, cs; dtype, batch, heads, seqlen, chunk, p, n, ptile;
# the strides of y (b, h, s), states (b, h, chunk), dt (b, h, s), a (b, h),
# c (b, h, s); stream
FWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                + [ctypes.c_int64] * 14 + [ctypes.c_void_p])
# repro_ssd_state_bwd's C parameters: dy, dfinal, carries, entering, cs, c,
# dstates, dinit, dcum, dc_part, dc; dtype, batch, heads, groups, seqlen,
# chunk, p, n, splits; the strides of dy (b, h, s), c (b, g, s); stream
BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                + [ctypes.c_int64] * 6 + [ctypes.c_void_p])

STATE_KERNEL = build.Kernel("ssd_state", "repro_ssd_state_fwd", FWD_ARGTYPES)
STATE_BWD_KERNEL = build.Kernel("ssd_state", "repro_ssd_state_bwd",
                                BWD_ARGTYPES)


def ptile_for(bs: int, h: int, p: int) -> int:
    """Rows of P that one block of the forward walk takes: the largest of
    64, 32 and 16 (at most P) that still gives a block a streaming
    multiprocessor, else 16.  The carry's rows are independent, so the walk
    splits exactly; a shape with few (batch, head) pairs (a model rank's
    own heads, one short prompt) takes finer tiles."""
    fits = [t for t in PTILES if t <= p]
    return next((t for t in fits if bs * h * (p // t) >= SMS), fits[-1])


def readout_splits(bs: int, h: int, g: int, chunks: int, tiles: int) -> int:
    """How many blocks share one group's heads in the read-out's backward
    (each sums its own heads' share of dc, and the wrapper adds the splits
    in order): enough blocks for two a streaming multiprocessor, at most
    one block a head."""
    blocks = bs * g * chunks * tiles
    return min(h // g, max(1, -(-2 * SMS // blocks)))


def fwd_launch_args(y, states, dt, a, c, init, fin, carries, entering, cs,
                    chunk: int, ptile: int) -> tuple:
    """repro_ssd_state_fwd's arguments but the stream, for checked y
    [B,H,S,P] (bfloat16 rows on 16 bytes), states [B,H,L,P,N]
    float32 with dense [P, N] blocks, dt [B,H,S] and a [B,H] float32, c
    [B,H,S,N] (a head stride of 0 when shared; bfloat16 rows on 16 bytes),
    init (dense float32 [B,H,P,N] or None), and the dense outputs fin
    [B,H,P,N], carries (float32 [B,H,L,P,N], bfloat16 only; else None),
    entering ([B,H,L,P,N], y's dtype) and cs [B,H,S]; raises on what the
    kernels do not take.  Reads no device memory."""
    bs, h, s, p = y.shape
    n = c.shape[-1]
    check_dims(p, n, chunk)
    if ptile not in PTILES or ptile > p:
        raise ValueError(f"ptile {ptile} must be one of {PTILES}, <= {p}")
    if any(t is not None and t.dtype != torch.float32 for t in (dt, a, init)):
        raise ValueError("dt, a and init must be float32")
    if states.dtype != torch.float32 or not contiguous_block(states):
        raise ValueError("states must be float32 with dense [P, N] blocks "
                         "that start on 16 bytes")
    cst = head_strides(c, h)
    if y.dtype == torch.bfloat16 and not (
            rows_aligned(c, cst) and rows_aligned(y, y.stride()[:3])):
        raise ValueError("bfloat16 rows of c and y must start on 16 bytes")
    if (carries is None) != (y.dtype == torch.float32):
        raise ValueError("carries go with bfloat16 only")
    for name, t in (("init", init), ("fin", fin), ("carries", carries),
                    ("entering", entering), ("cs", cs)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be dense and start on 16 bytes")
    return (y.data_ptr(), states.data_ptr(), dt.data_ptr(), a.data_ptr(),
            c.data_ptr(), None if init is None else init.data_ptr(),
            fin.data_ptr(), None if carries is None else carries.data_ptr(),
            entering.data_ptr(), cs.data_ptr(), build.DTYPE_CODES[y.dtype],
            bs, h, s,
            chunk, p, n, ptile, *y.stride()[:3], *states.stride()[:3],
            *dt.stride(), *a.stride(), *cst)


def ssd_state_heads(y: torch.Tensor, states: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, c: torch.Tensor, chunk: int,
                    init: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Steps 3 and 4 of the chunked SSD (`ref.ssd_state_reference`): y
    [B,H,S,P] holds the intra-chunk output y_diag and is updated in place
    to y; states [B,H,L,P,N] are the block's chunk states, dt [B,H,S], a
    [B,H] and init [B,H,P,N] or None (all in the work dtype), c [B,G,S,N]
    with G = 1 (shared by the heads) or H; any strides with the last dim
    contiguous.
    Returns (final [B,H,P,N], entering [B,H,L,P,N] in y's dtype, carries
    [B,H,L,P,N] (the entering states unrounded; for float32 the same
    tensor as entering), cs [B,H,S]), all but entering in the work dtype.
    On the card, c whose bfloat16 rows are off 16 bytes is copied dense,
    and such a y is updated through a dense copy."""
    bs, h, s, p = y.shape
    g, n = c.shape[1], c.shape[-1]
    check_call(s, chunk, y, states, dt, a, c, init)
    if states.shape != (bs, h, s // chunk, p, n) or dt.shape != (bs, h, s) \
            or a.shape != (bs, h) or c.shape != (bs, g, s, n) \
            or g not in (1, h):
        raise ValueError(f"states {tuple(states.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)} or c "
                         f"{tuple(c.shape)} do not match y {tuple(y.shape)}")
    if init is not None and init.shape != (bs, h, p, n):
        raise ValueError(f"init must be {(bs, h, p, n)}")
    check_dtypes("y and c", y, c)
    if any(t.stride(-1) != 1 for t in (y, c)):
        raise ValueError("the last dim of y and c must be contiguous")
    ft = work_dtype(y)
    kw = dict(device=y.device)
    fin = torch.empty((bs, h, p, n), dtype=ft, **kw)
    entering = torch.empty((bs, h, s // chunk, p, n), dtype=y.dtype, **kw)
    carries = torch.empty(entering.shape, dtype=ft, **kw) \
        if y.dtype != ft else None
    cs = torch.empty((bs, h, s), dtype=ft, **kw)
    build.call(torch.ops.repro_torch.ssd_state_fwd, _state_fwd, y, states,
               dt, a, c, init, chunk, fin, entering, carries, cs)
    return fin, entering, entering if carries is None else carries, cs


def _state_fwd(y: torch.Tensor, states: torch.Tensor, dt: torch.Tensor,
               a: torch.Tensor, c: torch.Tensor,
               init: Optional[torch.Tensor], chunk: int, fin: torch.Tensor,
               entering: torch.Tensor, carries: Optional[torch.Tensor],
               cs: torch.Tensor) -> None:
    """The checked forward, writing y, fin, entering, carries and cs."""
    if y.device.type == "cpu":
        return build.copy_into((y, fin, entering, carries, cs),
                               ssd_state_reference(y, states, dt, a, c,
                                                   chunk, init))
    out_y = y
    if y.dtype == torch.bfloat16:
        if not rows_aligned(c, head_strides(c, y.shape[1])):
            c = c.contiguous()
        if not rows_aligned(y, y.stride()[:3]):
            y = y.contiguous()
    bs, h = y.shape[:2]
    c = c.expand(bs, h, *c.shape[2:])       # G = 1: a head stride of 0
    if not contiguous_block(states):
        states = states.contiguous()
    if init is not None:
        init = init.contiguous()
    STATE_KERNEL.launch_on(y.device, fwd_launch_args(
        y, states, dt, a, c, init, fin, carries, entering, cs, chunk,
        ptile_for(bs, h, y.shape[-1])))
    if out_y is not y:
        out_y.copy_(y)


build.mutating_op("repro_torch::ssd_state_fwd", _state_fwd,
                  ("y", "fin", "entering", "carries", "cs"))


@register_flop_formula(torch.ops.repro_torch.ssd_state_fwd)
def state_fwd_flops(y_shape, states_shape, dt_shape, a_shape, c_shape,
                    *args, out_shape=None, **kwargs) -> int:
    """The read-out's matmul FLOPs, as the plain version's: C . entering^T
    per head and chunk, 2 * B * S * H * P * N."""
    bs, h, s, p = y_shape
    return 2 * bs * s * h * p * c_shape[-1]


# ---------------------------------------------------------------------------
# the backward

def bwd_launch_args(dy, dfinal, carries, entering, cs, c, dstates, dinit,
                    dcum, dc_part, dc, chunk: int, splits: int) -> tuple:
    """repro_ssd_state_bwd's arguments but the stream, for checked dy
    [B,H,S,P] (bfloat16 rows on 16 bytes), dfinal (dense float32 [B,H,P,N]
    or None), carries, entering and cs as the forward wrote them, c
    [B,G,S,N] (bfloat16 rows on 16 bytes), and the dense float32 outputs
    dstates [B,H,L,P,N], dinit [B,H,P,N] (or None), dcum [B,H,S], dc_part
    [splits,B,G,S,N] and dc [B,G,S,N] (the splits' sum; with one split,
    dc_part is dc); raises on what the kernels do not take.  Reads no
    device memory."""
    bs, h, s, p = dy.shape
    g, n = c.shape[1], c.shape[-1]
    check_dims(p, n, chunk)
    check_groups(h, g, splits)
    if dy.dtype == torch.bfloat16 and not (
            rows_aligned(dy, dy.stride()[:3])
            and rows_aligned(c, c.stride()[:3])):
        raise ValueError("bfloat16 rows of dy and c must start on 16 bytes")
    need = dict(dstates=(bs, h, s // chunk, p, n), dinit=(bs, h, p, n),
                dcum=(bs, h, s), dc_part=(splits, bs, g, s, n),
                dc=(bs, g, s, n), dfinal=(bs, h, p, n),
                carries=(bs, h, s // chunk, p, n))
    for name, t in (("dstates", dstates), ("dinit", dinit), ("dcum", dcum),
                    ("dc_part", dc_part), ("dc", dc), ("dfinal", dfinal),
                    ("carries", carries)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != need[name]
                              or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be dense float32 {need[name]} "
                             f"starting on 16 bytes")
    return (dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
            carries.data_ptr(), entering.data_ptr(), cs.data_ptr(),
            c.data_ptr(), dstates.data_ptr(),
            None if dinit is None else dinit.data_ptr(), dcum.data_ptr(),
            dc_part.data_ptr(), dc.data_ptr(), build.DTYPE_CODES[dy.dtype],
            bs, h, g,
            s, chunk, p, n, splits, *dy.stride()[:3], *c.stride()[:3])


def ssd_state_bwd_heads(dy: torch.Tensor, dfinal: Optional[torch.Tensor],
                        carries: torch.Tensor, entering: torch.Tensor,
                        cs: torch.Tensor, c: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, ...]:
    """The backward of `ssd_state_heads` (`ref.ssd_state_bwd_reference`):
    dy [B,H,S,P] in the compute dtype (its last dim contiguous), dfinal
    [B,H,P,N] or None (zero), carries, entering and cs as the forward
    returned them, c [B,G,S,N] with G = 1 or H.  Returns (dstates
    [B,H,L,P,N], dcs [B,H,S], dc [B,G,S,N], dinit [B,H,P,N]), all in the
    work dtype.  On the card, bfloat16
    rows of dy or c off 16 bytes are copied dense first."""
    bs, h, s, p = dy.shape
    g, n = c.shape[1], c.shape[-1]
    if entering.shape != (bs, h, s // chunk, p, n) or \
            cs.shape != (bs, h, s) or c.shape != (bs, g, s, n) \
            or g not in (1, h) or dy.stride(-1) != 1 or \
            (dfinal is not None and dfinal.shape != (bs, h, p, n)):
        raise ValueError("dy, dfinal, entering, cs or c do not match")
    ft = carries.dtype
    kw = dict(dtype=ft, device=dy.device)
    dstates = torch.empty(entering.shape, **kw)
    dcs = torch.empty((bs, h, s), **kw)
    dc = torch.empty((bs, g, s, n), **kw)
    dinit = torch.empty((bs, h, p, n), **kw)
    build.call(torch.ops.repro_torch.ssd_state_bwd, _state_bwd, dy, dfinal,
               carries, entering, cs, c, chunk, dstates, dcs, dc, dinit)
    return dstates, dcs, dc, dinit


def _state_bwd(dy: torch.Tensor, dfinal: Optional[torch.Tensor],
               carries: torch.Tensor, entering: torch.Tensor,
               cs: torch.Tensor, c: torch.Tensor, chunk: int,
               dstates: torch.Tensor, dcs: torch.Tensor, dc: torch.Tensor,
               dinit: torch.Tensor) -> None:
    """The checked backward, writing dstates, dcs, dc and dinit."""
    if dy.device.type == "cpu":
        return build.copy_into((dstates, dcs, dc, dinit),
                               ssd_state_bwd_reference(dy, dfinal, carries,
                                                       entering, cs, c, chunk))
    bwd_launch(dy, dfinal, carries, entering, cs, c, chunk, dstates, dcs, dc,
               dinit, partial(STATE_BWD_KERNEL.launch_on, dy.device))


def bwd_launch(dy, dfinal, carries, entering, cs, c, chunk: int, dstates,
               dcs, dc, dinit, launch: Callable[[tuple], None]) -> None:
    """The card's backward around `launch(args)` (the kernels' launch; a
    stand-in on the CPU in tests): dense copies of what the kernels cannot
    read, the head splits' buffer for dc (the kernels add the splits in
    order), and the launch plan."""
    if dy.dtype == torch.bfloat16:
        if not rows_aligned(dy, dy.stride()[:3]):
            dy = dy.contiguous()
        if not rows_aligned(c, c.stride()[:3]):
            c = c.contiguous()
    if dfinal is not None:
        dfinal = dfinal.contiguous()
    bs, h, s, _ = dy.shape
    g = c.shape[1]
    splits = readout_splits(bs, h, g, s // chunk, -(-chunk // TILE))
    part = dc[None] if splits == 1 else torch.empty(
        (splits, *dc.shape), dtype=torch.float32, device=dy.device)
    launch(bwd_launch_args(dy, dfinal, carries, entering, cs, c, dstates,
                           dinit, dcs, part, dc, chunk, splits))


build.mutating_op("repro_torch::ssd_state_bwd", _state_bwd,
                  ("dstates", "dcs", "dc", "dinit"))


@register_flop_formula(torch.ops.repro_torch.ssd_state_bwd)
def state_bwd_flops(dy_shape, dfinal_shape, carries_shape, entering_shape,
                    *args, out_shape=None, **kwargs) -> int:
    """The matmul FLOPs of the plain backward: dE = (sd o dy)^T C and
    dy entering, each 2 * B * S * H * P * N."""
    bs, h, s, p = dy_shape
    return 4 * bs * s * h * p * entering_shape[-1]
