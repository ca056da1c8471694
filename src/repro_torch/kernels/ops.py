"""Layout adapters between the models and the kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention
from .ref import work_dtype
from .ssd_scan import ssd_chunk_intra_bwd_heads, ssd_chunk_intra_heads
from .ssd_state import ssd_state_bwd_heads, ssd_state_heads


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         spec, logit_cap: Optional[float]) -> torch.Tensor:
    """q: [B,S,H,D], k/v: [B,T,Hkv,D] -> [B,S,H,D]; the MaskSpec becomes the
    kernel's flags.  Query row i and kv row j are positions i and j: the
    caller guarantees that (see `repro_torch.models.attention.attend`).
    The kernel reads and writes the transposed views through their strides,
    so no copy is made."""
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=spec.causal, window=spec.window, prefix_len=spec.prefix_len,
        logit_cap=logit_cap)
    return out.transpose(1, 2)


def ssd_chunk_intra_bshp(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1 and 2 of `ssd_chunked` in its own layout: x [B,S,H,P], dt
    [B,S,H], a [H], b, c [B,S,N] shared by every head.  Returns (y_diag
    [B,S,H,P] in x's dtype, states [B,L,H,P,N] float32), L = S/chunk.

    The kernel reads x and dt as transposed views, b and c with a head stride
    of 0 and a as [B,H] with a batch stride of 0, and writes y and the states
    into [B,S,H,P] and [B,L,H,P,N] tensors through transposed views: nothing
    is copied.  Inputs that require grad are refused: under autograd the
    block runs inside `ssd_chunked_bshp`'s Function.  On CPU tensors the
    wrapper computes the plain version, in float64 too."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    states = torch.empty((bs, s // chunk, h, p, n), dtype=work_dtype(x),
                         device=x.device)
    ssd_chunk_intra_heads(*heads_views(x, dt, a, b, c), chunk,
                          y=y.transpose(1, 2), states=states.transpose(1, 2))
    return y, states


def heads_views(x, dt, a, b, c) -> tuple:
    """The [B,S,...] tensors as views in the layout of
    `ssd_scan.ssd_chunk_intra_heads`."""
    bs, _, h, _ = x.shape
    return (x.transpose(1, 2), dt.transpose(1, 2), a.expand(bs, h),
            b[:, None], c[:, None])


def ssd_chunked_bshp(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, chunk: int,
                     init: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All four steps of the chunked SSD (`models/ssm.py:ssd_chunked`) on
    the kernels, in its layout: x [B,S,H,P], dt [B,S,H], a [H], b, c
    [B,S,N] shared by every head (x, b, c in the compute dtype; dt, a in
    the work dtype), init [B,H,P,N] (work dtype) or None.  Returns (y
    [B,S,H,P] in x's dtype, final state [B,H,P,N] in the work dtype).

    Steps 1 and 2 are the SSD block (`ssd_chunk_intra_bshp`), steps 3 and
    4 the state passes (`ssd_state.ssd_state_heads`), which add the read-out
    into the block's y in place.  Under autograd (grad enabled, an input
    that requires grad) the call is `SSDChunked`: those kernels, then the
    state passes' backward and the block's backward.  On CPU tensors the
    wrappers compute the plain versions, in float64 too (gradcheck's
    dtype)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, init)):
        return SSDChunked.apply(x, dt, a, b, c, chunk, init)
    return _chunked(x, dt, a, b, c, chunk, init)[:2]


def _chunked(x, dt, a, b, c, chunk: int, init) -> tuple:
    """(y, final, entering, carries, cs): the forward and what the
    backward needs of it."""
    y, states = ssd_chunk_intra_bshp(x, dt, a, b, c, chunk)
    bs, _, h, _ = x.shape
    final, entering, carries, cs = ssd_state_heads(
        y.transpose(1, 2), states.transpose(1, 2), dt.transpose(1, 2),
        a.expand(bs, h), c[:, None], chunk, init)
    return y, final, entering, carries, cs


class SSDChunked(torch.autograd.Function):
    """`ssd_chunked_bshp` under autograd.  The forward runs the kernels on
    the detached inputs (the same calls as without grad) and saves x, dt,
    a, b, c, the entering states, their float32 carries (bfloat16 only:
    the float32 entering states are their own) and cs; the backward is the
    state passes' backward (dstates, the gradient of cs, c's read-out
    term and the initial state's gradient), then the block's backward,
    which takes the gradient of cs into its reverse cumsum and c's term
    into dc."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int, init):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        y, final, entering, carries, cs = _chunked(
            *(t.detach() for t in (x, dt, a, b, c)), chunk,
            None if init is None else init.detach())
        ctx.save_for_backward(x, dt, a, b, c, entering,
                              None if carries is entering else carries, cs)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, entering, carries, cs = (
            None if t is None else t.detach() for t in ctx.saved_tensors)
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        dstates, dcs, dc_state, dinit = ssd_state_bwd_heads(
            dy.transpose(1, 2), dfinal, entering if carries is None
            else carries, entering, cs, c[:, None], ctx.chunk)
        grads = ssd_chunk_intra_bshp_bwd(x, dt, a, b, c, dy,
                                         dstates.transpose(1, 2), ctx.chunk,
                                         dcum=dcs, dc_extra=dc_state)
        return grads + (None, dinit if ctx.needs_input_grad[6] else None)


def ssd_chunk_intra_bshp_bwd(x, dt, a, b, c, dy, dstates, chunk: int,
                             dcum=None, dc_extra=None
                             ) -> Tuple[torch.Tensor, ...]:
    """The SSD block's backward in `ssd_chunk_intra_bshp`'s layout: the
    gradients (dx, ddt, da [H], db, dc) of its inputs, given dy [B,S,H,P]
    and dstates [B,L,H,P,N], and, from steps 3 and 4, dcum [B,H,S] (the
    gradient of cumsum(dt a)) and dc_extra [B,1,S,N] (c's read-out term)
    or None."""
    bs, s, h, p = x.shape
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    ddt = torch.empty((bs, s, h), dtype=work_dtype(x), device=x.device)
    db = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    dc = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    _, _, da, _, _ = ssd_chunk_intra_bwd_heads(
        *heads_views(x, dt, a, b, c), dy.transpose(1, 2),
        dstates.transpose(1, 2), chunk, dx=dx.transpose(1, 2),
        ddt=ddt.transpose(1, 2), db=db[:, None], dc=dc[:, None], dcum=dcum,
        dc_extra=dc_extra)
    return dx, ddt.to(dt.dtype), da.sum(0).to(a.dtype), db, dc
