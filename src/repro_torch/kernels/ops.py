"""Layout adapters between the models and the kernels.  `ssd_chunked_bshp`
is the chunked SSD's one entry: it makes the dtype casts, and `_chunked`
forms the kernels' heads-layout views once for forward and backward."""
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


def ssd_chunked_bshp(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, chunk: int,
                     init: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All four steps of the chunked SSD (`models/ssm.py:ssd_chunked`) on
    the kernels, in its layout: x [B,S,H,P], dt [B,S,H], a [H], b, c
    [B,S,N] shared by every head, init [B,H,P,N] or None.  Returns (y
    [B,S,H,P] in x's dtype, final state [B,H,P,N] in the work dtype).

    The dtype contract: x sets the compute dtype, into which b and c are
    cast; dt, a and init are cast to the work dtype (`ref.work_dtype`:
    float32, float64 for float64 x), in which the kernels sum.  Below this
    call nothing is cast again.

    Steps 1 and 2 are the SSD block (`ssd_scan.ssd_chunk_intra_heads`),
    steps 3 and 4 the state passes (`ssd_state.ssd_state_heads`), which
    add the read-out into the block's y in place.  Under autograd (grad
    enabled, an input that requires grad) the call is `SSDChunked`: those
    kernels, then the state passes' backward and the block's backward.  On
    CPU tensors the wrappers compute the plain versions, in float64 too
    (gradcheck's dtype)."""
    ft = work_dtype(x)
    dt, a, b, c = dt.to(ft), a.to(ft), b.to(x.dtype), c.to(x.dtype)
    init = None if init is None else init.to(ft)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, init)):
        return SSDChunked.apply(x, dt, a, b, c, chunk, init)
    return _chunked(x, dt, a, b, c, chunk, init)[:2]


def _chunked(x, dt, a, b, c, chunk: int, init) -> tuple:
    """(y, final, heads, entering, carries, cs): the forward, and what the
    backward needs of it; `heads` are x, dt, a, b, c as the kernels read
    them, x [B,H,S,P] and dt [B,H,S] transposed views, a [B,H] with a
    batch stride of 0, b and c [B,1,S,N] with a head stride of 0 (every
    head reads them).  The block writes y and the states into [B,S,H,P]
    and [B,L,H,P,N] tensors through transposed views: nothing is copied."""
    bs, s, h, p = x.shape
    heads = (x.transpose(1, 2), dt.transpose(1, 2), a.expand(bs, h),
             b[:, None], c[:, None])
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    states = torch.empty((bs, s // chunk, h, p, b.shape[-1]),
                         dtype=work_dtype(x), device=x.device)
    ssd_chunk_intra_heads(*heads, chunk, y=y.transpose(1, 2),
                          states=states.transpose(1, 2))
    final, entering, carries, cs = ssd_state_heads(
        y.transpose(1, 2), states.transpose(1, 2), heads[1], heads[2],
        heads[4], chunk, init)
    return y, final, heads, entering, carries, cs


class SSDChunked(torch.autograd.Function):
    """`ssd_chunked_bshp` under autograd.  The forward runs the kernels on
    the detached inputs (the same calls as without grad) and saves their
    heads-layout views, the entering states, their float32 carries
    (bfloat16 only: the float32 entering states are their own) and cs;
    the backward is the state passes' backward (dstates, the gradient of
    cs, c's read-out term and the initial state's gradient), then the
    block's backward, which takes the gradient of cs into its reverse
    cumsum and c's term into dc, writing dx, ddt, db and dc through
    transposed views of [B,S,...] tensors."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int, init):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        y, final, heads, entering, carries, cs = _chunked(
            *(t.detach() for t in (x, dt, a, b, c)), chunk,
            None if init is None else init.detach())
        ctx.save_for_backward(*heads, entering,
                              None if carries is entering else carries, cs)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, entering, carries, cs = ctx.saved_tensors
        bs, h, s, p = x.shape
        if dy is None:
            dy = x.new_zeros((bs, s, h, p))
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        dstates, dcs, dc_state, dinit = ssd_state_bwd_heads(
            dy.transpose(1, 2), dfinal, entering if carries is None
            else carries, entering, cs, c, ctx.chunk)
        dx = x.new_empty((bs, s, h, p))
        ddt = dt.new_empty((bs, s, h))
        db, dc = (t.new_empty((bs, s, t.shape[-1])) for t in (b, c))
        _, _, da, _, _ = ssd_chunk_intra_bwd_heads(
            x, dt, a, b, c, dy.transpose(1, 2), dstates, ctx.chunk,
            dx=dx.transpose(1, 2), ddt=ddt.transpose(1, 2), db=db[:, None],
            dc=dc[:, None], dcum=dcs, dc_extra=dc_state)
        return (dx, ddt, da.sum(0), db, dc, None,
                dinit if ctx.needs_input_grad[6] else None)
