"""Layout adapters between the models and the kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention
from .ref import work_dtype
from .ssd_scan import ssd_chunk_intra_bwd_heads, ssd_chunk_intra_heads


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
    is copied.  Under autograd (grad enabled, an input that requires grad)
    the call is `SSDIntraBSHP`: the forward kernel, then the backward kernel.
    On CPU tensors the wrappers compute the plain versions, in float64 too
    (gradcheck's dtype)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        return SSDIntraBSHP.apply(x, dt, a, b, c, chunk)
    return _forward(x, dt, a, b, c, chunk)


def heads_views(x, dt, a, b, c) -> tuple:
    """The [B,S,...] tensors as views in the layout of
    `ssd_scan.ssd_chunk_intra_heads`."""
    bs, _, h, _ = x.shape
    return (x.transpose(1, 2), dt.transpose(1, 2), a.expand(bs, h),
            b[:, None], c[:, None])


def _forward(x, dt, a, b, c, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    bs, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    states = torch.empty((bs, s // chunk, h, p, n), dtype=work_dtype(x),
                         device=x.device)
    ssd_chunk_intra_heads(*heads_views(x, dt, a, b, c), chunk,
                          y=y.transpose(1, 2), states=states.transpose(1, 2))
    return y, states


class SSDIntraBSHP(torch.autograd.Function):
    """`ssd_chunk_intra_bshp` under autograd.  The forward is the SSD kernel
    on the detached inputs (the same call, views and work buffer as without
    grad) and saves only x, dt, a, b, c; the backward is the backward
    kernel, which recomputes cum and the decays from them."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c)
        return _forward(*(t.detach() for t in (x, dt, a, b, c)), chunk)

    @staticmethod
    def backward(ctx, dy, dstates):
        x, dt, a, b, c = (t.detach() for t in ctx.saved_tensors)
        return ssd_chunk_intra_bshp_bwd(x, dt, a, b, c, dy, dstates,
                                        ctx.chunk) + (None,)


def ssd_chunk_intra_bshp_bwd(x, dt, a, b, c, dy, dstates, chunk: int
                             ) -> Tuple[torch.Tensor, ...]:
    """`SSDIntraBSHP`'s backward: the gradients (dx, ddt, da [H], db, dc)
    of `ssd_chunk_intra_bshp`'s inputs, given dy [B,S,H,P] and dstates
    [B,L,H,P,N]."""
    bs, s, h, p = x.shape
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    ddt = torch.empty((bs, s, h), dtype=work_dtype(x), device=x.device)
    db = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    dc = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    _, _, da, _, _ = ssd_chunk_intra_bwd_heads(
        *heads_views(x, dt, a, b, c), dy.transpose(1, 2),
        dstates.transpose(1, 2), chunk, dx=dx.transpose(1, 2),
        ddt=ddt.transpose(1, 2), db=db[:, None], dc=dc[:, None])
    return dx, ddt.to(dt.dtype), da.sum(0).to(a.dtype), db, dc
