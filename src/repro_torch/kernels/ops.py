"""Layout adapters between the models and the kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention
from .ref import ssd_chunk_intra_heads_reference
from .ssd_scan import ssd_chunk_intra_heads


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
                         b: torch.Tensor, c: torch.Tensor, chunk: int, *,
                         plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1 and 2 of `ssd_chunked` in its own layout: x [B,S,H,P], dt
    [B,S,H], a [H], b, c [B,S,N] shared by every head.  Returns (y_diag
    [B,S,H,P] in x's dtype, states [B,L,H,P,N] float32), L = S/chunk.

    The kernel reads x and dt as transposed views, b and c with a head stride
    of 0 and a as [B,H] with a batch stride of 0, and writes y and the states
    into [B,S,H,P] and [B,L,H,P,N] tensors through transposed views: nothing
    is copied.  `plain=True` computes the plain version on any device (the
    caller's choice under autograd)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    views = (x.transpose(1, 2), dt.transpose(1, 2), a.expand(bs, h),
             b[:, None], c[:, None])
    if plain:
        y, states = ssd_chunk_intra_heads_reference(*views, chunk)
        return y.transpose(1, 2), states.transpose(1, 2)
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    states = torch.empty((bs, s // chunk, h, p, n), dtype=torch.float32,
                         device=x.device)
    ssd_chunk_intra_heads(*views, chunk, y=y.transpose(1, 2),
                          states=states.transpose(1, 2))
    return y, states
