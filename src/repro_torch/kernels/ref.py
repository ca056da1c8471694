"""Plain PyTorch versions of the port's kernels (the allclose references).

Each function computes what its kernel computes, with ordinary tensor ops:
the CPU path of every wrapper and the oracle the card's kernel is held to.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0,
                  logit_cap: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k,v: [B,Hkv,Skv,D] -> [B,H,Sq,D] in q's dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float())
    logits = logits / math.sqrt(d)
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        kv_pos = torch.arange(skv, device=q.device)[None, :]
        ok = kv_pos <= q_pos
        if window is not None:
            ok &= kv_pos > q_pos - window
        if prefix_len:
            ok |= kv_pos < prefix_len
        logits = torch.where(ok, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def chunk_accum_reference(acc: torch.Tensor, update: torch.Tensor
                          ) -> torch.Tensor:
    """acc: [N, C] float32; update: [N, C] of any float dtype.
    acc += update.float(), in place; returns acc."""
    return acc.add_(update.to(acc.dtype))


def chunk_accum_indexed_reference(acc: torch.Tensor, idx: torch.Tensor,
                                  update: torch.Tensor, skip: int
                                  ) -> torch.Tensor:
    """acc: [M, C] float32; idx: [W] int64 rows of acc; update: [W, C].
    acc[idx[j]] += update[j].float() for every j with idx[j] != skip, in
    place; returns acc."""
    keep = idx != skip
    return acc.index_add_(0, idx[keep], update[keep].to(acc.dtype))
