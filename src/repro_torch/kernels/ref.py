"""Plain PyTorch versions of the port's kernels (the allclose references).

Each function computes what its kernel computes, with ordinary tensor ops:
the CPU path of every wrapper and the oracle the card's kernel is held to.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def ssd_chunk_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Single-chunk SSD intra-chunk output (no inter-chunk state), the
    oracle of src/repro/kernels/ref.py.
    x: [Q,H,P], dt: [Q,H], a: [H], b,c: [Q,N] -> y [Q,H,P]."""
    q = x.shape[0]
    da = dt * a[None, :]                                  # [Q,H]
    cs = torch.cumsum(da, dim=0)
    diff = cs[:, None, :] - cs[None, :, :]                # [i,j,H]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    ll = torch.where(mask[..., None], torch.exp(diff), 0.0)
    scores = c @ b.T                                      # [i,j]
    xdt = x * dt[..., None]
    return torch.einsum("ij,ijh,jhp->ihp", scores, ll, xdt)


def ssd_chunk_intra_reference(x: torch.Tensor, dt: torch.Tensor,
                              a: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor, chunk: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk SSD of every (batch*head, chunk) block: what the
    Pallas kernel `_ssd_chunk_kernel` computes.
    x: [BH,S,P], dt: [BH,S], a: [BH], b, c: [BH,S,N], S a multiple of chunk.
    Returns (y_diag [BH,S,P] in x's dtype, states [BH,S//chunk,P,N] f32):

        L[i,j] = exp(cum[i] - cum[j]) for i >= j, else 0, cum = cumsum(dt*a)
        y[i]   = sum_j (C[i].B[j]) L[i,j] x[j] dt[j]
        state  = sum_j exp(cum[Q-1] - cum[j]) (x[j] dt[j]) (x) B[j]

    in float32, except that the cumulative sum of dt*a is taken in float64
    and each difference is rounded to float32 once: a float32 cumsum over a
    512-row chunk carries errors of ~1e-4 into L, which would depend on the
    order of the sum; the kernel computes the same float64 sum."""
    y, states = ssd_chunk_intra_heads_reference(
        x[:, None], dt[:, None], a[:, None], b[:, None], c[:, None], chunk)
    return y[:, 0], states[:, 0]


def ssd_chunk_intra_heads_reference(x: torch.Tensor, dt: torch.Tensor,
                                    a: torch.Tensor, b: torch.Tensor,
                                    c: torch.Tensor, chunk: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ssd_chunk_intra_reference on the heads layout of
    `ssd_scan.ssd_chunk_intra_heads`: x [B,H,S,P], dt [B,H,S], a [B,H],
    b, c [B,G,S,N] with G = H or 1, any broadcastable strides.  Returns
    (y [B,H,S,P], states [B,H,L,P,N] f32).  With G = 1 (every head reads
    the same b, c, as Mamba2's do) C.B^T is computed once per batch row
    and chunk and shared by the heads, as the reference model computes
    it."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    l = s // chunk
    xf = x.float().reshape(bs, h, l, chunk, p)
    dtf = dt.float().reshape(bs, h, l, chunk)
    bf = b.float().reshape(bs, g, l, chunk, n)
    cf = c.float().reshape(bs, g, l, chunk, n)
    da = dtf * a.float().expand(bs, h)[..., None, None]     # [B,H,L,Q]
    cum = torch.cumsum(da, dim=-1, dtype=torch.float64)
    diff = (cum[..., :, None] - cum[..., None, :]).float()
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    # masked before the exp: the positive differences above the diagonal
    # may overflow to inf, and under autograd the backward of a select
    # after the exp would multiply its zero gradient by that inf
    ll = torch.exp(torch.where(mask, diff, -torch.inf))
    xdt = xf * dtf[..., None]                               # [B,H,L,Q,P]
    scores = cf @ bf.transpose(-1, -2)                      # [B,G,L,Q,Q]
    y = (scores * ll) @ xdt
    decay = torch.exp((cum[..., -1:] - cum).float())        # [B,H,L,Q]
    states = xdt.transpose(-1, -2) @ (bf * decay[..., None])
    return y.reshape(bs, h, s, p).to(x.dtype), states
