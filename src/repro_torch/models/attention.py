"""Attention: GQA/MQA/MHA with RoPE, sliding window, logit softcap, qk-norm,
prefix-LM masks and KV-cache decode.  Counterpart of
src/repro/models/attention.py.

Masks are described by (causal, window, prefix_len) plus position vectors and
evaluated inline.  Two execution paths:

* kernel  -- the hand-written flash kernel (repro_torch.kernels) for every
             CUDA call with more than one query row and no gradient to
             carry: prompt processing.
* direct  -- one einsum with the mask inline: decode, every CPU call, and
             every call under autograd.  The kernel is a forward kernel only,
             as the reference's is (its `pallas_call` has no VJP, and the
             reference's training differentiates this plain path).

The reference's third path, the blockwise online softmax in plain ops for
more than 2048 rows, is not ported yet (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.ops import flash_attention_bshd

from .common import (ModelConfig, NEG_INF, apply_rope, dense_init, rms_norm,
                     softcap)

BLOCKWISE_THRESHOLD = 2048      # the reference goes blockwise above this


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Logical attention mask: evaluated lazily from positions."""
    causal: bool = True
    window: Optional[int] = None        # sliding window (None = unbounded)
    prefix_len: int = 0                 # bidirectional prefix (prefix-LM)

    def allowed(self, q_pos: torch.Tensor, kv_pos: torch.Tensor
                ) -> torch.Tensor:
        """q_pos: [...,S], kv_pos: [...,T] -> bool [...,S,T].
        Negative kv positions are never attended (ring-buffer caches encode
        not-yet-written rows as negative positions)."""
        qp = q_pos[..., :, None]
        kp = kv_pos[..., None, :]
        if self.causal:
            ok = kp <= qp
            if self.window is not None:
                ok = ok & (kp > qp - self.window)
        else:
            ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                            dtype=torch.bool, device=kp.device)
        if self.prefix_len:
            ok = ok | (kp < self.prefix_len)
        return ok & (kp >= 0)


def ring_positions(index: int, cache_len: int,
                   device: torch.device) -> torch.Tensor:
    """Absolute position held by each row of a (possibly ring-buffer) cache
    when the current decode position is `index`.  Rows never written resolve
    to negative positions, which MaskSpec.allowed() always rejects."""
    r = torch.arange(cache_len, device=device)
    return index - torch.remainder(index - r, cache_len)


class Attention(nn.Module):
    """Projections as bias-free `nn.Linear`s ([out, in] weights)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        hd = cfg.hd
        kw = dict(bias=False, dtype=dtype, device=device)
        self.wq = nn.Linear(cfg.d_model, cfg.num_heads * hd, **kw)
        self.wk = nn.Linear(cfg.d_model, cfg.num_kv_heads * hd, **kw)
        self.wv = nn.Linear(cfg.d_model, cfg.num_kv_heads * hd, **kw)
        self.wo = nn.Linear(cfg.num_heads * hd, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(hd, dtype=dtype,
                                                   device=device))
            self.k_norm = nn.Parameter(torch.zeros(hd, dtype=dtype,
                                                   device=device))


@torch.no_grad()
def init_attention(p: Attention, cfg: ModelConfig,
                   generator: torch.Generator) -> None:
    for lin in (p.wq, p.wk, p.wv, p.wo):
        dense_init(lin.weight, lin.in_features, generator)
    if cfg.qk_norm:
        p.q_norm.zero_()
        p.k_norm.zero_()


# ---------------------------------------------------------------------- #
# core attend
# ---------------------------------------------------------------------- #

def _direct_attend(q, k, v, q_pos, kv_pos, spec: MaskSpec,
                   logit_cap: Optional[float]) -> torch.Tensor:
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    logits = softcap(logits / d ** 0.5, logit_cap)
    ok = spec.allowed(q_pos, kv_pos)                  # [B,S,T] or [S,T]
    if ok.dim() == 2:
        ok = ok[None]
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    # the probabilities are rounded to q's dtype before the PV product, as
    # in the reference (a visible rounding at bf16)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, h, d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: Optional[torch.Tensor], kv_pos: Optional[torch.Tensor],
           spec: MaskSpec, logit_cap: Optional[float] = None
           ) -> torch.Tensor:
    """q: [B,S,H,D], k/v: [B,T,Hkv,D]; positions: [S]/[T] int, or None for
    0..S-1 / 0..T-1.

    Under autograd (grad enabled and an input that requires grad) this takes
    the plain path on every device, so gradients flow as in the reference.
    Otherwise, on CUDA with S > 1 it launches the flash kernel, which takes
    row and column indices as positions: it is reached only with both
    positions None, which callers pass where that holds by construction (a
    prompt processed from its first token).  Explicit positions there
    raise."""
    s, t = q.shape[1], k.shape[1]
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if q.is_cuda and s > 1 and not needs_grad:
        if q_pos is not None or kv_pos is not None:
            raise ValueError("the flash kernel takes positions 0..S-1 only: "
                             "pass q_pos=kv_pos=None for such a call")
        return flash_attention_bshd(q, k, v, spec, logit_cap)
    if q_pos is None:
        q_pos = torch.arange(s, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(t, device=q.device)
    if s == 1 or max(s, t) <= BLOCKWISE_THRESHOLD:
        return _direct_attend(q, k, v, q_pos, kv_pos, spec, logit_cap)
    raise NotImplementedError(
        f"attention over {max(s, t)} rows on the plain path (the CPU, or "
        f"under autograd) needs the blockwise path, which is not ported yet "
        f"(ROADMAP.md queue A, item A3)")


# ---------------------------------------------------------------------- #
# attention block with optional KV cache
# ---------------------------------------------------------------------- #

def attention_forward(
        p: Attention, cfg: ModelConfig, x: torch.Tensor,
        positions: Optional[torch.Tensor], spec: MaskSpec, *,
        cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
        cache_positions: Optional[torch.Tensor] = None,
        logit_cap: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """x: [B,S,d]; positions: [S] int, or None for 0..S-1.

    * training / prefill: positions None (the prompt starts at 0), which
      lets a CUDA call take the flash kernel.
    * decode: cache = (k_cache, v_cache) [B,Tmax,Hkv,D]; new rows are written
      IN PLACE at cache_index (the caller mod-wraps for ring-buffer windowed
      caches), which saves a copy of the cache per layer and step; attention
      runs over the cache with `cache_positions` (defaults to arange) giving
      each row's absolute position for masking.
    """
    hd = cfg.hd
    b, s, _ = x.shape
    q = p.wq(x).reshape(b, s, cfg.num_heads, hd)
    k = p.wk(x).reshape(b, s, cfg.num_kv_heads, hd)
    v = p.wv(x).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    rope_pos = positions if positions is not None \
        else torch.arange(s, device=x.device)
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)

    new_cache = None
    kv_pos = positions
    if cache is not None:
        k_cache, v_cache = cache
        clen = k_cache.shape[1]
        kw, vw, widx = k, v, cache_index
        if s >= clen and s > 1:
            # ring-buffer cache shorter than the prompt: keep only the tail,
            # ROLLED so that row r holds absolute position p = r (mod clen)
            # -- decode's ring_positions() relies on that alignment
            shift = s % clen
            kw = torch.roll(k[:, -clen:], shift, dims=1)
            vw = torch.roll(v[:, -clen:], shift, dims=1)
            widx = 0
        n = kw.shape[1]
        widx = min(widx, clen - n)   # the reference's update clamps its start
        k_cache[:, widx:widx + n] = kw
        v_cache[:, widx:widx + n] = vw
        new_cache = (k_cache, v_cache)
        if s == 1:
            # decode: attend over the cache; row positions mask garbage /
            # encode ring-buffer wraparound
            k, v = k_cache, v_cache
            kv_pos = cache_positions if cache_positions is not None \
                else torch.arange(clen, device=x.device)
        # prefill (s > 1): attend over the fresh full-length k/v

    out = attend(q, k.to(q.dtype), v.to(q.dtype), positions, kv_pos, spec,
                 logit_cap)
    return p.wo(out.reshape(b, s, cfg.num_heads * hd)), new_cache
