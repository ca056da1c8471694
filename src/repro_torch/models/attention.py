"""Attention: GQA/MQA/MHA with RoPE, sliding window, logit softcap, qk-norm,
prefix-LM masks and KV-cache decode.  Counterpart of
src/repro/models/attention.py.

Masks are described by (causal, window, prefix_len) plus position vectors and
evaluated inline.  Three execution paths:

* kernel    -- the hand-written flash kernel (repro_torch.kernels) for every
               CUDA call with more than one query row and no gradient to
               carry: prompt processing.
* direct    -- one einsum with the mask inline: decode, and every CPU call
               or call under autograd over at most 2048 rows.  The kernel is
               a forward kernel only, as the reference's is (its
               `pallas_call` has no VJP, and the reference's training
               differentiates the plain paths).
* blockwise -- the same calls over more than 2048 rows: online softmax over
               1024-row query and kv blocks in plain ops, each kv block's
               step recomputed in the backward instead of stored, and only
               the window-adjacent kv blocks visited under a sliding window.
               `BLOCKWISE.calls` counts its calls.

Under tensor parallelism the weights are DTensors on a ("data", "model")
mesh (repro_torch.launch.sharding) and so are the projections.  Heads are
split over "model" where their count divides it (`split_heads` gathers a
projection whose heads do not), and `attend` runs each rank's own heads
as local tensors (`_attend_sharded`): the kernel sees [B, H/mp, S, D]
tensors, never a DTensor.  Where the kv heads do not divide "model", each
rank takes the kv heads its local q heads read under GQA; a decode cache
placed split on head_dim there stays so, and the scores are all-reduced
(`_attend_head_dim`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import flash_attention_bshd

from .common import (ModelConfig, NEG_INF, activation_candidate, apply_rope,
                     dense_init, linear, rms_norm, softcap,
                     unshard, unsplit_sequence)

BLOCKWISE_THRESHOLD = 2048      # use the blockwise path above this many rows
BLOCK_Q = 1024
BLOCK_KV = 1024


class CallCount:
    """Calls of a plain path, counted as a kernel wrapper counts launches."""

    def __init__(self) -> None:
        self.calls = 0


BLOCKWISE = CallCount()


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


CAUSAL = MaskSpec(causal=True)
FULL = MaskSpec(causal=False)


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
                   logit_cap: Optional[float], sum_logits=None,
                   head_dim: Optional[int] = None) -> torch.Tensor:
    """One einsum each way.  q and k may hold a slice of head_dim
    (`_attend_head_dim`): `sum_logits` then sums the partial float32
    logits over the slices, and `head_dim` is the whole one, which
    scales them."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    if sum_logits is not None:
        logits = sum_logits(logits)
    logits = softcap(logits / (head_dim or d) ** 0.5, logit_cap)
    ok = spec.allowed(q_pos, kv_pos)                  # [B,S,T] or [S,T]
    if ok.dim() == 2:
        ok = ok[None]
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    # the probabilities are rounded to q's dtype before the PV product, as
    # in the reference (a visible rounding at bf16)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


def _kv_step(m, l, acc, qg, kj, vj, ok, logit_cap):
    """One kv block of the online softmax: (m, l, acc) after block (kj, vj)
    whose mask against the query block is `ok` [bq, bkv]."""
    d = qg.shape[-1]
    logits = torch.einsum("bshgd,bthd->bhgst", qg, kj).float()
    logits = softcap(logits / d ** 0.5, logit_cap)
    logits = torch.where(ok, logits, NEG_INF)
    new_m = torch.maximum(m, logits.amax(dim=-1))          # [B,hkv,g,bq]
    corr = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])
    new_l = l * corr + p.sum(dim=-1)
    # the probabilities stay float32 for this product, as in the reference
    # (unlike the direct path, which rounds them to q's dtype)
    pv = torch.einsum("bhgst,bthd->bhgsd", p, vj.float())
    return new_m, new_l, acc * corr[..., None] + pv


def _blockwise_attend(q, k, v, q_pos, kv_pos, spec: MaskSpec,
                      logit_cap: Optional[float], block_q: int = BLOCK_Q,
                      block_kv: int = BLOCK_KV) -> torch.Tensor:
    """Online-softmax attention over query and kv blocks in plain ops, with
    the reference's choices: GQA kv heads expanded up front, query rows
    padded with position -1 and kv rows with 2**30, float32 softmax state,
    and under a sliding window only the kv blocks that can meet the window,
    anchored on the last query row's diagonal block (a clamped index may
    visit the last block again, fully masked, which changes nothing).
    Under autograd each kv block's step is recomputed in the backward
    (`checkpoint`, as the reference's `jax.checkpoint` with
    `nothing_saveable`), so no [S, T] probabilities are stored.  The
    reference's sharding constraints have no counterpart on one card."""
    BLOCKWISE.calls += 1
    b, s, h, d = q.shape
    t = k.shape[1]
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    bq, bkv = min(block_q, s), min(block_kv, t)
    pad_q, pad_kv = (-s) % bq, (-t) % bkv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad_kv), value=2 ** 30)
    nq, nk = (s + pad_q) // bq, (t + pad_kv) // bkv
    windowed = spec.causal and spec.window is not None \
        and spec.prefix_len == 0
    kblocks = nk if not windowed else \
        min(nk, -(-(spec.window + bq) // bkv) + 1)
    recompute = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = []
    for i in range(nq):
        qg = q[:, i * bq:(i + 1) * bq].reshape(b, bq, h, 1, d)
        qpi = q_pos[i * bq:(i + 1) * bq]
        if windowed:
            jmax = ((i + 1) * bq - 1) // bkv
            j0 = max(0, jmax - (kblocks - 1))
            blocks = [min(j0 + j, nk - 1) for j in range(kblocks)]
        else:
            blocks = range(kblocks)
        m = torch.full((b, h, 1, bq), -float("inf"), device=q.device)
        l = torch.zeros((b, h, 1, bq), device=q.device)
        acc = torch.zeros((b, h, 1, bq, d), device=q.device)
        for jj in blocks:
            rows = slice(jj * bkv, (jj + 1) * bkv)
            args = (m, l, acc, qg, k[:, rows], v[:, rows],
                    spec.allowed(qpi, kv_pos[rows]), logit_cap)
            m, l, acc = (checkpoint(_kv_step, *args, use_reentrant=False)
                         if recompute else _kv_step(*args))
        out = acc / torch.clamp_min(l, 1e-37)[..., None]
        outs.append(out.movedim(3, 1).reshape(b, bq, h, d))
    return torch.cat(outs, dim=1)[:, :s].to(q.dtype)


def split_heads(y: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> [B, S, n, hd].  A DTensor sharded on its last dim
    over a mesh dim that does not divide n is gathered over it first: a
    shard would cut a head."""
    if isinstance(y, DTensor):
        mesh, pl = y.device_mesh, list(y.placements)
        last = y.dim() - 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim in (-1, last) \
                    and n % mesh.size(i):
                pl[i] = Replicate()
        if pl != list(y.placements):
            y = y.redistribute(mesh, pl)
    return y.reshape(*y.shape[:-1], n, hd)


def _local_kv_heads(k: torch.Tensor, h: int, mp: int, r: int
                    ) -> torch.Tensor:
    """The kv heads of a whole [B, T, Hkv, D] that rank r's q heads
    [r * h / mp, (r + 1) * h / mp) read under GQA (group h / Hkv)."""
    hkv = k.shape[2]
    hl, g = h // mp, h // hkv
    if hl % g == 0:
        return k[:, :, r * hl // g:(r + 1) * hl // g]
    if g % hl == 0:
        lo = r * hl // g
        return k[:, :, lo:lo + 1]
    return k.repeat_interleave(g, dim=2)[:, :, r * hl:(r + 1) * hl]


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: DTensor views the
    gradient of a local tensor by its global shape, which a transposed
    local layout (an einsum's backward) does not allow."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _placed(x: DTensor, placements) -> DTensor:
    """x redistributed to `placements`, or x itself when it has them (a
    redistribute call costs host time even when it moves nothing)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _split_like_input_dim(y: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """A DTensor y [..., n] replicated over a mesh dim that splits the
    input dim of the linear weight w [m, n], split there before the
    product.  DTensor would split it inside the product, where its
    gradient then comes back split over the heads' flattened dim, which a
    reshape into heads that the mesh dim does not divide refuses; split
    here, the gradient is gathered on the way back."""
    if not isinstance(y, DTensor) or not isinstance(w, DTensor):
        return y
    last = y.dim() - 1
    return _placed(y, [Shard(last) if wp.is_shard() and wp.dim == 1
                       and yp.is_replicate() else yp
                       for yp, wp in zip(y.placements, w.placements)])


def _attend_sharded(q, k, v, q_pos, kv_pos, spec: MaskSpec,
                    logit_cap: Optional[float]) -> torch.Tensor:
    """`attend` on DTensors q [B,S,H,D], k/v [B,T,Hkv,D]: rows over the
    batch axes where they divide, heads over "model" where H does (kv
    heads too where Hkv does; else each rank slices the kv heads its q
    heads read from the whole kv, whose gradient is then a partial sum).
    Each rank attends its own rows and heads on local tensors.

    The dry run's activation policy ('attn_qkv': heads over "model", else
    rows over the batch axes and "model", else rows over the batch axes)
    maps onto this: where H does not divide "model" but the rows divide
    every axis, the rows are split over "model" too instead of every
    "model" rank attending all heads of its rows."""
    mesh = q.device_mesh
    h, hkv = q.shape[2], k.shape[2]
    at = _head_dim_split(k, v)
    if at is not None:
        return _attend_head_dim(q, k, v, q_pos, kv_pos, spec, logit_cap, at)
    qp, kvp, kv_grad = [], [], []
    model_rank = None
    names = mesh.mesh_dim_names
    cand = activation_candidate(q.shape, "attn_qkv") \
        if "model" in names else None
    rows_over_model = cand is not None and \
        cand.placements[names.index("model")] == Shard(0)
    for i, name in enumerate(names):
        n = mesh.size(i)
        if name == "model":
            if h % n:
                rows = Shard(0) if rows_over_model else Replicate()
                qp.append(rows)
                kvp.append(rows)
                kv_grad.append(rows)
            elif hkv % n:
                qp.append(Shard(2))
                kvp.append(Replicate())
                kv_grad.append(Partial())
                model_rank = (mesh.get_local_rank(name), n)
            else:
                qp.append(Shard(2))
                kvp.append(Shard(2))
                kv_grad.append(Shard(2))
        else:
            rows = Shard(0) if q.shape[0] % n == 0 else Replicate()
            qp.append(rows)
            kvp.append(rows)
            kv_grad.append(rows)
    ql, kl, vl = (_ContiguousGrad.apply(x) for x in (
        _placed(q, qp).to_local(),
        _placed(k, kvp).to_local(grad_placements=kv_grad),
        _placed(v, kvp).to_local(grad_placements=kv_grad)))
    if model_rank is not None:
        kl = _local_kv_heads(kl, h, model_rank[1], model_rank[0])
        vl = _local_kv_heads(vl, h, model_rank[1], model_rank[0])
    out = attend(ql, kl, vl, q_pos, kv_pos, spec, logit_cap).contiguous()
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _head_dim_split(k, v) -> Optional[int]:
    """The index of the "model" mesh dim where k and v (DTensors [B,T,Hkv,
    D]) both arrive split on head_dim, as a decode cache whose kv heads do
    not divide "model" is placed (`decode_state_specs`); else None."""
    if not isinstance(k, DTensor) or not isinstance(v, DTensor):
        return None
    names = k.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    at = names.index("model")
    if k.device_mesh.size(at) == 1:
        return None
    return at if k.placements[at] == v.placements[at] == Shard(3) else None


def _attend_head_dim(q, k, v, q_pos, kv_pos, spec: MaskSpec,
                     logit_cap: Optional[float], at: int) -> torch.Tensor:
    """`attend` over k, v split on head_dim over "model" (mesh dim `at`):
    the small q is moved to the same split, never the cache.  Each rank
    contracts its head_dim slice of q and k, the partial float32 logits
    [B, Hkv, G, S, T] are all-reduced over "model", and softcap, mask and
    softmax run on every rank alike; P.V takes the rank's slice of v, and
    the output [B, S, H, D], small too, leaves split over the heads where
    H divides "model", else replicated there, as the other routes leave
    it.  Rows stay over the batch axes where they divide."""
    mesh = q.device_mesh
    h = q.shape[2]
    pl, summed = [], []
    for i in range(mesh.ndim):
        if i == at:
            pl.append(Shard(3))
            summed.append(Replicate())
        else:
            rows = Shard(0) if q.shape[0] % mesh.size(i) == 0 \
                else Replicate()
            pl.append(rows)
            summed.append(rows)
    partial = [Partial() if i == at else p for i, p in enumerate(summed)]

    def sum_logits(t: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(t, mesh, partial, run_check=False) \
            .redistribute(mesh, summed).to_local(grad_placements=partial)

    ql, kl, vl = (_placed(x, pl).to_local() for x in (q, k, v))
    if q_pos is None:
        q_pos = torch.arange(q.shape[1], device=ql.device)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[1], device=ql.device)
    out = _direct_attend(ql, kl, vl, q_pos, kv_pos, spec, logit_cap,
                         sum_logits, q.shape[-1]).contiguous()
    out = DTensor.from_local(out, mesh, pl, run_check=False)
    n = mesh.size(at)
    return _placed(out, [(Shard(2) if h % n == 0 else Replicate())
                         if i == at else p for i, p in enumerate(pl)])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: Optional[torch.Tensor], kv_pos: Optional[torch.Tensor],
           spec: MaskSpec, logit_cap: Optional[float] = None
           ) -> torch.Tensor:
    """q: [B,S,H,D], k/v: [B,T,Hkv,D]; positions: [S]/[T] int, or None for
    0..S-1 / 0..T-1.

    Under autograd (grad enabled and an input that requires grad) this takes
    a plain path on every device, so gradients flow as in the reference:
    direct up to BLOCKWISE_THRESHOLD rows, blockwise above.
    Otherwise, on CUDA with S > 1 it launches the flash kernel, which takes
    row and column indices as positions: it is reached only with both
    positions None, which callers pass where that holds by construction (a
    prompt processed from its first token).  Explicit positions there
    raise.  DTensor inputs run through `_attend_sharded`, which calls this
    on each rank's local rows and heads."""
    if isinstance(q, DTensor):
        return _attend_sharded(q, k, v, q_pos, kv_pos, spec, logit_cap)
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
    return _blockwise_attend(q, k, v, q_pos, kv_pos, spec, logit_cap)


# ---------------------------------------------------------------------- #
# attention block with optional KV cache
# ---------------------------------------------------------------------- #

def _write_rows(cache: torch.Tensor, rows: torch.Tensor, at: int) -> None:
    """cache[:, at:at + n] = rows, in place.  A DTensor cache whose rows
    are not split is written through its local tensor, with the rows in
    its placements: a slice at a new index each decode step would miss
    DTensor's sharding cache."""
    n = rows.shape[1]
    if isinstance(cache, DTensor) and not any(
            isinstance(p, Shard) and p.dim == 1 for p in cache.placements):
        cache.to_local()[:, at:at + n] = _placed(
            rows, cache.placements).to_local()
    else:
        cache[:, at:at + n] = rows


def attention_forward(
        p: Attention, cfg: ModelConfig, x: torch.Tensor,
        positions: Optional[torch.Tensor], spec: MaskSpec, *,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
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
    * cross-attention: kv_override = precomputed (k, v) [B,T,Hkv,D], at kv
      positions 0..T-1; no rope, and q_norm alone under cfg.qk_norm.  Under
      a FULL mask positions decide nothing, so a prefill passes None and
      reaches the kernel with Sq != T.
    """
    hd = cfg.hd
    b, s, _ = x.shape
    x = unsplit_sequence(x)
    q = split_heads(linear(p.wq, x), cfg.num_heads, hd)
    if kv_override is None:
        k = split_heads(linear(p.wk, x), cfg.num_kv_heads, hd)
        v = split_heads(linear(p.wv, x), cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
            k = rms_norm(k, p.k_norm, cfg.norm_eps)
        rope_pos = positions if positions is not None \
            else torch.arange(s, device=x.device)
        q = apply_rope(q, rope_pos, cfg.rope_theta)
        k = apply_rope(k, rope_pos, cfg.rope_theta)
    else:
        k, v = kv_override
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)

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
            kw, vw = k[:, -clen:], v[:, -clen:]
            if shift:       # (no roll when the prompt fills the cache)
                kw = torch.roll(kw, shift, dims=1)
                vw = torch.roll(vw, shift, dims=1)
            widx = 0
        n = kw.shape[1]
        widx = min(widx, clen - n)   # the reference's update clamps its start
        _write_rows(k_cache, kw, widx)
        _write_rows(v_cache, vw, widx)
        new_cache = (k_cache, v_cache)
        if s == 1:
            # decode: attend over the cache; row positions mask garbage /
            # encode ring-buffer wraparound
            k, v = k_cache, v_cache
            kv_pos = cache_positions if cache_positions is not None \
                else torch.arange(clen, device=x.device)
        # prefill (s > 1): attend over the fresh full-length k/v
    elif kv_override is not None and positions is not None:
        kv_pos = torch.arange(k.shape[1], device=x.device)

    out = attend(q, k.to(q.dtype), v.to(q.dtype), positions, kv_pos, spec,
                 logit_cap)
    y = out.reshape(b, s, cfg.num_heads * hd)
    w_o = unshard(p.wo.weight)
    return F.linear(_split_like_input_dim(y, w_o), w_o), new_cache
