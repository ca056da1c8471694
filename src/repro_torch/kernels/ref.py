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


def work_dtype(x: torch.Tensor) -> torch.dtype:
    """The SSD block's arithmetic type: float32, or float64 for float64
    inputs (the CPU tests' oracle)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _ssd_chunk_terms(x, dt, a, b, c, chunk):
    """The plain SSD block's operands and intermediates, shared by its
    forward and its backward: (xf [B,H,L,Q,P], dtf, af [B,H], bf, cf
    [B,G,L,Q,N], cum (float64) [B,H,L,Q], ll [B,H,L,Q,Q], scores
    [B,G,L,Q,Q], xdt, decay [B,H,L,Q]) in the work dtype."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    l = s // chunk
    ft = work_dtype(x)
    xf = x.to(ft).reshape(bs, h, l, chunk, p)
    dtf = dt.to(ft).reshape(bs, h, l, chunk)
    af = a.to(ft).expand(bs, h)
    bf = b.to(ft).reshape(bs, g, l, chunk, n)
    cf = c.to(ft).reshape(bs, g, l, chunk, n)
    da = dtf * af[..., None, None]                          # [B,H,L,Q]
    cum = torch.cumsum(da, dim=-1, dtype=torch.float64)
    diff = (cum[..., :, None] - cum[..., None, :]).to(ft)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    # masked before the exp: the positive differences above the diagonal
    # may overflow to inf, and under autograd the backward of a select
    # after the exp would multiply its zero gradient by that inf
    ll = torch.exp(torch.where(mask, diff, -torch.inf))
    xdt = xf * dtf[..., None]                               # [B,H,L,Q,P]
    scores = cf @ bf.transpose(-1, -2)                      # [B,G,L,Q,Q]
    decay = torch.exp((cum[..., -1:] - cum).to(ft))         # [B,H,L,Q]
    return xf, dtf, af, bf, cf, cum, ll, scores, xdt, decay


def ssd_chunk_intra_heads_reference(x: torch.Tensor, dt: torch.Tensor,
                                    a: torch.Tensor, b: torch.Tensor,
                                    c: torch.Tensor, chunk: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk SSD of every (batch, head, chunk) block: what the
    Pallas kernel `_ssd_chunk_kernel` computes, in the heads layout of
    `ssd_scan.ssd_chunk_intra_heads`: x [B,H,S,P], dt [B,H,S], a [B,H],
    b, c [B,G,S,N] with G = H or 1, any broadcastable strides, S a
    multiple of chunk.  Returns (y_diag [B,H,S,P] in x's dtype, states
    [B,H,L,P,N] f32):

        L[i,j] = exp(cum[i] - cum[j]) for i >= j, else 0, cum = cumsum(dt*a)
        y[i]   = sum_j (C[i].B[j]) L[i,j] x[j] dt[j]
        state  = sum_j exp(cum[Q-1] - cum[j]) (x[j] dt[j]) (x) B[j]

    in float32, except that the cumulative sum of dt*a is taken in float64
    and each difference is rounded to float32 once: a float32 cumsum over a
    512-row chunk carries errors of ~1e-4 into L, which would depend on the
    order of the sum; the kernel computes the same float64 sum.  With G = 1
    (every head reads the same b, c, as Mamba2's do) C.B^T is computed
    once per batch row and chunk and shared by the heads, as the reference
    model computes it.  float64 inputs are computed in float64 (states
    too)."""
    bs, h, s, p = x.shape
    _, _, _, bf, _, _, ll, scores, xdt, decay = _ssd_chunk_terms(
        x, dt, a, b, c, chunk)
    y = (scores * ll) @ xdt
    states = xdt.transpose(-1, -2) @ (bf * decay[..., None])
    return y.reshape(bs, h, s, p).to(x.dtype), states


def ssd_chunk_intra_bwd_reference(x: torch.Tensor, dt: torch.Tensor,
                                  a: torch.Tensor, b: torch.Tensor,
                                  c: torch.Tensor, dy: torch.Tensor,
                                  dstates: torch.Tensor, chunk: int,
                                  dcum: Optional[torch.Tensor] = None,
                                  dc_extra: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """The gradients of `ssd_chunk_intra_heads_reference`, written out:
    the oracle the backward kernel (`ssd_scan.ssd_chunk_intra_bwd_heads`)
    is held to, and its CPU path.  dy [B,H,S,P] and dstates [B,H,L,P,N]
    are the gradients of y and the states.  Returns (dx [B,H,S,P] in x's
    dtype, ddt [B,H,S], da [B,H], db, dc [B,G,S,N] in b's dtype); ddt and
    da in the work dtype (float32, float64 for float64 inputs).  `dcum`
    [B,H,S] (optional) is added to dcum below before its reverse cumsum,
    and `dc_extra` [B,G,S,N] to dc before its rounding: the gradients that
    steps 3 and 4 of the chunked SSD send to cum and to c
    (`ssd_state_bwd_reference`).

    Per chunk, with M = S o L (S = C B^T shared by a group's heads), xdt =
    x dt and w = exp(cum[Q-1] - cum) the decay of the states:

        dM    = dy xdt^T                 dxdt = M^T dy + (B o w) dstates^T
        dS    = sum_h dM o L             dC = dS B,  dB = dS^T C
        dB   += sum_h w o (xdt dstates)
        dcum  = rowsum(dM o M) - colsum(dM o M) - g,  g = w o rowsum(B o
                (xdt dstates)), and dcum[Q-1] += sum(g)
        d(dt a) = reverse cumsum of dcum, summed in float64 as autograd
                sums the float64 cumsum's gradient

    dx = dxdt dt, ddt = rowsum(dxdt o x) + d(dt a) a, da = sum d(dt a) dt."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    l = s // chunk
    xf, dtf, af, bf, cf, _, ll, scores, xdt, decay = _ssd_chunk_terms(
        x, dt, a, b, c, chunk)
    ft = xf.dtype
    dyf = dy.to(ft).reshape(bs, h, l, chunk, p)
    dst = dstates.to(ft)                                    # [B,H,L,P,N]

    def by_group(t):                    # sum a [B,H,...] over each group
        return t.reshape(bs, g, h // g, *t.shape[2:]).sum(2)

    m = scores * ll                                         # [B,H,L,Q,Q]
    dm = dyf @ xdt.transpose(-1, -2)
    dxdt = m.transpose(-1, -2) @ dyf + (bf * decay[..., None]) @ \
        dst.transpose(-1, -2)
    xst = xdt @ dst                                         # [B,H,L,Q,N]
    ds = by_group(dm * ll)                                  # [B,G,L,Q,Q]
    dc = ds @ bf
    db = ds.transpose(-1, -2) @ cf + by_group(xst * decay[..., None])
    dp = (dm * m).double()
    gdec = ((xst * bf).sum(-1) * decay).double()            # [B,H,L,Q]
    dcum_all = dp.sum(-1) - dp.sum(-2) - gdec
    dcum_all[..., -1] += gdec.sum(-1)
    if dcum is not None:
        dcum_all += dcum.double().reshape(bs, h, l, chunk)
    dda = dcum_all.flip(-1).cumsum(-1).flip(-1).to(ft)
    ddt = (dxdt * xf).sum(-1) + dda * af[..., None, None]
    da = (dda * dtf).sum((-1, -2))
    dc = dc.reshape(bs, g, s, n)
    if dc_extra is not None:
        dc = dc + dc_extra.to(ft)
    return ((dxdt * dtf[..., None]).reshape(bs, h, s, p).to(x.dtype),
            ddt.reshape(bs, h, s), da, db.reshape(bs, g, s, n).to(b.dtype),
            dc.to(b.dtype))


def ssd_state_reference(y: torch.Tensor, states: torch.Tensor,
                        dt: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                        chunk: int, init: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Steps 3 and 4 of the chunked SSD (`models/ssm.py:ssd_chunked`), the
    plain version of `ssd_state.ssd_state_heads` and its CPU path: the
    chunks' states carried from chunk to chunk, and each chunk's entering
    state read out through the decay inside the chunk.  Heads layout: y
    [B,H,S,P] (the intra-chunk output y_diag, in the compute dtype), states
    [B,H,L,P,N] and init [B,H,P,N] (optional) in the work dtype, dt [B,H,S],
    a [B,H], c [B,G,S,N] with G = H or 1.  With cs = cumsum(dt a) over each
    chunk, in the work dtype:

        carry[0] = init,  carry[l+1] = carry[l] exp(cs[l, Q-1]) + states[l]
        entering[l] = carry[l] in the compute dtype
        y += (C entering^T in the compute dtype) sd,  sd = exp(cs) rounded
             to the compute dtype

    Returns (y, final = carry[L], entering [B,H,L,P,N] in y's dtype,
    carries [B,H,L,P,N] = carry[0 .. L-1] in the work dtype, cs [B,H,S]),
    the last three what the backward needs."""
    bs, h, s, p = y.shape
    g, n = c.shape[1], c.shape[-1]
    l = s // chunk
    ft, cdt = work_dtype(y), y.dtype
    da = dt.to(ft) * a.to(ft)[..., None]                    # [B,H,S]
    cs = torch.cumsum(da.reshape(bs, h, l, chunk), dim=-1)  # [B,H,L,Q]
    decay = torch.exp(cs[..., -1])                          # [B,H,L]
    carry = torch.zeros((bs, h, p, n), dtype=ft, device=y.device) \
        if init is None else init.to(ft)
    carries = []
    for i in range(l):
        carries.append(carry)
        carry = carry * decay[:, :, i, None, None] + states[:, :, i].to(ft)
    carries = torch.stack(carries, dim=2)                   # [B,H,L,P,N]
    entering = carries.to(cdt)
    sd = torch.exp(cs).to(cdt)                              # [B,H,L,Q]
    cc = c.to(cdt).reshape(bs, g, l, chunk, n)
    y_off = (cc @ entering.transpose(-1, -2)) * sd[..., None]
    return (y + y_off.reshape(bs, h, s, p), carry, entering, carries,
            cs.reshape(bs, h, s))


def ssd_state_bwd_reference(dy: torch.Tensor, dfinal: Optional[torch.Tensor],
                            carries: torch.Tensor, entering: torch.Tensor,
                            cs: torch.Tensor, c: torch.Tensor, chunk: int
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradients of `ssd_state_reference` that do not pass through the
    intra-chunk block's own inputs, written out: the oracle of the state
    passes' backward (`ssd_state.ssd_state_bwd_heads`) and its CPU path.
    dy [B,H,S,P] is the gradient of y (and so of y_diag), dfinal [B,H,P,N]
    (optional) that of the final state; carries, entering and cs are what
    the forward returned.  Per chunk l, with e = exp(cs), sd = e rounded to
    the compute dtype and D = e[Q-1] the chunk's decay:

        dE[l]   = (sd o dy)^T C                       [P, N]
        Gr      = dy entering[l]                      [Q, N]
        dc      = sum_h sd o Gr   (over each group's heads)
        dcs     = e o rowsum(C o Gr), and dcs[Q-1] += D sum(dcarry[l+1] o
                  carry[l])
        dcarry[L] = dfinal,  dcarry[l] = dcarry[l+1] D + dE[l]
        dstates[l] = dcarry[l+1]

    Returns (dstates [B,H,L,P,N], dcs [B,H,S] (the gradient of cs, which
    the intra-chunk block's backward adds to its own before the reverse
    cumsum), dc [B,G,S,N], dinit = dcarry[0] [B,H,P,N]), all in the work
    dtype."""
    bs, h, s, p = dy.shape
    g, n = c.shape[1], c.shape[-1]
    l = s // chunk
    ft = carries.dtype
    dyf = dy.to(ft).reshape(bs, h, l, chunk, p)
    cf = c.to(ft).reshape(bs, g, l, chunk, n)
    e = torch.exp(cs.to(ft).reshape(bs, h, l, chunk))       # [B,H,L,Q]
    sd = e.to(entering.dtype).to(ft)
    d_ent = (dyf * sd[..., None]).transpose(-1, -2) @ cf    # [B,H,L,P,N]
    gr = dyf @ entering.to(ft)                              # [B,H,L,Q,N]
    dcs = (gr * cf).sum(-1) * e                             # [B,H,L,Q]
    dc = (gr * sd[..., None]).reshape(bs, g, h // g, l, chunk, n).sum(2)
    decay = e[..., -1]                                      # [B,H,L]
    dcarry = torch.zeros((bs, h, p, n), dtype=ft, device=dy.device) \
        if dfinal is None else dfinal.to(ft)
    dstates = [None] * l
    for i in reversed(range(l)):
        dstates[i] = dcarry
        dd = (dcarry * carries[:, :, i]).sum((-1, -2))      # [B,H]
        dcs[:, :, i, -1] += dd * decay[:, :, i]
        dcarry = dcarry * decay[:, :, i, None, None] + d_ent[:, :, i]
    return (torch.stack(dstates, dim=2), dcs.reshape(bs, h, s),
            dc.reshape(bs, g, s, n), dcarry)
