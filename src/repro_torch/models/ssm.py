"""Mamba2 (state-space duality / SSD): chunked prefill and O(1) decode.
Counterpart of src/repro/models/ssm.py.

The SSD recurrence per head (state [P, N], input x_t [P], B_t, C_t [N]):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t
    y_t = h_t @ C_t + D x_t

Prefill of a prompt whose length is a multiple of the chunk uses the chunked
block decomposition, all on hand-written kernels on the card
(`repro_torch.kernels.ssd_chunked_bshp`; in training one autograd Function
whose backward is kernels too): the intra-chunk term and each chunk's
terminal state (steps 1 and 2) from the SSD block's kernel, the
inter-chunk recurrence and the read-out of the carried state (steps 3 and
4) from the state passes.  Any other prompt, and decode, take the
sequential recurrence `ssd_reference`, as in the reference.  Decode keeps
(conv_state, ssm_state) per layer.

Under tensor parallelism the weights are DTensors placed by the reference's
specs (repro_torch.launch.sharding): in_proj split on its output dim over
"model", which cuts across its z | x | B | C | dt segments, and conv_w,
conv_b split on the channels likewise.  `mamba2_forward` then runs each
rank's own heads on local tensors (`_mamba2_sharded`), as `attend` does
for attention: in_proj's weight or, where it is the smaller, its output
gathered whole, and the conv taps (each rank keeps the rows of its heads'
z, x and dt and all of B and C, which every head reads), the SSD block
on [B, S, H/M, P] with b and c whole, the gated norm over the whole
d_inner by an all-reduce of each rank's sum of squares, and out_proj
row-parallel, its output a partial sum over "model".  The plain path is
the one rank of `mamba2_rank`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import obs
from repro_torch.kernels.ops import ssd_chunked_bshp

from .common import ModelConfig, const_init, dense_init, unsplit_sequence

SSMState = Tuple[torch.Tensor, torch.Tensor]     # (conv, ssm)


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, num_heads, head_dim, state_dim)."""
    din = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    h = cfg.ssm_num_heads or din // p
    return din, h, p, cfg.ssm_state_dim


class Mamba2(nn.Module):
    """The mixer's weights: in_proj and out_proj as bias-free `nn.Linear`s
    ([out, in] weights), conv_w [W, C] as the reference keeps it (a
    depthwise cross-correlation over W taps), and per-head A_log, D,
    dt_bias."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        din, h, _, n = ssm_dims(cfg)
        d = cfg.d_model
        conv_dim = din + 2 * n                  # x, B, C share the conv
        kw = dict(dtype=dtype, device=device)
        self.in_proj = nn.Linear(d, 2 * din + 2 * n + h, bias=False, **kw)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv_width, conv_dim,
                                               **kw))
        self.conv_b = nn.Parameter(torch.empty(conv_dim, **kw))
        self.A_log = nn.Parameter(torch.empty(h, **kw))
        self.D = nn.Parameter(torch.empty(h, **kw))
        self.dt_bias = nn.Parameter(torch.empty(h, **kw))
        self.norm_w = nn.Parameter(torch.empty(din, **kw))
        self.out_proj = nn.Linear(din, d, bias=False, **kw)


@torch.no_grad()
def init_mamba2(p: Mamba2, generator: torch.Generator) -> None:
    """The reference's init: normal projections, conv taps * 0.5,
    A = -exp(0) = -1, D = 1, zero biases and norm."""
    dense_init(p.in_proj.weight, p.in_proj.in_features, generator)
    dense_init(p.conv_w, p.conv_w.shape[0], generator, scale=0.5)
    dense_init(p.out_proj.weight, p.out_proj.in_features, generator)
    for w in (p.conv_b, p.A_log, p.dt_bias, p.norm_w):
        w.zero_()
    const_init(p.D, 1.0)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.
    x: [B,S,H,P], dt: [B,S,H] (>0), a: [H] (<0), b,c: [B,S,N], as the
    mixer makes them: `ssd_chunked_bshp` casts them to its dtype contract.
    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] float32).

    1, 2: the intra-chunk output and each chunk's terminal state; 3: the
    inter-chunk recurrence (a float32 carry, entering each chunk in the
    compute dtype); 4: the entering state read out through the decay
    inside the chunk.  Steps 1 and 2 run in float32 inside the SSD kernel
    on the card, or its plain version on the CPU.  The reference runs them
    in the input dtype, so in bf16 the two differ by bf16 roundings, and
    in float32 they agree.  Steps 3 and 4 (the state passes' kernels, or
    their plain version) follow the reference: a float32 carry, emitted
    and read out in the input dtype.  Under autograd the four steps are
    one Function whose gradients come from the backward kernels (their
    plain versions on the CPU), summed in float32.

    The span `ssm.ssd` covers the call and, while the recorder is on, its
    backward pass (`obs.backward_span`)."""
    if x.shape[1] % chunk:
        raise ValueError(f"seq {x.shape[1]} not divisible by chunk {chunk}")
    with obs.span("ssm.ssd"):
        return obs.backward_span(
            "ssm.ssd", lambda *xs: ssd_chunked_bshp(*xs, chunk, init_state),
            x, dt, a, b, c)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential recurrence: the oracle for ssd_chunked, and the path
    of decode and of prompts the chunk does not divide.  A Python loop over
    S: fine for decode (S = 1), slow for long prompts."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    state = init_state if init_state is not None else \
        torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None, :])[..., None, None]   # [B,H,1,1]
        upd = (x[:, t] * dt[:, t, :, None])[..., None] \
            * b[:, t, None, None, :]
        state = state * decay + upd                           # [B,H,P,N]
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; x: [B,S,C], w: [W,C].  Returns (silu(y),
    new_state) where the state is the last W-1 inputs (for decode).
    Prefill is `F.conv1d` with groups = C, a cross-correlation like the
    reference's `lax.conv_general_dilated` (the taps are not flipped), with
    cuDNN's TF32 off so a float32 conv stays float32."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)                         # [B,S+W-1,C]
    new_state = full[:, -(width - 1):, :]
    if x.shape[1] == 1:
        # decode: one dot against the window
        y = torch.einsum("bwc,wc->bc", full, w)[:, None, :] + bias
        return F.silu(y), new_state
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(full.transpose(1, 2), w.T[:, None, :],
                     groups=x.shape[2])
    # back to [B,S,C] in memory: the SSD kernel reads x, b and c with their
    # channels contiguous
    return F.silu(y.transpose(1, 2).contiguous() + bias), new_state


def mamba2_forward(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                   state: Optional[SSMState] = None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full Mamba2 mixer.  x: [B,S,d].  state = (conv_state, ssm_state) for
    incremental decode (S small, typically 1).  Returns (out, new_state).
    DTensor weights run through `_mamba2_sharded`."""
    if isinstance(p.in_proj.weight, DTensor):
        return _mamba2_sharded(p, cfg, x, state)
    conv_state, ssm_state = state if state is not None else (None, None)
    yz, new_conv, new_ssm = mamba2_rank(
        p.in_proj(x), p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, cfg, 0, 1,
        conv_state, ssm_state)
    y = gated_norm_rank(yz, p.norm_w, ssm_dims(cfg)[0], cfg.norm_eps)
    return p.out_proj(y), (new_conv, new_ssm)


# ---------------------------------------------------------------------- #
# tensor parallelism: each model rank's own heads
# ---------------------------------------------------------------------- #

def take(t: torch.Tensor, ranges, dim: int) -> torch.Tensor:
    """The slices [lo, hi) of `t` along `dim`, in order, as one tensor: a
    view where they meet end to end (one model rank holds every head),
    else a copy."""
    merged: list = []
    for lo, hi in ranges:
        if merged and merged[-1][1] == lo:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in merged]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def rank_ranges(cfg: ModelConfig, r: int, m: int):
    """(in_proj rows, conv channels) of model rank r of m: the rows of its
    heads' z, x and dt and of all of B and C, and the conv channels of its
    heads' x and of all of B and C, each as [lo, hi) ranges in order."""
    din, h, _, n = ssm_dims(cfg)
    dl, hl = din // m, h // m
    z, xs = (r * dl, (r + 1) * dl), (din + r * dl, din + (r + 1) * dl)
    bc = (2 * din, 2 * din + 2 * n)
    dt = (2 * din + 2 * n + r * hl, 2 * din + 2 * n + (r + 1) * hl)
    return [z, xs, bc, dt], [(r * dl, (r + 1) * dl), (din, din + 2 * n)]


def mamba2_rank(proj: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor, a_log: torch.Tensor,
                d_skip: torch.Tensor, dt_bias: torch.Tensor,
                cfg: ModelConfig, r: int, m: int,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model rank r of m's part of the mixer up to the gated norm, on plain
    tensors (r = 0 of 1: the whole mixer's): proj [B,S,...] the in_proj
    rows of `rank_ranges` (z, x, dt of its heads, all of B and C), the
    other weights whole (conv_w [W, C], conv_b [C], A_log, D, dt_bias
    [H]), conv_state the whole [B,W-1,C] or None, ssm_state the rank's
    heads [B,H/m,P,N] or None.  Returns (y * silu(z) [B,S,d_inner/m] in
    proj's dtype, the new conv state of its channels [B,W-1,d_inner/m+2N],
    the new SSM state of its heads)."""
    din, h, pdim, n = ssm_dims(cfg)
    dl, hl = din // m, h // m
    bs, s = proj.shape[:2]
    _, chans = rank_ranges(cfg, r, m)
    z, xbc, dt_raw = torch.split(proj, [dl, dl + 2 * n, hl], dim=-1)
    heads = slice(r * hl, (r + 1) * hl)
    dt = F.softplus(dt_raw.float() + dt_bias[heads].float())  # [B,S,H/m]
    xbc, new_conv = _causal_conv(
        xbc, take(conv_w, chans, 1), take(conv_b, chans, 0),
        None if conv_state is None else take(conv_state, chans, 2))
    xs, b, c = torch.split(xbc, [dl, n, n], dim=-1)
    xs = xs.reshape(bs, s, hl, pdim)
    a = -torch.exp(a_log[heads].float())
    if s % cfg.ssm_chunk == 0 and s >= cfg.ssm_chunk:
        # all four steps on the SSD's kernels on the card
        y, new_ssm = ssd_chunked(xs, dt, a, b, c, cfg.ssm_chunk, ssm_state)
    else:
        y, new_ssm = ssd_reference(xs.float(), dt, a, b.float(), c.float(),
                                   ssm_state)
    y = y.float() + xs.float() * d_skip[heads].float()[None, None, :, None]
    y = y.reshape(bs, s, dl).to(proj.dtype)
    return y * F.silu(z), new_conv, new_ssm


def gated_norm_rank(yz: torch.Tensor, norm_w: torch.Tensor, din: int,
                    eps: float, reduce=None) -> torch.Tensor:
    """`rms_norm` over the whole d_inner of one rank's [..., d_inner/m]
    part, with norm_w its slice: the rank's mean of squares, scaled by its
    share of d_inner, summed over the ranks by `reduce` (None: one rank
    holds all).  In the same ops as rms_norm, so one rank equals it."""
    f = yz.float()
    ms = torch.mean(f * f, dim=-1, keepdim=True) * (f.shape[-1] / din)
    if reduce is not None:
        ms = reduce(ms)
    return (f * torch.rsqrt(ms + eps) * (1.0 + norm_w.float())).to(yz.dtype)


def _local(w: DTensor, placements, grads) -> torch.Tensor:
    """w's local tensor under `placements` (a mesh dim of size 1 keeps w's
    own placement: it moves nothing), its gradient coming back under
    `grads` (likewise)."""
    mesh = w.device_mesh
    keep = [mesh.size(i) == 1 for i in range(mesh.ndim)]
    pl = [p if k else t for p, t, k in zip(w.placements, placements, keep)]
    gp = [p if k else g for p, g, k in zip(w.placements, grads, keep)]
    if tuple(pl) != tuple(w.placements):
        w = w.redistribute(mesh, pl)
    return w.to_local(grad_placements=gp)


def _mamba2_sharded(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[SSMState]
                    ) -> Tuple[DTensor, Optional[SSMState]]:
    """`mamba2_forward` on DTensor weights: each rank runs its own heads
    (`mamba2_rank`) on its rows of x (those of its batch axes, every row
    over "model") and returns out_proj's partial sum over "model".

    in_proj's output is gathered over "model" where it is no larger than
    in_proj's weight (B S <= d_model on the rank's rows: decode, short
    prompts), else the weight is (long prompts, training, one model
    rank); either way
    each rank keeps its `rank_ranges` rows.  The gathered tensor's
    gradient differs per rank (its heads' rows, its share of B and C), so
    it comes back a partial sum, reduce-scattered to the shards; likewise
    the other gathered weights'.  state: (conv [B,W-1,C], ssm [B,H,P,N])
    DTensors placed by `decode_state_specs`, their batch rows x's; the
    conv state is gathered over "model" (tiny) and the new one's x
    channels gathered back, so each rank writes its own shard; the SSM
    state's heads are the rank's own.

    Where the heads do not divide "model" (64 heads at a model axis of 3),
    every model rank runs the whole mixer on the same rows, the weights
    and the states gathered whole over "model": the output is replicated
    there, the weights' gradients come back replicated there (not summed
    over the ranks), and each rank writes back its own chunk of the
    states, whose P or N dim `decode_state_specs` split instead."""
    mesh = p.in_proj.weight.device_mesh
    names = mesh.mesh_dim_names
    din, h, _, _ = ssm_dims(cfg)
    m_axis = mesh.size(names.index("model")) if "model" in names else 1
    r_axis = mesh.get_local_rank("model") if m_axis > 1 else 0
    # where the heads do not divide "model", every model rank runs the
    # whole mixer (rank 0 of 1) on the same rows, replicated there
    r, m = (r_axis, m_axis) if h % m_axis == 0 else (0, 1)
    over_model = Partial() if m > 1 else Replicate()
    x = unsplit_sequence(x)
    rows = [Replicate() if n == "model" or not (q.is_shard() and q.dim == 0)
            else q for n, q in zip(names, x.placements)]
    split = [(n == "model" and m == m_axis) or q.is_shard()
             for n, q in zip(names, rows)]
    # the weights whole; gradients summed where ranks see other rows/heads
    whole = [Replicate()] * mesh.ndim
    partial = [Partial() if s else Replicate() for s in split]
    conv_w, conv_b, a_log, d_skip, dt_bias, norm_w = (
        _local(w, whole, partial) for w in (
            p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, p.norm_w))
    # out_proj [d, d_inner]: this rank's heads' columns
    by_heads = Shard(1) if m == m_axis else Replicate()
    w_out = _local(p.out_proj.weight, [by_heads if n == "model" else
                                       Replicate() for n in names],
                   [by_heads if n == "model" else g
                    for n, g in zip(names, partial)])
    xl = _local(x, rows, [over_model if n == "model" else q
                          for n, q in zip(names, rows)])
    own, _ = rank_ranges(cfg, r, m)
    if m > 1 and xl.shape[0] * xl.shape[1] <= cfg.d_model:
        w_in = _local(p.in_proj.weight, [Shard(0) if n == "model" else
                                         Replicate() for n in names],
                      [Shard(0) if n == "model" else g
                       for n, g in zip(names, partial)])
        proj = take(_gather_model(F.linear(xl, w_in), mesh, rows,
                                  p.in_proj.weight.shape[0]), own, 2)
    else:
        proj = F.linear(xl, take(_local(p.in_proj.weight, whole, partial),
                                 own, 0))

    conv_full = ssm_local = None
    if state is not None:
        conv, ssm = state
        conv_full = _local(conv, [Replicate() if n == "model" else q
                                  for n, q in zip(names, conv.placements)],
                           conv.placements)
        # the rank's heads (H divides "model"), else the whole state
        ssm_local = ssm.to_local() if m == m_axis else _local(
            ssm, [Replicate() if n == "model" else q
                  for n, q in zip(names, ssm.placements)], ssm.placements)
    yz, new_conv, new_ssm = mamba2_rank(proj, conv_w, conv_b, a_log, d_skip,
                                        dt_bias, cfg, r, m, conv_full,
                                        ssm_local)

    def sum_over_model(t: torch.Tensor) -> torch.Tensor:
        # an all-reduce both ways: every rank's norm reads the sum, so its
        # gradient is the sum of every rank's
        partial = [Partial() if n == "model" else q
                   for n, q in zip(names, rows)]
        return DTensor.from_local(t, mesh, partial, run_check=False) \
            .redistribute(mesh, rows).to_local(grad_placements=partial)

    dl = din // m
    y = gated_norm_rank(yz, norm_w[r * dl:(r + 1) * dl], din, cfg.norm_eps,
                        sum_over_model if m > 1 else None)
    out = DTensor.from_local(F.linear(y, w_out), mesh, [
        over_model if n == "model" else q for n, q in zip(names, rows)],
        run_check=False)
    if state is None:
        return out, None
    if m == m_axis:
        return out, (_conv_shard(new_conv, conv, din, r, m),
                     DTensor.from_local(new_ssm, mesh, ssm.placements,
                                        run_check=False))
    return out, (_own_shard(new_conv, conv, r_axis, m_axis),
                 _own_shard(new_ssm, ssm, r_axis, m_axis))


def _own_shard(full: torch.Tensor, like: DTensor, r: int, m: int
               ) -> DTensor:
    """A whole state `full` (this rank's rows) in `like`'s placements:
    model rank r of m keeps its chunk where "model" splits a dim of it
    (`decode_state_specs` puts the SSM state's P or N there when the heads
    do not divide "model")."""
    mesh, names = like.device_mesh, like.device_mesh.mesh_dim_names
    own = like.placements[names.index("model")] if "model" in names \
        else Replicate()
    if own.is_shard():
        full = full.chunk(m, dim=own.dim)[r]
    return DTensor.from_local(full.contiguous(), mesh, like.placements,
                              run_check=False)


def _gather_model(t: torch.Tensor, mesh, rows, width: int) -> torch.Tensor:
    """Each rank's columns t [B,S,width/M] of a [B,S,width] tensor gathered
    over "model" (`rows`: t's placements on the other axes), its gradient
    a partial sum over "model" reduce-scattered back."""
    names = mesh.mesh_dim_names
    shape = list(t.shape[:2]) + [width]
    for q, n in zip(rows, names):
        if q.is_shard():
            shape[0] *= mesh.size(names.index(n))
    stride = (shape[1] * width, width, 1)
    whole = DTensor.from_local(
        t, mesh, [Shard(2) if n == "model" else q for n, q in zip(names, rows)],
        run_check=False, shape=torch.Size(shape), stride=stride)
    return whole.redistribute(mesh, rows).to_local(grad_placements=[
        Partial() if n == "model" else q for n, q in zip(names, rows)])


def _conv_shard(new_conv: torch.Tensor, conv: DTensor, din: int, r: int,
                m: int) -> DTensor:
    """The new conv state [B,W-1,C] in `conv`'s placements from one rank's
    channels [B,W-1,d_inner/m+2N]: the x channels of every rank gathered
    over "model", and this rank's chunk kept."""
    if m == 1:
        return _own_shard(new_conv, conv, r, m)
    mesh, names = conv.device_mesh, conv.device_mesh.mesh_dim_names
    at = names.index("model")
    rows = [Replicate() if i == at else q
            for i, q in enumerate(conv.placements)]
    xs = DTensor.from_local(
        new_conv[..., :din // m].contiguous(), mesh,
        [Shard(2) if i == at else q for i, q in enumerate(rows)],
        run_check=False).redistribute(mesh, rows).to_local()
    return _own_shard(torch.cat([xs, new_conv[..., din // m:]], dim=-1),
                      conv, r, m)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda") -> SSMState:
    """Zeroed (conv [B,W-1,C] in dtype, ssm [B,H,P,N] float32)."""
    din, h, pdim, n = ssm_dims(cfg)
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, din + 2 * n),
                       dtype=dtype, device=device)
    ssm = torch.zeros((batch, h, pdim, n), dtype=torch.float32,
                      device=device)
    return conv, ssm
