"""Mixture-of-Experts with top-k routing, capacity-grouped dispatch, and
optional always-on shared experts (Qwen-MoE style).  Counterpart of
src/repro/models/moe.py, same arithmetic.

Dispatch is grouped: tokens are reshaped to [G, T/G] (G = `get_moe_groups()`,
the number of data shards; 1 unless a launcher sets it, and 1 whenever G
does not divide the token count).  Each group computes its own routing
positions and lands its tokens in its own [E, cap] dispatch buffer; tokens
past an expert's capacity go to an overflow row that is cut away, so they
contribute zero.  Every expert runs on its whole buffer (a dense dispatch):
the three expert products are batched matmuls over the expert dimension.

`moe_forward_alltoall` is the expert-parallel form over a comm of the
collective layer: each rank routes its own tokens, a destination-major
all-to-all carries each expert's tokens to the rank that owns it, and a
second one carries the results home.  The transport is a plain one
(`Stacked`: a transpose of the two rank dimensions; `P2P`:
`torch.distributed.all_to_all_single`) or the paper's tree all-to-all
(`functools.partial(tree_all_to_all, prog=..., comm=...)`); it only moves
values, so the outputs are bit-equal across transports.

Under tensor parallelism (DTensor weights on a ("data", "model") mesh,
repro_torch.launch.sharding) `moe_forward` runs the block on local tensors
(`_moe_forward_sharded`): every rank routes every token of the batch (so
the top-k, the capacity and its drops are the reference's), and computes
its slice of each expert's ff dim, so its output is a partial sum over
"model".
"""
from __future__ import annotations

import types
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.comms.collectives import Stacked

from .common import (ModelConfig, activation_candidate, activation_fn,
                     dense_init)
from .mlp import MLP, init_mlp, mlp_forward

_MOE_GROUPS = 1


def set_moe_groups(g: int) -> None:
    """Number of token groups (= data shards).  Launcher-owned knob."""
    global _MOE_GROUPS
    _MOE_GROUPS = max(1, int(g))


def get_moe_groups() -> int:
    return _MOE_GROUPS


class MoE(nn.Module):
    """router [d, E], w_gate and w_up [E, d, ff], w_down [E, ff, d] in the
    reference's layout; with shared experts a gated `MLP` of width
    ff * num_shared_experts and shared_gate [d, 1]."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        e, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, e, **kw))
        self.w_gate = nn.Parameter(torch.empty(e, d, ff, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, ff, **kw))
        self.w_down = nn.Parameter(torch.empty(e, ff, d, **kw))
        if cfg.num_shared_experts:
            self.shared = MLP(d, ff * cfg.num_shared_experts, dtype, device)
            self.shared_gate = nn.Parameter(torch.empty(d, 1, **kw))


@torch.no_grad()
def init_moe(p: MoE, cfg: ModelConfig, generator: torch.Generator) -> None:
    """Router and shared gate at scale 0.02; each expert matrix at
    1/sqrt(its fan-in: d for w_gate and w_up, ff for w_down)."""
    d, ff = cfg.d_model, cfg.moe_d_ff
    dense_init(p.router, d, generator, scale=0.02)
    dense_init(p.w_gate, d, generator)
    dense_init(p.w_up, d, generator)
    dense_init(p.w_down, ff, generator)
    if cfg.num_shared_experts:
        init_mlp(p.shared, generator)
        dense_init(p.shared_gate, d, generator, scale=0.02)


# ---------------------------------------------------------------------- #
# routing, dispatch, experts, combine
# ---------------------------------------------------------------------- #

def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert and group: the reference's Python float expression,
    ceil(tokens * k * capacity_factor / E), at least 1."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    return int(max(1, -(-tokens * k * cfg.capacity_factor // e)))


def _route(p: MoE, cfg: ModelConfig, xg: torch.Tensor, cap: int):
    """xg: [G, T, d] -> (probs [G, T, E] f32, weights [G, T, k] f32,
    onehot [G, T*k, E], slot [G, T*k]).  The top k come from a stable
    descending sort, so ties go to the lower expert index as in
    `jax.lax.top_k`; a choice past its expert's capacity gets the overflow
    slot E * cap."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g, t, _ = xg.shape
    logits = (xg @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., :k], idx[..., :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e_flat = idx.reshape(g, t * k)
    onehot = F.one_hot(e_flat, e)
    # each choice's position among its expert's choices: a running count,
    # scanned along the innermost dim of [G, E, T*k] (a scan along the
    # outer dim of [G, T*k, E] runs only G*E threads)
    cum = onehot.transpose(1, 2).contiguous().cumsum(2)
    pos = torch.gather(cum, 1, e_flat[:, None, :])[:, 0] - 1
    slot = torch.where(pos < cap, e_flat * cap + pos,
                       torch.full_like(e_flat, e * cap))
    return probs, weights, onehot, slot


def _dispatch(xg: torch.Tensor, slot: torch.Tensor, k: int, rows: int
              ) -> torch.Tensor:
    """[G, T, d] tokens into a [G, rows + 1, d] buffer, each token copied to
    the slots of its k choices.  Kept choices have unique slots; dropped
    ones all land in the overflow row `rows`, which the caller cuts away."""
    g, t, d = xg.shape
    buf = torch.zeros(g * (rows + 1), d, dtype=xg.dtype, device=xg.device)
    base = torch.arange(g, device=xg.device)[:, None] * (rows + 1)
    buf.index_copy_(0, (slot + base).reshape(-1),
                    xg.repeat_interleave(k, dim=1).reshape(g * t * k, d))
    return buf.view(g, rows + 1, d)


def _expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, activation: str) -> torch.Tensor:
    """xe: [E', M, d] tokens of each of E' experts -> [E', M, d]."""
    act = activation_fn(activation)
    h = act(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def _combine(p: MoE, cfg: ModelConfig, xg: torch.Tensor, ye: torch.Tensor,
             slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """ye: [G, E * cap, d] expert outputs -> [G, T, d]: each token's k
    outputs (zero for a dropped choice) weighted and summed, plus the
    sigmoid-gated shared expert."""
    g, t, d = xg.shape
    k = cfg.num_experts_per_tok
    flat = torch.cat([ye, ye.new_zeros(g, 1, d)], dim=1)
    y_rep = torch.gather(flat, 1, slot[..., None].expand(g, t * k, d))
    y = (y_rep.view(g, t, k, d) * weights[..., None].to(xg.dtype)).sum(2)
    if cfg.num_shared_experts:
        gate = torch.sigmoid((xg @ p.shared_gate).float())
        y = y + mlp_forward(p.shared, xg, cfg.activation) * gate.to(xg.dtype)
    return y


def _aux_stats(cfg: ModelConfig, probs: torch.Tensor, onehot: torch.Tensor,
               dims=(0, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The load-balancing loss's two means over the tokens: each expert's
    share of the routed choices, and its mean router probability."""
    g, t, e = probs.shape
    k = cfg.num_experts_per_tok
    density = onehot.view(g, t, k, e).sum(2).float().mean(dims)
    return density, probs.mean(dims)


def _aux(cfg: ModelConfig, probs: torch.Tensor, onehot: torch.Tensor,
         dims=(0, 1)) -> torch.Tensor:
    """Switch-style load-balancing loss: over all groups' tokens (a
    scalar), or with dims=1 one per group ([G])."""
    density, pmean = _aux_stats(cfg, probs, onehot, dims)
    return cfg.num_experts * (density * pmean).sum(-1)


def _local_groups(cfg: ModelConfig, x: DTensor) -> bool:
    """Whether the dry run's activation policy puts one token group on
    each rank of the batch axes ('moe_tokens': groups over the data
    shards), and x's rows split into those groups."""
    mesh = x.device_mesh
    dpg = 1
    for i, n in enumerate(mesh.mesh_dim_names):
        if n != "model":
            dpg *= mesh.size(i)
    b, s, d = x.shape
    t = b * s
    return (_MOE_GROUPS == dpg > 1 and t % dpg == 0 and b % dpg == 0
            and activation_candidate((dpg, t // dpg, d), "moe_tokens")
            is not None)


def _moe_forward_sharded(p: MoE, cfg: ModelConfig, x: DTensor
                         ) -> Tuple[DTensor, DTensor]:
    """`moe_forward` of DTensor weights and tokens, on local tensors.  The
    tokens and the router are gathered whole on every rank; the expert
    tensors (and the shared expert) keep their ff dim over "model" where
    it divides and are gathered over every other mesh dim.  The output is
    then a partial sum over "model", and so is the aux loss, which each
    rank scales by 1 / mp; the gradients of the whole tokens and router
    are partial sums likewise.  Where ff does not divide "model", every
    rank computes the whole block and the outputs are replicated.

    Under the dry run's activation policy ('moe_tokens': one token group
    per rank of the batch axes, `set_moe_groups` = their size) the tokens
    keep their rows over the batch axes instead: each rank routes and
    computes its own group, as the reference's grouped dispatch does, the
    weights' gradients are partial sums over the batch axes too, and the
    aux loss's two means are averaged over them before their product."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    mp = mesh.size(names.index("model")) if "model" in names else 1
    split = cfg.moe_d_ff % mp == 0 and (
        not cfg.num_shared_experts
        or cfg.moe_d_ff * cfg.num_shared_experts % mp == 0)
    part = Partial() if split else Replicate()
    grouped = _local_groups(cfg, x)
    grad_rows = Partial() if grouped else Replicate()

    def on(model_pl, rows_pl=Replicate()):
        return [model_pl if n == "model" else rows_pl for n in names]

    def local(t: DTensor, model_pl, grad_pl=None, rows=Replicate(),
              grads=grad_rows):
        model_pl = model_pl if split else Replicate()
        return t.redistribute(mesh, on(model_pl, rows)).to_local(
            grad_placements=on(model_pl if grad_pl is None else grad_pl,
                               grads))

    lp = types.SimpleNamespace(
        router=local(p.router, Replicate(), part),
        w_gate=local(p.w_gate, Shard(2)), w_up=local(p.w_up, Shard(2)),
        w_down=local(p.w_down, Shard(1)))
    if cfg.num_shared_experts:
        sh = p.shared
        lp.shared = types.SimpleNamespace(
            variant="gated",
            w_gate=types.SimpleNamespace(
                weight=local(sh.w_gate.weight, Shard(0)), bias=None),
            w_up=types.SimpleNamespace(
                weight=local(sh.w_up.weight, Shard(0)), bias=None),
            w_down=types.SimpleNamespace(
                weight=local(sh.w_down.weight, Shard(1)), bias=None))
        lp.shared_gate = local(p.shared_gate, Replicate(), part)
    rows = Shard(0) if grouped else Replicate()
    y, probs, onehot = _moe_dense(
        lp, cfg, local(x, Replicate(), part, rows, rows),
        1 if grouped else _MOE_GROUPS)
    y = DTensor.from_local(y, mesh, on(part, rows), run_check=False)
    if not grouped:
        aux = _aux(cfg, probs, onehot)
        if split:
            aux = aux / mp
        return y, DTensor.from_local(aux, mesh, on(part), run_check=False)
    share = mesh.size() // (1 if split else mp)
    stats = DTensor.from_local(
        torch.stack(_aux_stats(cfg, probs, onehot)) / share, mesh,
        on(part, Partial()), run_check=False)
    stats = stats.redistribute(mesh, on(Replicate()))
    return y, cfg.num_experts * (stats[0] * stats[1]).sum()


def _moe_dense(p: MoE, cfg: ModelConfig, x: torch.Tensor, groups: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouped dense dispatch of x [B, S, d] in `groups` groups (1
    where they do not divide the tokens) -> (out [B, S, d], router probs
    [G, T/G, E], choices one-hot [G, T/G * k, E])."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    groups = groups if t % groups == 0 else 1
    tl = t // groups
    xg = x.reshape(groups, tl, d)
    cap = _capacity(tl, cfg)
    probs, weights, onehot, slot = _route(p, cfg, xg, cap)
    buf = _dispatch(xg, slot, k, e * cap)
    # [G, E, cap, d] -> one batched product per expert over all groups
    xe = buf[:, :e * cap].view(groups, e, cap, d).transpose(0, 1)
    ye = _expert_ffn(xe.reshape(e, groups * cap, d), p.w_gate, p.w_up,
                     p.w_down, cfg.activation)
    ye = ye.view(e, groups, cap, d).transpose(0, 1).reshape(
        groups, e * cap, d)
    y = _combine(p, cfg, xg, ye, slot, weights)
    return y.reshape(b, s, d), probs, onehot


def moe_forward(p: MoE, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], load-balance aux loss scalar).
    DTensor tokens take `_moe_forward_sharded`."""
    if isinstance(x, DTensor):
        return _moe_forward_sharded(p, cfg, x)
    y, probs, onehot = _moe_dense(p, cfg, x, _MOE_GROUPS)
    return y, _aux(cfg, probs, onehot)


# ---------------------------------------------------------------------- #
# expert parallel
# ---------------------------------------------------------------------- #

def _default_all_to_all(comm) -> Callable[[torch.Tensor], torch.Tensor]:
    if isinstance(comm, Stacked):
        return lambda v: v.transpose(0, 1).contiguous()

    def exchange(v: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(v)
        dist.all_to_all_single(out, v.contiguous(), group=comm.group)
        return out
    return exchange


def moe_forward_alltoall(p: MoE, cfg: ModelConfig, x: torch.Tensor, comm,
                         all_to_all: Optional[Callable] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE forward over the ranks of `comm` (a `Stacked`
    axis, where x is [A, B, S, d] with every rank's tokens, or a `P2P`
    group, where x is this rank's [B, S, d]).  Rank r owns the contiguous
    experts [r * E/A, (r+1) * E/A); tokens stay data-parallel.  Routing and
    capacity dropping run per rank (cap from the rank's own tokens), the
    destination-major [A, (E/A) * cap, d] dispatch buffer crosses to the
    experts' ranks through `all_to_all`, each rank runs its expert slice
    on every source's tokens, and a second all-to-all carries the results
    home.  The full weights are passed in; the slice happens here, and
    under `Stacked` all ranks' slices run as one batched product.

    ``all_to_all`` takes and returns the comm's form of [A, ...] per rank;
    it defaults to the plain transport.  Returns (out in x's form, aux:
    one scalar per rank in the comm's form, each from the rank's own
    tokens)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    a = comm.axis_size
    if e % a:
        raise ValueError(f"num_experts {e} not divisible by axis size {a}")
    el = e // a
    if all_to_all is None:
        all_to_all = _default_all_to_all(comm)
    xl = comm.local(x)
    n, b, s_len, d = xl.shape
    t = b * s_len
    xg = xl.reshape(n, t, d)                       # one group per rank
    # local capacity per expert: every source may ship up to `cap` tokens
    # to each expert, so an expert sees at most A * cap in total
    cap = _capacity(t, cfg)
    probs, weights, onehot, slot = _route(p, cfg, xg, cap)
    buf = _dispatch(xg, slot, k, e * cap)
    xe = buf[:, :e * cap].reshape(n, a, el * cap, d)   # dest-major slabs
    recv = comm.local(all_to_all(comm.unlocal(xe)))    # [n, src, el*cap, d]
    xr = recv.reshape(n, a, el, cap, d).transpose(1, 2).reshape(
        n * el, a * cap, d)                # per local expert, all sources
    lo = comm.ranks[0] * el                # the local ranks are contiguous
    ye = _expert_ffn(xr, p.w_gate.narrow(0, lo, n * el),
                     p.w_up.narrow(0, lo, n * el),
                     p.w_down.narrow(0, lo, n * el), cfg.activation)
    back = ye.view(n, el, a, cap, d).transpose(1, 2).reshape(
        n, a, el * cap, d)
    z = comm.local(all_to_all(comm.unlocal(back)))     # [n, exp-rank, ...]
    y = _combine(p, cfg, xg, z.reshape(n, e * cap, d), slot, weights)
    return (comm.unlocal(y.reshape(n, b, s_len, d)),
            comm.unlocal(_aux(cfg, probs, onehot, dims=1)))
