"""Lower bounds: allgather (1), broadcast (5), allreduce (6)+(7), Theorem 19.

All bounds are returned as *runtime factors* in units of (data bytes) /
(bandwidth unit): multiply by M/bandwidth-unit to get seconds.

  allgather/reduce-scatter:  T >= (M/N) * inv_x_star              (1)
  broadcast:                 T >= M / min-compute-cut             (5)
  reduce:                    T >= M / min-compute-cut of G^T      (5 dual)
  allreduce:                 T >= M / min-compute-cut             (6)
  allreduce (Patarasuk-Yuan):T >= 2M(N-1)/N / max_v single-node-cut (7)
  alltoall:                  T >= (M/N) max_S |S∩Vc|(N-|S∩Vc|)/B+(S)

Per-root variants (`broadcast_root_lb`, `reduce_root_lb`) give the exact
bound a single-root schedule converges to: M / λ(root).
"""
from __future__ import annotations

import itertools
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from .graph import DiGraph
from .maxflow import FlowNetwork, build_network
from .optimality import allgather_inv_xstar


def min_compute_separating_cut(g: DiGraph) -> int:
    """min_{S: S∩Vc ∉ {∅,Vc}} B+_G(S).

    For Eulerian G this equals min over v of F(v0, v; G) for any fixed
    compute node v0 (cuts not containing v0 have Eulerian-equal complements
    that do)."""
    vc = sorted(g.compute)
    if len(vc) < 2:
        raise ValueError("need >= 2 compute nodes")
    v0 = vc[0]
    best = None
    for v in vc[1:]:
        net = build_network(g)
        f = net.maxflow(v0, v)
        best = f if best is None else min(best, f)
        # Eulerian symmetry: also the reverse direction
        net = build_network(g)
        f = net.maxflow(v, v0)
        best = min(best, f)
    return best


def single_node_cut(g: DiGraph, v: int) -> int:
    """min_{S: S∩Vc = {v}} B+_G(S): maxflow from v to a super-sink tied to
    every other compute node with ∞ capacity."""
    inf = sum(g.cap.values()) + 1
    net = FlowNetwork(g.num_nodes + 1)
    t = g.num_nodes
    for (a, b), c in g.cap.items():
        net.add_edge(a, b, c)
    for u in sorted(g.compute):
        if u != v:
            net.add_edge(u, t, inf)
    return net.maxflow(v, t)


def broadcast_lb(g: DiGraph) -> Fraction:
    """Eq (5): runtime factor M * [min cut]^-1 — per unit M."""
    return Fraction(1, min_compute_separating_cut(g))


def broadcast_root_lb(g: DiGraph, root: int) -> Fraction:
    """Eq (5) specialised to one source: T >= M / λ(root) with
    λ(root) = min_v F(root, v; G) — the exact bound the compiled broadcast
    schedule converges to as the chunk count grows."""
    from .schedule import broadcast_lambda
    return Fraction(1, broadcast_lambda(g, root))


def reduce_lb(g: DiGraph) -> Fraction:
    """Dual of eq (5): reduce is edge-reversed broadcast, so its bound is
    broadcast's on the transpose graph (equal for Eulerian G)."""
    return broadcast_lb(g.transpose())


def reduce_root_lb(g: DiGraph, root: int) -> Fraction:
    """Per-root reduce bound: M / min_v F(v, root; G) = broadcast_root_lb on
    the transpose graph."""
    return broadcast_root_lb(g.transpose(), root)


def allreduce_lb(g: DiGraph) -> Fraction:
    """max of eq (6) and eq (7), per unit M."""
    n = g.num_compute
    lb6 = Fraction(1, min_compute_separating_cut(g))
    best_single = max(single_node_cut(g, v) for v in sorted(g.compute))
    lb7 = Fraction(2 * (n - 1), n) / best_single
    return max(lb6, lb7)


def allgather_lb(g: DiGraph) -> Fraction:
    """Eq (1): runtime factor per unit M (the 1/N is folded in)."""
    return allgather_inv_xstar(g) / g.num_compute


#: memo for `alltoall_lb` — the bound is re-evaluated per simulate call and
#: the certified-cut sweep is hundreds of maxflows on the large fabrics
_A2A_LB_CACHE: Dict[str, Fraction] = {}

#: graphs up to this many total nodes get the exhaustive (exact over all
#: cuts) enumeration; larger ones the certified family
_A2A_ENUM_MAX_NODES = 16


def alltoall_lb(g: DiGraph) -> Fraction:
    """All-to-all runtime factor per unit M of per-node send buffer:
    ``max_S (1/N) · |S∩Vc| · (N−|S∩Vc|) / B+(S)`` — every source inside a
    cut S owes every destination outside it a distinct block of M/N bytes,
    all of which must cross S's egress capacity.

    Exhaustive over all cuts (hence exact) for graphs up to 16 nodes.
    Larger graphs maximize over a certified family — every single-node
    cut, every pairwise maxflow min-cut side and its complement, and
    every BFS-ball prefix cut from each compute seed — so the returned
    value is always a valid bound (each evaluated cut certifies it) and
    tight on fabrics whose bottleneck is a ball or a pairwise cut
    (rings, tori, circulants, switched clusters)."""
    key = g.fingerprint()
    hit = _A2A_LB_CACHE.get(key)
    if hit is not None:
        return hit
    n = g.num_compute
    if n < 2:
        raise ValueError("need >= 2 compute nodes")
    best = Fraction(0)

    def consider(nc: int, egress: int) -> None:
        nonlocal best
        if 0 < nc < n and egress > 0:
            val = Fraction(nc * (n - nc), n * egress)
            if val > best:
                best = val

    if g.num_nodes <= _A2A_ENUM_MAX_NODES:
        nodes = list(range(g.num_nodes))
        for r in range(1, g.num_nodes):
            for s in itertools.combinations(nodes, r):
                ss = set(s)
                consider(len(ss & g.compute), g.egress_set(ss))
    else:
        vc = sorted(g.compute)
        for v in vc:                       # |S∩Vc| = 1, minimal egress
            consider(1, single_node_cut(g, v))
        v0 = vc[0]
        all_nodes = set(range(g.num_nodes))
        for v in vc[1:]:
            for (s_node, t_node) in ((v0, v), (v, v0)):
                net = build_network(g)
                net.maxflow(s_node, t_node)
                side = set(net.min_cut_side(s_node))
                consider(len(side & g.compute), g.egress_set(side))
                comp = all_nodes - side
                consider(len(comp & g.compute), g.egress_set(comp))
        # BFS-ball prefix cuts, egress maintained incrementally: adding u
        # removes S→u capacity, adds u's out-capacity minus u→S
        out_adj: Dict[int, List[Tuple[int, int]]] = {}
        in_adj: Dict[int, List[Tuple[int, int]]] = {}
        out_cap: Dict[int, int] = {}
        for (a, b), c in g.cap.items():
            out_adj.setdefault(a, []).append((b, c))
            in_adj.setdefault(b, []).append((a, c))
            out_cap[a] = out_cap.get(a, 0) + c
        for seed in vc:
            order, seen = [seed], {seed}
            for u in order:
                for (w, _) in out_adj.get(u, ()):
                    if w not in seen:
                        seen.add(w)
                        order.append(w)
            ss: Set[int] = set()
            egress = nc = 0
            for u in order[:-1]:
                egress += out_cap.get(u, 0)
                egress -= sum(c for (w, c) in out_adj.get(u, ()) if w in ss)
                egress -= sum(c for (w, c) in in_adj.get(u, ()) if w in ss)
                ss.add(u)
                nc += u in g.compute
                consider(nc, egress)
    _A2A_LB_CACHE[key] = best
    return best


def rs_ag_allreduce_runtime(g: DiGraph) -> Fraction:
    """Runtime factor (per unit M) of optimal RS+AG allreduce: RS on G^T has
    the same optimum as AG on G (paper App. B), so RS+AG = 2 * (1)."""
    return 2 * allgather_lb(g)


def re_bc_allreduce_runtime(g: DiGraph) -> Fraction:
    """Runtime factor of optimal reduce+broadcast (Blink-style): reduce is
    reversed broadcast (same bound), so RE+BC = 2 * (5)."""
    return 2 * broadcast_lb(g)


# ---------------------------------------------------------------------- #
# Bottleneck-cut argmax + Theorem 19 (exponential — analysis/tests only)
# ---------------------------------------------------------------------- #

def brute_force_bottleneck_cut(g: DiGraph) -> Tuple[Set[int], Fraction]:
    """argmax_S |S∩Vc|/B+(S) by enumeration (guarded to small graphs)."""
    if g.num_nodes > 20:
        raise ValueError("bottleneck-cut enumeration limited to <= 20 nodes")
    best_cut: Set[int] = set()
    best = Fraction(0)
    nodes = list(range(g.num_nodes))
    for r in range(1, g.num_nodes + 1):
        for s in itertools.combinations(nodes, r):
            ss = set(s)
            if g.compute <= ss or not (ss & g.compute):
                continue
            out = g.egress_set(ss)
            if out == 0:
                continue
            val = Fraction(len(ss & g.compute), out)
            if val > best:
                best, best_cut = val, ss
    return best_cut, best


def theorem19_rs_ag_optimal(g: DiGraph) -> Optional[str]:
    """Check Theorem 19's sufficient conditions for RS+AG allreduce
    optimality.  Returns the satisfied condition name or None."""
    n = g.num_compute
    s_star, _ = brute_force_bottleneck_cut(g)
    nc = len(s_star & g.compute)
    if 2 * nc == n:
        return "(a) |S*∩Vc| = N/2"
    if nc == 1:
        (v_prime,) = tuple(s_star & g.compute)
        mine = single_node_cut(g, v_prime)
        best = max(single_node_cut(g, v) for v in sorted(g.compute))
        if mine == best:
            return "(b) singleton bottleneck with max single-node cut"
    return None
