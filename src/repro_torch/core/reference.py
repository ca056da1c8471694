"""Reference oracles: slow, obviously-correct re-implementations straight
from the paper's pseudocode.

Every function here trades all of the production engine's machinery —
numpy/scipy substrates, warm-started flows, shared gadget networks,
candidate caching — for the most literal possible transcription of the
paper: plain-dict Edmonds–Karp maxflow, a fresh network per probe, a full
candidate rescan per pick.  `tests/test_reference_differential.py` pins the
fast path to these functions over seeded random and zoo topologies, so any
optimization that changes a verdict (not just its cost) fails loudly.

Paper mapping (see docs/ALGORITHM.md for the line-by-line version):

* `reference_maxflow`            — the F(·,·) primitive every theorem uses
* `reference_min_flow_from_source` — Theorem 5/7 quantity
                                     min_v F(s, v; D_k)
* `reference_feasible`           — Theorem 7 condition
                                     min_v F(s, v; D_k) >= |Vc| k
* `reference_split_cap`          — Theorem 8 / eq. (2) maximum splittable M
* `reference_mu`                 — Theorem 12 / eq. (4) step size µ
* `reference_pack_rooted_trees`  — Algorithm 2 (generalised, per-root
                                    demands), fresh µ oracle per candidate
* `reference_pack_arborescences` — Algorithm 2 with demands ≡ k

The production counterparts are `FlowNetwork.maxflow` /
`min_flow_from_source` (core.maxflow), `_TheoremEightProber.split_cap`
(core.edge_split), and `_MuGadget.mu` / `pack_rooted_trees` /
`pack_arborescences` (core.arborescence).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .arborescence import PackingError, TreeClass
from .graph import DiGraph, Edge


def reference_maxflow(edges: Iterable[Tuple[int, int, int]], s: int, t: int,
                      limit: Optional[int] = None) -> int:
    """Edmonds–Karp on a plain dict residual graph: repeatedly push along a
    BFS-shortest augmenting path.  Parallel edges merge (flow values are
    distribution-independent).  Returns exactly ``min(F(s, t), limit)`` —
    the same contract as `FlowNetwork.maxflow`."""
    if s == t:
        raise ValueError("source == sink")
    cap: Dict[Edge, int] = {}
    adj: Dict[int, set] = {}
    for u, v, c in edges:
        if c < 0:
            raise ValueError(f"negative capacity on ({u}, {v})")
        cap[(u, v)] = cap.get((u, v), 0) + c
        cap.setdefault((v, u), 0)
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    flow = 0
    while limit is None or flow < limit:
        parent: Dict[int, int] = {s: s}
        queue = deque([s])
        while queue and t not in parent:
            u = queue.popleft()
            for v in sorted(adj.get(u, ())):
                if v not in parent and cap[(u, v)] > 0:
                    parent[v] = u
                    queue.append(v)
        if t not in parent:
            break
        path = []
        v = t
        while v != s:
            path.append((parent[v], v))
            v = parent[v]
        aug = min(cap[e] for e in path)
        if limit is not None:
            aug = min(aug, limit - flow)
        for (a, b) in path:
            cap[(a, b)] -= aug
            cap[(b, a)] += aug
        flow += aug
    return flow


# ---------------------------------------------------------------------- #
# Theorems 5/7/8 — the edge-splitting oracles
# ---------------------------------------------------------------------- #

def _dk_edges(d: DiGraph, k: int) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(super_source, edges) of D_k: the graph plus a super source tied to
    every compute node with capacity k."""
    s = d.num_nodes
    edges = [(a, b, c) for (a, b), c in sorted(d.cap.items())]
    edges.extend((s, u, k) for u in sorted(d.compute))
    return s, edges


def reference_min_flow_from_source(d: DiGraph, k: int) -> int:
    """Theorem 5/7 quantity: min_v F(s, v; D_k) over compute sinks v."""
    s, edges = _dk_edges(d, k)
    return min(reference_maxflow(edges, s, v) for v in sorted(d.compute))


def reference_feasible(d: DiGraph, k: int) -> bool:
    """Theorem 7: D_k admits the packing iff min_v F(s, v) >= |Vc| k."""
    return reference_min_flow_from_source(d, k) >= d.num_compute * k


def reference_split_cap(d: DiGraph, k: int, u: int, w: int, t: int) -> int:
    """Theorem 8 / eq. (2): the maximum M such that splitting the pair
    (u, w), (w, t) by M preserves the Theorem-7 condition.  Every term of
    the minimum is evaluated with a fresh D̂ network and a cold maxflow:

        M = min{ c(u,w), c(w,t),
                 min_{v != u}  F(u, w; D̂_(u,w),v) − |Vc| k,
                 min_v         F(w, t; D̂_(w,t),v) − |Vc| k }

    where D̂_(a,b),v is D_k plus ∞ edges making the term finite exactly on
    the paper's witness cuts: (u, s) and (u, t) in both, plus the per-sink
    probe edge (v, w) resp. (v, t) (v = t probes plain F(w, t))."""
    if u == t:
        raise ValueError("degenerate pair (u == t) is not covered by "
                         "Theorem 8 (use the Theorem-5 discard search)")
    bound = min(d.cap.get((u, w), 0), d.cap.get((w, t), 0))
    if bound <= 0:
        return 0
    nk = d.num_compute * k
    s, base_edges = _dk_edges(d, k)
    inf = 2 * sum(d.cap.values()) + nk + 1
    best = bound
    for v in sorted(d.compute):          # term 3: F(u, w; D̂_(u,w),v)
        if v == u:
            continue                     # ∞ probe (v,w)=(u,w) → F infinite
        edges = base_edges + [(u, s, inf), (u, t, inf), (v, w, inf)]
        best = min(best, reference_maxflow(edges, u, w) - nk)
        if best <= 0:
            return 0
    for v in sorted(d.compute):          # term 4: F(w, t; D̂_(w,t),v)
        edges = base_edges + [(w, s, inf), (u, t, inf)]
        if v != t:
            edges.append((v, t, inf))
        best = min(best, reference_maxflow(edges, w, t) - nk)
        if best <= 0:
            return 0
    return best


# ---------------------------------------------------------------------- #
# Theorem 12 / Algorithm 2 — tree packing
# ---------------------------------------------------------------------- #

def reference_mu(dstar: DiGraph, g: Dict[Edge, int],
                 classes: Sequence[TreeClass], ci: int,
                 x: int, y: int) -> int:
    """Theorem 12 / eq. (4): the step size for growing classes[ci] by edge
    (x, y), from a D̄ network built fresh for this single probe:

        µ = min{ g(x,y), m(R1), F(x,y; D̄) − Σ_{i≠1} m(R_i) }

    D̄ carries the residual capacities g plus, per other *incomplete* class
    R_i, a node s_i with x → s_i of capacity m(R_i) and ∞ edges s_i → v
    for every v already in R_i.  (Complete classes can never violate the
    packing condition, so they are omitted — exactly as in the production
    gadget.)"""
    cur = classes[ci]
    others = [c for j, c in enumerate(classes)
              if j != ci and c.mult > 0
              and len(c.vset) < dstar.num_compute]
    sum_m = sum(c.mult for c in others)
    inf = sum_m + sum(g.values()) + cur.mult + 1
    edges = [(a, b, c) for (a, b), c in sorted(g.items()) if c > 0]
    for j, c in enumerate(others):
        sid = dstar.num_nodes + j
        edges.append((x, sid, c.mult))
        edges.extend((sid, v, inf) for v in sorted(c.vset))
    f = reference_maxflow(edges, x, y)
    return min(g[(x, y)], cur.mult, f - sum_m)


def reference_pack_rooted_trees(dstar: DiGraph,
                                demands: Dict[int, int]) -> List[TreeClass]:
    """Algorithm 2, literally: grow each class to spanning, re-scanning
    every candidate edge in (depth-of-tail, head-id) order after every pick
    and computing µ with a fresh `reference_mu` network per candidate.  The
    candidate order matches the production packer exactly, and µ is exact
    on both sides, so the class list (roots, multiplicities, vertex and
    edge orders) is identical to `pack_rooted_trees`."""
    for w in dstar.switches:
        if any(w in e for e in dstar.cap):
            raise ValueError(
                f"pack expects a compute-only graph; switch {w} "
                f"still has incident edges")
    nodes = sorted(dstar.compute)
    if len(nodes) == 1:
        (u, k), = demands.items()
        return [TreeClass(root=u, mult=k, verts=[u], edges=[])]

    g: Dict[Edge, int] = dict(dstar.cap)
    classes: List[TreeClass] = [
        TreeClass(root=u, mult=m, verts=[u], edges=[])
        for u, m in sorted(demands.items()) if m > 0]
    queue: List[int] = list(range(len(classes)))
    all_v = set(nodes)
    qi = 0
    while qi < len(queue):
        ci = queue[qi]
        cur = classes[ci]
        while cur.vset != all_v:
            picked = False
            for x in cur.verts:
                for y in nodes:
                    e = (x, y)
                    if y in cur.vset or g.get(e, 0) <= 0:
                        continue
                    mu = reference_mu(dstar, g, classes, ci, x, y)
                    if mu <= 0:
                        continue
                    if mu < cur.mult:
                        rest = TreeClass(root=cur.root, mult=cur.mult - mu,
                                         verts=list(cur.verts),
                                         edges=list(cur.edges))
                        classes.append(rest)
                        queue.append(len(classes) - 1)
                        cur.mult = mu
                    cur.add_edge(e)
                    g[e] -= cur.mult
                    picked = True
                    break
                if picked:
                    break
            if not picked:
                raise PackingError(
                    f"no augmenting edge for root {cur.root} with "
                    f"verts={sorted(cur.vset)} — packing condition violated")
        qi += 1
    return classes


def reference_pack_arborescences(dstar: DiGraph, k: int) -> List[TreeClass]:
    """Algorithm 2 with demands ≡ k (allgather: k spanning out-trees per
    compute root)."""
    return reference_pack_rooted_trees(
        dstar, {u: k for u in sorted(dstar.compute)})
