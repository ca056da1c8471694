"""§2.3 Spanning-tree packing (Algorithm 2, Bérczi–Frank / Schrijver).

Packs k edge-disjoint spanning out-trees rooted at *every* compute node into
the direct-connect graph D* = (Vc, E*) produced by edge splitting.  Identical
trees are kept aggregated as a `TreeClass` with multiplicity m(R) — the
algorithm's runtime is independent of k (strongly polynomial).

The step size µ for adding edge (x,y) to a class is computed with a single
maxflow in the auxiliary network D̄ of Theorem 12:

    µ = min{ g(x,y), m(R1), F(x,y; D̄) − Σ_{i≠1} m(R_i) }       (eq. 4)

Classes that already span Vc can never violate condition (3) (R_i ⊆ S is
impossible for S ⊊ Vc), so they are dropped from the gadget — this keeps D̄
small and is exactly equivalent (their gadget path contributes F and Σ terms
that cancel).

Candidate edges are scanned in (depth-of-tail, head-id) order, which grows
BFS-like trees: minimum-height packing is NP-complete (paper §2.3), but
shallow trees reduce pipeline fill latency, so the heuristic matters in
practice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

from .graph import DiGraph, Edge
from .maxflow import FlowNetwork


class PackingError(RuntimeError):
    pass


@dataclasses.dataclass
class TreeClass:
    """m identical partial out-trees rooted at `root`."""
    root: int
    mult: int
    verts: List[int]               # vertices in addition order (root first)
    edges: List[Edge]              # tree edges in addition order
    vset: set = dataclasses.field(default_factory=set)
    depth: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.vset = set(self.verts)
        d = {self.root: 0}
        for (a, b) in self.edges:
            d[b] = d[a] + 1
        self.depth = d

    def add_edge(self, e: Edge) -> None:
        """Grow the tree by edge e = (a, b): b joins the vertex order and
        the depth map incrementally (no O(|E|) recomputation)."""
        a, b = e
        self.edges.append(e)
        self.verts.append(b)
        self.vset.add(b)
        self.depth[b] = self.depth[a] + 1

    def depth_of(self, v: int) -> int:
        """Depth of v in the tree (root = 0) — a dict lookup; the map is
        maintained incrementally by `add_edge`."""
        return self.depth[v]

    def parent_map(self) -> Dict[int, int]:
        return {b: a for (a, b) in self.edges}

    def children_map(self) -> Dict[int, List[int]]:
        ch: Dict[int, List[int]] = {}
        for (a, b) in self.edges:
            ch.setdefault(a, []).append(b)
        return ch


def pack_arborescences(dstar: DiGraph, k: int) -> List[TreeClass]:
    """Algorithm 2.  Returns classes with Σ_{classes of u} mult == k for every
    compute node u, edge-disjoint w.r.t. dstar's capacities."""
    demands = {u: k for u in sorted(dstar.compute)}
    classes = pack_rooted_trees(dstar, demands)
    verify_packing(dstar, k, classes)
    return classes


def pack_rooted_trees(dstar: DiGraph,
                      demands: Dict[int, int]) -> List[TreeClass]:
    """Generalised Algorithm 2: pack `demands[u]` spanning out-trees rooted
    at each u (allgather: k per compute node; broadcast: λ at one root)."""
    for w in dstar.switches:
        # isolated switches (left over from edge splitting) are fine
        if any(w in e for e in dstar.cap):
            raise ValueError(
                f"pack expects a compute-only graph; switch {w} "
                f"still has incident edges")
    nodes = sorted(dstar.compute)
    n = len(nodes)
    if n == 1:
        (u, k), = demands.items()
        return [TreeClass(root=u, mult=k, verts=[u], edges=[])]

    g: Dict[Edge, int] = dict(dstar.cap)          # residual edge capacities
    classes: List[TreeClass] = [
        TreeClass(root=u, mult=m, verts=[u], edges=[])
        for u, m in sorted(demands.items()) if m > 0]
    # grow classes to completion one at a time; splits enqueue copies
    queue: List[int] = list(range(len(classes)))
    all_v = set(nodes)

    sinks = sorted(dstar.compute)
    qi = 0
    while qi < len(queue):
        ci = queue[qi]
        cur = classes[ci]
        # ONE Theorem-12 gadget network for the whole growth of this class,
        # shared across every candidate tail x (toggleable tail edges — see
        # `_MuGadget`) and kept *across* picks: a pick applies its residual-
        # capacity delta (and any split-off class) to the gadget in place.
        gadget: Optional[_MuGadget] = None
        # (x, y) candidates whose µ came back <= 0 for this class growth.
        # µ is monotonically non-increasing while the class grows (picks
        # only shrink g and want, and a split raises Σm by exactly the
        # amount F can gain through the grafted s_i), so a rejected
        # candidate stays rejected — and by the same argument the scan is
        # *resumable*: after a pick at position (xi, yi) every candidate
        # before it is still rejected for its original reason (vset only
        # grows, g never rises, µ never rises), so instead of restarting
        # the (tail, head) sweep from scratch each pick continues it in
        # place.  A re-validation pass below guards the invariant: on a
        # stall the cache is dropped and the sweep restarts from zero once
        # before the packing condition is declared violated.
        negative: Set[Edge] = set()
        revalidated = False
        xi = yi = 0
        while cur.vset != all_v:
            picked = False
            # candidate edges: BFS-like order (oldest tail vertex first)
            while xi < len(cur.verts):
                x = cur.verts[xi]
                while yi < len(sinks):
                    y = sinks[yi]
                    yi += 1
                    e = (x, y)
                    if y in cur.vset or g.get(e, 0) <= 0 or e in negative:
                        continue
                    if gadget is None:
                        gadget = _MuGadget(dstar, g, classes, ci)
                    mu = gadget.mu(x, y)
                    if mu <= 0:
                        negative.add(e)
                        continue
                    rest = None
                    if mu < cur.mult:
                        # split: a copy keeps the old shape with the rest
                        rest = TreeClass(root=cur.root, mult=cur.mult - mu,
                                         verts=list(cur.verts),
                                         edges=list(cur.edges))
                        classes.append(rest)
                        queue.append(len(classes) - 1)
                        cur.mult = mu
                    cur.add_edge(e)
                    g[e] -= cur.mult
                    gadget.note_pick(e, g[e], rest)
                    picked = True
                    revalidated = False
                    break
                if picked:
                    break
                xi += 1
                yi = 0
            if not picked:
                if negative and not revalidated:
                    # re-validation pass: the cache rests on µ monotonicity;
                    # before declaring the packing condition violated, drop
                    # every cached rejection (and the gadget whose residual
                    # state produced them) and rescan from scratch once.
                    negative.clear()
                    gadget = None
                    revalidated = True
                    xi = yi = 0
                    continue
                raise PackingError(
                    f"no augmenting edge for root {cur.root} with "
                    f"verts={sorted(cur.vset)} — packing condition violated")
        qi += 1

    return classes


class _MuGadget:
    """Theorem 12's auxiliary network D̄ for the growth of one class,
    shared across every candidate tail x and head y: µ for adding edge
    (x,y) to classes[ci] is  min{g(x,y), m(R1), F(x,y; D̄) − Σ m(R_i)}.

    The network D̄ of the paper attaches one node s_i per other
    *incomplete* class, with an edge x -> s_i of capacity m(R_i) from the
    candidate tail.  Those tail edges are the only x-dependent part, so
    instead of one network per tail the gadget routes them through a hub:
    a single hub node h with h -> s_i of capacity m(R_i), plus a
    toggleable u -> h edge per compute vertex — exactly one of them (the
    probed tail's, at the ∞ stand-in) is active per probe.  Every unit of
    s_i inflow still originates at x and is still capped at m(R_i), so
    F(x, y) is exactly the paper's value, and switching tails is two
    capacity writes instead of a network build.

    A pick only (a) lowers one residual capacity g(e) and (b) may split
    off a new incomplete class, so `note_pick` rewrites that one edge and
    grafts the split class's s_i node in place (hub edge + ∞ fan-out)
    instead of rebuilding.  Other classes never change while classes[ci]
    grows, so no other state can go stale.

    The ∞ stand-in only needs to exceed the flow limit Σm + m(R1), and
    Σm + m(R1) is conserved by splits while g only shrinks, so the value
    sized at build time stays sufficient — the computed µ is identical
    for any sufficiently large value.

    Fast accept: edge (x,y) itself and the Σm − miss(y) units routable
    x -> h -> s_i -> y through classes that already contain y are
    edge-disjoint flows, so F ≥ g(x,y) + Σm − miss(y) (miss(y) = Σ m(R_i)
    over incomplete classes *not* containing y).  When g(x,y) − miss(y)
    ≥ min{g(x,y), m(R1)} this lower bound already pins µ = want, and the
    probe returns without running a maxflow at all."""

    __slots__ = ("net", "g", "cur", "sum_m", "inf", "eid", "tail_eid",
                 "hub", "miss", "cur_tail")

    def __init__(self, dstar: DiGraph, g: Dict[Edge, int],
                 classes: Sequence[TreeClass], ci: int):
        cur = classes[ci]
        # gadget: one node s_i per other *incomplete* class
        others = [c for j, c in enumerate(classes)
                  if j != ci and c.mult > 0
                  and len(c.vset) < dstar.num_compute]
        sum_m = sum(c.mult for c in others)
        inf = sum_m + sum(g.values()) + cur.mult + 1
        edges = [(a, b, c) for (a, b), c in g.items() if c > 0]
        self.eid: Dict[Edge, int] = {
            (a, b): 2 * j for j, (a, b, _) in enumerate(edges)}
        hub = dstar.num_nodes
        tails = sorted(dstar.compute)
        self.tail_eid: Dict[int, int] = {
            u: 2 * (len(edges) + j) for j, u in enumerate(tails)}
        edges.extend((u, hub, 0) for u in tails)
        for j, c in enumerate(others):
            sid = hub + 1 + j
            edges.append((hub, sid, c.mult))
            edges.extend((sid, v, inf) for v in c.verts)
        self.net = FlowNetwork(hub + 1 + len(others))
        self.net.add_edges(edges)
        self.g, self.cur = g, cur
        self.sum_m, self.inf = sum_m, inf
        self.hub = hub
        self.miss: Dict[int, int] = {
            y: sum(c.mult for c in others if y not in c.vset)
            for y in tails}
        self.cur_tail: Optional[int] = None

    def note_pick(self, e: Edge, new_cap: int,
                  rest: Optional[TreeClass]) -> None:
        """Apply a pick's delta: edge e's residual capacity dropped to
        `new_cap`, and `rest` (if the pick split the class) joins the
        gadget as a fresh incomplete class."""
        eid = self.eid.get(e)
        if eid is None:      # e had capacity 0 at build time (cannot
            eid = self.net.add_edge(*e, 0)    # happen: g never grows), but
            self.eid[e] = eid                 # stay safe
        self.net.set_edge_cap(eid, new_cap)
        if rest is not None:
            sid = self.net.add_node()
            self.net.add_edge(self.hub, sid, rest.mult)
            self.net.add_edges((sid, v, self.inf) for v in rest.verts)
            self.sum_m += rest.mult
            for y in self.miss:
                if y not in rest.vset:
                    self.miss[y] += rest.mult

    def mu(self, x: int, y: int) -> int:
        want = min(self.g[(x, y)], self.cur.mult)
        if self.g[(x, y)] - self.miss[y] >= want:
            return want          # lower bound pins µ (see class docstring)
        if x != self.cur_tail:
            if self.cur_tail is not None:
                self.net.set_edge_cap(self.tail_eid[self.cur_tail], 0)
            self.net.set_edge_cap(self.tail_eid[x], self.inf)
            self.cur_tail = x
        limit = self.sum_m + want
        self.net.reset_flow()
        f = self.net.maxflow(x, y, limit=limit)
        return min(want, f - self.sum_m)


# ---------------------------------------------------------------------- #
# Verification (used by tests and by the schedule builder in verify mode)
# ---------------------------------------------------------------------- #

def verify_packing(dstar: DiGraph, k: int,
                   classes: Sequence[TreeClass]) -> None:
    """Assert the Algorithm-2 output contract:
    * every class is a spanning out-tree rooted at its root;
    * per root, multiplicities sum to k;
    * edge-disjoint: per edge, Σ mult of classes using it <= capacity."""
    verify_rooted_packing(dstar, {u: k for u in sorted(dstar.compute)},
                          classes)


def verify_rooted_packing(dstar: DiGraph, demands: Dict[int, int],
                          classes: Sequence[TreeClass]) -> None:
    """Demand-weighted contract of `pack_rooted_trees`: spanning out-trees,
    per-root multiplicities summing to demands[root], edge-disjointness
    (used both by allgather, demands ≡ k, and broadcast, {root: λ})."""
    nodes = sorted(dstar.compute)
    per_root: Dict[int, int] = {u: 0 for u in demands}
    load: Dict[Edge, int] = {}
    for c in classes:
        if c.mult <= 0:
            raise PackingError(f"class with non-positive multiplicity {c.mult}")
        per_root[c.root] += c.mult
        if set(c.verts) != set(nodes):
            raise PackingError(f"root {c.root}: tree does not span Vc")
        if len(c.edges) != len(nodes) - 1:
            raise PackingError(f"root {c.root}: {len(c.edges)} edges != N-1")
        indeg: Dict[int, int] = {}
        reach = {c.root}
        for (a, b) in c.edges:          # edges are in addition order
            indeg[b] = indeg.get(b, 0) + 1
            if a not in reach:
                raise PackingError(f"root {c.root}: edge {(a,b)} detached")
            reach.add(b)
        if any(d != 1 for d in indeg.values()) or c.root in indeg:
            raise PackingError(f"root {c.root}: not an out-tree")
        for e in c.edges:
            load[e] = load.get(e, 0) + c.mult
    for u, total in per_root.items():
        if total != demands[u]:
            raise PackingError(
                f"root {u}: multiplicities sum to {total} != {demands[u]}")
    for e, used in load.items():
        if used > dstar.cap.get(e, 0):
            raise PackingError(
                f"edge {e}: load {used} exceeds capacity {dstar.cap.get(e, 0)}")


def max_tree_depth(classes: Sequence[TreeClass]) -> int:
    return max((max(c.depth.values(), default=0) for c in classes),
               default=0)
