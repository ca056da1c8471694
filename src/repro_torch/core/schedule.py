"""Pipeline schedule IR — from spanning trees to executable comm rounds.

A `PipelineSchedule` is the deployable artifact: a static list of rounds,
each a list of `Send(src, dst, root, slot)` operations at chunk granularity.
Chunking implements the paper's §1.3 resolution of the minimality-or-
saturation dilemma: each of the k trees per root streams P chunks, so the
runtime converges to the optimum as (P + depth − 1)/P → 1.

Builders (the full collective family the paper's abstract promises):
  compile_allgather      — §2.1-2.3 end-to-end (optimality, split, pack)
  compile_reduce_scatter — allgather on the transpose graph, reversed
                           (paper Appendix B / Zhao et al. [19] App. A)
  compile_allreduce      — RS + AG concatenation (Appendix B)
  compile_broadcast      — Appendix A: λ(r) = min_v F(r, v; G) edge-disjoint
                           out-trees from one root; switched topologies go
                           through the rooted edge-splitting variant
  compile_reduce         — broadcast on the transpose graph, reversed, with
                           the accumulation (op fusion) happening bottom-up
                           along each reversed tree
  compile_alltoall       — per-source pruned scatter over the same packed
                           spanning trees (Basu/Pal/Zhao et al. direct-
                           connect all-to-all): tree edge (a, b) of root r
                           forwards only the chunks whose destination lies
                           in subtree(b), so each (r, w) block travels the
                           unique r→w tree path and nothing else

All of them are thin wrappers over the staged pipeline in
`repro.core.plan` (solve → split → pack → rounds → lower), which records
per-stage wall time and size stats on the emitted artifact
(`PipelineSchedule.compile_stats`) and can amortize shared stages across
a whole collective family (`plan.compile_family`).

Physical path assignment: every tree-edge unit of capacity is bound to a
concrete switch path of the original graph G (via the edge-splitting
`routing` table), so the simulator can re-validate the bandwidth bound on
*physical* links, and a deployment can emit per-link send/recv programs.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from .arborescence import TreeClass, max_tree_depth
from .edge_split import SplitResult, expand_paths
from .graph import DiGraph, Edge
from .maxflow import build_network
from .optimality import Optimality


class Send(NamedTuple):
    """One chunk transfer on the logical graph D*.

    A NamedTuple rather than a (frozen) dataclass: schedules materialize
    millions of these and tuple construction is several times cheaper than
    a frozen dataclass's per-field object.__setattr__."""
    src: int
    dst: int
    root: int      # whose shard this chunk belongs to
    slot: int      # chunk slot within the root's shard: [0, k*P) for the
                   # allgather family, [0, N*k*P) for alltoall (the slot
                   # folds the destination in: dest_index*k*P + subslot)
    cls: int       # class index (for path assignment / debugging)


@dataclasses.dataclass
class PipelineSchedule:
    """The deployable artifact: a static list of chunk-granular rounds plus
    everything needed to re-verify it (optimality result, tree classes,
    edge-splitting routing, physical path assignment).  Serialized by
    `repro.cache.serialize`; lowered to ppermute programs by
    `repro.comms.compile_program`."""
    kind: str                      # allgather | reduce_scatter |
                                   # broadcast | reduce | alltoall
    topo: DiGraph                  # original G (possibly with switches)
    dstar: DiGraph                 # logical compute-only graph (caps U*b_e)
    opt: Optimality
    classes: List[TreeClass]
    split: SplitResult
    num_chunks: int                # P — pipeline chunks per tree
    rounds: List[List[Send]]
    class_slot_offset: List[int]   # per class: first slot within root shard
    # physical path assignment: (cls, edge) -> [(path, units), ...]
    path_assignment: Dict[Tuple[int, Edge], List[Tuple[Tuple[int, ...], int]]]
    # exact pipelined runtime (data_size=1) claimed by the compiler; filled
    # in by the simulator / cache layer, carried by serialized artifacts so
    # a loaded schedule can be re-verified against its claim.
    claimed_runtime: Optional[Fraction] = None
    # per-stage compiler instrumentation (repro.core.plan.CompileStats).
    # Not part of the canonical artifact payload — the cache stores it in a
    # stats sidecar, the sweep copies it into BENCH rows.
    compile_stats: Optional[Any] = None

    @property
    def nodes(self) -> List[int]:
        return sorted(self.dstar.compute)

    @property
    def num_nodes(self) -> int:
        return len(self.dstar.compute)

    @property
    def k(self) -> int:
        return self.opt.k

    @property
    def root(self) -> Optional[int]:
        """The single root of a broadcast/reduce schedule (None otherwise)."""
        if self.kind in ("broadcast", "reduce"):
            return self.classes[0].root
        return None

    @property
    def slots_per_shard(self) -> int:
        """Chunk slots per source shard.  The allgather family splits each
        node's shard into k·P slots; alltoall carries N distinct destination
        blocks per source, each split into k·P subslots."""
        if self.kind == "alltoall":
            return self.num_nodes * self.opt.k * self.num_chunks
        return self.opt.k * self.num_chunks

    @property
    def depth(self) -> int:
        return max_tree_depth(self.classes)

    def total_sends(self) -> int:
        return sum(len(r) for r in self.rounds)

    def lb_runtime_factor(self) -> Fraction:
        """Optimal T_B per unit data M per unit bandwidth: (1/N)·(1/x*)."""
        return self.opt.inv_x_star / self.num_nodes

    def describe(self) -> str:
        return (f"{self.kind} on {self.topo.name}: N={self.num_nodes} "
                f"k={self.k} P={self.num_chunks} depth={self.depth} "
                f"rounds={len(self.rounds)} sends={self.total_sends()} "
                f"1/x*={self.opt.inv_x_star}")


# ---------------------------------------------------------------------- #
# Allgather round construction (store-and-forward over the tree pipeline)
# ---------------------------------------------------------------------- #

def _build_allgather_rounds(
        classes: Sequence[TreeClass], num_chunks: int
) -> Tuple[List[List[Send]], List[int]]:
    """Chunk-granular rounds: per round, each tree edge of class c forwards
    up to m_c in-order chunks (m_c = class multiplicity = its capacity
    share on every one of its edges)."""
    # slot offsets: classes of the same root occupy disjoint slot ranges
    offset: List[int] = []
    per_root: Dict[int, int] = {}
    for c in classes:
        offset.append(per_root.get(c.root, 0))
        per_root[c.root] = per_root.get(c.root, 0) + c.mult * num_chunks

    total = [c.mult * num_chunks for c in classes]          # chunks per class
    received = [{c.root: total[i]} for i, c in enumerate(classes)]
    sent: List[Dict[Edge, int]] = [dict() for _ in classes]

    rounds: List[List[Send]] = []
    done = False
    while not done:
        this_round: List[Send] = []
        # deliveries land after the round: reads below see pre-round state,
        # writes are deferred (cheaper than copying every class's dict)
        pending: List[Tuple[int, int, int]] = []
        for ci, c in enumerate(classes):
            got_ci, sent_ci = received[ci], sent[ci]
            mult, tot, off, root = c.mult, total[ci], offset[ci], c.root
            for e in c.edges:
                a, b = e
                s = sent_ci.get(e, 0)
                n = min(mult, got_ci.get(a, 0) - s, tot - s)
                if n <= 0:
                    continue
                this_round.extend(
                    Send(a, b, root, off + t, ci) for t in range(s, s + n))
                sent_ci[e] = s + n
                pending.append((ci, b, n))
        for ci, b, n in pending:
            received[ci][b] = received[ci].get(b, 0) + n
        if not this_round:
            # all deliveries complete?
            done = all(
                received[ci].get(v, 0) == total[ci]
                for ci, c in enumerate(classes) for v in c.verts)
            if not done:
                raise RuntimeError("pipeline stalled before completion")
        else:
            rounds.append(this_round)
            done = all(
                received[ci].get(v, 0) == total[ci]
                for ci, c in enumerate(classes) for v in c.verts)
    return rounds, offset


# ---------------------------------------------------------------------- #
# All-to-all round construction (pruned scatter over the same packed trees)
# ---------------------------------------------------------------------- #

def _build_alltoall_rounds(
        classes: Sequence[TreeClass], num_chunks: int, k: int
) -> Tuple[List[List[Send]], List[int]]:
    """Per-source scatter rounds over the all-roots §2.3 packing.

    Each spanning tree of root r carries r's traffic to *every*
    destination, but pruned: edge (a, b) forwards only the chunks whose
    destination lies in subtree(b), so the (r, w) block travels exactly
    the unique r→w tree path.  Slots fold the destination in —
    ``slot = dest_index·k·P + class_offset + t`` — which keeps `Send`,
    the serializer and the executor's ``root·S + slot`` addressing
    unchanged (S grows to N·k·P).  The diagonal (r, r) block is never
    sent; its buffer rows are simply the staged input.

    Per round each tree edge forwards up to ``mult`` chunks (its capacity
    share) in a fixed deepest-destination-first order, store-and-forward:
    a chunk crosses an edge strictly after the round that delivered it to
    the edge's tail.  Returns ``(rounds, class_slot_offset)`` with the
    same offset semantics as the allgather builder.
    """
    offset: List[int] = []
    per_root: Dict[int, int] = {}
    for c in classes:
        offset.append(per_root.get(c.root, 0))
        per_root[c.root] = per_root.get(c.root, 0) + c.mult * num_chunks
    stride = k * num_chunks                    # subslots per dest block
    nodes = sorted({v for c in classes for v in c.verts})
    pos = {v: i for i, v in enumerate(nodes)}

    # static per-class structure: per-edge destination queues (deepest
    # destination first — keeps downstream edges fed early) and the child
    # hop toward every destination below a vertex.  Queue order is a
    # single global (depth, id) key per class, so every edge consumes its
    # queue as an order-preserving subsequence of its parent's — arrivals
    # at the tail are always a prefix of the queue.
    queues: List[Dict[Edge, List[int]]] = []
    routes: List[Dict[Tuple[int, int], Edge]] = []
    for c in classes:
        children: Dict[int, List[int]] = {}
        for (a, b) in c.edges:
            children.setdefault(a, []).append(b)
        depth = {c.root: 0}
        order = [c.root]
        for v in order:
            for w in children.get(v, ()):
                depth[w] = depth[v] + 1
                order.append(w)
        sub: Dict[int, List[int]] = {}
        for v in reversed(order):              # leaves first
            s = [v]
            for w in children.get(v, ()):
                s.extend(sub[w])
            sub[v] = s
        q: Dict[Edge, List[int]] = {}
        rt: Dict[Tuple[int, int], Edge] = {}
        for (a, b) in c.edges:
            q[(a, b)] = sorted(sub[b], key=lambda w: (-depth[w], w))
            for w in sub[b]:
                rt[(a, w)] = (a, b)
        queues.append(q)
        routes.append(rt)

    mp = [c.mult * num_chunks for c in classes]   # chunks per (class, dest)
    sent = [dict.fromkeys(queues[ci], 0) for ci in range(len(classes))]
    avail: List[Dict[Edge, int]] = []
    for ci, c in enumerate(classes):
        avail.append({e: len(dests) * mp[ci] if e[0] == c.root else 0
                      for e, dests in queues[ci].items()})
    active = [list(c.edges) for c in classes]
    remaining = sum(len(dests) * mp[ci]
                    for ci in range(len(classes))
                    for dests in queues[ci].values())

    rounds: List[List[Send]] = []
    while remaining:
        this_round: List[Send] = []
        # deliveries land after the round: reads below see pre-round state
        pending: List[Tuple[Dict[Edge, int], Edge]] = []
        for ci, c in enumerate(classes):
            edges = active[ci]
            if not edges:
                continue
            q_ci, s_ci, a_ci, rt = queues[ci], sent[ci], avail[ci], routes[ci]
            mult, m, off, root = c.mult, mp[ci], offset[ci], c.root
            still: List[Edge] = []
            for e in edges:
                dests = q_ci[e]
                s = s_ci[e]
                n = min(mult, a_ci[e] - s)
                if n > 0:
                    a, b = e
                    for j in range(s, s + n):
                        w = dests[j // m]
                        this_round.append(
                            Send(a, b, root, pos[w] * stride + off + j % m,
                                 ci))
                        if w != b:
                            pending.append((a_ci, rt[(b, w)]))
                    s_ci[e] = s = s + n
                    remaining -= n
                if s < len(dests) * m:
                    still.append(e)
            active[ci] = still
        for a_ci, e in pending:
            a_ci[e] += 1
        if not this_round:
            raise RuntimeError("alltoall pipeline stalled before completion")
        rounds.append(this_round)
    return rounds, offset


# ---------------------------------------------------------------------- #
# Physical path assignment
# ---------------------------------------------------------------------- #

def _assign_paths(split: SplitResult, classes: Sequence[TreeClass]
                  ) -> Dict[Tuple[int, Edge], List[Tuple[Tuple[int, ...], int]]]:
    """Bind each class's per-edge capacity share to concrete physical paths
    (a flow decomposition of the edge-splitting routing table)."""
    pool = expand_paths(split)          # (u,t) -> [(path, cap)] totals = cap
    remaining: Dict[Edge, List[List]] = {
        e: [[list(p), c] for (p, c) in plist] for e, plist in pool.items()}
    assignment: Dict[Tuple[int, Edge], List[Tuple[Tuple[int, ...], int]]] = {}
    for ci, c in enumerate(classes):
        for e in c.edges:
            need = c.mult
            alloc: List[Tuple[Tuple[int, ...], int]] = []
            for slot in remaining.get(e, ()):  # [path, cap] mutable
                if need == 0:
                    break
                take = min(need, slot[1])
                if take > 0:
                    alloc.append((tuple(slot[0]), take))
                    slot[1] -= take
                    need -= take
            if need != 0:
                raise RuntimeError(
                    f"path pool exhausted for class {ci} edge {e} (short {need})")
            assignment[(ci, e)] = alloc
    return assignment


# ---------------------------------------------------------------------- #
# Public compilers (thin wrappers over the staged pipeline in plan.py)
# ---------------------------------------------------------------------- #

def compile_allgather(topo: DiGraph, num_chunks: int = 8,
                      fixed_k: Optional[int] = None,
                      pair_priority=None, verify: bool = False
                      ) -> PipelineSchedule:
    """End-to-end §2: bandwidth-optimal allgather pipeline schedule
    (staged: solve → split → pack → rounds)."""
    from . import plan as plan_mod
    return plan_mod.compile_plan(plan_mod.plan_for(
        "allgather", topo, num_chunks=num_chunks, fixed_k=fixed_k,
        pair_priority=pair_priority, verify=verify))


def compile_reduce_scatter(topo: DiGraph, num_chunks: int = 8,
                           fixed_k: Optional[int] = None,
                           pair_priority=None, verify: bool = False
                           ) -> PipelineSchedule:
    """Reduce-scatter = allgather compiled on G^T with all sends reversed
    (src/dst swapped, round order flipped).  In the reversed schedule every
    node forwards a chunk to its tree-parent only after all tree-children
    delivered theirs — the store-and-forward order of the forward schedule
    guarantees it."""
    from . import plan as plan_mod
    return plan_mod.compile_plan(plan_mod.plan_for(
        "reduce_scatter", topo, num_chunks=num_chunks, fixed_k=fixed_k,
        pair_priority=pair_priority, verify=verify))


@dataclasses.dataclass
class AllReduceSchedule:
    """RS + AG concatenation (paper Appendix B)."""
    rs: PipelineSchedule
    ag: PipelineSchedule

    @property
    def topo(self) -> DiGraph:
        return self.rs.topo

    @property
    def num_nodes(self) -> int:
        return self.rs.num_nodes

    def runtime_factor(self) -> Fraction:
        """2 · (M/N) · 1/x* per unit M — optimal under Theorem 19 conditions."""
        return self.rs.lb_runtime_factor() + self.ag.lb_runtime_factor()

    @property
    def claimed_runtime(self) -> Optional[Fraction]:
        if self.rs.claimed_runtime is None or self.ag.claimed_runtime is None:
            return None
        return self.rs.claimed_runtime + self.ag.claimed_runtime

    @property
    def compile_stats(self):
        """{'rs': CompileStats, 'ag': CompileStats} of the two halves
        (entries may be None for deserialized artifacts)."""
        return {"rs": self.rs.compile_stats, "ag": self.ag.compile_stats}

    def describe(self) -> str:
        return f"allreduce = [{self.rs.describe()}] + [{self.ag.describe()}]"


def compile_allreduce(topo: DiGraph, num_chunks: int = 8,
                      fixed_k: Optional[int] = None,
                      pair_priority=None, verify: bool = False
                      ) -> AllReduceSchedule:
    """Appendix B: pipelined allreduce as reduce-scatter composed with
    allgather — one `AllReduceSchedule` carrying both halves, serialized
    and cached as a single `repro.allreduce` artifact.  Optimal whenever
    Theorem 19's conditions hold (see `theorem19_rs_ag_optimal`).

    Compiled through `plan.compile_family`, so the §2.1 solve runs once
    and is shared between the two halves (exact by Eulerian transpose
    symmetry) instead of being recomputed per orientation."""
    from . import plan as plan_mod
    return plan_mod.compile_family(
        topo, kinds=("allreduce",), num_chunks=num_chunks, fixed_k=fixed_k,
        pair_priority=pair_priority, verify=verify)["allreduce"]


def broadcast_lambda(topo: DiGraph, root: int) -> int:
    """λ(root) = min_v F(root, v; G): the exact broadcast bandwidth of the
    root (paper eq. 5 specialised to one source) — an integer for integer
    capacities, so no Proposition-3 scaling is needed."""
    if root not in topo.compute:
        raise ValueError(f"broadcast root {root} is not a compute node")
    lam = None
    net = build_network(topo)          # one network, reset between sinks
    for v in sorted(topo.compute):
        if v == root:
            continue
        net.reset_flow()
        f = net.maxflow(root, v)
        lam = f if lam is None else min(lam, f)
    if not lam:
        raise ValueError("root cannot reach some compute node")
    return lam


def compile_broadcast(topo: DiGraph, root: int, num_chunks: int = 8,
                      pair_priority=None, verify: bool = False
                      ) -> PipelineSchedule:
    """Appendix A: pack λ(root) = min_v F(root, v; G) edge-disjoint out-trees
    from a single root; each tree streams 1/λ of the data as `num_chunks`
    pipelined chunks.  Switched topologies first go through the rooted
    edge-splitting variant, which preserves F(root, v) >= λ for every
    compute node v (Frank's rooted-packing condition) instead of the
    all-roots Theorem-5 oracle used by allgather."""
    from . import plan as plan_mod
    return plan_mod.compile_plan(plan_mod.plan_for(
        "broadcast", topo, num_chunks=num_chunks, root=root,
        pair_priority=pair_priority, verify=verify))


def compile_alltoall(topo: DiGraph, num_chunks: int = 8,
                     fixed_k: Optional[int] = None,
                     pair_priority=None, verify: bool = False
                     ) -> PipelineSchedule:
    """All-to-all as per-source pruned scatter (Basu/Pal/Zhao et al.,
    direct-connect all-to-all): reuse the §2.1 solve and the all-roots
    §2.2/§2.3 packing verbatim — the solve, split and pack products are
    identical to allgather's — and replace only the round construction:
    each source's k trees scatter N−1 distinct destination blocks along
    their unique tree paths instead of broadcasting one shard.  Shares
    packed products with allgather under `plan.compile_family`."""
    from . import plan as plan_mod
    return plan_mod.compile_plan(plan_mod.plan_for(
        "alltoall", topo, num_chunks=num_chunks, fixed_k=fixed_k,
        pair_priority=pair_priority, verify=verify))


def compile_reduce(topo: DiGraph, root: int, num_chunks: int = 8,
                   pair_priority=None, verify: bool = False
                   ) -> PipelineSchedule:
    """Reduce = broadcast compiled on G^T with all sends reversed (src/dst
    swapped, round order flipped) — the same duality that derives
    reduce-scatter from allgather.  In the reversed schedule every node
    forwards each chunk slot to its tree-parent only after all tree-children
    delivered theirs, so the reduction op is fused bottom-up along the tree:
    a node sends one accumulated partial per slot, never raw operands."""
    from . import plan as plan_mod
    return plan_mod.compile_plan(plan_mod.plan_for(
        "reduce", topo, num_chunks=num_chunks, root=root,
        pair_priority=pair_priority, verify=verify))
