"""Dinic's max-flow — the oracle engine behind every theorem in the paper.

Dinic's algorithm is strongly polynomial (O(V^2 E) independent of capacity
values), which is what makes the whole schedule generator strongly
polynomial.  We add an optional `limit` argument: every caller in this
codebase only ever needs to know whether the flow reaches some threshold
(Theorems 1, 5, 8, 12), so we stop augmenting as soon as the threshold is
met — a large constant-factor win.

Two substrates back the same `FlowNetwork` API:

* a pure-Python Dinic over adjacency linked lists — the reference-shaped
  slow path, used for small networks (where interpreter overhead beats
  array set-up costs), and whenever capacities leave the int64 range
  (capacities are Python ints, arbitrary precision: the optimality search
  scales capacities by binary-search denominators);
* a compact array substrate: capacities live in a numpy int64 array and
  probes on large networks are solved by `scipy.sparse.csgraph.maximum_flow`
  (a compiled Dinic) over a cached CSR view of the network.  The CSR
  structure (coalesced coordinates, group index, residual write-back
  permutations) is built once per network shape and only capacity *data*
  moves per probe.  An extra bottleneck node `b` with a single `b -> s`
  edge of capacity `limit` realises the exact early-exit semantics
  (`min(F, limit)`) without giving up the compiled inner loops.

Both substrates return exact flow values, so every oracle verdict — and
therefore every emitted schedule byte — is independent of which one ran.
The differential suite (`repro.core.reference`,
`tests/test_reference_differential.py`) pins this equivalence.

Reuse: every binary search in the compiler probes the *same* network shape
with different capacities, and every Theorem-5-style oracle sweeps the same
network over all sinks.  `FlowNetwork.set_edge_cap` + `reset_flow` make one
network serve a whole search, and `SourcedNetwork` packages the recurring
"graph + super-source + rewritable capacities" pattern — one allocation per
search instead of O(|Vc| · log C) fresh builds.

Incremental engine (warm starts): `increase_edge_cap` / `decrease_edge_cap`
rewrite a capacity while keeping the current flow *feasible* — an increase
leaves the flow untouched (later probes only augment the delta), a decrease
drains the excess along residual paths (reroute first, then cancel back to
the source/sink) instead of resetting the whole network.  On top of that,
`SourcedNetwork.min_source_flow_at_least` keeps a per-sink flow snapshot
(`warm=True`) so the monotone binary searches of §2.2 re-augment small
capacity deltas instead of recomputing each sink's flow from zero, and it
adaptively reorders sinks (last-failing sink first) so infeasible probes
fail after one maxflow instead of |Vc|.  Neither changes any oracle
verdict: maxflow values are exact, and the sweep is a pure conjunction.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .graph import DiGraph, Edge

try:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow as _scipy_maxflow
    HAVE_SCIPY = True
except Exception:  # pragma: no cover — scipy is part of the baked image
    HAVE_SCIPY = False

INF = float("inf")

#: networks with fewer residual-edge entries than this stay on the Python
#: substrate: one scipy probe costs ~0.5ms of fixed wrapper/validation
#: work, which swamps a Dinic run on a tiny network.  Tuned on the zoo
#: (fattree[8p4l2h] pack probes sit just above it, small fixture probes
#: well below).  Tests monkeypatch this to 0 to force the array substrate
#: onto small fixtures.
FAST_MIN_ENTRIES = 384

#: total capacity at or above this bails to the Python substrate: scipy's
#: maximum_flow silently casts capacities to int32, so every entry *and*
#: the flow value must stay below 2^31.  Guarding the capacity sum covers
#: both (each entry and the achievable flow are bounded by the total).
_FAST_CAP_LIMIT = (1 << 31) - 1


class OracleCounters:
    """Per-process maxflow instrumentation: `probes` counts `maxflow`
    invocations (including warm-start drains/reroutes), `augments` counts
    augmenting paths pushed by the Python substrate (the scipy substrate
    does not expose its augmentation count; large-network probes therefore
    contribute probes but no augments).  The staged compiler snapshots the
    global `COUNTERS` around each stage and records the deltas in its stage
    meta (they surface in BENCH rows as ``oracle_probes`` /
    ``oracle_augments``)."""

    __slots__ = ("probes", "augments")

    def __init__(self) -> None:
        self.probes = 0
        self.augments = 0

    def snapshot(self) -> Tuple[int, int]:
        return (self.probes, self.augments)

    def delta(self, snap: Tuple[int, int]) -> Dict[str, int]:
        return {"probes": self.probes - snap[0],
                "augments": self.augments - snap[1]}


COUNTERS = OracleCounters()


def _store(arr: np.ndarray, idx: int, val: int) -> np.ndarray:
    """Scalar store into a capacity array, promoting to an object-dtype
    array (arbitrary-precision Python ints) when `val` leaves int64."""
    try:
        arr[idx] = val
        return arr
    except OverflowError:
        arr = arr.astype(object)
        arr[idx] = val
        return arr


def _int_array(vals: Iterable[int]) -> np.ndarray:
    """int64 array of `vals`, or object dtype when a value doesn't fit."""
    vals = list(vals)
    try:
        return np.array(vals, dtype=np.int64)
    except OverflowError:
        return np.array(vals, dtype=object)


def _cap_block(caps: Sequence[int]) -> np.ndarray:
    """Interleave `caps` with their zero reverse capacities, as int64 when
    the values fit and object dtype otherwise."""
    try:
        block = np.zeros(2 * len(caps), dtype=np.int64)
        block[0::2] = caps
        return block
    except OverflowError:
        block = np.zeros(2 * len(caps), dtype=object)
        block[0::2] = caps
        return block


def _concat_caps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.dtype == object or b.dtype == object:
        return np.concatenate([a.astype(object), b.astype(object)])
    return np.concatenate([a, b])


class _CsrSolver:
    """Cached CSR structure for one `FlowNetwork` shape, solved by scipy's
    compiled Dinic.

    Entries 0..m-1 mirror the network's residual-edge entries (entry i is
    the directed coordinate ``to[i^1] -> to[i]``); entries m..m+2n-1 are
    the bottleneck gadget: a virtual node ``b = n`` with a coordinate pair
    ``b <-> u`` for every node u.  Per probe only the data vector changes:
    real entries carry the current residual capacities and the single
    ``b -> s`` entry carries the probe's `limit` (the whole flow must cross
    it, so the solve returns exactly ``min(F(s, t), limit)`` — the same
    early-exit contract as the Python substrate).

    Parallel entries of one coordinate are coalesced for the solve and the
    resulting net coordinate flow is distributed back to the entries
    greedily in edge-id order (a segmented prefix-sum), yielding a valid
    residual state with the exact flow value.  Which parallel entry carries
    the flow is not observable: every caller consumes flow *values* (and
    the canonical min-cut side, which is distribution-independent)."""

    __slots__ = ("m", "n", "order", "gid_sorted", "starts", "partner",
                 "indices", "indptr", "checked")

    def __init__(self, net: "FlowNetwork"):
        m, n = len(net.to), net.n
        self.m, self.n = m, n
        t = np.asarray(net.to, dtype=np.int64)
        rows = np.empty(m + 2 * n, dtype=np.int64)
        cols = np.empty(m + 2 * n, dtype=np.int64)
        rows[0:m:2] = t[1::2]
        rows[1:m:2] = t[0::2]
        cols[:m] = t
        ar = np.arange(n, dtype=np.int64)
        rows[m:m + n] = n
        cols[m:m + n] = ar
        rows[m + n:] = ar
        cols[m + n:] = n
        partner = np.empty(m + 2 * n, dtype=np.int64)
        partner[:m] = np.arange(m, dtype=np.int64) ^ 1
        partner[m:m + n] = ar + m + n
        partner[m + n:] = ar + m
        order = np.lexsort((cols, rows))
        r_s, c_s = rows[order], cols[order]
        newgrp = np.empty(len(order), dtype=bool)
        newgrp[0] = True
        newgrp[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
        self.order = order
        self.gid_sorted = np.cumsum(newgrp) - 1
        self.starts = np.flatnonzero(newgrp)
        self.partner = partner
        urows = r_s[self.starts]
        counts = np.bincount(urows, minlength=n + 1)
        self.indptr = np.concatenate(
            ([0], np.cumsum(counts))).astype(np.int32)
        self.indices = c_s[self.starts].astype(np.int32)
        self.checked = False

    def solve(self, net: "FlowNetwork", s: int, t: int,
              limit: Optional[int]) -> Optional[int]:
        """min(F(s, t), limit) on `net`'s current residual capacities, or
        None when the capacities are too large for scipy's int32 core (the
        caller falls back to the exact Python substrate)."""
        m, n = self.m, self.n
        cap = net.cap
        # max-check first: it bounds the int64 sum below any wrap, and a
        # single over-limit entry already forces the fallback
        if len(cap) and int(cap.max()) >= _FAST_CAP_LIMIT:
            return None
        total = int(cap.sum())
        if total >= _FAST_CAP_LIMIT:
            return None
        ec = np.zeros(m + 2 * n, dtype=np.int64)
        ec[:m] = cap
        lim = total + 1 if limit is None else min(int(limit), total + 1)
        if lim <= 0:
            return 0
        ec[m + s] = lim
        ec_s = ec[self.order]
        # int32 data: scipy's core is int32 (the _FAST_CAP_LIMIT guard
        # above makes the cast exact) and handing it pre-cast data skips a
        # full-matrix astype copy inside the wrapper.
        agg = np.add.reduceat(ec_s, self.starts).astype(np.int32)
        mat = csr_matrix((agg, self.indices, self.indptr),
                         shape=(n + 1, n + 1))
        res = _scipy_maxflow(mat, n, t)
        flow = res.flow
        if not self.checked:
            # scipy preserves the input structure when every coordinate's
            # reverse is present (ours always is: entries come in pairs)
            if (len(flow.data) != len(agg)
                    or not np.array_equal(flow.indices, self.indices)):
                raise RuntimeError("scipy flow structure mismatch")
            self.checked = True
        fpos = np.maximum(flow.data, 0).astype(np.int64)
        if fpos.any():
            cs = np.cumsum(ec_s)
            base = np.concatenate(
                ([0], cs[self.starts[1:] - 1]))[self.gid_sorted]
            take_s = np.clip(fpos[self.gid_sorted] - (cs - ec_s - base),
                             0, ec_s)
            take = np.empty_like(take_s)
            take[self.order] = take_s
            new_ec = ec - take + take[self.partner]
            cap[:] = new_ec[:m]
        return int(res.flow_value)


class FlowNetwork:
    """Residual flow network with integer capacities.

    Capacities live in a numpy array (`int64`, promoted to object dtype if
    a capacity ever leaves the int64 range).  The adjacency linked lists
    only serve the Python substrate and `min_cut_side`; they are built
    lazily (`_ensure_adj`) so bulk builders that stay on the array
    substrate never pay for them."""

    __slots__ = ("n", "to", "cap", "head", "nxt", "_adj_m", "_fast")

    def __init__(self, n: int):
        self.n = n
        # edge arrays (paired: edge i and i^1 are residual partners)
        self.to: List[int] = []
        self.cap: np.ndarray = np.zeros(0, dtype=np.int64)
        # adjacency as linked lists: head[u] -> edge index, nxt[i] -> next
        # edge; valid for the first `_adj_m` entries of `to`
        self.head: List[int] = [-1] * n
        self.nxt: List[int] = []
        self._adj_m = 0
        self._fast: Optional[_CsrSolver] = None

    def add_node(self) -> int:
        self.head.append(-1)
        self.n += 1
        return self.n - 1

    def add_edge(self, u: int, v: int, cap: int) -> int:
        """Add directed edge u->v with given capacity; returns edge id."""
        i = len(self.to)
        self.to.append(v)
        self.to.append(u)
        if self._adj_m == i:      # adjacency current: extend incrementally
            self.nxt.append(self.head[u]); self.head[u] = i
            self.nxt.append(self.head[v]); self.head[v] = i + 1
            self._adj_m = i + 2
        self.cap = _concat_caps(self.cap, _cap_block([cap]))
        return i

    def add_edges(self, edges: Iterable[Tuple[int, int, int]]) -> None:
        """Bulk `add_edge` for the hot network builders — same layout, one
        array concatenation instead of one append per edge.  Edge ids are
        assigned in order (first edge gets id len(to) before the call,
        then +2 per edge)."""
        edges = list(edges)
        if not edges:
            return
        to = self.to
        for u, v, _ in edges:
            to.append(v)
            to.append(u)
        self.cap = _concat_caps(self.cap, _cap_block([c for _, _, c in edges]))

    def _ensure_adj(self) -> None:
        """(Re)build the adjacency linked lists from `to`.  Insertion order
        matches per-edge construction exactly, so the Python substrate
        traverses identically however the edges were added."""
        to = self.to
        if self._adj_m == len(to):
            return
        head = [-1] * self.n
        nxt = [0] * len(to)
        for i in range(len(to)):
            u = to[i ^ 1]
            nxt[i] = head[u]
            head[u] = i
        self.head, self.nxt, self._adj_m = head, nxt, len(to)

    def edge_flow(self, edge_id: int) -> int:
        """Flow currently pushed through edge `edge_id` (reverse residual)."""
        return int(self.cap[edge_id ^ 1])

    def clone(self) -> "FlowNetwork":
        """Independent copy (arrays duplicated) — the transplant primitive:
        a repair run copies a retained oracle network and rewrites its
        capacities instead of rebuilding the layout."""
        dup = FlowNetwork(0)
        dup.n = self.n
        dup.to = list(self.to)
        dup.cap = self.cap.copy()
        dup.head = list(self.head)
        dup.nxt = list(self.nxt)
        dup._adj_m = self._adj_m
        dup._fast = self._fast    # structure is shape-keyed and immutable
        return dup

    def set_edge_cap(self, edge_id: int, cap: int) -> None:
        """Rewrite edge `edge_id`'s capacity in place (clearing any flow on
        it) — the probe primitive that lets one network serve a whole
        binary search instead of being rebuilt per probe."""
        self.cap = _store(self.cap, edge_id, cap)
        self.cap[edge_id ^ 1] = 0

    def reset_flow(self) -> None:
        cap = self.cap
        cap[0::2] += cap[1::2]
        cap[1::2] = 0

    # -- flow-preserving capacity updates (the warm-start primitives) --- #

    def increase_edge_cap(self, edge_id: int, new_cap: int) -> None:
        """Raise edge `edge_id`'s capacity to `new_cap` without touching the
        flow currently on it: the flow stays feasible and a later `maxflow`
        call only augments the delta."""
        flow = int(self.cap[edge_id ^ 1])
        if new_cap < flow:
            raise ValueError(f"increase_edge_cap to {new_cap} below current "
                             f"flow {flow} on edge {edge_id}")
        self.cap = _store(self.cap, edge_id, new_cap - flow)

    def decrease_edge_cap(self, edge_id: int, new_cap: int,
                          s: int, t: int) -> int:
        """Lower edge `edge_id`'s capacity to `new_cap`, draining any excess
        flow along residual paths instead of resetting the network.

        Excess is first *rerouted* (an equal amount of u->v flow found in
        the residual graph, preserving the s->t flow value; this also
        cancels any cycle-borne flow through the edge) and what cannot be
        rerouted is *cancelled* back along the paths that carried it
        (u⇝s and t⇝v residual pushes, which always exist by flow
        decomposition).  Returns the s->t flow value lost, so a caller
        tracking the current flow value can subtract it."""
        flow = int(self.cap[edge_id ^ 1])
        if flow <= new_cap:
            self.cap = _store(self.cap, edge_id, new_cap - flow)
            return 0
        excess = flow - new_cap
        self.cap[edge_id] = 0
        self.cap = _store(self.cap, edge_id ^ 1, new_cap)
        u, v = self.to[edge_id ^ 1], self.to[edge_id]
        short = excess - self.maxflow(u, v, limit=excess)
        if short:
            if u != s:
                got = self.maxflow(u, s, limit=short)
                if got != short:  # pragma: no cover — invariant violation
                    raise RuntimeError(
                        f"drain failed: cancelled {got}/{short} at node {u}")
            if v != t:
                got = self.maxflow(t, v, limit=short)
                if got != short:  # pragma: no cover — invariant violation
                    raise RuntimeError(
                        f"drain failed: restored {got}/{short} at node {v}")
        return short

    # ------------------------------------------------------------------ #
    def maxflow(self, s: int, t: int, limit: Optional[int] = None) -> int:
        """Max flow s->t, early-exiting once `limit` is reached (the
        returned value is exactly ``min(F, limit)`` on both substrates)."""
        if s == t:
            raise ValueError("source == sink")
        COUNTERS.probes += 1
        if (HAVE_SCIPY and len(self.to) >= FAST_MIN_ENTRIES
                and self.cap.dtype != object):
            fast = self._fast
            if fast is None or fast.m != len(self.to) or fast.n != self.n:
                fast = self._fast = _CsrSolver(self)
            value = fast.solve(self, s, t, limit)
            if value is not None:
                return value
        return self._maxflow_py(s, t, limit)

    def _maxflow_py(self, s: int, t: int, limit: Optional[int]) -> int:
        """The pure-Python Dinic substrate (reference-shaped; also the
        arbitrary-precision and small-network path).  Runs on a plain-list
        copy of the capacities — interpreter loops over lists beat numpy
        scalar indexing — and writes the residual state back."""
        self._ensure_adj()
        flow = 0
        cap = self.cap.tolist()
        to, nxt, head = self.to, self.nxt, self.head
        while limit is None or flow < limit:
            # BFS level graph, pruned at the sink's level (nodes further
            # out can never lie on a shortest augmenting path)
            level = [-1] * self.n
            level[s] = 0
            queue = [s]
            qi = 0
            tlevel = self.n
            while qi < len(queue):
                u = queue[qi]; qi += 1
                if level[u] >= tlevel:
                    continue
                i = head[u]
                while i != -1:
                    v = to[i]
                    if cap[i] > 0 and level[v] < 0:
                        level[v] = level[u] + 1
                        if v == t:
                            tlevel = level[v]
                        queue.append(v)
                    i = nxt[i]
            if level[t] < 0:
                break
            # iterative DFS blocking flow with current-arc optimisation
            it = list(head)
            while True:
                # find augmenting path in level graph
                path: List[int] = []  # edge ids
                u = s
                found = False
                while True:
                    if u == t:
                        found = True
                        break
                    i = it[u]
                    advanced = False
                    while i != -1:
                        v = to[i]
                        if cap[i] > 0 and level[v] == level[u] + 1:
                            path.append(i)
                            u = v
                            advanced = True
                            break
                        i = nxt[i]
                        it[u] = i
                    if not advanced:
                        if not path:
                            break
                        # retreat: dead-end, remove node from level graph
                        level[u] = -1
                        last = path.pop()
                        u = to[last ^ 1]
                        it[u] = nxt[last] if it[u] == last else it[u]
                if not found:
                    break
                COUNTERS.augments += 1
                aug = min(cap[i] for i in path)
                if limit is not None:
                    aug = min(aug, limit - flow)
                for i in path:
                    cap[i] -= aug
                    cap[i ^ 1] += aug
                flow += aug
                if limit is not None and flow >= limit:
                    break
            if limit is not None and flow >= limit:
                break
        self.cap[:] = cap
        return flow

    def min_cut_side(self, s: int) -> List[int]:
        """After maxflow, the source side of a min cut (residual-reachable).
        For a *maximum* flow this set is canonical (the unique minimal
        source side), independent of which substrate found the flow."""
        self._ensure_adj()
        seen = [False] * self.n
        seen[s] = True
        stack = [s]
        while stack:
            u = stack.pop()
            i = self.head[u]
            while i != -1:
                v = self.to[i]
                if self.cap[i] > 0 and not seen[v]:
                    seen[v] = True
                    stack.append(v)
                i = self.nxt[i]
        return [u for u in range(self.n) if seen[u]]


def warm_restore(net: FlowNetwork, cur_tgt: np.ndarray,
                 state: Tuple[np.ndarray, int, np.ndarray],
                 src: int, snk: int, limit: int) -> int:
    """Restore a flow snapshot taken for (src, snk), apply the capacity
    deltas accumulated since (flow-preserving increase/decrease against the
    target-capacity records), and re-augment up to `limit`.

    `state` is `(cap snapshot, flow value, target snapshot)`; `cur_tgt` is
    the *current* per-edge target capacities (index = edge id >> 1).  The
    snapshot must be a valid conserving src->snk flow; the result is an
    exact maxflow value capped at `limit` — it may exceed `limit` when the
    restored flow already did, which callers treat identically (every user
    only compares against, or clamps at, the limit).  This is the delta
    engine behind the per-sink `warm=True` sweeps, the keyed `warm_flow`
    store, and the §2.3 gadget warm probes."""
    caps, value, tgt = state
    cap = net.cap
    m0 = len(tgt)
    cap[:len(caps)] = caps
    # edges added since the snapshot carried no flow: install fresh
    if len(cur_tgt) > m0:
        cap[2 * m0::2] = cur_tgt[m0:]
        cap[2 * m0 + 1::2] = 0
    decreases: List[Tuple[int, int]] = []
    for j in np.flatnonzero(cur_tgt[:m0] != tgt).tolist():
        new = int(cur_tgt[j])
        if new > tgt[j]:     # increases first: more reroute room
            net.increase_edge_cap(2 * j, new)
        else:
            decreases.append((2 * j, new))
    for eid, new in decreases:
        value -= net.decrease_edge_cap(eid, new, src, snk)
    if value < limit:
        value += net.maxflow(src, snk, limit=limit - value)
    return value


# ---------------------------------------------------------------------- #
# Reusable oracle network
# ---------------------------------------------------------------------- #

class SourcedNetwork:
    """A `FlowNetwork` over a `DiGraph` plus a super-source, built **once**
    per search and re-probed in place.

    Every graph edge's id is recorded so callers can rewrite capacities
    between probes (`set_cap` / `rescale_graph_caps` / `floor_graph_caps`)
    and the flow is cleared between sinks with `reset_flow` — replacing the
    O(|Vc| · log C) fresh `FlowNetwork` builds the binary-search oracles
    used to pay for.  `extra` edges (the Theorem-8 ∞ gadget edges) are
    installed at construction; per-sink gadget edges are added with
    `add_probe_edge` at capacity 0 and toggled with `set_cap_id` — a
    zero-capacity edge never carries flow, so inactive gadget edges are
    invisible to the oracle.

    The network tracks a *target capacity* per edge (`_tgt`), which is what
    makes warm starts possible: `min_source_flow_at_least(..., warm=True)`
    snapshots each sink's flow state after its probe and, on the next probe
    of the same sink, restores the snapshot and applies only the capacity
    deltas (flow-preserving `increase_edge_cap` / `decrease_edge_cap`)
    before re-augmenting — the §2.2 binary searches touch 2-3 edges per
    probe, so re-augmenting the delta replaces a full recompute.  The sweep
    also remembers the last failing sink (move-to-front), so infeasible
    probes usually fail on the first maxflow.
    """

    __slots__ = ("g", "net", "s", "eid", "src_eid", "_tgt", "_order",
                 "_warm", "last_failing")

    def __init__(self, g: DiGraph,
                 source_caps: Optional[Mapping[int, int]] = None,
                 extra: Sequence[Tuple[int, int, int]] = ()):
        self.g = g
        self.net = FlowNetwork(g.num_nodes + 1)
        self.s = g.num_nodes
        self.eid = {e: 2 * i for i, e in enumerate(g.cap)}
        self.net.add_edges((u, v, c) for (u, v), c in g.cap.items())
        self.src_eid: Dict[int, int] = {}
        for u, m in sorted((source_caps or {}).items()):
            self.src_eid[u] = self.net.add_edge(self.s, u, m)
        for (a, b, c) in extra:
            self.net.add_edge(a, b, c)
        self._tgt: np.ndarray = self.net.cap[0::2].copy()
        self._order: Optional[List[int]] = None    # adaptive sink order
        # sink -> (cap snapshot, flow value, target snapshot)
        self._warm: Dict[int, Tuple[np.ndarray, int, np.ndarray]] = {}
        self.last_failing: Optional[int] = None    # sink of last failed sweep

    def clone(self, g: Optional[DiGraph] = None) -> "SourcedNetwork":
        """Independent copy for transplanting a retained oracle onto a
        repaired compile.  Passing `g` rebinds the graph the capacity
        rewrites read from (`rescale_graph_caps` / `floor_graph_caps` use
        `self.g.cap.get(e, 0)` over the recorded edge ids, so a clone bound
        to a degraded graph probes the degraded capacities — edges the new
        graph lacks become capacity 0, which is invisible to the oracle)."""
        dup = object.__new__(SourcedNetwork)
        dup.g = self.g if g is None else g
        dup.net = self.net.clone()
        dup.s = self.s
        dup.eid = dict(self.eid)
        dup.src_eid = dict(self.src_eid)
        dup._tgt = self._tgt.copy()
        dup._order = None if self._order is None else list(self._order)
        # snapshot tuples are never mutated in place (warm probes replace
        # entries wholesale), so sharing them with the source is safe
        dup._warm = dict(self._warm)
        dup.last_failing = self.last_failing
        return dup

    def ensure_edge(self, u: int, v: int) -> int:
        """Edge id of (u, v), adding a capacity-0 edge if absent (probes of
        edge-splitting moves may create logical edges the graph lacks)."""
        e = (u, v)
        if e not in self.eid:
            self.eid[e] = self.net.add_edge(u, v, 0)
            self._tgt = np.append(self._tgt, 0)
        return self.eid[e]

    def add_probe_edge(self, u: int, v: int) -> int:
        """An initially-inactive (capacity 0) gadget edge — always parallel
        to (never merged with) any graph edge (u, v), toggled per probe
        with `set_cap_id`."""
        eid = self.net.add_edge(u, v, 0)
        self._tgt = np.append(self._tgt, 0)
        return eid

    # -- capacity rewrites between probes ------------------------------- #

    def set_cap_id(self, edge_id: int, cap: int) -> None:
        """Rewrite one edge's capacity by id, keeping the target-capacity
        record coherent (all capacity writes must go through here or
        `set_cap`, or warm starts would diff against a stale target)."""
        self.net.set_edge_cap(edge_id, cap)
        self._tgt = _store(self._tgt, edge_id >> 1, cap)

    def set_cap(self, u: int, v: int, cap: int) -> None:
        self.set_cap_id(self.ensure_edge(u, v), cap)

    def increase_cap_id(self, edge_id: int, cap: int) -> None:
        """Flow-preserving capacity increase by id (target kept coherent)."""
        self.net.increase_edge_cap(edge_id, cap)
        self._tgt = _store(self._tgt, edge_id >> 1, cap)

    def decrease_cap_id(self, edge_id: int, cap: int,
                        source: int, sink: int) -> int:
        """Flow-preserving capacity decrease by id: drains excess flow along
        residual paths of the current source->sink flow; returns the flow
        value lost."""
        lost = self.net.decrease_edge_cap(edge_id, cap, source, sink)
        self._tgt = _store(self._tgt, edge_id >> 1, cap)
        return lost

    def rescale_graph_caps(self, scale: int) -> None:
        """caps := b_e * scale for every graph edge (Theorem-1 probes)."""
        cap = self.g.cap
        for e, i in self.eid.items():
            self.set_cap_id(i, cap.get(e, 0) * scale)

    def floor_graph_caps(self, factor: Fraction) -> None:
        """caps := ⌊factor * b_e⌋ for every graph edge (§2.4 probes)."""
        cap = self.g.cap
        for e, i in self.eid.items():
            self.set_cap_id(i, int(factor * cap.get(e, 0)))

    def set_source_caps(self, cap: int) -> None:
        for i in self.src_eid.values():
            self.set_cap_id(i, cap)

    # -- oracle sweeps --------------------------------------------------- #

    def _ordered(self, sinks: Sequence[int]) -> List[int]:
        """`sinks` reordered by the adaptive history: previously-failing
        sinks first (move-to-front), new sinks appended in given order."""
        if self._order is None:
            self._order = list(sinks)
            return self._order
        ss = set(sinks)
        order = [v for v in self._order if v in ss]
        seen = set(order)
        order += [v for v in sinks if v not in seen]
        self._order = order
        return order

    def min_source_flow_at_least(self, sinks: Iterable[int], threshold: int,
                                 warm: bool = False) -> bool:
        """min_{v ∈ sinks} F(s, v) >= threshold, early-exiting per sink and
        on first failure (the Theorem-1/5 oracle shape).

        The sink order adapts across calls (last-failing sink first); the
        verdict is order-independent (a pure conjunction of exact per-sink
        oracles).  With `warm=True` each sink keeps a flow snapshot reused
        by its next probe — only valid while capacity changes between
        probes go through the `set_cap*` family."""
        net, s = self.net, self.s
        order = self._ordered(list(sinks))
        for idx, v in enumerate(order):
            if warm:
                f = self._warm_probe(v, threshold)
            else:
                net.reset_flow()
                f = net.maxflow(s, v, limit=threshold)
            if f < threshold:
                if idx:      # move the failing sink to the front
                    order.remove(v)
                    order.insert(0, v)
                self.last_failing = v
                return False
        self.last_failing = None
        return True

    def _warm_value(self, state: Tuple[np.ndarray, int, np.ndarray],
                    src: int, snk: int, limit: int) -> int:
        return warm_restore(self.net, self._tgt, state, src, snk, limit)

    def _warm_probe(self, v: int, threshold: int) -> int:
        """F(s, v) >= threshold probe warm-started from v's last flow."""
        net, s = self.net, self.s
        state = self._warm.get(v)
        if state is None:
            net.reset_flow()
            value = net.maxflow(s, v, limit=threshold)
        else:
            value = self._warm_value(state, s, v, threshold)
        self._warm[v] = (net.cap.copy(), value, self._tgt.copy())
        return value

    def warm_flow(self, store: Dict, key, src: int, snk: int, limit: int,
                  maxsize: int = 512) -> int:
        """Maxflow src->snk warm-started from `store[key]` (a snapshot a
        previous call with the same key left behind); falls back to a cold
        reset+maxflow when the key is unseen.  The resulting state is
        snapshotted back under `key` (LRU-capped at `maxsize` entries).
        Verdict-exact: the value equals `flow(src, snk, limit)` whenever
        both are < limit, and both are >= limit otherwise."""
        state = store.pop(key, None)
        if state is None:
            self.net.reset_flow()
            value = self.net.maxflow(src, snk, limit=limit)
        else:
            value = self._warm_value(state, src, snk, limit)
        store[key] = (self.net.cap.copy(), value, self._tgt.copy())
        while len(store) > maxsize:
            store.pop(next(iter(store)))
        return value

    def flow(self, a: int, b: int, limit: Optional[int] = None) -> int:
        """One maxflow a->b from a clean (reset) state."""
        self.net.reset_flow()
        return self.net.maxflow(a, b, limit=limit)


# ---------------------------------------------------------------------- #
# Flow-network builders used by the paper's constructions
# ---------------------------------------------------------------------- #

def build_network(g: DiGraph, extra_nodes: int = 0) -> FlowNetwork:
    """FlowNetwork over g's nodes (+extra), with g's edges installed."""
    net = FlowNetwork(g.num_nodes + extra_nodes)
    for (u, v), c in g.cap.items():
        net.add_edge(u, v, c)
    return net


def build_Dk(g: DiGraph, k: int, scale: int = 1) -> Tuple[FlowNetwork, int]:
    """The paper's ``D_k`` network: add source s with cap-k edges to every
    compute node.  Capacities (including k) are multiplied by `scale`
    (used by the rational binary search).  Returns (net, source_id)."""
    net = FlowNetwork(g.num_nodes + 1)
    s = g.num_nodes
    for (u, v), c in g.cap.items():
        net.add_edge(u, v, c * scale)
    for u in sorted(g.compute):
        net.add_edge(s, u, k)  # caller pre-scales k if needed
    return net, s


def min_flow_from_source(g: DiGraph, k_scaled: int, cap_scale: int,
                         threshold: int) -> bool:
    """Test  min_{v∈Vc} F(s, v; G_x)  >=  threshold  (Theorem 1 oracle).

    The rational source capacity x = k_scaled / cap_scale is realised by
    scaling the topology capacities by `cap_scale` and the source edges by
    ... nothing (the caller passes k_scaled already in scaled units).
    """
    for v in sorted(g.compute):
        net, s = build_Dk(g, k_scaled, scale=cap_scale)
        if net.maxflow(s, v, limit=threshold) < threshold:
            return False
    return True
