"""§2.2 Edge splitting (Algorithm 1) — remove switch nodes losslessly.

Repeatedly replaces a unit of capacity on ``(u, w), (w, t)`` (w a switch) by
a unit on the direct logical edge ``(u, t)`` while preserving

    min_{v∈Vc} F(s, v; D_k)  >=  |Vc| * k                      (Theorem 7)

Theorem 8 gives the *maximum* capacity M splittable in one shot via 2|Vc|
maxflows, which makes Algorithm 1 strongly polynomial (capacity-independent).

Oracle engine: one incremental prober serves a whole `remove_switches`
run.  The Theorem-8 term scans share a single D_k `SourcedNetwork` (gadget
edges are pre-installed capacity-0 parallels toggled in place — two fresh
network builds per (u, w, t) pair became zero), remember the last *binding*
sink per switch and probe it first (the running minimum tightens the flow
`limit` immediately, so the remaining probes early-exit almost at once; the
final minimum is order-independent), and the degenerate-discard / rooted
binary searches descend on warm-started per-sink flows
(`min_source_flow_at_least(..., warm=True)`) instead of recomputing each
probe from a cold residual network.

We also keep the paper's `routing` table: ``routing[(u,t)][w] = M`` records
that M units of the logical edge (u,t) physically traverse switch w.  After
tree construction, `expand_paths` recovers the concrete switch paths, which
the simulator uses to re-validate optimality on the *original* graph G.

Degenerate pairs (u == t) occur when surplus switch capacity must simply be
discarded (the split would create a self-loop).  Theorem 8's formula does not
cover that case, so we fall back to a direct monotone binary search on the
Theorem-5 oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .graph import DiGraph, Edge, validate_eulerian
from .maxflow import SourcedNetwork

PairPriority = Callable[[int, int, int], object]  # (u, w, t) -> sort key


@dataclasses.dataclass
class SplitResult:
    graph: DiGraph                       # D*: compute-only logical topology
    routing: Dict[Edge, Dict[int, int]]  # (u,t) -> {switch w: capacity via w}
    original: DiGraph                    # the input (scaled) switch topology
    k: int


class EdgeSplitError(RuntimeError):
    pass


# ---------------------------------------------------------------------- #
# Theorem 8: maximum splittable capacity (shared incremental prober)
# ---------------------------------------------------------------------- #

def _dk_net(d: DiGraph, k: int,
            extra: Sequence[Tuple[int, int, int]] = ()) -> SourcedNetwork:
    """The D_k shape (super-source tied cap-k to every compute node) plus
    optional gadget edges, built once and re-probed in place."""
    return SourcedNetwork(d, {u: k for u in sorted(d.compute)}, extra=extra)


class _TheoremEightProber:
    """One D_k oracle network serving every Theorem-8 term scan *and* every
    degenerate-discard binary search of an Algorithm-1 run.

    Gadget edges (the per-term ∞ edges and per-sink probe edges) are
    capacity-0 parallels added lazily and toggled in place; `sync` mirrors
    each applied split's 3 capacity changes into the network.  The ∞
    stand-in only needs to exceed every flow limit ever probed; capacity
    never enters the system after construction (splits move or discard it),
    so one value sized from the initial graph stays valid for the whole
    run — the computed M is identical for any sufficiently large value.
    """

    def __init__(self, d: DiGraph, k: int):
        self.d = d
        self.k = k
        self.nk = d.num_compute * k
        self.net = _dk_net(d, k)
        self.inf = 2 * sum(d.cap.values()) + self.nk + 1
        self.sinks = sorted(d.compute)
        # keyed (a, b, tag): a term's base ∞ edge and a per-sink probe edge
        # over the same (a, b) stay separate parallels, as in the paper's D̂
        self._gadget: Dict[Tuple[int, int, str], int] = {}
        self._armed: List[int] = []
        self._hot3: Dict[int, int] = {}   # switch w -> last binding sink
        self._hot4: Dict[int, int] = {}
        # (src, snk, probe_head) -> flow snapshot: each eq.-(2) term's base
        # flow is warm-restarted when the term is revisited (later rounds of
        # the saturation loop, or a transplanted repair run)
        self._twarm: Dict[Tuple[int, int, int],
                          Tuple[List[int], int, List[int]]] = {}

    @classmethod
    def transplant(cls, base: "_TheoremEightProber", d: DiGraph,
                   k: int) -> "_TheoremEightProber":
        """A prober for graph `d` (typically a degraded rescale of the base
        run's input) that inherits the base run's oracle network, warm flow
        snapshots, and binding-sink history instead of starting cold.  Every
        capacity is rewritten to `d`'s value through the target-tracking
        setters, so the first warm probe of each flow drains/augments
        exactly the capacity delta between the runs — verdicts are
        unchanged (the warm engine is exact), only the work shrinks."""
        self = cls.__new__(cls)
        self.d = d
        self.k = k
        self.nk = d.num_compute * k
        self.net = base.net.clone(g=d)
        self.inf = max(base.inf, 2 * sum(d.cap.values()) + self.nk + 1)
        self.sinks = sorted(d.compute)
        self._gadget = dict(base._gadget)
        self._armed = []
        self._hot3 = dict(base._hot3)
        self._hot4 = dict(base._hot4)
        # snapshot tuples are never mutated (warm_flow replaces entries
        # wholesale), so sharing them with the base prober is safe
        self._twarm = dict(base._twarm)
        net = self.net
        for e, eid in net.eid.items():
            net.set_cap_id(eid, d.cap.get(e, 0))
        for eid in self._gadget.values():
            net.set_cap_id(eid, 0)
        for u, eid in net.src_eid.items():
            net.set_cap_id(eid, k)
        return self

    # -- gadget plumbing ------------------------------------------------ #

    def _arm(self, a: int, b: int, cap: int, tag: str = "base") -> int:
        eid = self._gadget.get((a, b, tag))
        if eid is None:
            eid = self.net.add_probe_edge(a, b)
            self._gadget[(a, b, tag)] = eid
        self.net.set_cap_id(eid, cap)
        self._armed.append(eid)
        return eid

    def _disarm(self) -> None:
        for eid in self._armed:
            self.net.set_cap_id(eid, 0)
        self._armed.clear()

    def sync(self, edges: Sequence[Edge]) -> None:
        """Mirror the graph capacities of `edges` (changed by an applied
        split) into the oracle network."""
        for e in edges:
            if e[0] != e[1]:
                self.net.set_cap(*e, self.d.cap.get(e, 0))

    @staticmethod
    def _hot_first(order: List[int], hot: Optional[int]) -> List[int]:
        if hot is not None and hot in order and order[0] != hot:
            order.remove(hot)
            order.insert(0, hot)
        return order

    # -- Theorem 8 / eq. (2) -------------------------------------------- #

    def split_cap(self, u: int, w: int, t: int,
                  expect: Optional[int] = None) -> int:
        """Theorem 8 / eq. (2): max M such that splitting (u,w),(w,t) by M
        keeps min_v F(s, v; D^ef_k) >= |Vc| k.  Requires u != t.

        Each term's minimum is taken sink-adaptively: the last binding sink
        of this switch is probed first, so `limit` collapses to the final
        minimum immediately and later probes early-exit (the minimum itself
        is order-independent).

        `expect` is a caller-guaranteed upper bound on the answer (replay
        under capacity domination passes the base run's value): the running
        minimum starts there, so every probe runs against the tightest
        possible flow limit.  Results at the clamp are exact because the
        true value cannot exceed it."""
        assert u != t, "degenerate pair handled by discard_cap"
        d = self.d
        c_uw = d.cap.get((u, w), 0)
        c_wt = d.cap.get((w, t), 0)
        bound = min(c_uw, c_wt)
        if expect is not None:
            bound = min(bound, expect)
        if bound <= 0:
            return 0
        nk = self.nk
        limit = nk + bound  # flows above this are non-binding
        best = bound

        # term 3: min_v F(u, w; D̂_(u,w),v) - |Vc|k
        #         with ∞ edges (u,s),(u,t),(v,w)
        # (∞ edge (v,w)=(u,w) would make F infinite, so v == u is skipped)
        best = self._term_min(
            src=u, snk=w, base=((u, self.net.s), (u, t)),
            order=self._hot_first([v for v in self.sinks if v != u],
                                  self._hot3.get(w)),
            probe_head=w, skip_probe=None, best=best, hot=self._hot3, w=w)
        if best <= 0:
            return 0

        # term 4: min_v F(w, t; D̂_(w,t),v) - |Vc|k
        #         with ∞ edges (w,s),(u,t),(v,t)
        # (v == t is probed with no gadget edge: plain F(w, t))
        best = self._term_min(
            src=w, snk=t, base=((w, self.net.s), (u, t)),
            order=self._hot_first(list(self.sinks), self._hot4.get(w)),
            probe_head=t, skip_probe=t, best=best, hot=self._hot4, w=w)
        return max(best, 0)

    def _term_min(self, src: int, snk: int, base, order, probe_head: int,
                  skip_probe: Optional[int], best: int,
                  hot: Dict[int, int], w: int) -> int:
        """One eq.-(2) term:  min_v F(src, snk; D̂ with (v, probe_head) ∞
        probe edge) − |Vc|k,  folded into the running `best`.

        The flow is carried *across* sinks: swapping the probe edge drains
        the outgoing probe's flow (flow-preserving decrease) and re-augments
        only the delta, instead of recomputing the nk-unit base flow per
        sink.  The probe `limit` tracks nk + best; a carried flow value at
        or above the limit means this v is non-binding (f = min(F_v, limit)
        of the cold scan), below it the augmented value is the exact F_v —
        identical results to per-sink cold maxflows, in any probe order."""
        net, nk, inf = self.net, self.nk, self.inf
        self._disarm()
        for (a, b) in base:
            self._arm(a, b, inf)
        probe = None
        value = None
        limit = nk + best
        for v in order:
            if probe is not None:
                value -= net.decrease_cap_id(probe, 0, src, snk)
                probe = None
            if v != skip_probe:
                eid = self._gadget.get((v, probe_head, "probe"))
                if eid is None:
                    eid = self.net.add_probe_edge(v, probe_head)
                    self._gadget[(v, probe_head, "probe")] = eid
                self._armed.append(eid)
                probe = eid
            if value is None:
                if probe is not None:
                    net.set_cap_id(probe, inf)
                value = net.warm_flow(self._twarm, (src, snk, probe_head),
                                      src, snk, limit)
            else:
                if probe is not None:
                    net.increase_cap_id(probe, inf)
                if value < limit:
                    value += net.net.maxflow(src, snk, limit=limit - value)
            if value < limit:            # binding: value is the exact F_v
                best = value - nk
                hot[w] = v
                if best <= 0:
                    self._disarm()
                    return best
                limit = nk + best
        self._disarm()
        return best

    # -- degenerate discard --------------------------------------------- #

    def discard_cap(self, u: int, w: int,
                    expect: Optional[int] = None) -> int:
        """Degenerate split (u,w),(w,u): capacity is simply discarded.  Max
        M keeping the Theorem-5 oracle true, by monotone binary search over
        the shared network with warm-started per-sink flows (each probe
        only moves the two rewritten capacities and re-augments).

        `expect` is a caller-guaranteed upper bound on the answer (replay
        under capacity domination): one feasibility check at it decides the
        whole search, and on failure the search resumes below it."""
        d = self.d
        c_uw = d.cap.get((u, w), 0)
        c_wu = d.cap.get((w, u), 0)
        bound = min(c_uw, c_wu)
        if expect is not None:
            bound = min(bound, expect)
        if bound <= 0:
            return 0
        self._disarm()
        net, nk, sinks = self.net, self.nk, self.sinks

        def ok(m: int) -> bool:
            net.set_cap(u, w, c_uw - m)
            net.set_cap(w, u, c_wu - m)
            return net.min_source_flow_at_least(sinks, nk, warm=True)

        try:
            if ok(bound):
                return bound
            lo_ok, hi = 0, bound
            while hi - lo_ok > 1:
                mid = (lo_ok + hi) // 2
                if ok(mid):
                    lo_ok = mid
                else:
                    hi = mid
            return lo_ok
        finally:
            net.set_cap(u, w, c_uw)
            net.set_cap(w, u, c_wu)


def max_split_capacity(d: DiGraph, k: int, u: int, w: int, t: int) -> int:
    """One-shot Theorem-8 maximum (fresh prober; Algorithm 1 keeps a shared
    prober across its whole run instead)."""
    return _TheoremEightProber(d, k).split_cap(u, w, t)


def max_discard_capacity(d: DiGraph, k: int, u: int, w: int) -> int:
    """One-shot degenerate-discard maximum (fresh prober)."""
    return _TheoremEightProber(d, k).discard_cap(u, w)


def _oracle_holds(d: DiGraph, k: int) -> bool:
    """min_v F(s, v; D_k) >= |Vc| k (Theorem 5 condition)."""
    return _dk_net(d, k).min_source_flow_at_least(sorted(d.compute),
                                                  d.num_compute * k)


# ---------------------------------------------------------------------- #
# Rooted variant: preserve a demand-weighted tree-packing oracle
# ---------------------------------------------------------------------- #

def _oracle_holds_demands(d: DiGraph, demands: Dict[int, int]) -> bool:
    """Frank's rooted-packing condition: with a super-source s tied to each
    root u by demands[u] parallel arcs, min_v F(s, v; D) >= Σ demands —
    for broadcast ({root: λ}) this is exactly min_v F(root, v) >= λ."""
    net = SourcedNetwork(d, dict(sorted(demands.items())))
    return net.min_source_flow_at_least(sorted(d.compute),
                                        sum(demands.values()))


class _RootedProber:
    """The rooted (broadcast/reduce) analogue of `_TheoremEightProber`: one
    demand-weighted `SourcedNetwork` serves every binary search of a
    `remove_switches_rooted` run, with warm-started per-sink flows."""

    def __init__(self, d: DiGraph, demands: Dict[int, int]):
        self.d = d
        self.total = sum(demands.values())
        self.net = SourcedNetwork(d, dict(sorted(demands.items())))
        self.sinks = sorted(d.compute)

    @classmethod
    def transplant(cls, base: "_RootedProber", d: DiGraph,
                   demands: Dict[int, int]) -> "_RootedProber":
        """Rooted analogue of `_TheoremEightProber.transplant`: inherit the
        base run's network and per-sink warm flows, rewrite every capacity
        to `d`'s (and the source edges to the new demands).  Requires the
        same demand keys (same root set) as the base run."""
        if set(demands) != set(base.net.src_eid):
            raise ValueError("transplant requires identical demand roots")
        self = cls.__new__(cls)
        self.d = d
        self.total = sum(demands.values())
        self.net = base.net.clone(g=d)
        self.sinks = sorted(d.compute)
        net = self.net
        for e, eid in net.eid.items():
            net.set_cap_id(eid, d.cap.get(e, 0))
        for u, eid in net.src_eid.items():
            net.set_cap_id(eid, demands[u])
        return self

    def sync(self, edges: Sequence[Edge]) -> None:
        for e in edges:
            if e[0] != e[1]:
                self.net.set_cap(*e, self.d.cap.get(e, 0))

    def split_cap(self, u: int, w: int, t: int,
                  expect: Optional[int] = None) -> int:
        """Max M such that splitting (u,w),(w,t) by M keeps the rooted
        oracle.  Every cut's egress capacity is non-increasing in M under
        the split, so feasibility is monotone and a binary search on the
        oracle is exact (the closed form of Theorem 8 only covers the
        uniform all-roots case).  Each probe rewrites the three affected
        capacities and re-augments the warm per-sink flows.

        `expect` is a caller-guaranteed upper bound on the answer (replay
        under capacity domination): one feasibility check at it usually
        decides the whole search."""
        d, net = self.d, self.net
        c_uw = d.cap.get((u, w), 0)
        c_wt = d.cap.get((w, t), 0)
        bound = min(c_uw, c_wt)
        if expect is not None:
            bound = min(bound, expect)
        if bound <= 0:
            return 0
        c_ut = d.cap.get((u, t), 0)
        total, sinks = self.total, self.sinks

        def ok(m: int) -> bool:
            net.set_cap(u, w, c_uw - m)
            net.set_cap(w, t, c_wt - m)
            if u != t:
                net.set_cap(u, t, c_ut + m)
            return net.min_source_flow_at_least(sinks, total, warm=True)

        try:
            if ok(bound):
                return bound
            lo_ok, hi = 0, bound
            while hi - lo_ok > 1:
                mid = (lo_ok + hi) // 2
                if ok(mid):
                    lo_ok = mid
                else:
                    hi = mid
            return lo_ok
        finally:
            net.set_cap(u, w, c_uw)
            net.set_cap(w, t, c_wt)
            if u != t:
                net.set_cap(u, t, c_ut)

    def discard_cap(self, t: int, w: int,
                    expect: Optional[int] = None) -> int:
        return self.split_cap(t, w, t, expect=expect)


def max_split_capacity_rooted(d: DiGraph, demands: Dict[int, int],
                              u: int, w: int, t: int) -> int:
    """One-shot rooted maximum (fresh prober; Algorithm 1 keeps a shared
    warm prober across its whole run instead)."""
    return _RootedProber(d, demands).split_cap(u, w, t)


def remove_switches_rooted(d: DiGraph, demands: Dict[int, int],
                           pair_priority: Optional[PairPriority] = None,
                           verify: bool = False,
                           prober_factory=None,
                           prober_sink=None,
                           trace: bool = False) -> SplitResult:
    """Algorithm-1 loop with the rooted (broadcast/reduce) oracle: split off
    all switches while preserving min_v F(s, v) >= Σ demands for the
    demand-weighted super-source — enough to pack `demands[u]` spanning
    out-trees at each root u afterwards (Frank).  Eulerian graphs always
    admit a complete splitting-off, so the greedy loop terminates.

    `prober_factory` overrides the prober construction (repair passes a
    `_ReplayProber` over a transplant of a retained base-run prober);
    `prober_sink` receives the live prober after the run, for retention by
    a warm store; `trace=True` wraps the default prober in a
    `_TracingProber` so the sunk prober carries its decision log."""
    validate_eulerian(d)
    k = sum(demands.values())
    factory = prober_factory or (lambda dd: _RootedProber(dd, demands))
    if trace and prober_factory is None:
        factory = (lambda dd: _TracingProber(_RootedProber(dd, demands), dd))
    return _isolate_switches(
        d, k,
        prober_factory=factory,
        pair_priority=pair_priority, verify=verify,
        oracle=lambda dd: _oracle_holds_demands(dd, demands),
        prober_sink=prober_sink)


# ---------------------------------------------------------------------- #
# Decision traces: record one Algorithm-1 run, replay it against a delta
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class SplitTrace:
    """The decision log of one Algorithm-1 run: every prober call with its
    result, plus the residual capacities at each switch boundary.

    `events` holds ``(tag, u, w, t, m)`` rows — tag ``"s"`` for
    `split_cap(u, w, t)`, ``"d"`` for `discard_cap(u, w)` (recorded with
    ``t == u``; the loop never passes ``u == t`` to `split_cap`, so the tag
    disambiguates).  `segments` holds ``(switch, first_event_index,
    residual_caps)`` per isolated switch, in loop order.
    """
    events: List[Tuple[str, int, int, int, int]] = \
        dataclasses.field(default_factory=list)
    segments: List[Tuple[int, int, Dict[Edge, int]]] = \
        dataclasses.field(default_factory=list)


class _TracingProber:
    """Transparent prober wrapper that logs the run into a `SplitTrace`.

    `repro.core.plan.split` wraps every cold prober with this so the warm
    store retains, next to the prober itself, the exact decision sequence —
    the raw material `_ReplayProber` needs to skip work during a repair.
    The overhead is one tuple append per probe and one dict copy per
    switch, invisible next to the maxflows being logged.
    """

    def __init__(self, inner, d: DiGraph):
        self.inner = inner
        self.d = d
        self.trace = SplitTrace()

    def note_switch(self, w: int) -> None:
        self.trace.segments.append(
            (w, len(self.trace.events), dict(self.d.cap)))

    def sync(self, edges: Sequence[Edge]) -> None:
        self.inner.sync(edges)

    def split_cap(self, u: int, w: int, t: int) -> int:
        m = self.inner.split_cap(u, w, t)
        self.trace.events.append(("s", u, w, t, m))
        return m

    def discard_cap(self, u: int, w: int) -> int:
        m = self.inner.discard_cap(u, w)
        self.trace.events.append(("d", u, w, u, m))
        return m


class _ReplayProber:
    """Replay a base run's `SplitTrace` against a degraded residual,
    skipping every probe the trace proves is zero.

    Soundness rests on capacity monotonicity of the oracles: each
    Theorem-8 term is ``min_v F(src, snk; D̂) − |Vc|k`` with F a maxflow of
    the residual capacities, and the rooted oracle is a feasibility
    threshold on the same flows — both non-decreasing when capacities
    grow.  So while the degraded residual is pointwise *dominated* by the
    base residual at the aligned trace position (``cap'(e) <= cap(e)``
    everywhere), any candidate the base run probed to zero is a proven
    zero for the degraded run too and is answered without touching the
    oracle.  Positive base results only bound the degraded value from
    above, so picks are always probed for real (on the transplanted warm
    network, where they re-augment little).

    Alignment: at each switch boundary the wrapper checks domination
    against the recorded residual snapshot and enters sync; within a
    segment it advances the cursor past base zero-probes (they left the
    base residual untouched) until the current candidate matches.  A pick
    whose probed value differs from the recorded one, a base *pick* the
    degraded enumeration skipped, or cursor exhaustion all break the
    segment out of sync — every later candidate of that switch is probed
    for real, which is plain cold semantics and always correct.  The next
    boundary re-checks domination and may re-enter sync.

    The wrapper records its own `SplitTrace` while replaying, so a
    repaired artifact's retained prober can seed yet another repair.
    """

    def __init__(self, inner, d: DiGraph, base_trace: SplitTrace):
        self.inner = inner
        self.d = d
        self.base = base_trace
        self.trace = SplitTrace()
        self.skipped = 0            # probes answered from the trace
        self.probed = 0             # probes that hit the oracle
        self._seg = -1
        self._cur = 0               # cursor into base.events
        self._end = 0
        self._sync = False

    def note_switch(self, w: int) -> None:
        self.trace.segments.append(
            (w, len(self.trace.events), dict(self.d.cap)))
        segs = self.base.segments
        j = self._seg + 1
        if j < len(segs) and segs[j][0] == w:
            self._seg = j
            self._cur = segs[j][1]
            self._end = (segs[j + 1][1] if j + 1 < len(segs)
                         else len(self.base.events))
            snap = segs[j][2]
            self._sync = all(c <= snap.get(e, 0)
                             for e, c in self.d.cap.items())
        else:                       # structural mismatch: never sync again
            self._seg = len(segs)
            self._sync = False

    def sync(self, edges: Sequence[Edge]) -> None:
        self.inner.sync(edges)

    def _consume(self, tag: str, u: int, w: int, t: int) -> Optional[int]:
        """Advance the cursor to this candidate's base event and return its
        recorded value, or None (desynchronised)."""
        ev = self.base.events
        while self._cur < self._end:
            btag, bu, bw, bt, bm = ev[self._cur]
            if (btag, bu, bw, bt) == (tag, u, w, t):
                self._cur += 1
                return bm
            if bm != 0:
                # a base pick our enumeration skipped: residuals diverge
                return None
            self._cur += 1          # foreign zero-probe: base residual
        return None                 # unchanged, safe to pass over

    def _answer(self, tag: str, u: int, w: int, t: int,
                probe: Callable[[Optional[int]], int]) -> int:
        if self._sync:
            bm = self._consume(tag, u, w, t)
            if bm == 0:
                self.skipped += 1
                self.trace.events.append((tag, u, w, t, 0))
                return 0
            if bm is not None:
                # domination bounds the degraded answer by the base one, so
                # the prober may clamp its search at `expect` and stay exact
                m = probe(bm)
                self.probed += 1
                self.trace.events.append((tag, u, w, t, m))
                if m != bm:
                    self._sync = False
                return m
            self._sync = False
        m = probe(None)
        self.probed += 1
        self.trace.events.append((tag, u, w, t, m))
        return m

    def split_cap(self, u: int, w: int, t: int) -> int:
        return self._answer(
            "s", u, w, t,
            lambda e: self.inner.split_cap(u, w, t, expect=e))

    def discard_cap(self, u: int, w: int) -> int:
        return self._answer(
            "d", u, w, u,
            lambda e: self.inner.discard_cap(u, w, expect=e))


# ---------------------------------------------------------------------- #
# Algorithm 1
# ---------------------------------------------------------------------- #

def remove_switches(d: DiGraph, k: int,
                    pair_priority: Optional[PairPriority] = None,
                    verify: bool = False,
                    prober_factory=None,
                    prober_sink=None,
                    trace: bool = False) -> SplitResult:
    """Algorithm 1: split off all switch nodes of `d` (capacities already
    scaled to G({U b_e})), preserving the Theorem-5 tree-packing condition.

    pair_priority(u, w, t) orders ingress candidates per egress edge — the
    paper uses this hook (§2.2 example) to e.g. prefer cross-cluster pairs.
    `prober_factory` overrides the prober construction (repair passes a
    `_ReplayProber` over a transplant of a retained base-run prober);
    `prober_sink` receives the live prober after the run, for retention by
    a warm store; `trace=True` wraps the default prober in a
    `_TracingProber` so the sunk prober carries its decision log.
    """
    validate_eulerian(d)
    factory = prober_factory or (lambda dd: _TheoremEightProber(dd, k))
    if trace and prober_factory is None:
        factory = (lambda dd: _TracingProber(_TheoremEightProber(dd, k), dd))
    return _isolate_switches(
        d, k,
        prober_factory=factory,
        pair_priority=pair_priority, verify=verify,
        oracle=lambda dd: _oracle_holds(dd, k),
        prober_sink=prober_sink)


def _isolate_switches(d: DiGraph, k: int,
                      prober_factory,
                      pair_priority: Optional[PairPriority],
                      verify: bool, oracle, prober_sink=None) -> SplitResult:
    """Shared Algorithm-1 saturation loop, parameterised by the maximum-
    splittable-capacity prober (Theorem-8 closed form for allgather,
    warm binary search for the rooted variants).  One prober — and its
    incremental oracle network — lives for the whole run; applied splits
    are mirrored into it instead of triggering rebuilds."""
    original = d.copy()
    d = d.copy()
    prober = prober_factory(d)
    routing: Dict[Edge, Dict[int, int]] = {}

    def apply_split(u: int, w: int, t: int, m: int) -> None:
        for e in ((u, w), (w, t)):
            d.cap[e] -= m
            if d.cap[e] == 0:
                del d.cap[e]
        if u != t:
            d.cap[(u, t)] = d.cap.get((u, t), 0) + m
            routing.setdefault((u, t), {})
            routing[(u, t)][w] = routing[(u, t)].get(w, 0) + m
        prober.sync(((u, w), (w, t), (u, t)))

    boundary = getattr(prober, "note_switch", None)
    for w in sorted(d.switches):
        if boundary is not None:
            boundary(w)             # trace/replay probers log the residual
        # saturate every egress edge of w in turn
        guard = 0
        while True:
            egress = sorted(t for (a, t) in d.cap if a == w)
            if not egress:
                break
            guard += 1
            if guard > 4 * (d.num_nodes ** 2 + len(d.cap) + 4):
                raise EdgeSplitError(f"no progress isolating switch {w}")
            progress = False
            for t in egress:
                if d.cap.get((w, t), 0) == 0:
                    continue
                ins = [a for (a, b) in d.cap if b == w and a != t]
                if pair_priority is not None:
                    ins.sort(key=lambda u: pair_priority(u, w, t))
                else:
                    ins.sort()
                for u in ins:
                    if d.cap.get((w, t), 0) == 0:
                        break
                    m = prober.split_cap(u, w, t)
                    if m > 0:
                        apply_split(u, w, t, m)
                        progress = True
                # degenerate leftover: (t,w),(w,t) must be discarded
                if d.cap.get((w, t), 0) > 0 and d.cap.get((t, w), 0) > 0:
                    m = prober.discard_cap(t, w)
                    if m > 0:
                        apply_split(t, w, t, m)
                        progress = True
            if not progress:
                raise EdgeSplitError(
                    f"stuck isolating switch {w}: residual "
                    f"{{e: c for e, c in d.cap.items() if w in e}}")
        # w should now be isolated
        residual = [(e, c) for e, c in d.cap.items() if w in e]
        if residual:
            raise EdgeSplitError(f"switch {w} not isolated: {residual}")

    star = DiGraph(d.num_nodes, d.compute, d.cap, original.name + "*")
    if verify:
        validate_eulerian(star)
        if not oracle(star):
            raise EdgeSplitError("edge splitting broke the packing oracle")
    if prober_sink is not None:
        prober_sink(prober)
    return SplitResult(graph=star, routing=routing, original=original, k=k)


# ---------------------------------------------------------------------- #
# Path recovery: logical (u,t) capacity -> physical switch paths in G
# ---------------------------------------------------------------------- #

Path = Tuple[int, ...]


def expand_paths(res: SplitResult) -> Dict[Edge, List[Tuple[Path, int]]]:
    """Decompose every logical edge of D* into physical paths of G with
    integer capacities (a valid flow decomposition; conservation is exact)."""
    phys_pool: Dict[Edge, int] = dict(res.original.cap)
    via_pool: Dict[Edge, Dict[int, int]] = {
        e: dict(ws) for e, ws in res.routing.items()}

    def expand(a: int, b: int, amount: int) -> List[Tuple[Path, int]]:
        out: List[Tuple[Path, int]] = []
        take = min(amount, phys_pool.get((a, b), 0))
        if take:
            phys_pool[(a, b)] -= take
            out.append(((a, b), take))
            amount -= take
        for w in sorted(via_pool.get((a, b), {})):
            if amount == 0:
                break
            avail = via_pool[(a, b)][w]
            m = min(amount, avail)
            if m == 0:
                continue
            via_pool[(a, b)][w] -= m
            left = expand(a, w, m)
            right = expand(w, b, m)
            out.extend(_join(left, right))
            amount -= m
        if amount != 0:
            raise EdgeSplitError(
                f"path expansion under-supplied for ({a},{b}): short {amount}")
        return out

    result: Dict[Edge, List[Tuple[Path, int]]] = {}
    for (u, t), c in sorted(res.graph.cap.items()):
        result[(u, t)] = expand(u, t, c)
    return result


def _join(left: List[Tuple[Path, int]],
          right: List[Tuple[Path, int]]) -> List[Tuple[Path, int]]:
    """Splice a->..->w path pieces with w->..->b pieces, capacity-matched."""
    out: List[Tuple[Path, int]] = []
    li = ri = 0
    lpath, lcap = (left[0] if left else ((), 0))
    rpath, rcap = (right[0] if right else ((), 0))
    while li < len(left) and ri < len(right):
        m = min(lcap, rcap)
        out.append((lpath + rpath[1:], m))
        lcap -= m
        rcap -= m
        if lcap == 0:
            li += 1
            if li < len(left):
                lpath, lcap = left[li]
        if rcap == 0:
            ri += 1
            if ri < len(right):
                rpath, rcap = right[ri]
    return out


def trivial_split(d: DiGraph, k: int) -> SplitResult:
    """For already direct-connect topologies §2.2 is skippable."""
    if d.switches:
        raise ValueError("graph has switches; use remove_switches")
    return SplitResult(graph=d.copy(), routing={}, original=d.copy(), k=k)
