"""Round-accurate simulator + correctness verifier for pipeline schedules.

Two roles:

1. **Verifier** — replays the schedule chunk by chunk and proves semantic
   correctness: allgather delivers every root's every chunk to every node
   (store-and-forward discipline enforced); reduce-scatter accumulates each
   rank's contribution exactly once into the destination root's shard.

2. **Bandwidth simulator** — computes the exact runtime of the *pipelined*
   schedule on the **physical** topology G (chunks traverse the concrete
   switch paths assigned at compile time).  Round time = max over physical
   links of (bytes this round) / (link bandwidth); total = Σ rounds.  As the
   chunk count P grows this converges to the paper's optimum (M/N)·(1/x*) —
   the §1.3 minimality-or-saturation argument made executable.

Everything is exact rational arithmetic (fractions.Fraction): "equals the
lower bound" is checked with ==, not allclose.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from .graph import DiGraph, Edge
from .schedule import AllReduceSchedule, PipelineSchedule, Send


class ScheduleError(AssertionError):
    pass


@dataclasses.dataclass
class SimReport:
    kind: str
    num_rounds: int
    sim_time: Fraction          # runtime on physical links (M = data_size)
    lb_time: Fraction           # paper lower bound for this collective
    link_bytes: Dict[Edge, Fraction]  # physical per-link totals
    num_chunks: int

    @property
    def ratio(self) -> float:
        return float(self.sim_time / self.lb_time) if self.lb_time else 1.0

    def describe(self) -> str:
        return (f"{self.kind}: rounds={self.num_rounds} P={self.num_chunks} "
                f"T={float(self.sim_time):.6g} LB={float(self.lb_time):.6g} "
                f"ratio={self.ratio:.4f}")


# ---------------------------------------------------------------------- #
# physical link loads per round
# ---------------------------------------------------------------------- #

def _unit_paths(sched: PipelineSchedule
                ) -> Dict[Tuple[int, Edge], List[Tuple[int, ...]]]:
    """Flatten each (class, edge) path allocation to per-capacity-unit paths
    (len == class multiplicity)."""
    out: Dict[Tuple[int, Edge], List[Tuple[int, ...]]] = {}
    for key, alloc in sched.path_assignment.items():
        units: List[Tuple[int, ...]] = []
        for path, cap in alloc:
            units.extend([path] * cap)
        out[key] = units
    return out


def _round_times(sched: PipelineSchedule, data_size: Fraction,
                 reverse_paths: bool) -> Tuple[Fraction, Dict[Edge, Fraction]]:
    """Total pipelined runtime + physical per-link byte totals."""
    n = sched.num_nodes
    # rooted collectives move one buffer of M bytes; alltoall moves one
    # send buffer of M bytes per node (N blocks of M/N, slots_per_shard
    # already counts all N·k·P of them); the gathered/scattered family
    # moves N shards of M/N bytes each
    chunk = Fraction(data_size, sched.slots_per_shard) \
        if sched.kind in ("broadcast", "reduce", "alltoall") else \
        Fraction(data_size, n * sched.slots_per_shard)
    # reduce-scatter schedules carry paths in transpose-graph orientation;
    # after flipping the hops below they are in original-graph orientation,
    # so the bandwidth table is always sched.topo.cap as-is.
    unit_paths = _unit_paths(sched)
    bw = {e: Fraction(c) for e, c in sched.topo.cap.items()}
    total_time = Fraction(0)
    link_bytes: Dict[Edge, Fraction] = {}
    for rnd in sched.rounds:
        # group sends per (cls, logical edge) to index into capacity units
        per_key: Dict[Tuple[int, Edge], int] = {}
        load: Dict[Edge, int] = {}
        for s in sorted(rnd, key=lambda s: (s.cls, s.slot)):
            logical_e = (s.src, s.dst)
            key = (s.cls, logical_e if not reverse_paths
                   else (s.dst, s.src))
            idx = per_key.get(key, 0)
            per_key[key] = idx + 1
            path = unit_paths[key][idx]
            hops = list(zip(path[:-1], path[1:]))
            if reverse_paths:
                hops = [(b, a) for (a, b) in hops]
            for hop in hops:
                load[hop] = load.get(hop, 0) + 1
        if not load:
            continue
        rt = max(Fraction(cnt, 1) * chunk / bw[hop]
                 for hop, cnt in load.items())
        total_time += rt
        for hop, cnt in load.items():
            link_bytes[hop] = link_bytes.get(hop, Fraction(0)) + cnt * chunk
    return total_time, link_bytes


# ---------------------------------------------------------------------- #
# allgather
# ---------------------------------------------------------------------- #

def verify_allgather_delivery(sched: PipelineSchedule) -> None:
    """Replay: every node must end with every (root, slot) chunk; chunks may
    only be forwarded in a strictly later round than received."""
    nodes = sched.nodes
    slots = sched.slots_per_shard
    have: Dict[int, Set[Tuple[int, int]]] = {
        v: {(v, s) for s in range(slots)} for v in nodes}
    for rnd_i, rnd in enumerate(sched.rounds):
        incoming: List[Tuple[int, Tuple[int, int]]] = []
        for s in rnd:
            chunk = (s.root, s.slot)
            if chunk not in have[s.src]:
                raise ScheduleError(
                    f"round {rnd_i}: {s.src}->{s.dst} forwards {chunk} "
                    f"not yet held (store-and-forward violation)")
            incoming.append((s.dst, chunk))
        for dst, chunk in incoming:
            have[dst].add(chunk)
    want = {(r, s) for r in nodes for s in range(slots)}
    for v in nodes:
        if have[v] != want:
            missing = sorted(want - have[v])[:5]
            raise ScheduleError(f"node {v} missing chunks, e.g. {missing}")


def simulate_allgather(sched: PipelineSchedule,
                       data_size: Fraction = Fraction(1),
                       verify: bool = True) -> SimReport:
    """Exact pipelined allgather runtime on the physical topology, after
    (optionally) replaying every chunk through the delivery verifier; the
    report's lb_time is the eq (1) bound (M/N)·(1/x*)."""
    if verify:
        verify_allgather_delivery(sched)
    t, link_bytes = _round_times(sched, data_size, reverse_paths=False)
    lb = data_size * sched.lb_runtime_factor()
    return SimReport("allgather", len(sched.rounds), t, lb, link_bytes,
                     sched.num_chunks)


# ---------------------------------------------------------------------- #
# broadcast
# ---------------------------------------------------------------------- #

def verify_broadcast_delivery(sched: PipelineSchedule) -> None:
    """Replay: every node must end with all λ·P chunks of the root's buffer;
    a chunk may only be forwarded in a strictly later round than received."""
    root = sched.classes[0].root
    slots = sched.slots_per_shard
    have: Dict[int, Set[Tuple[int, int]]] = {
        v: set() for v in sched.nodes}
    have[root] = {(root, s) for s in range(slots)}
    for rnd_i, rnd in enumerate(sched.rounds):
        inc = []
        for s in rnd:
            if (s.root, s.slot) not in have[s.src]:
                raise ScheduleError(
                    f"round {rnd_i}: broadcast forwards unheld chunk")
            inc.append((s.dst, (s.root, s.slot)))
        for dst, ch in inc:
            have[dst].add(ch)
    for v in sched.nodes:
        if len(have[v]) != slots:
            raise ScheduleError(f"broadcast: node {v} incomplete")


def simulate_broadcast(sched: PipelineSchedule,
                       data_size: Fraction = Fraction(1),
                       verify: bool = True) -> SimReport:
    """Exact pipelined broadcast runtime; lb_time is the eq (5) per-root
    bound M/λ(root) (sched.k = λ)."""
    if verify:
        verify_broadcast_delivery(sched)
    t, link_bytes = _round_times(sched, data_size, reverse_paths=False)
    lb = data_size * Fraction(1, sched.k)  # eq (5): M / min-cut, k = λ
    return SimReport("broadcast", len(sched.rounds), t, lb, link_bytes,
                     sched.num_chunks)


# ---------------------------------------------------------------------- #
# reduce (edge-reversed broadcast with op fusion)
# ---------------------------------------------------------------------- #

def verify_reduce(sched: PipelineSchedule) -> None:
    """Replay with contribution counters: every node starts holding its own
    partial for each of the λ·P chunk slots; partials flow up the reversed
    trees (accumulating at every hop — op fusion); at the end the root must
    hold, for every slot, exactly one contribution from every rank."""
    root = sched.classes[0].root
    nodes = sched.nodes
    slots = sched.slots_per_shard
    state: Dict[int, Dict[int, Counter]] = {
        v: {s: Counter({v: 1}) for s in range(slots)} for v in nodes}
    for rnd_i, rnd in enumerate(sched.rounds):
        moves: List[Tuple[int, int, Counter]] = []
        for s in rnd:
            payload = state[s.src].get(s.slot)
            if payload is None:
                raise ScheduleError(
                    f"round {rnd_i}: {s.src} re-sends already-sent slot "
                    f"{s.slot} (fusion violation: a node forwards each "
                    f"accumulated partial exactly once)")
            moves.append((s.dst, s.slot, payload))
            del state[s.src][s.slot]          # the partial leaves the sender
        for dst, slot, payload in moves:
            acc = state[dst].get(slot)
            if acc is None:
                state[dst][slot] = Counter(payload)
            else:
                acc.update(payload)
    full = Counter({v: 1 for v in nodes})
    for s in range(slots):
        got = state[root].get(s)
        if got != full:
            raise ScheduleError(
                f"reduce root {root} slot {s}: contributions "
                f"{dict(got or {})} != one from every rank")


def simulate_reduce(sched: PipelineSchedule,
                    data_size: Fraction = Fraction(1),
                    verify: bool = True) -> SimReport:
    """Exact pipelined reduce runtime (contribution-counter replay when
    verify=True); lb_time is the eq (5) dual M / min cut into the root."""
    if verify:
        verify_reduce(sched)
    t, link_bytes = _round_times(sched, data_size, reverse_paths=True)
    lb = data_size * Fraction(1, sched.k)  # eq (5) dual: M / min cut into root
    return SimReport("reduce", len(sched.rounds), t, lb, link_bytes,
                     sched.num_chunks)


# ---------------------------------------------------------------------- #
# reduce-scatter
# ---------------------------------------------------------------------- #

def verify_reduce_scatter(sched: PipelineSchedule) -> None:
    """Replay with contribution counters: at the end, root r must hold, for
    each of its slots, exactly one contribution from every rank."""
    nodes = sched.nodes
    slots = sched.slots_per_shard
    # state[v][(root, slot)] = Counter{rank: times contributed}
    state: Dict[int, Dict[Tuple[int, int], Counter]] = {
        v: {(r, s): Counter({v: 1}) for r in nodes for s in range(slots)}
        for v in nodes}
    for rnd_i, rnd in enumerate(sched.rounds):
        moves: List[Tuple[int, Tuple[int, int], Counter]] = []
        for s in rnd:
            chunk = (s.root, s.slot)
            payload = state[s.src].get(chunk)
            if payload is None:
                raise ScheduleError(
                    f"round {rnd_i}: {s.src} re-sends already-sent {chunk}")
            moves.append((s.dst, chunk, payload))
            del state[s.src][chunk]          # partials leave the sender
        for dst, chunk, payload in moves:
            acc = state[dst].get(chunk)
            if acc is None:
                state[dst][chunk] = Counter(payload)
            else:
                acc.update(payload)
    full = Counter({v: 1 for v in nodes})
    for r in nodes:
        for s in range(slots):
            got = state[r].get((r, s))
            if got != full:
                raise ScheduleError(
                    f"root {r} slot {s}: contributions {dict(got or {})} "
                    f"!= one from every rank")


def simulate_reduce_scatter(sched: PipelineSchedule,
                            data_size: Fraction = Fraction(1),
                            verify: bool = True) -> SimReport:
    """Exact pipelined reduce-scatter runtime (physical paths traversed in
    reverse of the transpose-graph orientation they were assigned in);
    lb_time equals allgather's eq (1) bound by Appendix-B duality."""
    if verify:
        verify_reduce_scatter(sched)
    t, link_bytes = _round_times(sched, data_size, reverse_paths=True)
    lb = data_size * sched.lb_runtime_factor()
    return SimReport("reduce_scatter", len(sched.rounds), t, lb, link_bytes,
                     sched.num_chunks)


# ---------------------------------------------------------------------- #
# alltoall (per-source pruned scatter)
# ---------------------------------------------------------------------- #

def verify_alltoall_delivery(sched: PipelineSchedule) -> None:
    """Replay: chunk (root=r, slot=dest·kP+sub) must end at its destination,
    store-and-forward enforced; the diagonal (r → r) block must never be
    scheduled (its buffer rows are the staged input)."""
    nodes = sched.nodes
    stride = sched.k * sched.num_chunks          # subslots per dest block
    pos = {v: i for i, v in enumerate(nodes)}
    have: Dict[int, Set[Tuple[int, int]]] = {
        v: {(v, s) for s in range(sched.slots_per_shard)} for v in nodes}
    for rnd_i, rnd in enumerate(sched.rounds):
        incoming: List[Tuple[int, Tuple[int, int]]] = []
        for s in rnd:
            chunk = (s.root, s.slot)
            if chunk not in have[s.src]:
                raise ScheduleError(
                    f"round {rnd_i}: {s.src}->{s.dst} forwards {chunk} "
                    f"not yet held (store-and-forward violation)")
            if s.slot // stride == pos[s.root]:
                raise ScheduleError(
                    f"round {rnd_i}: diagonal block of root {s.root} "
                    f"scheduled ({s.src}->{s.dst} slot {s.slot}) — the "
                    f"self block never travels")
            incoming.append((s.dst, chunk))
        for dst, chunk in incoming:
            have[dst].add(chunk)
    for w in nodes:
        want = {(r, pos[w] * stride + t)
                for r in nodes if r != w for t in range(stride)}
        missing = want - have[w]
        if missing:
            raise ScheduleError(
                f"alltoall: node {w} missing chunks, e.g. "
                f"{sorted(missing)[:5]}")


def simulate_alltoall(sched: PipelineSchedule,
                      data_size: Fraction = Fraction(1),
                      verify: bool = True) -> SimReport:
    """Exact pipelined alltoall runtime on the physical topology;
    lb_time is the certified-cut bound `alltoall_lb` — for any compute
    cut S, the |S|·(N−|S|) cross blocks of M/N bytes must cross B+(S)."""
    if verify:
        verify_alltoall_delivery(sched)
    from .lower_bounds import alltoall_lb
    t, link_bytes = _round_times(sched, data_size, reverse_paths=False)
    lb = data_size * alltoall_lb(sched.topo)
    return SimReport("alltoall", len(sched.rounds), t, lb, link_bytes,
                     sched.num_chunks)


# ---------------------------------------------------------------------- #
# allreduce
# ---------------------------------------------------------------------- #

def simulate_allreduce(ar: AllReduceSchedule,
                       data_size: Fraction = Fraction(1),
                       verify: bool = True) -> SimReport:
    """Exact runtime of the composed RS+AG allreduce (both halves verified
    independently); lb_time is the RS+AG optimum 2·(M/N)·(1/x*), which is
    the true allreduce optimum under the Theorem-19 conditions."""
    rs = simulate_reduce_scatter(ar.rs, data_size, verify)
    ag = simulate_allgather(ar.ag, data_size, verify)
    link_bytes = dict(rs.link_bytes)
    for e, b in ag.link_bytes.items():
        link_bytes[e] = link_bytes.get(e, Fraction(0)) + b
    return SimReport("allreduce", rs.num_rounds + ag.num_rounds,
                     rs.sim_time + ag.sim_time,
                     data_size * ar.runtime_factor(),
                     link_bytes, ar.rs.num_chunks)


# ---------------------------------------------------------------------- #
# cut-traffic minimality (paper §1.3 requirement (b))
# ---------------------------------------------------------------------- #

def cut_traffic(report: SimReport, cut: Set[int]) -> Fraction:
    """Total bytes that crossed out of `cut` (physical links)."""
    return sum((b for (u, v), b in report.link_bytes.items()
                if u in cut and v not in cut), Fraction(0))
