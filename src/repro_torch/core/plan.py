"""Staged schedule-compiler pipeline over the `CollectivePlan` IR.

The `compile_*` entry points in `repro.core.schedule` used to be monoliths
that re-derived shared intermediate state per collective.  They are now
thin wrappers over an explicit five-stage pipeline:

    stage 1  solve   §2.1 optimality / Appendix-A broadcast λ / §2.4 fixed-k
    stage 2  split   §2.2 switch removal (all-roots or rooted oracle)
    stage 3  pack    §2.3 arborescence / rooted-tree packing
    stage 4  rounds  §1.3 pipelined round construction + path assignment
    stage 5  lower   ppermute program lowering (repro.comms.compile_program)

Each of stages 1-4 is a pure function Plan → Plan (the input plan is never
mutated; products accumulate in a new plan), with wall time and size stats
recorded per stage in `CompileStats`.  The stats ride on the emitted
`PipelineSchedule`, into the schedule cache's stats sidecar, the sweep's
`BENCH_schedules.json` rows and the launch drivers' logs.

Dual kinds (`reduce_scatter`, `reduce`) compile forward on the transpose
graph and are emitted with every send reversed and the round order flipped
— exactly the Appendix-B duality the monoliths implemented.

`compile_family` amortizes shared stages across kinds.  The §2.1 solve is
computed once per topology and shared across the two orientations: for an
Eulerian graph every cut S has B+(S) = B-(S) (sum the per-node balance
over S), so eq. (1)'s `1/x*` — and with it Proposition 3's (U, k) — is
transpose-invariant.  Allreduce therefore solves once instead of twice,
and reuses the packed products of its allgather / reduce-scatter siblings
when those kinds are requested together.
"""
from __future__ import annotations

import dataclasses
import time
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .arborescence import (TreeClass, max_tree_depth, pack_arborescences,
                           pack_rooted_trees, verify_rooted_packing)
from .edge_split import (PairPriority, SplitResult, remove_switches,
                         remove_switches_rooted, trivial_split)
from .fixed_k import solve_fixed_k
from .graph import DiGraph, Edge, validate_eulerian
from .maxflow import COUNTERS
from .optimality import Optimality, solve_optimality
from .schedule import (AllReduceSchedule, PipelineSchedule, Send,
                       _assign_paths, _build_allgather_rounds,
                       _build_alltoall_rounds, broadcast_lambda)

#: kinds a single `CollectivePlan` can carry (allreduce is a composite of
#: two plans — see `compile_family`).
PLAN_KINDS = ("allgather", "reduce_scatter", "broadcast", "reduce",
              "alltoall")
FAMILY_KINDS = PLAN_KINDS + ("allreduce",)
STAGES = ("solve", "split", "pack", "rounds", "lower")

_DUAL = frozenset(("reduce_scatter", "reduce"))     # compile forward on G^T
_ROOTED = frozenset(("broadcast", "reduce"))        # single-root λ family
#: same-orientation siblings whose solve/split/pack products are identical
#: (stages 1-3 never look at the kind beyond rooted-ness/orientation, so an
#: alltoall packing IS the allgather packing — only the rounds differ)
_FORWARD_SHARE = {"allgather": "alltoall", "alltoall": "allgather"}
#: transpose-dual donors for opt sharing (see `adopt_solution`)
_OPT_DONORS = {"allgather": ("reduce_scatter",),
               "alltoall": ("reduce_scatter",),
               "reduce_scatter": ("allgather", "alltoall")}


class PlanError(ValueError):
    pass


# ---------------------------------------------------------------------- #
# per-stage instrumentation
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class StageStat:
    """One pipeline stage's wall time plus small size/result stats.

    Stages that drive the maxflow oracle engine (solve/split/pack) also
    record ``probes`` (maxflow invocations, including warm-start drains)
    and ``augments`` (augmenting paths pushed) in `meta` — the counters
    perf work watches to see oracle reuse paying off."""
    stage: str
    wall_time_s: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"stage": self.stage, "wall_time_s": self.wall_time_s,
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StageStat":
        return cls(stage=d["stage"], wall_time_s=d["wall_time_s"],
                   meta=dict(d.get("meta", {})))


@dataclasses.dataclass
class CompileStats:
    """Ordered per-stage record of one collective's compilation."""
    kind: str
    stages: List[StageStat] = dataclasses.field(default_factory=list)

    def with_stage(self, stage: str, wall_time_s: float,
                   **meta: Any) -> "CompileStats":
        """A new CompileStats with `stage` recorded (replacing any earlier
        record of the same stage, so re-lowering stays idempotent)."""
        kept = [s for s in self.stages if s.stage != stage]
        return CompileStats(self.kind,
                            kept + [StageStat(stage, wall_time_s, dict(meta))])

    def copy(self) -> "CompileStats":
        return CompileStats(self.kind, [
            StageStat(s.stage, s.wall_time_s, dict(s.meta))
            for s in self.stages])

    @property
    def total_time_s(self) -> float:
        return sum(s.wall_time_s for s in self.stages)

    def stage_seconds(self) -> Dict[str, float]:
        """{stage: wall seconds} in pipeline order."""
        return {s.stage: s.wall_time_s for s in self.stages}

    def describe(self) -> str:
        parts = " ".join(f"{s.stage}={s.wall_time_s * 1e3:.2f}ms"
                         for s in self.stages)
        return f"{self.kind}: {parts} total={self.total_time_s * 1e3:.2f}ms"

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "stages": [s.to_dict() for s in self.stages]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CompileStats":
        return cls(kind=d["kind"],
                   stages=[StageStat.from_dict(s) for s in d["stages"]])


# ---------------------------------------------------------------------- #
# the IR
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """Immutable state threaded through the staged compiler.

    `work` is the forward-orientation graph the stages operate on: the
    topology itself for forward kinds, its transpose for the dual kinds
    (whose schedules are emitted send-reversed).  Stage products start as
    None and are filled in by `solve` → `split` → `pack` → `rounds`;
    `emit` assembles the final `PipelineSchedule`.
    """
    kind: str
    topo: DiGraph                        # original user-facing topology
    work: DiGraph                        # forward-orientation graph
    num_chunks: int
    root: Optional[int] = None           # rooted kinds only
    fixed_k: Optional[int] = None        # §2.4 (non-rooted kinds only)
    pair_priority: Optional[PairPriority] = None
    verify: bool = False
    # stage products
    opt: Optional[Optimality] = None
    scaled: Optional[DiGraph] = None     # graph the splitter consumes
    split: Optional[SplitResult] = None
    classes: Optional[List[TreeClass]] = None
    rounds: Optional[List[List[Send]]] = None
    class_slot_offset: Optional[List[int]] = None
    path_assignment: Optional[
        Dict[Tuple[int, Edge], List[Tuple[Tuple[int, ...], int]]]] = None
    stats: CompileStats = dataclasses.field(
        default_factory=lambda: CompileStats(kind="?"))

    @property
    def is_dual(self) -> bool:
        return self.kind in _DUAL

    @property
    def is_rooted(self) -> bool:
        return self.kind in _ROOTED

    def describe(self) -> str:
        done = [s for s, p in (("solve", self.opt), ("split", self.split),
                               ("pack", self.classes), ("rounds", self.rounds))
                if p is not None]
        return (f"CollectivePlan[{self.kind}] on {self.topo.name} "
                f"P={self.num_chunks} stages_done={done}")


def plan_for(kind: str, topo: DiGraph, num_chunks: int = 8,
             root: Optional[int] = None, fixed_k: Optional[int] = None,
             pair_priority: Optional[PairPriority] = None,
             verify: bool = False) -> CollectivePlan:
    """A fresh, un-run plan for one collective on `topo`."""
    if kind not in PLAN_KINDS:
        raise PlanError(f"unknown plan kind {kind!r} (one of {PLAN_KINDS})")
    if kind in _ROOTED:
        if root is None:
            raise PlanError(f"{kind} plans need an explicit root")
        if fixed_k is not None:
            raise PlanError(f"{kind} has no fixed-k variant (k = λ(root))")
    work = topo.transpose() if kind in _DUAL else topo
    return CollectivePlan(kind=kind, topo=topo, work=work,
                          num_chunks=num_chunks, root=root, fixed_k=fixed_k,
                          pair_priority=pair_priority, verify=verify,
                          stats=CompileStats(kind=kind))


def _require(plan: CollectivePlan, stage: str, need: str,
             have_not: str) -> None:
    if getattr(plan, have_not) is not None:
        raise PlanError(f"stage {stage!r} already ran for this plan")
    if need and getattr(plan, need) is None:
        raise PlanError(f"stage {stage!r} needs stage product {need!r} — "
                        f"run the earlier stages first ({plan.describe()})")


# ---------------------------------------------------------------------- #
# stages 1-4 (pure Plan -> Plan)
# ---------------------------------------------------------------------- #

def solve(plan: CollectivePlan) -> CollectivePlan:
    """Stage 1: the exact bandwidth-optimality result.

    Non-rooted kinds run the §2.1 binary search (or the §2.4 fixed-k
    search) on the forward graph and scale it to integer capacities;
    rooted kinds compute λ(root) = min_v F(root, v) (Appendix A eq. 5)."""
    _require(plan, "solve", "", "opt")
    t0 = time.perf_counter()
    c0 = COUNTERS.snapshot()
    w = plan.work
    meta: Dict[str, Any] = {"nodes": w.num_nodes, "edges": len(w.cap)}
    if plan.is_rooted:
        lam = broadcast_lambda(w, plan.root)
        opt = Optimality(inv_x_star=Fraction(len(w.compute), lam),
                         U=Fraction(1), k=lam)
        scaled = w
    elif plan.fixed_k is None:
        from .optimality import _oracle_net
        from .repair import WARM
        net = _oracle_net(w)
        opt = solve_optimality(w, net=net)
        WARM.offer_solve(w, net)    # retained for later delta-recompiles
        scaled = w.scaled(opt.U)
    else:
        res = solve_fixed_k(w, plan.fixed_k)
        opt = Optimality(inv_x_star=res.runtime_factor, U=res.U_star,
                         k=plan.fixed_k)
        scaled = w.floor_scaled(res.U_star)
        meta["fixed_k"] = plan.fixed_k
    wall = time.perf_counter() - t0
    return dataclasses.replace(
        plan, opt=opt, scaled=scaled,
        stats=plan.stats.with_stage("solve", wall, k=opt.k, U=str(opt.U),
                                    inv_x_star=str(opt.inv_x_star), **meta,
                                    **COUNTERS.delta(c0)))


def adopt_solution(plan: CollectivePlan, opt: Optimality) -> CollectivePlan:
    """Stage 1 by sharing: install an `Optimality` already solved for the
    *other orientation* of the same topology.

    Exact for Eulerian graphs: B+(S) = B-(S) for every cut S, so eq. (1)
    and Proposition 3's (U, k) are transpose-invariant.  Only valid for
    the non-rooted kinds with the automatic k (λ and the §2.4 floor are
    not transpose-symmetric in general)."""
    _require(plan, "solve", "", "opt")
    if plan.is_rooted or plan.fixed_k is not None:
        raise PlanError("solution sharing only applies to the automatic-k "
                        "allgather family")
    t0 = time.perf_counter()
    validate_eulerian(plan.work)    # the symmetry argument needs this
    scaled = plan.work.scaled(opt.U)
    wall = time.perf_counter() - t0
    return dataclasses.replace(
        plan, opt=opt, scaled=scaled,
        stats=plan.stats.with_stage("solve", wall, k=opt.k, U=str(opt.U),
                                    inv_x_star=str(opt.inv_x_star),
                                    shared="transpose"))


def split(plan: CollectivePlan, prober_factory=None) -> CollectivePlan:
    """Stage 2: §2.2 switch removal on the solved, scaled graph — the
    rooted oracle for broadcast/reduce, Theorem 8 for the rest; a trivial
    split when the topology is already direct-connect.

    `prober_factory` (graph -> prober) substitutes the Theorem-8 / rooted
    oracle — `repro.core.repair` passes transplanted warm probers through
    it.  Either way the finished prober is retained in the warm store for
    later delta-recompiles of the same scaled graph."""
    _require(plan, "split", "opt", "split")
    from .repair import WARM
    t0 = time.perf_counter()
    c0 = COUNTERS.snapshot()
    g = plan.scaled
    switched = g.switches and any(w in e for e in g.cap for w in g.switches)
    if plan.is_rooted:
        if switched:
            sink = (lambda p: WARM.offer_split(
                g, "rooted", (plan.root, plan.opt.k), p))
            res = remove_switches_rooted(g, {plan.root: plan.opt.k},
                                         pair_priority=plan.pair_priority,
                                         verify=plan.verify,
                                         prober_factory=prober_factory,
                                         prober_sink=sink,
                                         trace=prober_factory is None)
        else:
            res = trivial_split(g, plan.opt.k)
    elif switched:
        sink = lambda p: WARM.offer_split(g, "tree", plan.opt.k, p)
        res = remove_switches(g, plan.opt.k,
                              pair_priority=plan.pair_priority,
                              verify=plan.verify,
                              prober_factory=prober_factory,
                              prober_sink=sink,
                              trace=prober_factory is None)
    else:
        res = trivial_split(g, plan.opt.k)
    wall = time.perf_counter() - t0
    return dataclasses.replace(
        plan, split=res,
        stats=plan.stats.with_stage(
            "split", wall, switches=len(g.switches),
            logical_edges=len(res.graph.cap),
            routed_edges=len(res.routing), **COUNTERS.delta(c0)))


def pack(plan: CollectivePlan) -> CollectivePlan:
    """Stage 3: §2.3 spanning-tree packing on the compute-only graph —
    k trees per root (allgather family) or λ trees at the single root."""
    _require(plan, "pack", "split", "classes")
    t0 = time.perf_counter()
    c0 = COUNTERS.snapshot()
    if plan.is_rooted:
        demands = {plan.root: plan.opt.k}
        classes = pack_rooted_trees(plan.split.graph, demands)
        if plan.verify:
            verify_rooted_packing(plan.split.graph, demands, classes)
    else:
        classes = pack_arborescences(plan.split.graph, plan.opt.k)
    wall = time.perf_counter() - t0
    return dataclasses.replace(
        plan, classes=classes,
        stats=plan.stats.with_stage("pack", wall, classes=len(classes),
                                    depth=max_tree_depth(classes),
                                    **COUNTERS.delta(c0)))


def rounds(plan: CollectivePlan) -> CollectivePlan:
    """Stage 4: §1.3 chunk-granular store-and-forward rounds plus the
    physical path assignment binding tree edges to switch paths of G."""
    _require(plan, "rounds", "classes", "rounds")
    t0 = time.perf_counter()
    if plan.kind == "alltoall":
        rnds, offsets = _build_alltoall_rounds(plan.classes, plan.num_chunks,
                                               plan.opt.k)
    else:
        rnds, offsets = _build_allgather_rounds(plan.classes, plan.num_chunks)
    paths = _assign_paths(plan.split, plan.classes)
    wall = time.perf_counter() - t0
    return dataclasses.replace(
        plan, rounds=rnds, class_slot_offset=offsets, path_assignment=paths,
        stats=plan.stats.with_stage("rounds", wall, rounds=len(rnds),
                                    sends=sum(len(r) for r in rnds)))


def emit(plan: CollectivePlan) -> PipelineSchedule:
    """Assemble the deployable artifact from a fully-run plan.  Dual kinds
    get every send reversed and the round order flipped (Appendix B); the
    plan's stats ride along as an independent copy (artifacts emitted from
    shared plan products must not share mutable stats)."""
    if plan.rounds is None:
        raise PlanError(f"emit needs all four stages run ({plan.describe()})")
    if plan.is_dual:
        out_rounds = [
            [Send(src=s.dst, dst=s.src, root=s.root, slot=s.slot, cls=s.cls)
             for s in rnd]
            for rnd in reversed(plan.rounds)]
        dstar = plan.split.graph.transpose()
    else:
        out_rounds = plan.rounds
        dstar = plan.split.graph
    return PipelineSchedule(
        kind=plan.kind, topo=plan.topo, dstar=dstar, opt=plan.opt,
        classes=list(plan.classes), split=plan.split,
        num_chunks=plan.num_chunks, rounds=out_rounds,
        class_slot_offset=list(plan.class_slot_offset),
        path_assignment=plan.path_assignment,
        compile_stats=plan.stats.copy())


def compile_plan(plan: CollectivePlan) -> PipelineSchedule:
    """Run stages 1-4 and emit the artifact."""
    return emit(rounds(pack(split(solve(plan)))))


def lower(sched: PipelineSchedule):
    """Stage 5: lower the schedule to a static `lax.ppermute` program
    (`repro.comms.compile_program`), recording the lowering wall time into
    the artifact's `compile_stats`."""
    from repro_torch.comms.executor import compile_program
    return compile_program(sched)


# ---------------------------------------------------------------------- #
# family compilation: amortize stages across collectives
# ---------------------------------------------------------------------- #

FamilyArtifact = Union[PipelineSchedule, AllReduceSchedule]


def _split_pack_worker(plan: CollectivePlan) -> CollectivePlan:
    """Process-pool body for `compile_family(jobs=...)`: finish one plan
    kind's chunk-count-independent stages.  Ships a solved (or fresh,
    for rooted kinds) plan to a worker process and returns the packed
    plan — stage stats (wall times + oracle counters) ride back inside
    it, so BENCH instrumentation survives the process hop; only the
    in-process warm-oracle offers are lost (documented trade-off)."""
    if plan.opt is None:
        plan = solve(plan)
    return pack(split(plan))


def compile_family(topo: DiGraph, kinds: Sequence[str] = FAMILY_KINDS,
                   num_chunks: int = 8, root: Optional[int] = None,
                   fixed_k: Optional[int] = None,
                   pair_priority: Optional[PairPriority] = None,
                   verify: bool = False,
                   timings: Optional[Dict[str, float]] = None,
                   packed_out: Optional[Dict[str, CollectivePlan]] = None,
                   jobs: int = 1) -> Dict[str, FamilyArtifact]:
    """Compile several collectives for one topology, sharing stages.

    * The §2.1 solve runs once and is shared across both orientations
      (exact — see `adopt_solution`), so allreduce never solves twice.
    * split/pack/rounds products are computed once per orientation and
      reused: `allreduce` is assembled from the same packed products as
      the `allgather` / `reduce_scatter` rows when requested together,
      and `alltoall` re-tags allgather's packed products outright (stages
      1-3 are kind-independent; only the rounds construction differs).
    * Rooted kinds (`broadcast`, `reduce`) need `root`; `fixed_k` applies
      to the allgather family only (rooted kinds always use k = λ(root)).
    * A `timings` dict (if given) receives each kind's *marginal* wall
      seconds — shared stage work is charged to the kind that triggered
      it, so the values sum to the family's total compile wall time (this
      is what the sweep records as per-row ``compile_time_s``).
    * A `packed_out` dict (if given) receives the packed (pre-rounds)
      plans by plan kind.  Stages 1-3 are chunk-count-independent, so a
      caller that discovers it needs a larger P (the sweep's P >= depth
      rule) can re-run only `rounds` + `emit` on a
      ``dataclasses.replace(plan, num_chunks=...)`` copy instead of
      recompiling the family.
    * ``jobs > 1`` runs the per-orientation split+pack stages in worker
      *processes* (each packed orientation/kind is independent once the
      solve is shared).  Artifacts stay byte-identical to the sequential
      path — only wall times in the stats sidecar differ, the family's
      parallel stage wall is charged to the first requested kind, and the
      in-process warm-oracle store sees no offers from worker plans.

    Returns {kind: artifact}, semantically identical (and byte-identical
    once serialized) to calling the per-kind `compile_*` entry points.
    """
    kinds = list(kinds)
    unknown = [k for k in kinds if k not in FAMILY_KINDS]
    if unknown:
        raise PlanError(f"unknown collective kinds {unknown} "
                        f"(choose from {FAMILY_KINDS})")
    packed: Dict[str, CollectivePlan] = {}
    full: Dict[str, CollectivePlan] = {}

    pre_wall = 0.0
    if jobs > 1:
        # expand to plan kinds in sequential trigger order (allreduce is
        # RS then AG — the same order the emit loop below uses)
        plan_kinds: List[str] = []
        for kind in kinds:
            # alltoall shares allgather's packed products outright, so the
            # workers pack allgather once and packed_plan() re-tags it
            for pk in (("reduce_scatter", "allgather")
                       if kind == "allreduce"
                       else ("allgather",) if kind == "alltoall"
                       else (kind,)):
                if pk not in plan_kinds:
                    plan_kinds.append(pk)
        if len(plan_kinds) > 1:
            t0 = time.perf_counter()
            todo: List[CollectivePlan] = []
            shared_opt: Optional[Optimality] = None
            for pk in plan_kinds:
                p = plan_for(pk, topo, num_chunks=num_chunks,
                             root=root if pk in _ROOTED else None,
                             fixed_k=fixed_k if pk not in _ROOTED else None,
                             pair_priority=pair_priority, verify=verify)
                if pk not in _ROOTED and fixed_k is None:
                    # exactly the sequential sharing: the first non-rooted
                    # kind solves, its transpose dual adopts that solution
                    if shared_opt is None:
                        p = solve(p)
                        shared_opt = p.opt
                    else:
                        p = adopt_solution(p, shared_opt)
                # rooted / fixed-k plans solve in their worker
                todo.append(p)
            import concurrent.futures
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=min(jobs, len(todo))) as ex:
                done = list(ex.map(_split_pack_worker, todo))
            packed.update({p.kind: p for p in done})
            pre_wall = time.perf_counter() - t0

    def packed_plan(kind: str) -> CollectivePlan:
        if kind in packed:
            return packed[kind]
        sib = _FORWARD_SHARE.get(kind)
        if sib is not None and sib in packed:
            # same orientation, same (fixed-)k: stages 1-3 are identical,
            # so re-tag the sibling's packed products instead of recomputing
            src = packed[sib]
            p = dataclasses.replace(
                src, kind=kind,
                stats=dataclasses.replace(src.stats.copy(), kind=kind))
            packed[kind] = p
            return p
        p = plan_for(kind, topo, num_chunks=num_chunks,
                     root=root if kind in _ROOTED else None,
                     fixed_k=fixed_k if kind not in _ROOTED else None,
                     pair_priority=pair_priority, verify=verify)
        donor = next((d for d in _OPT_DONORS.get(kind, ())
                      if d in packed), None) if fixed_k is None else None
        if donor is not None:
            p = adopt_solution(p, packed[donor].opt)
        else:
            p = solve(p)
        p = pack(split(p))
        packed[kind] = p
        return p

    def full_plan(kind: str) -> CollectivePlan:
        if kind not in full:
            full[kind] = rounds(packed_plan(kind))
        return full[kind]

    out: Dict[str, FamilyArtifact] = {}
    for kind in kinds:
        t0 = time.perf_counter()
        if kind == "allreduce":
            # RS first, AG adopts its solve — same order as the monolith
            rs = emit(full_plan("reduce_scatter"))
            ag = emit(full_plan("allgather"))
            out[kind] = AllReduceSchedule(rs=rs, ag=ag)
        else:
            out[kind] = emit(full_plan(kind))
        if timings is not None:
            timings[kind] = time.perf_counter() - t0
    if timings is not None and kinds:
        timings[kinds[0]] += pre_wall   # parallel stage wall (jobs > 1)
    if packed_out is not None:
        packed_out.update(packed)
    return out
