"""Online schedule repair: delta-recompile a degraded topology from the
warm oracle state the base compile left behind.

A link failing (or degrading) mid-run turns the fabric G into G' with
strictly smaller capacities.  Cold-compiling G' repeats the three oracle-
heavy stages — the §2.1 optimality search, the §2.2 edge splitting and the
§2.3 packing — from empty flow networks, even though G' differs from G on a
single edge.  Repair instead *transplants* the base run's retained networks
and re-derives each stage from capacity deltas:

solve   The degraded optimum is found by an exact Dinkelbach-style
        iteration started at the base ``1/x*``: capacity decreases only
        raise cut ratios (for every cut S, ``B+_{G'}(S) <= B+_G(S)``), so
        the base value is an achieved-ratio lower bound of the degraded
        value.  If the Theorem-1 oracle accepts it, it *is* the degraded
        ``1/x*``; otherwise the failing probe's min cut T yields the
        strictly larger achieved ratio ``|T∩Vc| / B+_{G'}(T)`` (from the
        cut arithmetic of eq. 1:  ``q·(n−|T∩Vc|) + p·B+_{G'}(T) < n·q``
        implies the ratio exceeds p/q), and the iteration repeats from it.
        Ratios strictly increase through achieved values, so the loop is
        finite and the result is exactly ``allgather_inv_xstar(G')`` — a
        handful of oracle probes instead of a whole binary search.  The
        probes themselves run on a clone of the base solve network rebound
        to G' (`SourcedNetwork.clone(g=...)`), skipping the rebuild.

split   Two warm layers.  (a) The base run's Theorem-8 prober (network,
        keyed term-flow snapshots, binding-sink history) is transplanted:
        every capacity is rewritten to the degraded scaled value through
        the target-tracking setters, so each term's first warm probe
        drains/augments exactly the inter-run delta instead of recomputing
        the |Vc|·k-unit base flow.  (b) The base compile records a
        `SplitTrace` — every prober call, its result, and a per-switch
        residual snapshot — and repair *replays* it through a
        `_ReplayProber`: while the degraded residual is pointwise dominated
        by the base residual at the aligned trace position, capacity
        monotonicity of maxflow makes every base zero-probe a proven zero
        for the degraded run (``m' <= m = 0``), so it is answered without
        touching the oracle; positive base results bound the degraded
        answer from above (the ``expect`` fast path: one feasibility check
        at the recorded value decides a binary search, and Theorem-8's
        running minimum starts at it).  Any mismatch — a pick value that
        differs, a base pick our enumeration skipped, trace exhaustion —
        desynchronises the replay, which then probes everything until the
        next switch boundary re-establishes domination against the
        recorded snapshot.  Every returned value is a genuine oracle probe
        or a monotonicity-proven zero, so the split trajectory, and with
        it the emitted bytes, match a cold compile of G' exactly.  The
        transplant/replay is only engaged when the degraded optimum keeps
        the base ``(U, k)`` (rooted: λ); a changed optimum rescales every
        capacity, the trace cannot align, and the split runs cold — which
        is always correct; the gate is purely about speed.

pack    §2.3 gadget networks are built per (class, tail) against the
        *residual* capacities at growth time, which diverge from the base
        run's after the first differing pick — there is no stable base
        state to transplant, so pack always runs fresh.  It is still
        warm within the run: `_MuGadget` keeps per-head flow snapshots
        across picks (see `repro.core.arborescence`).

rounds/lower are cheap, deterministic reconstructions and always rerun.

The repaired artifact is re-verified on the degraded graph (the simulator
replays every chunk) and is byte-identical to a cold compile of the
transformed topology — `tests/test_repair.py` pins this across the zoo.
"""
from __future__ import annotations

import dataclasses
import time
from fractions import Fraction
from typing import Any, Dict, Optional, Tuple, Union

from .edge_split import _ReplayProber, _RootedProber, _TheoremEightProber
from .graph import DiGraph, validate_eulerian
from .maxflow import COUNTERS, SourcedNetwork
from .optimality import (Optimality, _feasible_on, _oracle_net,
                         check_reachable, choose_U_k)
from .schedule import AllReduceSchedule, PipelineSchedule

__all__ = ["RepairError", "RepairReport", "WarmStore", "WARM",
           "repair_inv_xstar", "repair_artifact", "repair_schedule"]


class RepairError(RuntimeError):
    """Repair could not produce a verified schedule for the degraded graph."""


# ---------------------------------------------------------------------- #
# warm-state retention
# ---------------------------------------------------------------------- #

class WarmStore:
    """LRU retention of the oracle state a compile leaves behind, keyed by
    graph fingerprint, so a later repair can transplant it.

    * solve networks: ``work.fingerprint() -> SourcedNetwork`` (the §2.1
      D_k-shaped oracle, reusable for any transform of that work graph);
    * split probers: ``(scaled.fingerprint(), mode, param) -> prober``
      (mode "tree" with param k, or "rooted" with param (root, k)).

    Deposits happen inside `repro.core.plan.solve` / `split`; lookups only
    in this module.  Entries are bounded (`max_entries` per category,
    insertion-ordered eviction) — losing one only costs warmth, never
    correctness, since every repair path falls back to cold oracles.
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._solve: Dict[str, SourcedNetwork] = {}
        self._split: Dict[Tuple[str, str, Any], Any] = {}

    @staticmethod
    def _put(store: Dict, key, value, cap: int) -> None:
        store.pop(key, None)
        store[key] = value
        while len(store) > cap:
            store.pop(next(iter(store)))

    def offer_solve(self, work: DiGraph, net: SourcedNetwork) -> None:
        self._put(self._solve, work.fingerprint(), net, self.max_entries)

    def solve_net(self, fingerprint: str) -> Optional[SourcedNetwork]:
        return self._solve.get(fingerprint)

    def offer_split(self, scaled: DiGraph, mode: str, param,
                    prober) -> None:
        self._put(self._split, (scaled.fingerprint(), mode, param), prober,
                  self.max_entries)

    def split_prober(self, fingerprint: str, mode: str, param):
        return self._split.get((fingerprint, mode, param))

    def clear(self) -> None:
        self._solve.clear()
        self._split.clear()


#: process-wide store the staged compiler deposits into
WARM = WarmStore()


# ---------------------------------------------------------------------- #
# stage 1 repair: exact Dinkelbach iteration from the base optimum
# ---------------------------------------------------------------------- #

def repair_inv_xstar(degraded: DiGraph, base_inv: Fraction,
                     net: Optional[SourcedNetwork] = None,
                     max_rounds: int = 10_000) -> Tuple[Fraction, int]:
    """Exact degraded ``1/x*`` from the base value, by achieved-cut-ratio
    iteration (see module docstring for the argument).  Returns
    ``(inv_x_star, oracle_rounds)``; the value equals
    ``allgather_inv_xstar(degraded)`` exactly.

    `net` may be a Theorem-1 oracle network already bound to `degraded`
    (e.g. a transplanted clone of the base solve network); omitted, a
    fresh one is built.
    """
    check_reachable(degraded)
    n = degraded.num_compute
    if n == 1:
        return Fraction(0), 0
    dmin = degraded.min_compute_ingress()
    if dmin <= 0:
        raise RepairError(
            f"{degraded.name}: a compute node lost all ingress capacity")
    if net is None:
        net = _oracle_net(degraded)
    elif net.g is not degraded:
        raise RepairError("repair oracle network bound to the wrong graph")
    # both candidates are achieved cut ratios of the degraded graph (the
    # base 1/x* via capacity monotonicity), hence lower bounds of 1/x*'
    r = max(base_inv, Fraction(n - 1, dmin))
    for rounds in range(1, max_rounds + 1):
        if _feasible_on(net, r):
            # r is a lower bound *and* feasible (an upper bound): r = 1/x*'
            assert r.denominator <= dmin, (r, dmin)
            return r, rounds
        # the failing probe's min cut is a strictly-tighter achieved ratio
        v = net.last_failing
        assert v is not None
        side = set(net.net.min_cut_side(net.s))
        T = side - {net.s}
        nc = len(T & degraded.compute)
        egress = degraded.egress_set(T)
        if nc <= 0 or egress <= 0:  # pragma: no cover — invariant violation
            raise RepairError(
                f"degenerate failing cut while repairing {degraded.name}: "
                f"|T∩Vc|={nc}, B+(T)={egress} (failing sink {v})")
        r2 = Fraction(nc, egress)
        if r2 <= r:  # pragma: no cover — invariant violation
            raise RepairError(
                f"cut-ratio iteration stalled at {r} (next {r2}) "
                f"repairing {degraded.name}")
        r = r2
    raise RepairError(  # pragma: no cover — max_rounds is far beyond need
        f"no convergence after {max_rounds} rounds repairing {degraded.name}")


def _repair_optimality(work: DiGraph, base_opt: Optimality,
                       net: Optional[SourcedNetwork]
                       ) -> Tuple[Optimality, int]:
    """Degraded-work `Optimality`, exactly equal to `solve_optimality(work)`."""
    validate_eulerian(work)
    inv, rounds = repair_inv_xstar(work, base_opt.inv_x_star, net=net)
    U, k = choose_U_k(work, inv)
    return Optimality(inv_x_star=inv, U=U, k=k), rounds


# ---------------------------------------------------------------------- #
# full-pipeline repair
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class RepairReport:
    """What one repair did, and how warm it ran."""
    kind: str
    transform: str
    base_topology: str
    degraded_topology: str
    repair_time_s: float
    warm_solve: bool            # base solve network transplanted
    warm_split: bool            # base split prober transplanted
    solve_rounds: int           # Dinkelbach oracle rounds (0 = rooted path)
    verified: bool              # simulator replayed every chunk
    claimed_runtime: str        # exact Fraction as text
    cached: bool = False        # replayed from a .repair cache sidecar

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RepairReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _replay_or_raw(transplanted, dd, entry):
    """Wrap the transplanted prober in a `_ReplayProber` over the base
    run's decision trace when the warm-store entry carries one (it always
    does for probers sunk by `plan.split`); a bare transplant otherwise."""
    trace = getattr(entry, "trace", None)
    if trace is None:
        return transplanted
    return _ReplayProber(transplanted, dd, trace)


def _transform_of(transform) -> "TransformSpec":
    from repro_torch.topo.spec import TransformSpec
    if isinstance(transform, TransformSpec):
        return transform
    if isinstance(transform, str):
        return TransformSpec.parse_text(transform)
    raise TypeError(f"cannot interpret {type(transform).__name__!r} as a "
                    f"transform (takes TransformSpec | '@name(...)' string)")


def repair_schedule(artifact: PipelineSchedule, transform,
                    verify: bool = True
                    ) -> Tuple[PipelineSchedule, RepairReport]:
    """Delta-recompile `artifact` for ``transform.apply(artifact.topo)``.

    The result is byte-identical (same canonical serialization) to cold-
    compiling the degraded topology with the same kind/P/root, and is
    re-verified on the degraded graph (`verify=True` replays every chunk
    through the simulator's correctness checker; disabling it skips only
    the replay, never the exactness postconditions).

    Repair assumes the artifact was compiled with the automatic k (the
    §2.4 fixed-k floor is not recorded on artifacts and its floor-scaled
    capacities do not delta-compose); fixed-k artifacts must be recompiled
    cold.
    """
    from . import plan as plan_mod

    t0 = time.perf_counter()
    spec = _transform_of(transform)
    if artifact.kind not in plan_mod.PLAN_KINDS:
        raise RepairError(f"cannot repair artifact kind {artifact.kind!r}")
    if artifact.kind == "alltoall":
        raise RepairError(
            "cannot repair alltoall artifacts: the merged per-source "
            "scatter rounds are rebuilt whole-cloth from the packing, so a "
            "delta-recompile saves nothing over compiling the degraded "
            "topology cold — recompile instead")
    base_topo = artifact.topo
    try:
        degraded = spec.apply(base_topo)
    except ValueError as e:
        raise RepairError(f"{spec} does not apply to "
                          f"{base_topo.name}: {e}") from e
    rooted = artifact.kind in plan_mod._ROOTED
    plan = plan_mod.plan_for(
        artifact.kind, degraded, num_chunks=artifact.num_chunks,
        root=artifact.root if rooted else None)

    warm_solve = warm_split = False
    solve_rounds = 0
    base_work = base_topo.transpose() if plan.is_dual else base_topo
    if rooted:
        # Appendix-A λ(root) is a cheap direct computation; run stage 1 as-is
        plan = plan_mod.solve(plan)
    else:
        base_net = WARM.solve_net(base_work.fingerprint())
        net = None
        if base_net is not None:
            net = base_net.clone(g=plan.work)
            warm_solve = True
        c0 = COUNTERS.snapshot()
        ts = time.perf_counter()
        opt, solve_rounds = _repair_optimality(plan.work, artifact.opt, net)
        wall = time.perf_counter() - ts
        scaled = plan.work.scaled(opt.U)
        plan = dataclasses.replace(
            plan, opt=opt, scaled=scaled,
            stats=plan.stats.with_stage(
                "solve", wall, k=opt.k, U=str(opt.U),
                inv_x_star=str(opt.inv_x_star), repair="dinkelbach",
                rounds=solve_rounds, warm=warm_solve,
                **COUNTERS.delta(c0)))
        if net is not None:
            WARM.offer_solve(plan.work, net)

    # stage 2: transplant the base split prober when one is retained
    g = plan.scaled
    switched = g.switches and any(w in e for e in g.cap for w in g.switches)
    factory = None
    if switched:
        # Transplant only when the degraded optimum *matches* the base one:
        # then the scaled graphs differ solely on the transformed link and
        # every retained flow re-validates after a single-edge delta.  A
        # changed (U, k) / λ rescales every capacity and demand, and
        # draining the base flows down to the new limits costs more than a
        # cold run — fall back to the cold oracle (exact either way; this
        # gate is purely about speed).
        if rooted:
            if plan.opt.k == artifact.opt.k:
                base_scaled_fp = base_work.fingerprint()  # rooted: U = 1
                entry = WARM.split_prober(
                    base_scaled_fp, "rooted", (artifact.root, artifact.opt.k))
                if entry is not None:
                    demands = {plan.root: plan.opt.k}
                    factory = (lambda dd: _replay_or_raw(
                        _RootedProber.transplant(
                            getattr(entry, "inner", entry), dd, demands),
                        dd, entry))
        elif (plan.opt.U, plan.opt.k) == (artifact.opt.U, artifact.opt.k):
            base_scaled_fp = base_work.scaled(artifact.opt.U).fingerprint()
            entry = WARM.split_prober(
                base_scaled_fp, "tree", artifact.opt.k)
            if entry is not None:
                k2 = plan.opt.k
                factory = (lambda dd: _replay_or_raw(
                    _TheoremEightProber.transplant(
                        getattr(entry, "inner", entry), dd, k2),
                    dd, entry))
        warm_split = factory is not None
    plan = plan_mod.split(plan, prober_factory=factory)

    plan = plan_mod.rounds(plan_mod.pack(plan))
    art = plan_mod.emit(plan)

    # re-verify: replay the repaired schedule on the degraded graph
    from . import simulate as sim
    fn = {"allgather": sim.simulate_allgather,
          "reduce_scatter": sim.simulate_reduce_scatter,
          "broadcast": sim.simulate_broadcast,
          "reduce": sim.simulate_reduce}[art.kind]
    try:
        rep = fn(art, verify=verify)
    except Exception as e:
        raise RepairError(
            f"repaired {art.kind} schedule failed verification on "
            f"{degraded.name}: {e}") from e
    art.claimed_runtime = rep.sim_time

    report = RepairReport(
        kind=artifact.kind, transform=str(spec),
        base_topology=base_topo.name, degraded_topology=degraded.name,
        repair_time_s=time.perf_counter() - t0,
        warm_solve=warm_solve, warm_split=warm_split,
        solve_rounds=solve_rounds, verified=verify,
        claimed_runtime=str(rep.sim_time))
    return art, report


def repair_artifact(artifact: Union[PipelineSchedule, AllReduceSchedule],
                    transform, verify: bool = True):
    """Repair a cached artifact for a topology transform.  Allreduce
    artifacts repair both halves (reduce-scatter + allgather) and
    recompose; the merged report sums the halves' wall time."""
    if isinstance(artifact, AllReduceSchedule):
        rs, rep_rs = repair_schedule(artifact.rs, transform, verify=verify)
        ag, rep_ag = repair_schedule(artifact.ag, transform, verify=verify)
        report = RepairReport(
            kind="allreduce", transform=rep_rs.transform,
            base_topology=rep_rs.base_topology,
            degraded_topology=rep_rs.degraded_topology,
            repair_time_s=rep_rs.repair_time_s + rep_ag.repair_time_s,
            warm_solve=rep_rs.warm_solve and rep_ag.warm_solve,
            warm_split=rep_rs.warm_split and rep_ag.warm_split,
            solve_rounds=rep_rs.solve_rounds + rep_ag.solve_rounds,
            verified=verify,
            claimed_runtime=str(Fraction(rep_rs.claimed_runtime) +
                                Fraction(rep_ag.claimed_runtime)))
        return AllReduceSchedule(rs=rs, ag=ag), report
    return repair_schedule(artifact, transform, verify=verify)
