"""Topology-zoo sweep over the port's compiler copy: compile + simulate +
verify the full collective family on every topology, and write the
schedule-quality scoreboard.  Counterpart of src/repro/cache/sweep.py: the
same rows, fields and options, through `repro_torch.api.Collectives` and
`repro_torch.core`; the document's ``compiler`` is the port's fingerprint
(`repro_torch.cache.fingerprint`).  It writes ``BENCH_schedules.torch.json``
(a partial run ``BENCH_schedules.torch.smoke.json``), never the committed
``BENCH_schedules.json``, which stays the reference's scoreboard and the
baseline the port's rows are held to.

Every (topology, collective) entry records compile time, the exact optimal
bound for that collective, the schedule's claimed pipelined runtime, the
re-simulated achieved runtime and their exact ratio
(``achieved_over_claimed`` must be "1": the verifier replays every chunk, so
a schedule that does not reproduce its claim fails the sweep).
``achieved_over_lb`` tracks convergence to the asymptotic bound as the chunk
count grows.

Collectives swept (``--collectives`` selects a subset):

  allgather / reduce_scatter — §2.1-2.3 construction and its transpose dual
  broadcast / reduce         — Appendix A rooted trees (root = first compute
                               node) and the edge-reversed reduction
  allreduce                  — Appendix B RS+AG composition, cached as one
                               artifact
  alltoall                   — per-source pruned scatter over the allgather
                               family's packed trees (swept at P = 1: the
                               N−1 destination blocks already fill the
                               pipeline, so re-chunking buys nothing)

The sweep compiles each topology's collectives **as one family**
(`plan.compile_family` / `ScheduleCache.family`): the §2.1 solve and the
split/pack products are shared across kinds (allreduce reuses its
allgather / reduce-scatter siblings outright), byte-identical to the
per-kind compilers.  Each row's ``compile_time_s`` is that kind's
*marginal* wall time — shared stage work is charged to the kind that
triggered it, so the rows of one topology sum to its family compile time.

Every row carries the staged compiler's per-stage record (BENCH v6
``compile_stats``: a ``[{stage, seconds, probes, augments}]`` list in
pipeline order) alongside the total ``compile_time_s``, plus the summed
oracle-engine work counters (``oracle_probes`` / ``oracle_augments``:
maxflow calls and augmenting paths over the stages that produced the
artifact), so perf work can see *which* stage moved and whether oracle
reuse is paying off.  Note that an artifact emitted from shared plan
products reports the shared stages' times/counters (the work that
*produced* it), which can exceed its own marginal ``compile_time_s``.

``--repair`` (BENCH v5) adds a ``repair`` section: every swept row whose
spec carries a transform (``*_failed`` / ``*_degraded`` zoo rows,
transformed --topology specs) is *also* produced by online schedule repair
(`repro_torch.core.repair`) from its stripped base spec — the base compile warms
the oracle store, the repair delta-recompiles from it — and byte-compared
against the cold compile of the transformed spec.  Each row records
``repair_time_s`` vs ``cold_compile_time_s``; any byte mismatch fails the
sweep.

``--fixed-k K`` sweeps the §2.4 fixed-tree-count variant over the zoo
(allgather family only — rooted kinds always use k = λ(root)); topologies
where the floor-scaled graph can't be compiled for that k are reported in
the document's ``skipped`` list rather than failing the sweep.

The swept topologies come from the declarative zoo registry
(`repro_torch.topo.spec.zoo_specs()` — the `ZOO_SPECS` table keyed by BENCH row
name), and ``--topology SPEC`` adds arbitrary non-zoo fabrics using the
full spec grammar, transforms included, without any code edit:

    python -m repro_torch.cache.sweep --topology "torus2d:6x6@fail(0-1)" \
        "dragonfly:g4,p3"

Such rows are named by their canonical spec string.  All compilation goes
through the `repro_torch.api.Collectives` facade (cache-first when a cache dir
is given).

Runs topologies in parallel with `concurrent.futures` (each worker
compiles one topology's whole family); pass a cache dir to make repeated
sweeps (and any launch that follows) skip compilation.

    PYTHONPATH=src python -m repro_torch.cache.sweep
    PYTHONPATH=src python -m repro_torch.cache.sweep --smoke   # 3 topologies
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import time
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.api import Collectives
from repro_torch.core import schedule as schedule_mod
from repro_torch.core import simulate as sim
from repro_torch.core.graph import DiGraph
from repro_torch.topo.spec import TopologySpec, zoo_specs

from .fingerprint import compiler_fingerprint

BENCH_FORMAT = "repro.bench_schedules"
# v5: adds the optional ``repair`` section (--repair): per (topology,
# transform, kind) rows with ``repair_time_s`` vs ``cold_compile_time_s``
# and the byte-identity verdict of the repaired artifact.
# v6: normalizes ``compile_stats`` from a {stage: seconds} mapping to an
# aggregatable ``[{stage, seconds, probes, augments}]`` list in pipeline
# order (see cache README).
# v7: adds ``alltoall`` rows (swept at P = ALLTOALL_CHUNKS, lower bound =
# the exact bisection-cut `alltoall_lb`); repair rows for alltoall are
# always ``skipped`` (repair rejects the kind).
BENCH_VERSION = 7
SMOKE_NAMES = ("ring8", "hypercube3", "fig1a")
# the scaled-up zoo rows (64-compute fabrics where split/pack dominate);
# all of them are committed BENCH rows, and a full sweep document fed to
# tools/perf_smoke.py --measured gates every one of them
LARGE_NAMES = ("torus8x8", "torus8x8_failed", "fattree8p4l2h",
               "fattree8p4l2h_degraded", "fattree8p4l4h", "dragonfly6x4",
               "dragonfly6x4_degraded", "torus16x16")
# what the perf gate compiles fresh by default: the smoke rows plus two
# scaled-up fabrics — dragonfly6x4 (cheapest 64-compute row) and
# fattree8p4l2h (the §2.3 pack hot-path poster child, cheap since the
# fast-substrate packer landed; tools/perf_smoke.py gates its pack stage
# individually)
PERF_GATE_NAMES = SMOKE_NAMES + ("dragonfly6x4", "fattree8p4l2h")
COLLECTIVES = ("allgather", "reduce_scatter", "broadcast", "reduce",
               "allreduce", "alltoall")
# kinds a --fixed-k sweep exercises (rooted kinds always use k = λ(root))
FIXED_K_COLLECTIVES = ("allgather", "reduce_scatter", "allreduce",
                       "alltoall")
# alltoall sweeps at P = 1: each spanning tree already pipelines N−1
# distinct destination blocks back-to-back, so its rounds stay full
# without sub-chunking and the P >= depth acceptance rule does not apply
ALLTOALL_CHUNKS = 1


def default_out_path(partial: bool) -> str:
    """The port's scoreboard, never the committed reference one; partial
    runs (--smoke / explicit --names) write a scratch file of their own."""
    return "BENCH_schedules.torch.smoke.json" if partial \
        else "BENCH_schedules.torch.json"


def claim_mismatches(doc: Dict[str, Any]) -> List[str]:
    """Entries whose re-simulated runtime != the claimed runtime."""
    return [f"{e['name']}:{e.get('kind', 'allgather')}"
            for e in doc["entries"] if e["achieved_over_claimed"] != "1"]


def sweep_registry() -> Dict[str, Callable[[], DiGraph]]:
    """The expanded zoo (paper families + hypercube/BCube/mesh-of-DGX and
    degraded / failed-link variants) as ``{row_name: builder}``, derived
    from the declarative `repro_torch.topo.zoo.ZOO_SPECS` registry."""
    return {name: spec.build for name, spec in zoo_specs().items()}


def _build_topology(name: str) -> DiGraph:
    """A sweep row's graph: a committed zoo row name, or (for --topology
    rows) the canonical spec string itself."""
    specs = zoo_specs()
    if name in specs:
        return specs[name].build()
    return TopologySpec.parse(name).build()


def _known_name(name: str) -> bool:
    if name in zoo_specs():
        return True
    try:
        TopologySpec.parse(name)
        return True
    except ValueError:
        return False


def _compile(kind: str, g: DiGraph, num_chunks: int,
             cache_dir: Optional[str], root: Optional[int],
             fixed_k: Optional[int] = None):
    return Collectives(cache=cache_dir).schedule(
        g, kind=kind, root=root, num_chunks=num_chunks,
        fixed_k=None if kind in ("broadcast", "reduce") else fixed_k)


def _compile_family(g: DiGraph, kinds: Sequence[str], num_chunks: int,
                    cache_dir: Optional[str], root: Optional[int],
                    fixed_k: Optional[int], timings: Dict[str, float],
                    packed: Dict[str, Any],
                    pack_jobs: int = 1) -> Dict[str, Any]:
    """One topology's whole collective family, stages shared across kinds
    (cache-backed when a cache dir is given); `timings` receives per-kind
    marginal wall seconds, `packed` the pre-rounds plans (fresh-compile
    path only — a cache hit needs no re-rounding plan); ``pack_jobs > 1``
    packs the independent orientations in worker processes."""
    return Collectives(cache=cache_dir).family(
        g, kinds, num_chunks=num_chunks, fixed_k=fixed_k, root=root,
        timings=timings, packed_out=packed, jobs=pack_jobs)


def _rechunked(packed_plan, num_chunks: int):
    """Rounds + emit of a packed plan at a larger chunk count (stages 1-3
    are P-independent, so the packed products are reused as-is)."""
    import dataclasses
    from repro_torch.core import plan as plan_mod
    return plan_mod.emit(plan_mod.rounds(
        dataclasses.replace(packed_plan, num_chunks=num_chunks)))


_SIMULATORS = {
    "allgather": sim.simulate_allgather,
    "reduce_scatter": sim.simulate_reduce_scatter,
    "broadcast": sim.simulate_broadcast,
    "reduce": sim.simulate_reduce,
    "allreduce": sim.simulate_allreduce,
    "alltoall": sim.simulate_alltoall,
}


def _depth(sched) -> int:
    if isinstance(sched, schedule_mod.AllReduceSchedule):
        return max(sched.rs.depth, sched.ag.depth)
    return sched.depth


def _compile_stats(sched) -> Optional[List[Dict[str, Any]]]:
    """An artifact's per-stage compiler record, normalized (BENCH v6) to an
    aggregatable ``[{stage, seconds, probes, augments}]`` list in pipeline
    order — allreduce sums its two halves stage-by-stage.  None when the
    artifact carries no instrumentation."""
    halves = (sched.rs, sched.ag) \
        if isinstance(sched, schedule_mod.AllReduceSchedule) else (sched,)
    order: List[str] = []
    acc: Dict[str, Dict[str, Any]] = {}
    for half in halves:
        cs = half.compile_stats
        if cs is None:
            continue
        for s in cs.stages:
            row = acc.get(s.stage)
            if row is None:
                order.append(s.stage)
                row = acc[s.stage] = {"stage": s.stage, "seconds": 0.0,
                                      "probes": 0, "augments": 0}
            row["seconds"] = round(row["seconds"] + s.wall_time_s, 6)
            row["probes"] += int(s.meta.get("probes", 0))
            row["augments"] += int(s.meta.get("augments", 0))
    return [acc[stage] for stage in order] or None


def _oracle_counters(sched) -> Dict[str, int]:
    """Summed maxflow probe/augment counters over the stages that produced
    the artifact (allreduce sums its halves; zero for uninstrumented
    artifacts)."""
    halves = (sched.rs, sched.ag) \
        if isinstance(sched, schedule_mod.AllReduceSchedule) else (sched,)
    probes = augments = 0
    for half in halves:
        cs = half.compile_stats
        if cs is None:
            continue
        for stage in cs.stages:
            probes += stage.meta.get("probes", 0)
            augments += stage.meta.get("augments", 0)
    return {"oracle_probes": probes, "oracle_augments": augments}


def _entry(name: str, kind: str, g: DiGraph, root: Optional[int],
           fixed_k: Optional[int], sched,
           compile_time: float) -> Dict[str, Any]:
    """Verify one compiled artifact chunk-by-chunk, simulate, and build its
    scoreboard row."""
    rep = _SIMULATORS[kind](sched, verify=True)   # replays every chunk
    achieved = rep.sim_time
    # Cache path: `claimed` was recorded in the artifact at compile time, so
    # achieved == claimed is a real replay-fidelity check.  Fresh-compile
    # path: adopt the verified run as the claim (simulating twice in one
    # process would only compare the simulator against itself).
    claimed = sched.claimed_runtime
    if claimed is None:
        claimed = achieved
    lb = rep.lb_time
    if isinstance(sched, schedule_mod.AllReduceSchedule):
        opt, num_p = sched.rs.opt, sched.rs.num_chunks
        rounds = len(sched.rs.rounds) + len(sched.ag.rounds)
        sends = sched.rs.total_sends() + sched.ag.total_sends()
    else:
        opt, num_p = sched.opt, sched.num_chunks
        rounds, sends = len(sched.rounds), sched.total_sends()
    return {
        "name": name,
        "kind": kind,
        "root": root,
        "fixed_k": fixed_k,
        "topology": g.name,
        "fingerprint": g.fingerprint(),
        "num_nodes": g.num_nodes,
        "num_compute": g.num_compute,
        "num_switches": len(g.switches),
        "num_edges": len(g.cap),
        "num_chunks": num_p,
        "compile_time_s": round(compile_time, 6),
        "compile_stats": _compile_stats(sched),
        **_oracle_counters(sched),
        "inv_x_star": str(opt.inv_x_star),
        "U": str(opt.U),
        "k": opt.k,
        "depth": _depth(sched),
        "rounds": rounds,
        "total_sends": sends,
        "lb_runtime": str(lb),
        "claimed_runtime": str(claimed),
        "achieved_runtime": str(achieved),
        "achieved_over_claimed": str(achieved / claimed),
        "achieved_over_lb": str(achieved / lb),
        "achieved_over_lb_float": float(achieved / lb),
        "verified": True,
    }


def sweep_one(name: str, kind: str = "allgather", num_chunks: int = 16,
              cache_dir: Optional[str] = None,
              fixed_k: Optional[int] = None) -> Dict[str, Any]:
    """Compile one (topology, collective) pair (P >= depth enforced; alltoall
    sweeps at P = ALLTOALL_CHUNKS, exempt from the rule), verify
    chunk-by-chunk, simulate, and return a scoreboard entry."""
    g = _build_topology(name)
    root = min(g.compute) if kind in ("broadcast", "reduce") else None
    if kind == "alltoall":
        num_chunks = ALLTOALL_CHUNKS
    t0 = time.perf_counter()
    sched = _compile(kind, g, num_chunks, cache_dir, root, fixed_k)
    if kind != "alltoall" and _depth(sched) > num_chunks:
        # acceptance requires P >= tree depth
        sched = _compile(kind, g, _depth(sched), cache_dir, root, fixed_k)
    compile_time = time.perf_counter() - t0
    return _entry(name, kind, g, root, fixed_k, sched, compile_time)


def _alltoall_artifact(g: DiGraph, cache_dir: Optional[str],
                       fixed_k: Optional[int], packed: Dict[str, Any]):
    """One alltoall sweep artifact at P = ALLTOALL_CHUNKS.  On the
    fresh-compile path the allgather family's packed plan is re-tagged and
    only rounds + emit run (stages 1-3 are kind-independent — identical
    bytes to a cold `compile_alltoall`); the cache path (no packed plans)
    goes through the facade, which replays or compiles as usual."""
    if "allgather" in packed:
        import dataclasses
        from repro_torch.core import plan as plan_mod
        src = packed["allgather"]
        p = dataclasses.replace(
            src, kind="alltoall", num_chunks=ALLTOALL_CHUNKS,
            stats=dataclasses.replace(src.stats.copy(), kind="alltoall"))
        return plan_mod.emit(plan_mod.rounds(p))
    return Collectives(cache=cache_dir).schedule(
        g, kind="alltoall", num_chunks=ALLTOALL_CHUNKS, fixed_k=fixed_k)


def _sweep_topology(name: str, kinds: Sequence[str], num_chunks: int,
                    cache_dir: Optional[str], fixed_k: Optional[int],
                    pack_jobs: int = 1) -> List[Dict[str, Any]]:
    """All of one topology's sweep rows, compiled as a single family so
    solve/split/pack are amortized across the collective kinds; each row's
    ``compile_time_s`` is its kind's marginal wall time.  Alltoall is
    carved out of the family call (it sweeps at P = ALLTOALL_CHUNKS, not
    the sweep's chunk count) and built from the family's packed allgather
    plan — see `_alltoall_artifact`.

    Under --fixed-k, topologies that can't compile for the requested k
    (e.g. the floor-scaled graph loses the Eulerian condition) fall back to
    per-kind compilation so any kind that *can* compile still gets a row,
    and the infeasible kinds become `skipped` records instead of killing
    the sweep.  Only the known infeasibility errors are tolerated — a
    PackingError or a verification failure is a compiler bug and still
    fails the run."""
    from repro_torch.core.edge_split import EdgeSplitError
    g = _build_topology(name)
    root = (min(g.compute)
            if any(k in ("broadcast", "reduce") for k in kinds) else None)
    fam_kinds = [k for k in kinds if k != "alltoall"]
    try:
        timings: Dict[str, float] = {}
        packed: Dict[str, Any] = {}
        arts: Dict[str, Any] = {}
        if fam_kinds:
            arts = _compile_family(g, fam_kinds, num_chunks, cache_dir, root,
                                   fixed_k, timings, packed, pack_jobs)
        if "alltoall" in kinds:
            t0 = time.perf_counter()
            arts["alltoall"] = _alltoall_artifact(g, cache_dir, fixed_k,
                                                  packed)
            timings["alltoall"] = time.perf_counter() - t0
    except (EdgeSplitError, ValueError) as e:
        if fixed_k is None:
            raise
        results = []
        for kind in kinds:
            try:
                results.append(sweep_one(name, kind, num_chunks, cache_dir,
                                         fixed_k))
            except (EdgeSplitError, ValueError) as e:
                results.append({"name": name, "kind": kind,
                                "fixed_k": fixed_k,
                                "skipped": f"{type(e).__name__}: {e}"})
        return results
    rows = []
    for kind in kinds:
        sched = arts[kind]
        kind_root = root if kind in ("broadcast", "reduce") else None
        extra = 0.0
        if kind != "alltoall" and _depth(sched) > num_chunks:
            # acceptance requires P >= tree depth (alltoall exempt: its
            # destination blocks fill the pipeline at P = 1)
            t0 = time.perf_counter()
            need = _depth(sched)
            if kind == "allreduce" and "reduce_scatter" in packed:
                sched = schedule_mod.AllReduceSchedule(
                    rs=_rechunked(packed["reduce_scatter"], need),
                    ag=_rechunked(packed["allgather"], need))
            elif kind in packed:
                sched = _rechunked(packed[kind], need)
            else:   # cache path: re-ask the cache at the larger P
                sched = _compile(kind, g, need, cache_dir, kind_root,
                                 None if kind_root is not None else fixed_k)
            extra = time.perf_counter() - t0
        rows.append(_entry(name, kind, g, kind_root, fixed_k, sched,
                           timings.get(kind, 0.0) + extra))
    return rows


def _repair_target(name: str):
    """(base_spec, transform) of a transformed sweep row, or None for rows
    without a (single) transform."""
    import dataclasses
    spec = zoo_specs().get(name)
    if spec is None:
        try:
            spec = TopologySpec.parse(name)
        except ValueError:
            return None
    if len(spec.transforms) != 1:
        return None
    return dataclasses.replace(spec, transforms=()), spec.transforms[0]


def _repair_topology(name: str, kinds: Sequence[str],
                     num_chunks: int) -> List[Dict[str, Any]]:
    """BENCH v5 repair rows for one transformed zoo row: compile the
    stripped base spec (warming the in-process oracle store), cold-compile
    the transformed spec, then `repair_artifact` from the base — asserting
    the repaired schedule is byte-identical to the cold compile and
    recording ``repair_time_s`` vs ``cold_compile_time_s``."""
    from repro_torch.core.repair import RepairError, repair_artifact
    from .serialize import allreduce_to_json, schedule_to_json
    target = _repair_target(name)
    if target is None:
        return []
    base_spec, transform = target
    base_g = base_spec.build()
    deg_g = _build_topology(name)
    coll = Collectives(cache=None)
    rows: List[Dict[str, Any]] = []
    for kind in kinds:
        if kind == "alltoall":
            # repair rejects the kind outright — record the skip without
            # paying for the base + cold compiles it would take to find out
            rows.append({"name": name, "kind": kind,
                         "transform": str(transform),
                         "base_topology": base_g.name,
                         "skipped": "RepairError: repair does not support "
                                    "alltoall artifacts"})
            continue
        root = min(base_g.compute) if kind in ("broadcast", "reduce") \
            else None
        base_art = coll.schedule(base_g, kind=kind, root=root,
                                 num_chunks=num_chunks)
        t0 = time.perf_counter()
        cold_art = coll.schedule(deg_g, kind=kind, root=root,
                                 num_chunks=num_chunks)
        cold_s = time.perf_counter() - t0
        row: Dict[str, Any] = {
            "name": name, "kind": kind, "transform": str(transform),
            "base_topology": base_g.name,
            "cold_compile_time_s": round(cold_s, 6),
        }
        try:
            rep_art, report = repair_artifact(base_art, transform,
                                              verify=True)
        except RepairError as e:
            row["skipped"] = f"RepairError: {e}"
            rows.append(row)
            continue
        to_json = allreduce_to_json if kind == "allreduce" \
            else schedule_to_json
        row.update({
            "repair_time_s": round(report.repair_time_s, 6),
            "speedup": round(cold_s / report.repair_time_s, 4)
            if report.repair_time_s > 0 else None,
            "warm_solve": report.warm_solve,
            "warm_split": report.warm_split,
            "solve_rounds": report.solve_rounds,
            "bytes_equal": to_json(rep_art) == to_json(cold_art),
        })
        rows.append(row)
    return rows


def repair_mismatches(doc: Dict[str, Any]) -> List[str]:
    """Repair rows whose repaired artifact is not byte-identical to the
    cold compile of the transformed spec."""
    return [f"{e['name']}:{e['kind']}" for e in doc.get("repair", ())
            if "skipped" not in e and not e.get("bytes_equal")]


def run_sweep(names: Optional[Sequence[str]] = None, num_chunks: int = 16,
              jobs: Optional[int] = None, cache_dir: Optional[str] = None,
              out_path: Optional[str] = None,
              collectives: Optional[Sequence[str]] = None,
              fixed_k: Optional[int] = None,
              topologies: Optional[Sequence[str]] = None,
              repair: bool = False, pack_jobs: int = 1) -> Dict[str, Any]:
    """Sweep the named zoo rows (default: all of them) plus any extra
    `topologies` given as raw spec strings (rows named by the canonical
    spec form); `names` entries may themselves be spec strings.

    ``repair=True`` adds the BENCH v5 ``repair`` section: every swept row
    with a transform is re-derived by online repair from its stripped base
    spec and byte-compared against the cold compile (see
    `_repair_topology`).

    ``pack_jobs > 1`` packs each family's independent orientations/kinds
    in worker processes (artifacts byte-identical to sequential); it only
    engages when topology-level `jobs` parallelism is not already
    saturating the machine."""
    names = list(names) if names is not None else (
        [] if topologies else list(sweep_registry()))
    for text in topologies or ():
        names.append(str(TopologySpec.parse(text)))
    unknown = [n for n in names if not _known_name(n)]
    if unknown:
        raise KeyError(f"unknown sweep topologies: {unknown}")
    if collectives is None:
        collectives = list(FIXED_K_COLLECTIVES if fixed_k is not None
                           else COLLECTIVES)
    else:
        collectives = list(collectives)
    bad_kinds = [c for c in collectives if c not in COLLECTIVES]
    if bad_kinds:
        raise KeyError(f"unknown collectives: {bad_kinds}")
    if fixed_k is not None:
        rooted = [c for c in collectives if c not in FIXED_K_COLLECTIVES]
        if rooted:
            raise KeyError(f"--fixed-k does not apply to rooted kinds "
                           f"{rooted} (k = λ(root) there)")
        if repair:
            raise KeyError("--repair measures the automatic-k compiler "
                           "(fixed-k artifacts don't delta-compose); "
                           "drop --fixed-k")
    jobs = jobs if jobs is not None else min(len(names),
                                             max(1, (os.cpu_count() or 2)))
    if jobs <= 1 or len(names) <= 1:
        grouped = [_sweep_topology(n, collectives, num_chunks, cache_dir,
                                   fixed_k, pack_jobs) for n in names]
    else:
        # topology-level processes already saturate the pool; nesting the
        # per-family pack pool under them would oversubscribe
        with concurrent.futures.ProcessPoolExecutor(max_workers=jobs) as ex:
            futs = {ex.submit(_sweep_topology, n, collectives, num_chunks,
                              cache_dir, fixed_k, 1): n
                    for n in names}
            grouped = [f.result() for f in futs]
    results = [e for rows in grouped for e in rows]
    entries = [e for e in results if "skipped" not in e]
    skipped = [e for e in results if "skipped" in e]
    order = lambda e: (e["name"], COLLECTIVES.index(e["kind"]))  # noqa: E731
    entries.sort(key=order)
    skipped.sort(key=order)
    repair_rows: List[Dict[str, Any]] = []
    if repair:
        # fixed-k artifacts don't delta-compose (the floor isn't recorded),
        # so the repair section always measures the automatic-k compiler
        repair_kinds = [c for c in collectives]
        targets = [n for n in names if _repair_target(n) is not None]
        if jobs <= 1 or len(targets) <= 1:
            rep_grouped = [_repair_topology(n, repair_kinds, num_chunks)
                           for n in targets]
        else:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=jobs) as ex:
                futs = [ex.submit(_repair_topology, n, repair_kinds,
                                  num_chunks) for n in targets]
                rep_grouped = [f.result() for f in futs]
        repair_rows = sorted((e for rows in rep_grouped for e in rows),
                             key=order)
    doc = {
        "format": BENCH_FORMAT,
        "version": BENCH_VERSION,
        "compiler": compiler_fingerprint(),
        "num_chunks": num_chunks,
        "collectives": collectives,
        "fixed_k": fixed_k,
        "num_topologies": len(names),
        "num_entries": len(entries),
        "entries": entries,
        "skipped": skipped,
    }
    if repair:
        doc["repair"] = repair_rows
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    return doc


def build_parser() -> argparse.ArgumentParser:
    """The sweep CLI (exposed separately so tools/check_docs.py can assert
    the documented flags match)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help=f"only the 3 small smoke topologies {SMOKE_NAMES}")
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--topology", nargs="*", default=None, metavar="SPEC",
                    help="extra topologies as TopologySpec strings (full "
                         "grammar incl. transforms, e.g. "
                         "'torus2d:6x6@fail(0-1)'); swept alongside --names "
                         "(or alone), rows named by the canonical spec form")
    ap.add_argument("--collectives", nargs="*", default=None,
                    choices=list(COLLECTIVES),
                    help="collective kinds to sweep (default: all of "
                         f"{COLLECTIVES})")
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--fixed-k", type=int, default=None,
                    help="sweep the §2.4 fixed-tree-count variant "
                         f"(solve_fixed_k) with this k over {FIXED_K_COLLECTIVES}; "
                         "incompatible topologies land in the doc's "
                         "'skipped' list")
    ap.add_argument("--repair", action="store_true",
                    help="add the BENCH v5 repair section: every swept row "
                         "with a transform is also produced by online "
                         "repair from its stripped base spec "
                         "(repro_torch.core.repair), byte-compared against the "
                         "cold compile, and timed (repair_time_s vs "
                         "cold_compile_time_s)")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--pack-jobs", type=int, default=1,
                    help="worker processes for the per-family split/pack "
                         "stages (pays on single-topology sweeps; ignored "
                         "when topology-level --jobs parallelism is active)")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--out", default=None,
                    help="output path (default "
                         "BENCH_schedules.torch.json; a partial run — "
                         "--smoke/--names — defaults to "
                         "BENCH_schedules.torch.smoke.json; never the "
                         "committed BENCH_schedules.json)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    names = list(SMOKE_NAMES) if args.smoke else args.names
    if args.out is None:
        args.out = default_out_path(
            partial=names is not None or args.topology is not None
            or args.fixed_k is not None)
    doc = run_sweep(names=names, num_chunks=args.chunks, jobs=args.jobs,
                    cache_dir=args.cache_dir, out_path=args.out,
                    collectives=args.collectives, fixed_k=args.fixed_k,
                    topologies=args.topology, repair=args.repair,
                    pack_jobs=args.pack_jobs)
    for e in doc["entries"]:
        print(f"{e['name']}.{e['kind']},{e['compile_time_s'] * 1e6:.1f},"
              f"inv_x*={e['inv_x_star']};k={e['k']};depth={e['depth']};"
              f"claimed={e['claimed_runtime']};"
              f"achieved/claimed={e['achieved_over_claimed']};"
              f"achieved/lb={e['achieved_over_lb_float']:.4f}", flush=True)
    for e in doc["skipped"]:
        print(f"{e['name']}.{e['kind']},skipped,{e['skipped']}", flush=True)
    for e in doc.get("repair", ()):
        if "skipped" in e:
            print(f"repair {e['name']}.{e['kind']},skipped,{e['skipped']}",
                  flush=True)
        else:
            print(f"repair {e['name']}.{e['kind']} {e['transform']}: "
                  f"repair={e['repair_time_s'] * 1e3:.1f}ms "
                  f"cold={e['cold_compile_time_s'] * 1e3:.1f}ms "
                  f"speedup={e['speedup']}x "
                  f"warm=(solve={e['warm_solve']},split={e['warm_split']}) "
                  f"bytes_equal={e['bytes_equal']}", flush=True)
    bad = claim_mismatches(doc)
    if bad:
        print(f"FAIL: achieved != claimed for {bad}", file=sys.stderr)
        return 1
    bad_repair = repair_mismatches(doc)
    if bad_repair:
        print(f"FAIL: repaired bytes != cold compile for {bad_repair}",
              file=sys.stderr)
        return 1
    print(f"wrote {args.out}: {doc['num_topologies']} topologies x "
          f"{len(doc['collectives'])} collectives = {doc['num_entries']} "
          f"entries ({len(doc['skipped'])} skipped), "
          f"compiler {doc['compiler']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
