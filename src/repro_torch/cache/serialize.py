"""Exact JSON (de)serialization of compiled pipeline schedules.
Counterpart of src/repro/cache/serialize.py: the payloads are byte-identical
to the reference's, format names included.

Design rules:

* **Exact arithmetic** — every rational is encoded as `str(Fraction)`
  ("3/4", "1") and decoded back through `Fraction(str)`; round-tripping is
  loss-free, so "equals the claimed optimum" stays an `==` check.
* **Byte stability** — `dumps_canonical` emits sorted-key, tight-separator
  JSON with a trailing newline; serialize(deserialize(text)) == text, which
  the golden-schedule regression tests pin down.
* **Order fidelity** — tree-class vertex/edge addition order, round order,
  intra-round send order and per-edge path-allocation order are semantic
  (the simulator indexes capacity units by position), so those stay lists
  in original order; unordered maps (capacities, routing, path keys) are
  sorted for canonical output.

The artifact carries the compiler's *claimed* exact runtime (data_size=1)
so a consumer can re-simulate a loaded schedule and check achieved ==
claimed without recompiling anything.
"""
from __future__ import annotations

import json
from fractions import Fraction
from typing import Any, Dict, List, Tuple

from repro_torch.core.arborescence import TreeClass
from repro_torch.core.edge_split import SplitResult
from repro_torch.core.graph import DiGraph, Edge
from repro_torch.core.optimality import Optimality
from repro_torch.core.plan import CompileStats
from repro_torch.core.schedule import AllReduceSchedule, PipelineSchedule, Send

from .fingerprint import FORMAT_VERSION

SCHEDULE_FORMAT = "repro.schedule"
ALLREDUCE_FORMAT = "repro.allreduce"
STATS_FORMAT = "repro.compile_stats"
REPAIR_FORMAT = "repro.repair"
# Version of the *cache directory* schema (artifact payloads live at
# FORMAT_VERSION): v3 adds the per-artifact compile-stats sidecar and the
# flock-guarded index.  v5 adds transform-keyed `.repair` sidecars: a
# repaired artifact is stored under its natural (degraded-topology) key,
# and a `repair-...` sidecar keyed by base fingerprint + transform records
# `repair_time_s` and points at that artifact.  Readers accept older
# directories (no sidecar → no repair metadata).  v6 rides the artifact
# FORMAT_VERSION 2 → 3 bump (the kind vocabulary grew `alltoall`); the
# directory layout itself is unchanged.
CACHE_SCHEMA_VERSION = 6

# every kind a `repro.schedule` payload may carry (allreduce artifacts are
# the nested `repro.allreduce` format: an rs + an ag payload)
SCHEDULE_KINDS = ("allgather", "reduce_scatter", "broadcast", "reduce",
                  "alltoall")


class SerializationError(ValueError):
    pass


# ---------------------------------------------------------------------- #
# primitives
# ---------------------------------------------------------------------- #

def _enc_frac(f: Fraction) -> str:
    return str(Fraction(f))


def _dec_frac(s: str) -> Fraction:
    return Fraction(s)


def _enc_graph(g: DiGraph) -> Dict[str, Any]:
    return {
        "name": g.name,
        "num_nodes": g.num_nodes,
        "compute": sorted(g.compute),
        "cap": [[u, v, c] for (u, v), c in sorted(g.cap.items())],
    }


def _dec_graph(d: Dict[str, Any]) -> DiGraph:
    return DiGraph(d["num_nodes"], frozenset(d["compute"]),
                   {(u, v): c for u, v, c in d["cap"]}, d["name"])


# ---------------------------------------------------------------------- #
# schedule payloads
# ---------------------------------------------------------------------- #

def ensure_claimed(sched: PipelineSchedule, verify: bool = False) -> Fraction:
    """Fill (and return) the schedule's claimed exact runtime at data_size=1
    by running the round-accurate simulator once."""
    if sched.claimed_runtime is None:
        from repro_torch.core import simulate as sim
        fn = {"allgather": sim.simulate_allgather,
              "reduce_scatter": sim.simulate_reduce_scatter,
              "broadcast": sim.simulate_broadcast,
              "reduce": sim.simulate_reduce,
              "alltoall": sim.simulate_alltoall}[sched.kind]
        sched.claimed_runtime = fn(sched, verify=verify).sim_time
    return sched.claimed_runtime


def schedule_to_payload(sched: PipelineSchedule,
                        verify: bool = False) -> Dict[str, Any]:
    claimed = ensure_claimed(sched, verify=verify)
    return {
        "format": SCHEDULE_FORMAT,
        "version": FORMAT_VERSION,
        "kind": sched.kind,
        "root": sched.root,
        "num_chunks": sched.num_chunks,
        "claimed_runtime": _enc_frac(claimed),
        "opt": {"inv_x_star": _enc_frac(sched.opt.inv_x_star),
                "U": _enc_frac(sched.opt.U), "k": sched.opt.k},
        "topo": _enc_graph(sched.topo),
        "dstar": _enc_graph(sched.dstar),
        "split": {
            "k": sched.split.k,
            "graph": _enc_graph(sched.split.graph),
            "original": _enc_graph(sched.split.original),
            "routing": [[u, t, sorted((w, c) for w, c in via.items())]
                        for (u, t), via in sorted(sched.split.routing.items())],
        },
        "classes": [{"root": c.root, "mult": c.mult, "verts": list(c.verts),
                     "edges": [[a, b] for a, b in c.edges]}
                    for c in sched.classes],
        "class_slot_offset": list(sched.class_slot_offset),
        "rounds": [[[s.src, s.dst, s.root, s.slot, s.cls] for s in rnd]
                   for rnd in sched.rounds],
        "path_assignment": [
            [cls, [e[0], e[1]], [[list(path), units] for path, units in alloc]]
            for (cls, e), alloc in sorted(sched.path_assignment.items())],
    }


def payload_to_schedule(d: Dict[str, Any]) -> PipelineSchedule:
    if d.get("format") != SCHEDULE_FORMAT:
        raise SerializationError(f"not a schedule payload: {d.get('format')!r}")
    if d.get("version") != FORMAT_VERSION:
        raise SerializationError(
            f"schedule format version {d.get('version')} != {FORMAT_VERSION}")
    if d.get("kind") not in SCHEDULE_KINDS:
        raise SerializationError(f"unknown schedule kind {d.get('kind')!r}")
    opt = Optimality(inv_x_star=_dec_frac(d["opt"]["inv_x_star"]),
                     U=_dec_frac(d["opt"]["U"]), k=d["opt"]["k"])
    sp = d["split"]
    split = SplitResult(
        graph=_dec_graph(sp["graph"]),
        routing={(u, t): {w: c for w, c in via}
                 for u, t, via in sp["routing"]},
        original=_dec_graph(sp["original"]),
        k=sp["k"])
    classes = [TreeClass(root=c["root"], mult=c["mult"],
                         verts=list(c["verts"]),
                         edges=[(a, b) for a, b in c["edges"]])
               for c in d["classes"]]
    rounds: List[List[Send]] = [
        [Send(src=s[0], dst=s[1], root=s[2], slot=s[3], cls=s[4])
         for s in rnd] for rnd in d["rounds"]]
    paths: Dict[Tuple[int, Edge], List[Tuple[Tuple[int, ...], int]]] = {
        (cls, (e[0], e[1])): [(tuple(path), units) for path, units in alloc]
        for cls, e, alloc in d["path_assignment"]}
    return PipelineSchedule(
        kind=d["kind"], topo=_dec_graph(d["topo"]),
        dstar=_dec_graph(d["dstar"]), opt=opt, classes=classes, split=split,
        num_chunks=d["num_chunks"], rounds=rounds,
        class_slot_offset=list(d["class_slot_offset"]),
        path_assignment=paths,
        claimed_runtime=_dec_frac(d["claimed_runtime"]))


def allreduce_to_payload(ar: AllReduceSchedule,
                         verify: bool = False) -> Dict[str, Any]:
    return {"format": ALLREDUCE_FORMAT, "version": FORMAT_VERSION,
            "rs": schedule_to_payload(ar.rs, verify=verify),
            "ag": schedule_to_payload(ar.ag, verify=verify)}


def payload_to_allreduce(d: Dict[str, Any]) -> AllReduceSchedule:
    if d.get("format") != ALLREDUCE_FORMAT:
        raise SerializationError(f"not an allreduce payload: {d.get('format')!r}")
    return AllReduceSchedule(rs=payload_to_schedule(d["rs"]),
                             ag=payload_to_schedule(d["ag"]))


# ---------------------------------------------------------------------- #
# compile-stats sidecar (cache schema v3)
# ---------------------------------------------------------------------- #

def stats_to_payload(art) -> Dict[str, Any]:
    """The `{key}.stats` sidecar payload for an artifact, or None when the
    artifact carries no per-stage instrumentation (e.g. it was built by a
    pre-v3 compiler or deserialized from a v2 cache directory)."""
    if isinstance(art, AllReduceSchedule):
        rs, ag = art.rs.compile_stats, art.ag.compile_stats
        if rs is None and ag is None:
            return None
        return {"format": STATS_FORMAT, "version": CACHE_SCHEMA_VERSION,
                "kind": "allreduce",
                "rs": rs.to_dict() if rs else None,
                "ag": ag.to_dict() if ag else None}
    if art.compile_stats is None:
        return None
    return {"format": STATS_FORMAT, "version": CACHE_SCHEMA_VERSION,
            "kind": art.kind, "stats": art.compile_stats.to_dict()}


def attach_stats(art, payload: Dict[str, Any]) -> None:
    """Re-attach a stats sidecar payload to a deserialized artifact (a
    malformed sidecar is ignored — stats are diagnostics, never needed for
    correctness)."""
    try:
        if payload.get("format") != STATS_FORMAT:
            return
        if isinstance(art, AllReduceSchedule):
            if payload.get("rs"):
                art.rs.compile_stats = CompileStats.from_dict(payload["rs"])
            if payload.get("ag"):
                art.ag.compile_stats = CompileStats.from_dict(payload["ag"])
        elif payload.get("stats"):
            art.compile_stats = CompileStats.from_dict(payload["stats"])
    except (KeyError, TypeError, ValueError):
        return


# ---------------------------------------------------------------------- #
# canonical text form
# ---------------------------------------------------------------------- #

def dumps_canonical(payload: Dict[str, Any]) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":")) + "\n"


def schedule_to_json(sched: PipelineSchedule, verify: bool = False) -> str:
    return dumps_canonical(schedule_to_payload(sched, verify=verify))


def schedule_from_json(text: str) -> PipelineSchedule:
    return payload_to_schedule(json.loads(text))


def allreduce_to_json(ar: AllReduceSchedule, verify: bool = False) -> str:
    return dumps_canonical(allreduce_to_payload(ar, verify=verify))


def allreduce_from_json(text: str) -> AllReduceSchedule:
    return payload_to_allreduce(json.loads(text))
