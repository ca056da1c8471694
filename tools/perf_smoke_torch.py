#!/usr/bin/env python
"""Perf-smoke gate over the port's compiler copy (`repro_torch.core`):
fail if schedule-compile time regressed more than --factor (default
1.25x, i.e. >25%) vs the committed `BENCH_schedules.json` baseline — in
*total* or in the §2.2 split / §2.3 pack stages individually
(`compile_stats` per-stage seconds), so a regression hiding inside one
stage while another improves still fails.  Counterpart of
tools/perf_smoke.py, with its totals, stage gates, pack and repair gates,
options and exit codes (0 pass, 1 fail, 2 nothing to compare); the fresh
measurement sweeps through `repro_torch.cache.run_sweep`.  It runs on the
CPU.

The gate runs over every (topology, kind) pair shared by the measured and
baseline documents: the default fresh measurement compiles the smoke
topologies plus one scaled-up fabric (`PERF_GATE_NAMES`), and passing a
full sweep document with --measured gates every row it shares with the
baseline — including the large-topology rows.  Per-stage `compile_stats`
of the worst offenders are printed on failure so the regression points at
a stage, not just a number.  The §2.3 pack stage of the topologies in
`PACK_GATE_TOPOS` (the fast-substrate packer's poster children) is gated
on its own (measured, baseline) wall-clock pair as well.

The gate also exercises online schedule repair (`repro_torch.core.repair`): for
every pair in `REPAIR_GATE_PAIRS` — switched fabrics under optimum-
preserving degrades, where the warm solve/split transplant pays — the
repaired artifact must (a) be byte-identical to the cold compile of the
degraded topology and (b) beat it on wall time (``repair_time_s <
cold_compile_time_s``, best-of-N to de-noise), failing the workflow
otherwise.

    python tools/perf_smoke_torch.py                  # run + compare
    python tools/perf_smoke_torch.py --measured BENCH_schedules.torch.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

#: stages gated individually (the two §2.2/§2.3 hot paths); stages whose
#: baseline share is below ABS_FLOOR seconds are not gated individually —
#: a ratio over a near-zero baseline is all timer noise.
GATED_STAGES = ("split", "pack")
ABS_FLOOR = 0.05

#: topologies whose §2.3 pack stage is additionally gated on its own
#: (measured, baseline) wall-clock pair — the pack hot-path poster child
#: must not regress even if the aggregate stage budget would absorb it.
PACK_GATE_TOPOS = ("fattree8p4l2h",)

#: (base spec, transform) pairs the repair gate times: switched topologies
#: under degrades that preserve the base optimum, so the warm transplant +
#: trace replay engages.  Harsh transforms that change (U, k) fall back to
#: cold split by design and are NOT gated on time (only on bytes, via the
#: sweep's --repair section and tests/test_repair.py).
REPAIR_GATE_PAIRS = (
    ("fig1a", "@degrade(0-9,cap=9)"),
    ("multipod:2x4", "@degrade(0-9,cap=9)"),
    ("meshdgx:2x2x4", "@degrade(0-1,cap=3)"),
)


def run_repair_gate(repeats: int = 3, num_chunks: int = 4):
    """Best-of-`repeats` cold vs repair wall time per gated pair.  Returns
    ``[(spec, transform, cold_s, repair_s, bytes_equal), ...]``.  Repair
    runs with verify=False so both sides time exactly the compile pipeline
    (the byte comparison against the verified cold artifact still pins
    correctness)."""
    from repro_torch.cache.serialize import schedule_to_json
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.repair import WARM, repair_schedule
    from repro_torch.topo.spec import TopologySpec, TransformSpec

    def pipeline(g):
        p = plan_mod.plan_for("allgather", g, num_chunks=num_chunks,
                              root=None)
        return plan_mod.emit(plan_mod.rounds(plan_mod.pack(
            plan_mod.split(plan_mod.solve(p)))))

    results = []
    for base_s, tr in REPAIR_GATE_PAIRS:
        base = TopologySpec.parse(base_s).build()
        deg = TransformSpec.parse_text(tr).apply(base)
        best_cold = best_rep = float("inf")
        bytes_equal = True
        for _ in range(repeats):
            WARM.clear()
            art = pipeline(base)            # warms the oracle store
            t0 = time.perf_counter()
            cold = pipeline(deg)
            best_cold = min(best_cold, time.perf_counter() - t0)
            t0 = time.perf_counter()
            rep_art, _ = repair_schedule(art, tr, verify=False)
            best_rep = min(best_rep, time.perf_counter() - t0)
            bytes_equal &= (schedule_to_json(rep_art)
                            == schedule_to_json(cold))
        results.append((base_s, tr, best_cold, best_rep, bytes_equal))
    return results


def gate_names():
    """Topologies the default fresh measurement compiles: the smoke rows
    plus one scaled-up fabric (`repro_torch.cache.PERF_GATE_NAMES`) so the
    large-row hot paths are exercised by the gate too."""
    from repro_torch.cache import PERF_GATE_NAMES
    return tuple(PERF_GATE_NAMES)


def total_compile_time(doc: dict, pairs) -> float:
    """Sum compile_time_s over the given (name, kind) pairs — both sides
    of the comparison must cover the same pairs, or a partial measurement
    would be held against a fuller baseline (or vice versa)."""
    return sum(e["compile_time_s"] for e in doc["entries"]
               if (e["name"], e["kind"]) in pairs)


def stage_total(doc: dict, pairs, stage: str) -> float:
    """Sum one stage's seconds over the given pairs (rows without
    instrumentation contribute 0).  Understands both the BENCH v6
    ``[{stage, seconds, probes, augments}]`` list and the pre-v6
    ``{stage: seconds}`` mapping, so the gate still runs against an older
    committed baseline."""
    total = 0.0
    for e in doc["entries"]:
        if (e["name"], e["kind"]) not in pairs:
            continue
        cs = e.get("compile_stats")
        if isinstance(cs, dict):            # pre-v6 mapping
            total += cs.get(stage, 0.0)
        elif cs:                            # v6 list
            total += sum(row["seconds"] for row in cs
                         if row["stage"] == stage)
    return total


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default=str(REPO / "BENCH_schedules.json"),
                    help="committed sweep scoreboard to compare against")
    ap.add_argument("--measured", default=None,
                    help="an already-emitted sweep JSON; omitted = sweep "
                         "the gate topologies now (jobs=1 for stable "
                         "timing)")
    ap.add_argument("--factor", type=float, default=1.25,
                    help="fail when measured > factor * baseline (total "
                         "and per gated stage)")
    ap.add_argument("--repair-repeats", type=int, default=3,
                    help="best-of-N repeats for the repair gate timings "
                         "(0 skips the repair gate)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch.cache import run_sweep

    baseline_doc = json.loads(Path(args.baseline).read_text())
    if args.measured:
        measured_doc = json.loads(Path(args.measured).read_text())
    else:
        measured_doc = run_sweep(names=gate_names(), jobs=1)

    base_pairs = {(e["name"], e["kind"]) for e in baseline_doc["entries"]}
    pairs = {(e["name"], e["kind"])
             for e in measured_doc["entries"]} & base_pairs
    if not pairs:
        print("perf-smoke: measured document shares no (name, kind) "
              "pairs with the baseline", file=sys.stderr)
        return 2

    failed = []
    checks = [("total", total_compile_time(baseline_doc, pairs),
               total_compile_time(measured_doc, pairs))]
    for stage in GATED_STAGES:
        base = stage_total(baseline_doc, pairs, stage)
        if base < ABS_FLOOR:
            continue
        checks.append((f"stage:{stage}", base,
                       stage_total(measured_doc, pairs, stage)))
    for topo in PACK_GATE_TOPOS:
        topo_pairs = {(n, k) for (n, k) in pairs if n == topo}
        if not topo_pairs:
            continue
        base = stage_total(baseline_doc, topo_pairs, "pack")
        if base < ABS_FLOOR:
            continue
        checks.append((f"pack:{topo}", base,
                       stage_total(measured_doc, topo_pairs, "pack")))
    for label, base, measured in checks:
        budget = args.factor * base
        ok = measured <= budget
        if not ok:
            failed.append(label)
        print(f"perf-smoke[{label}][{'OK' if ok else 'FAIL'}]: "
              f"measured {measured:.3f}s vs baseline {base:.3f}s "
              f"(budget {budget:.3f}s = {args.factor:.2f}x)")
    print(f"perf-smoke: {len(pairs)} (topology, kind) pairs over "
          f"{sorted({n for n, _ in pairs})}")

    if args.repair_repeats > 0:
        for spec, tr, cold_s, rep_s, same in \
                run_repair_gate(repeats=args.repair_repeats):
            ok = same and rep_s < cold_s
            if not ok:
                failed.append(f"repair:{spec}{tr}")
            print(f"perf-smoke[repair:{spec}{tr}]"
                  f"[{'OK' if ok else 'FAIL'}]: repair {rep_s:.3f}s vs "
                  f"cold {cold_s:.3f}s ({rep_s / cold_s:.2f}x) "
                  f"bytes_equal={same}")

    if not failed:
        return 0
    worst = sorted((e for e in measured_doc["entries"]
                    if (e["name"], e["kind"]) in pairs),
                   key=lambda e: -e["compile_time_s"])
    for e in worst[:5]:
        print(f"  {e['name']}.{e['kind']}: {e['compile_time_s']:.3f}s "
              f"stages={e.get('compile_stats')}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
