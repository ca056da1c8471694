"""Aggregate dry-run JSON records (repro_torch.launch.dryrun --out DIR) into
the roofline table.  Counterpart of src/repro/analysis/report.py.

    PYTHONPATH=src python -m repro_torch.analysis.report DIR
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

from repro_torch.topo.hardware import H100_SXM


def load(dirname: str) -> List[dict]:
    out = []
    for fn in sorted(os.listdir(dirname)):
        if fn.endswith(".json"):
            with open(os.path.join(dirname, fn)) as f:
                out.append(json.load(f))
    return out


def fmt_ms(s: float) -> str:
    return f"{s * 1e3:9.1f}"


def table(records: List[dict], mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | mem/dev GiB | compute ms | memory ms | "
        "collective ms | dominant | useful-FLOPs | roofline-frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    skips = []
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r.get("skip"):
            skips.append(f"| {r['arch']} | {r['shape']} | — skipped: "
                         f"{r['skip']} |")
            continue
        if not r["ok"]:
            lines.append(f"| {r['arch']} | {r['shape']} | FAILED |")
            continue
        rf = r["roofline"]
        mem = r["memory"]["total_per_device"] / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {mem:.2f} "
            f"| {fmt_ms(rf['compute_s'])} | {fmt_ms(rf['memory_s'])} "
            f"| {fmt_ms(rf['collective_s'])} | {rf['dominant']} "
            f"| {rf['useful_flops_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.3f} |")
    return "\n".join(lines + [""] + skips)


def _cell(r: dict) -> str:
    rf = r["roofline"]
    gib = r["memory"]["total_per_device"] / 2 ** 30
    return (f"{rf['dominant']} {rf['compute_s'] * 1e3:.1f} / "
            f"{rf['memory_s'] * 1e3:.1f} / {rf['collective_s'] * 1e3:.1f} "
            f"| {gib:.2f} ({gib * 2 ** 30 / H100_SXM.hbm_bytes:.0%})")


def pair_table(records: List[dict]) -> str:
    """Both meshes of each cell on one row: the dominant term, compute /
    memory / collective ms, and the per-device GiB (its share of the
    card's HBM), then one line of skips and one of failures."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    lines = ["| arch | shape | 16x16: dominant, compute / memory / "
             "collective ms | GiB (HBM) | 2x16x16: dominant, compute / "
             "memory / collective ms | GiB (HBM) |",
             "|---|---|---|---|---|---|"]
    skips, fails = [], []
    for arch, shape in dict.fromkeys((a, s) for a, s, _ in by):
        pair = [by.get((arch, shape, m)) for m in ("16x16", "2x16x16")]
        if all(r is not None and r["ok"] and not r.get("skip")
               for r in pair):
            lines.append(f"| {arch} | {shape} | {_cell(pair[0])} | "
                         f"{_cell(pair[1])} |")
            continue
        for r in pair:
            if r is None:
                continue
            tag = f"{arch}/{shape}/{r['mesh']}"
            if r.get("skip"):
                skips.append(tag)
            elif not r["ok"]:
                fails.append(tag)
            else:
                lines.append(f"| {arch} | {shape} ({r['mesh']} only) | "
                             f"{_cell(r)} | | |")
    return "\n".join(lines + ["", f"SKIP ({len(skips)}): {', '.join(skips)}",
                              f"FAIL ({len(fails)}): {', '.join(fails)}"])


def summary(records: List[dict]) -> Dict[str, int]:
    ok = sum(1 for r in records if r["ok"] and not r.get("skip"))
    skip = sum(1 for r in records if r.get("skip"))
    fail = sum(1 for r in records if not r["ok"])
    return {"ok": ok, "skip": skip, "fail": fail}


def worst_cells(records: List[dict], mesh: str = "16x16", n: int = 5):
    rows = [r for r in records
            if r["mesh"] == mesh and r["ok"] and not r.get("skip")
            and r["roofline"]["compute_s"] > 1e-5]
    rows.sort(key=lambda r: r["roofline"]["roofline_fraction"])
    return rows[:n]


def most_collective_bound(records: List[dict], mesh: str = "16x16", n: int = 5):
    rows = [r for r in records
            if r["mesh"] == mesh and r["ok"] and not r.get("skip")]
    rows.sort(key=lambda r: -(r["roofline"]["collective_s"]
                              / max(r["roofline"]["compute_s"], 1e-9)))
    return rows[:n]


def main() -> None:
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    records = load(d)
    print(f"records: {summary(records)}\n")
    print("## both meshes\n")
    print(pair_table(records))
    print()
    for mesh in ("16x16", "2x16x16"):
        print(f"## mesh {mesh}\n")
        print(table(records, mesh))
        print()
    print("### worst roofline fraction (single-pod)")
    for r in worst_cells(records):
        rf = r["roofline"]
        print(f"  {r['arch']}/{r['shape']}: frac={rf['roofline_fraction']:.3f}"
              f" dominant={rf['dominant']}")
    print("### most collective-bound (single-pod)")
    for r in most_collective_bound(records):
        rf = r["roofline"]
        print(f"  {r['arch']}/{r['shape']}: collective/compute="
              f"{rf['collective_s'] / max(rf['compute_s'], 1e-9):.1f}")


if __name__ == "__main__":
    main()
