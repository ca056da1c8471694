"""The benchmark's harness: it finds a cell's configuration, traffic mix,
driver and per-layer metric readers by name, runs the cell, and prints the
result line.

A cell of BENCHMARK.json names a configuration (`configs[].file`, a JSON
file of sizes whose `reference` key names its plain reference under
`bench/reference/`) and a traffic mix (`bench/traffic/<traffic>.json`,
whose `driver` key names the general generator under `bench/drivers/`).
A per-layer metric is read by `bench/metrics/<name>.py`'s `read(run)`,
which returns a number or None (nothing to read: the metric is left out).
A later cell, mix or metric is new files and new BENCHMARK.json entries.

A driver's `run(ctx: RunContext) -> RunResult` makes the inputs from the
seed, warms up, runs the window for `ctx.seconds`, then checks what the
window produced against the plain reference (`RunResult.checks`: name ->
(number, limit); the run is correct when every number is finite and at
most its limit).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .trace import TraceSummary

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODULE = re.compile(r"^[a-z][a-z0-9_]*$")
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration's file
    traffic: Dict[str, Any]         # the traffic mix's file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


@dataclasses.dataclass
class RunContext:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str                     # "cuda"; the CPU tests pass "cpu"
    t_start: float                  # perf_counter at the process's start


@dataclasses.dataclass
class RunResult:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    counters: Dict[str, Any]
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    window_s: float
    trace: Optional[TraceSummary] = None
    lines: List[str] = dataclasses.field(default_factory=list)
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= limit
            for v, limit in self.checks.values())


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _checked(name: str, what: str, pattern=NAME) -> str:
    if not pattern.match(name):
        raise ValueError(f"{what} name {name!r} is not allowed")
    return name


def load_traffic(name: str) -> Dict[str, Any]:
    path = BENCH / "traffic" / f"{_checked(name, 'traffic')}.json"
    return json.loads(path.read_text())


def _applies(metric: Dict[str, Any], cell: str,
             moves_in: Optional[List[str]] = None) -> bool:
    """A metric with a `workloads` key is the listed cells'; an end-to-end
    one without it every cell's, a per-layer one without it the cells
    that report the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_in is None or metric["moves"] in moves_in


def find_cell(manifest: Dict[str, Any], name: str,
              root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_traffic(w["traffic"]), end_to_end=e2e,
                per_layer=per_layer)


def load_driver(name: str):
    return importlib.import_module(
        f"bench.drivers.{_checked(name, 'driver', MODULE)}")


def load_reference(name: str):
    return importlib.import_module(
        f"bench.reference.{_checked(name, 'reference', MODULE)}")


def load_reader(metric: str) -> Callable[[RunResult], Optional[float]]:
    path = BENCH / "metrics" / f"{_checked(metric, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> RunResult:
    ctx = RunContext(cell=cell, seed=seed, seconds=seconds, trace=trace,
                     device=device, t_start=t_start)
    res = load_driver(cell.traffic["driver"]).run(ctx)
    res.config = cell.config
    return res


def metrics_of(cell: Cell, res: RunResult, trace: bool
               ) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (trace off) or its per-layer metrics
    that have something to read (trace on), each with its unit."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(res) if trace \
            else res.end_to_end[m["name"]]
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def result_line(cell: Cell, res: RunResult, trace: bool,
                device_kind: str) -> Dict[str, Any]:
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    line: Dict[str, Any] = {
        "correct": res.correct, "attempted": res.attempted,
        "failed": res.failed, "metrics": metrics_of(cell, res, trace),
        "device": device}
    if trace:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
        line["breakdown"] = {"device_ops": res.trace.top_ops(),
                             "idle_gaps": res.trace.top_idle()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res.checks.items()}
    return line


def card_line() -> str:
    """The cards' names and power limits, which the peaks assume at 700 W."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"cards: nvidia-smi failed ({e})"
    return "cards: " + "; ".join(x.strip() for x in out.splitlines())


def main(args, t_start: float) -> int:
    import torch
    importlib.import_module("repro_torch")     # the program under test
    cell = find_cell(load_manifest(), args.workload)
    if not torch.cuda.is_available():
        print("CUDA is not available: the benchmark runs on the cards",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that may not be loaded are loaded: {bad}",
              file=sys.stderr)
        return 3
    line = result_line(cell, res, bool(args.trace),
                       torch.cuda.get_device_name(0))
    print(card_line(), flush=True)
    for text in res.lines:
        print(text, flush=True)
    for name, (value, limit) in res.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
