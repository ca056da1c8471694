#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json as bench/run.py does, with the program's
own spans (`repro_torch.obs`).

    python3 bench/spans_run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

--trace 1: the traced run through `program_spans.ProgramTrace` in place of
the driver's `DeviceTrace`, so the result line's idle gaps name the
innermost span, the program's or the benchmark's, and its `spans` entry
(`program_spans.report`) gives device seconds and operations by program
span, the train step's parts in device ms a step, their partition of the
busy time and the share of operations matched to their launch.  --trace 0:
the untraced run with the recorder on throughout; against bench/run.py's
it gives the recorder's cost.  Prints the same lines as bench/run.py.
"""
import time

T0 = time.perf_counter()        # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench", "cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def main(args, t_start: float) -> int:
    import torch

    from bench import harness, program_spans
    cell = harness.find_cell(harness.load_manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    if trace:
        driver = harness.load_driver(cell.traffic["driver"])
        driver.DeviceTrace = program_spans.ProgramTrace
        res = harness.run_cell(cell, args.seed, args.seconds, True, "cuda",
                               t_start)
    else:
        with program_spans.recording():
            res = harness.run_cell(cell, args.seed, args.seconds, False,
                                   "cuda", t_start)
    line = harness.result_line(cell, res, trace,
                               torch.cuda.get_device_name(0))
    if trace:
        line["spans"] = program_spans.report(res.trace,
                                             res.counters.get("steps", 0))
    print(harness.card_line(), flush=True)
    for text in res.lines:
        print(text, flush=True)
    for name, (value, limit) in res.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    sys.exit(main(ap.parse_args(), T0))
