#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card at a
cell's own size: the control (a lower precision in the program's place)
and the planted faults.  The benchmark's own runs never run this.

    python3 bench/control.py --workload <cell> --what <what> --seeds 1 2 3 \
        [--seconds 3]

--what, by the cell's driver:
  grad_sync   control     the hook with its bf16 wire (the program's own
                          lower-precision path) at the cell's load
  train_step  control     the reference's steps computed in float8 e4m3
                          (activations, operands, gradients), held to the
                          reference as the run holds the program to it
              half_batch  the program's steps on the first half of each
                          batch's rows, held to the reference on all rows

Prints one JSON line a seed: the numbers the run compares, by name.
"""
import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def grad_sync_control(cell, seed: int, seconds: float, device: str) -> dict:
    from bench import harness
    cell = copy.deepcopy(cell)
    cell.traffic["wire_dtype"] = "bfloat16"
    res = harness.run_cell(cell, seed, seconds, False, device,
                           time.perf_counter())
    return {k: v for k, (v, _) in res.checks.items()}


def train_control(cell, seed: int, seconds: float, device: str) -> dict:
    import torch

    from bench.drivers.train_step import (check_leaves, compare,
                                          reference_steps)
    from bench.harness import RunContext
    ctx = RunContext(cell=cell, seed=seed, seconds=seconds, trace=False,
                     device=device, t_start=0.0)
    dev = torch.device(device)
    return compare(reference_steps(ctx, dev, quant="fp8"),
                   reference_steps(ctx, dev), check_leaves(cell))


def train_half_batch(cell, seed: int, seconds: float, device: str) -> dict:
    from bench import harness
    from repro_torch.train import train_step as ts
    whole = ts.loss_and_grad

    def half(model, params, batch, cfg):
        return whole(model, params, {k: v[:max(1, v.shape[0] // 2)]
                                     for k, v in batch.items()}, cfg)
    ts.loss_and_grad = half
    try:
        res = harness.run_cell(cell, seed, seconds, False, device,
                               time.perf_counter())
    finally:
        ts.loss_and_grad = whole
    return {k: v for k, (v, _) in res.checks.items()}


READINGS = {("grad_sync", "control"): grad_sync_control,
            ("train_step", "control"): train_control,
            ("train_step", "half_batch"): train_half_batch}


def main(argv=None) -> int:
    import torch

    from bench import harness
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("the readings are taken on the cards", file=sys.stderr)
        return 2
    reading = READINGS[(cell.traffic["driver"], args.what)]
    for seed in args.seeds:
        t = time.perf_counter()
        got = reading(cell, seed, args.seconds, "cuda")
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "what": args.what,
                          "seed": seed, "seconds": time.perf_counter() - t,
                          **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
