#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the cards of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (`correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, then `checks`),
and the numbers compared for `correct`, each beside its limit, as the last
lines of standard error.  --trace 0 reports the cell's end-to-end metrics,
--trace 1 its per-layer metrics.  Exits non-zero, with no result, without
CUDA or with fewer cards than the cell asks for.
"""
import time

T0 = time.perf_counter()        # set-up counts from the process's start

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench", "cache")
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from bench import harness
    sys.exit(harness.main(parse_args(), T0))
