"""Model FLOPs utilisation (%) of the traced window's steps: the frozen
count of a step's model FLOPs (bench/flops.py) times the steps completed,
over the window, over the card's dense bf16 peak (989 TFLOP/s at 700 W;
the run prints the card's power limit).  Moves train_tokens_per_s."""
from bench.flops import train_step_flops
from bench.peaks import PEAK_FLOPS_BF16


def read(run):
    c = run.counters
    if run.trace is None or not c.get("steps"):
        return None
    flops = train_step_flops(run.config, c["batch"], c["seq"]) * c["steps"]
    return 100.0 * flops / run.trace.window_s / PEAK_FLOPS_BF16
