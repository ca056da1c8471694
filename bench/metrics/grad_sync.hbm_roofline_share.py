"""Share (%) of the card's HBM bandwidth that the least traffic of the
stacked allreduce would take over the traced window: each rank's float32
bucket read once and its float32 result written once, 2 x A x N x 4 bytes
for a bucket of N elements a rank over A ranks, summed over the buckets
completed.  Whatever implements the sync, this bounds a gain.  Only where
every rank is on one card.  Moves grad_sync_GBps."""
from bench.peaks import HBM_BYTES_PER_S


def read(run):
    c = run.counters
    if run.trace is None or not c.get("stacked") or not c.get("elements"):
        return None
    least = 2 * c["ranks"] * c["elements"] * 4
    return 100.0 * least / HBM_BYTES_PER_S / run.trace.window_s
