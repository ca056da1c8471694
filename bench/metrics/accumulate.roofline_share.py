"""Share (%) of the accumulating kernel's device time that the least HBM
traffic of the buckets' reduction would take: each rank's bucket read once
in the wire dtype and each reduced float32 element written once, A x N x
wire + N x 4 bytes for a bucket of N elements a rank over A ranks, summed
over the buckets completed, shared by the cards that reduce it, over the
card's HBM bandwidth, over the device time of `chunk_accum` (the kernel
that adds the payloads today).  Nothing to read where that kernel did not
run.  Moves grad_sync_GBps."""
from bench.peaks import HBM_BYTES_PER_S

KERNEL = "chunk_accum"


def read(run):
    c = run.counters
    if run.trace is None or not c.get("elements"):
        return None
    seconds = run.trace.seconds_of(KERNEL)
    if seconds <= 0:
        return None
    n, a = c["elements"], c["ranks"]
    least = (a * n * c["wire_bytes"] + n * 4) / c["devices"]
    return 100.0 * least / HBM_BYTES_PER_S / seconds
