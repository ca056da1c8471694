"""Device operations (kernels, copies, sets) launched in the traced window
per bucket completed there: the comms layer's host cost shows as launches.
Moves grad_sync_GBps."""


def read(run):
    if run.trace is None or not run.counters.get("buckets"):
        return None
    return run.trace.launches / run.counters["buckets"]
