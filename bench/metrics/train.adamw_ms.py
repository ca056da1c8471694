"""Mean milliseconds of `adamw_update`, timed alone between
synchronizations, over the traced window's steps.  Moves
train_tokens_per_s."""


def read(run):
    times = run.counters.get("adamw_s")
    if run.trace is None or not times:
        return None
    return 1000.0 * sum(times) / len(times)
