"""Share (%) of the traced window in which no operation ran on the card:
1 - (union of the device's busy intervals) / window.  Moves
train_tokens_per_s."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share()
