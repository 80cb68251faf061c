"""The share of the traced stretch in which no device operation ran, the
mean over the cell's cards (the union of every operation's interval)."""


def read(run):
    tr = run.trace
    return 100.0 * (1 - tr["busy_s"] / tr["window_s"]) if tr else None
