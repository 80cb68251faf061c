"""Time to first token, p90 over every request submitted in the window:
from then to the first token of any of its branches.  A request that got
none by the drain's end counts that end."""

from benchlib.stats import percentile


def read(run):
    due = run.window_turns()
    if not due:
        return None
    end = max(t1 for _, t1, *_ in run.rec.decodes)
    return percentile([((t.first_ns or end) - t.submit_ns) / 1e6
                       for t in due], 90)
