"""Milliseconds from a request's submission to its admission
(the engine's ``add_request``), p90 over the window's requests that were
admitted."""

from benchlib.stats import percentile


def read(run):
    waits = [(t.admit_ns - t.submit_ns) / 1e6 for t in run.window_turns()
             if t.admit_ns]
    return percentile(waits, 90)
