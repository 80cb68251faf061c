"""Inter-token latency, p95 over every gap between successive tokens of a
branch whose later token came inside the window."""

from benchlib.stats import percentile


def read(run):
    return percentile([g / 1e6 for t, g in run.rec.gaps if run.inside(t)],
                      95)
