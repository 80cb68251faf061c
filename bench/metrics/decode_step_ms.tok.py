"""Milliseconds of one ``engine.decode`` call (the step ends in the host's
read of its tokens, which waits for the device), the mean over every call
that began inside the window."""


def read(run):
    calls = [t1 - t0 for t0, t1, *_ in run.rec.decodes if run.inside(t0)]
    return sum(calls) / len(calls) / 1e6 if calls else None
