"""Host milliseconds a driver step spends outside ``engine.decode`` (the
driver, ``BranchSession``, the scheduler, admission's enqueued prefills),
over every step that began inside the window."""


def read(run):
    steps = [(t1 - t0 - d) for t0, t1, d in run.rec.steps if run.inside(t0)]
    return sum(steps) / len(steps) / 1e6 if steps else None
