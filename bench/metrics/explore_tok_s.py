"""Tokens decoded on any branch, greedy or sampled, over the window: every
``engine.decode`` call that returned inside it, over its length."""


def read(run):
    n = sum(b for _, t1, b, *_ in run.rec.decodes if run.inside(t1))
    return n / run.window_s if n else None
