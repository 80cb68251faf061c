"""Prefix-cache lookups that hit, as a share of all lookups in the window
(the engine's ``kv.prefix_hits`` and ``kv.prefix_misses`` counters)."""


def read(run):
    hits = run.counters["kv.prefix_hits"]
    n = hits + run.counters["kv.prefix_misses"]
    return 100.0 * hits / n if n else None
