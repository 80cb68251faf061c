"""repro_torch.obs — zero-dependency tracing + metrics for the branch stack.

One :class:`Observability` hub bundles a :class:`~repro_torch.obs.Metrics`
registry and a :class:`~repro_torch.obs.Tracer`.  Every instrumented object
(`ServeEngine`, `KVBranchManager`, `BranchFS`) creates its **own** hub
by default and shares it downward (engine → KV manager → branch tree
tracer), so tests and concurrent engines never see each other's
counters; pass ``obs=`` to share a hub across layers explicitly, or
``Observability(trace=True)`` to turn span recording on (disabled
tracing is one predicted branch per site).

Process-wide aggregation (``benchmarks/run.py``'s metrics block) goes
through :func:`merged_snapshot`: live hubs are tracked with weak
references — the registry never extends an engine's lifetime — and a
dying hub's final counters are folded into a retired-hub accumulator
via ``weakref.finalize``, so short-lived benchmark engines still show
up in the merged view.  Counters and histograms merge additively;
gauges are last-writer-wins (pool levels don't sum across engines).
"""

from __future__ import annotations

import weakref

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Metrics
from repro_torch.obs.tracer import ENGINE_TRACK, NULL_TRACER, Span, Tracer

_LIVE_HUBS: "weakref.WeakSet" = weakref.WeakSet()
_RETIRED = Metrics()


class Observability:
    """Metrics registry + tracer, shared down one engine/manager stack."""

    def __init__(self, *, trace: bool = False):
        self.metrics = Metrics()
        self.tracer = Tracer(enabled=trace)
        _LIVE_HUBS.add(self)
        weakref.finalize(self, _RETIRED.absorb, self.metrics)


def merged_snapshot() -> dict:
    """Snapshot of every hub this process ever created (live + retired)."""
    acc = Metrics()
    acc.absorb(_RETIRED)
    for hub in list(_LIVE_HUBS):
        acc.absorb(hub.metrics)
    return acc.snapshot()


__all__ = [
    "ENGINE_TRACK",
    "NULL_TRACER",
    "Counter",
    "Gauge",
    "Histogram",
    "Metrics",
    "Observability",
    "Span",
    "Tracer",
    "merged_snapshot",
]
