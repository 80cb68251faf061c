"""Typed metrics registry — counters, gauges, log-bucketed histograms.

Zero-dependency and process-local.  Every instrument is get-or-create
by name through one :class:`Metrics` registry; a name is bound to
exactly one kind (asking for ``counter("x")`` after ``gauge("x")`` is a
programming error and raises).  The registry is what
``ServeEngine.stats()`` / ``BranchSession.stat(metrics=True)`` /
``benchmarks/run.py`` snapshot, and what the ad-hoc serving counters
(``cow_dispatches`` et al.) became views over.

Design points
-------------
* **Counters** only go up (``inc``).  **Gauges** are set to the latest
  value (``set``); pool-utilization style gauges are updated at the
  mutation site, never via closures over the owning object, so a
  retained ``Metrics`` never pins an engine or a device pool alive.
* **Histograms** use *fixed log-spaced buckets*: bucket ``i`` holds
  observations ``<= lo * growth**i``, plus one overflow bucket.  With
  the defaults (``lo=1.0, growth=2.0, n=40``) the range covers 1 unit
  to ~5.5e11 units — microsecond latencies from sub-µs to ~6 days.
  Percentiles are read from the cumulative bucket counts (upper-bound
  estimate), which is exact enough for p50/p90/p99 trend lines and
  costs O(n_buckets) only at snapshot time; ``observe`` is one bisect
  plus four scalar updates.
* ``snapshot()`` returns plain dicts (JSON-ready for BENCH_*.json);
  ``format()`` returns the procfs-style text block used by
  ``session.format_tree(metrics=True)`` and the ``--trace`` demos.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing count (events, faults, dispatches)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: Number = 1) -> None:
        self._value += n

    @property
    def value(self) -> Number:
        return self._value


class Gauge:
    """Last-set value (pool levels, reservation ledgers, byte totals)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def set(self, v: Number) -> None:
        self._value = v

    def add(self, d: Number) -> None:
        self._value += d

    @property
    def value(self) -> Number:
        return self._value


class Histogram:
    """Fixed log-spaced buckets: bucket ``i`` counts ``v <= lo*growth**i``.

    One extra overflow bucket catches everything beyond the last bound.
    ``percentile(p)`` returns the upper bound of the bucket containing
    the p-th observation (``max`` for the overflow bucket), from the
    cumulative counts — no per-observation storage.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, *, lo: float = 1.0, growth: float = 2.0,
                 buckets: int = 40):
        if lo <= 0 or growth <= 1.0 or buckets < 1:
            raise ValueError("need lo > 0, growth > 1, buckets >= 1")
        self.name = name
        self.bounds: List[float] = [lo * growth ** i for i in range(buckets)]
        self.counts: List[int] = [0] * (buckets + 1)   # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, v: Number) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, p: float) -> float:
        """Upper-bound estimate of the p-th percentile, p in [0, 100]."""
        if self.count == 0:
            return 0.0
        target = max(1, -(-self.count * p // 100))   # ceil
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i >= len(self.bounds):
                    return self.max
                # bucket upper bound, capped at the true max so the
                # p50 <= p99 <= max ordering always holds
                return min(self.bounds[i], self.max)
        return self.max

    def snapshot(self) -> dict:
        snap = {
            "count": self.count,
            "sum": round(self.sum, 3),
            "min": 0.0 if self.count == 0 else round(self.min, 3),
            "max": round(self.max, 3),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }
        nonzero = {f"{self.bounds[i]:g}" if i < len(self.bounds) else "inf": c
                   for i, c in enumerate(self.counts) if c}
        if nonzero:
            snap["buckets"] = nonzero
        return snap


class Metrics:
    """Get-or-create instrument registry with JSON + procfs export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: dict, others: List[dict], name: str, make):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                if any(name in o for o in others):
                    raise TypeError(
                        f"metric {name!r} already registered as a "
                        "different kind")
                inst = table[name] = make()
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, [self._gauges, self._histograms],
                         name, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, [self._counters, self._histograms],
                         name, lambda: Gauge(name))

    def histogram(self, name: str, *, lo: float = 1.0, growth: float = 2.0,
                  buckets: int = 40) -> Histogram:
        return self._get(
            self._histograms, [self._counters, self._gauges], name,
            lambda: Histogram(name, lo=lo, growth=growth, buckets=buckets))

    # ------------------------------------------------------------------
    # merge / export
    # ------------------------------------------------------------------
    def absorb(self, other: "Metrics") -> None:
        """Fold another registry into this one (cross-hub aggregation).

        Counters and histograms are additive; gauges take the other's
        value (last-writer-wins — per-pool levels do not sum
        meaningfully across engines, so ``merged_snapshot`` documents
        gauges as per-hub latest).
        """
        with other._lock:
            counters = list(other._counters.values())
            gauges = list(other._gauges.values())
            histograms = list(other._histograms.values())
        for c in counters:
            self.counter(c.name).inc(c.value)
        for g in gauges:
            self.gauge(g.name).set(g.value)
        for h in histograms:
            mine = self.histogram(h.name)
            if mine.bounds != h.bounds:      # geometry mismatch: refit
                for i, c in enumerate(h.counts):
                    if c:
                        v = h.bounds[i] if i < len(h.bounds) else h.max
                        for _ in range(c):
                            mine.observe(v)
                continue
            for i, c in enumerate(h.counts):
                mine.counts[i] += c
            mine.count += h.count
            mine.sum += h.sum
            if h.count:
                mine.min = min(mine.min, h.min)
                mine.max = max(mine.max, h.max)

    def snapshot(self) -> dict:
        """JSON-ready dict: the metrics block of ``BENCH_*.json``."""
        with self._lock:
            return {
                "counters": {n: c.value
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g.value
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h.snapshot()
                               for n, h in sorted(self._histograms.items())},
            }

    def format(self) -> str:
        """Procfs-style text block (one instrument per line)."""
        snap = self.snapshot()
        lines = []
        for n, v in snap["counters"].items():
            lines.append(f"counter {n} {v}")
        for n, v in snap["gauges"].items():
            lines.append(f"gauge   {n} {v:g}" if isinstance(v, float)
                         else f"gauge   {n} {v}")
        for n, h in snap["histograms"].items():
            lines.append(
                f"hist    {n} count={h['count']} sum={h['sum']:g} "
                f"p50={h['p50']:g} p90={h['p90']:g} p99={h['p99']:g} "
                f"max={h['max']:g}")
        return "\n".join(lines)


__all__ = ["Counter", "Gauge", "Histogram", "Metrics"]
