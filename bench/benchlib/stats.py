"""Percentiles and spreads, by one rule everywhere in the benchmark."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The ``p``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), or None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    if len(xs) == 1:
        return float(xs[0])
    r = (len(xs) - 1) * p / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (r - lo))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, the quartiles as ``statistics.quantiles(values, n=4)`` gives
    them (its default, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
