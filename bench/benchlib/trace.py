"""The profiler's trace of a steady stretch, reduced to what the per-layer
metrics and the breakdown read.

The profiler records device operations only (CUPTI): recording every host
op as well would slow the eager host path it measures several fold.  Two
marker kernels bound the stretch on the device's clock; the first, launched
right after a sync at a host time the harness notes, maps the harness's own
host spans (``driver.step``, ``engine.decode``, ...) onto that clock.

Device time is the union of every device operation's interval (kernels,
copies, fills) on each card, so overlapping streams count once; the idle
share is what the union leaves of the stretch.  Each idle gap is charged to
the innermost host span open when it began, or to ``harness`` where none
was."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: the marker kernel (``torch.cuda._sleep``) that bounds the stretch
MARK = "spin_kernel"
MARK_CYCLES = 1000


@dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int
    index: int = 0        # the card's index


class Profiler:
    """``torch.profiler`` over device operations, its stretch bounded by
    marker kernels.  Starting the tracer takes seconds on the card, so it
    starts in set-up (a burst of small launches follows: the tracer can
    lose the first events after it starts) and the stretch is marked
    later."""

    def __init__(self, device: str):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        # the CPU rehearsal has no device to trace
        self.prof = (None if device == "cpu"
                     else profile(activities=[ProfilerActivity.CUDA]))
        self.host0 = 0

    def _sync(self) -> None:
        import torch

        if self.device != "cpu":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def start(self) -> None:
        import torch

        if self.prof is not None:
            self.prof.start()
        x = torch.zeros(1, device=self.device)
        for _ in range(16):
            x.add_(1)
        self._sync()

    def mark(self) -> int:
        """Open the stretch; returns its host time."""
        import time

        import torch

        self._sync()
        self.host0 = time.perf_counter_ns()
        if self.prof is not None:
            torch.cuda._sleep(MARK_CYCLES)
        return self.host0

    def stop(self) -> int:
        """Close the stretch and stop tracing; returns the host time the
        stretch closed."""
        import time

        import torch

        self._sync()
        host1 = time.perf_counter_ns()
        if self.prof is not None:
            torch.cuda._sleep(MARK_CYCLES)
            self._sync()
            self.prof.stop()
        return host1

    def events(self) -> List[Event]:
        """Every device operation of the trace."""
        from torch.autograd import DeviceType

        if self.prof is None:
            return []
        return [Event(e.name(), e.start_ns(), e.end_ns(), e.device_index())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _clip(iv: List[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def bounds(events: List[Event], host0: int, host1: int
           ) -> Optional[Tuple[int, int, int]]:
    """(start, end) of the stretch on the device's clock and the shift from
    the host's clock to it, from the marker kernels.  Where the tracer lost
    one marker, the other and the stretch's host length stand in; where it
    lost both, the first operation after the host's mark does (the device
    is idle at the mark, so the next launch starts just after it)."""
    marks = sorted((e for e in events if MARK in e.name),
                   key=lambda e: e.start_ns)
    length = host1 - host0
    if len(marks) >= 2 and marks[-1].start_ns > marks[0].end_ns:
        return marks[0].end_ns, marks[-1].start_ns, marks[0].start_ns - host0
    dev = sorted(e.start_ns for e in events)
    if len(marks) == 1:
        # the stretch's operations lie after the first mark, before the last
        m = marks[0]
        if m.start_ns > dev[len(dev) // 2]:
            return m.start_ns - length, m.start_ns, m.start_ns - host1
        return m.end_ns, m.end_ns + length, m.start_ns - host0
    # the set-up's warm-up launches end before the mark: take the first
    # operation after the widest gap of the trace's first second
    head = [t for t in dev if t < dev[0] + 1_000_000_000]
    gaps = [(b - a, b) for a, b in zip(head, head[1:])]
    lo = max(gaps)[1] if gaps else dev[0]
    return lo, lo + length, lo - host0


def reduce(events: List[Event], cards: int,
           spans: Sequence[Tuple[str, int, int]], host0: int, host1: int,
           top: int = 10) -> Optional[Dict[str, Any]]:
    """``busy_s`` (mean over ``cards``) and each card's, ``window_s``,
    device seconds by operation name (summed over the cards: the work of
    every shard), and idle seconds by host span (mean over the cards) over
    the stretch between the marker kernels.  ``spans`` are (name, start,
    end) on the host's clock, ``host0`` and ``host1`` the host times of the
    stretch's marks.  None when the trace holds no device operation."""
    dev = [e for e in events if MARK not in e.name]
    if not dev:
        return None
    lo, hi, shift = bounds(events, host0, host1)
    by_card: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        if e.end_ns > lo and e.start_ns < hi:
            by_card[e.index].append((e.start_ns, e.end_ns))
            by_name[e.name] += (min(e.end_ns, hi) - max(e.start_ns, lo)) / 1e9
    busy = {i: _clip(union(iv), lo, hi) for i, iv in by_card.items()}
    busy_s = sum(b - a for iv in busy.values() for a, b in iv) / 1e9 / cards
    idle: Dict[str, float] = defaultdict(float)
    host = sorted(((n, a + shift, b + shift) for n, a, b in spans),
                  key=lambda x: (x[1], -x[2]))
    for iv in busy.values():
        edges = [lo] + [x for ab in iv for x in ab] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        for (a, b), name in zip(gaps, _hosts_at(host, [a for a, _ in gaps])):
            idle[name] += (b - a) / 1e9 / cards
    # cards that ran nothing in the stretch were idle all of it
    for _ in range(cards - len(busy)):
        idle["harness"] += (hi - lo) / 1e9 / cards
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e9,
            "busy_by_card": {i: sum(b - a for a, b in iv) / 1e9
                             for i, iv in sorted(busy.items())},
            "device_s": dict(by_name),
            "device_ops": [[n, s] for n, s in rank[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}


def _hosts_at(spans: List[Tuple[str, int, int]], times: List[int]
              ) -> List[str]:
    """For each of the increasing ``times``, the innermost host span open
    then (one thread's nested spans, sorted by start, outer first)."""
    out: List[str] = []
    stack: List[Tuple[str, int, int]] = []
    j = 0
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else "harness")
    return out


def kernel_s(trace: Optional[Dict[str, Any]], key: str) -> float:
    """Device seconds of the operations whose name holds ``key``."""
    if not trace:
        return 0.0
    return sum(s for n, s in trace["device_s"].items() if key in n)
