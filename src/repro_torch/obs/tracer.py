"""Tracer — monotonic-clock spans + instant events, Chrome-trace export.

The span model mirrors the branch tree: every branch gets one **track**
(trace ``tid`` = branch id) carrying one long-lived ``explore`` span
from fork to resolution, and the resolution kind is the span's
``status`` (``committed`` / ``aborted`` / ``invalidated``).  Tracks are
grouped into a **process** per exploration (trace ``pid`` = the root
branch id of the subtree, propagated at fork), so a best-of-N run
renders in Perfetto as one process with N+1 rows and a visible
first-commit-wins cascade.  Engine-wide telemetry (decode steps) lands
on the reserved :data:`ENGINE_TRACK`.

Overhead discipline: the hot-path guard is ONE branch — every recording
method starts with ``if not self.enabled: return`` and allocates
nothing in the disabled case (tests probe this with a counting clock).
The :data:`NULL_TRACER` singleton is what instrumented objects hold
when no tracer was supplied, so instrumentation sites never need a
None check.

Re-entrant close guard: :meth:`end_span` *pops*; if a track has no open
span it returns ``False`` and records nothing.  Lifecycle code uses the
return value to fire resolution instants ("commit", "invalidated")
exactly once per branch, even when a scheduler purge, a lazy -ESTALE
discovery, and an abort-after-ESTALE all race to close the same span.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

#: reserved track for engine-wide events (decode steps); branch ids are >= 0
ENGINE_TRACK = -1


@dataclass
class Span:
    track: int                     # trace tid (branch id, or ENGINE_TRACK)
    name: str
    start_ns: int
    group: int = 0                 # trace pid (exploration root branch id)
    parent: Optional[int] = None   # parent *track* (branch lineage)
    end_ns: Optional[int] = None
    status: str = "open"
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_ns(self) -> int:
        end = self.end_ns if self.end_ns is not None else self.start_ns
        return end - self.start_ns


@dataclass
class Instant:
    track: int
    name: str
    ts_ns: int
    group: int = 0
    args: Dict[str, Any] = field(default_factory=dict)


class Tracer:
    """Per-track span stacks + instant events on one monotonic clock."""

    def __init__(self, enabled: bool = False, *, clock=time.perf_counter_ns):
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock() if enabled else 0
        self._open: Dict[int, List[Span]] = {}
        self._spans: List[Span] = []
        self._instants: List[Instant] = []
        self._group: Dict[int, int] = {}    # track -> pid it belongs to

    # ------------------------------------------------------------------
    # recording (hot path: one branch when disabled)
    # ------------------------------------------------------------------
    def begin_span(self, track: int, name: str, *,
                   parent: Optional[int] = None,
                   group: Optional[int] = None, **args) -> Optional[Span]:
        if not self.enabled:
            return None
        with self._lock:
            if group is None:
                # inherit the exploration process from the parent track;
                # a parentless track roots a new process
                group = self._group.get(parent, track if parent is None
                                        else parent)
            span = Span(track=track, name=name, start_ns=self._clock(),
                        group=group, parent=parent, args=args)
            self._open.setdefault(track, []).append(span)
            self._group[track] = group
            return span

    def end_span(self, track: int, status: str = "ok", **args) -> bool:
        """Close the innermost open span on ``track``.

        Returns ``False`` (recording nothing) when no span is open —
        the re-entrancy guard lifecycle code keys one-shot resolution
        events off.
        """
        if not self.enabled:
            return False
        with self._lock:
            stack = self._open.get(track)
            if not stack:
                return False
            span = stack.pop()
            span.end_ns = self._clock()
            span.status = status
            if args:
                span.args.update(args)
            self._spans.append(span)
            return True

    def instant(self, track: int, name: str, **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._instants.append(Instant(
                track=track, name=name, ts_ns=self._clock(),
                group=self._group.get(track, track), args=args))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def group_of(self, track: int, default: Optional[int] = None):
        return self._group.get(track, default)

    def has_open(self, track: int) -> bool:
        with self._lock:
            return bool(self._open.get(track))

    @property
    def spans(self) -> List[Span]:
        """Closed spans, in close order."""
        with self._lock:
            return list(self._spans)

    @property
    def open_spans(self) -> List[Span]:
        with self._lock:
            return [s for stack in self._open.values() for s in stack]

    @property
    def instants(self) -> List[Instant]:
        with self._lock:
            return list(self._instants)

    def lineage(self) -> Dict[int, Optional[int]]:
        """track -> parent track, over every span ever recorded."""
        with self._lock:
            out: Dict[int, Optional[int]] = {}
            for s in self._spans:
                out.setdefault(s.track, s.parent)
            for stack in self._open.values():
                for s in stack:
                    out.setdefault(s.track, s.parent)
            return out

    # ------------------------------------------------------------------
    # Chrome/Perfetto export
    # ------------------------------------------------------------------
    def export_chrome_trace(self, path=None) -> dict:
        """Write (and return) a Chrome Trace Event JSON object.

        ``pid`` = exploration group (root branch id), ``tid`` = branch
        id, so chrome://tracing / https://ui.perfetto.dev render one
        process per exploration with one row per branch.  Still-open
        spans are flushed with status ``open`` so a mid-run export is
        valid JSON.  Timestamps are microseconds relative to tracer
        construction.
        """
        with self._lock:
            spans = list(self._spans)
            for stack in self._open.values():
                for s in stack:
                    spans.append(Span(
                        track=s.track, name=s.name, start_ns=s.start_ns,
                        group=s.group, parent=s.parent,
                        end_ns=self._clock(), status="open",
                        args=dict(s.args)))
            instants = list(self._instants)
            t0 = self._t0

        def us(ns: int) -> float:
            return round((ns - t0) / 1000.0, 3)

        events: List[dict] = []
        pids = sorted({s.group for s in spans}
                      | {i.group for i in instants})
        tracks = sorted({(s.group, s.track) for s in spans}
                        | {(i.group, i.track) for i in instants})
        for pid in pids:
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": "engine" if pid == ENGINE_TRACK
                                    else f"exploration {pid}"}})
        for pid, tid in tracks:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": "engine" if tid == ENGINE_TRACK
                                    else f"branch {tid}"}})
        for s in spans:
            args = {"status": s.status, **s.args}
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "ph": "X", "cat": "branch", "name": s.name,
                "pid": s.group, "tid": s.track,
                "ts": us(s.start_ns),
                "dur": round(s.duration_ns / 1000.0, 3),
                "args": args,
            })
        for i in instants:
            events.append({
                "ph": "i", "s": "t", "cat": "branch", "name": i.name,
                "pid": i.group, "tid": i.track, "ts": us(i.ts_ns),
                "args": i.args,
            })
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            Path(path).write_text(json.dumps(trace, indent=1))
        return trace


#: shared disabled tracer — what instrumented objects hold by default,
#: so every site is `tracer.enabled`-guarded rather than None-checked.
NULL_TRACER = Tracer(enabled=False)


__all__ = ["ENGINE_TRACK", "Instant", "NULL_TRACER", "Span", "Tracer"]
