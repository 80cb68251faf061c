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

A call that may raise records its span through :meth:`Tracer.span`, a
context manager that closes it with whatever is still open above it
(status ``error`` when the call raised), so the track's stack never
mis-nests; its own phases (the engine's decode step, a prefill, a driver
round) are :meth:`Tracer.phase` spans, each ending where the next
begins.  A site writes ``with (tracer.span(...) if tracer.enabled else
NO_SPAN):``, so a disabled tracer costs one branch there too.

Re-entrant close guard: :meth:`end_span` *pops*; if a track has no open
span it returns ``False`` and records nothing.  Lifecycle code uses the
return value to fire resolution instants ("commit", "invalidated")
exactly once per branch, even when a scheduler purge, a lazy -ESTALE
discovery, and an abort-after-ESTALE all race to close the same span.
"""

from __future__ import annotations

import contextlib
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
    phase: bool = False            # opened by Tracer.phase

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
            self._close(span, self._clock(), status)
            if args:
                span.args.update(args)
            return True

    def phase(self, track: int, name: Optional[str], **args
              ) -> Optional[Span]:
        """End the phase open on ``track`` (the innermost span, when this
        method opened it) and open phase ``name`` in its place, at one
        clock reading, so that one call's phases tile it.  ``name=None``
        only ends the open phase.  Returns the new phase's span."""
        if not self.enabled:
            return None
        with self._lock:
            now = self._clock()
            stack = self._open.setdefault(track, [])
            if stack and stack[-1].phase:
                self._close(stack.pop(), now, "ok")
            if name is None:
                return None
            group = self._group.get(track, track)
            span = Span(track=track, name=name, start_ns=now, group=group,
                        args=args, phase=True)
            stack.append(span)
            self._group[track] = group
            return span

    def span(self, track: int, name: str, **args) -> "_Scope":
        """A context manager recording span ``name`` on ``track`` around
        its block; it yields the :class:`Span`."""
        return _Scope(self, track, name, args)

    def _close_through(self, track: int, span: Span, status: str) -> None:
        """Close ``span`` and, first, every span still open above it (its
        last phase, or what an exception left open), at one reading."""
        with self._lock:
            stack = self._open.get(track, [])
            if not any(s is span for s in stack):
                return
            now = self._clock()
            while True:
                top = stack.pop()
                self._close(top, now, status)
                if top is span:
                    break

    def _close(self, span: Span, now: int, status: str) -> None:
        span.end_ns = now
        span.status = status
        self._spans.append(span)

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


class _Scope:
    """:meth:`Tracer.span`'s context manager."""

    def __init__(self, tracer: Tracer, track: int, name: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.track = track
        self.name = name
        self.args = args
        self.opened: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        self.opened = self.tracer.begin_span(self.track, self.name,
                                             **self.args)
        return self.opened

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.opened is not None:
            self.tracer._close_through(
                self.track, self.opened, "ok" if exc_type is None
                else "error")


#: shared disabled tracer — what instrumented objects hold by default,
#: so every site is `tracer.enabled`-guarded rather than None-checked.
NULL_TRACER = Tracer(enabled=False)

#: what a site enters in place of :meth:`Tracer.span` when the tracer is
#: disabled: nothing is allocated, no clock is read, and it yields None
NO_SPAN = contextlib.nullcontext()


__all__ = ["ENGINE_TRACK", "Instant", "NO_SPAN", "NULL_TRACER", "Span",
           "Tracer"]
