"""Unified eventing — an epoll over branch handles.

Every earlier surface had its own blocking model: ``Scheduler.wait``
spun on one request, the exploration driver hand-rolled four wait
classes, and ``BranchRuntime`` had none at all.  This module is the one
replacement: a handle becomes *ready* when the lifecycle kernel, the
scheduler, or the session resolves it, and a :class:`Waiter`
multiplexes any number of handles the way ``epoll_wait(2)`` multiplexes
fds — register interest, poll a ready set, or block (step the
scheduler) until something fires.

Event bits (OR-able, edge-accumulated per handle):

==================  =====================================================
``EV_ADMITTED``     the root request left the FIFO: it has a sequence,
                    pages reserved, and a bound state-domain subtree
``EV_COMMITTED``    this branch won its exclusive group's
                    first-commit-wins race
``EV_INVALIDATED``  this branch lost — a sibling committed (``-ESTALE``),
                    an ancestor aborted, or it was aborted/evicted
``EV_FINISHED``     the root request can produce no more tokens; its
                    result is claimable via ``result()``
``EV_PRODUCED``     a :class:`Waiter` produced-target was met (only
                    reported when a target was registered)
==================  =====================================================
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterable, Optional, Tuple

if TYPE_CHECKING:   # pragma: no cover - import cycle guard
    from repro_torch.api.session import BranchSession

EV_ADMITTED = 1 << 0
EV_COMMITTED = 1 << 1
EV_INVALIDATED = 1 << 2
EV_FINISHED = 1 << 3
EV_PRODUCED = 1 << 4

#: the branch resolved one way or the other
EV_RESOLVED = EV_COMMITTED | EV_INVALIDATED
EV_ANY = EV_ADMITTED | EV_COMMITTED | EV_INVALIDATED | EV_FINISHED

_NAMES = {
    EV_ADMITTED: "EV_ADMITTED",
    EV_COMMITTED: "EV_COMMITTED",
    EV_INVALIDATED: "EV_INVALIDATED",
    EV_FINISHED: "EV_FINISHED",
    EV_PRODUCED: "EV_PRODUCED",
}


def event_names(events: int) -> list:
    """Symbolic names of every set event bit."""
    return [name for bit, name in _NAMES.items() if events & bit]


class Waiter:
    """Readiness multiplexer over session handles (the epoll analogue).

    ``add`` registers interest in a handle — an event mask, optionally a
    *produced target* (ready once the branch has generated that many
    tokens past its fork point, or can never reach it because its
    request budget ran out or it resolved).  ``poll`` returns the ready
    map without side effects; ``wait`` steps the session's scheduler
    until the ready set is non-empty (or every registered handle is
    ready, with ``require_all``), so decode work from everything else
    registered on the same engine keeps flowing while one caller blocks.

    A handle closed underneath the waiter (its exploration finished and
    recycled the slot) reports ``EV_INVALIDATED`` rather than raising —
    exactly how epoll reports ``EPOLLHUP`` instead of failing the wait.
    """

    def __init__(self, session: "BranchSession"):
        self.session = session
        self._interest: Dict[int, Tuple[int, Optional[int]]] = {}

    # ------------------------------------------------------------------
    def add(self, hd: int, events: int = EV_ANY, *,
            produced: Optional[int] = None) -> "Waiter":
        """Register interest; returns self so registrations chain."""
        self._interest[hd] = (events, produced)
        return self

    def remove(self, hd: int) -> None:
        self._interest.pop(hd, None)

    def handles(self) -> Iterable[int]:
        return tuple(self._interest)

    # ------------------------------------------------------------------
    def poll(self) -> Dict[int, int]:
        """The ready map ``{handle: events}`` right now (non-blocking)."""
        from repro_torch.core.errors import BadHandleError

        ready: Dict[int, int] = {}
        for hd, (mask, target) in self._interest.items():
            try:
                got = self.session.events(hd) & (mask | EV_RESOLVED)
                if target is not None and \
                        self.session.decode_target_met(hd, target):
                    got |= EV_PRODUCED
            except BadHandleError:
                got = EV_INVALIDATED   # slot recycled: the branch is gone
            if got:
                ready[hd] = got
        return ready

    def wait(self, timeout_steps: int = 1000, *, require_all: bool = False,
             **decode_kw) -> Dict[int, int]:
        """Block (stepping the scheduler) until the ready set is usable.

        Returns the ready map — possibly empty if ``timeout_steps``
        scheduler rounds elapse first, mirroring ``epoll_wait``'s
        0-return on timeout rather than raising.

        ``session.close()`` wakes every blocked waiter: a closed
        session cannot make further progress, so the wait returns the
        ready-set-so-far immediately instead of stepping a drained
        scheduler until the timeout — the unblock path a serving front
        door's graceful shutdown relies on.
        """
        for _ in range(max(timeout_steps, 1)):
            ready = self.poll()
            if ready and (not require_all
                          or len(ready) == len(self._interest)):
                return ready
            if self.session.closed:
                return ready   # woken by close(): report what fired
            self.session.step(**decode_kw)
        return self.poll()


__all__ = [
    "EV_ADMITTED",
    "EV_ANY",
    "EV_COMMITTED",
    "EV_FINISHED",
    "EV_INVALIDATED",
    "EV_PRODUCED",
    "EV_RESOLVED",
    "Waiter",
    "event_names",
]
