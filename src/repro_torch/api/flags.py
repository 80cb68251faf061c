"""The ``branch()`` flags word (paper Listing 1, realized for serving).

One integer, OR-able, controlling the semantics of a single
:meth:`BranchSession.branch <repro_torch.api.BranchSession.branch>` call —
exactly the shape of ``clone(2)``'s flags argument:

=================  ======================================================
flag               semantics
=================  ======================================================
``BR_ISOLATE``     kernel-enforced sibling isolation: the handle table
                   refuses to resolve a sibling's handles from an
                   isolated branch (``siblings()`` raises ``-EPERM``)
``BR_HOLD``        children are created *parked*: they keep their page
                   reservations but never decode until ``resume()`` —
                   the exploration driver's pacing primitive
``BR_NESTED``      required to fork a branch that is itself a branch
                   (fork-of-fork, Tree-of-Thoughts); forking a non-root
                   without it is ``-EINVAL``
``BR_SPECULATIVE`` marks the children as speculative drafts: they may
                   be ``truncate()``d to a verified prefix before
                   commit; truncating a non-speculative branch is
                   ``-EPERM``
``BR_NONBLOCK``    page-budget denial returns ``-EAGAIN`` immediately
                   instead of blocking (stepping the scheduler) until
                   other work frees pages
``BR_TIERED``      *stat-only*: reported by ``stat()`` for a branch
                   whose KV is checkpointed out of the device pool
                   (``session.checkpoint``); never accepted by
                   ``branch()`` — tiering is a runtime state, not a
                   creation mode
=================  ======================================================

These are session-level flags and intentionally a *different* namespace
from the low-level :mod:`repro_torch.core.runtime_api` domain flags
(``BR_STATE``/``BR_KV``): the session always forks every attached
domain atomically, so the caller only ever chooses *behaviour*, never
which domains stay consistent.
"""

from __future__ import annotations

BR_ISOLATE = 1 << 0
BR_HOLD = 1 << 1
BR_NESTED = 1 << 2
BR_SPECULATIVE = 1 << 3
BR_NONBLOCK = 1 << 4
BR_TIERED = 1 << 5

_NAMES = {
    BR_ISOLATE: "BR_ISOLATE",
    BR_HOLD: "BR_HOLD",
    BR_NESTED: "BR_NESTED",
    BR_SPECULATIVE: "BR_SPECULATIVE",
    BR_NONBLOCK: "BR_NONBLOCK",
    BR_TIERED: "BR_TIERED",
}

# BR_TIERED is stat-only, so it is deliberately NOT part of BR_ALL (the
# mask of flags branch() accepts).
BR_ALL = BR_ISOLATE | BR_HOLD | BR_NESTED | BR_SPECULATIVE | BR_NONBLOCK


def flag_names(flags: int) -> list:
    """Symbolic names of every set flag (procfs-style ``stat()`` output)."""
    return [name for bit, name in _NAMES.items() if flags & bit]


__all__ = [
    "BR_ALL",
    "BR_HOLD",
    "BR_ISOLATE",
    "BR_NESTED",
    "BR_NONBLOCK",
    "BR_SPECULATIVE",
    "BR_TIERED",
    "flag_names",
]
