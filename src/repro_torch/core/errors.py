"""Branch-context errors — one errno vocabulary for every layer.

The paper's ``branch()`` is a syscall, and syscalls report failure
through *one* errno namespace.  Before this module was unified, the
repro had three error conventions: ``Scheduler`` raised
``AdmissionDenied``, ``KVBranchManager`` raised a bare ``MemoryError``
for pool exhaustion, and ``explore_ctx`` wrapped both in ``BranchError``
subclasses with ``-ESTALE``/``-EAGAIN`` spelled out in prose.  Now every
branch-layer exception derives from :class:`BranchError` and carries a
machine-readable code from the shared :class:`Errno` enum:

=====================  ==========  =======================================
exception              errno       syscall meaning
=====================  ==========  =======================================
BadHandleError         EBADF       stale/closed branch handle (generation
                                   counter mismatch in the handle table)
NoSuchLeafError        ENOENT      chain resolution found nothing
AdmissionDenied        EAGAIN      page-budget backpressure (retryable) —
                                   or ENOSPC when the request can *never*
                                   fit the pool / block table
PoolExhausted          ENOSPC      KV page pool empty mid-operation
BranchStateError       EINVAL      lifecycle misuse (double commit, op on
                                   resolved branch, bad flags)
FrozenOriginError      EAGAIN      write to an origin with live children
StaleBranchError       ESTALE      invalidated by a sibling's commit
=====================  ==========  =======================================

Callers that care about the *code* check ``err.errno``; callers that
care about the *family* catch the subclass.  Both views are one object,
so there is no mapping code to drift.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional


class Errno(IntEnum):
    """The branch layer's errno namespace (values mirror Linux).

    An exception carrying ``Errno.EBADF`` is the library analogue of a
    syscall returning ``-EBADF``; the sign convention is dropped because
    Python signals failure by raising, not by returning negatives.
    """

    EPERM = 1      # operation not permitted (flag forbids it)
    ENOENT = 2     # no such entry (chain resolution)
    EBADF = 9      # stale/unknown branch handle
    EAGAIN = 11    # try again (backpressure, frozen origin)
    EBUSY = 16     # resource busy (live children)
    EINVAL = 22    # lifecycle misuse / bad arguments
    ENOSPC = 28    # page pool can never absorb the request
    ESTALE = 116   # invalidated by a sibling's first-commit win


class BranchError(RuntimeError):
    """Base class for all branch-context errors.

    Every instance carries :attr:`errno` — the subclass default, or an
    explicit override (``AdmissionDenied(msg, errno=Errno.ENOSPC)`` for
    a request that can *never* fit, vs the retryable EAGAIN default).
    """

    default_errno: Errno = Errno.EINVAL

    def __init__(self, *args: object, errno: Optional[Errno] = None):
        super().__init__(*args)
        self.errno: Errno = errno if errno is not None else self.default_errno


class StaleBranchError(BranchError):
    """Raised when operating on a branch invalidated by a sibling's commit.

    The OS analogue is ``-ESTALE`` returned from ``branch(BR_COMMIT)`` to
    every loser of the exclusive commit group, and ``SIGBUS`` delivered to
    mappings of an invalidated branch.
    """

    default_errno = Errno.ESTALE


class FrozenOriginError(BranchError):
    """Raised when writing to a parent that has live child branches.

    The paper freezes the origin while branches exist (filesystem writes
    denied, memory pages read-only returning ``-EAGAIN``); this eliminates
    merge conflicts by construction.
    """

    default_errno = Errno.EAGAIN


class BranchStateError(BranchError):
    """Raised on lifecycle misuse (double commit, op on aborted branch...)."""

    default_errno = Errno.EINVAL


class NoSuchLeafError(BranchError, KeyError):
    """Raised when chain resolution finds no leaf and no tombstone hides one."""

    default_errno = Errno.ENOENT


class BadHandleError(BranchError):
    """Raised when a session handle's generation counter no longer matches.

    The ``-EBADF`` of the branch layer: handles are fd-like integers
    packing a table index with a generation counter, so a handle kept
    across a ``close`` (slot reuse bumps the generation) can never
    silently address the new occupant — it fails here instead.
    """

    default_errno = Errno.EBADF


class AdmissionDenied(BranchError):
    """Raised when admission would overrun the page budget.

    The -EAGAIN of the serving layer: the caller may retry after commits
    or retirements recycle pages.  Requests rejected at ``submit``
    because they can *never* fit carry ``Errno.ENOSPC`` instead — no
    amount of retrying resizes the pool.
    """

    default_errno = Errno.EAGAIN


class PoolExhausted(BranchError, MemoryError):
    """Raised when the KV page pool empties mid-operation (``-ENOSPC``).

    Subclasses :class:`MemoryError` so pre-unification callers that
    caught the pool's bare ``MemoryError`` keep working; new code should
    catch :class:`BranchError` and check ``errno is Errno.ENOSPC``.
    Scheduler admission makes this unreachable for scheduled work — it
    can only fire on raw engine use that bypasses the reservation ledger.
    """

    default_errno = Errno.ENOSPC


__all__ = [
    "AdmissionDenied",
    "BadHandleError",
    "BranchError",
    "BranchStateError",
    "Errno",
    "FrozenOriginError",
    "NoSuchLeafError",
    "PoolExhausted",
    "StaleBranchError",
]
