"""``repro_torch.api`` — the one syscall-faithful public surface.

The paper's central proposal is a *single* ``branch()`` syscall with
flag-controlled semantics, kernel-enforced sibling isolation, and
first-commit-wins coordination.  This package is that surface for the
serving stack:

* :class:`BranchSession` — handle table (generation-counted, ``-EBADF``
  on stale use), ``open``/``branch``/``commit``/``abort``/``wait``/
  ``poll``/``stat``/``tree``/``finish``/``close`` verbs, vectorized
  ``branch(parent, n=k)`` (one ledger transaction, one fused CoW
  dispatch), atomic multi-domain composition.
* :mod:`flags <repro_torch.api.flags>` — the ``branch()`` flags word:
  ``BR_ISOLATE | BR_HOLD | BR_NESTED | BR_SPECULATIVE | BR_NONBLOCK``.
* :mod:`events <repro_torch.api.events>` — unified eventing: ``EV_*`` bits
  and the epoll-like :class:`Waiter`.
* :class:`Errno` / :class:`BranchError` — one errno discipline shared
  with every lower layer (re-exported from :mod:`repro_torch.core.errors`).

Everything else (``BranchRuntime``'s opcode dispatcher, raw
``Scheduler`` verbs, ``explore_ctx.BranchContext``) is either a thin
deprecated shim over this package or sugar built on top of it — see
DESIGN.md §10 for the syscall ↔ API mapping and the migration table.
"""

from repro_torch.core.errors import (
    AdmissionDenied,
    BadHandleError,
    BranchError,
    BranchStateError,
    Errno,
    FrozenOriginError,
    PoolExhausted,
    StaleBranchError,
)

from repro_torch.api.events import (
    EV_ADMITTED,
    EV_ANY,
    EV_COMMITTED,
    EV_FINISHED,
    EV_INVALIDATED,
    EV_PRODUCED,
    EV_RESOLVED,
    Waiter,
    event_names,
)
from repro_torch.api.flags import (
    BR_ALL,
    BR_HOLD,
    BR_ISOLATE,
    BR_NESTED,
    BR_NONBLOCK,
    BR_SPECULATIVE,
    flag_names,
)
from repro_torch.api.session import BranchSession

__all__ = [
    # the session (the branch() syscall surface)
    "BranchSession",
    # flags word
    "BR_ALL",
    "BR_HOLD",
    "BR_ISOLATE",
    "BR_NESTED",
    "BR_NONBLOCK",
    "BR_SPECULATIVE",
    "flag_names",
    # unified eventing
    "EV_ADMITTED",
    "EV_ANY",
    "EV_COMMITTED",
    "EV_FINISHED",
    "EV_INVALIDATED",
    "EV_PRODUCED",
    "EV_RESOLVED",
    "Waiter",
    "event_names",
    # errno discipline
    "AdmissionDenied",
    "BadHandleError",
    "BranchError",
    "BranchStateError",
    "Errno",
    "FrozenOriginError",
    "PoolExhausted",
    "StaleBranchError",
]
