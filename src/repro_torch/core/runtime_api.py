"""``branch()`` analogue — atomic composition of multi-domain branch forks.

The port's copy of ``repro/core/runtime_api.py``.
The paper's central argument for a syscall (§5, Table 3) is *atomic
composition*: forking filesystem state, process groups, and memory in one
call, with kernel-side cleanup on partial failure.  In branchx the state
domains are (a) the host pytree store (≈ BR_FS), (b) device-resident
paged-KV / recurrent state (≈ BR_MEMORY), and (c) whatever additional
domains are attached to the KV manager's lifecycle kernel — e.g. the
serving engine's token tails, which resolve in the same kernel-level
commit (≈ the process group).  ``BranchRuntime.create`` forks all
requested domains or none — any failure unwinds the domains already
forked, mirroring the kernel's cleanup-on-failure guarantee.

``BranchRuntime.commit`` is the cross-domain first-commit-wins arbiter:
it takes the KV kernel's lock for the whole composite commit, verifies
every KV-domain branch is still live, and only then lets the state
store's epoch CAS decide the race — so a commit that loses in *any*
domain loses in *all* of them, and the loser's branches are unwound
rather than left half-committed (no stranded token tails, no leaked
page refcounts; see DESIGN §3).

Flags mirror Listing 1:

* ``BR_STATE``  (paper BR_FS, required) — fork the pytree store.
* ``BR_KV``     (paper BR_MEMORY)       — fork device generation state.
* ``BR_ISOLATE``                        — enforce that a context cannot
  address a sibling's handles (checked at the ``BranchHandle.group``
  accessor, the one API surface exposing siblings; inside one SPMD
  program isolation is otherwise structural).
* ``BR_CLOSE_FDS``                      — drop inherited open handles
  (the context re-opens leaves through its own chain).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.branch import BranchContext
from repro_torch.core.errors import (
    BranchError,
    BranchStateError,
    StaleBranchError,
)
from repro_torch.core.store import BranchStore

# operation codes (paper Listing 1)
BR_CREATE = 0
BR_COMMIT = 1
BR_ABORT = 2

# flags for BR_CREATE
BR_STATE = 1 << 0   # paper: BR_FS (required)
BR_KV = 1 << 1      # paper: BR_MEMORY
BR_ISOLATE = 1 << 2
BR_CLOSE_FDS = 1 << 3


@dataclass
class BranchHandle:
    """What a child receives from ``create``: its view of every domain."""

    index: int                       # 1..N, the paper's branch index
    state: Optional[BranchContext]   # BR_STATE domain
    kv_seqs: Dict[int, int] = field(default_factory=dict)  # parent seq -> forked seq
    flags: int = BR_STATE
    _resolved: bool = False
    _group: Tuple["BranchHandle", ...] = ()

    def _sibling_guard(self, other: "BranchHandle") -> None:
        if self.flags & BR_ISOLATE and other is not self:
            raise BranchError(
                "BR_ISOLATE: sibling branch handles are not addressable"
            )

    @property
    def group(self) -> Tuple["BranchHandle", ...]:
        """Every handle of this BR_CREATE set (the exclusive group).

        This is the API boundary where BR_ISOLATE is enforced: a handle
        created with the flag cannot address its siblings, so accessing
        the group (beyond a singleton, which is just ``self``) raises
        ``BranchError`` — an isolated context only ever holds its own
        view of each domain.
        """
        for h in self._group:
            self._sibling_guard(h)
        return self._group


class BranchRuntime:
    """Composes branch forks across state domains atomically."""

    def __init__(self, store: BranchStore,
                 kv_manager: Optional[Any] = None,
                 kv_fork: Optional[Callable[[int, int], List[int]]] = None):
        self.store = store
        self.kv = kv_manager  # duck-typed: fork(seq, n), commit(seq), abort(seq)
        # Injectable fork path for the KV domain: a serving stack passes
        # ``Scheduler.fork`` here so composite creates go through page-
        # budget admission (AdmissionDenied unwinds the store forks too)
        # instead of bypassing the reservation ledger.
        self.kv_fork = kv_fork or (kv_manager.fork if kv_manager else None)

    @classmethod
    def scheduled(cls, store: BranchStore, scheduler: Any) -> "BranchRuntime":
        """A runtime whose KV domain forks through scheduler admission."""
        return cls(store, scheduler.engine.kv, kv_fork=scheduler.fork)

    # ------------------------------------------------------------------
    def _kv_lock(self) -> contextlib.AbstractContextManager:
        """The KV kernel's lock, if the KV manager exposes one.

        Holding it across a composite commit serializes the cross-domain
        race decision against kernel-level commits on the same tree.
        """
        tree = getattr(self.kv, "tree", None)
        if tree is not None:
            return tree.lock
        return contextlib.nullcontext()

    # ------------------------------------------------------------------
    def create(
        self,
        parent: BranchContext,
        n_branches: int,
        flags: int = BR_STATE,
        kv_seqs: Sequence[int] = (),
    ) -> List[BranchHandle]:
        """BR_CREATE: fork ``n_branches`` contexts across all domains.

        Atomic: on any failure every domain already forked is unwound, so
        the caller never observes a half-created branch set.
        """
        if not flags & BR_STATE:
            raise ValueError("BR_STATE is required (paper: BR_FS required)")
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")

        done: List[Callable[[], None]] = []
        try:
            state_ctxs = parent.fork(n_branches)
            done.append(lambda: [c.abort() for c in state_ctxs if c.is_active])

            kv_maps: List[Dict[int, int]] = [dict() for _ in range(n_branches)]
            if flags & BR_KV:
                if self.kv is None:
                    raise BranchStateError("BR_KV requested but no kv manager")
                for seq in kv_seqs:
                    children = self.kv_fork(seq, n_branches)
                    for i, child_seq in enumerate(children):
                        kv_maps[i][seq] = child_seq
                    done.append(
                        lambda cs=children: [self.kv.abort(c) for c in cs
                                             if self.kv.is_live(c)]
                    )

            handles = [
                BranchHandle(index=i + 1, state=state_ctxs[i],
                             kv_seqs=kv_maps[i], flags=flags)
                for i in range(n_branches)
            ]
            for h in handles:
                h._group = tuple(handles)
            return handles
        except Exception:
            # kernel-side cleanup on failure: unwind in reverse order
            for undo in reversed(done):
                try:
                    undo()
                # best-effort unwind while the original error re-raises
                # below; a failing undo must not mask it
                except Exception:  # pragma: no cover  # branchlint: ignore[BL001]
                    pass
            raise

    # ------------------------------------------------------------------
    def commit(self, handle: BranchHandle) -> int:
        """BR_COMMIT: win the exclusive-group race or raise StaleBranchError.

        Order mirrors §5.2, but the race is decided *once* for the whole
        composite: under the KV kernel's lock we first verify every KV
        branch of this handle is still live (if any lost a kernel-level
        race, this handle lost everywhere — its remaining domains are
        unwound and ``StaleBranchError`` = -ESTALE is raised), then the
        state store's epoch CAS decides the group race, then the KV
        domain (and every domain attached to its kernel, e.g. serving
        token tails) promotes, then siblings are invalidated.
        """
        if handle._resolved:
            raise BranchStateError("handle already resolved")
        assert handle.state is not None
        use_kv = bool(handle.flags & BR_KV) and self.kv is not None
        with self._kv_lock() if use_kv else contextlib.nullcontext():
            if use_kv:
                dead = [c for c in handle.kv_seqs.values()
                        if not self.kv.is_live(c)]
                if dead:
                    # The KV domain already lost a first-commit-wins race:
                    # the composite commit loses atomically.  Unwind the
                    # still-live domains so nothing is stranded.
                    self.abort(handle)
                    raise StaleBranchError(
                        f"KV branches {dead} were invalidated by a sibling "
                        "commit; composite commit loses (-ESTALE)")
                tree = getattr(self.kv, "tree", None)
                if tree is not None:
                    busy = [c for c in handle.kv_seqs.values()
                            if tree.live_children(c)]
                    if busy:
                        # A frozen KV child would pass is_live but fail
                        # its kernel commit; refuse BEFORE the state CAS
                        # so no domain half-commits.
                        raise BranchStateError(
                            f"KV branches {busy} have live children; "
                            "resolve them before the composite commit")
            try:
                parent = handle.state.commit()  # first-commit-wins here
            except StaleBranchError:
                # The state domain lost the group race: the composite
                # commit loses atomically — unwind the KV domain too so
                # no pages or token tails outlive the loser.
                self.abort(handle)
                raise
            if use_kv:
                for parent_seq, child_seq in handle.kv_seqs.items():
                    self.kv.commit(child_seq)
        handle._resolved = True
        return parent

    def abort(self, handle: BranchHandle) -> None:
        """BR_ABORT: discard every domain's delta; siblings stay valid."""
        if handle._resolved:
            return
        if handle.state is not None and handle.state.is_active:
            handle.state.abort()
        if handle.flags & BR_KV and self.kv is not None:
            for child_seq in handle.kv_seqs.values():
                if self.kv.is_live(child_seq):
                    self.kv.abort(child_seq)
        handle._resolved = True

    # ------------------------------------------------------------------
    def __call__(self, op: int, **kwargs: Any) -> Any:
        """Multiplexed entry point in the style of ``bpf(2)`` / Listing 1.

        .. deprecated:: superseded by :class:`repro_torch.api.BranchSession` —
           the one public ``branch()`` surface with a real flags word,
           handle table, errno discipline and poll/wait eventing.  The
           opcode dispatcher remains as a thin shim for existing callers.
        """
        import warnings

        warnings.warn(
            "BranchRuntime(op, ...) opcode dispatch is deprecated; use "
            "repro_torch.api.BranchSession.branch()/commit()/abort() instead",
            DeprecationWarning, stacklevel=2)
        if op == BR_CREATE:
            return self.create(**kwargs)
        if op == BR_COMMIT:
            return self.commit(**kwargs)
        if op == BR_ABORT:
            return self.abort(**kwargs)
        raise ValueError(f"unknown branch() op {op}")


__all__ = [
    "BR_CREATE", "BR_COMMIT", "BR_ABORT",
    "BR_STATE", "BR_KV", "BR_ISOLATE", "BR_CLOSE_FDS",
    "BranchHandle", "BranchRuntime", "StaleBranchError",
]
