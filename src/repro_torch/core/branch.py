"""BranchContext — the object-level lifecycle API over :class:`BranchStore`.

The port's copy of ``repro/core/branch.py``.
A ``BranchContext`` is the paper's branch context (§3.1): an isolated view
of state following the fork/explore/commit lifecycle.  It wraps one node
of a :class:`BranchStore` and adds:

* context-manager semantics — leaving the ``with`` block without a commit
  aborts the branch (no side effects escape, R2);
* pytree snapshot/restore helpers for training states;
* nested forking (R3).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

from repro_torch.core.errors import BranchStateError
from repro_torch.core.store import BranchStatus, BranchStore


class BranchContext:
    """One branch context bound to a store node."""

    def __init__(self, store: BranchStore, branch_id: int):
        self.store = store
        self.branch_id = branch_id
        self._resolved = False

    # -- lifecycle ------------------------------------------------------
    def fork(self, n: int = 1) -> List["BranchContext"]:
        """Fork ``n`` child contexts (this context becomes a frozen origin)."""
        return [
            BranchContext(self.store, bid)
            for bid in self.store.fork(self.branch_id, n=n)
        ]

    def commit(self) -> int:
        """First-commit-wins atomic commit to the immediate parent."""
        parent = self.store.commit(self.branch_id)
        self._resolved = True
        return parent

    def abort(self) -> None:
        self.store.abort(self.branch_id)
        self._resolved = True

    @property
    def status(self) -> BranchStatus:
        return self.store.status(self.branch_id)

    @property
    def is_active(self) -> bool:
        return self.status is BranchStatus.ACTIVE

    # -- namespace ------------------------------------------------------
    def read(self, path: str) -> Any:
        return self.store.read(self.branch_id, path)

    def write(self, path: str, value: Any) -> None:
        self.store.write(self.branch_id, path, value)

    def write_many(self, items: Mapping[str, Any]) -> None:
        self.store.write_many(self.branch_id, items)

    def delete(self, path: str) -> None:
        self.store.delete(self.branch_id, path)

    def listdir(self) -> List[str]:
        return self.store.listdir(self.branch_id)

    def exists(self, path: str) -> bool:
        return self.store.exists(self.branch_id, path)

    # -- pytree helpers ---------------------------------------------------
    def snapshot(self, tree: Any, prefix: str = "") -> None:
        self.store.snapshot_pytree(self.branch_id, tree, prefix)

    def restore(self, like: Any, prefix: str = "") -> Any:
        return self.store.restore_pytree(self.branch_id, like, prefix)

    def consolidated_view(self) -> Dict[str, Any]:
        return self.store.consolidated_view(self.branch_id)

    # -- context manager --------------------------------------------------
    def __enter__(self) -> "BranchContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._resolved and self.is_active:
            # Leaving the scope without commit == abort: no side effects
            # escape an unresolved branch (R2).
            try:
                self.abort()
            except BranchStateError:
                pass
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"BranchContext(id={self.branch_id}, status={self.status.value})"


def root_context(store: Optional[BranchStore] = None,
                 base: Optional[Mapping[str, Any]] = None) -> BranchContext:
    """Create a store (if needed) and return its root context."""
    if store is None:
        store = BranchStore(base)
    return BranchContext(store, BranchStore.ROOT)
