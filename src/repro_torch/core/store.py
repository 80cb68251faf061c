"""BranchStore — leaf-granular copy-on-write branch contexts over pytrees.

The port's copy of ``repro/core/store.py``.  This is the in-memory
realization of the paper's BranchFS semantics, with pytree *leaves*
playing the role of files:

* **CoW delta layers**: each branch holds only the leaves it wrote
  (``delta`` dict).  "Copy"-on-write is zero-copy: the delta stores a
  reference to the new tensor; the base is never touched.  Branch creation
  is O(1) regardless of base size (paper Table 4).  In the JAX package this
  holds because arrays are immutable; torch tensors are not, so it holds
  only while no one writes into a tensor the store hands out.  The store
  checks that rule: it stamps each tensor leaf with its version counter
  when the leaf is written, and a read of a leaf written in place since
  (directly or through a view) raises :class:`BranchStateError` instead
  of handing out what a sibling may have changed.  The port's SSM
  ``decode_step`` returns new tensors, so an SSM cache can be stepped as
  restored; a batched step writes each branch back as a tensor of its
  own, never as a view of the batch.  The dense, VLM and audio
  ``decode_step`` write the new K/V row into the cache they are given, so
  a dense cache restored from a store must be cloned before it is
  stepped.
* **Branch-chain resolution**: a read walks current branch → ancestors →
  base, exactly the lookup order of BranchFS §4.2.
* **Tombstones**: deletions write a sentinel so deleted leaves do not
  "reappear" from the base.
* **Frozen origin**: a branch with live children rejects writes
  (`FrozenOriginError`).
* **Nesting**: branches fork sub-branches; commit applies to the
  *immediate* parent only (paper §5.2 "Nested Branches").

The lifecycle itself (ids, parent/child links, status, epochs, exclusive
commit groups, first-commit-wins, recursive sibling invalidation) is NOT
implemented here: BranchStore is a :class:`~repro_torch.core.lifecycle.
BranchDomain` plugged into the shared :class:`~repro_torch.core.lifecycle.
BranchTree` kernel (DESIGN §2).  This module owns only the payload —
delta dicts and tombstones — and moves it in the ``on_fork/on_commit/
on_abort/on_invalidate`` hooks.  Thread-safety comes from the tree's
lock, mirroring the kernel's exclusive commit group.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core.errors import (
    BranchStateError,
    FrozenOriginError,
    NoSuchLeafError,
    StaleBranchError,
)
from repro_torch.core.lifecycle import BranchStatus, BranchTree


class _Tombstone:
    """Sentinel recording a deletion in a delta layer (BranchFS §4.2)."""

    _instance: Optional["_Tombstone"] = None

    def __new__(cls) -> "_Tombstone":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<TOMBSTONE>"


TOMBSTONE = _Tombstone()


class BranchStore:
    """A tree of CoW branch contexts over a flat ``{path: leaf}`` namespace.

    The root (branch id 0) is the base "filesystem".  All other branches
    are created by :meth:`fork` and resolved by :meth:`commit` /
    :meth:`abort` — both delegated to the lifecycle kernel, with this
    class acting as the BR_FS payload domain.
    """

    ROOT = 0

    def __init__(self, base: Optional[Mapping[str, Any]] = None):
        # Committed interior nodes may still be forked from (their state
        # is merged upward, but chain resolution still works), and the
        # origin stays ACTIVE while children are live — writes are gated
        # on has_live_children instead of a FROZEN status.
        self._tree = BranchTree(freeze_on_fork=False,
                                allow_fork_resolved=True)
        self._deltas: Dict[int, Dict[str, Any]] = {}
        # per branch, the version counter of each tensor leaf when written
        self._stamps: Dict[int, Dict[str, int]] = {}
        self._tree.attach(self)
        root = self._tree.create_root()
        assert root == self.ROOT
        self._deltas[root] = {}
        self._stamps[root] = {}
        self._put(root, dict(base or {}))

    @property
    def tree(self) -> BranchTree:
        """The lifecycle kernel (shared with any co-registered domains)."""
        return self._tree

    @property
    def _lock(self) -> threading.RLock:
        return self._tree.lock

    # ------------------------------------------------------------------
    # BranchDomain payload hooks (called by the kernel, under its lock)
    # ------------------------------------------------------------------
    def on_fork(self, parent: int, children: List[int]) -> None:
        for c in children:
            self._deltas[c] = {}   # O(1): children start with empty deltas
            self._stamps[c] = {}

    def on_commit(self, child: int, parent: int) -> None:
        # Apply tombstones first, then modified leaves (BranchFS §4.3).
        delta = self._deltas[child]
        parent_delta = self._deltas[parent]
        stamps, parent_stamps = self._stamps[child], self._stamps[parent]
        parent_is_base = self._tree.node(parent).parent is None
        for path, leaf in delta.items():
            if leaf is TOMBSTONE:
                parent_stamps.pop(path, None)
                if parent_is_base:
                    # committing into the base: delete outright
                    parent_delta.pop(path, None)
                else:
                    parent_delta[path] = TOMBSTONE
        for path, leaf in delta.items():
            if leaf is not TOMBSTONE:
                parent_delta[path] = leaf
                parent_stamps.pop(path, None)
                if path in stamps:
                    parent_stamps[path] = stamps[path]
        self._deltas[child] = {}
        self._stamps[child] = {}

    def on_abort(self, branch: int) -> None:
        self._deltas[branch] = {}
        self._stamps[branch] = {}

    def on_invalidate(self, branch: int) -> None:
        self._deltas[branch] = {}
        self._stamps[branch] = {}

    def on_reap(self, branch: int) -> None:
        self._deltas.pop(branch, None)
        self._stamps.pop(branch, None)

    # ------------------------------------------------------------------
    # lifecycle: fork / commit / abort (delegated to the kernel)
    # ------------------------------------------------------------------
    def fork(self, parent: int = ROOT, n: int = 1) -> List[int]:
        """Create ``n`` sibling branches from a frozen origin.  O(1) each.

        All ``n`` branches form an *exclusive group*: at most one of them
        can commit; the winner invalidates the rest (paper §5.2
        BR_CREATE).
        """
        return self._tree.fork(parent, n)

    def commit(self, branch_id: int) -> int:
        """Atomically apply this branch's delta to its immediate parent.

        First-commit-wins: the kernel's epoch CAS decides the race under
        its lock; on success the parent's epoch is bumped, turning every
        sibling stale.  Returns the parent id (the branch "replaces" the
        parent, analogous to the PID takeover of ``BR_COMMIT``).
        """
        return self._tree.commit(branch_id)

    def abort(self, branch_id: int) -> None:
        """Discard the branch's delta; siblings remain valid.  O(1)."""
        self._tree.abort(branch_id)

    def reap(self, branch_id: int) -> int:
        """GC a fully-resolved subtree (nodes + delta entries).

        Opt-in for the store: a COMMITTED interior node normally stays
        forkable (``allow_fork_resolved``) and resolvable in read
        chains, so only reap subtrees the caller will never address
        again (e.g. after an exploration round fully resolves).
        """
        return self._tree.reap(branch_id)

    # ------------------------------------------------------------------
    # namespace ops (the "filesystem" interface)
    # ------------------------------------------------------------------
    def _writable(self, branch_id: int) -> int:
        self._tree.check_live(branch_id)
        if self._tree.has_live_children(branch_id):
            raise FrozenOriginError(
                f"branch {branch_id} has live children and is frozen")
        return branch_id

    def read(self, branch_id: int, path: str) -> Any:
        """Chain resolution: branch delta → ancestors → base (§4.2)."""
        with self._lock:
            status = self._tree.status(branch_id)
            if status is BranchStatus.STALE:
                raise StaleBranchError(
                    f"branch {branch_id} was invalidated (SIGBUS analogue)")
            if status is BranchStatus.ABORTED:
                raise BranchStateError(f"branch {branch_id} was aborted")
            for level in self._tree.chain(branch_id):
                if path in self._deltas[level]:
                    leaf = self._deltas[level][path]
                    if leaf is TOMBSTONE:
                        raise NoSuchLeafError(path)
                    return self._unchanged(level, path, leaf)
            raise NoSuchLeafError(path)

    def _unchanged(self, level: int, path: str, leaf: Any) -> Any:
        """``leaf`` if no one wrote into it since it was stored."""
        stamp = self._stamps[level].get(path)
        if stamp is not None and leaf._version != stamp:
            raise BranchStateError(
                f"leaf {path} of branch {level} was written in place after "
                "it was stored, and its readers share it (clone a restored "
                "tensor before writing into it)")
        return leaf

    def exists(self, branch_id: int, path: str) -> bool:
        try:
            self.read(branch_id, path)
            return True
        except NoSuchLeafError:
            return False

    def write(self, branch_id: int, path: str, value: Any) -> None:
        self.write_many(branch_id, {path: value})

    def write_many(self, branch_id: int, items: Mapping[str, Any]) -> None:
        with self._lock:
            self._writable(branch_id)
            self._put(branch_id, items)

    def _put(self, branch_id: int, items: Mapping[str, Any]) -> None:
        delta, stamps = self._deltas[branch_id], self._stamps[branch_id]
        for path, leaf in items.items():
            delta[path] = leaf
            stamps.pop(path, None)
            # inference tensors keep no version counter: nothing to check
            if isinstance(leaf, torch.Tensor) and not leaf.is_inference():
                stamps[path] = leaf._version

    def delete(self, branch_id: int, path: str) -> None:
        """Record a tombstone (the leaf must currently resolve)."""
        with self._lock:
            self._writable(branch_id)
            if not self.exists(branch_id, path):
                raise NoSuchLeafError(path)
            self._deltas[branch_id][path] = TOMBSTONE
            self._stamps[branch_id].pop(path, None)

    def listdir(self, branch_id: int) -> List[str]:
        """Effective namespace: union along the chain minus tombstones."""
        with self._lock:
            self._tree.node(branch_id)
            seen: Dict[str, bool] = {}
            for level in self._tree.chain(branch_id):
                for path, leaf in self._deltas[level].items():
                    if path not in seen:
                        seen[path] = leaf is not TOMBSTONE
            return sorted(p for p, alive in seen.items() if alive)

    def delta_size(self, branch_id: int) -> int:
        self._tree.node(branch_id)
        return len(self._deltas[branch_id])

    def status(self, branch_id: int) -> BranchStatus:
        return self._tree.status(branch_id)

    def epoch(self, branch_id: int) -> int:
        return self._tree.epoch(branch_id)

    # ------------------------------------------------------------------
    # pytree convenience layer
    # ------------------------------------------------------------------
    @staticmethod
    def flatten_pytree(tree: Any, prefix: str = "") -> Dict[str, Any]:
        """Flatten a pytree into ``{key-path: leaf}`` with stable names
        (the JAX package's: ``"['ssm']"`` for a dict's ``"ssm"``)."""
        flat = pytree.tree_flatten_with_path(tree)[0]
        out: Dict[str, Any] = {}
        for path, leaf in flat:
            key = prefix + pytree.keystr(path)
            out[key] = leaf
        return out

    def snapshot_pytree(self, branch_id: int, tree: Any, prefix: str = "") -> None:
        """Write every leaf of ``tree`` into the branch (O(leaves) refs)."""
        self.write_many(branch_id, self.flatten_pytree(tree, prefix))

    def restore_pytree(self, branch_id: int, treedef_tree: Any, prefix: str = "") -> Any:
        """Rebuild a pytree shaped like ``treedef_tree`` from the branch."""
        flat, spec = pytree.tree_flatten_with_path(treedef_tree)
        leaves = []
        for path, _ in flat:
            key = prefix + pytree.keystr(path)
            leaves.append(self.read(branch_id, key))
        return pytree.tree_unflatten(leaves, spec)

    # ------------------------------------------------------------------
    # introspection for tests / benchmarks
    # ------------------------------------------------------------------
    def chain_depth(self, branch_id: int) -> int:
        return self._tree.chain_depth(branch_id)

    def consolidated_view(self, branch_id: int) -> Dict[str, Any]:
        """Materialize the flat effective namespace.

        This is the analogue of BranchFS *passthrough* mode: pay the chain
        walk once, then serve reads at native speed from the flat dict.
        """
        with self._lock:
            out: Dict[str, Any] = {}
            dead: set = set()
            for level in self._tree.chain(branch_id):
                for path, leaf in self._deltas[level].items():
                    if path in out or path in dead:
                        continue
                    if leaf is TOMBSTONE:
                        dead.add(path)
                    else:
                        out[path] = self._unchanged(level, path, leaf)
            return out


def explore(
    store: BranchStore,
    parent: int,
    fns: List[Callable[[int], bool]],
    *,
    threads: bool = True,
) -> Tuple[Optional[int], List[BranchStatus]]:
    """Run one fork/explore/commit round: the paper's Listing 2 in Python.

    Each ``fns[i]`` receives its branch id, does arbitrary reads/writes on
    it, and returns truthy to *attempt a commit*.  The first successful
    commit wins; every other branch ends STALE (if it lost the race) or
    ABORTED (if it returned falsy).  Returns ``(winner_branch_id | None,
    statuses)``.
    """
    branches = store.fork(parent, n=len(fns))
    winner: List[Optional[int]] = [None]

    def _run(i: int, bid: int) -> None:
        try:
            ok = fns[i](bid)
        except StaleBranchError:
            return
        if ok:
            try:
                store.commit(bid)
                winner[0] = bid
            except StaleBranchError:
                pass  # lost the race: -ESTALE
        else:
            try:
                store.abort(bid)
            except (StaleBranchError, BranchStateError):
                pass

    if threads:
        ts = [
            threading.Thread(target=_run, args=(i, bid))
            for i, bid in enumerate(branches)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        for i, bid in enumerate(branches):
            _run(i, bid)

    return winner[0], [store.status(b) for b in branches]
