"""The branch-lifecycle kernel — one state machine for every domain.

The paper's central design point (§5) is that fork/explore/commit is *one*
OS primitive: a single kernel object owns branch identity, parent/child
links, status, epochs, exclusive commit groups, frozen-origin enforcement,
first-commit-wins arbitration, and recursive sibling invalidation — and
every state domain (filesystem, memory, process group) plugs into it
through narrow hooks.  This module is that kernel for branchx:

* :class:`BranchTree` — the thread-safe lifecycle state machine.  It owns
  *no* domain data (no deltas, no page tables, no token tails); it owns
  the transitions and decides every race under one lock.
* :class:`BranchDomain` — the plug-in protocol.  A domain receives
  ``on_fork / on_commit / on_abort / on_invalidate`` callbacks, always
  under the tree lock, and moves its own payload (delta dicts, block
  tables, token lists) accordingly.

Domains in-tree (DESIGN §2):

=====================  ============================  ==================
paper primitive        domain                         module
=====================  ============================  ==================
BR_FS                  pytree delta dicts             core/store.py
BR_MEMORY              KV block tables + refcounts    core/kvbranch.py
process group          serving token tails            runtime/serve_loop.py
branch() syscall       multi-domain composition       core/runtime_api.py
=====================  ============================  ==================

Lifecycle invariants enforced here (and only here):

* **First-commit-wins** — a commit is a CAS on the parent's epoch taken
  under the tree lock; the winner bumps the epoch, so every sibling's
  next liveness check fails (``StaleBranchError`` = ``-ESTALE``).
* **Frozen origin** — with ``freeze_on_fork=True`` the parent's *status*
  becomes FROZEN while children are live (KV semantics: appends denied,
  parent resumes when all children resolve).  With ``freeze_on_fork=
  False`` the origin stays ACTIVE and callers gate writes on
  :meth:`BranchTree.has_live_children` (store semantics).
* **Recursive sibling invalidation** — the winner's commit (or an abort)
  walks every losing subtree depth-first, firing ``on_invalidate`` per
  node so domains reclaim payloads (deltas dropped, pages decref'd,
  token tails popped).
* **Exclusive commit groups** — every ``fork(parent, n)`` batch shares a
  group id (the paper's BR_CREATE set); at most one member commits.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterator, List, Optional, Protocol, runtime_checkable

from repro_torch.core.errors import BranchStateError, StaleBranchError
from repro_torch.obs.tracer import NULL_TRACER, Tracer


class BranchStatus(Enum):
    """Unified status vocabulary across all state domains."""

    ACTIVE = "active"
    FROZEN = "frozen"        # live children exist (freeze_on_fork domains)
    COMMITTED = "committed"
    ABORTED = "aborted"
    STALE = "stale"          # invalidated by a sibling's commit (-ESTALE)


#: statuses that count as "live" (may still resolve to a commit/abort)
LIVE = (BranchStatus.ACTIVE, BranchStatus.FROZEN)


@dataclass
class BranchNode:
    """Pure lifecycle bookkeeping for one branch — no domain payload."""

    branch_id: int
    parent: Optional[int]
    status: BranchStatus = BranchStatus.ACTIVE
    # Parent epoch observed at fork time.  A commit is valid only while
    # the parent's epoch is unchanged; the winning commit bumps it, so
    # every sibling's next check fails (-ESTALE).
    parent_epoch_at_fork: int = 0
    epoch: int = 0           # bumped when *this* node accepts a commit
    children: List[int] = field(default_factory=list)
    group: Optional[int] = None   # exclusive commit group (BR_CREATE set)


@runtime_checkable
class BranchDomain(Protocol):
    """Payload hooks a state domain registers with :class:`BranchTree`.

    All hooks run under the tree lock, after the kernel has decided the
    transition is legal; a domain must not re-enter the tree's lifecycle
    methods from inside a hook.
    """

    def on_fork(self, parent: int, children: List[int]) -> None:
        """Materialize each child's payload as a view of the parent's."""

    def on_commit(self, child: int, parent: int) -> None:
        """Fold the winning child's payload into the parent's."""

    def on_abort(self, branch: int) -> None:
        """Drop the payload of a voluntarily aborted branch."""

    def on_invalidate(self, branch: int) -> None:
        """Drop the payload of a branch invalidated by a sibling's win.

        Must be idempotent: stale branches may be cleaned up twice
        (eagerly by the winner, again by a caller's abort-after-ESTALE).
        """

    def on_reap(self, branch: int) -> None:
        """Forget a reaped branch's payload *entry* entirely (GC).

        Fired when :meth:`BranchTree.reap` removes a fully-resolved node
        from the tree; the id ceases to exist afterwards, so the domain
        must drop the key itself, not just empty the value.  Optional:
        domains that do not define the hook are skipped.
        """


class BranchTree:
    """Thread-safe branch lifecycle shared by every state domain.

    Parameters
    ----------
    freeze_on_fork:
        If True, forking flips the origin's status to FROZEN until all
        children resolve (KV semantics).  If False the origin stays
        ACTIVE and only :meth:`has_live_children` reports the freeze
        (store semantics, where committed interior nodes remain
        forkable).
    allow_fork_resolved:
        If True, COMMITTED nodes may be forked from (their payload was
        merged upward but chain resolution still works — store
        semantics).
    tracer:
        Optional :class:`repro_torch.obs.Tracer`.  When enabled, every branch
        carries one ``explore`` span from fork to resolution (track =
        branch id, process = the root of its exploration subtree) plus
        instant events for fork/commit/abort/invalidated/frozen/resumed
        — the span tree mirrors the branch tree.  Defaults to the
        shared disabled :data:`~repro_torch.obs.tracer.NULL_TRACER`, so every
        emit site below costs one predicted branch when tracing is off.
    """

    def __init__(self, *, freeze_on_fork: bool = False,
                 allow_fork_resolved: bool = False,
                 tracer: Optional[Tracer] = None):
        self.lock = threading.RLock()
        self._ids = itertools.count(0)
        self._groups = itertools.count(1)
        self._nodes: Dict[int, BranchNode] = {}
        self._domains: List[BranchDomain] = []
        self.freeze_on_fork = freeze_on_fork
        self.allow_fork_resolved = allow_fork_resolved
        self.tracer = NULL_TRACER if tracer is None else tracer

    # ------------------------------------------------------------------
    # domain registration
    # ------------------------------------------------------------------
    def attach(self, domain: BranchDomain) -> None:
        """Register a payload domain; hooks fire in attach order."""
        with self.lock:
            if domain not in self._domains:
                self._domains.append(domain)

    # ------------------------------------------------------------------
    # node access / liveness
    # ------------------------------------------------------------------
    def node(self, branch_id: int) -> BranchNode:
        try:
            return self._nodes[branch_id]
        except KeyError:
            raise BranchStateError(
                f"unknown branch id {branch_id!r}") from None

    def __contains__(self, branch_id: int) -> bool:
        return branch_id in self._nodes

    def check_live(self, branch_id: int) -> BranchNode:
        """Raise unless the branch may still resolve (ACTIVE or FROZEN).

        Performs the lazy epoch check: if the parent's epoch moved past
        the fork-time snapshot, a sibling committed and this branch is
        stale even if not yet eagerly marked.
        """
        with self.lock:
            node = self.node(branch_id)
            if node.status is BranchStatus.STALE:
                raise StaleBranchError(
                    f"branch {branch_id} was invalidated by a sibling "
                    "commit (-ESTALE)")
            if node.status not in LIVE:
                raise BranchStateError(
                    f"branch {branch_id} is {node.status.value}, not live")
            if node.parent is not None:
                parent = self._nodes[node.parent]
                if parent.epoch != node.parent_epoch_at_fork:
                    node.status = BranchStatus.STALE
                    self._trace_resolve(branch_id, "invalidated",
                                        "invalidated")
                    raise StaleBranchError(
                        f"branch {branch_id} is stale (parent epoch "
                        f"{parent.epoch} != {node.parent_epoch_at_fork} "
                        "at fork)")
            return node

    def is_live(self, branch_id: int) -> bool:
        with self.lock:
            if branch_id not in self._nodes:
                return False
            try:
                self.check_live(branch_id)
            except (StaleBranchError, BranchStateError):
                return False
            return True

    def status(self, branch_id: int) -> BranchStatus:
        """Current status with the lazy stale check applied."""
        with self.lock:
            node = self.node(branch_id)
            if node.status in LIVE and node.parent is not None:
                parent = self._nodes[node.parent]
                if parent.epoch != node.parent_epoch_at_fork:
                    node.status = BranchStatus.STALE
                    self._trace_resolve(branch_id, "invalidated",
                                        "invalidated")
            return node.status

    def epoch(self, branch_id: int) -> int:
        return self.node(branch_id).epoch

    def live_children(self, branch_id: int) -> List[int]:
        with self.lock:
            return [c for c in self.node(branch_id).children
                    if self._nodes[c].status in LIVE]

    def has_live_children(self, branch_id: int) -> bool:
        return bool(self.live_children(branch_id))

    def chain(self, branch_id: int) -> Iterator[int]:
        """Yield ids from ``branch_id`` up to and including its root."""
        cur: Optional[int] = branch_id
        while cur is not None:
            yield cur
            cur = self._nodes[cur].parent

    def chain_depth(self, branch_id: int) -> int:
        with self.lock:
            self.node(branch_id)
            return sum(1 for _ in self.chain(branch_id)) - 1

    # ------------------------------------------------------------------
    # lifecycle transitions
    # ------------------------------------------------------------------
    def _trace_resolve(self, branch_id: int, status: str,
                       event: Optional[str] = None) -> None:
        """Close a branch's explore-span and fire its resolution instant.

        ``end_span`` pops the track's open span and returns False when
        nothing is open, so racing closers — eager sibling
        invalidation, a lazy -ESTALE discovery in ``check_live``/
        ``status``, an abort-after-ESTALE, a scheduler purge's
        ``reap`` — resolve to exactly one span close and exactly one
        instant per branch, never a double-close or a leak.
        """
        tr = self.tracer
        if tr.enabled and tr.end_span(branch_id, status=status) and event:
            tr.instant(branch_id, event)

    def create_root(self) -> int:
        """Create a parentless branch (a new tree root / base namespace)."""
        with self.lock:
            bid = next(self._ids)
            self._nodes[bid] = BranchNode(branch_id=bid, parent=None)
            if self.tracer.enabled:
                self.tracer.begin_span(bid, "explore", group=bid, root=True)
            return bid

    def fork(self, parent: int, n: int = 1) -> List[int]:
        """Create ``n`` sibling branches in one exclusive commit group.

        O(1) per branch in the kernel; domains pay only their own
        payload-view cost in ``on_fork``.
        """
        if n < 1:
            raise ValueError("n must be >= 1")
        with self.lock:
            pnode = self.node(parent)
            if pnode.status is BranchStatus.COMMITTED:
                if not self.allow_fork_resolved:
                    raise BranchStateError(
                        f"branch {parent} is committed and this tree "
                        "does not allow forking resolved branches")
            else:
                self.check_live(parent)
            group = next(self._groups)
            children: List[int] = []
            for _ in range(n):
                bid = next(self._ids)
                self._nodes[bid] = BranchNode(
                    branch_id=bid,
                    parent=parent,
                    parent_epoch_at_fork=pnode.epoch,
                    group=group,
                )
                pnode.children.append(bid)
                children.append(bid)
            for domain in self._domains:
                domain.on_fork(parent, children)
            frozen = False
            if self.freeze_on_fork and pnode.status is BranchStatus.ACTIVE:
                pnode.status = BranchStatus.FROZEN
                frozen = True
            tr = self.tracer
            if tr.enabled:
                pg = tr.group_of(parent, parent)
                for bid in children:
                    tr.begin_span(bid, "explore", parent=parent, group=pg,
                                  fork_group=group)
                tr.instant(parent, "fork", children=list(children),
                           group=group)
                if frozen:
                    tr.instant(parent, "frozen")
            return children

    def commit(self, branch_id: int) -> int:
        """First-commit-wins: CAS on the parent's epoch under the lock.

        On success: domain payloads fold upward (``on_commit``), the
        parent's epoch bumps, every live sibling subtree is invalidated
        (``on_invalidate`` per node), and a frozen parent resumes
        ACTIVE.  Returns the parent id (the PID-takeover of BR_COMMIT).
        """
        with self.lock:
            node = self.check_live(branch_id)   # loser -> StaleBranchError
            if self.has_live_children(branch_id):
                raise BranchStateError(
                    f"branch {branch_id} has live children; commit or "
                    "abort them first (commit applies to the immediate "
                    "parent only)")
            if node.parent is None:
                raise BranchStateError("root branch cannot commit")
            parent = self._nodes[node.parent]
            for domain in self._domains:
                domain.on_commit(branch_id, parent.branch_id)
            node.status = BranchStatus.COMMITTED
            parent.epoch += 1   # the CAS bump: every sibling is now stale
            self._trace_resolve(branch_id, "committed", "commit")
            for sid in parent.children:
                if sid != branch_id and self._nodes[sid].status in LIVE:
                    self._invalidate(self._nodes[sid])
            if parent.status is BranchStatus.FROZEN:
                parent.status = BranchStatus.ACTIVE
                if self.tracer.enabled:
                    self.tracer.instant(parent.branch_id, "resumed")
            return parent.branch_id

    def abort(self, branch_id: int) -> None:
        """Discard the branch; siblings stay valid.

        Aborting a STALE branch is allowed as cleanup-after-ESTALE and
        only re-fires ``on_invalidate`` (idempotent).  If all children
        of a frozen origin resolve, the origin resumes ACTIVE.
        """
        with self.lock:
            node = self.node(branch_id)
            if node.status is BranchStatus.STALE:
                for domain in self._domains:
                    domain.on_invalidate(branch_id)
                return
            if node.status not in LIVE:
                raise BranchStateError(
                    f"branch {branch_id} is {node.status.value}")
            for cid in node.children:
                if self._nodes[cid].status in LIVE:
                    self._invalidate(self._nodes[cid])
            node.status = BranchStatus.ABORTED
            for domain in self._domains:
                domain.on_abort(branch_id)
            self._trace_resolve(branch_id, "aborted", "aborted")
            self._maybe_resume_parent(node)

    def invalidate(self, branch_id: int,
                   status: BranchStatus = BranchStatus.STALE) -> None:
        """Forcibly invalidate a subtree (serving-slot eviction, OOM...).

        Unlike :meth:`abort` this works on any live node — including a
        root — and does not resume a frozen parent.
        """
        with self.lock:
            node = self.node(branch_id)
            if node.status in LIVE:
                self._invalidate(node, status=status)

    def _invalidate(self, node: BranchNode,
                    status: BranchStatus = BranchStatus.STALE) -> None:
        for cid in node.children:
            child = self._nodes[cid]
            if child.status in LIVE:
                self._invalidate(child)
        node.status = status
        for domain in self._domains:
            domain.on_invalidate(node.branch_id)
        self._trace_resolve(
            node.branch_id,
            "invalidated" if status is BranchStatus.STALE else status.value,
            "invalidated")

    def reap(self, branch_id: int) -> int:
        """Garbage-collect a fully-resolved subtree from the kernel.

        Resolved nodes are kept so callers can observe COMMITTED / STALE
        / ABORTED outcomes, but in a long-running serving loop — where
        every request and fork allocates fresh ids — that history grows
        without bound.  Once a subtree can no longer transition (no LIVE
        member), the serving layer reaps it: every node is removed from
        the tree, unlinked from its parent, and each domain drops its
        payload entry via ``on_reap``.  Returns the number of nodes
        removed; 0 (and no change) if the id is unknown or the subtree
        still has a live member.
        """
        with self.lock:
            if branch_id not in self._nodes:
                return 0
            members: List[BranchNode] = []
            stack = [self._nodes[branch_id]]
            while stack:
                cur = stack.pop()
                # status() applies the lazy -ESTALE check, so a node that
                # merely *looks* ACTIVE after a sibling commit still reaps
                if self.status(cur.branch_id) in LIVE:
                    return 0
                members.append(cur)
                stack.extend(self._nodes[c] for c in cur.children)
            root = self._nodes[branch_id]
            if root.parent is not None and root.parent in self._nodes:
                siblings = self._nodes[root.parent].children
                if branch_id in siblings:
                    siblings.remove(branch_id)
            for node in reversed(members):   # children before parents
                del self._nodes[node.branch_id]
                for domain in self._domains:
                    hook = getattr(domain, "on_reap", None)
                    if hook is not None:
                        hook(node.branch_id)
                # a scheduler purge may reap descendants whose lazy
                # -ESTALE was never observed: their explore-spans are
                # still open and must close as invalidated here (the
                # one-shot guard makes this a no-op for already-closed
                # tracks)
                self._trace_resolve(node.branch_id, "invalidated",
                                    "invalidated")
            return len(members)

    def _maybe_resume_parent(self, node: BranchNode) -> None:
        if not self.freeze_on_fork or node.parent is None:
            return
        parent = self._nodes[node.parent]
        if parent.status is BranchStatus.FROZEN and not any(
                self._nodes[c].status in LIVE for c in parent.children):
            # all children resolved -> the origin resumes (paper §5.2:
            # "if all branches abort, the parent resumes")
            parent.status = BranchStatus.ACTIVE
            if self.tracer.enabled:
                self.tracer.instant(parent.branch_id, "resumed")

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def snapshot(self) -> List[dict]:
        """Procfs-style view of the whole forest (what the JAX
        package's ``repro.api`` serves as ``tree()``): one nested dict per
        root, each node carrying its id, lazily-checked status, exclusive
        group and epoch.  Read-only
        and taken under the lock, so it is a consistent cut of the
        lifecycle state.
        """
        with self.lock:
            def view(bid: int) -> dict:
                node = self._nodes[bid]
                return {
                    "id": bid,
                    "status": self.status(bid).value,
                    "group": node.group,
                    "epoch": node.epoch,
                    "children": [view(c) for c in node.children
                                 if c in self._nodes],
                }
            return [view(bid) for bid, node in self._nodes.items()
                    if node.parent is None or node.parent not in self._nodes]

    def live_count(self) -> int:
        with self.lock:
            return sum(1 for n in self._nodes.values() if n.status in LIVE)

    def __len__(self) -> int:
        return len(self._nodes)


__all__ = [
    "LIVE",
    "BranchDomain",
    "BranchNode",
    "BranchStatus",
    "BranchTree",
]
