"""BranchContext — one node of a scheduled exploration tree.

The paper ships two artifacts: the branch *primitive* (kernel, domains,
scheduler) and **BranchContext**, the integration library that turns
the primitive into ready-to-use exploration patterns.  This class is
pure **sugar over session handles**: every lifecycle verb delegates to one
:class:`~repro_torch.api.BranchSession` method, so a context and a raw handle
are always interchangeable (``ctx.hd`` is the handle; wrap any handle
in a context to get the object-style API back).

What the sugar adds over raw ``branch()`` calls:

* **Tree bookkeeping** — parent/children links, depth, per-node scores,
  ``commit_chain`` promoting a deep winner level by level.
* **Exploration defaults** — ``fork`` passes ``BR_HOLD`` (the driver
  paces decoding), ``BR_NESTED`` (policies nest freely) and
  ``BR_NONBLOCK`` (the driver owns the retry loop) so policies never
  spell flag words.
* **Context-manager semantics** — leaving a ``with`` block without
  commit aborts; no side effects escape an unresolved branch.

Contexts do not pace their own decoding: the
:class:`~repro_torch.explore_ctx.driver.ExplorationDriver` multiplexes decode
work from many live contexts into the scheduler's continuous-batching
loop through the session's :class:`~repro_torch.api.events.Waiter`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.api.flags import BR_HOLD, BR_NESTED, BR_NONBLOCK
from repro_torch.api.session import BranchSession
from repro_torch.core.branch import BranchContext as StateContext
from repro_torch.core.errors import BadHandleError, BranchStateError
from repro_torch.core.lifecycle import BranchStatus


@dataclass
class PolicyResult:
    """What an exploration policy returns through its driver."""

    req_id: Optional[int]
    tokens: List[int]            # the exploration root's full token list
    generated: List[int]         # tokens beyond the root's starting point
    score: Optional[float] = None
    committed: bool = True       # False if the policy kept the origin
    stats: Dict[str, Any] = field(default_factory=dict)


def policy_result(root: "BranchContext", *, score: Optional[float] = None,
                  committed: bool = True, **stats: Any) -> PolicyResult:
    """Assemble a :class:`PolicyResult` from the exploration root."""
    toks = root.tokens()
    return PolicyResult(req_id=root.req_id, tokens=toks,
                        generated=toks[root.fork_len:], score=score,
                        committed=committed, stats=stats)


class BranchContext:
    """A scheduled branch following fork/explore/commit-or-abort."""

    def __init__(self, session: BranchSession, hd: int, *,
                 parent: Optional["BranchContext"] = None):
        self.session = session
        self.hd = hd
        self.parent = parent
        self.seq = session.seq_of(hd)
        self.req_id = session.req_id_of(hd)
        self.children: List["BranchContext"] = []
        self.depth = 0 if parent is None else parent.depth + 1
        self.score: Optional[float] = None
        self._resolved = False
        # token count at creation: generated() is everything after this
        self.fork_len = len(self.tokens())

    # -- liveness -------------------------------------------------------
    @property
    def alive(self) -> bool:
        try:
            return self.session.alive(self.hd)
        except BadHandleError:
            return False             # handle closed: the branch is gone

    @property
    def status(self) -> Optional[BranchStatus]:
        try:
            return self.session.status(self.hd)   # None once reaped
        except BadHandleError:
            return None

    @property
    def resolved(self) -> bool:
        return self._resolved

    @property
    def state(self) -> Optional[StateContext]:
        """The composite store-domain context (None in KV-only mode)."""
        try:
            return self.session.state_of(self.hd)
        except BadHandleError:
            return None

    # -- content --------------------------------------------------------
    def tokens(self) -> List[int]:
        """This branch's full token list (prompt + committed + own)."""
        try:
            return self.session.tokens(self.hd)
        except BadHandleError:
            raise BranchStateError(
                f"branch context hd={self.hd:#x} was closed "
                "(its request finished)") from None

    def generated(self) -> List[int]:
        """Tokens this context added since it was forked."""
        return self.tokens()[self.fork_len:]

    # -- lifecycle ------------------------------------------------------
    def fork(self, n: int = 1, flags: int = 0) -> List["BranchContext"]:
        """Fork ``n`` admission-checked children (one exclusive group).

        One vectorized ``branch()`` call: all ``n`` siblings admitted in
        one ledger transaction, tail CoW fused into one dispatch, every
        domain forked atomically.  Children are parked (``BR_HOLD``) —
        the driver decides when they decode — and the call never blocks
        (``BR_NONBLOCK``): page pressure raises ``AdmissionDenied`` for
        the driver's backpressure loop to absorb.
        """
        hds = self.session.branch(
            self.hd, flags | BR_HOLD | BR_NESTED | BR_NONBLOCK, n)
        kids = [BranchContext(self.session, hd, parent=self) for hd in hds]
        self.children.extend(kids)
        return kids

    def commit(self) -> Optional["BranchContext"]:
        """First-commit-wins into the parent; siblings invalidated."""
        if self._resolved:
            raise BranchStateError("branch context already resolved")
        self.session.commit(self.hd)
        self._resolved = True
        return self.parent

    def commit_chain(self, until: Optional["BranchContext"] = None
                     ) -> "BranchContext":
        """Commit this branch level by level up to ``until`` (default:
        the exploration root).

        Each step's winner invalidates its siblings' whole subtrees —
        the nested-search ending where one leaf's lineage becomes the
        request's committed content.  Returns the context committed into.
        """
        cur = self
        while cur is not until and cur.parent is not None:
            cur.commit()
            cur = cur.parent
        return cur

    def abort(self) -> None:
        """Discard this branch (and, recursively, its live subtree)."""
        if self._resolved:
            return
        try:
            self.session.abort(self.hd)
        except BadHandleError:
            pass                     # closed: nothing left to discard
        self._resolved = True

    def prune_children(self) -> int:
        """Abort every live child subtree (pre-commit cleanup)."""
        n = 0
        for k in self.children:
            if not k._resolved and k.alive:
                k.abort()
                n += 1
        return n

    def truncate(self, n_generated: int) -> None:
        """Keep only the first ``n_generated`` tokens generated here.

        The speculative-decode primitive: a draft keeps its verified
        prefix and commits that.  Requires the context to have been
        forked ``BR_SPECULATIVE`` (``-EPERM`` otherwise).
        """
        self.session.truncate(self.hd, n_generated)

    def verify(self, drafts: List[List[int]]) -> List[List[int]]:
        """Fused speculative verify against this branch (one dispatch).

        Each draft is k proposed next tokens; each returned row is the
        target's greedy continuation at every draft position, so
        ``lcp_len(draft, row)`` is the draft's verified-prefix length.
        Pure scoring — no decode, no new branches, this context's KV is
        read-only.  The usual caller holds the frozen origin while the
        drafts are its live children.
        """
        return self.session.verify(self.hd, drafts)

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "BranchContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._resolved and self.alive and self.parent is not None:
            self.abort()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        st = self.status
        return (f"BranchContext(hd={self.hd:#x}, seq={self.seq}, "
                f"depth={self.depth}, "
                f"status={st.value if st else 'reaped'})")


__all__ = ["BranchContext", "PolicyResult", "StateContext",
           "policy_result"]
