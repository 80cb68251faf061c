"""BranchSession — the syscall-faithful public surface of branchx.

The port's copy of ``repro/api/session.py``, over the port's
:class:`~repro_torch.runtime.serve_loop.ServeEngine`.  Sampling
arguments of the stepping verbs (``step``/``wait``) are
``greedy``/``temperature`` and ``generator=`` (a ``torch.Generator`` on
the engine's device, or an int seed) where the JAX package takes a
``key``.

The paper proposes *one* ``branch()`` syscall; the layers beneath this
one (``BranchRuntime.__call__`` opcode dispatch, raw ``Scheduler`` verbs,
``explore_ctx.BranchContext`` sugar, and ``ServeEngine`` itself) each
have their own error convention and blocking model.  ``BranchSession``
is the one surface over all of them:

* **One verb set** — ``open`` (admit a request), ``branch`` (vectorized
  fork with a flags word), ``commit`` / ``abort``, ``wait`` / ``poll``
  (unified eventing), ``stat`` / ``tree`` (procfs-style introspection),
  ``finish`` / ``result`` (retirement), ``close``.
* **A real handle table** — handles are fd-like ints packing a table
  index with a **generation counter**; a handle kept across ``close``
  (slot reuse bumps the generation) fails with ``-EBADF``
  (:class:`~repro_torch.core.errors.BadHandleError`) instead of silently
  addressing the slot's new occupant.
* **One errno discipline** — every failure raises a
  :class:`~repro_torch.core.errors.BranchError` carrying a code from the
  shared :class:`~repro_torch.core.errors.Errno` enum; no ``None`` returns,
  no ad-hoc exception vocabularies.
* **Vectorized fork** — ``branch(parent, n=k)`` admits all ``k``
  siblings under one reservation-ledger transaction and hoists their
  shared-tail CoW into a single batched page copy (``_service_cow``)
  (``KVBranchManager.fork_batch``); ``k`` sequential forks pay ``k``
  dispatches and ``k`` ledger transactions for the same state.
* **Atomic multi-domain composition** — a session constructed with a
  ``store`` forks/commits the host pytree domain and the device KV
  domain through :class:`~repro_torch.core.runtime_api.BranchRuntime`, so no
  call ever half-creates a branch set.

Minimal usage (the paper's Listing 2, serving edition)::

    session = BranchSession(engine)
    root = session.open(prompt, max_new_tokens=16)
    kids = session.branch(root, n=4)          # one txn, one CoW dispatch
    session.wait(kids, produced=8)            # epoll-style readiness
    best = max(kids, key=score)
    session.commit(best)                      # losers -ESTALE, pages freed
    print(session.wait([root], events=EV_FINISHED) and session.result(root))
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.branch import BranchContext as StateContext
from repro_torch.core.branch import root_context
from repro_torch.core.errors import (
    AdmissionDenied,
    BadHandleError,
    BranchError,
    BranchStateError,
    Errno,
    StaleBranchError,
)
from repro_torch.core.lifecycle import BranchStatus
from repro_torch.core.runtime_api import (
    BR_KV,
    BR_STATE,
    BranchHandle,
    BranchRuntime,
)
from repro_torch.core.runtime_api import BR_ISOLATE as RT_ISOLATE
from repro_torch.core.store import BranchStore
from repro_torch.runtime.scheduler import Scheduler, SchedulerConfig
from repro_torch.runtime.serve_loop import ServeEngine

from repro_torch.api.events import (
    EV_ADMITTED,
    EV_COMMITTED,
    EV_FINISHED,
    EV_INVALIDATED,
    EV_ANY,
    Waiter,
    event_names,
)
from repro_torch.api.flags import (
    BR_HOLD,
    BR_ISOLATE,
    BR_NESTED,
    BR_NONBLOCK,
    BR_SPECULATIVE,
    BR_TIERED,
    flag_names,
)

# handle = (slot index << _GEN_BITS) | generation.  16 generation bits
# mean a slot must be recycled 65536 times before a stale handle could
# collide — and collision needs the *same* slot too.
_GEN_BITS = 16
_GEN_MASK = (1 << _GEN_BITS) - 1


@dataclass
class _Entry:
    """One handle-table slot: the session's view of a branch."""

    hd: int
    gen: int
    req_id: Optional[int]
    root_hd: int
    parent_hd: Optional[int]
    flags: int
    depth: int = 0
    seq: Optional[int] = None          # None until the root is admitted
    group: Tuple[int, ...] = ()
    state: Optional[StateContext] = None
    rt_handle: Optional[BranchHandle] = None
    fork_len: int = 0
    events: int = 0                    # edge-accumulated event bits
    resolved: Optional[str] = None     # "committed" | "aborted" | "stale"
    result: Optional[List[int]] = None
    result_claimed: bool = False


class BranchSession:
    """The one public entry surface: handles, flags, errno, events."""

    def __init__(self, engine: Any, *, store: Optional[BranchStore] = None,
                 max_batch: int = 8, seed: int = 0):
        if isinstance(engine, Scheduler):
            self.sched = engine
        elif isinstance(engine, ServeEngine):
            self.sched = Scheduler(
                engine, SchedulerConfig(max_batch=max_batch, seed=seed))
        else:
            raise BranchError(
                f"BranchSession needs a ServeEngine or Scheduler, got "
                f"{type(engine).__name__}", errno=Errno.EINVAL)
        self.engine = self.sched.engine
        # the engine stack's observability hub (metrics registry +
        # tracer); build the engine with Observability(trace=True) to
        # record spans, then session.trace(path) exports the timeline
        self.obs = self.engine.obs
        self.store = store
        # Composite sessions fork the store domain and the KV domain
        # atomically; the KV fork goes through scheduler admission with
        # eager fused CoW — the vectorized-fork hot path.
        self.runtime: Optional[BranchRuntime] = None
        self._state_root: Optional[StateContext] = None
        if store is not None:
            self.runtime = BranchRuntime(
                store, self.engine.kv,
                kv_fork=lambda seq, n: self.sched.fork(seq, n,
                                                       eager_cow=True))
            self._state_root = root_context(store)
        self._slots: List[Optional[_Entry]] = []
        self._gens: List[int] = []     # per-slot generation counters
        self._free: List[int] = []
        self._closed = False

    # ------------------------------------------------------------------
    # handle table
    # ------------------------------------------------------------------
    def _new_entry(self, **kw: Any) -> _Entry:
        if self._free:
            idx = self._free.pop()
        else:
            idx = len(self._slots)
            self._slots.append(None)
            self._gens.append(1)       # gen starts at 1: handle 0 never valid
        gen = self._gens[idx]
        hd = (idx << _GEN_BITS) | gen
        entry = _Entry(hd=hd, gen=gen, **kw)
        self._slots[idx] = entry
        return entry

    def _entry(self, hd: int) -> _Entry:
        idx, gen = hd >> _GEN_BITS, hd & _GEN_MASK
        if not 0 <= idx < len(self._slots):
            raise BadHandleError(f"unknown branch handle {hd:#x} (-EBADF)")
        entry = self._slots[idx]
        if entry is None or entry.gen != gen:
            raise BadHandleError(
                f"stale branch handle {hd:#x}: slot {idx} is "
                f"{'closed' if entry is None else 'reused'} (-EBADF)")
        return entry

    def close(self, hd: Optional[int] = None) -> None:
        """Free a handle slot; any later use of ``hd`` is ``-EBADF``.

        Closing never resolves the branch (mirror of ``close(2)`` not
        killing the process an fd pointed at) — commit/abort/finish
        first if the branch should not stay live.

        ``close()`` with **no handle** closes the *session*: no new
        requests are accepted (``open`` raises ``-EINVAL``), ``step``
        becomes a no-op, and every blocked :class:`~repro_torch.api.events.
        Waiter` (and therefore ``session.wait``) wakes on its next poll
        instead of stepping a drained scheduler forever — the wake/
        close path a serving front door needs for graceful shutdown.
        Idempotent; existing handles stay readable (``tokens``,
        ``stat``) so late readers can still collect results.
        """
        if hd is None:
            self._closed = True
            return
        entry = self._entry(hd)
        idx = hd >> _GEN_BITS
        self._slots[idx] = None
        self._gens[idx] = (entry.gen + 1) & _GEN_MASK or 1
        self._free.append(idx)

    @property
    def closed(self) -> bool:
        """Whether ``close()`` shut the session down (no more stepping)."""
        return self._closed

    def open_handles(self) -> List[int]:
        return [e.hd for e in self._slots if e is not None]

    # ------------------------------------------------------------------
    # request entry (open/adopt) and admission binding
    # ------------------------------------------------------------------
    def open(self, prompt: Sequence[int], max_new_tokens: int = 16,
             flags: int = 0) -> int:
        """Admit a new request; returns its *root* branch handle.

        Queues behind the scheduler's worst-case page-reservation FIFO;
        admission is asynchronous and observable as ``EV_ADMITTED``
        (``open`` itself never blocks).  A request that can *never* fit
        raises ``AdmissionDenied`` with ``Errno.ENOSPC`` up front.
        ``BR_HOLD`` parks the root in the admission transaction itself,
        so an exploration policy sees exactly the prompt — never a
        scheduler-paced token.
        """
        if self._closed:
            raise BranchStateError(
                "session is closed; no new requests (-EINVAL)")
        req_id = self.sched.submit(list(prompt), max_new_tokens,
                                   hold=bool(flags & BR_HOLD))
        entry = self._new_entry(req_id=req_id, root_hd=0,
                                parent_hd=None, flags=flags)
        entry.root_hd = entry.hd
        entry.group = (entry.hd,)
        self.sched.admit()             # admit eagerly if pages allow
        self._try_bind(entry)
        return entry.hd

    def adopt(self, req_id: int, flags: int = BR_HOLD) -> int:
        """Wrap an already-submitted scheduler request in a root handle
        (migration aid for code that still calls ``Scheduler.submit``)."""
        entry = self._new_entry(req_id=req_id, root_hd=0,
                                parent_hd=None, flags=flags)
        entry.root_hd = entry.hd
        entry.group = (entry.hd,)
        self._try_bind(entry)
        return entry.hd

    def _try_bind(self, entry: _Entry) -> bool:
        """Bind an admitted root to its sequence + state subtree."""
        if entry.seq is not None:
            return True
        try:
            seq = self.sched.seq_of(entry.req_id)
        except BranchError:
            return False               # still waiting in the FIFO
        entry.seq = seq
        entry.fork_len = len(self.engine.tokens(seq))
        if self._state_root is not None:
            # each request explores inside its own store subtree, so
            # concurrent requests never race each other's epoch CAS
            (entry.state,) = self._state_root.fork(1)
        entry.events |= EV_ADMITTED
        return True

    def admitted(self, hd: int) -> bool:
        return self._try_bind(self._entry(hd))

    def admit(self) -> List[int]:
        """Run one admission round (``wait``/``step`` do this for you)."""
        if self._closed:
            return []
        return self.sched.admit()

    # ------------------------------------------------------------------
    # branch(): the syscall
    # ------------------------------------------------------------------
    def branch(self, parent: int, flags: int = 0, n: int = 1, *,
               max_steps: int = 500) -> List[int]:
        """Fork ``n`` sibling branches of ``parent`` in one transaction.

        The paper's ``branch()``: every attached state domain (KV pages,
        token tails, and — in composite sessions — the pytree store)
        forks atomically or not at all, all ``n`` siblings are admitted
        under ONE reservation-ledger transaction, and their shared-tail
        CoW is one batched page copy (``_service_cow``).  Flag
        semantics are documented in :mod:`repro_torch.api.flags`; blocking
        behaviour: denial under page pressure retries (stepping the
        scheduler so other work can free pages) unless ``BR_NONBLOCK``
        is set, in which case ``AdmissionDenied`` (``-EAGAIN``) raises
        immediately.
        """
        entry = self._entry(parent)
        if n < 1:
            raise BranchError("branch() needs n >= 1", errno=Errno.EINVAL)
        self._refresh(entry)   # pick up admission / sibling invalidation
        if entry.resolved is not None:
            raise BranchStateError(
                f"handle {parent:#x} is resolved ({entry.resolved})")
        if entry.parent_hd is None and entry.req_id is not None \
                and self.sched.finished(entry.req_id):
            raise BranchStateError(
                f"handle {parent:#x}'s request already finished; "
                "nothing left to fork")
        if entry.seq is not None and not self.sched.is_tracked(entry.seq):
            raise BranchStateError(
                f"handle {parent:#x} is no longer schedulable "
                "(retired or evicted)")
        if entry.parent_hd is not None and not flags & BR_NESTED:
            raise BranchError(
                "forking a non-root branch requires BR_NESTED (-EINVAL)",
                errno=Errno.EINVAL)

        if flags & BR_NONBLOCK:
            made = self._fork_domains(entry, n, flags)
        else:
            made = self._fork_blocking(entry, n, flags, max_steps)

        kids: List[_Entry] = []
        try:
            for seq, state, rt_handle in made:
                kid = self._new_entry(
                    req_id=entry.req_id, root_hd=entry.root_hd,
                    parent_hd=parent, flags=flags, depth=entry.depth + 1)
                kids.append(kid)
                kid.seq = seq
                kid.state = state
                kid.rt_handle = rt_handle
                kid.fork_len = len(self.engine.tokens(seq))
                # the flags word is authoritative: children of a held
                # parent inherit the scheduler-level hold, so an unset
                # BR_HOLD must actively release them into the batch
                if flags & BR_HOLD:
                    self.sched.hold(seq)
                else:
                    self.sched.unhold(seq)
        except BranchError:
            self._unwind_vector(made, kids)
            raise
        group = tuple(k.hd for k in kids)
        for k in kids:
            k.group = group
        return list(group)

    def _unwind_vector(
        self, made: Sequence[Tuple[int, Any, Any]],
        kids: Sequence[_Entry],
    ) -> None:
        """Mid-vector failure: no half-created sibling group survives.

        ``branch(n=k)`` promises all-or-nothing; a failure while the
        kid entries were being wired (e.g. a scheduler verb racing an
        eviction) must not orphan the siblings already created — their
        slots would hold the table's last reference to live branches
        nobody can address again, and their page reservations would
        never free.  Abort every forked domain, then release every
        handle slot.  (The static face of this invariant is branchlint
        BL002; the dynamic face is tested in tests/test_torch_api.py.)
        """
        for seq, _state, rt_handle in made:
            try:
                if rt_handle is not None:
                    self.runtime.abort(rt_handle)
                elif seq in self.engine.kv.tree and \
                        self.engine.kv.is_live(seq):
                    self.engine.abort(seq)
            except BranchError:
                pass        # already resolved/reaped by the failure
        for kid in kids:
            kid.resolved = "aborted"
            kid.events |= EV_INVALIDATED
            self.close(kid.hd)

    def _fork_domains(
        self, entry: _Entry, n: int, flags: int
    ) -> List[Tuple[int, Optional[StateContext], Optional[BranchHandle]]]:
        """One atomic multi-domain fork attempt (raises AdmissionDenied)."""
        if entry.seq is None and not self._try_bind(entry):
            # still in the admission FIFO: backpressure, not an error —
            # the blocking path keeps stepping until admission happens
            raise AdmissionDenied(
                f"handle {entry.hd:#x} is not admitted yet (-EAGAIN)")
        if self.runtime is not None and entry.state is not None:
            # check the cheap reservation ledger BEFORE forking the
            # store domain: a backpressure retry loop must not churn
            # (fork + unwind) store nodes every round
            if not self.sched.can_fork(entry.seq, n):
                raise AdmissionDenied(
                    f"branch({entry.seq}, n={n}) exceeds the page budget "
                    "(-EAGAIN)")
            rt_flags = BR_STATE | BR_KV
            if flags & BR_ISOLATE:
                rt_flags |= RT_ISOLATE
            handles = self.runtime.create(entry.state, n, flags=rt_flags,
                                          kv_seqs=[entry.seq])
            return [(h.kv_seqs[entry.seq], h.state, h) for h in handles]
        seqs = self.sched.fork(entry.seq, n, eager_cow=True)
        return [(s, None, None) for s in seqs]

    def _fork_blocking(self, entry: _Entry, n: int, flags: int,
                       max_steps: int) -> List[Tuple[int, Any, Any]]:
        """Retry the fork while scheduler progress can still free pages."""
        stalled = 0
        for _ in range(max(max_steps, 1)):
            try:
                return self._fork_domains(entry, n, flags)
            except AdmissionDenied as err:
                if err.errno is not Errno.EAGAIN:
                    raise           # permanent: no retry can help
            st = self.step()
            if st["decoded"] or st["admitted"] or st["retired"]:
                stalled = 0
            else:
                stalled += 1
                if stalled >= 2:
                    break           # deterministic: nothing will change
        raise AdmissionDenied(
            f"branch({entry.seq}, n={n}) cannot be admitted and no other "
            "work can free pages (-EAGAIN)")

    # ------------------------------------------------------------------
    # commit / abort
    # ------------------------------------------------------------------
    def commit(self, hd: int) -> Optional[int]:
        """First-commit-wins into the parent; returns the parent handle.

        The winner's content (pages, token tail, store delta) replaces
        the parent's atomically across every domain; every live sibling
        subtree is invalidated (observable as ``EV_INVALIDATED`` via
        ``poll``).  Losers of the race get ``StaleBranchError``
        (``-ESTALE``); committing a root is ``-EINVAL``.
        """
        entry = self._entry(hd)
        self._refresh(entry)
        if entry.resolved == "stale":
            raise StaleBranchError(
                f"handle {hd:#x} was invalidated by a sibling commit "
                "(-ESTALE)")
        if entry.resolved is not None:
            raise BranchStateError(f"handle {hd:#x} already resolved "
                                   f"({entry.resolved})")
        if entry.parent_hd is None:
            raise BranchStateError(
                "root branch cannot commit; finish() retires a request")
        try:
            if entry.rt_handle is not None:
                self.runtime.commit(entry.rt_handle)
            else:
                self.engine.commit(entry.seq)
        except StaleBranchError:
            entry.resolved = "stale"
            entry.events |= EV_INVALIDATED
            raise
        entry.resolved = "committed"
        entry.events |= EV_COMMITTED
        for sib_hd in entry.group:
            if sib_hd == hd:
                continue
            try:
                sib = self._entry(sib_hd)
            except BadHandleError:
                continue
            if sib.resolved is None:
                sib.resolved = "stale"
                sib.events |= EV_INVALIDATED
        return entry.parent_hd

    def abort(self, hd: int) -> None:
        """Discard this branch's subtree in every domain; siblings stay
        valid; a frozen origin with no other live children resumes."""
        entry = self._entry(hd)
        if entry.resolved is not None:
            return
        if entry.rt_handle is not None:
            self.runtime.abort(entry.rt_handle)
        elif entry.seq is not None and entry.seq in self.engine.kv.tree \
                and self.engine.kv.is_live(entry.seq):
            self.engine.abort(entry.seq)
        entry.resolved = "aborted"
        entry.events |= EV_INVALIDATED

    def truncate(self, hd: int, n_generated: int) -> None:
        """Keep only the first ``n_generated`` tokens generated on this
        branch — the speculative-decode verified-prefix primitive.
        Requires the branch to have been created ``BR_SPECULATIVE``
        (``-EPERM`` otherwise): only a declared draft may rewrite its
        own history before committing it.
        """
        entry = self._entry(hd)
        if not entry.flags & BR_SPECULATIVE:
            raise BranchError(
                f"handle {hd:#x} was not created BR_SPECULATIVE; "
                "truncation is reserved for declared drafts (-EPERM)",
                errno=Errno.EPERM)
        self.engine.truncate(entry.seq, entry.fork_len + n_generated)

    def verify(self, hd: int,
               drafts: Sequence[Sequence[int]]) -> List[List[int]]:
        """Score draft continuations of this branch in ONE fused device
        dispatch (the speculative-verify fast path).

        Each draft is k proposed next tokens; the returned row is the
        target's greedy token at every draft position (teacher-forced),
        so ``lcp(draft, row)`` is exactly what a sequential greedy
        verifier branch would have accepted — k decode dispatches
        collapsed into one, with no KV writes and no new branches.
        Works on a frozen fork origin (the usual caller: a policy whose
        drafts are live children of ``hd``).
        """
        entry = self._entry(hd)
        self._refresh(entry)
        if entry.resolved is not None:
            raise BranchStateError(
                f"handle {hd:#x} is resolved ({entry.resolved})")
        if entry.seq is None or not self.sched.is_tracked(entry.seq):
            raise BranchStateError(
                f"handle {hd:#x} is not schedulable; nothing to verify "
                "against")
        return self.sched.verify(entry.seq, drafts)

    # ------------------------------------------------------------------
    # eventing: poll / wait
    # ------------------------------------------------------------------
    def events(self, hd: int) -> int:
        """Current event mask of a handle (edge bits accumulate)."""
        entry = self._entry(hd)
        self._refresh(entry)
        return entry.events

    def _refresh(self, entry: _Entry) -> None:
        if entry.seq is None:
            self._try_bind(entry)
        if entry.parent_hd is None and entry.req_id is not None \
                and self.sched.finished(entry.req_id):
            if not entry.result_claimed:
                try:
                    entry.result = self.sched.result(entry.req_id)
                except BranchError:
                    entry.result = None   # evicted unfinished
                entry.result_claimed = True
            entry.events |= EV_FINISHED
        if entry.seq is not None and entry.resolved is None:
            tree = self.engine.kv.tree
            if entry.seq not in tree:
                if entry.parent_hd is not None:
                    # reaped underneath us: an ancestor resolved
                    entry.resolved = "stale"
                    entry.events |= EV_INVALIDATED
            else:
                status = tree.status(entry.seq)
                if status is BranchStatus.COMMITTED:
                    entry.resolved = "committed"
                    entry.events |= EV_COMMITTED
                elif status in (BranchStatus.STALE, BranchStatus.ABORTED):
                    entry.resolved = "stale"
                    entry.events |= EV_INVALIDATED

    def poll(self, hds: Optional[Sequence[int]] = None) -> Dict[int, int]:
        """Ready map ``{handle: events}`` over ``hds`` (default: every
        open handle); handles with no events are omitted, epoll-style."""
        out: Dict[int, int] = {}
        for hd in (self.open_handles() if hds is None else hds):
            ev = self.events(hd)
            if ev:
                out[hd] = ev
        return out

    def wait(self, hds: Sequence[int], *, events: int = EV_ANY,
             produced: Optional[int] = None, timeout_steps: int = 1000,
             require_all: bool = False, **decode_kw: Any) -> Dict[int, int]:
        """Block (stepping the scheduler) until a handle is ready.

        Sugar over :class:`~repro_torch.api.events.Waiter` for the common
        one-shot shape; build a ``Waiter`` directly to mix per-handle
        masks and produced targets.
        """
        w = Waiter(self)
        for hd in hds:
            w.add(hd, events, produced=produced)
        return w.wait(timeout_steps, require_all=require_all, **decode_kw)

    def decode_target_met(self, hd: int, target: int) -> bool:
        """Whether a branch produced ``target`` tokens past its fork
        point — or can never reach it (resolved, evicted, or its
        request's decode budget ran out first)."""
        entry = self._entry(hd)
        if entry.seq is None or not self.sched.is_tracked(entry.seq):
            return True
        if not self.engine.kv.is_live(entry.seq):
            return True
        req = self.sched.request_of(entry.seq)
        if req is None:
            return True
        produced = self.sched.produced(entry.seq)
        return produced >= target or produced >= req.max_new_tokens

    # ------------------------------------------------------------------
    # pacing + content
    # ------------------------------------------------------------------
    def resume(self, hd: int, *, greedy: Optional[bool] = None,
               temperature: Optional[float] = None) -> None:
        """Unpark a held branch (optionally pinning its sampling row).

        Demote-before-deny is transparent here: a branch the scheduler
        checkpointed out under page pressure is restored first (the
        token-identical promotion), so pacing callers never notice the
        round trip.  When the ledger cannot re-seat it *right now* the
        ``AdmissionDenied`` (``-EAGAIN``) surfaces to the caller as
        honest backpressure — retry after the pool drains.
        """
        entry = self._entry(hd)
        if entry.seq is None or not self.sched.is_tracked(entry.seq):
            return
        if greedy is not None or temperature is not None:
            self.sched.set_sampling(
                entry.seq,
                greedy=True if greedy is None else greedy,
                temperature=1.0 if temperature is None else temperature)
        if self.sched.is_checkpointed(entry.seq):
            self.sched.restore(entry.seq, unhold=True)
        else:
            self.sched.unhold(entry.seq)

    def pause(self, hd: int) -> None:
        """Park a branch: it keeps its reservations but stops decoding."""
        entry = self._entry(hd)
        if entry.seq is not None and self.sched.is_tracked(entry.seq):
            self.sched.hold(entry.seq)

    def checkpoint(self, hd: int) -> int:
        """Demote a branch's KV out of the device pool (session verb).

        Checkpoint implies :meth:`pause`: the branch is parked, its KV
        snapshot moves to the tier store (host RAM, spilling to disk),
        and its device pages return to the allocator — ``stat()``
        reports ``BR_TIERED`` until :meth:`restore`.  The branch stays
        live in the lifecycle tree; commit/abort/first-commit-wins
        semantics are untouched (a tiered loser's snapshot dies with its
        branch).  Returns the number of device pages freed.
        """
        entry = self._entry(hd)
        self._refresh(entry)
        if entry.seq is None or not self.sched.is_tracked(entry.seq):
            raise BranchStateError(
                f"handle {hd:#x} has no schedulable sequence to "
                "checkpoint")
        self.sched.hold(entry.seq)
        return self.sched.checkpoint(entry.seq)

    def restore(self, hd: int, *, resume: bool = False) -> None:
        """Promote a checkpointed branch back into device pages.

        Token-identical: the branch decodes exactly as if it had never
        left the device.  Admission discipline applies — ``-EAGAIN``
        (``AdmissionDenied``) when the ledger cannot re-seat the
        branch's reservation right now.  With ``resume`` the branch
        rejoins continuous batching immediately; otherwise it stays
        parked (the :meth:`pause` state checkpoint implied).
        """
        entry = self._entry(hd)
        self._refresh(entry)
        if entry.seq is None or not self.sched.is_tracked(entry.seq):
            raise BranchStateError(
                f"handle {hd:#x} has no schedulable sequence to restore")
        self.sched.restore(entry.seq, unhold=resume)

    def produced(self, hd: int) -> int:
        """Tokens generated past the owning request's prompt (0 if the
        branch no longer decodes)."""
        entry = self._entry(hd)
        if entry.seq is None or not self.sched.is_tracked(entry.seq):
            return 0
        return self.sched.produced(entry.seq)

    def tokens(self, hd: int) -> List[int]:
        """The branch's full token list (prompt + committed + own)."""
        entry = self._entry(hd)
        if entry.seq is not None and entry.seq in self.engine.token_domain:
            return self.engine.tokens(entry.seq)
        if entry.resolved == "committed" and entry.parent_hd is not None:
            return self.tokens(entry.parent_hd)
        if entry.parent_hd is None and entry.req_id is not None:
            if entry.result is not None:
                return list(entry.result)
            res = self.sched.peek_result(entry.req_id)
            if res is not None:
                return res
        raise BranchStateError(
            f"handle {hd:#x} has no token tail (invalidated and reaped)")

    def state_of(self, hd: int) -> Optional[StateContext]:
        """The branch's store-domain context (composite sessions)."""
        return self._entry(hd).state

    def seq_of(self, hd: int) -> Optional[int]:
        return self._entry(hd).seq

    def req_id_of(self, hd: int) -> Optional[int]:
        return self._entry(hd).req_id

    def tracked(self, hd: int) -> bool:
        """Whether the scheduler may still decode this branch."""
        entry = self._entry(hd)
        return entry.seq is not None and self.sched.is_tracked(entry.seq)

    def alive(self, hd: int) -> bool:
        entry = self._entry(hd)
        return entry.seq is not None and entry.seq in self.engine.kv.tree \
            and self.engine.kv.is_live(entry.seq)

    def status(self, hd: int) -> Optional[BranchStatus]:
        """Kernel status of the branch (None once reaped)."""
        entry = self._entry(hd)
        if entry.seq is None or entry.seq not in self.engine.kv.tree:
            return None
        return self.engine.kv.status(entry.seq)

    def siblings(self, hd: int) -> List[int]:
        """Every handle of this branch's exclusive commit group.

        The handle-table enforcement point of ``BR_ISOLATE``: an
        isolated branch cannot address its siblings — the one surface
        that exposes them refuses with ``-EPERM``.
        """
        entry = self._entry(hd)
        if entry.flags & BR_ISOLATE:
            raise BranchError(
                "BR_ISOLATE: sibling branch handles are not addressable "
                "(-EPERM)", errno=Errno.EPERM)
        return list(entry.group)

    # ------------------------------------------------------------------
    # stepping + retirement
    # ------------------------------------------------------------------
    @property
    def steps(self) -> int:
        return self.sched.steps

    @property
    def tp(self) -> int:
        """Tensor-parallel width of the underlying serving mesh.  Handles,
        flags and errno semantics do not depend on it."""
        return self.sched.tp

    def step(self, **decode_kw: Any) -> Dict[str, Any]:
        """One scheduling round (admission, batched decode, retirement).

        A closed session never steps: the call returns an idle record
        (``closed=True``) so retry loops observe zero progress and
        unwind instead of decoding against a shutting-down engine.
        """
        if self._closed:
            return {"admitted": 0, "batch": 0, "decoded": 0, "retired": 0,
                    "waiting": 0, "running": 0, "closed": True}
        return self.sched.step(**decode_kw)

    def finish(self, hd: int) -> Optional[List[int]]:
        """Retire the handle's request now and recycle its whole subtree.

        Force-retires the owning request (releasing pages, token tails
        and reservations across every domain), reaps the composite
        store subtree, closes **every** handle rooted at this request,
        and returns the final token list (``None`` if the request was
        evicted before finishing).  Idempotent: finishing a closed or
        already-finished handle returns ``None``.
        """
        try:
            entry = self._entry(hd)
        except BadHandleError:
            return None
        root_entry = entry
        if entry.root_hd != entry.hd:
            try:
                root_entry = self._entry(entry.root_hd)
            except BadHandleError:
                root_entry = entry
        if entry.req_id is not None:
            if not self.sched.finished(entry.req_id):
                self.sched.finish(entry.req_id)
            # the result record lives on the ROOT entry: refresh it so a
            # finish through a child handle still claims the one-shot
            # scheduler result instead of stranding it
            self._refresh(root_entry)
        tokens = root_entry.result
        if root_entry.state is not None and self.store is not None:
            state = root_entry.state
            try:
                if state.is_active:
                    state.abort()
            except BranchStateError:
                pass
            self.store.reap(state.branch_id)
            root_entry.state = None
        root_hd = entry.root_hd
        for idx, slot in enumerate(self._slots):
            if slot is not None and slot.root_hd == root_hd:
                self._slots[idx] = None
                self._gens[idx] = (slot.gen + 1) & _GEN_MASK or 1
                self._free.append(idx)
        return tokens

    def result(self, hd: int) -> Optional[List[int]]:
        """The finished request's final token list (claimed once from
        the scheduler, cached on the handle thereafter)."""
        entry = self._entry(hd)
        self._refresh(entry)
        return None if entry.result is None else list(entry.result)

    # ------------------------------------------------------------------
    # introspection: stat() / tree()
    # ------------------------------------------------------------------
    def stat(self, hd: Optional[int] = None, *,
             metrics: bool = False) -> Dict[str, Any]:
        """Procfs-style status (``/proc/<pid>/stat``).

        With a handle: that branch's view.  Without one
        (``session.stat(metrics=True)``): the whole-session ``tree()``
        view.  ``metrics=True`` attaches the obs-registry snapshot
        (counters/gauges/histograms) plus per-branch page footprints —
        the machine-readable face of ``format_tree(metrics=True)``.
        """
        if hd is None:
            out = self.tree()
        else:
            out = self._stat_one(hd)
        if metrics:
            out["metrics"] = self.obs.metrics.snapshot()
            out["footprints"] = self.engine.kv.footprints()
        return out

    def _stat_one(self, hd: int) -> Dict[str, Any]:
        entry = self._entry(hd)
        self._refresh(entry)
        status = self.status(hd)
        in_tree = entry.seq is not None and entry.seq in self.engine.kv.tree
        tiered = in_tree and self.engine.kv.is_tiered(entry.seq)
        return {
            "hd": entry.hd,
            "seq": entry.seq,
            "req_id": entry.req_id,
            "parent": entry.parent_hd,
            "depth": entry.depth,
            # BR_TIERED is a runtime state, not a creation flag: it
            # appears here while the branch is checkpointed out
            "flags": flag_names(entry.flags | (BR_TIERED if tiered else 0)),
            "events": event_names(entry.events),
            "status": status.value if status is not None else "reaped",
            "resolved": entry.resolved,
            "group_size": len(entry.group),
            "produced": self.produced(hd),
            "pages": (len(self.engine.kv.block_table(entry.seq))
                      if in_tree else 0),
            "reserved_pages": (self.sched.reserved_pages(entry.seq)
                               if entry.seq is not None else 0),
            "held": (entry.seq is not None
                     and self.sched.is_held(entry.seq)),
            "tiered": tiered,
        }

    def tree(self) -> Dict[str, Any]:
        """Procfs-style view of the whole session: the lifecycle forest,
        page-pool/ledger utilization, and handle-table occupancy."""
        st = self.sched.stats()
        pool_total = st["pages_total"]
        return {
            "branches": self.engine.kv.tree.snapshot(),
            "pool": {
                "pages_total": pool_total,
                "pages_free": st["pages_free"],
                "pages_shared": st["pages_shared"],
                "pages_reserved": st["pages_reserved"],
                "utilization": 1.0 - st["pages_free"] / max(pool_total, 1),
            },
            "scheduler": {
                "steps": st["steps"],
                "tokens_generated": st["tokens_generated"],
                "waiting": st["waiting"],
                "running": st["running"],
                "held": st["held"],
                "checkpointed": st.get("checkpointed", 0),
                "tp": st.get("tp", 1),
            },
            "handles": {
                "open": len(self.open_handles()),
                "table_size": len(self._slots),
            },
        }

    def trace(self, path) -> dict:
        """Export the session's Chrome/Perfetto timeline to ``path``.

        Only meaningful when the engine was built with
        ``Observability(trace=True)``; an untraced session writes a
        valid-but-empty trace.  Open the file at
        https://ui.perfetto.dev or chrome://tracing.
        """
        return self.obs.tracer.export_chrome_trace(path)

    def format_tree(self, metrics: bool = False) -> str:
        """Human-readable ``tree()`` (the ``cat /proc/branches`` view).

        ``metrics=True`` appends the obs registry as a procfs-style
        block — the ``--metrics``/``--trace`` one-screen summary.
        """
        view = self.tree()
        lines: List[str] = []

        def walk(node: Dict[str, Any], indent: int) -> None:
            lines.append("  " * indent +
                         f"seq {node['id']} [{node['status']}]"
                         f" group={node['group']} epoch={node['epoch']}")
            for child in node["children"]:
                walk(child, indent + 1)

        for root in view["branches"]:
            walk(root, 0)
        pool = view["pool"]
        lines.append(
            f"pool: {pool['pages_free']}/{pool['pages_total']} free, "
            f"{pool['pages_reserved']} reserved, "
            f"{pool['pages_shared']} shared "
            f"({pool['utilization']:.0%} used); "
            f"handles: {view['handles']['open']} open")
        if metrics:
            lines.append("metrics:")
            lines.extend("  " + ln
                         for ln in self.obs.metrics.format().splitlines())
        return "\n".join(lines)


__all__ = ["BranchSession"]
