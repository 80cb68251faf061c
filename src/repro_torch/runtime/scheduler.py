"""Serving scheduler — admission, continuous batching, fork admission.

The port's copy of ``repro/runtime/scheduler.py``; the one change is the
sampling stream: a ``torch.Generator`` on the engine's device where the
JAX package splits a ``PRNGKey``.

The engine/scheduler split mirrors production LLM servers: the
:class:`~repro_torch.runtime.serve_loop.ServeEngine` owns the device step and
the per-sequence state domains (pages + token tails on the shared
lifecycle kernel), while the :class:`Scheduler` decides *what runs when*:

* **Admission** — requests wait in a FIFO behind a worst-case page
  **reservation ledger**: a request is admitted only when the pool can
  hold ``pages_for(prompt + max_new_tokens)`` on top of every reservation
  already outstanding, so an admitted request can always decode to
  completion — the pool cannot -ENOSPC mid-flight.  A request whose
  worst case exceeds the pool, or the per-sequence block-table limit,
  can never run and is rejected at ``submit`` (``AdmissionDenied``).
* **Continuous batching** — every step decodes all runnable sequences
  (live, unfrozen, unfinished), chunked into device batches; new
  requests join the running batch at page-granularity with no draining.
* **Page-budget-aware fork admission** — ``fork`` is denied (not
  crashed) when the ledger cannot absorb the worst-case cost of ``n``
  branches (one CoW'd tail page each plus every page the branch may
  still append before its request's decode budget runs out).  Agentic
  exploration degrades gracefully under memory pressure (-EAGAIN)
  instead of taking down the serving loop.

Branch bookkeeping is intentionally absent here: the scheduler tracks
only which sequence ids it may decode (and their reservations), and asks
the lifecycle kernel for liveness each step, so commits/aborts/
invalidations performed by agents (directly or through
:class:`~repro_torch.core.runtime_api.BranchRuntime`) are observed without any
scheduler-side state machine (DESIGN §3).  Subtrees that resolve are
*reaped* from the kernel once the scheduler stops tracking them, so a
long-running loop does not accumulate lifecycle nodes or payload
entries for retired work.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

# AdmissionDenied lives in the shared errno vocabulary
# (repro_torch.core.errors); re-exported here as in the JAX package.
from repro_torch.core.errors import AdmissionDenied, BranchError, Errno
from repro_torch.core.lifecycle import BranchStatus
from repro_torch.obs import ENGINE_TRACK
from repro_torch.obs.tracer import NO_SPAN
from repro_torch.runtime.serve_loop import ServeEngine


@dataclass
class SchedulerConfig:
    max_batch: int = 8          # device batch width per decode dispatch
    seed: int = 0               # scheduler-owned generator for sampled decode


@dataclass
class Request:
    """One user request: a prompt plus a decode budget."""

    req_id: int
    prompt: List[int]
    max_new_tokens: int
    worst_pages: int = 0               # pages_for(prompt + max_new_tokens)
    seq: Optional[int] = None          # assigned at admission
    hold_on_admit: bool = False        # park immediately (explorations)
    submitted_ns: int = 0              # queue-wait clock start


class Scheduler:
    """Admission + continuous batching over the engine's live branches.

    .. deprecated:: the raw verbs (``submit``/``fork``/``hold``/``wait``/
       ``finish``/``result``) are the *mechanism* behind
       :class:`repro_torch.api.BranchSession` and remain stable for internal
       use, but application code should enter through ``repro_torch.api`` —
       one handle table, one flags word, one errno discipline, and a
       poll/wait event interface over every state domain.
    """

    def __init__(self, engine: ServeEngine,
                 config: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        self._req_ids = itertools.count(0)
        self._waiting: List[Request] = []
        self._requests: Dict[int, Request] = {}
        # every sequence the scheduler may decode, mapped to its request
        self._seq_owner: Dict[int, int] = {}
        # worst-case pages each tracked sequence may still hold from the
        # pool; the sum over all tracked sequences never exceeds the pool
        self._reserved: Dict[int, int] = {}
        # finished token lists, claimed one-shot via result()
        self._results: Dict[int, List[int]] = {}
        # sequences parked by an exploration driver: tracked (they keep
        # their reservations) but neither decoded nor auto-retired until
        # released — the policy, not the budget, decides their pace
        self._holds: set = set()
        # reservations of checkpointed (tiered) sequences: moved out of
        # the live ledger — their device pages are freed — and moved
        # back at restore() after a budget re-check
        self._tiered_reserved: Dict[int, int] = {}
        # per-sequence sampling overrides: seq -> (greedy, temperature)
        self._sampling: Dict[int, tuple] = {}
        # sampled decode draws from this stream on the engine's device
        self._generator = torch.Generator(
            device=engine.device).manual_seed(self.config.seed)
        self.steps = 0
        self.tokens_generated = 0
        # admission outcomes + ledger telemetry, on the engine's hub
        self.obs = engine.obs
        m = self.obs.metrics
        self._c_submitted = m.counter("sched.submitted")
        self._c_rejected = m.counter("sched.rejected")
        self._c_admitted = m.counter("sched.admitted")
        self._c_forks_admitted = m.counter("sched.forks_admitted")
        self._c_forks_denied = m.counter("sched.forks_denied")
        self._c_retired = m.counter("sched.retired")
        self._c_demotions = m.counter("sched.demotions")
        self._c_restores = m.counter("sched.restores")
        self._h_admission_wait = m.histogram("sched.admission_wait_us")
        self._g_reserved = m.gauge("sched.pages_reserved")

    @property
    def tp(self) -> int:
        """Tensor-parallel width of the engine's serving mesh.  The
        scheduler itself is mesh-agnostic: its ledger counts pages, and a
        page id means the same on every shard."""
        return self.engine.tp

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.engine.page_size)

    def _pages_reserved(self) -> int:
        return sum(self._reserved.values())

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               *, hold: bool = False) -> int:
        """Queue a request; it is admitted when the page budget allows.

        With ``hold=True`` the admitted root is parked in the same
        admission transaction — it never decodes a token until its owner
        (an exploration policy) releases it, regardless of where in a
        scheduler step the admission lands.

        A request that could never run to completion — its worst case
        (prompt + full decode budget) exceeds the pool even entirely
        free, or the per-sequence block-table limit — is rejected up
        front (``AdmissionDenied``) instead of blocking the FIFO head or
        blowing up a later decode step.
        """
        worst = self._pages_for(len(prompt) + max_new_tokens)
        self._c_submitted.inc()
        if worst > self.engine.kv.num_pages:
            self._c_rejected.inc()
            raise AdmissionDenied(
                f"request needs up to {worst} pages but the pool only has "
                f"{self.engine.kv.num_pages}; it can never be admitted",
                errno=Errno.ENOSPC)
        if worst > self.engine.max_pages:
            self._c_rejected.inc()
            raise AdmissionDenied(
                f"request needs up to {worst} pages but a sequence's block "
                f"table holds at most {self.engine.max_pages}; it can "
                "never decode to completion", errno=Errno.ENOSPC)
        req = Request(req_id=next(self._req_ids), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, worst_pages=worst,
                      hold_on_admit=hold,
                      submitted_ns=time.perf_counter_ns())
        self._requests[req.req_id] = req
        self._waiting.append(req)
        return req.req_id

    def _demote_for(self, deficit: int) -> int:
        """Checkpoint held branches until ``deficit`` reservation pages
        free up (demote-before-deny).  Held branches are the coldest
        work the scheduler owns — parking them in the tier store instead
        of denying the FIFO head turns page pressure into host/disk
        bytes.  Branches that cannot demote (frozen origins, already
        tiered) are skipped.  Returns the reservation pages released.
        """
        released = 0
        for seq in sorted(s for s in self._holds if s in self._reserved):
            if released >= deficit:
                break
            worst = self._reserved[seq]
            try:
                self.checkpoint(seq)
            except BranchError:
                continue
            released += worst
        return released

    def admit(self) -> List[int]:
        """Admit waiting requests in FIFO order while reservations fit.

        When the head request does not fit, held branches are demoted to
        the tier store before the head is made to wait (demote-before-
        deny) — admission is denied only once nothing else can move.
        """
        admitted: List[int] = []
        while self._waiting:
            req = self._waiting[0]
            budget = self.engine.kv.num_pages - self._pages_reserved()
            if req.worst_pages > budget:
                self._demote_for(req.worst_pages - budget)
                budget = self.engine.kv.num_pages - self._pages_reserved()
            if req.worst_pages > budget:
                break   # FIFO: do not starve the head request
            self._waiting.pop(0)
            req.seq = self.engine.add_request(req.prompt)
            self._seq_owner[req.seq] = req.req_id
            self._reserved[req.seq] = req.worst_pages
            if req.hold_on_admit:
                self._holds.add(req.seq)
            admitted.append(req.req_id)
            self._c_admitted.inc()
            self._h_admission_wait.observe(
                (time.perf_counter_ns() - req.submitted_ns) / 1000.0)
        if admitted:
            self._g_reserved.set(self._pages_reserved())
        return admitted

    # ------------------------------------------------------------------
    # fork admission
    # ------------------------------------------------------------------
    def _fork_cost(self, seq: int, n: int) -> tuple:
        """(worst-case pages ``fork(seq, n)`` needs, current free budget)."""
        if seq not in self._seq_owner:
            raise BranchError(f"sequence {seq} is not scheduled here")
        req = self._requests[self._seq_owner[seq]]
        table_len = len(self.engine.kv.block_table(seq))
        child_cost = req.worst_pages - table_len + 1
        budget = self.engine.kv.num_pages - self._pages_reserved()
        return n * child_cost, budget

    def can_fork(self, seq: int, n: int) -> bool:
        """Whether ``fork(seq, n)`` would be admitted right now.

        Side-effect free: composite creates use it to check the cheap
        ledger BEFORE forking other domains, so a backpressure retry
        loop does not churn (fork + unwind) the store tree every round.
        """
        needed, budget = self._fork_cost(seq, n)
        return needed <= budget

    def fork(self, seq: int, n: int, *, eager_cow: bool = False) -> List[int]:
        """Fork ``n`` exploration branches if the page budget allows.

        All ``n`` siblings are admitted under ONE reservation-ledger
        transaction (one cost check, one exclusive commit group) — the
        vectorized-fork property ``repro_torch.api``'s ``branch(parent, n=k)``
        builds on.  Worst case each branch CoW-faults its shared tail
        page and then grows its table from the fork point to the
        request's full decode budget; deny the fork (``AdmissionDenied``)
        rather than let a later decode step hit -ENOSPC.  The frozen
        origin keeps its own reservation (it holds its pages and resumes
        when the children resolve), so shared pages are never
        double-booked.  ``eager_cow`` hoists every child's tail-page CoW
        into one fused device dispatch here (see ``ServeEngine.fork``);
        the ledger already reserves that page per child.
        """
        needed, budget = self._fork_cost(seq, n)
        if needed > budget:
            self._c_forks_denied.inc()
            raise AdmissionDenied(
                f"fork({seq}, n={n}) needs up to {needed} free "
                f"pages, budget is {budget} (-EAGAIN)")
        child_cost = needed // n
        children = self.engine.fork(seq, n, eager_cow=eager_cow)
        self._c_forks_admitted.inc(n)
        owner = self._seq_owner[seq]
        for c in children:
            self._seq_owner[c] = owner
            self._reserved[c] = child_cost
            # children inherit the origin's pacing and sampling so an
            # exploration's subtree stays under its driver's control
            if seq in self._holds:
                self._holds.add(c)
            if seq in self._sampling:
                self._sampling[c] = self._sampling[seq]
        self._g_reserved.set(self._pages_reserved())
        return children

    # ------------------------------------------------------------------
    # exploration pacing (holds + per-sequence sampling)
    # ------------------------------------------------------------------
    def hold(self, seq: int) -> None:
        """Park a tracked sequence: no decode, no auto-retire."""
        if seq not in self._seq_owner:
            raise BranchError(f"sequence {seq} is not scheduled here")
        self._holds.add(seq)

    def unhold(self, seq: int) -> None:
        if seq in self._tiered_reserved:
            raise BranchError(
                f"sequence {seq} is checkpointed to the tier store; "
                "restore() it before unholding (-EAGAIN)",
                errno=Errno.EAGAIN)
        self._holds.discard(seq)

    def is_held(self, seq: int) -> bool:
        return seq in self._holds

    # ------------------------------------------------------------------
    # tiering (checkpoint / restore with ledger movement)
    # ------------------------------------------------------------------
    def checkpoint(self, seq: int) -> int:
        """Demote a tracked, held branch's KV to the tier store.

        The branch's reservation leaves the live ledger (its device
        pages are freed), so the pages it was holding become admissible
        budget; the reservation is remembered and re-checked at
        :meth:`restore`.  Only held branches may checkpoint — a decoding
        branch would just fault straight back in.  Returns the number of
        device pages freed.
        """
        if seq not in self._seq_owner:
            raise BranchError(f"sequence {seq} is not scheduled here")
        if seq not in self._holds:
            raise BranchError(
                f"sequence {seq} must be held before checkpoint; a "
                "running branch cannot leave the device (-EINVAL)",
                errno=Errno.EINVAL)
        n = self.engine.checkpoint(seq)
        worst = self._reserved.pop(seq, 0)
        self._tiered_reserved[seq] = worst
        self._g_reserved.set(self._pages_reserved())
        self._c_demotions.inc()
        return n

    def restore(self, seq: int, *, unhold: bool = False) -> None:
        """Promote a tiered branch back into device pages.

        Re-checks the reservation against the live ledger first —
        restoring must honor the same admission discipline as new work
        (``AdmissionDenied``/-EAGAIN when it does not fit; demote or
        retire something and retry).  With ``unhold`` the branch rejoins
        continuous batching immediately.
        """
        if seq not in self._seq_owner:
            raise BranchError(f"sequence {seq} is not scheduled here")
        worst = self._tiered_reserved.get(seq)
        if worst is None:
            raise BranchError(
                f"sequence {seq} is not tiered (-EINVAL)",
                errno=Errno.EINVAL)
        budget = self.engine.kv.num_pages - self._pages_reserved()
        if worst > budget:
            raise AdmissionDenied(
                f"restoring sequence {seq} needs {worst} reserved pages, "
                f"budget is {budget} (-EAGAIN)")
        self.engine.restore(seq)
        self._reserved[seq] = self._tiered_reserved.pop(seq)
        self._g_reserved.set(self._pages_reserved())
        self._c_restores.inc()
        if unhold:
            self._holds.discard(seq)

    def is_checkpointed(self, seq: int) -> bool:
        return seq in self._tiered_reserved

    def set_sampling(self, seq: int, *, greedy: bool = True,
                     temperature: float = 1.0) -> None:
        """Per-sequence decode settings applied by :meth:`step`."""
        if seq not in self._seq_owner:
            raise BranchError(f"sequence {seq} is not scheduled here")
        self._sampling[seq] = (bool(greedy), float(temperature))

    def verify(self, seq: int,
               drafts: Sequence[Sequence[int]]) -> List[List[int]]:
        """Fused speculative verify on a tracked sequence.

        Pure scoring — one device dispatch for all drafts × k positions,
        no KV writes, no ledger movement (the sequence's reservation and
        hold state are untouched).  See ``ServeEngine.spec_verify``.
        """
        if seq not in self._seq_owner:
            raise BranchError(f"sequence {seq} is not scheduled here")
        return self.engine.spec_verify(seq, drafts)

    def produced(self, seq: int) -> int:
        """Tokens generated beyond the owning request's prompt."""
        req = self._requests[self._seq_owner[seq]]
        return self.engine.kv.length(seq) + 1 - len(req.prompt)

    def is_tracked(self, seq: int) -> bool:
        """Whether this scheduler may still decode ``seq``."""
        return seq in self._seq_owner

    def reserved_pages(self, seq: int) -> int:
        """Worst-case pages the ledger still reserves for ``seq`` (0 if
        untracked) — surfaced in ``repro_torch.api``'s ``stat()``."""
        return self._reserved.get(seq, 0)

    def request_of(self, seq: int) -> Optional[Request]:
        """The owning request of a tracked sequence (None if untracked
        or the request record is already gone)."""
        rid = self._seq_owner.get(seq)
        return None if rid is None else self._requests.get(rid)

    def waiting_head(self) -> Optional[Request]:
        """The admission FIFO's head request (None when the queue is
        empty).  Admission is strictly FIFO, so the head is the *only*
        request whose reservation shortfall matters — a tenancy layer
        relieving page pressure (preempting held/speculative branches)
        targets exactly this request's deficit."""
        return self._waiting[0] if self._waiting else None

    def admission_deficit(self) -> int:
        """Pages the FIFO head still lacks (0 when it fits or no queue).

        ``worst_pages(head) - (pool - reserved)``, clamped at 0: how
        many pages preemption must recycle before the next ``admit()``
        round can seat the head request.
        """
        head = self.waiting_head()
        if head is None:
            return 0
        budget = self.engine.kv.num_pages - self._pages_reserved()
        return max(0, head.worst_pages - budget)

    def peek_result(self, req_id: int) -> Optional[List[int]]:
        """A finished request's tokens without claiming them (None while
        pending or after the one-shot :meth:`result` claim)."""
        res = self._results.get(req_id)
        return None if res is None else list(res)

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------
    def _request_done(self, req: Request, seq: int) -> bool:
        # kv.length == len(tokens) - 1 (last token pending), so produced
        # count is O(1) host work — no token-list copy on the hot path
        produced = self.engine.kv.length(seq) + 1 - len(req.prompt)
        if produced >= req.max_new_tokens:
            return True
        # belt-and-suspenders: stop before the next append could overflow
        # the per-sequence block table (submit() makes this unreachable
        # for its own requests)
        return (self._pages_for(self.engine.kv.length(seq) + 1)
                > self.engine.max_pages)

    def _untrack(self, seq: int) -> None:
        rid = self._seq_owner.pop(seq, None)
        if self._reserved.pop(seq, None) is not None:
            self._g_reserved.set(self._pages_reserved())
        self._tiered_reserved.pop(seq, None)
        self._holds.discard(seq)
        self._sampling.pop(seq, None)
        if rid is not None:
            req = self._requests.get(rid)
            if req is not None and req.seq == seq:
                # the request's *root* resolved without retiring (evicted
                # or invalidated): it can never finish — drop it outright
                self._requests.pop(rid, None)

    def _drop(self, seq: int) -> None:
        """Stop tracking a sequence: free its reservation, GC its nodes."""
        self._untrack(seq)
        if self.engine.kv.tree.reap(seq):
            # the reap removes the whole resolved subtree, which may
            # include other tracked branches (e.g. children of an
            # aborted interior branch) — purge them too
            for s in list(self._seq_owner):
                if s not in self.engine.kv.tree:
                    self._untrack(s)

    def runnable(self) -> List[int]:
        """Sequences that may decode this step.

        Asks the lifecycle kernel directly: ACTIVE sequences run, FROZEN
        origins wait for their children, and anything resolved by a
        commit/abort/invalidation is dropped from tracking (and its
        resolved subtree reaped from the kernel).
        """
        out: List[int] = []
        for seq in list(self._seq_owner):
            if seq not in self._seq_owner:
                continue   # dropped with an earlier subtree this round
            if seq not in self.engine.kv.tree:
                self._untrack(seq)   # reaped externally (release/evict)
                continue
            status = self.engine.kv.status(seq)
            if status is BranchStatus.ACTIVE:
                out.append(seq)
            elif status is not BranchStatus.FROZEN:
                # resolved (committed / aborted / stale): stop tracking
                self._drop(seq)
        return out

    def _retire(self, seq: int) -> None:
        rid = self._seq_owner[seq]
        node = self.engine.kv.tree.node(seq)
        if node.parent is None:
            # a finished root request leaves the engine entirely;
            # release() invalidates and reaps every domain's entries,
            # and the Request itself moves to the one-shot result slot
            # so host state stays bounded in a long-running loop
            self._results[rid] = self.engine.tokens(seq)
            self._requests.pop(rid, None)
            self.engine.release(seq)
            self._seq_owner.pop(seq, None)
            self._reserved.pop(seq, None)
            self._g_reserved.set(self._pages_reserved())
            self._c_retired.inc()
        # a finished *branch* stays live: the agent decides commit/abort

    def step(self, *, greedy: bool = True, temperature: float = 1.0,
             generator: Union[torch.Generator, int, None] = None
             ) -> Dict[str, Any]:
        """One scheduling round: admit, batch-decode, retire.

        Sampled rows draw from ``generator`` (a generator on the engine's
        device, or an int seed for a fresh one) when given, else from the
        scheduler's own stream.  Returns counters for the serving loop /
        benchmarks.
        """
        tr = self.obs.tracer
        with (tr.span(ENGINE_TRACK, "sched.step") if tr.enabled
              else NO_SPAN) as span:
            gen = (self._generator if generator is None
                   else self._as_generator(generator))
            admitted = self.admit()
            batch = [s for s in self.runnable()
                     if s not in self._holds and not self._request_done(
                         self._requests[self._seq_owner[s]], s)]
            decoded = 0
            for lo in range(0, len(batch), self.config.max_batch):
                group = batch[lo: lo + self.config.max_batch]
                g_row = [self._sampling.get(s, (greedy, temperature))[0]
                         for s in group]
                t_row = [self._sampling.get(s, (greedy, temperature))[1]
                         for s in group]
                # a generator advances with every draw: each group (and each
                # step) gets fresh noise from the one stream
                self.engine.decode(group, greedy=g_row, temperature=t_row,
                                   generator=None if all(g_row) else gen)
                decoded += len(group)
            retired = 0
            if span is not None:
                tr.phase(ENGINE_TRACK, "sched.retire")
            for seq in self.runnable():   # re-asks the kernel; purges resolved
                if seq in self._holds:
                    continue   # an exploration owns this sequence's pace
                req = self._requests.get(self._seq_owner[seq])
                if req is not None and self._request_done(req, seq):
                    self._retire(seq)
                    retired += int(seq not in self._seq_owner)
            self.steps += 1
            self.tokens_generated += decoded
            return {
                "admitted": len(admitted),
                "batch": len(batch),
                "decoded": decoded,
                "retired": retired,
                "waiting": len(self._waiting),
                "running": len(self._seq_owner),
            }

    def _as_generator(self, generator: Union[torch.Generator, int]
                      ) -> torch.Generator:
        """A caller's generator (checked to live on the engine's device),
        or a fresh one on that device seeded with an int."""
        if isinstance(generator, torch.Generator):
            if generator.device.type != self.engine.device.type:
                raise ValueError(
                    f"sampling generator on {generator.device}, engine on "
                    f"{self.engine.device}: they must share a device")
            return generator
        return torch.Generator(device=self.engine.device).manual_seed(
            int(generator))

    def seed_sampling(self, generator: Union[torch.Generator, int]) -> None:
        """Reseed the scheduler-owned stream for sampled decode: adopt a
        generator on the engine's device, or reseed from an int."""
        self._generator = self._as_generator(generator)

    def _absorb_key(self, decode_kw: Dict[str, Any]) -> Dict[str, Any]:
        """Fold a caller generator into the scheduler's own stream.

        Repeated-step APIs must not hand one seed to every step — each
        step would draw identical sampling noise.  Reseeding the
        internal stream once instead gives every step fresh draws.
        """
        generator = decode_kw.pop("generator", None)
        if generator is not None:
            self.seed_sampling(generator)
        return decode_kw

    def run(self, max_steps: int = 1000, **decode_kw: Any) -> int:
        """Step until no work remains; returns tokens generated."""
        decode_kw = self._absorb_key(decode_kw)
        t0 = self.tokens_generated
        for _ in range(max_steps):
            st = self.step(**decode_kw)
            if st["decoded"] == 0 and st["waiting"] == 0:
                break
        return self.tokens_generated - t0

    # ------------------------------------------------------------------
    # completion / wait primitives
    # ------------------------------------------------------------------
    def finished(self, req_id: int) -> bool:
        """True once the request can no longer produce more tokens —
        its result is claimable (or was already claimed / evicted)."""
        return req_id not in self._requests

    def finish(self, req_id: int) -> None:
        """Force-retire a request now (exploration decided it is done).

        The paper's commit-terminates-the-search: a policy that committed
        its winner before the decode budget ran out retires the request
        early instead of letting continuous batching keep decoding the
        root.  Captures the result, releases the root's whole subtree
        across every domain, and frees all its reservations.  A request
        still waiting in the FIFO is cancelled with an empty result;
        finishing an unknown/finished request is a no-op.
        """
        req = self._requests.pop(req_id, None)
        if req is None:
            return
        if req.seq is None:
            self._waiting.remove(req)
            self._results[req_id] = []
            return
        if req.seq in self.engine.kv.tree:
            self._results[req_id] = self.engine.tokens(req.seq)
            self.engine.release(req.seq)   # invalidates + reaps subtree
        else:
            self._results[req_id] = []
        for s in list(self._seq_owner):
            if s not in self.engine.kv.tree:
                self._untrack(s)

    def wait(self, req_id: int, max_steps: int = 1000,
             **decode_kw: Any) -> List[int]:
        """Step the scheduler until ``req_id`` finishes; claim its result."""
        decode_kw = self._absorb_key(decode_kw)
        for _ in range(max_steps):
            if self.finished(req_id):
                break
            self.step(**decode_kw)
        if not self.finished(req_id):
            raise BranchError(
                f"request {req_id} did not finish in {max_steps} steps")
        return self.result(req_id)

    # ------------------------------------------------------------------
    def result(self, req_id: int) -> List[int]:
        """Claim the final token list of a retired request.

        One-shot: claiming drops the request's last host state, so a
        long-running loop stays bounded.  Returns ``[]`` while the
        request is still queued or decoding; raises ``BranchError`` for
        an unknown (or already-claimed, or evicted-unfinished) request.
        """
        if req_id in self._results:
            return self._results.pop(req_id)
        if req_id in self._requests:
            return []
        raise BranchError(f"unknown or already-claimed request {req_id}")

    def seq_of(self, req_id: int) -> int:
        """The admitted root sequence of a request (its fork origin)."""
        seq = self._requests[req_id].seq
        if seq is None:
            raise BranchError(f"request {req_id} not admitted yet")
        return seq

    def stats(self) -> Dict[str, Any]:
        st = self.engine.stats()
        st.update(steps=self.steps, tokens_generated=self.tokens_generated,
                  waiting=len(self._waiting), running=len(self._seq_owner),
                  held=len(self._holds),
                  checkpointed=len(self._tiered_reserved),
                  pages_reserved=self._pages_reserved())
        return st


__all__ = ["AdmissionDenied", "Request", "Scheduler", "SchedulerConfig"]
