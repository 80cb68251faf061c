"""The engine multiplexer — one background loop, every tenant's batch.

The port's copy of ``repro/server/multiplex.py``.  The serving stack's
blocking model (``Scheduler.step`` launches the step's kernels; ``Waiter``
spins on it) and asyncio's cooperative model meet exactly here and nowhere
else:

* **One engine thread** owns the :class:`~repro_torch.api.BranchSession`,
  the :class:`~repro_torch.explore_ctx.driver.ExplorationDriver`, and
  every tensor of the engine: every kernel launch happens on it, and
  everything it hands to the asyncio side is Python ints, floats and
  strings.  Each iteration it (1) executes commands the asyncio side
  posted, (2) relieves page pressure by preempting held/speculative
  work for higher-priority FIFO heads, (3) runs ONE ``driver.step()`` —
  admission, one continuous batched decode over *all* tenants' runnable
  branches, retirement, policy resumption — and (4) publishes per-stream
  deltas.  There is no per-request loop: a thousand concurrent streams
  cost the same number of device dispatches as one busy stream.
* **Commands** (``await mux.call(fn)``) marshal session access onto the
  engine thread: the asyncio side never touches the session directly,
  so the handle table and ledger need no locks.
* **Streams** are plain ``asyncio.Queue``\\ s; the engine thread pushes
  SSE-shaped ``(event, data)`` tuples via ``loop.call_soon_threadsafe``
  — tokens as they decode, ``Waiter``-style lifecycle events
  (``admitted``/``evicted``/``finished``), and the terminal result.
* **Idle costs nothing.**  With no runnable work the thread parks on a
  condition variable; a posted command (or stop) wakes it.
* **A crash reaches every client.**  An exception on the engine thread
  ends every open stream with an ``error`` event, fails every command
  still queued, and marks the loop not running (new work answers 503,
  ``/healthz`` 500) instead of leaving awaiters hanging.

Eviction (preemption and shutdown drain) goes through
``session.finish`` — the one verb that releases a request's whole
subtree across every domain and *returns the tokens committed so far* —
so a preempted tenant keeps its committed chain and observes an
``EV_INVALIDATED``-style event instead of a mid-decode ``-ENOSPC``.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, Generator, List, Optional

import torch

from repro_torch.core.errors import BranchError, BranchStateError
from repro_torch.explore_ctx.context import policy_result
from repro_torch.explore_ctx.driver import Decode, _WaitFork
from repro_torch.server.tenancy import ServedRequest, TenancyManager


def chat_policy(ctx, *, tokens: int, greedy: bool = True,
                temperature: float = 1.0) -> Generator:
    """Plain generation as a (trivial) exploration policy.

    Routing chat through the driver keeps ONE stepping surface: a chat
    request's decode rides the same continuous batch, pacing (holds)
    and cleanup (``session.finish`` on return) as every policy run.
    """
    yield Decode([ctx], tokens, greedy=greedy, temperature=temperature)
    return policy_result(ctx, committed=False, policy="chat")


def jsonable(x: Any) -> Any:
    """Sanitize policy stats for JSON: numpy/torch scalars → Python.

    A tensor is read back through numpy, so the JSON is the JAX package's:
    one element becomes its number (on the card a sync of the engine
    thread, once per request where a result carries one; token events
    carry Python ints), more than one prints as numpy prints an array."""
    if isinstance(x, bool) or x is None or isinstance(x, (int, str)):
        return x
    if isinstance(x, float):
        return x
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if hasattr(x, "item"):
        try:
            return jsonable(x.item())
        except (TypeError, ValueError):
            pass    # multi-element array: fall through to str()
    return str(x)


class Registry:
    """Server-side request records: live map + bounded completed ring."""

    def __init__(self, keep_completed: int = 512):
        self._next_sid = 0
        self.live: "OrderedDict[int, ServedRequest]" = OrderedDict()
        self.completed: "OrderedDict[int, ServedRequest]" = OrderedDict()
        self.by_req: Dict[int, ServedRequest] = {}
        self._keep = keep_completed

    def new_sid(self) -> int:
        sid, self._next_sid = self._next_sid, self._next_sid + 1
        return sid

    def add(self, rec: ServedRequest) -> None:
        self.live[rec.sid] = rec
        if rec.req_id is not None:
            self.by_req[rec.req_id] = rec

    def complete(self, rec: ServedRequest) -> None:
        self.live.pop(rec.sid, None)
        if rec.req_id is not None:
            self.by_req.pop(rec.req_id, None)
        self.completed[rec.sid] = rec
        while len(self.completed) > self._keep:
            self.completed.popitem(last=False)

    def get(self, sid: int) -> Optional[ServedRequest]:
        return self.live.get(sid) or self.completed.get(sid)

    def refresh_req_ids(self) -> None:
        """Learn req_ids assigned since launch (a driver Submit executes
        on a later engine step than the record's creation)."""
        for rec in self.live.values():
            if rec.req_id is None and rec.exp is not None \
                    and rec.exp.req_id is not None:
                rec.req_id = rec.exp.req_id
                self.by_req[rec.req_id] = rec


class EngineLoop:
    """The background engine thread plus its asyncio bridge."""

    def __init__(self, session: Any, driver: Any, tenancy: TenancyManager,
                 *, idle_wait_s: float = 0.02):
        self.session = session
        self.driver = driver
        self.tenancy = tenancy
        self.registry = Registry()
        self.idle_wait_s = idle_wait_s
        self._cv = threading.Condition()
        self._cmds: List[Callable[[Any], None]] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._aio_loop: Any = None
        self._stalled_rounds = 0
        self.crashed: Optional[BaseException] = None
        m = session.obs.metrics
        self._c_requests = m.counter("server.requests")
        self._c_tokens = m.counter("server.tokens_streamed")
        self._c_evict_shutdown = m.counter("server.evictions_shutdown")
        self._g_streams = m.gauge("server.streams_live")
        self._h_ttft = m.histogram("server.ttft_us")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self, aio_loop: Any) -> None:
        if self._thread is not None:
            return
        self._aio_loop = aio_loop
        self._running = True
        self._thread = threading.Thread(
            target=self._run, name="repro-engine-loop", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the engine thread (callers drain first for grace)."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._running and self._thread is not None

    # ------------------------------------------------------------------
    # asyncio bridge
    # ------------------------------------------------------------------
    def post(self, cmd: Callable[[Any], None]) -> None:
        """Queue a callable for the engine thread and wake it."""
        with self._cv:
            self._cmds.append(cmd)
            self._cv.notify_all()

    async def call(self, fn: Callable[[Any], Any]) -> Any:
        """Run ``fn(session)`` on the engine thread; await its result."""
        if not self.running:
            # BranchStateError is still a RuntimeError for old callers,
            # but carries Errno.EINVAL across the protocol surface
            raise BranchStateError("engine loop is not running")
        loop = self._aio_loop
        fut = loop.create_future()

        def resolve(res: Any, err: Optional[BaseException]) -> None:
            if fut.done():
                return
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(res)

        def cmd(session: Any) -> None:
            try:
                res = fn(session)
            except Exception as err:   # delivered to the awaiter
                loop.call_soon_threadsafe(resolve, None, err)
            else:
                loop.call_soon_threadsafe(resolve, res, None)

        # a crashed engine thread fails the commands it never ran
        cmd.fail = lambda err: loop.call_soon_threadsafe(resolve, None, err)
        self.post(cmd)
        return await fut

    def emit(self, rec: ServedRequest, event: str,
             data: Optional[Dict[str, Any]] = None) -> None:
        """Push one SSE-shaped event onto a record's stream queue."""
        if rec.queue is None or self._aio_loop is None:
            return
        item = (event, jsonable(data or {}))
        try:
            self._aio_loop.call_soon_threadsafe(rec.queue.put_nowait, item)
        except RuntimeError:
            rec.queue = None   # event loop gone (teardown): drop stream

    def _end_stream(self, rec: ServedRequest) -> None:
        if rec.queue is None or self._aio_loop is None:
            return
        try:
            self._aio_loop.call_soon_threadsafe(rec.queue.put_nowait, None)
        except RuntimeError:
            rec.queue = None

    # ------------------------------------------------------------------
    # the engine thread
    # ------------------------------------------------------------------
    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    if not self._cmds and not self._has_work():
                        if not self._running:
                            break
                        self._cv.wait(self.idle_wait_s)
                    if not self._running and not self._cmds \
                            and not self._has_work():
                        break
                    cmds, self._cmds = self._cmds, []
                progress = bool(cmds)
                for cmd in cmds:
                    cmd(self.session)
                progress |= bool(self._relieve_pressure())
                if self._has_step_work():
                    st = self.driver.step()
                    progress |= bool(st.get("resumed") or st.get("decoded")
                                     or st.get("admitted")
                                     or st.get("retired"))
                self._publish()
                if progress:
                    self._stalled_rounds = 0
                else:
                    self._stalled_rounds += 1
                    if self._stalled_rounds >= 2:
                        # a provably idle round with fork-blocked work:
                        # preempt on its behalf, else degrade one policy
                        if not self._relieve_fork_pressure() \
                                and not self.driver.kick_stalled():
                            with self._cv:
                                if self._running and not self._cmds:
                                    self._cv.wait(self.idle_wait_s)
                        self._stalled_rounds = 0
        except Exception as err:   # the thread's boundary: report it
            self.crashed = err
            traceback.print_exc()
            with self._cv:
                self._running = False
                cmds, self._cmds = self._cmds, []
            for cmd in cmds:
                fail = getattr(cmd, "fail", None)
                if fail is not None:
                    fail(BranchStateError(
                        f"engine loop crashed: {err!r}"))
            for rec in list(self.registry.live.values()):
                rec.state = "error"
                rec.error = f"engine loop crashed: {err!r}"
                # settled before the terminal event, as in evict()
                self.registry.complete(rec)
                self.emit(rec, "error", {"message": rec.error})
                self._end_stream(rec)

    def _has_work(self) -> bool:
        return bool(self.driver.live
                    or self.session.sched.waiting_head() is not None
                    or any(r.kind != "parked"
                           for r in self.registry.live.values()))

    def _has_step_work(self) -> bool:
        if self.session.closed:
            return False
        return bool(self.driver.live
                    or self.session.sched.waiting_head() is not None)

    # ------------------------------------------------------------------
    # preemption (engine thread)
    # ------------------------------------------------------------------
    def _relieve_pressure(self) -> int:
        """Evict held/speculative work so the FIFO head can be seated.

        Strictly priority-ordered: only the *head* request matters
        (admission is FIFO), and only strictly-lower-priority
        preemptible records pay for it, cheapest semantic loss first.
        """
        sched = self.session.sched
        head = sched.waiting_head()
        if head is None or sched.admission_deficit() <= 0:
            return 0
        self.registry.refresh_req_ids()
        rec = self.registry.by_req.get(head.req_id)
        if rec is None:
            return 0
        relieved = 0
        for victim in self.tenancy.victims_for(rec.priority):
            if sched.admission_deficit() <= 0:
                break
            # demote-before-deny: a parked victim's KV can leave the
            # device (tier store) without losing anything — eviction is
            # the escalation path, taken only when the victim cannot be
            # checkpointed.  An already-tiered victim holds no device
            # pages, so evicting it would free nothing: skip it.
            if victim.kind == "parked":
                if self.demote(victim,
                               f"demoted by tenant {rec.tenant!r} "
                               f"(priority {rec.priority} > "
                               f"{victim.priority})"):
                    relieved += 1
                    continue
                if victim.demoted:
                    continue
            self.evict(victim,
                       f"preempted by tenant {rec.tenant!r} "
                       f"(priority {rec.priority} > {victim.priority})")
            self.tenancy.note_preemption()
            relieved += 1
        return relieved

    def _relieve_fork_pressure(self) -> int:
        """Same policy for a fork-blocked exploration (no FIFO head):
        a policy whose vectorized fork keeps getting ``-EAGAIN`` may
        preempt lower-priority held/speculative work before the driver
        degrades it to a smaller fan-out."""
        for exp in self.driver.live:
            if not isinstance(exp.wait, _WaitFork):
                continue
            rec = next((r for r in self.registry.live.values()
                        if r.exp is exp), None)
            if rec is None:
                continue
            victims = self.tenancy.victims_for(rec.priority)
            if victims:
                self.evict(victims[0],
                           f"preempted by tenant {rec.tenant!r} fork "
                           f"(priority {rec.priority} > "
                           f"{victims[0].priority})")
                self.tenancy.note_preemption()
                return 1
        return 0

    def demote(self, rec: ServedRequest, reason: str) -> bool:
        """Checkpoint a parked victim's KV to the tier store in place of
        eviction: its device pages are recycled but the record stays
        live (tokens, reservation, handle all survive) and resumes via
        ``session.restore``.  Returns False — caller decides between
        skipping and :meth:`evict` — when the record has no root handle,
        was already demoted, or the checkpoint itself fails."""
        if rec.root_hd is None or rec.demoted:
            return False
        try:
            self.session.checkpoint(rec.root_hd)
        except BranchError:
            # the scheduler's own demote-before-deny (admit()) may have
            # tiered the branch already — adopt its bookkeeping
            self._sync_demoted(rec)
            return False
        rec.demoted = True
        self.tenancy.note_demotion()
        self.emit(rec, "demoted",
                  {"id": rec.sid, "events": [], "reason": reason})
        return True

    def _sync_demoted(self, rec: ServedRequest) -> None:
        """Reflect scheduler-layer tiering into the server record.

        ``Scheduler.admit`` checkpoints held branches on its own
        (demote-before-deny is mechanical, below the priority policy);
        the record's ``demoted`` flag, the ``server.demotions`` counter
        and the ``demoted`` stream event must follow wherever the
        demotion originated.  Restores flip the flag back silently."""
        if rec.root_hd is None:
            return
        try:
            tiered = bool(self.session.stat(rec.root_hd).get("tiered"))
        except BranchError:
            return      # handle raced a resolve; state is terminal
        if tiered and not rec.demoted:
            rec.demoted = True
            self.tenancy.note_demotion()
            self.emit(rec, "demoted", {
                "id": rec.sid, "events": [],
                "reason": "page pressure: KV checkpointed to the tier "
                          "store (demote-before-deny)"})
        elif not tiered and rec.demoted:
            rec.demoted = False

    def evict(self, rec: ServedRequest, reason: str) -> None:
        """Force-finish a record: reservations freed, committed chain
        captured and delivered with the ``EV_INVALIDATED``-style event."""
        hd = rec.root_hd if rec.root_hd is not None else (
            rec.exp.hd if rec.exp is not None else None)
        tokens: Optional[List[int]] = None
        if hd is not None:
            try:
                tokens = self.session.finish(hd)
            except BranchError:
                tokens = None   # already resolved / stale handle
        rec.state = "evicted"
        rec.evict_reason = reason
        rec.final_tokens = tokens
        # bookkeeping strictly BEFORE the terminal event: a consumer
        # that observes it must find the registry already settled
        self.tenancy.detach(rec)
        self.registry.complete(rec)
        self._g_streams.set(len(self.registry.live))
        self.emit(rec, "evicted", {
            "id": rec.sid, "events": ["EV_INVALIDATED"], "reason": reason,
            "tokens": tokens or []})
        self._end_stream(rec)

    def evict_parked(self, reason: str) -> int:
        """Shutdown drain: parked requests never finish on their own."""
        n = 0
        for rec in list(self.registry.live.values()):
            if rec.kind == "parked" and rec.live:
                self.evict(rec, reason)
                self._c_evict_shutdown.inc()
                n += 1
        return n

    def evict_all(self, reason: str) -> int:
        """Hard drain (non-graceful shutdown): everything goes."""
        n = 0
        for rec in list(self.registry.live.values()):
            if rec.live:
                self.evict(rec, reason)
                self._c_evict_shutdown.inc()
                n += 1
        return n

    # ------------------------------------------------------------------
    # launching (engine thread, via call())
    # ------------------------------------------------------------------
    def launch(self, rec: ServedRequest, policy: Any,
               **policy_kw: Any) -> ServedRequest:
        """Attach + start a record (chat and explore kinds run through
        the driver; parked kinds open a held root directly)."""
        from repro_torch.api.flags import BR_HOLD

        prompt = policy_kw.pop("prompt")
        if rec.kind == "parked":
            rec.root_hd = self.session.open(
                list(prompt), rec.max_new_tokens, flags=BR_HOLD)
            rec.req_id = self.session.req_id_of(rec.root_hd)
        else:
            rec.exp = self.driver.explore(
                list(prompt), rec.max_new_tokens, policy=policy,
                name=f"{rec.policy or rec.kind}-{rec.sid}", **policy_kw)
        self.tenancy.attach(rec)
        self.registry.add(rec)
        self._c_requests.inc()
        self._g_streams.set(len(self.registry.live))
        return rec

    # ------------------------------------------------------------------
    # stream publishing (engine thread)
    # ------------------------------------------------------------------
    def _publish(self) -> None:
        self.registry.refresh_req_ids()
        for rec in list(self.registry.live.values()):
            if rec.kind == "parked":
                self._publish_parked(rec)
            else:
                self._publish_exploration(rec)
        self._g_streams.set(len(self.registry.live))

    def _publish_parked(self, rec: ServedRequest) -> None:
        if rec.sent_admitted:
            self._sync_demoted(rec)
        if not rec.sent_admitted and rec.root_hd is not None:
            try:
                admitted = self.session.admitted(rec.root_hd)
            except BranchError:
                return      # handle raced a resolve; try next step
            if admitted:
                rec.sent_admitted = True
                rec.state = "running"
                self.emit(rec, "admitted", {
                    "id": rec.sid, "req_id": rec.req_id,
                    "seq": self.session.seq_of(rec.root_hd),
                    "events": ["EV_ADMITTED"], "held": True})

    def _publish_exploration(self, rec: ServedRequest) -> None:
        exp = rec.exp
        if exp is None:
            return
        if not rec.sent_admitted and exp.root is not None:
            rec.sent_admitted = True
            rec.state = "running"
            self.emit(rec, "admitted", {
                "id": rec.sid, "req_id": exp.req_id,
                "seq": exp.root.seq, "events": ["EV_ADMITTED"]})
        if not exp.done and exp.hd is not None:
            self._stream_tokens(rec, self._root_tokens(rec))
            return
        if not exp.done:
            return
        # terminal: settle the registry FIRST (a consumer observing the
        # terminal event must find the record already completed), then
        # flush the tail + result/error, then the sentinel
        if exp.error is not None:
            rec.state = "error"
            rec.error = str(exp.error)
            self.tenancy.detach(rec)
            self.registry.complete(rec)
            errno = getattr(exp.error, "errno", None)
            self.emit(rec, "error", {
                "id": rec.sid, "message": rec.error,
                "errno": errno.name if errno is not None else None})
        else:
            res = exp.result
            final = list(res.tokens) if res is not None else (
                list(exp.final_tokens or []))
            gen_start = rec.prompt_len + rec.tokens_sent
            if len(final) > gen_start:
                self._note_tokens(rec, final[gen_start:])
            rec.state = "finished"
            rec.final_tokens = final
            if res is not None:
                rec.result = {
                    "tokens": list(res.tokens),
                    "generated": list(res.generated),
                    "score": res.score,
                    "committed": res.committed,
                    "policy": rec.policy or "chat",
                    "stats": jsonable(res.stats),
                }
            self.tenancy.detach(rec)
            self.registry.complete(rec)
            event = "finished" if rec.kind == "chat" else "result"
            self.emit(rec, event, {
                "id": rec.sid, "events": ["EV_FINISHED"],
                "tokens": final, "generated": final[rec.prompt_len:],
                **({"result": rec.result}
                   if rec.kind == "explore" and rec.result else {})})
        self._end_stream(rec)

    def _root_tokens(self, rec: ServedRequest) -> Optional[List[int]]:
        """The exploration root's current chain (None when unreadable:
        mid-resolution windows are fine to skip for a step)."""
        try:
            return self.session.tokens(rec.exp.hd)
        except BranchError:
            return None

    def _stream_tokens(self, rec: ServedRequest,
                       tokens: Optional[List[int]]) -> None:
        if tokens is None:
            return
        new = tokens[rec.prompt_len + rec.tokens_sent:]
        if new:
            self._note_tokens(rec, new)

    def _note_tokens(self, rec: ServedRequest, new: List[int]) -> None:
        if rec.t_first_token is None:
            rec.t_first_token = time.perf_counter()
            self._h_ttft.observe(
                (rec.t_first_token - rec.t_submit) * 1e6)
        rec.tokens_sent += len(new)
        self._c_tokens.inc(len(new))
        self.emit(rec, "token", {
            "id": rec.sid, "tokens": list(new),
            "produced": rec.tokens_sent})


__all__ = ["EngineLoop", "Registry", "chat_policy", "jsonable"]
