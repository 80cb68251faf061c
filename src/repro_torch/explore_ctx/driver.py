"""Event-driven exploration driver — many searches, one engine.

The paper's BranchContext library is only useful at serving scale if
hundreds of independent explorations can share one engine without
hand-rolled coordination.  This driver is that multiplexer, and it
runs **entirely through the public surface** (``repro_torch.api``):
every fork is a ``session.branch()`` call, every wait is a
:class:`~repro_torch.api.events.Waiter` registration, every retirement is
``session.finish()`` — no raw scheduler verbs.

* **Policies are generators.**  A policy yields *work items* —
  :class:`Submit`, :class:`Fork`, :class:`Decode`, :class:`Tick` — and
  performs commits/aborts synchronously on its contexts.  ``yield
  from`` composes policies into nested searches.
* **One continuous batch.**  Each driver step resumes every policy
  whose wait is satisfied, then runs exactly one ``session.step`` —
  so decode work from every live exploration lands in the same
  continuous batch (per-sequence sampling settings let greedy
  verification and high-temperature exploration share a dispatch).
* **Backpressure, not crashes.**  A ``Fork`` that the page-budget
  ledger cannot absorb parks the exploration and retries each step:
  other explorations' commits recycle pages and unblock it.  Only a
  *provably* stalled system (a driver round in which nothing decoded,
  admitted, retired or resumed — deterministic, so nothing ever will)
  throws ``AdmissionDenied`` into the blocked policies, which may then
  shrink their fan-out or commit what they have.
* **Nothing leaks.**  When a policy returns (or raises), its request is
  force-retired through ``session.finish``: the root subtree is
  released across every domain, all reservations return to the pool,
  and every handle rooted at the request is closed (recycling its
  table slot).  N explorations entering always means a drained pool
  leaving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

from repro_torch.api.events import EV_ADMITTED, Waiter
from repro_torch.api.flags import BR_HOLD
from repro_torch.api.session import BranchSession
from repro_torch.core.errors import AdmissionDenied, BranchError, Errno
from repro_torch.core.store import BranchStore
from repro_torch.explore_ctx.context import (  # noqa: F401
    BranchContext,
    StateContext,
)


# ---------------------------------------------------------------------------
# work items a policy may yield
# ---------------------------------------------------------------------------

@dataclass
class Submit:
    """Queue a request; resumes with the admitted root BranchContext."""

    prompt: Sequence[int]
    max_new_tokens: int = 16


@dataclass
class Fork:
    """Fork ``n`` children of ``ctx``; resumes with the child contexts.

    Retried with backpressure while the page budget cannot absorb it.
    ``flags`` ORs extra ``repro_torch.api`` flags into the fork —
    ``BR_SPECULATIVE`` declares the children truncatable drafts.
    """

    ctx: BranchContext
    n: int
    flags: int = 0


@dataclass
class Decode:
    """Decode ``tokens`` more tokens on each context, then resume.

    The driver unparks the sequences, tags their sampling settings, and
    lets the scheduler batch them with everyone else's work; contexts
    that resolve or hit their request budget early count as done.
    ``greedy``/``temperature`` may be scalars or per-context rows, so a
    greedy verifier and sampled drafts decode in ONE wait (and one
    device batch) — the per-sequence sampling feature's whole point.
    """

    ctxs: Sequence[BranchContext]
    tokens: int
    greedy: Any = False
    temperature: Any = 1.5


@dataclass
class Tick:
    """Let the engine run ``steps`` scheduler steps (generic wait)."""

    steps: int = 1


# ---------------------------------------------------------------------------
# waits (internal): when may a parked exploration resume?
# All readiness goes through the session's event surface — the driver
# never inspects scheduler internals.
# ---------------------------------------------------------------------------

class _WaitAdmitted:
    def __init__(self, hd: int):
        self.hd = hd

    def poll(self, drv: "ExplorationDriver") -> Tuple[bool, Any]:
        if not drv.session.events(self.hd) & EV_ADMITTED:
            return False, None
        return True, BranchContext(drv.session, self.hd)


class _WaitFork:
    def __init__(self, item: Fork):
        self.item = item
        self.attempts = 0

    def poll(self, drv: "ExplorationDriver") -> Tuple[bool, Any]:
        try:
            kids = self.item.ctx.fork(self.item.n, self.item.flags)
        except AdmissionDenied:
            self.attempts += 1
            return False, None
        return True, kids


class _WaitDecode:
    """A Decode whose demoted context cannot be re-seated yet.

    The scheduler may checkpoint a held branch out of the device pool
    to admit new work (demote-before-deny); resuming it restores the
    snapshot, and that restore is budget-checked.  Until it is
    admitted, the whole Decode retries with backpressure — mirroring
    ``_WaitFork`` — then delegates to the token wait it finally starts.
    """

    def __init__(self, item: Decode, g_row: List[Any], t_row: List[Any]):
        self.item = item
        self.g_row = g_row
        self.t_row = t_row
        self.attempts = 0
        self.inner: Optional["_WaitTokens"] = None

    def poll(self, drv: "ExplorationDriver") -> Tuple[bool, Any]:
        if self.inner is None:
            try:
                self.inner = drv._start_decode(self.item, self.g_row,
                                               self.t_row)
            except AdmissionDenied:
                self.attempts += 1
                return False, None
            if self.inner is None:      # every context resolved meanwhile
                return True, None
        return self.inner.poll(drv)


class _WaitTokens:
    def __init__(self, waiter: Waiter, ctxs: Sequence[BranchContext]):
        self.waiter = waiter
        self.ctxs = ctxs

    def poll(self, drv: "ExplorationDriver") -> Tuple[bool, Any]:
        ready = self.waiter.poll()
        if len(ready) < len(self.waiter.handles()):
            return False, None
        for ctx in self.ctxs:
            drv.session.pause(ctx.hd)   # park again: policy regains control
        return True, None


class _WaitSteps:
    def __init__(self, until_step: int):
        self.until_step = until_step

    def poll(self, drv: "ExplorationDriver") -> Tuple[bool, Any]:
        return drv.steps >= self.until_step, None


# ---------------------------------------------------------------------------
# exploration handle
# ---------------------------------------------------------------------------

class Exploration:
    """A launched policy: its future result plus bookkeeping."""

    def __init__(self, driver: "ExplorationDriver",
                 gen: Generator, name: str):
        self.driver = driver
        self.gen = gen
        self.name = name
        self.hd: Optional[int] = None          # session root handle
        self.req_id: Optional[int] = None
        self.root: Optional[BranchContext] = None
        self.wait: Optional[Any] = None
        self.started = False
        self.done = False
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.error_reported = False   # raised to a caller exactly once
        self.final_tokens: Optional[List[int]] = None

    def run(self, max_steps: int = 10_000, **decode_kw: Any) -> Any:
        """Drive the whole fleet until *this* exploration resolves."""
        self.driver.run(max_steps=max_steps, until=self, **decode_kw)
        if self.error is not None:
            self.error_reported = True
            raise self.error
        return self.result


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class ExplorationDriver:
    """Multiplexes generator policies over one session."""

    def __init__(self, session: Any, *,
                 store: Optional[BranchStore] = None):
        if isinstance(session, BranchSession):
            if store is not None and session.store is not store:
                raise BranchError(
                    "pass the store to BranchSession, not the driver",
                    errno=Errno.EINVAL)
            self.session = session
        else:
            # migration path: wrap a bare Scheduler (or engine) in a
            # session; BranchSession validates the type
            self.session = BranchSession(session, store=store)
        self.sched = self.session.sched
        self.store = self.session.store
        self._live: List[Exploration] = []
        self.explorations: List[Exploration] = []
        self.steps = 0

    # -- launching ------------------------------------------------------
    def launch(self, gen: Generator, *, name: str = "") -> Exploration:
        """Register a policy generator; it starts on the next step."""
        exp = Exploration(self, gen, name or f"exploration-{len(self.explorations)}")
        self._live.append(exp)
        self.explorations.append(exp)
        return exp

    def explore(self, prompt: Sequence[int], max_new_tokens: int,
                policy: Any, *, name: str = "",
                **policy_kw: Any) -> Exploration:
        """One-liner: submit ``prompt`` and run ``policy`` on its root."""

        def wrapper() -> Generator:
            ctx = yield Submit(prompt, max_new_tokens)
            return (yield from policy(ctx, **policy_kw))

        return self.launch(wrapper(), name=name or getattr(
            policy, "__name__", "policy"))

    @property
    def live(self) -> List[Exploration]:
        """Unresolved explorations (read-only view for external loops)."""
        return list(self._live)

    def _bind_root(self, req_id: int,
                   seq: Optional[int] = None) -> BranchContext:
        """Wrap an externally submitted request in a root context
        (migration aid; new code opens through the session).  ``seq``
        is accepted for backward compatibility and must be the
        request's own root sequence — binding always resolves through
        the request id.
        """
        hd = self.session.adopt(req_id)
        if seq is not None and self.session.seq_of(hd) != seq:
            actual = self.session.seq_of(hd)
            # drop the just-adopted handle before raising: the request
            # itself stays with the scheduler, but the slot must not
            # leak (close() never resolves; see session.close)
            self.session.close(hd)
            raise BranchError(
                f"request {req_id} is rooted at seq {actual}, "
                f"not {seq}", errno=Errno.EINVAL)
        return BranchContext(self.session, hd)

    # -- stepping -------------------------------------------------------
    def _advance(self, exp: Exploration, value: Any = None,
                 error: Optional[BaseException] = None) -> None:
        """Run one exploration's host code until it blocks again."""
        while True:
            try:
                if error is not None:
                    err, error = error, None
                    item = exp.gen.throw(err)
                elif not exp.started:
                    exp.started = True
                    item = next(exp.gen)
                else:
                    item = exp.gen.send(value)
            except StopIteration as stop:
                self._finalize(exp, stop.value)
                return
            except BaseException as err:   # policy bug: fail + clean up
                self._fail(exp, err)
                return

            if isinstance(item, Submit):
                try:
                    exp.hd = self.session.open(
                        list(item.prompt), item.max_new_tokens,
                        flags=BR_HOLD)
                except AdmissionDenied as err:
                    # can NEVER fit: not backpressure — the policy decides
                    value, error = None, err
                    continue
                exp.req_id = self.session.req_id_of(exp.hd)
                wait = _WaitAdmitted(exp.hd)
                ok, value = wait.poll(self)   # may be admitted already
                if ok:
                    exp.root = value
                    continue
                exp.wait = wait
                return
            elif isinstance(item, Fork):
                try:
                    value = item.ctx.fork(item.n, item.flags)
                    continue
                except AdmissionDenied:
                    exp.wait = _WaitFork(item)    # backpressure: retry
                    return
                except BranchError as err:
                    # forking a resolved/evicted context is a policy-level
                    # condition: deliver it to the generator, not the run
                    value, error = None, err
                    continue
            elif isinstance(item, Decode):
                k = len(item.ctxs)
                g_row = (list(item.greedy) if isinstance(
                    item.greedy, (list, tuple)) else [item.greedy] * k)
                t_row = (list(item.temperature) if isinstance(
                    item.temperature, (list, tuple))
                    else [item.temperature] * k)
                if len(g_row) != k or len(t_row) != k:
                    value, error = None, ValueError(
                        "Decode sampling rows must match its contexts")
                    continue
                try:
                    wait = self._start_decode(item, g_row, t_row)
                except AdmissionDenied:
                    # a demoted context cannot re-seat yet: retry with
                    # backpressure, like a fork under page pressure
                    exp.wait = _WaitDecode(item, g_row, t_row)
                    return
                if wait is None:
                    value = None   # every context already resolved
                    continue
                exp.wait = wait
                return
            elif isinstance(item, Tick):
                exp.wait = _WaitSteps(self.steps + item.steps)
                return
            else:
                value, error = None, TypeError(
                    f"policy yielded {item!r}; expected Submit/Fork/"
                    "Decode/Tick")

    def _finalize(self, exp: Exploration, result: Any) -> None:
        exp.result = result
        exp.done = True
        exp.wait = None
        self._live.remove(exp)
        if exp.hd is not None:
            # finish releases the subtree across every domain, reaps the
            # composite store branch, and closes all of its handles
            exp.final_tokens = self.session.finish(exp.hd)

    def _start_decode(self, item: Decode, g_row: List[Any],
                      t_row: List[Any]) -> Optional["_WaitTokens"]:
        """Unpark + tag every still-tracked context of a Decode.

        Returns the token wait, or ``None`` when every context resolved
        meanwhile.  Transactional against restore backpressure: if a
        demoted context's re-seat is denied (``AdmissionDenied`` out of
        ``session.resume``), everything already unparked is re-held and
        the denial re-raised so the caller can retry the whole Decode.
        """
        waiter = Waiter(self.session)
        active: List[BranchContext] = []
        try:
            for ctx, g, t in zip(item.ctxs, g_row, t_row):
                if not self.session.tracked(ctx.hd):
                    continue   # already resolved: nothing to decode
                target = self.session.produced(ctx.hd) + item.tokens
                self.session.resume(ctx.hd, greedy=g, temperature=t)
                waiter.add(ctx.hd, events=0, produced=target)
                active.append(ctx)
        except AdmissionDenied:
            for ctx in active:
                self.session.pause(ctx.hd)
            raise
        if not active:
            return None
        return _WaitTokens(waiter, active)

    def _fail(self, exp: Exploration, err: BaseException) -> None:
        exp.error = err
        exp.done = True
        exp.wait = None
        self._live.remove(exp)
        if exp.hd is not None:
            exp.final_tokens = self.session.finish(exp.hd)

    def step(self, **decode_kw: Any) -> Dict[str, Any]:
        """One round: resume ready explorations, then one session step."""
        self.session.admit()   # admit first so _WaitAdmitted binds + holds
        resumed = 0
        for exp in list(self._live):
            if exp.done:
                continue
            if exp.wait is None:
                self._advance(exp)
                resumed += 1
            else:
                try:
                    ok, value = exp.wait.poll(self)
                except Exception as err:
                    # a wait that can never be satisfied (its context was
                    # evicted/resolved underneath it) fails into the
                    # policy, not the driver loop
                    exp.wait = None
                    self._advance(exp, error=err)
                    resumed += 1
                    continue
                if ok:
                    exp.wait = None
                    if isinstance(value, BranchContext) and exp.root is None:
                        exp.root = value
                    self._advance(exp, value)
                    resumed += 1
        st = self.session.step(**decode_kw)
        st["resumed"] = resumed
        st["live_explorations"] = len(self._live)
        self.steps += 1
        return st

    def run(self, max_steps: int = 10_000, *,
            until: Optional[Exploration] = None,
            raise_errors: bool = True, **decode_kw: Any) -> List[Exploration]:
        """Step until every exploration (or ``until``) resolves."""
        decode_kw = dict(decode_kw)
        generator = decode_kw.pop("generator", None)
        if generator is not None:
            # one seed must not reach every step (identical sampling
            # noise each round): it reseeds the scheduler's stream
            self.sched.seed_sampling(generator)
        stalled = 0
        for _ in range(max_steps):
            if not self._live or (until is not None and until.done):
                break
            st = self.step(**decode_kw)
            if st["resumed"] or st["decoded"] or st["admitted"] \
                    or st["retired"]:
                stalled = 0
                continue
            if any(isinstance(e.wait, _WaitSteps) for e in self._live):
                continue   # a Tick always resolves: steps advance
            # A fully idle round is deterministic: nothing will change on
            # its own.  Kick ONE fork-blocked policy with a permanent
            # -EAGAIN (it may shrink its fan-out or degrade to unforked
            # decoding, freeing pages for the rest); if nobody is
            # fork-blocked, the stall is unrecoverable.
            stalled += 1
            if self._kick_stalled():
                stalled = 0
            elif stalled > 1:
                blocked = [e.name for e in self._live]
                raise BranchError(
                    f"exploration driver stalled; blocked: {blocked}",
                    errno=Errno.EBUSY)
        else:
            if self._live and (until is None or not until.done):
                raise BranchError(
                    f"driver exceeded max_steps={max_steps} with "
                    f"{len(self._live)} explorations live",
                    errno=Errno.EAGAIN)
        if raise_errors:
            if until is not None:
                # the caller awaits ONE exploration: only its error is
                # theirs; other failures surface on their own run calls
                if until.error is not None and not until.error_reported:
                    until.error_reported = True
                    raise until.error
            else:
                for exp in self.explorations:
                    if exp.error is not None and not exp.error_reported:
                        exp.error_reported = True
                        raise exp.error
        return self.explorations

    def kick_stalled(self) -> int:
        """Throw -EAGAIN into ONE fork-blocked policy on a proven stall.

        Public for external continuous loops (the serving front door's
        engine multiplexer owns its own stepping loop instead of
        :meth:`run`, but needs the same escape hatch when a round makes
        no progress and a fork-blocked policy is the reason): the kicked
        policy may shrink its fan-out or degrade to unforked decoding,
        freeing pages for everyone else.  Returns 1 if a policy was
        kicked, else 0.
        """
        return self._kick_stalled()

    def _kick_stalled(self) -> int:
        for exp in list(self._live):
            if isinstance(exp.wait, _WaitFork):
                wait, exp.wait = exp.wait, None
                self._advance(exp, error=AdmissionDenied(
                    f"fork({wait.item.ctx.seq}, n={wait.item.n}) cannot be "
                    f"admitted after {wait.attempts} retries and no other "
                    "exploration can free pages (-EAGAIN, permanent)"))
                return 1
        return 0


__all__ = ["Decode", "Exploration", "ExplorationDriver", "Fork",
           "Submit", "Tick"]
