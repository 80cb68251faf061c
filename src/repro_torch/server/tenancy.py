"""Multi-tenant admission control over the scheduler's reservation ledger.

The port's copy of ``repro/server/tenancy.py``.

The scheduler (DESIGN §3) guarantees *mechanical* safety: an admitted
request can always decode to completion because its worst-case pages
are reserved up front.  This module layers *policy* on that mechanism:

* **Quotas** — each tenant gets a concurrency cap and a worst-case-page
  cap, checked BEFORE anything touches the scheduler.  A request over
  quota is rejected with :class:`QuotaExceeded` (HTTP 429 at the front
  door, ``-EAGAIN`` in errno terms) without submitting, so the
  reservation ledger — and the FIFO every tenant shares — never sees
  work that was never going to be allowed.
* **Priority classes** — each tenant carries an integer priority.
  Admission itself stays FIFO (the ledger's no-mid-decode--ENOSPC proof
  depends on it); priority instead governs **preemption**: when the
  FIFO head cannot be seated and it outranks lower-priority tenants'
  *preemptible* work, that work is evicted to free its reservations.
* **Preemptible work only** — victims are exclusively **held** branches
  (parked requests that are not decoding) and **speculative**
  explorations (declared-disposable drafts).  An actively-decoding,
  non-speculative request is never a victim, so a preempted tenant's
  committed chains survive intact: eviction goes through
  ``session.finish`` (capturing the tokens committed so far and
  releasing every reservation) and surfaces to the owner as an
  ``EV_INVALIDATED``-style event — never as a mid-decode ``-ENOSPC``.

The manager is deliberately ignorant of HTTP and asyncio: it accounts
:class:`ServedRequest` records (attach/detach), answers quota checks,
and ranks victims.  The engine multiplexer executes evictions; the app
layer maps the errors onto status codes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.errors import AdmissionDenied, BranchError, Errno


class QuotaExceeded(BranchError):
    """A tenant is over its concurrency or page quota (``-EAGAIN``).

    Retryable by construction — finishing any of the tenant's live
    requests frees quota — which is exactly HTTP 429 semantics, so the
    front door maps this error (and only this error) to 429.
    """

    default_errno = Errno.EAGAIN


@dataclass
class TenantConfig:
    """One tenant's admission contract.

    ``priority`` orders preemption (higher outranks lower; equal
    priorities never preempt each other).  ``max_reserved_pages`` caps
    the sum of worst-case reservations the tenant's live requests may
    hold (None = bounded only by the pool); ``max_concurrent`` caps
    live requests.
    """

    name: str
    max_concurrent: int = 16
    max_reserved_pages: Optional[int] = None
    priority: int = 1


@dataclass
class ServedRequest:
    """One front-door request: the server's bookkeeping record.

    ``kind`` is ``"chat"`` (plain generate), ``"explore"`` (a policy
    run), or ``"parked"`` (a held root — admitted, reserved, never
    decoding until resumed or evicted).  ``preemptible`` marks the
    record evictable under page pressure: parked requests always are,
    explorations are when their policy declared itself speculative.
    """

    sid: int
    tenant: str
    kind: str                           # "chat" | "explore" | "parked"
    prompt_len: int
    max_new_tokens: int
    worst_pages: int
    policy: str = ""
    preemptible: bool = False
    priority: int = 1
    exp: Any = None                     # explore_ctx Exploration (driver)
    root_hd: Optional[int] = None       # parked requests hold the root
    req_id: Optional[int] = None
    queue: Any = None                   # asyncio.Queue, owned by the app
    state: str = "queued"               # queued|running|finished|evicted|error
    sent_admitted: bool = False
    tokens_sent: int = 0
    t_submit: float = field(default_factory=time.perf_counter)
    t_first_token: Optional[float] = None
    final_tokens: Optional[List[int]] = None
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    evict_reason: Optional[str] = None
    demoted: bool = False               # KV checkpointed to the tier store

    @property
    def live(self) -> bool:
        return self.state in ("queued", "running")


class TenancyManager:
    """Quotas + priorities + victim ranking for one serving session."""

    def __init__(self, session: Any,
                 tenants: Optional[Sequence[TenantConfig]] = None,
                 *, default: Optional[TenantConfig] = None):
        self.session = session
        engine = session.engine
        self._page_size = engine.page_size
        self._num_pages = engine.kv.num_pages
        self._max_pages = engine.max_pages
        self._default = default or TenantConfig("default", max_concurrent=64)
        self._tenants: Dict[str, TenantConfig] = {
            self._default.name: self._default}
        for t in tenants or ():
            self._tenants[t.name] = t
        # live accounting: per-tenant record sets (attach/detach)
        self._live: Dict[str, List[ServedRequest]] = {}
        m = session.obs.metrics
        self._c_quota = m.counter("server.quota_429")
        self._c_enospc = m.counter("server.rejected_enospc")
        self._c_preempt = m.counter("server.preemptions")
        self._c_demote = m.counter("server.demotions")

    # ------------------------------------------------------------------
    # tenant registry
    # ------------------------------------------------------------------
    def register(self, config: TenantConfig) -> None:
        self._tenants[config.name] = config

    def tenant(self, name: str) -> TenantConfig:
        """The tenant's config (unknown tenants get the default class)."""
        return self._tenants.get(name, self._default)

    def priority_of(self, name: str) -> int:
        return self.tenant(name).priority

    def tenants(self) -> List[TenantConfig]:
        return list(self._tenants.values())

    # ------------------------------------------------------------------
    # quota checks (BEFORE the ledger)
    # ------------------------------------------------------------------
    def worst_pages(self, prompt_len: int, max_new_tokens: int) -> int:
        """The scheduler's worst-case page formula, mirrored here so the
        quota check prices a request exactly like the ledger will."""
        return -(-(prompt_len + max_new_tokens) // self._page_size)

    def reserved_pages(self, name: str) -> int:
        return sum(r.worst_pages for r in self._live.get(name, ()))

    def live_count(self, name: str) -> int:
        return len(self._live.get(name, ()))

    def check_admit(self, name: str, prompt_len: int,
                    max_new_tokens: int) -> int:
        """Validate a request against its tenant's quota; returns the
        worst-case page count on success.

        Raises :class:`QuotaExceeded` (→ 429) when the tenant is at its
        concurrency or page cap, and :class:`AdmissionDenied` with
        ``ENOSPC`` when the request could never fit the pool or a block
        table at all (the scheduler's own up-front rejection, applied
        here so the FIFO never sees it).  Neither path touches the
        scheduler: the reservation ledger moves only for requests that
        passed.
        """
        worst = self.worst_pages(prompt_len, max_new_tokens)
        if worst > self._num_pages or worst > self._max_pages:
            self._c_enospc.inc()
            raise AdmissionDenied(
                f"request needs up to {worst} pages but the pool/block "
                f"table holds at most "
                f"{min(self._num_pages, self._max_pages)}; it can never "
                "be admitted", errno=Errno.ENOSPC)
        cfg = self.tenant(name)
        if self.live_count(name) >= cfg.max_concurrent:
            self._c_quota.inc()
            raise QuotaExceeded(
                f"tenant {name!r} is at its concurrency quota "
                f"({cfg.max_concurrent} live requests) (-EAGAIN)")
        if cfg.max_reserved_pages is not None and \
                self.reserved_pages(name) + worst > cfg.max_reserved_pages:
            self._c_quota.inc()
            raise QuotaExceeded(
                f"tenant {name!r} would exceed its page quota "
                f"({self.reserved_pages(name)} + {worst} > "
                f"{cfg.max_reserved_pages}) (-EAGAIN)")
        return worst

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def attach(self, rec: ServedRequest) -> None:
        rec.priority = self.priority_of(rec.tenant)
        self._live.setdefault(rec.tenant, []).append(rec)

    def detach(self, rec: ServedRequest) -> None:
        recs = self._live.get(rec.tenant)
        if recs and rec in recs:
            recs.remove(rec)

    # ------------------------------------------------------------------
    # preemption policy
    # ------------------------------------------------------------------
    def victims_for(self, priority: int) -> List[ServedRequest]:
        """Preemptible records a request of ``priority`` may evict.

        Only held/speculative work qualifies — an actively-decoding,
        non-speculative request is never a victim — and only strictly
        lower-priority tenants pay.  Ordered cheapest-semantic-loss
        first: lowest priority, parked before speculative (a parked
        request loses nothing already committed; a speculative
        exploration loses in-flight drafts), oldest first.
        """
        out = [r for recs in self._live.values() for r in recs
               if r.live and r.preemptible and r.priority < priority]
        out.sort(key=lambda r: (r.priority,
                                0 if r.kind == "parked" else 1,
                                r.t_submit))
        return out

    def note_preemption(self) -> None:
        self._c_preempt.inc()

    def note_demotion(self) -> None:
        """A victim was demoted to the tier store instead of evicted —
        it keeps its tokens and resumes later, losing nothing."""
        self._c_demote.inc()

    # ------------------------------------------------------------------
    def usage(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant live usage (the /v1/tenants introspection view)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, cfg in self._tenants.items():
            out[name] = {
                "priority": cfg.priority,
                "live": self.live_count(name),
                "max_concurrent": cfg.max_concurrent,
                "reserved_pages": self.reserved_pages(name),
                "max_reserved_pages": cfg.max_reserved_pages,
            }
        return out


__all__ = ["QuotaExceeded", "ServedRequest", "TenancyManager",
           "TenantConfig"]
