"""The async serving front door — HTTP/SSE over a BranchSession.

The port's copy of ``repro/server/app.py``.  On the card,
:meth:`FrontDoor.start_backend` builds and loads every kernel before the
engine thread starts, so a failed build raises to its caller instead of
ending the thread while clients wait.

Zero dependencies beyond the standard library: the repo's CI (and the
paper's claim) is that branch-native serving needs an engine and an OS
analogy, not a web framework.  The HTTP/1.1 surface is deliberately
small:

===========================  ============================================
``POST /v1/generate``        plain generation; streams SSE ``token``
                             events plus Waiter lifecycle events
                             (``admitted``/``finished``/``evicted``), or
                             returns one JSON document with
                             ``"stream": false``.  ``"hold": true``
                             admits-and-parks (a reservation-holding
                             agentic request that decodes later — and
                             the canonical preemption victim).
``POST /v1/explore``         a named exploration policy (best_of_n,
                             beam, tree, speculative) run through the
                             shared driver; the first-commit-wins result
                             arrives as a terminal ``result`` event.
``GET /v1/sessions/{id}/tree``  procfs view of one served request.
``GET /v1/tenants``          per-tenant quota/usage introspection.
``GET /metrics``             the obs registry's procfs text format.
``GET /healthz``             liveness + draining state.
===========================  ============================================

Tests (and in-process callers) use :meth:`FrontDoor.dispatch` directly —
an ASGI-shaped ``(method, path, body) -> Response`` surface with no
sockets; :meth:`FrontDoor.serve` wraps the same dispatch in an
``asyncio.start_server`` loop for real clients.

Graceful shutdown (`shutdown(drain=True)`) refuses new work with 503,
evicts parked reservations (they never finish on their own), lets every
in-flight decode run to completion, then stops the engine thread and
closes the session — which wakes any straggler blocked in
``Waiter.wait``.  Nothing is ever cut off mid-decode.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, Optional, Sequence, Tuple

from repro_torch.core.errors import AdmissionDenied, BranchError
from repro_torch.explore_ctx.driver import ExplorationDriver
from repro_torch.explore_ctx.policies import (beam_search, best_of_n,
                                              tree_search)
from repro_torch.explore_ctx.speculative import speculative_decode
from repro_torch.kernels import _build
from repro_torch.server.multiplex import EngineLoop, chat_policy, jsonable
from repro_torch.server.tenancy import (QuotaExceeded, ServedRequest,
                                  TenancyManager, TenantConfig)

#: policy registry: name -> (fn, allowed JSON params, default max_new,
#: preemptible).  Speculative explorations are declared-disposable
#: drafts, so they (alone among policies) are preemption victims.
POLICIES: Dict[str, Tuple[Any, frozenset, int, bool]] = {
    "best_of_n": (best_of_n,
                  frozenset({"n", "tokens", "temperature"}), 16, False),
    "beam": (beam_search,
             frozenset({"width", "depth", "tokens_per_level",
                        "temperature"}), 16, False),
    "tree": (tree_search,
             frozenset({"fan_out", "tokens_per_node", "max_nodes",
                        "max_depth", "temperature"}), 16, False),
    "speculative": (speculative_decode,
                    frozenset({"n_drafts", "draft_tokens",
                               "temperature"}), 16, True),
}


@dataclass
class Response:
    """One dispatch result: a plain body OR a live SSE event stream."""

    status: int
    body: Optional[Dict[str, Any]] = None
    text: Optional[str] = None
    events: Optional[AsyncIterator[Tuple[str, Dict[str, Any]]]] = None
    headers: Dict[str, str] = field(default_factory=dict)

    @property
    def content_type(self) -> str:
        if self.events is not None:
            return "text/event-stream"
        return "text/plain" if self.text is not None else "application/json"

    def render_body(self) -> bytes:
        if self.text is not None:
            return self.text.encode()
        return json.dumps(self.body or {}).encode()


def _error(status: int, message: str, *, errno: Any = None) -> Response:
    return Response(status, body={
        "error": message,
        "errno": getattr(errno, "name", None)})


def _load_kernels() -> None:
    """Build every kernel library at once, then load each."""
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)


def _status_for(err: BaseException) -> int:
    """errno discipline → HTTP discipline."""
    if isinstance(err, QuotaExceeded):
        return 429                       # -EAGAIN: retry after quota frees
    if isinstance(err, AdmissionDenied):
        return 507                       # -ENOSPC: insufficient storage
    return 400


class FrontDoor:
    """Multi-tenant async HTTP/SSE front end over one BranchSession."""

    def __init__(self, session: Any,
                 tenants: Optional[Sequence[TenantConfig]] = None, *,
                 driver: Optional[ExplorationDriver] = None,
                 default_tenant: Optional[TenantConfig] = None):
        self.session = session
        self.driver = driver or ExplorationDriver(session)
        self.tenancy = TenancyManager(session, tenants,
                                      default=default_tenant)
        self.mux = EngineLoop(session, self.driver, self.tenancy)
        self.registry = self.mux.registry
        self.draining = False
        self._server: Any = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start_backend(self) -> None:
        """Start the engine thread against the running event loop (on the
        card, after building and loading every kernel)."""
        if self.mux.running:
            return
        if self.session.engine.device.type == "cuda":
            await asyncio.to_thread(_load_kernels)
        self.mux.start(asyncio.get_running_loop())

    async def serve(self, host: str, port: int) -> Any:
        """Bind the socket front end (returns the asyncio server)."""
        await self.start_backend()
        self._server = await asyncio.start_server(
            self._handle_conn, host, port)
        return self._server

    async def shutdown(self, *, drain: bool = True,
                       timeout: float = 60.0) -> Dict[str, Any]:
        """Stop serving; with ``drain`` let in-flight decodes finish.

        Draining: (1) new requests get 503, (2) parked reservations are
        evicted — held work never finishes by itself and its owners get
        the ``EV_INVALIDATED``-style event, (3) chat/explore requests
        decode to completion, (4) the engine thread stops and the
        session closes, waking any blocked Waiter.
        """
        self.draining = True
        stats = {"drained": 0, "evicted": 0}
        if self.mux.running:
            if drain:
                stats["evicted"] += await self.mux.call(
                    lambda s: self.mux.evict_parked("server draining"))
                loop = asyncio.get_running_loop()
                deadline = loop.time() + timeout
                while loop.time() < deadline:
                    live = await self.mux.call(
                        lambda s: len(self.registry.live))
                    if live == 0:
                        break
                    stats["drained"] = live
                    await asyncio.sleep(0.01)
                stats["evicted"] += await self.mux.call(
                    lambda s: self.mux.evict_all("drain timeout"))
            else:
                stats["evicted"] += await self.mux.call(
                    lambda s: self.mux.evict_all("server stopped"))
            self.mux.stop()
        self.session.close()   # wakes anything still blocked in a wait
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        return stats

    # ------------------------------------------------------------------
    # dispatch (the ASGI-shaped test transport)
    # ------------------------------------------------------------------
    async def dispatch(self, method: str, path: str,
                       body: Optional[Dict[str, Any]] = None) -> Response:
        try:
            if method == "GET":
                return await self._get(path)
            if method == "POST":
                if path == "/v1/generate":
                    return await self._generate(body or {})
                if path == "/v1/explore":
                    return await self._explore(body or {})
                return _error(404, f"no route {method} {path}")
            return _error(405, f"method {method} not allowed")
        except (QuotaExceeded, AdmissionDenied) as err:
            return _error(_status_for(err), str(err), errno=err.errno)
        except BranchError as err:
            return _error(400, str(err), errno=err.errno)

    async def _get(self, path: str) -> Response:
        if path == "/healthz":
            ok = self.mux.running and self.mux.crashed is None
            return Response(200 if ok else 500, body={
                "ok": ok, "draining": self.draining,
                "live": len(self.registry.live)})
        if path == "/metrics":
            if self.mux.running:
                text = await self.mux.call(lambda s: s.obs.metrics.format())
            else:
                text = self.session.obs.metrics.format()
            return Response(200, text=text)
        if path == "/v1/tenants":
            if self.mux.running:
                usage = await self.mux.call(lambda s: self.tenancy.usage())
            else:
                usage = self.tenancy.usage()
            return Response(200, body={"tenants": usage})
        if path.startswith("/v1/sessions/") and path.endswith("/tree"):
            frag = path[len("/v1/sessions/"):-len("/tree")]
            try:
                sid = int(frag)
            except ValueError:
                return _error(400, f"bad session id {frag!r}")
            return await self._tree(sid)
        return _error(404, f"no route GET {path}")

    # ------------------------------------------------------------------
    # request launch paths
    # ------------------------------------------------------------------
    def _reject_if_draining(self) -> Optional[Response]:
        if self.draining or not self.mux.running:
            return _error(503, "server is draining; no new requests")
        return None

    @staticmethod
    def _prompt_of(body: Dict[str, Any]) -> list:
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt or \
                not all(isinstance(t, int) for t in prompt):
            raise BranchError("prompt must be a non-empty list of ints")
        return prompt

    async def _launch(self, *, tenant: str, kind: str, prompt: list,
                      max_new_tokens: int, policy_name: str,
                      policy: Any, preemptible: bool,
                      **policy_kw: Any) -> ServedRequest:
        """Quota-check + register + start ONE record, atomically on the
        engine thread (the quota read and the attach that consumes it
        must not interleave with another tenant's launch)."""
        queue: asyncio.Queue = asyncio.Queue()

        def op(session: Any) -> ServedRequest:
            worst = self.tenancy.check_admit(
                tenant, len(prompt), max_new_tokens)   # 429/507, no ledger
            rec = ServedRequest(
                sid=self.registry.new_sid(), tenant=tenant, kind=kind,
                prompt_len=len(prompt), max_new_tokens=max_new_tokens,
                worst_pages=worst, policy=policy_name,
                preemptible=preemptible, queue=queue)
            return self.mux.launch(rec, policy, prompt=prompt, **policy_kw)

        return await self.mux.call(op)

    async def _generate(self, body: Dict[str, Any]) -> Response:
        busy = self._reject_if_draining()
        if busy is not None:
            return busy
        prompt = self._prompt_of(body)
        tenant = str(body.get("tenant", "default"))
        max_new = int(body.get("max_new_tokens", 16))
        if body.get("hold"):
            rec = await self._launch(
                tenant=tenant, kind="parked", prompt=prompt,
                max_new_tokens=max_new, policy_name="parked",
                policy=None, preemptible=True)
            return Response(200, body={
                "id": rec.sid, "tenant": tenant, "state": rec.state,
                "held": True, "worst_pages": rec.worst_pages})
        rec = await self._launch(
            tenant=tenant, kind="chat", prompt=prompt,
            max_new_tokens=max_new, policy_name="chat",
            policy=chat_policy, preemptible=False,
            tokens=max_new, greedy=bool(body.get("greedy", True)),
            temperature=float(body.get("temperature", 1.0)))
        return await self._respond(rec, stream=body.get("stream", True))

    async def _explore(self, body: Dict[str, Any]) -> Response:
        busy = self._reject_if_draining()
        if busy is not None:
            return busy
        prompt = self._prompt_of(body)
        tenant = str(body.get("tenant", "default"))
        name = str(body.get("policy", "best_of_n"))
        if name not in POLICIES:
            return _error(400, f"unknown policy {name!r}; have "
                          f"{sorted(POLICIES)}")
        fn, allowed, default_new, preemptible = POLICIES[name]
        params = body.get("params") or {}
        bad = set(params) - set(allowed)
        if bad:
            return _error(400, f"policy {name!r} does not accept "
                          f"{sorted(bad)}; allowed: {sorted(allowed)}")
        max_new = int(body.get("max_new_tokens", default_new))
        rec = await self._launch(
            tenant=tenant, kind="explore", prompt=prompt,
            max_new_tokens=max_new, policy_name=name, policy=fn,
            preemptible=preemptible, **params)
        return await self._respond(rec, stream=body.get("stream", True))

    # ------------------------------------------------------------------
    # responses
    # ------------------------------------------------------------------
    async def _respond(self, rec: ServedRequest, *,
                       stream: bool) -> Response:
        if stream:
            return Response(200, events=self._stream(rec))
        # blocking mode: drain the stream server-side, answer once
        final: Dict[str, Any] = {}
        async for event, data in self._stream(rec):
            if event in ("result", "finished", "evicted", "error"):
                final = {"event": event, **data}
        status = {"error": 500, "evicted": 409}.get(
            final.get("event", ""), 200)
        return Response(status, body={
            "id": rec.sid, "tenant": rec.tenant, "state": rec.state,
            **final})

    async def _stream(self, rec: ServedRequest
                      ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        """Yield a record's SSE events until its terminal sentinel.

        A consumer that goes away mid-stream (client disconnect) evicts
        the record: abandoned requests must not keep page reservations.
        """
        try:
            while True:
                item = await rec.queue.get()
                if item is None:
                    return
                yield item
        finally:
            if rec.live:
                self.mux.post(lambda s: (
                    self.mux.evict(rec, "client disconnected")
                    if rec.live else None))

    async def _tree(self, sid: int) -> Response:
        rec = self.registry.get(sid)
        if rec is None:
            return _error(404, f"no served request {sid}")

        def op(session: Any) -> Dict[str, Any]:
            out: Dict[str, Any] = {
                "id": rec.sid, "tenant": rec.tenant, "kind": rec.kind,
                "policy": rec.policy, "state": rec.state,
                "req_id": rec.req_id, "tokens_sent": rec.tokens_sent,
                "worst_pages": rec.worst_pages,
                "preemptible": rec.preemptible,
                "priority": rec.priority,
                "demoted": rec.demoted,
            }
            if rec.evict_reason:
                out["evict_reason"] = rec.evict_reason
            if rec.final_tokens is not None:
                out["final_tokens"] = list(rec.final_tokens)
            hd = rec.root_hd if rec.root_hd is not None else (
                rec.exp.hd if rec.exp is not None else None)
            if rec.live and hd is not None:
                try:
                    out["stat"] = session.stat(hd)
                except BranchError:
                    pass    # handle raced a resolve; tree still renders
            out["session"] = session.tree()
            return out

        if self.mux.running:
            view = await self.mux.call(op)
        else:
            view = op(self.session)
        return Response(200, body=jsonable(view))

    # ------------------------------------------------------------------
    # the socket front end (thin wrapper over dispatch)
    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, body = req
            resp = await self.dispatch(method, path, body)
            await self._write_response(writer, resp)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (OSError, RuntimeError):
                pass    # peer already gone / transport mid-teardown

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader
                            ) -> Optional[Tuple[str, str, Optional[dict]]]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        length = 0
        for line in lines[1:]:
            if line.lower().startswith("content-length:"):
                length = int(line.split(":", 1)[1].strip())
        body = None
        if length:
            raw = await reader.readexactly(length)
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                body = None
        return method, path, body

    async def _write_response(self, writer: asyncio.StreamWriter,
                              resp: Response) -> None:
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found",
                   405: "Method Not Allowed", 409: "Conflict",
                   429: "Too Many Requests", 500: "Internal Server Error",
                   503: "Service Unavailable",
                   507: "Insufficient Storage"}
        reason = reasons.get(resp.status, "Status")
        if resp.events is None:
            payload = resp.render_body()
            writer.write(
                f"HTTP/1.1 {resp.status} {reason}\r\n"
                f"Content-Type: {resp.content_type}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n".encode() + payload)
            await writer.drain()
            return
        writer.write(
            f"HTTP/1.1 {resp.status} {reason}\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-cache\r\n"
            "Connection: close\r\n\r\n".encode())
        await writer.drain()
        async for event, data in resp.events:
            frame = f"event: {event}\ndata: {json.dumps(data)}\n\n"
            writer.write(frame.encode())
            await writer.drain()   # ConnectionError here → _stream evicts


__all__ = ["FrontDoor", "POLICIES", "Response"]
