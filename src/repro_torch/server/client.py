"""Async client for the serving front door (stdlib only).

The port's copy of ``repro/server/client.py`` (the port imports nothing
of the JAX package, so it keeps its own).

Speaks exactly the dialect :mod:`repro_torch.server.app` serves: HTTP/1.1
with ``Connection: close`` and SSE frames of the form
``event: <name>\\ndata: <json>\\n\\n``.  Used by
``chip_smoke.py``'s front-door phase and the port's tests; it is
intentionally not a general HTTP client.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple


class ServeError(RuntimeError):
    """A non-2xx front-door response."""

    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


class ServeClient:
    """One front-door endpoint (``http://host:port`` or ``host:port``)."""

    def __init__(self, url: str):
        url = url.strip()
        for prefix in ("http://", "https://"):
            if url.startswith(prefix):
                url = url[len(prefix):]
        url = url.rstrip("/")
        host, _, port = url.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------
    async def _connect(self, method: str, path: str,
                       body: Optional[Dict[str, Any]] = None
                       ) -> Tuple[int, str, asyncio.StreamReader,
                                  asyncio.StreamWriter]:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        payload = json.dumps(body).encode() if body is not None else b""
        writer.write(
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: {self.host}:{self.port}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            "Connection: close\r\n\r\n".encode() + payload)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ")[1])
        ctype = ""
        for line in lines[1:]:
            if line.lower().startswith("content-type:"):
                ctype = line.split(":", 1)[1].strip()
        return status, ctype, reader, writer

    @staticmethod
    async def _close(writer: asyncio.StreamWriter) -> None:
        try:
            writer.close()
            await writer.wait_closed()
        except (OSError, RuntimeError):
            pass    # peer already gone / transport mid-teardown

    async def _request(self, method: str, path: str,
                       body: Optional[Dict[str, Any]] = None) -> Any:
        """One plain (non-streaming) round trip; raises on non-2xx."""
        status, ctype, reader, writer = await self._connect(
            method, path, body)
        try:
            raw = await reader.read()
        finally:
            await self._close(writer)
        data: Any = raw.decode()
        if ctype.startswith("application/json"):
            data = json.loads(raw) if raw else {}
        if status >= 400:
            raise ServeError(status, data)
        return data

    async def stream(self, method: str, path: str,
                     body: Optional[Dict[str, Any]] = None
                     ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        """Yield ``(event, data)`` SSE tuples until the server closes."""
        status, ctype, reader, writer = await self._connect(
            method, path, body)
        if not ctype.startswith("text/event-stream"):
            try:
                raw = await reader.read()
            finally:
                await self._close(writer)
            data = json.loads(raw) if raw else {}
            if status >= 400:
                raise ServeError(status, data)
            yield ("response", data)
            return
        try:
            event, data_lines = "", []
            while True:
                line = await reader.readline()
                if not line:
                    return
                text = line.decode().rstrip("\n").rstrip("\r")
                if text.startswith("event:"):
                    event = text[len("event:"):].strip()
                elif text.startswith("data:"):
                    data_lines.append(text[len("data:"):].strip())
                elif not text and (event or data_lines):
                    payload = json.loads("\n".join(data_lines) or "{}")
                    yield (event or "message", payload)
                    event, data_lines = "", []
        finally:
            await self._close(writer)

    # ------------------------------------------------------------------
    # the API surface
    # ------------------------------------------------------------------
    def generate_events(self, prompt: List[int], *, tenant: str = "default",
                        max_new_tokens: int = 16, greedy: bool = True,
                        temperature: float = 1.0
                        ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        return self.stream("POST", "/v1/generate", {
            "tenant": tenant, "prompt": list(prompt),
            "max_new_tokens": max_new_tokens, "greedy": greedy,
            "temperature": temperature, "stream": True})

    def explore_events(self, prompt: List[int], *, policy: str,
                       tenant: str = "default", max_new_tokens: int = 16,
                       params: Optional[Dict[str, Any]] = None
                       ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        return self.stream("POST", "/v1/explore", {
            "tenant": tenant, "prompt": list(prompt), "policy": policy,
            "max_new_tokens": max_new_tokens, "params": params or {},
            "stream": True})

    async def _collect(self, events: AsyncIterator[Tuple[str, dict]]
                       ) -> Dict[str, Any]:
        final: Dict[str, Any] = {"event": None}
        async for event, data in events:
            if event == "response":        # non-stream error surfaced
                raise ServeError(data.get("status", 500), data)
            if event in ("result", "finished", "evicted", "error"):
                final = {"event": event, **data}
        return final

    async def generate(self, prompt: List[int], **kw: Any
                       ) -> Dict[str, Any]:
        """Stream a /v1/generate to completion; returns the terminal
        event (``finished``/``evicted``/``error`` payload)."""
        return await self._collect(self.generate_events(prompt, **kw))

    async def explore(self, prompt: List[int], *, policy: str,
                      **kw: Any) -> Dict[str, Any]:
        """Stream a /v1/explore to completion; returns the terminal
        ``result`` (or ``evicted``/``error``) payload."""
        return await self._collect(
            self.explore_events(prompt, policy=policy, **kw))

    async def hold(self, prompt: List[int], *, tenant: str = "default",
                   max_new_tokens: int = 16) -> Dict[str, Any]:
        """Admit-and-park a reservation-holding request."""
        return await self._request("POST", "/v1/generate", {
            "tenant": tenant, "prompt": list(prompt),
            "max_new_tokens": max_new_tokens, "hold": True})

    async def tree(self, sid: int) -> Dict[str, Any]:
        return await self._request("GET", f"/v1/sessions/{sid}/tree")

    async def tenants(self) -> Dict[str, Any]:
        return await self._request("GET", "/v1/tenants")

    async def metrics(self) -> str:
        return await self._request("GET", "/metrics")

    async def health(self) -> Dict[str, Any]:
        return await self._request("GET", "/healthz")


__all__ = ["ServeClient", "ServeError"]
