"""Stdlib-asyncio HTTP/1.1 runner for the ASGI app.

No uvicorn in the image, so this is the socket layer: ``asyncio.start_server``
with a minimal HTTP/1.1 parser — enough for the OpenAI wire (JSON POSTs, SSE
responses via chunked transfer-encoding, health/metrics GETs). Every response
closes the connection (``Connection: close``), which keeps the parser honest
(no pipelining) and makes client EOF an unambiguous disconnect signal for
mid-stream cancellation.

``HttpServer`` is the async server; ``ServerThread`` runs one on a background
thread with its own event loop (tests and the bench harness use it to stand up
a loopback server beside the client under test); ``python -m k_llms_tpu_torch.serving``
(see __main__.py) runs it in the foreground with signal-driven graceful
shutdown wired to the backend's drain().
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 32 * 1024 * 1024

_STATUS_PHRASES = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 409: "Conflict",
    429: "Too Many Requests", 499: "Client Closed Request",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class HttpServer:
    """One ASGI app on one listening socket."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0) -> None:
        self.app = app
        self.host = host
        self.port = port  # 0 = ephemeral; resolved by start()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("serving on http://%s:%d", self.host, self.port)

    async def stop(self, drain: bool = True) -> None:
        """Graceful shutdown: stop accepting, then drain — preferring the
        app's own drain() (batch-lane checkpoint THEN backend) and falling
        back to the bare backend for non-ServingApp apps (typed 503s for late
        arrivals, in-flight work finishes)."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if drain:
            drain_fn = getattr(self.app, "drain", None)
            if not callable(drain_fn):
                backend = getattr(
                    getattr(self.app, "client", None), "backend", None
                )
                drain_fn = getattr(backend, "drain", None)
            if callable(drain_fn):
                await asyncio.to_thread(drain_fn)

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    # -- connection handling ----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader)
            if request is None:
                return
            method, path, headers, body = request
            await self._run_app(method, path, headers, body, reader, writer)
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            logger.exception("connection handler failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Tuple[str, str, Dict[bytes, bytes], bytes]]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > _MAX_HEADER_BYTES:
            return None
        request_line, *header_lines = head.decode("latin-1").split("\r\n")
        parts = request_line.split(" ")
        if len(parts) != 3:
            return None
        method, target, _version = parts
        headers: Dict[bytes, bytes] = {}
        for line in header_lines:
            if not line or ":" not in line:
                continue
            name, _, value = line.partition(":")
            headers[name.strip().lower().encode("latin-1")] = (
                value.strip().encode("latin-1")
            )
        length = int(headers.get(b"content-length", b"0") or 0)
        if length > _MAX_BODY_BYTES:
            return None
        body = await reader.readexactly(length) if length else b""
        return method, target, headers, body

    async def _run_app(self, method: str, target: str,
                       headers: Dict[bytes, bytes], body: bytes,
                       reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        path, _, query = target.partition("?")
        scope = {
            "type": "http",
            "asgi": {"version": "3.0"},
            "http_version": "1.1",
            "method": method.upper(),
            "path": path,
            "raw_path": target.encode("latin-1"),
            "query_string": query.encode("latin-1"),
            "headers": [(k, v) for k, v in headers.items()],
            "client": writer.get_extra_info("peername"),
            "server": (self.host, self.port),
        }

        # Connection: close per response, so after the request body any read
        # hitting EOF means the CLIENT went away — the disconnect signal the
        # app's mid-stream watcher cancels decodes on.
        disconnected = asyncio.Event()

        async def _watch_eof() -> None:
            try:
                data = await reader.read(1)
                # Either EOF (b"") or stray bytes we won't parse (no
                # pipelining with Connection: close) — both mean this
                # request's client is done with us.
                if data == b"":
                    disconnected.set()
                else:
                    disconnected.set()
            except Exception:
                disconnected.set()

        watcher = asyncio.ensure_future(_watch_eof())
        body_sent = False

        async def receive() -> Dict[str, Any]:
            nonlocal body_sent
            if not body_sent:
                body_sent = True
                return {"type": "http.request", "body": body, "more_body": False}
            await disconnected.wait()
            return {"type": "http.disconnect"}

        state: Dict[str, Any] = {"started": False, "chunked": False, "done": False}

        async def send(message: Dict[str, Any]) -> None:
            if state["done"]:
                return
            if message["type"] == "http.response.start":
                status = message["status"]
                hdrs: List[Tuple[bytes, bytes]] = list(message.get("headers", []))
                names = {k.lower() for k, _ in hdrs}
                chunked = b"content-length" not in names
                state["chunked"] = chunked
                lines = [
                    f"HTTP/1.1 {status} "
                    f"{_STATUS_PHRASES.get(status, 'Unknown')}\r\n".encode()
                ]
                for k, v in hdrs:
                    lines.append(k + b": " + v + b"\r\n")
                if chunked:
                    lines.append(b"transfer-encoding: chunked\r\n")
                lines.append(b"connection: close\r\n\r\n")
                writer.write(b"".join(lines))
                state["started"] = True
                await writer.drain()
            elif message["type"] == "http.response.body":
                data = message.get("body", b"")
                more = message.get("more_body", False)
                if state["chunked"]:
                    if data:
                        writer.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n"
                        )
                    if not more:
                        writer.write(b"0\r\n\r\n")
                else:
                    writer.write(data)
                if not more:
                    state["done"] = True
                try:
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    # Writer-side disconnect detection: surface to the app as
                    # http.disconnect on its next receive().
                    disconnected.set()
                    state["done"] = True

        try:
            await self.app(scope, receive, send)
        finally:
            if not watcher.done():
                watcher.cancel()


class ServerThread:
    """A real-socket server on a background thread — the hermetic harness for
    wire tests and the bench workload (loopback client + server, one process).

    Usage::

        with ServerThread(create_app(client)) as srv:
            httpx.get(f"http://127.0.0.1:{srv.port}/healthz")
    """

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = HttpServer(app, host=host, port=port)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    @property
    def host(self) -> str:
        return self._server.host

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServerThread":
        def _run() -> None:
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self._server.start())
            self._started.set()
            loop.run_forever()
            # Drain runs on loop shutdown (stop() scheduled it before
            # stopping the loop).
            loop.close()

        self._thread = threading.Thread(target=_run, daemon=True, name="kllms-http")
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("HTTP server failed to start within 30s")
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        loop = self._loop
        if loop is None or not loop.is_running():
            return
        fut = asyncio.run_coroutine_threadsafe(self._server.stop(drain=drain), loop)
        try:
            fut.result(timeout=timeout)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            if self._thread is not None:
                self._thread.join(timeout=10)

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
