"""Framework-free ASGI app: the OpenAI-wire HTTP front door.

The container bakes in no ASGI framework, so this is the protocol itself — a
plain ``async def __call__(scope, receive, send)`` — which also makes it
directly mountable under ``httpx.ASGITransport`` for hermetic in-process wire
tests (no sockets, byte-for-byte assertions against the client library).

Routes:

    POST /v1/chat/completions   stream=false → one JSON ChatCompletion whose
                                bytes match KLLMs.create()'s model_dump;
                                stream=true → SSE ``chat.completion.chunk``
                                deltas per sample (wire choice index 1..n)
                                then ONE final consensus ``chat.completion``
                                event (consolidated choices[0] + likelihoods),
                                then ``data: [DONE]``.
    POST /v1/batches            durable offline batch submission: the body is
                                a JSONL file of chat-completion requests
                                (OpenAI batch lines or bare bodies). Journaled
                                and fsynced BEFORE the 200 — a crash after the
                                response can never lose the job. Items run at
                                batch-SLO priority under the caller's quota.
    GET  /v1/batches/{id}       job status + request counts.
    POST /v1/batches/{id}/cancel
                                cancel: queued items never run; in-flight
                                items finish into the partial output.
    GET  /v1/batches/{id}/output
                                the output JSONL (one record per item, input
                                order, exactly once). 409 until terminal.
    GET  /healthz               scheduler lifecycle snapshot; 200 while the
                                backend admits work, 503 once DRAINING/STOPPED.
    GET  /metrics               Prometheus text exposition (0.0.4): HELP/TYPE
                                for every family — event counters, engine
                                gauges, and the latency histograms
                                (kllms_*_seconds _bucket/_sum/_count).
    GET  /debug/requests        flight-recorder ring of recent request records
                                (trace_id, phases, status, annotations).
                                404 unless BackendConfig.debug_endpoints.
    POST /debug/profile         on-demand torch.profiler capture (bounded
                                duration). 404 unless debug_endpoints.

Request tracing: a W3C ``traceparent`` header on POST /v1/chat/completions is
ingested at this front door (one is generated when absent) and bound to the
request context — ``asyncio.to_thread`` copies the contextvar into the thread
running the client call, so scheduler admission, decode, and consolidation all
attribute their spans to the caller's trace. The front door owns the trace:
every terminal path (200, wire error, stream end/abort, disconnect) finishes
it exactly once into the flight recorder.

Typed wire errors map to HTTP: each KLLMsError carries ``status_code`` and an
OpenAI-shaped ``as_wire()`` body, so 429/503/408/400 come out of the SAME
exception types the in-process client raises; RateLimitError's scheduler
estimate becomes a ``Retry-After`` header.

A client disconnect mid-stream cancels the decode: the ASGI ``http.disconnect``
message closes the ChatCompletionStream, whose budget-cancel propagates through
the engine's abort poller (``engine.decode_abort``). The ``serving.request``
failpoint's ``disconnect`` action simulates exactly that drop after the first
delta, deterministic enough for the soak test.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.locks import make_lock
from ..observability import prometheus as _prom
from ..reliability import failpoints as _failpoints
from ..reliability.tenancy import permissive as _permissive_tenancy
from ..types.wire import InvalidRequestError, KLLMsError, RateLimitError
from ..utils import observability as _obs
from . import sse

logger = logging.getLogger(__name__)

#: Fallback tenant registry for backends that don't carry one (FakeBackend,
#: bare test doubles): everything resolves to the unlimited default tenant.
_DEFAULT_TENANCY = _permissive_tenancy()

#: Latency families that fan out per tenant (``<base>.<tenant>``); rendered on
#: /metrics as one ``kllms_<base>_by_tenant_seconds`` histogram family with a
#: ``tenant`` label rather than one unlabeled family per tenant.
_TENANT_HIST_BASES = ("request.e2e", "request.ttft", "scheduler.queue_wait")

# Request-body keys forwarded to Completions.create. Anything else in the
# payload is ignored (OpenAI semantics: unknown fields don't fail requests).
_CREATE_KEYS = (
    "messages", "model", "n", "temperature", "max_tokens", "top_p",
    "frequency_penalty", "presence_penalty", "stop", "seed",
    "response_format", "timeout", "logprobs", "top_logprobs", "logit_bias",
)

_COUNTER_GROUPS = (
    ("failure", "FAILURE_EVENTS"),
    ("spec", "SPEC_EVENTS"),
    ("recovery", "RECOVERY_EVENTS"),
    ("route", "ROUTE_EVENTS"),
    ("hedge", "HEDGE_EVENTS"),
    ("failover", "FAILOVER_EVENTS"),
    ("quarantine", "QUARANTINE_EVENTS"),
    ("serve", "SERVE_EVENTS"),
    ("stream", "STREAM_EVENTS"),
    ("consensus", "CONSENSUS_EVENTS"),
    ("kernel", "KERNEL_EVENTS"),
    ("grammar", "GRAMMAR_EVENTS"),
    ("tenant", "TENANT_EVENTS"),
    ("batch", "BATCH_EVENTS"),
)

#: Declarative route table: (method, path pattern, handler attribute). Path
#: segments in ``{braces}`` capture into the ``params`` dict every handler
#: receives. Dispatch derives BOTH outcomes from this one table: unknown path
#: → 404, known path with the wrong method → 405 + ``Allow`` (the methods
#: listed here for that path) — so adding a route is one line, not a new
#: elif arm plus hand-maintained error cases.
_ROUTES: Tuple[Tuple[str, str, str], ...] = (
    ("POST", "/v1/chat/completions", "_chat"),
    ("POST", "/v1/batches", "_batch_create"),
    ("GET", "/v1/batches/{batch_id}", "_batch_get"),
    ("POST", "/v1/batches/{batch_id}/cancel", "_batch_cancel"),
    ("GET", "/v1/batches/{batch_id}/output", "_batch_output"),
    ("GET", "/healthz", "_healthz"),
    ("GET", "/metrics", "_metrics"),
    ("GET", "/debug/requests", "_debug_requests"),
    ("POST", "/debug/profile", "_debug_profile"),
)

_COMPILED_ROUTES: Tuple[Tuple[str, Tuple[str, ...], str], ...] = tuple(
    (method, tuple(pattern.strip("/").split("/")), handler)
    for method, pattern, handler in _ROUTES
)


def _match_segments(
    segments: Tuple[str, ...], parts: Tuple[str, ...]
) -> Optional[Dict[str, str]]:
    """Match one compiled pattern against a split request path; returns the
    captured path params, or None when the path doesn't fit."""
    if len(segments) != len(parts):
        return None
    params: Dict[str, str] = {}
    for seg, part in zip(segments, parts):
        if seg.startswith("{") and seg.endswith("}"):
            if not part:
                return None
            params[seg[1:-1]] = part
        elif seg != part:
            return None
    return params

#: Upper bound for a POST /debug/profile capture; anything longer belongs in
#: an offline KLLMS_PROFILE_DIR run, not a request handler.
_PROFILE_MAX_S = 10.0


class ServingApp:
    """ASGI 3 application over one KLLMs client."""

    def __init__(self, client: Any, batch_dir: Optional[str] = None) -> None:
        self.client = client
        self._batch_dir = batch_dir
        self._batch: Optional[Any] = None  # BatchLane, built lazily
        self._batch_lock = make_lock("serving.app_batch")

    # -- ASGI entry --------------------------------------------------------
    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            await self._lifespan(receive, send)
            return
        if scope["type"] != "http":  # pragma: no cover - websockets etc.
            return
        method, path = scope["method"], scope["path"]
        parts = tuple(path.strip("/").split("/"))
        matched: Optional[Tuple[str, Dict[str, str]]] = None
        allowed: List[str] = []
        for route_method, segments, handler in _COMPILED_ROUTES:
            params = _match_segments(segments, parts)
            if params is None:
                continue
            if route_method == method:
                matched = (handler, params)
                break
            allowed.append(route_method)
        try:
            if matched is not None:
                handler, params = matched
                await getattr(self, handler)(scope, receive, send, params)
            elif allowed:
                _obs.SERVE_EVENTS.record("request.unknown.405")
                await _send_json(
                    send, 405,
                    _error_body(
                        f"method {method} not allowed for {path}",
                        "invalid_request_error", "method_not_allowed",
                    ),
                    extra_headers=[(
                        b"allow",
                        ", ".join(sorted(set(allowed))).encode(),
                    )],
                )
            else:
                _obs.SERVE_EVENTS.record("request.unknown.404")
                await _send_json(
                    send, 404,
                    _error_body("not found", "invalid_request_error", "not_found"),
                )
        except ClientDisconnected:
            _obs.SERVE_EVENTS.record("request.disconnect")
        except Exception:  # pragma: no cover - last-resort 500
            logger.exception("unhandled error serving %s %s", method, path)
            try:
                await _send_json(
                    send, 500,
                    _error_body("internal server error", "server_error", None),
                )
            except Exception:
                pass

    async def _lifespan(self, receive, send) -> None:
        while True:
            message = await receive()
            if message["type"] == "lifespan.startup":
                await asyncio.to_thread(self.startup)
                await send({"type": "lifespan.startup.complete"})
            elif message["type"] == "lifespan.shutdown":
                await asyncio.to_thread(self.drain)
                await send({"type": "lifespan.shutdown.complete"})
                return

    # -- lifecycle ---------------------------------------------------------
    def startup(self) -> None:
        """Eager restart recovery: when a DURABLE batch store is configured
        (flag, config, or env — not an ephemeral tempdir), build the lane now
        so journaled jobs resume without waiting for the first batch request.
        Recovery failure degrades to lazy init; it never blocks serving."""
        backend = getattr(self.client, "backend", None)
        cfg = getattr(backend, "backend_config", None)
        durable = (
            self._batch_dir
            or getattr(cfg, "batch_store_dir", None)
            or os.environ.get("KLLMS_BATCH_DIR")
        )
        if not durable:
            return
        try:
            self._batch_lane()
        except Exception:
            logger.exception("batch-lane startup recovery failed")

    def drain(self) -> None:
        """Graceful shutdown: checkpoint the batch lane FIRST (in-flight items
        requeued durably), then drain the backend scheduler."""
        with self._batch_lock:
            lane = self._batch
        if lane is not None:
            lane.drain()
        backend = getattr(self.client, "backend", None)
        drain = getattr(backend, "drain", None)
        if callable(drain):
            drain()

    def _batch_lane(self) -> Any:
        """The lazily-built BatchLane (import deferred: batch.py imports this
        module's _CREATE_KEYS at its top, so the reverse edge must be lazy)."""
        with self._batch_lock:
            if self._batch is None:
                from ..reliability.jobstore import JobStore
                from .batch import BatchLane

                backend = getattr(self.client, "backend", None)
                cfg = getattr(backend, "backend_config", None)
                root = (
                    self._batch_dir
                    or getattr(cfg, "batch_store_dir", None)
                    or os.environ.get("KLLMS_BATCH_DIR")
                    or tempfile.mkdtemp(prefix="kllms-batches-")
                )
                lane = BatchLane(
                    self.client,
                    JobStore(
                        root,
                        ttl_s=getattr(cfg, "jobstore_ttl_s", None),
                    ),
                    max_in_flight=int(
                        getattr(cfg, "batch_max_in_flight", 4) or 4
                    ),
                    item_retries=int(getattr(cfg, "batch_item_retries", 1) or 1),
                )
                lane.recover()
                self._batch = lane
            return self._batch

    # -- /v1/batches -------------------------------------------------------
    def _resolve_tenant(self, scope) -> str:
        # Tenant resolution happens from the API key — never from the request
        # body, so clients can't claim another tenant's quota or weight by
        # naming it in JSON. Unmapped keys become their own dynamic tenant
        # under the default spec (see TenancyConfig.tenant_for_key).
        api_key: Optional[str] = None
        for key, value in scope.get("headers") or []:
            if key == b"authorization":
                auth = value.decode("latin-1")
                api_key = (
                    auth[7:].strip()
                    if auth[:7].lower() == "bearer " else auth.strip()
                )
        backend = getattr(self.client, "backend", None)
        tenancy = getattr(backend, "tenancy", None) or _DEFAULT_TENANCY
        return tenancy.tenant_for_key(api_key)

    async def _batch_create(self, scope, receive, send, params) -> None:
        tenant = self._resolve_tenant(scope)
        body = await _read_body(receive)
        try:
            lane = await asyncio.to_thread(self._batch_lane)
            wire = await asyncio.to_thread(lane.submit, body, tenant)
        except Exception as e:
            await self._send_error(send, e, route="batch")
            return
        _obs.SERVE_EVENTS.record("request.batch.200")
        await _send_json(send, 200, wire)

    async def _batch_get(self, scope, receive, send, params) -> None:
        lane = await asyncio.to_thread(self._batch_lane)
        wire = await asyncio.to_thread(lane.job_wire, params["batch_id"])
        if wire is None:
            await self._batch_404(send, params["batch_id"])
            return
        _obs.SERVE_EVENTS.record("request.batch.200")
        await _send_json(send, 200, wire)

    async def _batch_cancel(self, scope, receive, send, params) -> None:
        await _read_body(receive)
        lane = await asyncio.to_thread(self._batch_lane)
        wire = await asyncio.to_thread(lane.cancel, params["batch_id"])
        if wire is None:
            await self._batch_404(send, params["batch_id"])
            return
        _obs.SERVE_EVENTS.record("request.batch.200")
        await _send_json(send, 200, wire)

    async def _batch_output(self, scope, receive, send, params) -> None:
        lane = await asyncio.to_thread(self._batch_lane)
        job_id = params["batch_id"]
        if await asyncio.to_thread(lane.job_wire, job_id) is None:
            await self._batch_404(send, job_id)
            return
        data = await asyncio.to_thread(lane.output_bytes, job_id)
        if data is None:
            # Known job, not terminal yet: 409 rather than a partial file —
            # the output contract is "complete, input order, exactly once".
            _obs.SERVE_EVENTS.record("request.batch.409")
            await _send_json(
                send, 409,
                _error_body(
                    f"batch {job_id} is not finished; output is available "
                    "once the job reaches a terminal status",
                    "invalid_request_error", "batch_not_finished",
                ),
            )
            return
        _obs.SERVE_EVENTS.record("request.batch.200")
        await _send_bytes(
            send, 200, data, content_type=b"application/jsonl"
        )

    async def _batch_404(self, send, job_id: str) -> None:
        _obs.SERVE_EVENTS.record("request.batch.404")
        await _send_json(
            send, 404,
            _error_body(
                f"no batch job {job_id!r}",
                "invalid_request_error", "not_found", param="batch_id",
            ),
        )

    # -- GET /healthz ------------------------------------------------------
    async def _healthz(self, scope, receive, send, params) -> None:
        backend = getattr(self.client, "backend", None)
        health = getattr(backend, "health", None)
        snap = await asyncio.to_thread(health) if callable(health) else {
            "state": "ready"
        }
        with self._batch_lock:
            lane = self._batch
        if lane is not None:
            snap = dict(snap)
            # Per-job progress rides the health snapshot so operators can
            # watch offline work without polling every job id.
            snap["batch"] = await asyncio.to_thread(lane.health)
        state = str(snap.get("state", "ready"))
        # Load-balancer semantics: 200 only while this replica ADMITS work.
        # DEGRADED still serves (at reduced width); RECOVERING/DRAINING/
        # STOPPED reject, so health checks must route traffic away.
        status = 200 if state in ("ready", "degraded") else 503
        _obs.SERVE_EVENTS.record(f"request.healthz.{status}")
        await _send_json(send, status, snap)

    # -- GET /metrics ------------------------------------------------------
    async def _metrics(self, scope, receive, send, params) -> None:
        # Proper Prometheus 0.0.4 exposition: every family carries HELP/TYPE
        # lines, label values are escaped, and the latency histograms render
        # the full _bucket/_sum/_count triple (cumulative, +Inf included).
        families: List[Dict[str, Any]] = []
        for group, attr in _COUNTER_GROUPS:
            counters = getattr(_obs, attr, None)
            if counters is None:
                continue
            families.append(_prom.counter_family(
                f"kllms_{group}_events_total",
                f"{group} event counters "
                "(vocabularies declared in utils/observability.py)",
                [
                    ({"event": event}, count)
                    for event, count in sorted(counters.snapshot().items())
                ],
            ))
        # Latency histograms (LATENCY): exactly-declared families export even
        # at zero samples, so the scrape surface is stable from first poll.
        # Per-tenant fan-outs (``request.e2e.<tenant>``...) fold into ONE
        # labeled family per base — tenant ids become escaped label values,
        # never metric names (hostile API keys can't corrupt the exposition).
        tenant_snaps: Dict[str, Dict[str, Any]] = {
            base: {} for base in _TENANT_HIST_BASES
        }
        for fam, snap in sorted(_obs.LATENCY.snapshot().items()):
            base = next(
                (b for b in _TENANT_HIST_BASES if fam.startswith(b + ".")),
                None,
            )
            if base is not None:
                tenant_snaps[base][fam[len(base) + 1:]] = snap
                continue
            families.append(_prom.histogram_family(
                "kllms_" + fam.replace(".", "_") + "_seconds",
                f"latency histogram for {fam} (seconds, log-spaced buckets)",
                snap,
            ))
        for base, snaps in tenant_snaps.items():
            if snaps:
                families.append(_prom.labeled_histogram_family(
                    "kllms_" + base.replace(".", "_") + "_by_tenant_seconds",
                    f"per-tenant latency histogram for {base} "
                    "(seconds, log-spaced buckets; tenant label)",
                    snaps,
                ))
        backend = getattr(self.client, "backend", None)
        cont = getattr(backend, "_continuous", None)
        if cont is not None:
            for key, val in sorted(cont.stats.items()):
                # Numeric gauges only: the stats snapshot also carries nested
                # sections (page pool — exported below via health), strings
                # (last_recovery_reason), and Nones, none of which are
                # Prometheus sample values.
                if isinstance(val, (int, float)):
                    families.append(_prom.gauge_family(
                        f"kllms_continuous_{key}",
                        f"continuous decode loop stat {key!r}",
                        val,
                    ))
        # HBM + paged-KV pool gauges from the backend's health snapshot (the
        # read doubles as a page-accounting invariant check).
        if backend is not None and hasattr(backend, "health"):
            health = backend.health()
            hbm = health.get("hbm") or {}
            for key, val in sorted(hbm.items()):
                if key == "page_pool" and isinstance(val, dict):
                    for pk, pv in sorted(val.items()):
                        families.append(_prom.gauge_family(
                            f"kllms_hbm_page_pool_{pk}",
                            f"paged KV pool stat {pk!r}",
                            pv,
                        ))
                elif isinstance(val, (int, float)) and val is not None:
                    families.append(_prom.gauge_family(
                        f"kllms_hbm_{key}", f"HBM budget stat {key!r}", val
                    ))
            # Consensus cache gauges from the same snapshot: aggregate
            # hits/misses/entries/evictions across every scorer's caches.
            consensus = health.get("consensus") or {}
            for key, val in sorted((consensus.get("cache") or {}).items()):
                families.append(_prom.gauge_family(
                    f"kllms_consensus_cache_{key}",
                    f"consensus similarity/embedding cache stat {key!r}",
                    val,
                ))
            if "device_consensus" in consensus:
                families.append(_prom.gauge_family(
                    "kllms_consensus_device_enabled",
                    "1 when the batched on-device consensus kernels are active",
                    bool(consensus["device_consensus"]),
                ))
            # Grammar-compile cache gauges + the constrained-decoding switch:
            # one compile per (schema, vocab) fleet-wide, so hits/misses here
            # are the direct measure of the cache paying for itself.
            grammar = health.get("grammar") or {}
            for key, val in sorted((grammar.get("cache") or {}).items()):
                families.append(_prom.gauge_family(
                    f"kllms_grammar_cache_{key}",
                    f"compiled grammar-mask cache stat {key!r}",
                    val,
                ))
            if "enabled" in grammar:
                families.append(_prom.gauge_family(
                    "kllms_grammar_enabled",
                    "1 when schema-constrained decoding is enabled",
                    bool(grammar["enabled"]),
                ))
        body = _prom.render_families(families).encode()
        _obs.SERVE_EVENTS.record("request.metrics.200")
        await _send_bytes(send, 200, body, content_type=b"text/plain; version=0.0.4")

    # -- GET /debug/requests + POST /debug/profile -------------------------
    def _debug_enabled(self) -> bool:
        backend = getattr(self.client, "backend", None)
        cfg = getattr(backend, "backend_config", None)
        return bool(getattr(cfg, "debug_endpoints", False))

    async def _debug_denied(self, send) -> None:
        # Indistinguishable from an unknown route: debug surfaces are off by
        # default (BackendConfig.debug_endpoints) and shouldn't advertise
        # their existence to unauthorized scrapers.
        _obs.SERVE_EVENTS.record("request.debug.404")
        await _send_json(
            send, 404,
            _error_body("not found", "invalid_request_error", "not_found"),
        )

    async def _debug_requests(self, scope, receive, send, params) -> None:
        if not self._debug_enabled():
            await self._debug_denied(send)
            return
        recorder = _obs.FLIGHT_RECORDER
        _obs.SERVE_EVENTS.record("request.debug.200")
        await _send_json(
            send, 200,
            {"requests": recorder.snapshot(), **recorder.stats()},
        )

    async def _debug_profile(self, scope, receive, send, params) -> None:
        if not self._debug_enabled():
            await self._debug_denied(send)
            return
        body = await _read_body(receive)
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
            duration = float(payload.get("duration_s", 1.0))
        except ValueError as e:
            _obs.SERVE_EVENTS.record("request.debug.400")
            await _send_json(
                send, 400,
                _error_body(
                    f"invalid profile request: {e}",
                    "invalid_request_error", None,
                ),
            )
            return
        # Bounded capture: clamp instead of erroring so an over-eager
        # duration still yields a usable (shorter) profile.
        duration = min(max(duration, 0.01), _PROFILE_MAX_S)
        log_dir = str(
            payload.get("log_dir")
            or tempfile.mkdtemp(prefix="kllms-profile-")
        )

        def _capture() -> None:
            with _obs.device_profiler(log_dir):
                time.sleep(duration)

        await asyncio.to_thread(_capture)
        _obs.SERVE_EVENTS.record("request.debug.200")
        await _send_json(
            send, 200, {"log_dir": log_dir, "duration_s": duration}
        )

    # -- POST /v1/chat/completions ----------------------------------------
    async def _chat(self, scope, receive, send, params) -> None:
        # Trace ownership lives at the front door: ingest the caller's W3C
        # context (or generate one), bind it for every downstream
        # await/to_thread of this request, and finish it — exactly once —
        # on whichever terminal path the request takes.
        traceparent = None
        for key, value in scope.get("headers") or []:
            if key == b"traceparent":
                traceparent = value.decode("latin-1")
        tenant = self._resolve_tenant(scope)
        _obs.TENANT_EVENTS.record(f"tenant.requests.{tenant}")
        trace = _obs.TRACER.start(traceparent)
        outcome: Dict[str, Any] = {"status": 500, "n": None, "error": None}
        try:
            with _obs.use_trace(trace):
                await self._chat_inner(receive, send, outcome, tenant)
        except ClientDisconnected:
            outcome["status"] = "disconnect"
            raise
        finally:
            _obs.TRACER.finish(
                trace,
                route="chat",
                status=outcome["status"],
                n=outcome["n"],
                error=outcome["error"],
                tenant=tenant,
            )

    async def _chat_inner(
        self, receive, send, outcome: Dict[str, Any], tenant: str
    ) -> None:
        body = await _read_body(receive)
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
        except ValueError as e:
            _obs.SERVE_EVENTS.record("request.chat.400")
            outcome["status"] = 400
            await _send_json(
                send, 400,
                _error_body(f"invalid JSON body: {e}", "invalid_request_error", None),
            )
            return
        messages = payload.get("messages")
        if not isinstance(messages, list) or not messages:
            _obs.SERVE_EVENTS.record("request.chat.400")
            outcome["status"] = 400
            await _send_json(
                send, 400,
                _error_body(
                    "'messages' must be a non-empty list",
                    "invalid_request_error", None, param="messages",
                ),
            )
            return
        stream = bool(payload.get("stream", False))
        params = {k: payload[k] for k in _CREATE_KEYS if payload.get(k) is not None}
        # Deliberately NOT in _CREATE_KEYS: the header-resolved tenant wins
        # over anything in the body.
        params["tenant"] = tenant
        outcome["n"] = payload.get("n")

        # Fault injection at the front door. raise/sleep actions fire inside;
        # a returned ``disconnect`` spec simulates the client dropping the
        # connection after the first streamed delta (see module docstring).
        try:
            spec = _failpoints.fire("serving.request")
        except Exception as e:
            outcome["status"] = await self._send_error(send, e, route="chat")
            outcome["error"] = e
            return
        simulate_disconnect = (
            spec is not None and getattr(spec, "action", None) == "disconnect"
        )

        if not stream:
            try:
                completion = await asyncio.to_thread(
                    self.client.chat.completions.create, **params
                )
            except Exception as e:
                outcome["status"] = await self._send_error(send, e, route="chat")
                outcome["error"] = e
                return
            _obs.SERVE_EVENTS.record("request.chat.200")
            outcome["status"] = 200
            await _send_json(send, 200, completion.model_dump(mode="json"))
            return

        await self._chat_stream(
            receive, send, params, simulate_disconnect, outcome
        )

    async def _chat_stream(
        self,
        receive,
        send,
        params: Dict[str, Any],
        simulate_disconnect: bool,
        outcome: Dict[str, Any],
    ) -> None:
        try:
            stream_obj = await asyncio.to_thread(
                self.client.chat.completions.create, stream=True, **params
            )
        except Exception as e:
            outcome["status"] = await self._send_error(send, e, route="chat")
            outcome["error"] = e
            return
        _obs.STREAM_EVENTS.record("streams.opened")

        # SSE keep-alive: while the decode sits in the admission queue (or a
        # recovery replay re-prefills), no data events flow — emit ``: ping``
        # comment frames at the configured cadence so idle-timeout proxies
        # keep the connection open. 0 disables.
        backend = getattr(self.client, "backend", None)
        ping_interval = float(
            getattr(
                getattr(backend, "backend_config", None),
                "sse_ping_interval_s", 0.0,
            )
            or 0.0
        )

        loop = asyncio.get_running_loop()
        queue: "asyncio.Queue[Tuple[str, Any]]" = asyncio.Queue()

        def _pump() -> None:
            # The ChatCompletionStream iterator blocks on the decode; pump it
            # on a worker thread and relay into the event loop.
            try:
                for event in stream_obj:
                    loop.call_soon_threadsafe(queue.put_nowait, ("event", event))
                loop.call_soon_threadsafe(queue.put_nowait, ("end", None))
            except Exception as e:  # surfaced as an SSE error event
                loop.call_soon_threadsafe(queue.put_nowait, ("error", e))

        threading.Thread(target=_pump, daemon=True, name="sse-pump").start()

        disconnect_task = asyncio.ensure_future(_wait_disconnect(receive))
        started = False
        deltas_sent = 0
        try:
            while True:
                get_task = asyncio.ensure_future(queue.get())
                while True:
                    done, _ = await asyncio.wait(
                        {get_task, disconnect_task},
                        timeout=ping_interval if ping_interval > 0 else None,
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                    if done:
                        break
                    # Idle gap: heartbeat. The first ping may have to open the
                    # response itself (a queued request has produced nothing
                    # yet); an error surfacing after that rides the stream as
                    # an SSE error event, exactly like any post-first-delta
                    # failure.
                    if not started:
                        await send({
                            "type": "http.response.start",
                            "status": 200,
                            "headers": list(sse.HEADERS),
                        })
                        started = True
                    await send({
                        "type": "http.response.body",
                        "body": sse.PING,
                        "more_body": True,
                    })
                    _obs.STREAM_EVENTS.record("streams.pings")
                if disconnect_task in done:
                    get_task.cancel()
                    outcome["status"] = "disconnect"
                    await self._abort_stream(stream_obj, "client disconnected")
                    return
                kind, value = get_task.result()
                if kind == "error":
                    e = value
                    outcome["error"] = e
                    if not started:
                        outcome["status"] = await self._send_error(
                            send, e, route="chat"
                        )
                    else:
                        # Headers are on the wire; the error rides the stream.
                        wire = (
                            e.as_wire()["error"]
                            if isinstance(e, KLLMsError)
                            else {"message": str(e), "type": "server_error"}
                        )
                        outcome["status"] = "stream_error"
                        await send({
                            "type": "http.response.body",
                            "body": sse.format_event({"error": wire}) + sse.DONE,
                            "more_body": False,
                        })
                    _obs.STREAM_EVENTS.record("streams.aborted")
                    return
                if kind == "end":
                    outcome["status"] = 200
                    await send({
                        "type": "http.response.body",
                        "body": sse.DONE,
                        "more_body": False,
                    })
                    _obs.STREAM_EVENTS.record("streams.completed")
                    _obs.SERVE_EVENTS.record("request.chat.200")
                    return
                event = value
                if not started:
                    await send({
                        "type": "http.response.start",
                        "status": 200,
                        "headers": list(sse.HEADERS),
                    })
                    started = True
                await send({
                    "type": "http.response.body",
                    "body": sse.format_event(event),
                    "more_body": True,
                })
                if event.get("object") == "chat.completion.chunk":
                    if event["choices"][0]["delta"].get("content"):
                        _obs.STREAM_EVENTS.record("tokens.streamed")
                    deltas_sent += 1
                if simulate_disconnect and deltas_sent >= 1:
                    # Injected client drop: behave exactly as if http.disconnect
                    # arrived now — cancel the decode, stop writing.
                    outcome["status"] = "disconnect"
                    _obs.SERVE_EVENTS.record("request.disconnect")
                    await self._abort_stream(
                        stream_obj, "injected disconnect (failpoint)",
                        record_disconnect=False,
                    )
                    await send({
                        "type": "http.response.body",
                        "body": b"",
                        "more_body": False,
                    })
                    return
        finally:
            if not disconnect_task.done():
                disconnect_task.cancel()

    async def _abort_stream(
        self, stream_obj, reason: str, record_disconnect: bool = True
    ) -> None:
        if record_disconnect:
            _obs.SERVE_EVENTS.record("request.disconnect")
        _obs.STREAM_EVENTS.record("streams.aborted")
        logger.info("aborting stream: %s", reason)
        # close() cancels the stream's budget; the engine's abort poller (or
        # the continuous loop's budget check) then retires the decode rows.
        await asyncio.to_thread(stream_obj.close)

    async def _send_error(self, send, e: Exception, route: str) -> int:
        if isinstance(e, KLLMsError):
            status = e.status_code
            body = e.as_wire()  # already the full {"error": {...}} envelope
        else:
            logger.exception("request failed")
            status = 500
            body = _error_body(str(e) or "internal server error", "server_error", None)
        headers: List[Tuple[bytes, bytes]] = []
        if isinstance(e, RateLimitError) and e.retry_after is not None:
            headers.append((b"retry-after", str(max(1, int(e.retry_after))).encode()))
        _obs.SERVE_EVENTS.record(f"request.{route}.{status}")
        await _send_json(send, status, body, extra_headers=headers)
        return status


def create_app(
    client: Optional[Any] = None,
    batch_dir: Optional[str] = None,
    **client_kwargs: Any,
) -> ServingApp:
    """Build the app, constructing a KLLMs client when one isn't supplied."""
    if client is None:
        from ..client import KLLMs

        client = KLLMs(**client_kwargs)
    return ServingApp(client, batch_dir=batch_dir)


# -- ASGI plumbing ---------------------------------------------------------
class ClientDisconnected(Exception):
    pass


async def _read_body(receive) -> bytes:
    chunks: List[bytes] = []
    while True:
        message = await receive()
        if message["type"] == "http.disconnect":
            raise ClientDisconnected()
        chunks.append(message.get("body", b""))
        if not message.get("more_body", False):
            return b"".join(chunks)


async def _wait_disconnect(receive) -> None:
    while True:
        message = await receive()
        if message["type"] == "http.disconnect":
            return


def _error_body(
    message: str, err_type: str, code: Optional[str], param: Optional[str] = None
) -> Dict[str, Any]:
    return {
        "error": {"message": message, "type": err_type, "param": param, "code": code}
    }


async def _send_bytes(
    send, status: int, body: bytes,
    content_type: bytes = b"application/json",
    extra_headers: Optional[List[Tuple[bytes, bytes]]] = None,
) -> None:
    headers = [
        (b"content-type", content_type),
        (b"content-length", str(len(body)).encode()),
    ]
    headers.extend(extra_headers or [])
    await send({"type": "http.response.start", "status": status, "headers": headers})
    await send({"type": "http.response.body", "body": body})


async def _send_json(
    send, status: int, obj: Any,
    extra_headers: Optional[List[Tuple[bytes, bytes]]] = None,
) -> None:
    await _send_bytes(
        send, status, json.dumps(obj, separators=(",", ":")).encode(),
        extra_headers=extra_headers,
    )
