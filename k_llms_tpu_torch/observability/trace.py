"""Request-scoped tracing: trace_id/span_id context for the serving stack.

One :class:`RequestTrace` rides a request from the HTTP front door (or an
in-process ``create()`` call) through scheduler admission, coalescing or
continuous-loop decode, and consensus consolidation. Trace context is
ingested from a W3C ``traceparent`` header when the caller sends one and
generated otherwise; propagation is a :mod:`contextvars` variable, which
``asyncio.to_thread`` copies into the worker thread running the client call,
plus explicit capture at the two plain-``threading`` boundaries (scheduler
``_Item`` and continuous-loop ``_SlotRequest`` hold the submitting thread's
trace; the stream sink thread re-enters it via :func:`use_trace`).

Phases accumulate (``+=``) into one duration table, so a watchdog
rebuild+replay extends the SAME trace — one coherent record with a
``replayed`` annotation rather than two half-traces. Everything here is
host-side wall clock: no device syncs, nothing inside jitted step programs.

Tracing must never fail a request: the ``serving.trace`` failpoint's
``drop`` action (and any unexpected error while starting a trace) degrades
the tracer to :data:`NOOP_TRACE`, whose spans are free and which is never
flight-recorded.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..analysis.lockcheck import make_lock
from ..reliability import failpoints as _failpoints
from .flight import FLIGHT_RECORDER, FlightRecorder
from .histograms import LATENCY, LatencyHistograms

_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})-"
    r"(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)

#: Per-trace span cap: a pathological request (thousands of coalesced decode
#: launches) keeps its aggregate durations but stops growing the span list.
MAX_SPANS = 128


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str, str]]:
    """``(trace_id, parent_span_id, flags)`` from a W3C traceparent header,
    or None when absent/malformed (all-zero ids and version ff are invalid
    per spec, and a bad header must not fail the request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id = m.group("trace_id")
    span_id = m.group("span_id")
    if (
        m.group("version") == "ff"
        or trace_id == "0" * 32
        or span_id == "0" * 16
    ):
        return None
    return trace_id, span_id, m.group("flags")


def format_traceparent(trace_id: str, span_id: str, flags: str = "01") -> str:
    return f"00-{trace_id}-{span_id}-{flags}"


class Span:
    """One recorded phase occurrence: name + offset from trace start +
    duration, with its own span_id parented on the trace's root span."""

    __slots__ = ("name", "span_id", "parent_id", "start_s", "duration_s")

    def __init__(
        self, name: str, span_id: str, parent_id: str, start_s: float, duration_s: float
    ) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_s = start_s
        self.duration_s = duration_s

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": round(self.start_s, 6),
            "duration_s": round(self.duration_s, 6),
        }


class RequestTrace:
    """Thread-safe per-request trace: aggregated phase durations (the
    ``KLLMS_TRACE=1`` ``timings`` payload), a bounded span list, and
    free-form annotations (``replayed``, ``quarantined_rows``...).

    ``phase()`` keeps the old two-phase ``Trace`` API so existing call sites
    and tests hold; mutation is guarded by a lockcheck leaf lock because the
    stream sink thread and the caller can time phases concurrently."""

    def __init__(
        self,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        flags: str = "01",
    ) -> None:
        self._lock = make_lock("observability.trace")
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.flags = flags
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.durations: Dict[str, float] = {}
        self.spans: List[Span] = []
        self.annotations: Dict[str, Any] = {}
        self._finished = False

    @property
    def noop(self) -> bool:
        return False

    def traceparent(self) -> str:
        """The outgoing W3C header for this trace's root span."""
        return format_traceparent(self.trace_id, self.span_id, self.flags)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.monotonic() - self._t0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_phase(name, time.perf_counter() - t0, start_offset_s=start)

    def add_phase(
        self, name: str, duration_s: float, start_offset_s: Optional[float] = None
    ) -> None:
        """Accumulate a phase duration (and one span) measured externally —
        the thread-boundary form of ``phase()`` for the scheduler worker and
        the continuous loop, where the timed region isn't a ``with`` block
        on the trace owner's thread."""
        if start_offset_s is None:
            start_offset_s = max(0.0, time.monotonic() - self._t0 - duration_s)
        with self._lock:
            self.durations[name] = self.durations.get(name, 0.0) + duration_s
            if len(self.spans) < MAX_SPANS:
                self.spans.append(
                    Span(name, _new_span_id(), self.span_id, start_offset_s, duration_s)
                )

    def annotate(self, key: str, value: Any = True) -> None:
        with self._lock:
            self.annotations[key] = value

    def bump(self, key: str, n: int = 1) -> None:
        """Increment a numeric annotation (replay/quarantine tallies)."""
        with self._lock:
            prev = self.annotations.get(key)
            base = prev if isinstance(prev, (int, float)) and not isinstance(prev, bool) else 0
            self.annotations[key] = base + n

    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    def mark_finished(self) -> bool:
        """First caller wins — the idempotence behind "exactly one flight
        record per request" even when both the HTTP front door and an inner
        owner try to finish."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
            return True

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return {k: round(v, 6) for k, v in self.durations.items()}

    def spans_as_dicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [s.as_dict() for s in self.spans]

    def annotations_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.annotations)


class NoopTrace:
    """Same surface as :class:`RequestTrace`, no state and no cost: the
    degraded mode behind the ``serving.trace=drop`` failpoint. Never
    finished, never flight-recorded; the request completes untouched."""

    trace_id = ""
    span_id = ""
    parent_span_id = None
    flags = "00"
    started_at = 0.0
    durations: Dict[str, float] = {}
    spans: List[Span] = []
    annotations: Dict[str, Any] = {}

    @property
    def noop(self) -> bool:
        return True

    def traceparent(self) -> str:
        return ""

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        yield

    def add_phase(self, name: str, duration_s: float, start_offset_s: Optional[float] = None) -> None:
        pass

    def annotate(self, key: str, value: Any = True) -> None:
        pass

    def bump(self, key: str, n: int = 1) -> None:
        pass

    def elapsed_s(self) -> float:
        return 0.0

    def mark_finished(self) -> bool:
        return False

    def as_dict(self) -> Dict[str, float]:
        return {}

    def spans_as_dicts(self) -> List[Dict[str, Any]]:
        return []

    def annotations_snapshot(self) -> Dict[str, Any]:
        return {}


#: Shared degraded-mode trace (stateless, so one instance serves everyone).
NOOP_TRACE = NoopTrace()

_current: "contextvars.ContextVar[Optional[RequestTrace]]" = contextvars.ContextVar(
    "kllms_request_trace", default=None
)


def current_trace() -> Optional[RequestTrace]:
    """The trace bound to this thread/task context, if any."""
    return _current.get()


@contextlib.contextmanager
def use_trace(trace: Optional[RequestTrace]) -> Iterator[Optional[RequestTrace]]:
    """Bind ``trace`` as the current context for the block (used by the HTTP
    front door and by worker threads re-entering a captured trace)."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)


class Tracer:
    """Starts, propagates, and finishes request traces; finishing observes
    end-to-end latency and hands the record to the flight recorder."""

    def __init__(
        self,
        recorder: Optional[FlightRecorder] = None,
        latency: Optional[LatencyHistograms] = None,
    ) -> None:
        self._recorder = recorder
        self._latency = latency

    def start(self, traceparent: Optional[str] = None) -> RequestTrace:
        """A new trace adopting the caller's W3C context when present.
        Degrades to :data:`NOOP_TRACE` under the ``serving.trace`` drop
        failpoint or any unexpected error — tracing never fails a request."""
        try:
            spec = _failpoints.fire("serving.trace")
            if spec is not None and spec.action == "drop":
                return NOOP_TRACE
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, parent_span_id, flags = parsed
                return RequestTrace(
                    trace_id=trace_id, parent_span_id=parent_span_id, flags=flags
                )
            return RequestTrace()
        except Exception:
            return NOOP_TRACE

    def current_or_start(self) -> Tuple[RequestTrace, bool]:
        """The context's trace, or a fresh one. The bool is ownership: the
        component that created the trace is the one that must finish it."""
        cur = current_trace()
        if cur is not None:
            return cur, False
        return self.start(), True

    def finish(
        self,
        trace: Optional[RequestTrace],
        *,
        route: str,
        status: Any,
        n: Optional[int] = None,
        error: Optional[BaseException] = None,
        tenant: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        """Close a trace exactly once: observe e2e latency, flight-record.
        Re-finishing (or finishing a noop trace) is a no-op, which is what
        makes "exactly one record per request" hold across owners. When the
        request carried a tenant, the same e2e lands a second time in the
        per-tenant family (``request.e2e.<tenant>``) for the labeled
        ``/metrics`` exposition."""
        if trace is None or trace.noop or not trace.mark_finished():
            return None
        e2e = trace.elapsed_s()
        if self._latency is not None:
            self._latency.observe("request.e2e", e2e)
            if tenant:
                self._latency.observe(f"request.e2e.{tenant}", e2e)
        record: Dict[str, Any] = {
            "trace_id": trace.trace_id,
            "span_id": trace.span_id,
            "parent_span_id": trace.parent_span_id,
            "route": route,
            "status": status,
            "n": n,
            "started_at": round(trace.started_at, 3),
            "duration_s": round(e2e, 6),
            "phases": trace.as_dict(),
            "annotations": trace.annotations_snapshot(),
        }
        if tenant:
            record["tenant"] = tenant
        if error is not None:
            record["error"] = f"{type(error).__name__}: {error}"[:500]
        if self._recorder is not None:
            self._recorder.record(record)
        return record


#: Process-wide tracer wired to the process flight recorder and latency
#: histograms — the one the serving stack uses.
TRACER = Tracer(recorder=FLIGHT_RECORDER, latency=LATENCY)
