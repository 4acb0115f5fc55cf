"""Observability layer for the serving stack (see README "Observability").

Three pieces, re-exported through ``utils/observability.py`` for the rest of
the package:

- :mod:`.trace` — ``Tracer``/``Span`` request tracing with W3C
  ``traceparent`` ingestion and contextvar propagation;
- :mod:`.histograms` — declared-vocabulary log-bucketed latency histograms
  (``EventCounters`` hygiene contract, ``counter-hygiene`` lint enforced);
- :mod:`.flight` — the bounded flight recorder behind ``/debug/requests``;
- :mod:`.prometheus` — text-exposition (0.0.4) rendering for ``/metrics``.
"""

from .flight import DEFAULT_CAPACITY, FLIGHT_RECORDER, FlightRecorder
from .histograms import DEFAULT_BUCKETS, LATENCY, LatencyHistograms
from .prometheus import (
    counter_family,
    escape_help,
    escape_label_value,
    format_bound,
    format_value,
    gauge_family,
    histogram_family,
    render_families,
)
from .trace import (
    MAX_SPANS,
    NOOP_TRACE,
    NoopTrace,
    RequestTrace,
    Span,
    TRACER,
    Tracer,
    current_trace,
    format_traceparent,
    parse_traceparent,
    use_trace,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_CAPACITY",
    "FLIGHT_RECORDER",
    "FlightRecorder",
    "LATENCY",
    "LatencyHistograms",
    "MAX_SPANS",
    "NOOP_TRACE",
    "NoopTrace",
    "RequestTrace",
    "Span",
    "TRACER",
    "Tracer",
    "counter_family",
    "current_trace",
    "escape_help",
    "escape_label_value",
    "format_bound",
    "format_value",
    "format_traceparent",
    "gauge_family",
    "histogram_family",
    "parse_traceparent",
    "render_families",
    "use_trace",
]
