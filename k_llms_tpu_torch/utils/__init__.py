"""Small shared utilities: the observability surface (tracing, logging, the
profiler window, the confidence histogram) and quality helpers."""

from .observability import (
    Trace,
    confidence_histogram,
    configure_logging,
    device_profiler,
)

__all__ = ["Trace", "confidence_histogram", "configure_logging", "device_profiler"]
