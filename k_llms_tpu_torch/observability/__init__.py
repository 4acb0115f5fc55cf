"""Observability for the port: the JAX package's declared-vocabulary latency
histograms (:mod:`.histograms`, a copy). Request tracing, the flight
recorder and the Prometheus exposition are not ported yet."""

from .histograms import DEFAULT_BUCKETS, LATENCY, LatencyHistograms

__all__ = ["DEFAULT_BUCKETS", "LATENCY", "LatencyHistograms"]
