"""Tracing, metrics, and logging.

The request-scoped tracing, latency-histogram and flight-recorder layer lives
in ``k_llms_tpu_torch/observability/`` and is re-exported here; this module
keeps the ``EventCounters`` groups (the process-wide counter vocabularies,
the JAX package's declared names), the ``torch.profiler`` wrapper for device
traces, the package logger and consensus-confidence histograms. The port's
kernels keep their own launch counts on their wrappers (``ops/_ext.py``).
"""

from __future__ import annotations

import contextlib
import fnmatch
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..observability import (  # noqa: F401  (re-exported surface)
    FLIGHT_RECORDER,
    FlightRecorder,
    LATENCY,
    LatencyHistograms,
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
from ..analysis.lockcheck import make_lock

#: The request-phase timer call sites construct directly (``phase()`` /
#: ``as_dict()``), lock-guarded.
Trace = RequestTrace


def configure_logging() -> logging.Logger:
    """Package logger; DEBUG iff ENV_NAME=dev."""
    logger = logging.getLogger("k_llms_tpu_torch")
    logger.setLevel(logging.DEBUG if os.getenv("ENV_NAME") == "dev" else logging.INFO)
    return logger


@contextlib.contextmanager
def device_profiler(log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace of the host and, where a card is present,
    its kernels around a block, written into ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``; open it in Perfetto or chrome://tracing). No-ops
    when log_dir is None and KLLMS_PROFILE_DIR is unset."""
    log_dir = log_dir or os.getenv("KLLMS_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"kllms-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    )


class EventCounters:
    """Thread-safe named counters. ``declared`` is the group's counter
    vocabulary (literal names plus fnmatch wildcards); recording a name
    outside it raises, so a misspelt counter never lands in a bucket of its
    own. An empty declaration accepts any name."""

    def __init__(self, declared: Optional[Sequence[str]] = None) -> None:
        self._lock = make_lock("observability.counters")
        self._counts: Dict[str, int] = {}
        self.declared: Tuple[str, ...] = tuple(declared or ())

    def record(self, event: str, n: int = 1) -> None:
        if self.declared and not any(fnmatch.fnmatchcase(event, p) for p in self.declared):
            raise ValueError(
                f"counter {event!r} is not declared for this group "
                f"(declared: {sorted(self.declared)})"
            )
        with self._lock:
            self._counts[event] = self._counts.get(event, 0) + n

    def get(self, event: str) -> int:
        with self._lock:
            return self._counts.get(event, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: Failure-path events (sheds, decode aborts, killed samples, device OOMs,
#: retries, circuit transitions, zero-survivor consolidations), the JAX
#: package's names.
FAILURE_EVENTS = EventCounters(declared=(
    "scheduler.shed",
    "scheduler.shed_stopped",
    "scheduler.shed_over_capacity",
    "scheduler.shed_draining",
    "engine.decode_abort",
    "engine.samples_killed",
    "engine.oom",
    "engine.oom_unrecovered",
    "engine.oom_split",
    "retry.attempt",
    "circuit.rejected",
    "circuit.opened",
    "consensus.zero_survivors",
))

#: Speculative-decoding counters, fed by the scheduler's ``note_spec_stats``
#: (the engine's ``on_spec_stats`` hook, called after every speculative
#: launch).
SPEC_EVENTS = EventCounters(declared=(
    "spec.launches",
    "spec.drafted",
    "spec.accepted",
))

#: Self-healing counters fed by the EngineSupervisor and the continuous
#: decode loop (the ``continuous.*`` names).
RECOVERY_EVENTS = EventCounters(declared=(
    "supervisor.hung_launches",
    "supervisor.rebuilds",
    "supervisor.rebuild_failures",
    "supervisor.replayed",
    "supervisor.stale_results_discarded",
    "continuous.step_hangs",
    "continuous.worker_crashes",
    "continuous.restarts",
    "continuous.replayed_rows",
    "continuous.stale_steps_discarded",
    "continuous.pool_quarantined",
))

#: Replica-routing counters fed by the ReplicaSet router.
ROUTE_EVENTS = EventCounters(declared=(
    "route.dispatched",
    "route.pulled",
    "route.probes",
    "route.probe_failures",
    "route.rejoins",
    "route.no_healthy",
))

#: Hedged-dispatch counters.
HEDGE_EVENTS = EventCounters(declared=(
    "hedge.launched",
    "hedge.won_primary",
    "hedge.won_hedge",
    "hedge.cancelled_losers",
))

#: Mid-flight failover counters.
FAILOVER_EVENTS = EventCounters(declared=(
    "failover.attempts",
    "failover.member_down",
    "failover.exhausted",
))

#: Multi-tenancy counters, keyed by tenant name.
TENANT_EVENTS = EventCounters(declared=(
    "tenant.requests.*",
    "tenant.admitted.*",
    "tenant.served.*",
    "tenant.shed_quota.*",
    "tenant.shed_brownout.*",
    "tenant.shed_over_capacity.*",
    "tenant.evicted.*",
))

#: Paged-attention dispatch counters: which implementation each paged
#: launch ran (``kernel.paged_attn_cuda_dispatch`` for the hand kernel, the
#: port's name for the JAX package's ``..._pallas_dispatch``) and the
#: ``ops.paged_attn`` drill's launches: ``kernel.paged_attn_fallback.failpoint``
#: on the CPU, where it runs the reference, and
#: ``kernel.paged_attn_unavailable.failpoint`` on a card, where it fails the
#: launch.
KERNEL_EVENTS = EventCounters(declared=(
    "kernel.paged_attn_cuda_dispatch",
    "kernel.paged_attn_xla_dispatch",
    "kernel.paged_attn_fallback.*",
    "kernel.paged_attn_unavailable.*",
))

#: Grammar compile-cache and fallback counters, the JAX package's names.
GRAMMAR_EVENTS = EventCounters(declared=(
    "grammar.compile",
    "grammar.hit",
    "grammar.miss",
    "grammar.fallback_unsupported",
    "grammar.fallback_failpoint",
    "grammar.fallback_error",
    "grammar.masked_steps",
))

#: Numeric-integrity counters, the JAX package's names: quarantined decode
#: rows and launches, and corrupted checkpoints rejected at load.
QUARANTINE_EVENTS = EventCounters(declared=(
    "quarantine.samples",
    "quarantine.launches",
    "quarantine.checksum_failures",
))

#: On-device consensus counters, the JAX package's names
#: (consensus.device_dispatch / consensus.host_dispatch — which path a
#: consolidation's similarity prep took; consensus.fallback_failpoint /
#: consensus.fallback_error / consensus.fallback_unavailable — why a device
#: prepare degraded to the host; consensus.device_busy — declared as in the
#: JAX package, never recorded here: the port's scorer waits for its device
#: lock instead of scoring on the host;
#: consensus.device_pairs / consensus.host_pairs / consensus.cached_pairs —
#: where pair similarities came from; consensus.device_cosine — embedding
#: pairs scored by the batched cosine; consensus.device_votes — vote columns
#: tallied in the batched vote), fed by consensus/device.py and surfaced in
#: the backend's health().
# kllms: ignore[counter-hygiene] — consensus.device_busy keeps the JAX package's vocabulary (tests/test_torch_observability.py holds the groups equal); the port's scorer waits for its device lock, so nothing records it
CONSENSUS_EVENTS = EventCounters(declared=(
    "consensus.device_dispatch",
    "consensus.host_dispatch",
    "consensus.fallback_failpoint",
    "consensus.fallback_error",
    "consensus.fallback_unavailable",
    "consensus.device_busy",
    "consensus.device_pairs",
    "consensus.host_pairs",
    "consensus.cached_pairs",
    "consensus.device_cosine",
    "consensus.device_votes",
))

#: HTTP-serving counters (``request.<route>.<status>``, one per completed
#: request keyed by route and HTTP status, plus ``request.disconnect`` for
#: clients that dropped before the response finished), fed by the ASGI app
#: in ``serving/app.py`` and surfaced verbatim on ``/metrics``.
SERVE_EVENTS = EventCounters(declared=(
    "request.*",
))

#: SSE-streaming counters: streams opened, completed and aborted (closed
#: before the final consensus event, by a client disconnect or a mid-stream
#: error), ``tokens.streamed`` (content chunks put on the wire) and
#: ``streams.pings`` (keep-alive comment frames in idle gaps).
STREAM_EVENTS = EventCounters(declared=(
    "streams.opened",
    "streams.completed",
    "streams.aborted",
    "tokens.streamed",
    "streams.pings",
))

#: Offline batch-lane counters: the job lifecycle (created, recovered after a
#: restart, completed with or without item errors, cancelled, swept by the
#: ``jobstore_ttl_s`` sweep), the item lifecycle (output records committed or
#: captured as typed errors, in-flight items requeued by drain, a worker
#: crash or startup reconciliation) and the durability drills (lane worker
#: crashes, torn journal tails truncated on recovery). Fed by
#: ``reliability/jobstore.py`` and ``serving/batch.py``; surfaced on
#: ``/metrics`` as ``kllms_batch_events_total``.
BATCH_EVENTS = EventCounters(declared=(
    "batch.job_created",
    "batch.job_recovered",
    "batch.job_completed",
    "batch.job_completed_with_errors",
    "batch.job_cancelled",
    "batch.item_completed",
    "batch.item_failed",
    "batch.item_requeued",
    "batch.worker_crashes",
    "batch.store_torn_tail",
    "batch.job_swept",
))


def _walk_confidences(node: Any, out: List[float]) -> None:
    if isinstance(node, dict):
        for v in node.values():
            _walk_confidences(v, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _walk_confidences(v, out)
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        out.append(float(node))


def confidence_histogram(likelihoods: Any, bins: int = 10) -> Dict[str, Any]:
    """Histogram + summary stats over every confidence in a likelihoods tree."""
    values: List[float] = []
    _walk_confidences(likelihoods, values)
    if not values:
        return {"count": 0, "histogram": [0] * bins, "mean": None, "min": None}
    counts = [0] * bins
    for v in values:
        idx = min(int(max(0.0, min(1.0, v)) * bins), bins - 1)
        counts[idx] += 1
    return {
        "count": len(values),
        "histogram": counts,
        "mean": round(sum(values) / len(values), 5),
        "min": round(min(values), 5),
    }
