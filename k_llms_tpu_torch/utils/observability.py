"""Event counters and the latency histograms: the pieces of the JAX
package's observability module that the port's copied host layers call.
Consolidation records ``consensus.zero_survivors``; the grammar compiler
records the ``GRAMMAR_EVENTS`` family; the checkpoint loader counts rejected
loads in ``QUARANTINE_EVENTS``; the scheduler, supervisor, retry policy,
tenancy and replica set record the failure, recovery, tenant, route, hedge
and failover families under the JAX package's declared names; the paged
attention resolver counts its dispatches and drilled fallbacks in
``KERNEL_EVENTS``; the device consensus scorer counts its dispatches and
fallbacks in ``CONSENSUS_EVENTS``. Request tracing is not ported yet, so
:func:`current_trace` returns None and the scheduler attributes no spans.
The port's kernels keep their own launch counts on their wrappers
(``ops/_ext.py``)."""

from __future__ import annotations

import fnmatch
from typing import Dict, Optional, Sequence, Tuple

from ..observability import LATENCY, LatencyHistograms  # noqa: F401  (re-exported)
from .locks import make_lock


def current_trace() -> None:
    """The request trace of the calling context: always None until the
    tracer is ported."""
    return None


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

#: Speculative-decoding counters; the scheduler's ``note_spec_stats`` has no
#: caller until speculative decoding is ported.
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
