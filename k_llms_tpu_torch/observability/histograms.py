"""Thread-safe log-bucketed latency histograms with declared vocabularies.

Same hygiene contract as ``EventCounters``: ``declared`` names the group's
histogram vocabulary (literals plus fnmatch wildcards), ``observe()`` raises
on anything outside it, and the ``counter-hygiene`` lint statically checks
every ``observe()`` literal against the same patterns — a typo'd histogram
that silently lands in its own family is invisible to every dashboard that
queries the real name.

Buckets are log-spaced seconds shared across families (1ms → 60s), rendered
on ``/metrics`` in Prometheus histogram exposition (cumulative ``_bucket``
counts, ``_sum``, ``_count``). Exactly-declared families export even at zero
observations, so the scrape surface is stable from the first poll.
"""

from __future__ import annotations

import bisect
import fnmatch
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analysis.lockcheck import make_lock

#: Log-spaced bucket upper bounds in seconds (1-2.5-5 decades, 1ms → 60s).
#: The +Inf bucket is implicit: its cumulative count is the sample count.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class LatencyHistograms:
    """A group of named latency histograms sharing one bucket layout.

    ``observe(name, seconds)`` is cheap enough for the scheduler worker and
    the continuous loop's host bookkeeping (a bisect + three dict writes
    under a leaf lock); ``snapshot()`` returns cumulative bucket counts
    ready for Prometheus exposition."""

    def __init__(
        self,
        declared: Optional[Sequence[str]] = None,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or any(b <= 0 for b in bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be distinct positive bounds")
        self._lock = make_lock("observability.histograms")
        self.buckets = bounds
        self.declared: Tuple[str, ...] = tuple(declared or ())
        self._exact = {p for p in self.declared if "*" not in p and "?" not in p}
        self._globs = [p for p in self.declared if p not in self._exact]
        # Exact families pre-exist so /metrics exports them at zero samples.
        self._counts: Dict[str, List[int]] = {
            name: [0] * len(bounds) for name in sorted(self._exact)
        }
        self._sums: Dict[str, float] = {}
        self._totals: Dict[str, int] = {}

    def _check_declared(self, name: str) -> None:
        if not self.declared or name in self._exact:
            return
        if any(fnmatch.fnmatch(name, p) for p in self._globs):
            return
        raise ValueError(
            f"histogram {name!r} is not declared for this group "
            f"(declared: {sorted(self.declared)})"
        )

    def observe(self, name: str, seconds: float) -> None:
        self._check_declared(name)
        v = max(0.0, float(seconds))
        with self._lock:
            counts = self._counts.get(name)
            if counts is None:
                counts = self._counts[name] = [0] * len(self.buckets)
            i = bisect.bisect_left(self.buckets, v)
            if i < len(counts):
                counts[i] += 1
            self._sums[name] = self._sums.get(name, 0.0) + v
            self._totals[name] = self._totals.get(name, 0) + 1

    def count(self, name: str) -> int:
        with self._lock:
            return self._totals.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-family ``{"buckets": [(le, cumulative_count)...], "sum": s,
        "count": c}`` — bucket counts already cumulative and monotone; the
        +Inf bucket is ``count``."""
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for name in sorted(self._counts):
                cum: List[Tuple[float, int]] = []
                acc = 0
                for bound, c in zip(self.buckets, self._counts[name]):
                    acc += c
                    cum.append((bound, acc))
                out[name] = {
                    "buckets": cum,
                    "sum": self._sums.get(name, 0.0),
                    "count": self._totals.get(name, 0),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            for counts in self._counts.values():
                for i in range(len(counts)):
                    counts[i] = 0
            self._sums.clear()
            self._totals.clear()


#: Process-wide latency histograms for the serving stack, surfaced on
#: ``/metrics`` as ``kllms_<family>_seconds`` (dots become underscores):
#: request.e2e — full request wall time, observed when a trace finishes;
#: request.ttft — time to first streamed token, observed at the first delta
#: a ChatCompletionStream emits; scheduler.queue_wait — admission-to-dequeue
#: wait, observed at both the coalescing scheduler's group pop and the
#: continuous loop's slot admission; continuous.step — one continuous-loop
#: step's host wall time around the (possibly watchdogged) device dispatch;
#: engine.decode_launch — one coalesced decode launch (the paged-attention
#: fused path included), observed around the supervised generate_many call;
#: consensus.consolidate — consensus consolidation wall time. All observes
#: are host-side wall clock — never inside jitted step programs.
#:
#: The ``.*`` wildcard families are the per-tenant label sets:
#: ``request.e2e.<tenant>`` / ``request.ttft.<tenant>`` /
#: ``scheduler.queue_wait.<tenant>`` record the same observation a second
#: time under the request's tenant, and ``/metrics`` renders them as one
#: labeled family per base name (``kllms_request_e2e_by_tenant_seconds``
#: with a ``tenant`` label) so per-tenant SLO compliance is scrapeable
#: without pre-registering tenant names.
#: The batch-lane families: ``batch.item`` — one offline item's
#: end-to-end wall time through the lane (dequeue → committed output
#: segment); ``batch.job_e2e`` — a whole job from durable submission to
#: terminal status, wall clock, spanning restarts (the journal carries
#: ``created_at``).
#: The chunked-prefill family: ``continuous.prefill_chunk`` — one
#: interleaved prompt-chunk dispatch's host wall time (device step + paged
#: scatter + sync), observed per chunk by the continuous loop; compare its
#: max against ``continuous.step`` p50 to verify long admissions no longer
#: stall in-flight decode rows.
LATENCY = LatencyHistograms(declared=(
    "request.e2e",
    "request.ttft",
    "scheduler.queue_wait",
    "continuous.step",
    "continuous.prefill_chunk",
    "engine.decode_launch",
    "consensus.consolidate",
    "batch.item",
    "batch.job_e2e",
    "request.e2e.*",
    "request.ttft.*",
    "scheduler.queue_wait.*",
))
