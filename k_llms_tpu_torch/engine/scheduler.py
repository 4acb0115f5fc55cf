"""Request scheduler: a coalescing queue in front of the device mesh.

The reference's async client just multiplexes HTTP (SURVEY.md §3.3); a local
engine owns actual hardware, so concurrent callers need ordering: one worker
thread drains a FIFO queue and runs device work serially (the chip is serial
anyway — interleaving jit dispatches from many threads only causes duplicate
compiles and contention).

Cross-request batching (the local answer to the reference's 5-async-worker
concurrency baseline, `README_TESTS.md:214`): work submitted via
``submit_batched`` carries a compatibility key; when the worker dequeues such
an item it drains the CONTIGUOUS run of queued items with the same key and
hands them to one batch runner — e.g. ``LocalEngine.generate_many`` decoding
several requests in a single XLA program.

Coalescing is opportunistic PLUS a short admission window: after dequeuing a
batched item the worker waits up to ``batch_window`` (default 5 ms) for more
same-key arrivals before launching. Without the window, the first request of
a concurrent burst always decodes solo (the queue is empty the instant it
lands) and only the stragglers fuse; with it, a 5-client race fuses into one
program. The window costs a genuinely-solo request ~5 ms on a ~1 s decode
(<1%) and applies only to batchable work — plain ``submit`` closures run
immediately.

Overload protection: the queue is optionally *bounded by weight*
(``max_queue_weight``) — weight being the same device-row cost used for the
coalescing bound, so the cap tracks HBM pressure rather than request count.
Work that would push the queue past the cap is shed at admission with a typed
429 (:class:`~k_llms_tpu_torch.types.wire.RateLimitError`) whose ``retry_after`` is
derived from the measured drain rate, unless a strictly-lower-priority queued
item can be evicted in its place. The scheduler also owns the process
lifecycle: a :class:`ServerState`, a ``health()`` snapshot, and
``drain(timeout)`` which closes admission (typed 503), finishes in-flight
groups, and joins the worker. Device OOM feedback arrives via ``note_oom()``
(halves the effective coalescing width) / ``note_recovered()`` (restores it).

Multi-tenancy: the single FIFO is now a set of per-tenant FIFO
queues drained by weighted-fair queuing — each tenant carries a virtual-time
pass that advances by ``group_weight / tenant_weight`` when its group
launches, and the worker always serves the backlogged tenant with the
smallest ``(slo_class, vpass)`` key, so ``interactive`` work strictly
precedes ``batch`` and equal-weight tenants split device rows evenly no
matter how unequal their offered load. Coalescing never crosses a tenant
boundary. Quotas are charged via :meth:`EngineScheduler.charge_tenant_quota`
(per-tenant token buckets: requests/s and device-row weight/s) whose typed
429 carries the *tenant's own* bucket-refill ``retry_after``; the
``scheduler.tenant`` failpoint (keyed by tenant name, ``exhaust`` action)
forces a miss for drills. Under brownout — queue weight at its high-water
mark or repeated OOM backoff — ``batch``-class admissions are shed first,
and capacity eviction prefers batch-class, then over-quota, then
strictly-lower-priority victims, so in-SLO interactive work is touched last.
Everything is attributed per tenant (``TENANT_EVENTS``,
``scheduler.queue_wait.<tenant>`` histograms, per-tenant health section).
The default (tenancy-less) configuration resolves every request to one
unlimited interactive tenant, preserving pre-tenancy behavior exactly.

Callers get ``concurrent.futures.Future``s; ``AsyncKLLMs`` awaits them without
blocking the event loop. Queue depth and service counts are exposed for
observability.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.lockcheck import make_condition, race_exempt
from ..reliability import failpoints as _failpoints
from ..reliability.deadline import RequestBudget
from ..reliability.tenancy import TenancyConfig, TenantContext
from ..types.wire import BackendUnavailableError, RateLimitError, ServerDrainingError
from ..utils.observability import (
    FAILURE_EVENTS,
    LATENCY,
    SPEC_EVENTS,
    TENANT_EVENTS,
    current_trace,
)

logger = logging.getLogger(__name__)


def _next_pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


class ServerState(str, enum.Enum):
    """Lifecycle of a serving scheduler. Owned by the scheduler because the
    scheduler is the single choke point every request passes through — state
    transitions and admission decisions share one lock.

    STARTING  worker thread not yet running (transient, microseconds).
    READY     serving normally.
    DEGRADED  serving, but a device OOM forced the coalescing width down;
              clears back to READY once launches succeed at full width.
    RECOVERING  the supervisor is rebuilding a hung/poisoned engine; admission
              stays OPEN (work queues behind the rebuild and is replayed on
              the fresh engine) — callers see latency, not rejections.
    DRAINING  admission closed (503); in-flight + queued work finishing.
    STOPPED   worker joined; all submission rejected.
    """

    STARTING = "starting"
    READY = "ready"
    DEGRADED = "degraded"
    RECOVERING = "recovering"
    DRAINING = "draining"
    STOPPED = "stopped"


class _Item:
    __slots__ = (
        "future",
        "fn",
        "batch_key",
        "payload",
        "batch_fn",
        "weight",
        "window",
        "budget",
        "priority",
        "max_rows",
        "tenant",
        "trace",
        "trace_phase",
        "enqueued_at",
    )

    def __init__(
        self,
        future,
        fn=None,
        batch_key=None,
        payload=None,
        batch_fn=None,
        weight=1,
        window=None,
        budget=None,
        priority=0,
        max_rows=None,
        tenant=None,
        trace_phase=None,
    ):
        self.future = future
        self.fn = fn
        self.batch_key = batch_key
        self.payload = payload
        self.batch_fn = batch_fn
        self.weight = weight
        self.window = window
        self.budget = budget
        self.priority = priority
        self.max_rows = max_rows
        # Resolved to a TenantContext by _admit (None until then).
        self.tenant = tenant
        # Captured on the submitting thread: the worker is a plain Thread and
        # does not inherit contextvars, so the request trace must ride the
        # item. ``trace_phase`` names the span the group's runner duration is
        # attributed to (None for opaque closures — their inner device work
        # traces itself).
        self.trace = current_trace()
        self.trace_phase = trace_phase
        self.enqueued_at = time.monotonic()


class _TenantQueue:
    """One tenant's FIFO plus its WFQ virtual-time pass (guarded by the
    scheduler's condition variable, like the rest of the queue state)."""

    __slots__ = ("ctx", "items", "vpass")

    def __init__(self, ctx: TenantContext):
        self.ctx = ctx
        self.items: "deque[_Item]" = deque()
        self.vpass = 0.0


# Rolling window (seconds) over which the drain rate backing ``retry_after``
# estimates is measured. Long enough to smooth over one multi-second decode,
# short enough to track a load shift.
_DRAIN_WINDOW_S = 30.0

# Brownout triggers: queued weight at this fraction of ``max_queue_weight``,
# or the OOM width backoff at/past this many halvings. Either signals
# sustained overload, and batch-class admission sheds until it clears.
_BROWNOUT_HIGH_WATER = 0.9
_BROWNOUT_WIDTH_SHIFT = 2


class EngineScheduler:
    """Serializes closures onto one worker thread; thread-safe submit; queued
    same-key batched submissions coalesce into one runner call.

    ``max_batch`` caps the number of coalesced requests; ``max_rows`` caps the
    projected device batch. Coalesced decode pads every member to the group's
    max weight (rows are equal-size request groups), so the projected cost of
    a group is ``len(group) * max(weight)`` — a group stops growing once
    admitting the next item would push that product past ``max_rows``. This
    bounds HBM: five queued n=32 consensus requests do NOT fuse into one
    160-row decode.

    ``max_queue_weight`` (None = unbounded, the pre-PR-2 behavior) bounds the
    total weight of *queued* work; see the module docstring for the shedding
    contract."""

    def __init__(
        self,
        name: str = "engine",
        max_batch: int = 8,
        max_rows: int = 64,
        batch_window: float = 0.005,
        max_queue_weight: Optional[int] = None,
        tenancy: Optional[TenancyConfig] = None,
        brownout_high_water: float = _BROWNOUT_HIGH_WATER,
    ):
        # Per-tenant FIFO queues drained by WFQ; insertion-ordered so
        # selection ties break toward the longest-known tenant.
        self._queues: Dict[str, _TenantQueue] = {}
        # WFQ floor: the start-pass of the most recently launched group.
        # Charging new groups from max(tenant pass, floor) stops an idle
        # tenant from banking unbounded credit while others were served.
        self._vfloor = 0.0
        # shutdown()/drain() signal; replaces the old in-deque None sentinel
        # (a single FIFO position is meaningless across per-tenant queues).
        # Same contract: the backlog present at the signal is served first.
        self._sentinel = False
        self._tenancy = tenancy if tenancy is not None else TenancyConfig()
        self._brownout_high_water = brownout_high_water
        # Per-tenant shed/served attribution for health() (guarded by _cv).
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        self._cv = make_condition("engine.scheduler")
        self._served = 0
        self._errors = 0
        self._batches = 0
        self._coalesced = 0
        self._shed = 0
        self._shed_over_capacity = 0
        self._shed_brownout = 0
        self._shed_quota = 0
        self._evicted = 0
        self._oom_splits = 0
        # Speculative-decoding aggregates (engine.on_spec_stats): per-launch
        # drafted/accepted counts plus the most recent acceptance rate.
        self._spec_launches = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_tpi_last: Optional[float] = None
        # Self-healing aggregates (EngineSupervisor hooks): completed+attempted
        # engine rebuilds, the in-progress attempt number (0 when healthy),
        # and decode rows quarantined for numeric poison.
        self._recoveries = 0
        self._recovery_attempt = 0
        self._last_recovery_reason: Optional[str] = None
        self._quarantined = 0
        # Replica-set aggregates (ReplicaSet hooks): launches routed to this
        # member, failovers it absorbed for a sick sibling, and hedge
        # launches/wins it served.
        self._routed = 0
        self._failovers = 0
        self._hedges = 0
        self._hedges_won = 0
        # On-device consensus: set by the owning backend to a zero-arg callable
        # returning cache/dispatch stats; surfaced in stats/health so operators
        # see consensus cache behaviour next to queue depth.
        self.consensus_stats_provider: Optional[Callable[[], Dict[str, Any]]] = None
        self._queue_weight = 0
        self._in_flight = 0
        self._state = ServerState.STARTING
        # Adaptive-width backoff: effective row cap is max_rows >> _width_shift.
        # _effective_max_rows reads it lock-free (see its inline suppression);
        # the runtime exemption mirrors that decision for the sanitizer.
        self._width_shift = 0
        race_exempt(self, "_width_shift")
        self._ok_since_backoff = 0
        # (monotonic_time, weight) samples of recently completed work, for the
        # drain-rate estimate behind RateLimitError.retry_after.
        self._drained: "deque[Tuple[float, int]]" = deque()
        self.max_batch = max_batch
        self.max_rows = max_rows
        self.batch_window = batch_window
        self.max_queue_weight = max_queue_weight
        self._worker = threading.Thread(
            target=self._run, name=f"kllms-{name}-worker", daemon=True
        )
        self._worker.start()

    # -- tenant queue bookkeeping (caller holds self._cv) ------------------
    def _queue_for_locked(self, ctx: TenantContext) -> _TenantQueue:
        q = self._queues.get(ctx.name)
        if q is None:
            q = self._queues[ctx.name] = _TenantQueue(ctx)
        return q

    def _backlog_locked(self) -> int:
        return sum(len(q.items) for q in self._queues.values())

    def _all_items_locked(self) -> List[_Item]:
        out: List[_Item] = []
        for q in self._queues.values():
            out.extend(q.items)
        return out

    def _clear_queues_locked(self) -> List[_Item]:
        leftovers = self._all_items_locked()
        for q in self._queues.values():
            q.items.clear()
        self._queue_weight = 0
        return leftovers

    def _select_queue_locked(self) -> Optional[_TenantQueue]:
        """The backlogged tenant queue with the smallest (slo_class, vpass)
        key — interactive strictly before batch, then weighted virtual time.
        None when nothing is queued."""
        best: Optional[_TenantQueue] = None
        best_key: Optional[Tuple[int, float]] = None
        for q in self._queues.values():
            if not q.items:
                continue
            key = (0 if q.ctx.interactive else 1, q.vpass)
            if best_key is None or key < best_key:
                best, best_key = q, key
        return best

    def _charge_pass_locked(self, q: _TenantQueue, group_weight: int) -> None:
        """Advance the tenant's virtual time by the launched group's weight
        over its configured share. The floor keeps a tenant that just went
        idle from re-entering arbitrarily far in the past."""
        start = max(q.vpass, self._vfloor)
        self._vfloor = start
        q.vpass = start + group_weight / max(q.ctx.weight, 1e-9)

    def _tenant_count_locked(self, ctx: Optional[TenantContext], key: str, n: int = 1) -> None:
        if ctx is None:
            return
        stats = self._tenant_stats.setdefault(ctx.name, {})
        stats[key] = stats.get(key, 0) + n

    def _brownout_locked(self) -> bool:
        """Sustained-overload signal: queued weight at the high-water mark of
        the cap, or the OOM width backoff deep enough that the device is
        repeatedly refusing full-width launches."""
        if self._width_shift >= _BROWNOUT_WIDTH_SHIFT:
            return True
        return (
            self.max_queue_weight is not None
            and self._queue_weight
            >= self._brownout_high_water * self.max_queue_weight
        )

    @property
    def tenancy(self) -> TenancyConfig:
        return self._tenancy

    # -- adaptive width ----------------------------------------------------
    def _effective_max_rows(self) -> int:
        """Row cap after OOM backoff (caller holds no lock; reads are atomic
        enough for an admission heuristic)."""
        # kllms: ignore[guarded-by] — atomic int read; admission heuristic only
        return max(1, self.max_rows >> self._width_shift)

    def note_oom(self) -> None:
        """Device OOM observed on a batch launch: halve the coalescing width
        so subsequent groups fuse less aggressively, and mark DEGRADED. Safe
        to call from the worker thread (the engine's OOM guard) or elsewhere."""
        with self._cv:
            self._oom_splits += 1
            if (self.max_rows >> self._width_shift) > 1:
                self._width_shift += 1
            self._ok_since_backoff = 0
            if self._state is ServerState.READY:
                self._state = ServerState.DEGRADED
        logger.warning(
            "scheduler: device OOM — coalescing width backed off to %d rows",
            self._effective_max_rows(),
        )

    def note_recovered(self) -> None:
        """A batch launch succeeded. After a few consecutive successes, step
        the width back up; once fully restored, DEGRADED clears to READY."""
        with self._cv:
            if self._width_shift == 0:
                return
            self._ok_since_backoff += 1
            if self._ok_since_backoff >= 3:
                self._width_shift -= 1
                self._ok_since_backoff = 0
                if self._width_shift == 0 and self._state is ServerState.DEGRADED:
                    self._state = ServerState.READY

    def note_spec_stats(self, stats: Dict[str, Any]) -> None:
        """One speculative launch completed (engine.on_spec_stats hook):
        fold its drafted/accepted accounting into the serving-path aggregates
        and the process-wide observability counters."""
        drafted = int(stats.get("drafted") or 0)
        accepted = int(stats.get("accepted") or 0)
        tpi = stats.get("tokens_per_iteration")
        with self._cv:
            self._spec_launches += 1
            self._spec_drafted += drafted
            self._spec_accepted += accepted
            if tpi is not None:
                self._spec_tpi_last = float(tpi)
        SPEC_EVENTS.record("spec.launches")
        if drafted:
            SPEC_EVENTS.record("spec.drafted", drafted)
        if accepted:
            SPEC_EVENTS.record("spec.accepted", accepted)

    # -- self-healing (EngineSupervisor hooks) -----------------------------
    def note_recovering(self, attempt: int, reason: str) -> None:
        """The supervisor is tearing down and rebuilding the engine (attempt
        N, bounded). Runs on the worker thread mid-launch; admission stays
        open — queued work is served by the rebuilt engine."""
        with self._cv:
            self._recoveries += 1
            self._recovery_attempt = attempt
            self._last_recovery_reason = reason
            if self._state in (ServerState.READY, ServerState.DEGRADED):
                self._state = ServerState.RECOVERING
        logger.warning(
            "scheduler: engine RECOVERING (rebuild attempt %d, reason=%s)",
            attempt,
            reason,
        )

    def note_rebuilt(self) -> None:
        """Engine rebuild succeeded; resume serving. Width backoff survives
        the rebuild deliberately — an OOM-prone workload is still OOM-prone
        on a fresh engine."""
        with self._cv:
            self._recovery_attempt = 0
            if self._state is ServerState.RECOVERING:
                self._state = (
                    ServerState.DEGRADED if self._width_shift else ServerState.READY
                )

    def note_rebuild_failed(self, error: BaseException) -> None:
        """Rebuild attempts exhausted (or the checkpoint reload failed):
        terminal. Close admission and fail all queued work with a typed 503.
        Runs on the worker thread, so no join here — the worker retires on
        its own once it observes STOPPED with an empty queue."""
        with self._cv:
            self._state = ServerState.STOPPED
            leftovers = self._clear_queues_locked()
            self._shed += len(leftovers)
            self._cv.notify_all()
        # Futures complete outside the lock (callbacks may re-enter).
        for it in leftovers:
            if not it.future.done():
                it.future.set_exception(
                    BackendUnavailableError(
                        f"engine stopped after exhausting rebuild attempts: {error}"
                    )
                )
        if leftovers:
            FAILURE_EVENTS.record("scheduler.shed_stopped", len(leftovers))
        logger.error("scheduler: engine rebuild failed terminally: %s", error)

    def note_quarantine(self, n: int) -> None:
        """``n`` decode rows were quarantined for numeric poison (engine's
        ``on_quarantine`` hook, forwarded by the backend)."""
        if n <= 0:
            return
        with self._cv:
            self._quarantined += n

    # -- replica routing (ReplicaSet hooks) --------------------------------
    def note_routed(self) -> None:
        """A ReplicaSet routed a launch to this member (primary dispatch)."""
        with self._cv:
            self._routed += 1

    def note_failover(self) -> None:
        """This member absorbed a mid-flight failover from a sick sibling."""
        with self._cv:
            self._failovers += 1

    def note_hedge(self, won: bool = False) -> None:
        """A hedged duplicate launched on this member; ``won=True`` records
        separately that the hedge finished first (tail rescue)."""
        with self._cv:
            if won:
                self._hedges_won += 1
            else:
                self._hedges += 1

    # -- worker -----------------------------------------------------------
    def _next_group(self) -> Optional[List[_Item]]:
        """Blocks for the next unit of work: a single closure item, or the
        contiguous head run of batched items sharing one batch_key *within
        the WFQ-selected tenant's queue* — held open for up to
        ``batch_window`` seconds while that queue has no blocking
        (different-key / over-budget / shutdown) item at its head. Coalescing
        never reaches into another tenant's queue: cross-tenant fusion would
        let a flooding tenant ride a well-behaved tenant's launches."""
        with self._cv:
            while True:
                q = self._select_queue_locked()
                if q is not None:
                    break
                if self._sentinel or self._state in (
                    ServerState.DRAINING,
                    ServerState.STOPPED,
                ):
                    # Shutdown signal or draining/stopped with an empty
                    # backlog: nothing more can arrive, the worker retires.
                    return None
                self._cv.wait()
            head = q.items.popleft()
            self._queue_weight -= head.weight
            if head.batch_key is None:
                self._in_flight += 1
                self._charge_pass_locked(q, head.weight)
                return [head]
            group = [head]
            max_w = head.weight
            # Row cap for THIS group: global knob, OOM backoff, and any
            # per-item HBM hint from the backend's memory model. Hints of
            # later-admitted members tighten the cap mid-coalesce.
            cap = min(
                self.max_rows >> self._width_shift,
                head.max_rows if head.max_rows is not None else self.max_rows,
            )
            cap = max(1, cap)
            window = self.batch_window if head.window is None else head.window
            # The admission window must never outlive the tightest deadline in
            # the group: a member with 3 ms of budget left cannot afford a 5 ms
            # coalescing wait.
            if head.budget is not None:
                window = min(window, max(0.0, head.budget.remaining()))
            deadline = time.monotonic() + window
            while len(group) < self.max_batch:
                if q.items:
                    nxt = q.items[0]
                    if nxt.max_rows is not None:
                        cap = max(1, min(cap, nxt.max_rows))
                    if (
                        nxt.batch_key != head.batch_key
                        # Conservative projected cost: the decode pads the
                        # request count to a power of two (generate_many's
                        # compile bucketing), so admit against
                        # next_pow2(len+1) * max weight. Callers pass weights
                        # already rounded to their device-batch granularity.
                        or _next_pow2(len(group) + 1) * max(max_w, nxt.weight) > cap
                    ):
                        break  # FIFO fairness: never reach around the head
                    q.items.popleft()
                    self._queue_weight -= nxt.weight
                    max_w = max(max_w, nxt.weight)
                    group.append(nxt)
                    if nxt.budget is not None:
                        deadline = min(deadline, nxt.budget.deadline.at)
                    continue
                if _next_pow2(len(group) + 1) * max_w > cap:
                    break  # even a weight-1 arrival couldn't be admitted
                if self._sentinel or self._state is ServerState.DRAINING:
                    break  # nothing new can arrive; launch what we have
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            self._in_flight += 1
            self._charge_pass_locked(q, sum(it.weight for it in group))
            return group

    def _shed_spent(self, items: List[_Item]) -> List[_Item]:
        """Drop items whose budget expired or was cancelled while queued:
        their futures get the typed lifecycle error and they never reach the
        device. Shedding at dequeue (not just submit) matters because a request
        can expire while waiting behind a long decode."""
        live: List[_Item] = []
        shed = 0
        for it in items:
            if it.budget is not None and it.budget.should_abort():
                shed += 1
                if not it.future.done():
                    it.future.set_exception(it.budget.error("scheduler queue"))
                continue
            live.append(it)
        if shed:
            with self._cv:
                self._shed += shed
            FAILURE_EVENTS.record("scheduler.shed", shed)
        return live

    def _record_drained(self, weight: int) -> None:
        """Caller holds self._cv. Feeds the rolling drain-rate window."""
        now = time.monotonic()
        self._drained.append((now, weight))
        horizon = now - _DRAIN_WINDOW_S
        while self._drained and self._drained[0][0] < horizon:
            self._drained.popleft()

    def _group_done(
        self, group: List[_Item], served: int, errors: int, drained_weight: int
    ) -> None:
        """``drained_weight`` is the weight that actually reached the runner:
        work shed at dequeue must NOT feed the drain-rate window, or
        ``retry_after`` under-reports exactly when brownout is shedding the
        most (a shed is instantaneous, not evidence of service capacity)."""
        with self._cv:
            self._in_flight -= 1
            self._served += served
            self._errors += errors
            if drained_weight:
                self._record_drained(drained_weight)
            if served and group[0].batch_key is not None:
                self._batches += 1
                self._coalesced += served - 1
            # drain() waits on queue-empty AND in-flight-zero.
            self._cv.notify_all()

    def _run(self) -> None:
        with self._cv:
            if self._state is ServerState.STARTING:
                self._state = ServerState.READY
            self._cv.notify_all()
        while True:
            group = self._next_group()
            if group is None:
                return
            live = [it for it in group if it.future.set_running_or_notify_cancel()]
            live = self._shed_spent(live)
            # Only weight that reaches the runner counts toward the drain
            # rate; shed/cancelled weight vanished without consuming service.
            live_weight = sum(it.weight for it in live)
            if not live:
                self._group_done(group, served=0, errors=0, drained_weight=0)
                continue
            # Admission-to-dequeue wait, observed here (outside self._cv —
            # trace/histogram locks are leaves, never nested under the CV).
            now = time.monotonic()
            for it in live:
                wait_s = max(0.0, now - it.enqueued_at)
                LATENCY.observe("scheduler.queue_wait", wait_s)
                if it.tenant is not None:
                    LATENCY.observe(
                        f"scheduler.queue_wait.{it.tenant.name}", wait_s
                    )
                if it.trace is not None:
                    it.trace.add_phase("queue_wait", wait_s)
            try:
                if live[0].batch_key is None:
                    live[0].future.set_result(live[0].fn())
                else:
                    t0 = time.perf_counter()
                    results = live[0].batch_fn([it.payload for it in live])
                    launch_s = time.perf_counter() - t0
                    # Per-launch attribution: every coalesced member shared
                    # this device launch, so each trace gets the full span.
                    for it in live:
                        if it.trace is not None and it.trace_phase:
                            it.trace.add_phase(it.trace_phase, launch_s)
                    if len(results) != len(live):  # pragma: no cover - runner bug
                        raise RuntimeError(
                            f"batch runner returned {len(results)} results "
                            f"for {len(live)} requests"
                        )
                    # A runner may fail individual members of a coalesced batch
                    # (deadline hit mid-decode, injected sample kill) without
                    # poisoning the whole group: exception instances in the
                    # results list are delivered to just that member's caller.
                    n_failed = 0
                    for it, res in zip(live, results):
                        if isinstance(res, BaseException):
                            n_failed += 1
                            it.future.set_exception(res)
                        else:
                            it.future.set_result(res)
                    self._note_served(live)
                    self._group_done(
                        group,
                        served=len(live),
                        errors=n_failed,
                        drained_weight=live_weight,
                    )
                    continue
                self._note_served(live)
                self._group_done(
                    group, served=len(live), errors=0, drained_weight=live_weight
                )
            except BaseException as e:  # deliver to the caller(s), keep serving
                for it in live:
                    if not it.future.done():
                        it.future.set_exception(e)
                self._group_done(
                    group, served=0, errors=len(live), drained_weight=live_weight
                )

    def _note_served(self, live: List[_Item]) -> None:
        """Per-tenant service attribution (TENANT_EVENTS + health section)."""
        with self._cv:
            for it in live:
                self._tenant_count_locked(it.tenant, "served")
        for it in live:
            if it.tenant is not None:
                TENANT_EVENTS.record(f"tenant.served.{it.tenant.name}")

    # -- admission --------------------------------------------------------
    def _drain_rate(self) -> float:
        """Weight served per second over the rolling window (caller holds
        self._cv). Falls back to 0.0 when there is no history."""
        if len(self._drained) < 2:
            return 0.0
        span = self._drained[-1][0] - self._drained[0][0]
        if span <= 0:
            return 0.0
        return sum(w for _, w in self._drained) / span

    def _retry_after(self, weight: int) -> float:
        """Seconds until queued weight should have drained enough to admit
        ``weight`` more (caller holds self._cv). Clamped to [0.1, 60]. This
        is the *global* capacity estimate (drain window excludes shed work);
        quota rejections use the tenant's own bucket refill time instead —
        see :meth:`charge_tenant_quota`."""
        rate = self._drain_rate()
        backlog = self._queue_weight + weight
        est = backlog / rate if rate > 0 else 1.0
        return min(60.0, max(0.1, est))

    def _try_evict_for(
        self, weight: int, priority: int, tenant: Optional[TenantContext] = None
    ) -> List[_Item]:
        """Caller holds self._cv. Frees capacity for an incoming item by
        evicting queued items in brownout order — (1) batch-class work when
        the incoming item is interactive, (2) work from currently over-quota
        tenants, (3) strictly-lower-priority items (higher ``priority`` int =
        less important) — each tier scanning from the back of its candidates
        (newest, least sunk wait first). In-SLO interactive work is only ever
        displaced by the pre-tenancy priority rule, so single-tenant
        deployments see exactly the old behavior. Returns the evicted items —
        their futures must be failed AFTER the lock is released (Future
        callbacks run inline) — or [] if enough capacity cannot be freed."""
        assert self.max_queue_weight is not None
        need = self._queue_weight + weight - self.max_queue_weight
        incoming_interactive = tenant is None or tenant.interactive
        queued = self._all_items_locked()
        chosen: List[_Item] = []
        seen = set()
        freed = 0

        def take(candidates: List[_Item]) -> bool:
            nonlocal freed
            for it in reversed(candidates):
                if id(it) in seen:
                    continue
                seen.add(id(it))
                chosen.append(it)
                freed += it.weight
                if freed >= need:
                    return True
            return False

        done = False
        if incoming_interactive:
            done = take(
                [it for it in queued if it.tenant is not None and not it.tenant.interactive]
            )
        if not done:
            done = take(
                [
                    it
                    for it in queued
                    if it.tenant is not None
                    and (tenant is None or it.tenant.name != tenant.name)
                    and it.tenant.over_quota()
                ]
            )
        if not done:
            done = take([it for it in queued if it.priority > priority])
        if freed < need:
            return []
        for v in chosen:
            q = self._queues.get(v.tenant.name) if v.tenant is not None else None
            if q is not None and v in q.items:
                q.items.remove(v)
                self._queue_weight -= v.weight
        return chosen

    def admission_error(self) -> Optional[BaseException]:
        """Lifecycle-state admission gate as a typed error, or None while the
        server accepts work. Shared by ``_admit`` and request paths that
        bypass the coalescing queue (the continuous decode loop), so
        DRAINING/STOPPED produce identical wire errors everywhere."""
        with self._cv:
            if self._state is ServerState.STOPPED:
                return BackendUnavailableError(
                    "scheduler is stopped; no further work is accepted"
                )
            if self._state is ServerState.DRAINING:
                return ServerDrainingError(
                    "server is draining; retry against another replica"
                )
        return None

    def _admit(self, item: _Item) -> bool:
        """Admission control, atomic with the queue append: lifecycle state
        gate (DRAINING/STOPPED → typed 503), spent-budget rejection, the
        brownout gate (batch-class work shed under sustained overload), and
        the ``max_queue_weight`` capacity check with tiered eviction.
        Also hosts the ``scheduler.admit`` failpoint. Returns False when the
        item was rejected (its future already carries the typed error)."""
        future = item.future
        _failpoints.fire("scheduler.admit")
        if item.tenant is None or not isinstance(item.tenant, TenantContext):
            item.tenant = self._tenancy.resolve(item.tenant)
        if item.budget is not None and item.budget.should_abort():
            with self._cv:
                self._shed += 1
            FAILURE_EVENTS.record("scheduler.shed")
            future.set_exception(item.budget.error("scheduler admission"))
            return False
        evicted: List[_Item] = []
        rejection: Optional[BaseException] = None
        brownout_shed = False
        with self._cv:
            if self._state is ServerState.STOPPED:
                rejection = BackendUnavailableError(
                    "scheduler is stopped; no further work is accepted"
                )
            elif self._state is ServerState.DRAINING:
                rejection = ServerDrainingError(
                    "server is draining; retry against another replica"
                )
            elif not item.tenant.interactive and self._brownout_locked():
                # Brownout: batch-class tenants are shed before any capacity
                # arithmetic — their retry hint is their own refill horizon
                # (or the global drain estimate when unlimited), never the
                # interactive backlog's.
                brownout_shed = True
                horizon = item.tenant.refill_horizon(item.weight)
                rejection = RateLimitError(
                    f"brownout: batch-class tenant {item.tenant.name!r} shed "
                    f"under sustained overload (queue weight "
                    f"{self._queue_weight}/{self.max_queue_weight})",
                    retry_after=min(
                        60.0,
                        max(0.1, horizon or self._retry_after(item.weight)),
                    ),
                )
            elif (
                self.max_queue_weight is not None
                and self._queue_weight + item.weight > self.max_queue_weight
            ):
                evicted = self._try_evict_for(
                    item.weight, item.priority, item.tenant
                )
                if not evicted and (
                    self._queue_weight + item.weight > self.max_queue_weight
                ):
                    rejection = RateLimitError(
                        f"queue at capacity (weight {self._queue_weight}/"
                        f"{self.max_queue_weight}); request weight "
                        f"{item.weight} rejected",
                        retry_after=self._retry_after(item.weight),
                    )
            if rejection is None:
                self._queue_for_locked(item.tenant).items.append(item)
                self._queue_weight += item.weight
                self._shed += len(evicted)
                self._shed_over_capacity += len(evicted)
                self._evicted += len(evicted)
                for v in evicted:
                    self._tenant_count_locked(v.tenant, "evicted")
                self._cv.notify()
            else:
                self._shed += 1
                if brownout_shed:
                    self._shed_brownout += 1
                    self._tenant_count_locked(item.tenant, "shed_brownout")
                elif isinstance(rejection, RateLimitError):
                    self._shed_over_capacity += 1
                    self._tenant_count_locked(item.tenant, "shed_over_capacity")
        # Futures are completed outside the lock: set_exception runs caller
        # callbacks inline, and a callback that re-enters the scheduler
        # (e.g. a retry) must not deadlock on self._cv.
        if evicted:
            FAILURE_EVENTS.record("scheduler.shed_over_capacity", len(evicted))
            for v in evicted:
                if v.tenant is not None:
                    TENANT_EVENTS.record(f"tenant.evicted.{v.tenant.name}")
                if not v.future.done():
                    v.future.set_exception(
                        RateLimitError(
                            "evicted from queue by higher-priority work",
                            retry_after=1.0,
                        )
                    )
        if rejection is not None:
            if brownout_shed:
                FAILURE_EVENTS.record("scheduler.shed")
                TENANT_EVENTS.record(f"tenant.shed_brownout.{item.tenant.name}")
            elif isinstance(rejection, RateLimitError):
                FAILURE_EVENTS.record("scheduler.shed_over_capacity")
                TENANT_EVENTS.record(
                    f"tenant.shed_over_capacity.{item.tenant.name}"
                )
            else:
                FAILURE_EVENTS.record("scheduler.shed_draining")
            future.set_exception(rejection)
            return False
        return True

    def _put(self, item: Optional[_Item]) -> None:
        """Post the shutdown signal (``None``) or re-queue an item directly
        (no admission control — internal requeues only). The signal is a flag
        rather than an in-queue sentinel, with the same FIFO contract: the
        worker serves the whole backlog present at signal time, then retires."""
        with self._cv:
            if item is None:
                self._sentinel = True
            else:
                if not isinstance(item.tenant, TenantContext):
                    item.tenant = self._tenancy.resolve(item.tenant)
                self._queue_for_locked(item.tenant).items.append(item)
                self._queue_weight += item.weight
            self._cv.notify()

    # -- tenant quota ------------------------------------------------------
    def charge_tenant_quota(
        self, tenant: Any = None, rows: int = 0
    ) -> TenantContext:
        """Charge one request + ``rows`` device rows against the tenant's
        token buckets, resolving ``tenant`` (name, context, or None) through
        this scheduler's :class:`TenancyConfig`. On success returns the
        resolved context for threading through the decode path. On a quota
        miss — real, or forced by the keyed ``scheduler.tenant=exhaust``
        failpoint — raises a typed 429 whose ``retry_after`` is the tenant's
        OWN bucket-refill horizon, not the global drain-rate estimate: a
        tenant that exhausted its budget learns when *its* budget refills,
        regardless of how fast the shared queue is moving."""
        ctx = self._tenancy.resolve(tenant)
        spec = _failpoints.fire_keyed("scheduler.tenant", ctx.name)
        forced = spec is not None and spec.action == "exhaust"
        if forced:
            wait: Optional[float] = ctx.refill_horizon(rows)
        else:
            wait = ctx.try_admit(rows)
        if forced or wait is not None:
            retry = min(60.0, max(0.1, float(wait or 0.0)))
            with self._cv:
                self._shed += 1
                self._shed_quota += 1
                self._tenant_count_locked(ctx, "shed_quota")
            FAILURE_EVENTS.record("scheduler.shed")
            TENANT_EVENTS.record(f"tenant.shed_quota.{ctx.name}")
            raise RateLimitError(
                f"tenant {ctx.name!r} over quota"
                + (" (forced by failpoint)" if forced else "")
                + f"; bucket refills in {retry:.2f}s",
                retry_after=retry,
            )
        TENANT_EVENTS.record(f"tenant.admitted.{ctx.name}")
        return ctx

    def submit(
        self,
        fn: Callable[[], Any],
        budget: Optional[RequestBudget] = None,
        priority: int = 0,
        tenant: Any = None,
    ) -> Future:
        future: Future = Future()
        self._admit(
            _Item(future, fn=fn, budget=budget, priority=priority, tenant=tenant)
        )
        return future

    def submit_batched(
        self,
        batch_key: Tuple,
        payload: Any,
        batch_fn: Callable[[List[Any]], List[Any]],
        weight: int = 1,
        window: Optional[float] = None,
        budget: Optional[RequestBudget] = None,
        priority: int = 0,
        max_rows: Optional[int] = None,
        trace_phase: str = "decode",
        tenant: Any = None,
    ) -> Future:
        """Enqueue ``payload`` for batched service. Items whose ``batch_key``
        matches the queue head's coalesce into ONE ``batch_fn(payloads)`` call
        (the runner must return one result per payload, in order). Callers with
        equal keys must pass interchangeable runners — the group uses the first
        item's. ``weight`` is the item's device-batch contribution (e.g. its
        sample count n) for the ``max_rows`` admission bound AND the
        ``max_queue_weight`` capacity bound. ``window`` overrides the
        scheduler's admission window for a group this item heads — pass 0.0
        for cheap work (e.g. embedding forwards) where the default 5 ms would
        be a large relative latency cost. ``budget`` attaches the request's
        lifecycle budget: spent budgets are rejected at admission, shed at
        dequeue, and bound the coalescing window. ``priority`` (lower = more
        important, default 0) only matters under overload: an arriving item
        may evict strictly-lower-priority queued items when the queue is full.
        ``max_rows`` is a per-item cap on the device rows of any group this
        item joins — the backend's HBM memory model passes its estimate here.
        ``trace_phase`` names the request-trace span the group's runner time
        is attributed to ("decode" for generation launches; embeddings pass
        "embed" so consolidation-time forwards don't read as decode).
        ``tenant`` (name, :class:`TenantContext`, or None for the default
        tenant) routes the item to its tenant's WFQ queue; coalescing never
        crosses tenant boundaries. Quotas are NOT charged here — the request
        path charges once via :meth:`charge_tenant_quota` before submitting."""
        future: Future = Future()
        self._admit(
            _Item(
                future,
                batch_key=batch_key,
                payload=payload,
                batch_fn=batch_fn,
                weight=weight,
                window=window,
                budget=budget,
                priority=priority,
                max_rows=max_rows,
                tenant=tenant,
                trace_phase=trace_phase,
            )
        )
        return future

    def call(
        self, fn: Callable[[], Any], budget: Optional[RequestBudget] = None
    ) -> Any:
        """Synchronous convenience: submit and wait. Re-entrant from the
        worker thread itself (runs inline — prevents self-deadlock when device
        work triggers more device work, e.g. llm-consensus inside a request)."""
        if threading.current_thread() is self._worker:
            if budget is not None:
                budget.check("scheduler admission")
            return fn()
        return self.submit(fn, budget=budget).result()

    def call_batched(
        self,
        batch_key: Tuple,
        payload: Any,
        batch_fn: Callable[[List[Any]], List[Any]],
        weight: int = 1,
        window: Optional[float] = None,
        budget: Optional[RequestBudget] = None,
        priority: int = 0,
        max_rows: Optional[int] = None,
        trace_phase: str = "decode",
        tenant: Any = None,
    ) -> Any:
        """Synchronous batched submit-and-wait (re-entrant like ``call``).
        Per-member failures surface here: if the runner returned an exception
        instance for this payload, it is raised to the caller."""
        if threading.current_thread() is self._worker:
            if budget is not None:
                budget.check("scheduler admission")
            res = batch_fn([payload])[0]
            if isinstance(res, BaseException):
                raise res
            return res
        return self.submit_batched(
            batch_key,
            payload,
            batch_fn,
            weight=weight,
            window=window,
            budget=budget,
            priority=priority,
            max_rows=max_rows,
            trace_phase=trace_phase,
            tenant=tenant,
        ).result()

    # -- lifecycle & observability ----------------------------------------
    @property
    def state(self) -> ServerState:
        with self._cv:
            return self._state

    @property
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            out = {
                "queued": self._backlog_locked(),
                "served": self._served,
                "errors": self._errors,
                "batches": self._batches,
                "coalesced": self._coalesced,
                "shed": self._shed,
                "spec_launches": self._spec_launches,
                "spec_drafted": self._spec_drafted,
                "spec_accepted": self._spec_accepted,
                "spec_tokens_per_iteration": self._spec_tpi_last,
                "routed": self._routed,
                "failovers": self._failovers,
                "hedges": self._hedges,
                "hedges_won": self._hedges_won,
            }
        self._attach_consensus(out)
        self._attach_kernel(out)
        self._attach_grammar(out)
        return out

    def _attach_consensus(self, out: Dict[str, Any]) -> None:
        """Merge the backend's consensus snapshot (outside _cv: the provider
        takes its own locks and must never deadlock or break health)."""
        prov = self.consensus_stats_provider
        if prov is None:
            return
        try:
            out["consensus"] = prov()
        except Exception:  # pragma: no cover - observability must not throw
            pass

    def _attach_kernel(self, out: Dict[str, Any]) -> None:
        """Merge the paged-attention dispatch counters (process-global
        KERNEL_EVENTS: which impl decode launches ran, counted fallbacks).
        Omitted entirely until the first paged dispatch — dense-only
        deployments see no kernel section."""
        from ..utils.observability import KERNEL_EVENTS

        snap = KERNEL_EVENTS.snapshot()
        if snap:
            out["kernel"] = snap

    def _attach_grammar(self, out: Dict[str, Any]) -> None:
        """Merge the constrained-decoding counters (process-global
        GRAMMAR_EVENTS: compiles, cache hits/misses, counted fallbacks,
        masked decode steps). Omitted until the first grammar event —
        deployments that never constrain see no grammar section; the backend
        layers the cache gauges + enabled flag into the same key."""
        from ..utils.observability import GRAMMAR_EVENTS

        snap = GRAMMAR_EVENTS.snapshot()
        if snap:
            out["grammar"] = {"events": snap}

    def health(self) -> Dict[str, Any]:
        """Point-in-time lifecycle snapshot, shaped for a /healthz endpoint.
        Cheap (one lock acquisition, no device work)."""
        with self._cv:
            tenants: Dict[str, Any] = {}
            for name, tq in self._queues.items():
                entry: Dict[str, Any] = {
                    "slo": tq.ctx.slo,
                    "weight": tq.ctx.weight,
                    "queued": len(tq.items),
                    "queued_weight": sum(it.weight for it in tq.items),
                    "vpass": round(tq.vpass, 3),
                }
                entry.update(self._tenant_stats.get(name, {}))
                tenants[name] = entry
            for name, counts in self._tenant_stats.items():
                if name not in tenants:
                    tenants[name] = dict(counts)
            out = {
                "state": self._state.value,
                "queue_depth": self._backlog_locked(),
                "queue_weight": self._queue_weight,
                "max_queue_weight": self.max_queue_weight,
                "in_flight": self._in_flight,
                "effective_max_rows": max(1, self.max_rows >> self._width_shift),
                "max_rows": self.max_rows,
                "served": self._served,
                "errors": self._errors,
                "shed": self._shed,
                "shed_over_capacity": self._shed_over_capacity,
                "shed_brownout": self._shed_brownout,
                "shed_quota": self._shed_quota,
                "brownout": self._brownout_locked(),
                "evicted": self._evicted,
                "tenants": tenants,
                "oom_splits": self._oom_splits,
                "recoveries": self._recoveries,
                "recovery_attempt": self._recovery_attempt,
                "last_recovery_reason": self._last_recovery_reason,
                "quarantined": self._quarantined,
                "routed": self._routed,
                "failovers": self._failovers,
                "hedges": self._hedges,
                "hedges_won": self._hedges_won,
                "drain_rate": self._drain_rate(),
            }
        self._attach_consensus(out)
        self._attach_kernel(out)
        self._attach_grammar(out)
        return out

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: close admission (new work gets a typed 503),
        let queued + in-flight groups finish, then join the worker. Returns
        True when everything completed within ``timeout``; on timeout, still-
        queued items are failed with the draining 503 and the worker is only
        joined if it retires promptly (an in-flight decode cannot be killed).
        Idempotent; callable from any thread except the worker itself."""
        if threading.current_thread() is self._worker:
            raise RuntimeError("drain() must not be called from the worker thread")
        deadline = time.monotonic() + timeout
        with self._cv:
            if self._state is ServerState.STOPPED:
                return True
            self._state = ServerState.DRAINING
            self._cv.notify_all()  # wake the worker's idle wait
            clean = True
            while self._backlog_locked() or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    clean = False
                    break
                self._cv.wait(remaining)
            leftovers = self._clear_queues_locked()
        for it in leftovers:
            if not it.future.done():
                it.future.set_exception(
                    ServerDrainingError("server drained before this request ran")
                )
        if leftovers:
            FAILURE_EVENTS.record("scheduler.shed_draining", len(leftovers))
        # The worker retires on its own when it observes DRAINING with an
        # empty queue; the sentinel covers the race where it is mid-wait.
        self._put(None)
        self._worker.join(timeout=max(0.1, deadline - time.monotonic()) if not clean else 5)
        clean = clean and not self._worker.is_alive() and not leftovers
        with self._cv:
            self._state = ServerState.STOPPED
        return clean

    def shutdown(self) -> None:
        """Legacy stop: post the shutdown signal (backlog is served first)
        and join. Kept for back-compat; ``drain()`` is the graceful variant
        with admission close and timeout semantics."""
        self._put(None)
        self._worker.join(timeout=5)
        with self._cv:
            self._state = ServerState.STOPPED
