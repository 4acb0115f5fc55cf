"""Replica-set serving: health-aware routing, mid-flight failover, hedging.

The single-engine reliability stack (deadlines + breakers, overload shedding,
self-healing supervision) still serializes every caller behind one engine's
bad day: while the supervisor rebuilds a hung engine, all queued work waits.
:class:`ReplicaSet` is the standard serving-stack answer — N member backends
behind the one :class:`Backend` surface, so ``resolve_backend("replicas",
members=[...])`` is a drop-in for the client and resources layer.

Three mechanisms, in dispatch order:

1. **Health-aware routing.** Each dispatch goes to the eligible member with
   the lowest score ``latency_EWMA × (1 + queue_load)``, with multiplicative
   penalties for DEGRADED state and half-open breakers. A member whose
   supervisor reports RECOVERING/DRAINING/STOPPED — or whose dispatch just
   died with a replica-health error — leaves rotation and rejoins only after
   a synthetic health-probe generation passes (``probe()``), never merely
   because time passed.

2. **Mid-flight failover.** A dispatch that dies with a replica-health error
   (EngineHungError, terminal OOM, connection loss…) is transparently
   re-dispatched to a survivor. The set pins the request seed *before* the
   first attempt (the same pinning the supervisor relies on for replay), so
   the failover rerun is byte-identical to an uninterrupted run on the
   survivor. Bounded by ``max_failover_attempts`` and the caller's budget;
   caller-owned outcomes (timeout, cancel) and caller bugs (ValueError…)
   never fail over.

3. **Hedged dispatch** ("The Tail at Scale"). When the primary has not
   answered after a delay derived from its observed p95 latency, the launch
   is duplicated on a second healthy member. First result wins; the loser's
   child budget is cancelled, which the engine's io_callback abort poller
   turns into a token-granularity decode abort. Hedge attempts call the
   member's raw ``chat_completion`` (not ``dispatch_chat_completion``), so a
   losing or failing hedge never counts against any circuit breaker.

Degradation is honest: zero eligible members ⇒ :class:`NoHealthyReplicasError`
(an OpenAI-wire 503) listing the per-replica reasons, and when the surviving
capacity sheds with 429s the ``retry_after`` estimate is scaled by
``total_members / healthy_members`` so callers back off proportionally to the
capacity actually lost.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..analysis.lockcheck import make_lock, race_exempt
from ..backends.base import Backend, ChatRequest
from ..types import ChatCompletion
from ..types.wire import (
    NoHealthyReplicasError,
    RateLimitError,
    RequestCancelledError,
    RequestTimeoutError,
)
from ..utils.observability import FAILOVER_EVENTS, HEDGE_EVENTS, ROUTE_EVENTS
from . import failpoints as _failpoints
from .deadline import RequestBudget

logger = logging.getLogger(__name__)

#: Backend health states that pull a member from rotation (supervisor is
#: rebuilding it, it is draining, or it is gone). DEGRADED stays in rotation —
#: a width-backed-off engine still serves — it just scores worse.
_OUT_OF_ROTATION_STATES = ("recovering", "draining", "stopped")

#: Errors that are the CALLER's outcome (their deadline/cancel) or the
#: caller's bug — never a replica-health signal, so never a failover trigger.
_NO_FAILOVER = (
    RequestTimeoutError,
    RequestCancelledError,
    ValueError,
    TypeError,
    KeyboardInterrupt,
)


class ReplicaHandle:
    """One member of a :class:`ReplicaSet` plus its routing state: latency
    EWMA + recent-sample window (for the hedge-delay p95), dispatch tallies,
    and the in/out-of-rotation probation state."""

    def __init__(self, replica_id: str, backend: Backend):
        self.replica_id = replica_id
        self.backend = backend
        self.lock = make_lock(f"reliability.replica.{replica_id}")
        self._ewma_s: Optional[float] = None
        self._recent: "deque[float]" = deque(maxlen=64)
        self.dispatched = 0
        self.failed = 0
        self.hedges_won = 0
        self.failovers = 0
        self.in_rotation = True
        self.out_reason: Optional[str] = None
        self.out_since: Optional[float] = None
        self.probe_failures = 0
        self.last_probe_at = 0.0  # monotonic; 0 = never probed
        self.probing = False  # an async probe is in flight

    # -- latency ----------------------------------------------------------
    def note_success(self, elapsed_s: float) -> None:
        with self.lock:
            self.dispatched += 1
            self._recent.append(elapsed_s)
            alpha = 0.3
            self._ewma_s = (
                elapsed_s
                if self._ewma_s is None
                else alpha * elapsed_s + (1 - alpha) * self._ewma_s
            )

    def note_failure(self) -> None:
        with self.lock:
            self.failed += 1

    def ewma_s(self) -> Optional[float]:
        with self.lock:
            return self._ewma_s

    def p95_s(self) -> Optional[float]:
        """p95 of the recent-latency window; None until enough history exists
        to call anything a tail (hedging without history would just double
        every launch)."""
        with self.lock:
            if len(self._recent) < 4:
                return None
            ordered = sorted(self._recent)
            return ordered[min(len(ordered) - 1, int(0.95 * (len(ordered) - 1)))]

    # -- rotation ----------------------------------------------------------
    def mark_down(self, reason: str) -> None:
        with self.lock:
            if self.in_rotation:
                self.in_rotation = False
                self.out_since = time.monotonic()
            self.out_reason = reason[:200]

    def rejoin(self) -> None:
        with self.lock:
            self.in_rotation = True
            self.out_reason = None
            self.out_since = None
            self.probe_failures = 0

    def safe_health(self) -> Dict[str, Any]:
        try:
            return self.backend.health()
        except BaseException as e:  # a member too sick to report health
            return {"state": f"health_error:{type(e).__name__}", "breaker": "open"}


class ReplicaSet(Backend):
    """N member backends behind one :class:`Backend` surface.

    ``members`` accepts Backend instances (tests, pre-built engines), backend
    names (each resolved via :func:`resolve_backend` with ``**member_kwargs``),
    or per-member dicts ``{"backend": "cuda", "id": "west", **kwargs}`` for
    heterogeneous sets. Replica ids default to ``r0..rN-1``.

    Routing knobs:

    - ``route_policy``: ``"health"`` (default — score-based) or
      ``"round_robin"`` (uniform over eligible members; used by benchmarks
      that must not let the EWMA route around an injected slow member).
    - ``hedge`` / ``hedge_delay_s`` / ``hedge_latency_multiplier``: hedging
      on/off, a fixed hedge delay, or (default) ``p95 × multiplier`` from the
      primary's observed latency window.
    - ``max_failover_attempts``: additional members tried after the primary's
      replica-health failure.
    - ``probe_interval_s`` / ``probe_timeout_s`` / ``probe_max_tokens``: the
      synthetic health-probe generation gating rejoin.
    """

    def __init__(
        self,
        members: Optional[Sequence[Union[Backend, str, Dict[str, Any]]]] = None,
        *,
        model: Optional[str] = None,
        route_policy: str = "health",
        hedge: bool = True,
        hedge_delay_s: Optional[float] = None,
        hedge_latency_multiplier: float = 2.0,
        min_hedge_delay_s: float = 0.05,
        max_failover_attempts: int = 2,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 30.0,
        probe_max_tokens: int = 4,
        **member_kwargs: Any,
    ):
        if not members:
            raise ValueError(
                "ReplicaSet needs at least one member; pass members=[...] "
                "(Backend instances, backend names, or per-member dicts)"
            )
        if route_policy not in ("health", "round_robin"):
            raise ValueError(
                f"route_policy must be 'health' or 'round_robin', got {route_policy!r}"
            )
        self.route_policy = route_policy
        self.hedge = hedge
        self.hedge_delay_s = hedge_delay_s
        self.hedge_latency_multiplier = hedge_latency_multiplier
        self.min_hedge_delay_s = min_hedge_delay_s
        self.max_failover_attempts = max_failover_attempts
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.probe_max_tokens = probe_max_tokens

        handles: List[ReplicaHandle] = []
        for i, member in enumerate(members):
            replica_id = f"r{i}"
            if isinstance(member, Backend):
                backend = member
            elif isinstance(member, str):
                backend = self._build_member(member, model, member_kwargs)
            elif isinstance(member, dict):
                spec = dict(member)
                replica_id = str(spec.pop("id", replica_id))
                name = spec.pop("backend", "cuda")
                backend = self._build_member(name, model, {**member_kwargs, **spec})
            else:
                raise TypeError(
                    f"member {i} must be a Backend, backend name, or dict, "
                    f"got {type(member).__name__}"
                )
            handles.append(ReplicaHandle(replica_id, backend))
        ids = [h.replica_id for h in handles]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self._handles = handles
        self._by_id = {h.replica_id: h for h in handles}
        self.model_name = (
            model or getattr(handles[0].backend, "model_name", None) or "replicas"
        )
        self._rr_lock = make_lock("reliability.replica_rr")
        self._rr_next = 0
        # Monotonic shutdown latch: a stale False costs at most one extra
        # probe submission, which the shut-down executor rejects harmlessly.
        # kllms: unguarded — monotonic shutdown latch; stale reads are benign
        self._closed = False
        race_exempt(self, "_closed")
        # Sized for hedged dispatch (2 workers per in-flight hedged request)
        # plus background probes. The wait loop runs on the caller's thread,
        # never in this pool, so saturation queues work instead of deadlocking.
        self._executor = ThreadPoolExecutor(
            max_workers=max(8, 4 * len(handles)),
            thread_name_prefix="kllms-replica",
        )

    @staticmethod
    def _build_member(
        name: str, model: Optional[str], kwargs: Dict[str, Any]
    ) -> Backend:
        from ..backends.base import resolve_backend

        kw = dict(kwargs)
        if model is not None:
            kw.setdefault("model", model)
        return resolve_backend(name, **kw)

    # -- routing -----------------------------------------------------------
    def _score(self, handle: ReplicaHandle, snap: Dict[str, Any]) -> float:
        """Lower is better: latency EWMA scaled by queue pressure, penalized
        for degraded state and a half-open (probing) breaker."""
        ewma = handle.ewma_s() or 0.050  # optimistic prior for cold members
        try:
            load = int(snap.get("queue_weight") or snap.get("queue_depth") or 0)
            load += int(snap.get("in_flight") or 0)
        except (TypeError, ValueError):
            load = 0
        score = ewma * (1.0 + load)
        if str(snap.get("state")) == "degraded":
            score *= 2.0
        if str(snap.get("breaker")) == "half_open":
            score *= 4.0
        return score

    def _eligible(
        self, exclude: frozenset
    ) -> Tuple[List[Tuple[ReplicaHandle, float]], Dict[str, str]]:
        """Eligible members with scores, plus per-replica reasons for every
        ineligible one (the 503 body). Side effects: pulls members whose
        backend reports an out-of-rotation state, and kicks off async probes
        for members sitting in probation."""
        eligible: List[Tuple[ReplicaHandle, float]] = []
        reasons: Dict[str, str] = {}
        for handle in self._handles:
            snap = handle.safe_health()
            state = str(snap.get("state", "ready"))
            with handle.lock:
                in_rotation = handle.in_rotation
            if in_rotation and state in _OUT_OF_ROTATION_STATES:
                handle.mark_down(f"backend state: {state}")
                in_rotation = False
                ROUTE_EVENTS.record("route.pulled")
                logger.warning(
                    "replica %s pulled from rotation (state=%s)",
                    handle.replica_id,
                    state,
                )
            if not in_rotation:
                with handle.lock:
                    out_reason = handle.out_reason
                reasons[handle.replica_id] = out_reason or "out of rotation"
                self._maybe_probe_async(handle)
                continue
            if handle.replica_id in exclude:
                reasons[handle.replica_id] = "already tried for this request"
                continue
            breaker = str(snap.get("breaker", handle.backend.circuit_breaker.state))
            if breaker == "open":
                reasons[handle.replica_id] = "circuit breaker open"
                continue
            eligible.append((handle, self._score(handle, snap)))
        return eligible, reasons

    def _route(
        self, exclude: frozenset = frozenset(), advance_round_robin: bool = True
    ) -> ReplicaHandle:
        """Pick the best eligible member. With zero eligible members, try one
        synchronous probe round over probation members (rate-limited by
        ``probe_interval_s``) before giving up with the typed 503.
        ``advance_round_robin=False`` (hedge routing) keeps the round-robin
        cursor aligned with primary dispatches."""
        eligible, reasons = self._eligible(exclude)
        if not eligible:
            for handle in self._handles:
                with handle.lock:
                    in_rotation = handle.in_rotation
                    last_probe_at = handle.last_probe_at
                if in_rotation or handle.replica_id in exclude:
                    continue
                if time.monotonic() - last_probe_at < self.probe_interval_s:
                    continue
                if self._probe(handle):
                    return handle
            ROUTE_EVENTS.record("route.no_healthy")
            detail = "; ".join(f"{rid}: {why}" for rid, why in sorted(reasons.items()))
            raise NoHealthyReplicasError(
                f"no healthy replicas ({len(self._handles)} members): {detail}",
                reasons=reasons,
            )
        if self.route_policy == "round_robin":
            with self._rr_lock:
                start = self._rr_next
                if advance_round_robin:
                    self._rr_next += 1
            order = {h.replica_id: i for i, h in enumerate(self._handles)}
            ranked = sorted(eligible, key=lambda t: order[t[0].replica_id])
            return ranked[start % len(ranked)][0]
        return min(eligible, key=lambda t: t[1])[0]

    # -- probes ------------------------------------------------------------
    def _maybe_probe_async(self, handle: ReplicaHandle) -> None:
        with handle.lock:
            if handle.probing or self._closed:
                return
            if time.monotonic() - handle.last_probe_at < self.probe_interval_s:
                return
            handle.probing = True

        def run() -> None:
            try:
                self._probe(handle)
            finally:
                with handle.lock:
                    handle.probing = False

        try:
            self._executor.submit(run)
        except RuntimeError:  # executor shut down during close/drain
            with handle.lock:
                handle.probing = False

    def probe(self, replica_id: str) -> bool:
        """Synchronously run the health probe for one member (public for tests
        and operator tooling); True means the member passed and rejoined."""
        return self._probe(self._by_id[replica_id])

    def _probe(self, handle: ReplicaHandle) -> bool:
        """The rejoin gate: a member in probation must answer a real (tiny,
        greedy, deadline-bounded) generation before it serves traffic again.
        A passing probe also records a breaker success, so a half-open
        circuit closes off the probe rather than off a user request."""
        with handle.lock:
            handle.last_probe_at = time.monotonic()
        ROUTE_EVENTS.record("route.probes")
        try:
            _failpoints.fire_keyed("replica.probe", handle.replica_id)
            snap = handle.safe_health()
            state = str(snap.get("state", "ready"))
            if state in _OUT_OF_ROTATION_STATES or state.startswith("health_error"):
                raise RuntimeError(f"probe: backend state is {state}")
            request = ChatRequest(
                messages=[{"role": "user", "content": "replica health probe"}],
                model=self.model_name,
                n=1,
                max_tokens=self.probe_max_tokens,
                temperature=0.0,
                seed=0,
                budget=RequestBudget.from_timeout(self.probe_timeout_s),
            )
            out = handle.backend.chat_completion(request)
            if not out.choices:
                raise RuntimeError("probe generation returned no choices")
        except BaseException as e:
            with handle.lock:
                handle.probe_failures += 1
            ROUTE_EVENTS.record("route.probe_failures")
            logger.info("replica %s probe failed: %s", handle.replica_id, e)
            return False
        handle.backend.circuit_breaker.record_success()
        handle.rejoin()
        ROUTE_EVENTS.record("route.rejoins")
        logger.info("replica %s passed health probe, rejoining rotation", handle.replica_id)
        return True

    # -- dispatch ----------------------------------------------------------
    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        """Single-attempt surface (Backend contract): route to the best
        member, no failover/hedging. The reliability entry point is
        ``dispatch_chat_completion``, which this class owns wholesale."""
        handle = self._route()
        return self._attempt(handle, request, hedged=False)

    def dispatch_chat_completion(self, request: ChatRequest) -> ChatCompletion:
        """Route → (hedged) dispatch → failover loop. Replaces the base
        breaker/retry wrapper: each member's own ``dispatch_chat_completion``
        still applies its breaker and retry policy, so wrapping again here
        would double-retry and double-count."""
        if request.seed is None:
            # Pin the seed before the FIRST attempt so any failover replay is
            # byte-identical (the same pinning the supervisor relies on).
            request = dataclasses.replace(
                request, seed=int.from_bytes(os.urandom(4), "little")
            )
        budget = request.budget
        tried: set = set()
        attempts = 0
        shed_errors: List[RateLimitError] = []
        while True:
            if budget is not None:
                budget.check("replica routing")
            try:
                handle = self._route(exclude=frozenset(tried))
            except NoHealthyReplicasError:
                if shed_errors:
                    # Members are healthy-but-full, not down: surface the 429
                    # with retry_after scaled to the capacity actually left.
                    raise self._scaled_rate_limit(shed_errors)
                raise
            ROUTE_EVENTS.record("route.dispatched")
            self._note_member(handle, "routed")
            if attempts > 0:
                FAILOVER_EVENTS.record("failover.attempts")
                with handle.lock:
                    handle.failovers += 1
                self._note_member(handle, "failover")
            try:
                return self._dispatch_hedged(handle, request)
            except RateLimitError as e:
                # Load signal, not a health signal: try another member, and
                # if every member sheds, report aggregate-scaled backpressure.
                shed_errors.append(e)
                tried.add(handle.replica_id)
                if len(tried) >= len(self._handles):
                    raise self._scaled_rate_limit(shed_errors)
                continue
            except _NO_FAILOVER:
                raise
            except BaseException as e:
                handle.mark_down(f"dispatch failed: {type(e).__name__}: {e}")
                FAILOVER_EVENTS.record("failover.member_down")
                ROUTE_EVENTS.record("route.pulled")
                logger.warning(
                    "replica %s failed mid-flight (%s: %s); failing over",
                    handle.replica_id,
                    type(e).__name__,
                    e,
                )
                tried.add(handle.replica_id)
                attempts += 1
                if attempts > self.max_failover_attempts:
                    FAILOVER_EVENTS.record("failover.exhausted")
                    raise

    def _scaled_rate_limit(self, errors: List[RateLimitError]) -> RateLimitError:
        healthy = sum(1 for h in self._handles if h.in_rotation)
        total = len(self._handles)
        base = min(
            (e.retry_after for e in errors if e.retry_after is not None),
            default=1.0,
        )
        scale = total / max(1, healthy)
        return RateLimitError(
            f"all {max(1, healthy)}/{total} healthy replicas at capacity",
            retry_after=min(60.0, base * scale),
        )

    def _attempt(
        self, handle: ReplicaHandle, request: ChatRequest, hedged: bool
    ) -> ChatCompletion:
        """One member attempt. Primary/failover attempts go through the
        member's ``dispatch_chat_completion`` (its breaker + retry policy);
        hedge attempts call the raw ``chat_completion`` so a losing or failing
        hedge never touches a breaker."""
        _failpoints.fire_keyed("replica.dispatch", handle.replica_id)
        t0 = time.perf_counter()
        try:
            if hedged:
                out = handle.backend.chat_completion(request)
            else:
                out = handle.backend.dispatch_chat_completion(request)
        except BaseException:
            handle.note_failure()
            raise
        handle.note_success(time.perf_counter() - t0)
        return out

    def _batch_class(self, handle: ReplicaHandle, request: ChatRequest) -> bool:
        """True when this request's tenant is SLO class ``batch`` on the
        routed member. Batch work never hedges: duplicating it on a second
        member would spend tail-latency capacity on traffic that by contract
        doesn't have a tail SLO. Defaults to interactive on any lookup
        failure (a backend without tenancy hedges as before)."""
        try:
            tenancy = getattr(handle.backend, "tenancy", None)
            if tenancy is None or request.tenant is None:
                return False
            return not tenancy.resolve(request.tenant).interactive
        except Exception:
            return False

    def _hedge_delay(self, handle: ReplicaHandle) -> Optional[float]:
        """Seconds to wait before duplicating on a second member; None
        disables hedging for this dispatch (off, solo set, or no latency
        history yet to define a tail)."""
        if not self.hedge or len(self._handles) < 2:
            return None
        if self.hedge_delay_s is not None:
            return max(0.0, self.hedge_delay_s)
        p95 = handle.p95_s()
        if p95 is None:
            return None
        return max(self.min_hedge_delay_s, p95 * self.hedge_latency_multiplier)

    def _dispatch_hedged(
        self, primary: ReplicaHandle, request: ChatRequest
    ) -> ChatCompletion:
        delay = self._hedge_delay(primary)
        if delay is None or self._batch_class(primary, request):
            return self._attempt(primary, request, hedged=False)

        parent = request.budget

        def child_of(req: ChatRequest) -> Tuple[ChatRequest, RequestBudget]:
            # Each attempt gets its own cancellable budget sharing the
            # parent's deadline, so cancelling the loser aborts ONLY the
            # loser's decode (via the engine's abort poller).
            child = RequestBudget(
                deadline=parent.deadline if parent is not None else None
            )
            return dataclasses.replace(req, budget=child), child

        # in-flight attempts: Future -> (handle, child_budget, kind)
        pending: Dict[Future, Tuple[ReplicaHandle, RequestBudget, str]] = {}
        preq, pbudget = child_of(request)
        pending[self._executor.submit(self._attempt, primary, preq, False)] = (
            primary,
            pbudget,
            "primary",
        )
        hedge_at = time.monotonic() + delay
        hedge_launched = False
        hedged_this_request = False
        errors: Dict[str, BaseException] = {}

        def cancel_all(remaining: Dict[Future, Tuple[ReplicaHandle, RequestBudget, str]]) -> None:
            for fut, (_, child, _) in remaining.items():
                child.cancel()
                fut.add_done_callback(lambda f: f.exception())

        while pending:
            if parent is not None and parent.should_abort():
                cancel_all(pending)
                raise parent.error("replica hedge wait")
            timeout = 0.02
            if not hedge_launched:
                timeout = min(timeout, max(0.0, hedge_at - time.monotonic()))
            done, _ = wait(list(pending), timeout=timeout, return_when=FIRST_COMPLETED)
            if not done:
                if not hedge_launched and time.monotonic() >= hedge_at:
                    hedge_launched = True  # one hedge per dispatch, success or not
                    try:
                        hedge_handle = self._route(
                            exclude=frozenset([primary.replica_id]),
                            advance_round_robin=False,
                        )
                    except NoHealthyReplicasError:
                        continue  # nobody to hedge on; keep waiting on primary
                    hedged_this_request = True
                    HEDGE_EVENTS.record("hedge.launched")
                    self._note_member(hedge_handle, "hedge")
                    hreq, hbudget = child_of(request)
                    pending[
                        self._executor.submit(self._attempt, hedge_handle, hreq, True)
                    ] = (hedge_handle, hbudget, "hedge")
                continue
            for fut in done:
                handle, _, kind = pending.pop(fut)
                exc = fut.exception()
                if exc is None:
                    losers = len(pending)
                    cancel_all(pending)
                    if losers:
                        HEDGE_EVENTS.record("hedge.cancelled_losers", losers)
                    if kind == "hedge":
                        HEDGE_EVENTS.record("hedge.won_hedge")
                        with handle.lock:
                            handle.hedges_won += 1
                        self._note_member(handle, "hedge_won")
                    elif hedged_this_request:
                        HEDGE_EVENTS.record("hedge.won_primary")
                    return fut.result()
                errors[kind] = exc
                if kind == "primary" and isinstance(
                    exc, (RequestTimeoutError, RequestCancelledError)
                ):
                    # The hedge shares the same deadline; don't wait for it
                    # to time out too.
                    cancel_all(pending)
                    raise exc
        # Every attempt failed. The primary's error drives the failover loop
        # (the hedge's failure never reaches a breaker or rotation decision).
        raise errors.get("primary") or next(iter(errors.values()))

    def _note_member(self, handle: ReplicaHandle, kind: str) -> None:
        """Forward route/hedge/failover tallies into the member's scheduler
        stats (TpuBackend members; others have no scheduler and skip)."""
        scheduler = getattr(handle.backend, "scheduler", None)
        if scheduler is None:
            return
        try:
            if kind == "routed":
                scheduler.note_routed()
            elif kind == "failover":
                scheduler.note_failover()
            elif kind == "hedge":
                scheduler.note_hedge()
            elif kind == "hedge_won":
                scheduler.note_hedge(won=True)
        except Exception:  # stats must never fail a dispatch
            logger.debug("replica stats hook failed", exc_info=True)

    # -- non-chat Backend surface (failover, no hedging) -------------------
    def _call_with_failover(self, fn: Callable[[ReplicaHandle], Any]) -> Any:
        tried: set = set()
        attempts = 0
        while True:
            handle = self._route(exclude=frozenset(tried))
            try:
                _failpoints.fire_keyed("replica.dispatch", handle.replica_id)
                return fn(handle)
            except _NO_FAILOVER:
                raise
            except RateLimitError:
                raise
            except BaseException as e:
                handle.note_failure()
                handle.mark_down(f"dispatch failed: {type(e).__name__}: {e}")
                FAILOVER_EVENTS.record("failover.member_down")
                tried.add(handle.replica_id)
                attempts += 1
                if attempts > self.max_failover_attempts:
                    FAILOVER_EVENTS.record("failover.exhausted")
                    raise
                FAILOVER_EVENTS.record("failover.attempts")

    def embeddings(self, texts: List[str]) -> List[List[float]]:
        return self._call_with_failover(lambda h: h.backend.embeddings(texts))

    def embeddings_with_usage(
        self, texts: List[str], model: Optional[str] = None
    ) -> "tuple[List[List[float]], int]":
        return self._call_with_failover(
            lambda h: h.backend.embeddings_with_usage(texts, model=model)
        )

    def crop_texts(
        self, texts: List[str], max_tokens: int, model: Optional[str] = None
    ) -> List[str]:
        for handle in self._handles:
            with handle.lock:
                in_rotation = handle.in_rotation
            if in_rotation:
                return handle.backend.crop_texts(texts, max_tokens, model=model)
        return self._handles[0].backend.crop_texts(texts, max_tokens, model=model)

    def llm_consensus(self, values: List[str]) -> str:
        return self._call_with_failover(lambda h: h.backend.llm_consensus(values))

    @property
    def embedding_model_name(self) -> str:  # type: ignore[override]
        return self._handles[0].backend.embedding_model_name

    @property
    def bills_usage(self) -> bool:  # type: ignore[override]
        return any(h.backend.bills_usage for h in self._handles)

    # -- observability & lifecycle -----------------------------------------
    def _replica_snapshot(self, handle: ReplicaHandle) -> Dict[str, Any]:
        snap = handle.safe_health()
        with handle.lock:
            ewma = handle._ewma_s
            out = {
                "state": str(snap.get("state", "ready"))
                if handle.in_rotation
                else "out_of_rotation",
                "in_rotation": handle.in_rotation,
                "out_reason": handle.out_reason,
                "breaker": str(snap.get("breaker", "closed")),
                "queue_depth": snap.get("queue_depth", 0),
                "in_flight": snap.get("in_flight", 0),
                "dispatched": handle.dispatched,
                "failed": handle.failed,
                "hedges_won": handle.hedges_won,
                "failovers": handle.failovers,
                "probe_failures": handle.probe_failures,
                "ewma_ms": round(ewma * 1000.0, 3) if ewma is not None else None,
            }
        p95 = handle.p95_s()
        out["p95_ms"] = round(p95 * 1000.0, 3) if p95 is not None else None
        return out

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-replica ``{dispatched, failed, hedges_won, ewma_ms, state}``
        (plus rotation detail) keyed by replica id."""
        return {h.replica_id: self._replica_snapshot(h) for h in self._handles}

    def health(self) -> Dict[str, Any]:
        replicas = self.stats()
        healthy = sum(1 for snap in replicas.values() if snap["in_rotation"])
        if healthy == len(replicas):
            state = "ready"
        elif healthy == 0:
            state = "unavailable"
        else:
            state = "degraded"
        return {
            "state": state,
            "breaker": self.circuit_breaker.state,
            "members": len(replicas),
            "healthy_members": healthy,
            "route_policy": self.route_policy,
            "hedge": self.hedge,
            "replicas": replicas,
        }

    def drain(self, timeout: float = 30.0) -> bool:
        self._closed = True
        per_member = timeout / max(1, len(self._handles))
        ok = True
        for handle in self._handles:
            try:
                ok = handle.backend.drain(per_member) and ok
            except BaseException:
                ok = False
        self._executor.shutdown(wait=False)
        return ok

    def close(self) -> None:
        self._closed = True
        for handle in self._handles:
            try:
                handle.backend.close()
            except BaseException:
                logger.debug("replica %s close failed", handle.replica_id, exc_info=True)
        self._executor.shutdown(wait=False)
