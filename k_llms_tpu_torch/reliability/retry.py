"""Bounded retry with exponential backoff + jitter, and a per-backend circuit
breaker.

The reference gets retries from the OpenAI client (2 retries, exponential
backoff); locally the same shape already proved itself in ``bench.py``'s
relay-flap survival (bounded probe attempts + backoff + structured error on
final failure). This module is that shape as a reusable policy, plus the
circuit breaker that turns a flapping backend (relay death, OOM loop, compile
failure storm) into fast typed errors instead of every caller queueing behind
a hang.

Determinism: jitter derives from ``random.Random(seed)`` so failure tests can
pin exact backoff schedules; production constructs without a seed.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..analysis.lockcheck import make_lock
from ..types.wire import BackendUnavailableError, KLLMsError
from ..utils.observability import FAILURE_EVENTS
from .deadline import RequestBudget

logger = logging.getLogger(__name__)

T = TypeVar("T")

# Typed lifecycle errors and parameter errors must NEVER be retried: the
# former are final verdicts (deadline/cancel/circuit), the latter are caller
# bugs that will fail identically on every attempt.
NON_RETRYABLE: Tuple[Type[BaseException], ...] = (
    KLLMsError,
    ValueError,
    TypeError,
    KeyboardInterrupt,
)


def is_retryable(exc: BaseException) -> bool:
    return not isinstance(exc, NON_RETRYABLE)


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter: delay_k = U(0, min(cap, base*2^k)).

    ``max_attempts`` counts total tries (1 = no retry). Sleeps are bounded by
    the request budget's remaining time — a retry never outlives the deadline
    it is trying to beat.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: bool = True
    seed: Optional[int] = None
    _rng: random.Random = field(init=False, repr=False, compare=False, default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based: after the first
        failure attempt=1)."""
        cap = min(self.max_delay, self.base_delay * (2 ** max(0, attempt - 1)))
        return self._rng.uniform(0.0, cap) if self.jitter else cap

    def call(
        self,
        fn: Callable[[], T],
        budget: Optional[RequestBudget] = None,
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> T:
        """Run ``fn`` under this policy. Non-retryable errors and budget
        expiry propagate immediately; the final attempt's error propagates
        as-is (callers wrap it in their own typed error if they want one)."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if budget is not None:
                budget.check("retry")
            try:
                return fn()
            except BaseException as e:
                if not is_retryable(e) or attempt >= self.max_attempts:
                    raise
                last = e
                FAILURE_EVENTS.record("retry.attempt")
                if on_retry is not None:
                    on_retry(e, attempt)
                delay = self.delay_for(attempt)
                if budget is not None:
                    remaining = budget.remaining()
                    if remaining <= 0:
                        raise
                    delay = min(delay, max(0.0, remaining))
                logger.debug(
                    "retry %d/%d after %r; backing off %.3fs",
                    attempt, self.max_attempts, e, delay,
                )
                if delay > 0:
                    sleep(delay)
        raise last  # pragma: no cover - loop always returns or raises


class CircuitBreaker:
    """Per-backend circuit breaker: closed -> open after ``failure_threshold``
    consecutive failures; open sheds calls instantly with a typed
    ``BackendUnavailableError``; after ``reset_timeout`` seconds ONE probe call
    is admitted (half-open) — success closes the circuit, failure re-opens it.

    ``clock`` is injectable so tests pin transitions without sleeping.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout: float = 10.0,
        name: str = "backend",
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.name = name
        self._clock = clock
        self._lock = make_lock(f"reliability.breaker.{name}" if name else "reliability.breaker")
        self._failures = 0
        self._state = "closed"  # closed | open | half_open
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> None:
        """Gate a dispatch: raises ``BackendUnavailableError`` when open (and
        not yet due for a probe); transitions open -> half_open when due."""
        with self._lock:
            if self._state == "closed":
                return
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_timeout:
                    self._state = "half_open"
                    logger.info("circuit %s: open -> half_open (probe admitted)", self.name)
                    return
                FAILURE_EVENTS.record("circuit.rejected")
                raise BackendUnavailableError(
                    f"backend {self.name!r} circuit open after "
                    f"{self._failures} consecutive failures; retrying in "
                    f"{max(0.0, self.reset_timeout - (self._clock() - self._opened_at)):.1f}s"
                )
            # half_open: exactly one probe in flight is the simple (and
            # sufficient) policy — concurrent callers shed fast.
            FAILURE_EVENTS.record("circuit.rejected")
            raise BackendUnavailableError(
                f"backend {self.name!r} circuit half-open; probe in flight"
            )

    def record_success(self) -> None:
        with self._lock:
            if self._state != "closed":
                logger.info("circuit %s: %s -> closed", self.name, self._state)
            self._failures = 0
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or self._failures >= self.failure_threshold:
                if self._state != "open":
                    logger.warning(
                        "circuit %s: -> open after %d consecutive failures",
                        self.name, self._failures,
                    )
                    FAILURE_EVENTS.record("circuit.opened")
                self._state = "open"
                self._opened_at = self._clock()
