"""Deadlines and per-request budgets.

The reference SDK inherits the OpenAI client's ``timeout=`` wire contract and
request-cancellation machinery for free (PAPER.md §0); a local engine owns the
whole request lifecycle, so the budget object created from ``timeout=`` in the
resources layer must travel down through the scheduler (admission control) and
into the engine's decode loop (token-granularity cancellation) and be checkable
at each stage without re-deriving wall-clock math.

``Deadline`` is a plain absolute-monotonic instant (``math.inf`` when no
timeout was given). ``RequestBudget`` couples a deadline with a cooperative
cancel token; every layer calls ``check(stage)`` (raises the typed error) or
``should_abort()`` (bool poll, used between decode steps where raising inside
jitted code is impossible).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from ..types.wire import RequestCancelledError, RequestTimeoutError


class Deadline:
    """Absolute monotonic-clock deadline; infinite when no timeout applies."""

    __slots__ = ("at",)

    def __init__(self, at: float = math.inf):
        self.at = float(at)

    @classmethod
    def from_timeout(cls, timeout: Optional[float]) -> "Deadline":
        if timeout is None:
            return cls(math.inf)
        if timeout < 0:
            raise ValueError(f"timeout must be >= 0, got {timeout}")
        return cls(time.monotonic() + timeout)

    @property
    def finite(self) -> bool:
        return math.isfinite(self.at)

    def remaining(self) -> float:
        """Seconds until expiry; ``inf`` when no timeout, <= 0 when expired."""
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():.3f}s)" if self.finite else "Deadline(inf)"


class RequestBudget:
    """One request's lifecycle budget: a deadline plus a cancel token.

    Created in the resources layer from ``timeout=`` (or passed in by a caller
    who wants to hold the cancel handle), then threaded through scheduler
    admission, backend dispatch, and the engine decode loop. Thread-safe: the
    cancel token is an event, the deadline is immutable.
    """

    __slots__ = ("deadline", "_cancelled")

    def __init__(self, deadline: Optional[Deadline] = None):
        self.deadline = deadline or Deadline()
        self._cancelled = threading.Event()

    @classmethod
    def from_timeout(cls, timeout: Optional[float]) -> "RequestBudget":
        return cls(Deadline.from_timeout(timeout))

    # -- cancellation -----------------------------------------------------
    def cancel(self) -> None:
        """Cooperatively cancel: queued work is shed at admission, in-flight
        decode stops at the next token boundary."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    # -- polling ----------------------------------------------------------
    @property
    def finite(self) -> bool:
        """Whether this budget can ever abort (deadline set or cancellable —
        a cancel token always makes it worth polling)."""
        return True

    def expired(self) -> bool:
        return self.deadline.expired()

    def should_abort(self) -> bool:
        return self._cancelled.is_set() or self.deadline.expired()

    def remaining(self) -> float:
        return self.deadline.remaining()

    def error(self, stage: str = "") -> Exception:
        """The typed error describing WHY this budget aborted (cancel wins:
        it is the caller's explicit signal, deadline expiry is incidental)."""
        where = f" at {stage}" if stage else ""
        if self._cancelled.is_set():
            return RequestCancelledError(f"request cancelled{where}")
        return RequestTimeoutError(
            f"request deadline exceeded{where} (budget expired)"
        )

    def check(self, stage: str = "") -> None:
        """Raise the typed error if the budget is spent; no-op otherwise."""
        if self.should_abort():
            raise self.error(stage)
