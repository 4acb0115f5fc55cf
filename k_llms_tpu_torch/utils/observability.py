"""Event counters: the one piece of the JAX package's observability module
that the copied host layers call (consolidation records
``consensus.zero_survivors``). Tracing, histograms and the kernel dispatch
counters stay in the JAX package; the port's kernels keep their own launch
counts on their wrappers (``ops/_ext.py``)."""

from __future__ import annotations

from typing import Dict

from .locks import make_lock


class EventCounters:
    """Thread-safe named counters."""

    def __init__(self) -> None:
        self._lock = make_lock("observability.counters")
        self._counts: Dict[str, int] = {}

    def record(self, event: str, n: int = 1) -> None:
        with self._lock:
            self._counts[event] = self._counts.get(event, 0) + n


FAILURE_EVENTS = EventCounters()
