"""Flight recorder: a bounded ring buffer of finished request records.

Every finished trace (completed or failed) lands here as a plain dict —
trace_id, route, n, status, phase durations, and the recovery/quarantine
annotations the PR-13 fault domains stamp on the trace. The ring is the
post-incident "what were the last N requests doing" view served at
``GET /debug/requests`` (off by default; ``BackendConfig.debug_endpoints``).

Bounded by design: a deque with ``maxlen`` so sustained traffic costs O(1)
memory and the recorder can never be the thing that falls over during the
incident it exists to explain.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, List, Optional

from ..analysis.lockcheck import make_lock

#: Default ring capacity: enough recent history to cover a watchdog rebuild
#: plus the traffic around it, small enough to be always-on.
DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Thread-safe bounded ring of request records (newest kept)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be positive")
        self._lock = make_lock("observability.flight")
        self.capacity = capacity
        self._ring: Deque[Dict[str, Any]] = collections.deque(maxlen=capacity)
        self._total = 0

    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(dict(rec))
            self._total += 1

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-first copies of the held records."""
        with self._lock:
            items = [dict(r) for r in self._ring]
        items.reverse()
        return items[:limit] if limit is not None else items

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "held": len(self._ring),
                "recorded_total": self._total,
            }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total = 0


#: Process-wide flight recorder the tracer writes into.
FLIGHT_RECORDER = FlightRecorder()
