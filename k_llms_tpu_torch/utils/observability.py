"""Event counters: the piece of the JAX package's observability module that
the port's copied host layers call (consolidation records
``consensus.zero_survivors``; the grammar compiler records the
``GRAMMAR_EVENTS`` family; the checkpoint loader counts rejected loads in
``QUARANTINE_EVENTS``). Tracing, histograms and the kernel dispatch
counters stay in the JAX package; the port's kernels keep their own launch
counts on their wrappers (``ops/_ext.py``)."""

from __future__ import annotations

import fnmatch
from typing import Dict, Optional, Sequence, Tuple

from .locks import make_lock


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

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


FAILURE_EVENTS = EventCounters()

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

#: Numeric-integrity counters, the JAX package's names: corrupted
#: checkpoints rejected at load count ``quarantine.checksum_failures``.
QUARANTINE_EVENTS = EventCounters(declared=(
    "quarantine.samples",
    "quarantine.launches",
    "quarantine.checksum_failures",
))
