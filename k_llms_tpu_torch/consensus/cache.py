"""Thread-safe TTL caches with hit/miss/eviction accounting.

The reference uses ``cachetools.TTLCache(maxsize=1024, ttl=300)`` behind explicit
locks (`k_llms/utils/consensus_utils.py:620-623`, `:780-794`).
``cachetools`` is not a dependency here, so this is a small lock-internalized
equivalent: LRU eviction at ``maxsize``, entries expire ``ttl`` seconds after insert.

This module is the cache seam for the on-device consensus path: the
device engine's bucketed pair-similarity results, the vote/medoid/numeric memo
tables, and the embedding cache all live in named :class:`TTLCache` instances,
and every instance keeps its own hit/miss/eviction/expiration counters so
``scheduler.stats()`` / ``health()`` and the ``kllms_consensus_*`` gauges on
``/metrics`` can report cache effectiveness without touching entries.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional

from ..analysis.lockcheck import make_lock


class TTLCache:
    """Minimal thread-safe TTL + LRU cache with stats counters."""

    def __init__(self, maxsize: int = 1024, ttl: float = 300.0, name: Optional[str] = None):
        self.maxsize = maxsize
        self.ttl = ttl
        self.name = name
        self._data: OrderedDict[Hashable, tuple[float, Any]] = OrderedDict()
        self._lock = make_lock(
            f"consensus.cache.{name}" if name else "consensus.cache"
        )
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._expirations = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        now = time.monotonic()
        with self._lock:
            item = self._data.get(key)
            if item is None:
                self._misses += 1
                return default
            expires, value = item
            if expires < now:
                del self._data[key]
                self._expirations += 1
                self._misses += 1
                return default
            self._data.move_to_end(key)
            self._hits += 1
            return value

    def set(self, key: Hashable, value: Any) -> None:
        now = time.monotonic()
        with self._lock:
            self._data[key] = (now + self.ttl, value)
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> Dict[str, Any]:
        """Point-in-time counters (entries counts only unexpired items)."""
        with self._lock:
            now = time.monotonic()
            return {
                "entries": sum(1 for exp, _ in self._data.values() if exp >= now),
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "expirations": self._expirations,
                "maxsize": self.maxsize,
            }

    def __len__(self) -> int:
        with self._lock:
            now = time.monotonic()
            return sum(1 for exp, _ in self._data.values() if exp >= now)

    def __contains__(self, key: Hashable) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel
