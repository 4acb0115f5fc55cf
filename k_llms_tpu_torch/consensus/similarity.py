"""Generic value similarity with a pluggable embedding provider.

Parity targets in `k_llms/utils/consensus_utils.py`:
``_cosine_similarity`` :626-649, ``string_similarity`` :797-824 (TTL-cached,
embeddings gated on both strings > 50 chars, Levenshtein fallback on any failure),
``numerical_similarity`` :827-841, ``dict_similarity`` :844-869 (skips
reasoning___/source___ keys), ``list_similarity`` :872-889 (positional mean),
``generic_similarity`` :892-917 (both-falsy => 1.0, single None => 1e-8 floor).

Design change vs the reference: instead of threading a raw
``sync_get_openai_embeddings_from_text`` callable through every function, similarity
state (method + embedding provider + caches) lives in one :class:`SimilarityScorer`.
The TPU backend plugs in on-device mean-pooled hidden-state embeddings; tests plug
in deterministic fakes. The reference's module-global TTL caches become per-scorer
(same 1024/300s policy, thread-safe).
"""

from __future__ import annotations

import functools
import logging
import math
import re
from typing import Any, Callable, List, Optional, Protocol

import numpy as np

from .cache import TTLCache
from .settings import (
    IGNORED_KEY_PATTERNS,
    SIMILARITY_SCORE_LOWER_BOUND,
    StringSimilarityMethod,
)
from .text import hamming_similarity, jaccard_similarity, levenshtein_similarity

logger = logging.getLogger(__name__)

EmbeddingFn = Callable[[List[str]], List[List[float]]]

NumericalPrimitive = (int, float)


@functools.lru_cache(maxsize=4096)
def _key_ignored(k: str) -> bool:
    """Memoized reasoning___/source___ key-skip check: dict similarity runs it
    per key per PAIR, which made re.match a measured hot spot at n=32."""
    return any(re.match(p, k) for p in IGNORED_KEY_PATTERNS)


class _Unfreezable(Exception):
    """Value cannot be turned into a hashable memo key (exotic type / too big)."""


def _freeze(v: Any, counter: List[int]) -> Any:
    """Hashable structural snapshot of a JSON-ish value, for memo keys.

    Bools are type-tagged because ``hash(True) == hash(1)`` would otherwise
    alias bool and int keys. Leaf budget (``counter``) bounds key-build cost so
    pathological payloads skip the memo instead of paying O(tree) per lookup.
    """
    counter[0] -= 1
    if counter[0] < 0:
        raise _Unfreezable
    if isinstance(v, bool):
        return ("b", v)
    if v is None or isinstance(v, (str, int, float)):
        return v
    if isinstance(v, dict):
        try:
            items = sorted(v.items())
        except TypeError as e:  # non-sortable keys
            raise _Unfreezable from e
        return ("d", tuple((k, _freeze(val, counter)) for k, val in items))
    if isinstance(v, (list, tuple)):
        return ("l", tuple(_freeze(x, counter) for x in v))
    raise _Unfreezable


def freeze_key(v: Any, budget: int = 256) -> Optional[Any]:
    """Public memo-key helper: hashable snapshot of ``v`` or None if unsuitable."""
    try:
        return _freeze(v, [budget])
    except _Unfreezable:
        return None


def collect_strings(value: Any, acc: Optional[List[str]] = None) -> List[str]:
    """All string leaves in a parsed-content tree (for embedding prefetch)."""
    if acc is None:
        acc = []
    if isinstance(value, str):
        acc.append(value)
    elif isinstance(value, dict):
        for v in value.values():
            collect_strings(v, acc)
    elif isinstance(value, (list, tuple)):
        for v in value:
            collect_strings(v, acc)
    return acc

# Embeddings are only worth the trip for long strings (reference :813).
EMBEDDING_MIN_CHARS = 50


def cosine_similarity(vec1: List[float], vec2: List[float]) -> float:
    """Cosine similarity normalized from [-1,1] to [0,1] and floored at 1e-8."""
    arr1 = np.asarray(vec1, dtype=np.float64)
    arr2 = np.asarray(vec2, dtype=np.float64)
    if arr1.shape != arr2.shape:
        raise ValueError("Vectors must have the same shape for cosine similarity")
    norm1 = np.linalg.norm(arr1)
    norm2 = np.linalg.norm(arr2)
    if norm1 == 0 or norm2 == 0:
        return SIMILARITY_SCORE_LOWER_BOUND
    similarity = float(np.dot(arr1, arr2) / (norm1 * norm2))
    similarity = 0.5 * (similarity + 1.0)
    return float(np.clip(similarity, SIMILARITY_SCORE_LOWER_BOUND, 1.0))


def numerical_similarity(val1: Any, val2: Any) -> float:
    """Booleans exact; numbers within 1% relative tolerance; else equality."""
    if isinstance(val1, bool) and isinstance(val2, bool):
        return 1.0 if val1 == val2 else SIMILARITY_SCORE_LOWER_BOUND
    if (
        isinstance(val1, NumericalPrimitive)
        and isinstance(val2, NumericalPrimitive)
        and math.isclose(val1, val2, rel_tol=0.01)
    ):
        return 1.0
    return 1.0 if val1 == val2 else SIMILARITY_SCORE_LOWER_BOUND


class EmbeddingProvider(Protocol):
    def __call__(self, texts: List[str]) -> List[List[float]]: ...


class SimilarityScorer:
    """Stateful similarity engine: method dispatch + embedding provider + caches."""

    def __init__(
        self,
        method: StringSimilarityMethod = "embeddings",
        embed_fn: Optional[EmbeddingFn] = None,
        cache_maxsize: int = 1024,
        cache_ttl: float = 300.0,
    ):
        self.method = method
        self.embed_fn = embed_fn
        self._sim_cache = TTLCache(maxsize=cache_maxsize, ttl=cache_ttl, name="similarity")
        self._emb_cache = TTLCache(maxsize=cache_maxsize, ttl=cache_ttl, name="embeddings")
        # Host-path memo tables: repeated identical field
        # values within (and across) consolidations hit these instead of
        # recomputing votes / medoid scans / numeric consensus / container sims.
        self._vote_cache = TTLCache(maxsize=4096, ttl=cache_ttl, name="vote")
        self._medoid_cache = TTLCache(maxsize=4096, ttl=cache_ttl, name="medoid")
        self._numeric_cache = TTLCache(maxsize=4096, ttl=cache_ttl, name="numeric")
        # Whole-alignment memo (lists_alignment): frozen input lists ->
        # source-index table; aligned output is rebuilt from the caller's own
        # objects, so hits preserve the uncached path's aliasing exactly.
        self._align_cache = TTLCache(maxsize=2048, ttl=cache_ttl, name="align")

    # -- consolidation hooks ----------------------------------------------
    def prepare(self, contents: List[Any]) -> None:
        """Pre-alignment hook, called once per consolidation with the parsed
        contents. Host path: batch-prefetch embeddings. The device scorer
        overrides this to additionally build its batched pair-similarity
        session on the chip."""
        self.prefetch_embeddings(collect_strings(contents))

    def prepare_aligned(self, contents: List[Any], consensus_settings: Any) -> None:
        """Post-alignment hook: the device scorer batch-computes majority
        votes for the aligned columns here. Host path: no-op."""

    def cache_stats(self) -> dict:
        """Per-cache counters, keyed by cache name (see TTLCache.stats())."""
        caches = (
            self._sim_cache,
            self._emb_cache,
            self._vote_cache,
            self._medoid_cache,
            self._numeric_cache,
            self._align_cache,
        )
        return {c.name: c.stats() for c in caches}

    # -- embeddings -------------------------------------------------------
    def prefetch_embeddings(self, texts: List[str]) -> None:
        """Batch-embed the long strings that similarity will need and warm the
        cache — turns the engine's lazy per-pair, batch-1 device calls into ONE
        batched forward (big win for n=32 consensus latency)."""
        if self.embed_fn is None or self.method != "embeddings":
            return
        missing, seen = [], set()
        for t in texts:
            if (
                isinstance(t, str)
                and len(t) > EMBEDDING_MIN_CHARS
                and t not in seen
                and self._emb_cache.get(t) is None
            ):
                missing.append(t)
                seen.add(t)
        if not missing:
            return
        try:
            for t, e in zip(missing, self.embed_fn(missing)):
                self._emb_cache.set(t, e)
        except Exception as e:  # lazy path will retry / degrade per pair
            logger.error("embedding prefetch failed", exc_info=e)

    def get_embedding(self, s: str) -> List[float]:
        cached = self._emb_cache.get(s)
        if cached is not None:
            return cached
        if self.embed_fn is None:
            raise RuntimeError("No embedding provider configured")
        result = self.embed_fn([s])[0]
        self._emb_cache.set(s, result)
        return result

    # -- strings ----------------------------------------------------------
    def string(self, s1: str, s2: str) -> float:
        key = (min(s1, s2), max(s1, s2), self.method)
        cached = self._sim_cache.get(key)
        if cached is not None:
            return cached
        result: Optional[float] = None
        if self.method == "jaccard":
            result = jaccard_similarity(s1, s2)
        elif self.method == "hamming":
            result = hamming_similarity(s1, s2)
        elif (
            self.method == "embeddings"
            and len(s1) > EMBEDDING_MIN_CHARS
            and len(s2) > EMBEDDING_MIN_CHARS
            and self.embed_fn is not None
        ):
            try:
                result = cosine_similarity(self.get_embedding(s1), self.get_embedding(s2))
            except Exception as e:  # degrade identically to the reference (:816-817)
                logger.error("Error getting embeddings for %r and %r", s1, s2, exc_info=e)
        if result is None:
            result = levenshtein_similarity(s1, s2)
        self._sim_cache.set(key, result)
        return result

    # -- containers -------------------------------------------------------
    def dict(self, d1: dict, d2: dict) -> float:
        # Sorted union: a raw set iterates in hash order, which varies with
        # PYTHONHASHSEED across processes — the float sum below then rounds
        # differently run to run and downstream threshold/medoid decisions
        # flip (the reference has this instability; determinism wins here).
        all_keys = sorted(set(d1.keys()) | set(d2.keys()))
        all_keys = [k for k in all_keys if not _key_ignored(k)]
        if not all_keys:
            return 1.0
        total = 0.0
        for k in all_keys:
            total += self.generic(d1.get(k), d2.get(k))
        return total / len(all_keys)

    def list(self, l1, l2) -> float:
        max_len = max(len(l1), len(l2))
        if max_len == 0:
            return 1.0
        total = 0.0
        for i in range(max_len):
            v1 = l1[i] if i < len(l1) else None
            v2 = l2[i] if i < len(l2) else None
            total += self.generic(v1, v2)
        return total / max_len

    # -- dispatcher -------------------------------------------------------
    def generic(self, v1: Any, v2: Any) -> float:
        # Both falsy ("" / 0 / [] / False / None) => perfect agreement.
        if not bool(v1) and not bool(v2):
            return 1.0
        if v1 is None or v2 is None:
            return SIMILARITY_SCORE_LOWER_BOUND
        if isinstance(v1, str) and isinstance(v2, str):
            return self.string(v1, v2)
        elif isinstance(v1, NumericalPrimitive) and isinstance(v2, NumericalPrimitive):
            return numerical_similarity(v1, v2)
        elif isinstance(v1, dict) and isinstance(v2, dict):
            key = self._container_pair_key(v1, v2)
            if key is not None:
                cached = self._sim_cache.get(key)
                if cached is not None:
                    return cached
            result = self.dict(v1, v2)
            if key is not None:
                self._sim_cache.set(key, result)
            return result
        elif isinstance(v1, (list, tuple)) and isinstance(v2, (list, tuple)):
            key = self._container_pair_key(v1, v2)
            if key is not None:
                cached = self._sim_cache.get(key)
                if cached is not None:
                    return cached
            result = self.list(v1, v2)
            if key is not None:
                self._sim_cache.set(key, result)
            return result
        else:
            return SIMILARITY_SCORE_LOWER_BOUND

    def _container_pair_key(self, v1: Any, v2: Any):
        """Symmetric memo key for a container pair, or None when not cacheable.

        generic() is symmetric in its arguments (every branch is), so the key
        orders the two frozen halves by hash for a canonical form.
        """
        f1 = freeze_key(v1)
        if f1 is None:
            return None
        f2 = freeze_key(v2)
        if f2 is None:
            return None
        if hash(f2) < hash(f1):
            f1, f2 = f2, f1
        return ("pair", self.method, f1, f2)

    # Convenience constructor used by tests and the alignment internals.
    @classmethod
    def levenshtein(cls) -> "SimilarityScorer":
        return cls(method="levenshtein")
