"""Primitive (non-enum) consensus: llm-consensus strings, hybrid numeric
clustering, and the similarity-medoid fallback.

Behavioral spec: ``consensus_as_primitive`` at
`k_llms/utils/consensus_utils.py:1075-1237` — every threshold,
rounding (5 decimals), and tie-break key is kept bit-compatible and pinned by
the differential oracle. The implementation is vectorized: sorted values are
segmented into clusters with one boolean gap vector, and the tied-cluster
support tie-break evaluates all three closeness predicates (direct, sign-less,
power-of-10) as broadcast matrices over cluster centers rather than scanning
pairs. The llm-consensus string mode takes a caller-supplied
``llm_consensus_fn`` (the TPU backend routes it to the local model) instead of
the reference's hardcoded OpenAI ``gpt-5-mini`` call (:1026-1048).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from .settings import ConsensusSettings
from .similarity import SimilarityScorer, freeze_key

LlmConsensusFn = Callable[[List[str]], str]


def _pairwise_matrix(values: List[Any], scorer: SimilarityScorer, diag: float) -> np.ndarray:
    """Symmetric generic-similarity matrix with a fixed diagonal."""
    n = len(values)
    sim = np.full((n, n), diag, dtype=float)
    for a in range(n):
        row = sim[a]
        for b in range(a + 1, n):
            row[b] = sim[b, a] = scorer.generic(values[a], values[b])
    return sim


def _close_matrix(a: np.ndarray, b: np.ndarray, rel_eps: float, abs_eps: float) -> np.ndarray:
    """Broadcast |a - b| <= max(abs_eps, rel_eps * max(|a|, |b|, 1))."""
    a = a[:, None]
    b = b[None, :]
    tol = np.maximum(abs_eps, rel_eps * np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0))
    return np.abs(a - b) <= tol


def _segment_sorted(xs: np.ndarray, rel_eps: float, abs_eps: float) -> List[np.ndarray]:
    """Chain-cluster a sorted 1-D array: a new segment starts wherever the gap
    to the previous value exceeds the mixed absolute/relative tolerance."""
    if xs.size == 0:
        return []
    left, right = xs[:-1], xs[1:]
    tol = np.maximum(abs_eps, rel_eps * np.maximum(np.maximum(np.abs(left), np.abs(right)), 1.0))
    breaks = np.flatnonzero(np.abs(right - left) > tol) + 1
    return np.split(xs, breaks)


def _finite_floats(values: List[Any]) -> np.ndarray:
    """The finite numeric payload of ``values`` (bools excluded), sorted."""
    out = []
    for v in values:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            try:
                f = float(v)
            except Exception:
                continue
            if math.isfinite(f):
                out.append(f)
    return np.sort(np.asarray(out, dtype=float))


def _numeric_consensus(
    values: List[Any],
    settings: ConsensusSettings,
    parent_valid_frac: float,
    scorer: Optional[SimilarityScorer] = None,
) -> Tuple[Optional[float], float]:
    """Hybrid numeric consensus with None-aware confidence (spec :1098-1219).

    Pure in ``values``+tolerances except the empty-payload early return (the
    only branch that reads ``parent_valid_frac``), so results are memoized on
    the scorer's numeric cache with that branch stored as a sentinel."""
    cache = getattr(scorer, "_numeric_cache", None)
    key = None
    if cache is not None:
        frozen = freeze_key(values)
        if frozen is not None:
            key = (frozen, settings.rel_eps, settings.abs_eps)
            hit = cache.get(key)
            if hit is not None:
                if hit == "empty":
                    return None, parent_valid_frac
                return hit

    result = _numeric_consensus_uncached(values, settings, parent_valid_frac)
    if key is not None:
        xs_empty = result == (None, parent_valid_frac) and _finite_floats(values).size == 0
        cache.set(key, "empty" if xs_empty else result)
    return result


def _numeric_consensus_uncached(
    values: List[Any], settings: ConsensusSettings, parent_valid_frac: float
) -> Tuple[Optional[float], float]:
    total = len(values)
    none_count = sum(v is None for v in values)

    xs = _finite_floats(values)
    if xs.size == 0:
        return None, parent_valid_frac

    clusters = _segment_sorted(xs, settings.rel_eps, settings.abs_eps)
    sizes = np.array([c.size for c in clusters])
    biggest = int(sizes.max())
    top = max(biggest, none_count)

    if none_count > biggest:
        return None, round(none_count / total, 5)

    # A strict majority, or a unique largest block, decides outright.
    contenders = int((sizes == top).sum()) + (1 if none_count == top else 0)
    if top > total / 2 or contenders == 1:
        if none_count == top:
            return None, round(none_count / total, 5)
        winner = clusters[int(np.argmax(sizes))]
        return float(winner.mean()), round(top / total, 5)

    # Tied largest blocks: rank by cross-cluster support. A candidate absorbs
    # every strictly-smaller cluster whose center is close to its own directly,
    # after dropping signs, or after a power-of-10 shift (common LLM slips).
    centers = np.array([float(np.median(c)) for c in clusters])
    spreads = np.array([float(np.std(c)) if c.size > 1 else 0.0 for c in clusters])
    rel, ae = settings.rel_eps, settings.abs_eps

    near = _close_matrix(centers, centers, rel, ae)
    near |= _close_matrix(np.abs(centers), np.abs(centers), rel, ae)
    shifts = 10.0 ** np.arange(-6, 7)
    nz = centers != 0.0
    for s in shifts:
        shifted = _close_matrix(centers, centers * s, rel, ae)
        near |= shifted & nz[:, None] & nz[None, :]

    absorbable = sizes[None, :] < sizes[:, None]  # [cand, other]
    gained = np.where(near & absorbable, sizes[None, :], 0).sum(axis=1)

    board: List[Tuple[float, int, float, float, int]] = []
    for rank, ci in enumerate(np.flatnonzero(sizes == top)):
        ci = int(ci)
        board.append(
            (
                -(sizes[ci] + gained[ci]),  # total support, descending
                0,  # numeric candidates outrank the None candidate
                float(spreads[ci]),  # tighter cluster wins
                -abs(float(centers[ci])),  # then larger magnitude
                ci,
            )
        )
    if none_count == top:
        board.append((-float(none_count), 1, float("inf"), 0.0, -1))
    board.sort(key=lambda t: t[:4])
    support, _, _, _, idx = board[0]
    if idx < 0:
        return None, round(none_count / total, 5)
    return float(clusters[idx].mean()), round(-support / total, 5)


def _medoid_consensus(
    values: List[Any],
    scorer: SimilarityScorer,
    parent_valid_frac: float,
    canonical_spelling: bool = False,
) -> Tuple[Any, float]:
    """Similarity medoid (spec :1221-1237): the value with the highest mean
    similarity to the others wins; that mean (scaled) is the confidence.

    With ``canonical_spelling`` (default-on, see ConsensusSettings) ties at the
    max mean break toward the most frequent exact value among the tied
    candidates instead of np.argmax's first-index rule — normalized-identical
    case variants stop winning on position."""
    cache = getattr(scorer, "_medoid_cache", None)
    key = None
    if cache is not None:
        frozen = freeze_key(values)
        if frozen is not None:
            key = (frozen, bool(canonical_spelling))
            hit = cache.get(key)
            if hit is not None:
                best_idx, mean = hit
                return values[best_idx], round(parent_valid_frac * mean, 5)
    sim = _pairwise_matrix(values, scorer, diag=np.nan)
    mean_to_others = np.nanmean(sim, axis=1)
    best = int(np.argmax(mean_to_others))
    if canonical_spelling:
        tied = np.flatnonzero(mean_to_others >= mean_to_others[best] - 1e-12)
        if tied.size > 1:
            freq: Counter = Counter(repr(values[i]) for i in tied)
            top = max(freq[repr(values[i])] for i in tied)
            best = int(next(i for i in tied if freq[repr(values[i])] == top))
    if key is not None:
        cache.set(key, (best, float(mean_to_others[best])))
    return values[best], round(parent_valid_frac * float(mean_to_others[best]), 5)


def _looks_numeric(non_none: List[Any]) -> bool:
    """The spec's type gate (:1099): the first value's type default must be an
    int/float instance — for bool that default (False) IS an int, so all-bool
    input takes the numeric branch and returns (None, parent_valid_frac) —
    or every non-None value must be numeric."""
    head_default = type(non_none[0])()
    return isinstance(head_default, (int, float)) or all(
        isinstance(v, (int, float)) for v in non_none
    )


def _weighted_numeric_consensus(
    xs: List[float], ws: List[float], total_weight: float, settings: ConsensusSettings
) -> Tuple[float, float]:
    """Weighted 1-D clustering: cluster mass = sum of member weights; the
    heaviest cluster wins and its weighted mean represents it."""
    order = np.lexsort((ws, xs))
    x = np.asarray(xs, dtype=float)[order]
    w = np.asarray(ws, dtype=float)[order]
    tol = np.maximum(
        settings.abs_eps,
        settings.rel_eps * np.maximum(np.maximum(np.abs(x[:-1]), np.abs(x[1:])), 1.0),
    )
    breaks = np.flatnonzero(np.abs(x[1:] - x[:-1]) > tol) + 1
    seg_x = np.split(x, breaks)
    seg_w = np.split(w, breaks)
    masses = np.array([sw.sum() for sw in seg_w])
    best = int(np.argmax(masses))
    rep = float((seg_x[best] * seg_w[best]).sum() / masses[best])
    return rep, round(float(masses[best]) / total_weight, 5)


def _weighted_medoid(
    values: List[Any], ws: List[float], scorer: SimilarityScorer, parent_valid_frac: float
) -> Tuple[Any, float]:
    """Medoid under weighted mean similarity (self excluded)."""
    sim = _pairwise_matrix(values, scorer, diag=0.0)
    w = np.asarray(ws, dtype=float)
    denom = w.sum() - w  # per-row weight of the others
    weighted = (sim * w[None, :]).sum(axis=1)
    rows = np.divide(weighted, denom, out=np.zeros_like(weighted), where=denom != 0)
    best = int(np.argmax(rows))
    return values[best], round(parent_valid_frac * float(rows[best]), 5)


def consensus_as_primitive(
    values: list[Any],
    consensus_settings: ConsensusSettings,
    scorer: SimilarityScorer,
    parent_valid_frac: float = 1.0,
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
    weights: Optional[List[float]] = None,
) -> Tuple[Any, float]:
    non_none = [v for v in values if v is not None]
    if not non_none:
        return None, parent_valid_frac
    if len(non_none) == 1:
        return non_none[0], parent_valid_frac * (1 / len(values))

    # Strictly-additional likelihood-weighted mode: weighted clustering/medoid.
    # The weights-None path below stays bit-identical to the reference.
    if weights is not None:
        total_weight = sum(weights) or 1.0
        pairs = [
            (float(v), w)
            for v, w in zip(values, weights)
            if isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(float(v))
        ]
        if pairs and _looks_numeric(non_none):
            return _weighted_numeric_consensus(
                [x for x, _ in pairs], [w for _, w in pairs], total_weight, consensus_settings
            )
        nn = [(v, w) for v, w in zip(values, weights) if v is not None]
        if len(nn) >= 2:
            return _weighted_medoid(
                [v for v, _ in nn], [w for _, w in nn], scorer, parent_valid_frac
            )
        # fall through to the unweighted path for degenerate cases

    # (a) llm-consensus string mode — only with embeddings similarity (:1090).
    if (
        type(non_none[0]) is str
        and consensus_settings.string_consensus_method == "llm-consensus"
        and consensus_settings.string_similarity_method == "embeddings"
    ):
        if llm_consensus_fn is None:
            raise ValueError(
                "string_consensus_method='llm-consensus' requires an llm_consensus_fn "
                "(the TPU backend provides one automatically)"
            )
        candidate = llm_consensus_fn(non_none)
        sims = [scorer.generic(candidate, v) for v in non_none]
        return candidate, float(np.nanmean(sims))

    # (b) hybrid numeric consensus with None-aware confidence.
    if _looks_numeric(non_none):
        return _numeric_consensus(values, consensus_settings, parent_valid_frac, scorer=scorer)

    # (c) similarity medoid (strings or other structures).
    return _medoid_consensus(
        values, scorer, parent_valid_frac, consensus_settings.effective_canonical_spelling
    )


def compute_similarity_scores(values: list, scorer: SimilarityScorer) -> list:
    """Per-value mean similarity against all values (self included, at 1.0) —
    scores without electing a winner. Spec: ``compute_similarity_scores``,
    `k_llms/utils/consensus_utils.py:1243-1263`."""
    if not values:
        return []
    if len(values) == 1:
        return [1.0]
    sim = _pairwise_matrix(values, scorer, diag=1.0)
    return [float(round(s, 5)) for s in sim.mean(axis=1)]
