"""Vote-based (enum-like) consensus.

Parity target: ``voting_consensus`` at
`k_llms/utils/consensus_utils.py:936-982`. Most-common non-null
value wins; booleans treat None as False; strings vote under their sanitized form
but the winner is reported in its original spelling (first occurrence). Confidence
is ``parent_valid_frac * count/total`` rounded to 5 decimals.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple, Union

from .settings import ConsensusSettings
from .text import sanitize_value

__all__ = ["voting_consensus", "sanitize_value", "vote_memo_key"]


def vote_memo_key(
    values: list,
    consensus_settings: ConsensusSettings,
) -> Optional[tuple]:
    """Memo key for an unweighted vote column, or None when not memo-safe.

    Only columns of str/bool/None are keyed: ``hash(True) == hash(1)``, so a
    bare value tuple would alias bool and numeric columns. The stored payload
    is ``(best_val, best_count)``; confidence is recomputed at lookup because
    ``parent_valid_frac`` varies by call site.
    """
    if not all(v is None or isinstance(v, (str, bool)) for v in values):
        return None
    return (
        tuple(values),
        bool(consensus_settings.allow_none_as_candidate),
        bool(consensus_settings.effective_canonical_spelling),
    )


def voting_consensus(
    values: list[Union[str, bool, None]],
    consensus_settings: ConsensusSettings,
    parent_valid_frac: float = 1.0,
    weights: Optional[list[float]] = None,
    scorer=None,
) -> Tuple[Optional[Union[str, bool]], float]:
    """``weights`` (strictly-additional extension): per-sample vote weights —
    the likelihood-weighted mode derives them from sequence logprobs. With
    weights None every sample votes 1.0, bit-identical to the reference.

    ``scorer`` (optional) supplies the vote memo table (and, on the device
    path, votes precomputed in one batched kernel call land in that same
    table keyed by :func:`vote_memo_key`)."""
    total_values = len(values)

    if not any(v is not None for v in values):
        return (None, parent_valid_frac)

    cache = getattr(scorer, "_vote_cache", None) if weights is None else None
    key = vote_memo_key(values, consensus_settings) if cache is not None else None
    if key is not None:
        hit = cache.get(key)
        if hit is not None:
            best_val, best_count = hit
            confidence = parent_valid_frac * (best_count / float(total_values))
            return (best_val, round(confidence, 5))

    if weights is None:
        w = [1.0] * total_values
        total_weight = float(total_values)
    else:
        w = list(weights)
        total_weight = sum(w) or 1.0

    first_non_none = next((v for v in values if v is not None), None)
    is_boolean = isinstance(first_non_none, bool)

    if is_boolean:
        # For booleans: treat None as False.
        processed_values = [v or False for v in values]
        tallies: Counter = Counter()
        for v, wi in zip(processed_values, w):
            tallies[v] += wi
        best_val, best_count = tallies.most_common(1)[0]
    else:
        if consensus_settings.allow_none_as_candidate:
            valid_values = values
            valid_weights = w
        else:
            valid_values = [v for v in values if v is not None]
            valid_weights = [wi for v, wi in zip(values, w) if v is not None]
        processed_values = [(sanitize_value(v) if v is not None else None) for v in valid_values]
        tallies = Counter()
        for v, wi in zip(processed_values, valid_weights):
            tallies[v] += wi
        best_normalized, best_count = tallies.most_common(1)[0]
        if consensus_settings.effective_canonical_spelling:
            # Default-on (reference_exact turns it off): report the bucket's
            # most common exact spelling (weighted; ties broken by first
            # occurrence).
            spelling: Counter = Counter()
            for v, pv, wi in zip(valid_values, processed_values, valid_weights):
                if pv == best_normalized:
                    spelling[v] += wi
            top = max(spelling.values())
            best_val = next(
                v
                for v, pv in zip(valid_values, processed_values)
                if pv == best_normalized and spelling[v] == top
            )
        else:
            # Report the winner in its original (first-seen) spelling.
            best_val = valid_values[processed_values.index(best_normalized)]

    if key is not None:
        cache.set(key, (best_val, best_count))

    confidence = parent_valid_frac * (best_count / total_weight)
    return (best_val, round(confidence, 5))
