"""Key-based latent aligner.

Deterministic alternative to the similarity aligner: lists of JSON records are
aligned by the best-scoring scalar "join key" (single or composite) instead of
pairwise similarity. Parity targets: `k_llms/utils/
key_selection.py`, `fuzzy_key_selection.py`, `key_based_alignment.py`. The
public ``recursive_align`` keeps the documented swap-point signature
(`k_llms/utils/consolidation.py:22`).

Structural difference vs the reference: the standard and fuzzy cascades are ONE
parametrized funnel (the reference duplicates ~60 lines); behavior is
differential-tested identical.
"""

from .selection import (
    CascadeConfig,
    KeyMetrics,
    KeySelectionResult,
    discover_scalar_paths,
    iter_records,
    select_best_keys,
)
from .fuzzy import SelectionComparison, select_best_keys_with_fuzzy_fallback
from .align import recursive_align

__all__ = [
    "CascadeConfig",
    "KeyMetrics",
    "KeySelectionResult",
    "SelectionComparison",
    "discover_scalar_paths",
    "iter_records",
    "select_best_keys",
    "select_best_keys_with_fuzzy_fallback",
    "recursive_align",
]
