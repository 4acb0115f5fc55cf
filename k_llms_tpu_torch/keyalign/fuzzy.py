"""Fuzzy key selection: canonicalized scalars (rounded numerics, normalized
strings), preferred over standard selection iff stability strictly improves.

Behavioral spec: `k_llms/utils/fuzzy_key_selection.py` —
canonicalization :37-52, fuzzy cascade :100-157 (served here by the shared
parametrized funnel in selection.py), comparison/decision :175-232 — pinned by
the differential oracle in ``tests/test_keyalign.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional

from . import selection
from .selection import CascadeConfig, KeyMetrics


def canonicalize_scalar(value: Any, numeric_round_decimals: int = 2) -> Any:
    """Numbers rounded to N decimals; strings lower/trim/collapse; rest as-is."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        try:
            quantized = round(float(value), numeric_round_decimals)
        except Exception:
            quantized = value
        return quantized
    return selection.normalize_scalar(value)


@dataclass(frozen=True)
class SelectionComparison:
    """Which strategy won: "normal" | "fuzzy"."""

    normal_best: Optional[KeyMetrics] = None
    fuzzy_best: Optional[KeyMetrics] = None
    chosen: str = "normal"


def select_best_keys_with_fuzzy_fallback(
    extractions: List[Dict[str, Any]],
    cascade_cfg: CascadeConfig = CascadeConfig(),
    list_key: Optional[str] = None,
    fuzzy_numeric_round_decimals: int = 2,
    enable_fuzzy_fallback: bool = True,
    prefer_fuzzy_if_better: bool = True,
) -> SelectionComparison:
    """Run both selectors and pick one: exact wins unless fuzzy exists and
    strictly improves the stability tuple (or exact failed entirely)."""

    def attempt(run):
        try:
            return run()
        except ValueError:
            return None

    exact = attempt(
        lambda: selection.select_best_keys(
            extractions, cascade_cfg=cascade_cfg, list_key=list_key
        ).best_single
    )

    fuzzy = None
    if enable_fuzzy_fallback:
        paths = selection.discover_scalar_paths(extractions, list_key=list_key)
        if paths:
            fuzzy = attempt(
                lambda: selection.cascade_select_keys(
                    extractions,
                    paths,
                    cascade_cfg,
                    list_key=list_key,
                    canonicalize=partial(
                        canonicalize_scalar, numeric_round_decimals=fuzzy_numeric_round_decimals
                    ),
                ).final_best
            )

    if exact is None and fuzzy is None:
        raise ValueError("No keys pass Stage 0 (normal or fuzzy)")
    if exact is None:
        return SelectionComparison(fuzzy_best=fuzzy, chosen="fuzzy")
    if fuzzy is None:
        return SelectionComparison(normal_best=exact)
    take_fuzzy = prefer_fuzzy_if_better and fuzzy.stability > exact.stability
    return SelectionComparison(
        normal_best=exact, fuzzy_best=fuzzy, chosen="fuzzy" if take_fuzzy else "normal"
    )
