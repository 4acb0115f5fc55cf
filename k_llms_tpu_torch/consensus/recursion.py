"""Recursive alignment and the type-directed consensus dispatcher.

Behavioral spec in `k_llms/utils/consensus_utils.py`:
``exists_nested_lists`` :433-455, ``recursive_list_alignments`` :458-613 (walk
dicts per-key and lists per-position, returning aligned values plus key-mapping
paths back to original source positions), ``consensus_dict`` :1269-1306,
``consensus_list`` :1309-1352, and the dispatcher ``consensus_values``
:1376-1454 (str/bool with every value under 3 words => voting; dict => field
recursion with ``parent_valid_frac`` scaled by the dict-typed fraction; list =>
element-wise recursion; else primitive consensus). Pinned by the differential
oracle; structured here as a dispatcher plus per-shape descent helpers.

Signature change vs the reference: similarity flows through a
:class:`SimilarityScorer` (and optional ``llm_consensus_fn``) rather than an
OpenAI-embeddings callback plus client.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


def _copy_tree(v: Any) -> Any:
    """deepcopy fast path for parsed-JSON trees (dict/list/tuple/scalars).

    deepcopy's generic machinery (memo dict, reductor dispatch) measured ~2.6 ms
    per warm n=32 consolidation; parsed contents are almost always plain JSON,
    which this covers directly. Exotic nodes fall back to copy.deepcopy.
    """
    t = type(v)
    if t is dict:
        return {k: _copy_tree(x) for k, x in v.items()}
    if t is list:
        return [_copy_tree(x) for x in v]
    if t is tuple:
        return tuple(_copy_tree(x) for x in v)
    if v is None or t in (str, int, float, bool):
        return v
    return deepcopy(v)

from .alignment import lists_alignment
from .primitive import LlmConsensusFn, consensus_as_primitive
from .settings import SPECIAL_FIELD_PREFIXES, ConsensusSettings
from .similarity import SimilarityScorer
from .voting import voting_consensus

PathMap = Dict[str, List[Optional[str]]]


def exists_nested_lists(values: List[Any]) -> bool:
    """True if any value is a list, or a dict containing nested lists."""
    return any(
        isinstance(v, list)
        or (isinstance(v, dict) and exists_nested_lists(list(v.values())))
        for v in values
    )


def _aligned_path(prefix: str, pos: int, leaf: str) -> str:
    base = f"{prefix}.{pos}" if prefix else str(pos)
    return f"{base}.{leaf}" if leaf else base


def _source_path(prefix: str, pos: int, leaf: str):
    # Quirk kept for parity: with no prefix and no leaf the reference leaves the
    # position as a bare int, so root-level scalar lists map to ints not strings.
    base = f"{prefix}.{pos}" if prefix else pos
    return f"{base}.{leaf}" if leaf else base


def _descend_keys(
    values: List[Any],
    scorer: SimilarityScorer,
    min_support_ratio: float,
    max_novelty_ratio: float,
    prefix: str,
    reference_idx: Optional[int],
    refinement_rounds: int = 0,
) -> Tuple[List[Any], PathMap]:
    """Per-key recursion over dict samples (Nones become empty shells; every
    output dict carries the full key union, in sorted order)."""
    shells = [v if isinstance(v, dict) else {} for v in values]
    keys = sorted({k for d in shells for k in d})
    mappings: PathMap = {}
    for key in keys:
        column, sub = recursive_list_alignments(
            [d.get(key) for d in shells],
            scorer,
            min_support_ratio,
            max_novelty_ratio=max_novelty_ratio,
            current_path=f"{prefix}.{key}" if prefix else key,
            reference_idx=reference_idx,
            refinement_rounds=refinement_rounds,
        )
        for shell, aligned in zip(shells, column):
            shell[key] = aligned
        mappings.update(sub)
    return [{k: d.get(k) for k in keys} for d in shells], mappings


def _descend_positions(
    values: List[Any],
    scorer: SimilarityScorer,
    min_support_ratio: float,
    max_novelty_ratio: float,
    prefix: str,
    reference_idx: Optional[int],
    refinement_rounds: int = 0,
) -> Tuple[List[Any], PathMap]:
    """Structural alignment of list samples, then per-column recursion with the
    path map rewritten through each sample's pre-alignment positions."""
    rows = [v if isinstance(v, list) else [] for v in values]
    sources: List[List[Optional[int]]] = [[None] * len(r) for r in rows]
    if any(rows):
        rows, sources = lists_alignment(
            rows,
            scorer.generic,
            min_support_ratio=min_support_ratio,
            max_novelty_ratio=max_novelty_ratio,
            reference_list_idx=reference_idx,
            refinement_rounds=refinement_rounds,
        )
    else:
        rows = [[] for _ in rows]

    mappings: PathMap = {}
    width = len(rows[0]) if rows else 0
    for col in range(width):
        aligned_col, sub = recursive_list_alignments(
            [r[col] for r in rows],
            scorer,
            min_support_ratio,
            max_novelty_ratio=max_novelty_ratio,
            current_path="",
            reference_idx=reference_idx,
            refinement_rounds=refinement_rounds,
        )
        for r, v in zip(rows, aligned_col):
            r[col] = v
        for leaf, per_sample in sub.items():
            rewritten: List[Optional[str]] = []
            for r_idx, leaf_val in enumerate(per_sample):
                origin = sources[r_idx][col]
                if origin is None or leaf_val is None:
                    rewritten.append(None)
                else:
                    rewritten.append(_source_path(prefix, origin, leaf_val))
            mappings[_aligned_path(prefix, col, leaf)] = rewritten
    if width == 0 and prefix:  # empty root paths are not supported
        mappings[prefix] = [prefix] * len(values)
    return rows, mappings


def recursive_list_alignments(
    values: List[Any],
    scorer: SimilarityScorer,
    min_support_ratio: float,
    max_novelty_ratio: float = 0.25,
    current_path: str = "",
    reference_idx: Optional[int] = None,
    refinement_rounds: int = 0,
) -> Tuple[List[Any], PathMap]:
    """Recursively align nested dicts/lists across the n samples.

    Returns the aligned values (same outer structure) and a mapping from each
    aligned path to, per sample, the original source path that landed there (or
    None where a sample contributed nothing).
    """
    if not values:
        return values, {}
    if all(v is None for v in values):
        return values, {current_path: [current_path] * len(values)}

    values = _copy_tree(values)  # descent helpers mutate nested structure
    present = [v for v in values if v is not None]
    head = type(present[0])
    uniform = all(isinstance(v, head) for v in present)

    if uniform and head is dict:
        return _descend_keys(
            values, scorer, min_support_ratio, max_novelty_ratio, current_path,
            reference_idx, refinement_rounds,
        )
    if uniform and head is list:
        return _descend_positions(
            values, scorer, min_support_ratio, max_novelty_ratio, current_path,
            reference_idx, refinement_rounds,
        )

    # Scalars and mixed-type levels pass through untouched; a sample maps to the
    # path iff it contributed a value (the designated reference always does).
    return values, {
        current_path: [
            current_path if (v is not None or i == reference_idx) else None
            for i, v in enumerate(values)
        ]
    }


def _subset(
    values: List[Any], weights: Optional[List[float]], keep: Callable[[Any], bool]
) -> Tuple[List[Any], Optional[List[float]]]:
    kept = [v for v in values if keep(v)]
    kept_w = [w for v, w in zip(values, weights) if keep(v)] if weights else None
    return kept, kept_w


def consensus_values(
    values: List[Any],
    consensus_settings: ConsensusSettings,
    scorer: SimilarityScorer,
    parent_valid_frac: float = 1.0,
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
    weights: Optional[List[float]] = None,
) -> Tuple[Any, Union[float, List[Any], Dict[str, Any]]]:
    """Type-directed consensus dispatcher. Returns (value, confidence-structure)."""
    if not values:
        return None, parent_valid_frac
    present = [v for v in values if v is not None]
    if not present:
        return None, 0.0

    # Enum-like str/bool (every value under 3 words) => voting.
    if isinstance(present[0], (str, bool)) and all(
        len(str(v).strip().split()) < 3 for v in present
    ):
        return voting_consensus(
            values,
            consensus_settings,
            parent_valid_frac=parent_valid_frac,
            weights=weights,
            scorer=scorer,
        )

    for shape, handler in ((dict, consensus_dict), (list, consensus_list)):
        if isinstance(present[0], shape):
            kept, kept_w = _subset(values, weights, lambda v: isinstance(v, shape))
            return handler(
                kept,
                consensus_settings,
                scorer,
                parent_valid_frac=parent_valid_frac * len(kept) / len(values),
                llm_consensus_fn=llm_consensus_fn,
                weights=kept_w,
            )

    kept_w = _subset(values, weights, lambda v: v is not None)[1]
    return consensus_as_primitive(
        present,
        consensus_settings,
        scorer,
        parent_valid_frac=parent_valid_frac * len(present) / len(values),
        llm_consensus_fn=llm_consensus_fn,
        weights=kept_w,
    )


def consensus_dict(
    dict_values: List[dict],
    consensus_settings: ConsensusSettings,
    scorer: SimilarityScorer,
    parent_valid_frac: float = 1.0,
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
    weights: Optional[List[float]] = None,
) -> Tuple[dict, Dict[str, Any]]:
    """Field-by-field consensus. Returns (merged_dict, per-field confidences).

    Keys run in first-seen order across samples; reasoning___/source___ fields
    are skipped entirely (:1287-1294)."""
    merged: dict = {}
    confidences: Dict[str, Any] = {}
    for key in dict.fromkeys(k for d in dict_values for k in d):
        if any(marker in key for marker in SPECIAL_FIELD_PREFIXES):
            continue
        merged[key], confidences[key] = consensus_values(
            [d.get(key) for d in dict_values],
            consensus_settings,
            scorer,
            parent_valid_frac=parent_valid_frac,
            llm_consensus_fn=llm_consensus_fn,
            weights=weights,
        )
    return merged, confidences


def consensus_list(
    list_values: List[List[Any]],
    consensus_settings: ConsensusSettings,
    scorer: SimilarityScorer,
    parent_valid_frac: float = 1.0,
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
    weights: Optional[List[float]] = None,
) -> Tuple[List[Any], List[Any]]:
    """Element-wise consensus across aligned lists (position i votes with
    position i; short lists contribute None)."""
    width = max((len(lst) for lst in list_values), default=0)
    out: List[Any] = []
    confidences: List[Any] = []
    for col in range(width):
        value, conf = consensus_values(
            [lst[col] if col < len(lst) else None for lst in list_values],
            consensus_settings,
            scorer,
            parent_valid_frac=parent_valid_frac,
            llm_consensus_fn=llm_consensus_fn,
            weights=weights,
        )
        out.append(value)
        confidences.append(conf)
    return out, confidences


def intermediary_consensus_cleanup(obj):
    """Strip empty strings/dicts/lists recursively, collapsing emptied
    containers to None. Spec: ``intermediary_consensus_cleanup``,
    `k_llms/utils/consensus_utils.py:1355-1370`."""
    if isinstance(obj, dict):
        kept = {
            k: v
            for k, v in ((k, intermediary_consensus_cleanup(v)) for k, v in obj.items())
            if v is not None
        }
        return kept or None
    if isinstance(obj, (list, tuple)):
        kept = [v for v in map(intermediary_consensus_cleanup, obj) if v is not None]
        return kept or None
    if isinstance(obj, str):
        return obj.strip() or None
    return obj
