"""Key-based recursive alignment engine.

Behavioral spec: `k_llms/utils/key_based_alignment.py` —
``_get_key_tuple`` :47-68 (matches on RAW values; only key *selection*
normalizes), ``_align_lists_by_key`` :71-151 (row order from the longest
source, then remaining keys sorted), the recursive merge :156-347 (zip fallback
for scalar lists :324-345), per-source view projection :474-516, and the public
``recursive_align`` :350-431 whose signature matches the similarity aligner so
it can swap in at the documented point (`consolidation.py:22`). Pinned by the
differential oracle in ``tests/test_keyalign.py``.

Design notes: the two row producers (key-tuple alignment and positional zip)
emit a common (row_values, row_positions) plan consumed by one shared merge
loop; source catalogs are first-occurrence dicts rather than parallel
index/set bookkeeping; key selection catches only ``ValueError`` (a missing
key is expected — anything else is a real bug and surfaces).
"""

from __future__ import annotations

import logging
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .fuzzy import select_best_keys_with_fuzzy_fallback
from .selection import CascadeConfig, _walk, select_best_keys

logger = logging.getLogger(__name__)

PathMap = Dict[str, List[Optional[str]]]
RowPlan = Iterable[Tuple[List[Any], List[Optional[int]]]]


def _get_key_tuple(obj: Dict[str, Any], paths: Tuple[str, ...]) -> Optional[Tuple[Any, ...]]:
    """Raw (un-normalized) key tuple; None if any component is missing, None,
    or a container."""
    parts = [_walk(obj, p) for p in paths]
    if any(v is None or isinstance(v, (dict, list)) for v in parts):
        return None
    return tuple(parts)


def _catalog(source: Any, key_paths: Tuple[str, ...]) -> Dict[Tuple[Any, ...], int]:
    """Key tuple -> first occurrence index for one source list (non-lists and
    non-dict items contribute nothing)."""
    out: Dict[Tuple[Any, ...], int] = {}
    if isinstance(source, list):
        for i, item in enumerate(source):
            if isinstance(item, dict):
                key = _get_key_tuple(item, key_paths)
                if key is not None:
                    out.setdefault(key, i)
    return out


def _align_lists_by_key(
    sources: Sequence[Optional[List[Dict[str, Any]]]], key_paths: Tuple[str, ...]
) -> Tuple[List[List[Optional[Dict[str, Any]]]], List[List[Optional[int]]]]:
    """Rows = key tuples (ordered by the longest source list, then sorted
    leftovers); columns = sources. Returns (aligned_rows, original_indices)."""
    if not any(sources):
        return [], []

    catalogs = [_catalog(src, key_paths) for src in sources]
    anchor = max(
        range(len(sources)),
        key=lambda i: len(sources[i]) if isinstance(sources[i], list) else 0,
    )
    order = list(catalogs[anchor])  # the anchor's first-occurrence order
    order += sorted({k for c in catalogs for k in c} - set(order))

    rows: List[List[Optional[Dict[str, Any]]]] = []
    positions: List[List[Optional[int]]] = []
    for key in order:
        where = [c.get(key) for c in catalogs]
        rows.append([src[i] if i is not None else None for i, src in zip(where, sources)])
        positions.append(where)
    return rows, positions


def _select_key_paths(
    lists: List[List[Any]], cascade_cfg: CascadeConfig
) -> Optional[Tuple[str, ...]]:
    """Standard selection (composite-aware) first; fuzzy preferred when it
    improves stability; fuzzy-only as last resort."""
    wrapped = [{"items": lst} for lst in lists]

    def fuzzy_comparison():
        return select_best_keys_with_fuzzy_fallback(
            wrapped,
            cascade_cfg=cascade_cfg,
            list_key="items",
            fuzzy_numeric_round_decimals=2,
            enable_fuzzy_fallback=True,
            prefer_fuzzy_if_better=True,
        )

    try:
        picked = select_best_keys(wrapped, list_key="items", cascade_cfg=cascade_cfg)
    except ValueError:
        # No exact key at all — fuzzy canonicalization is the last resort.
        try:
            comparison = fuzzy_comparison()
        except ValueError:
            logger.debug("key-select: no key found")
            return None
        winner = (
            comparison.fuzzy_best if comparison.chosen == "fuzzy" else comparison.normal_best
        )
        return winner.path if winner is not None else None

    exact = picked.best_single
    if (
        picked.best_composite is not None
        and picked.best_composite.score_tuple > exact.score_tuple
    ):
        exact = picked.best_composite
    try:
        comparison = fuzzy_comparison()
        if comparison.chosen == "fuzzy" and comparison.fuzzy_best is not None:
            logger.debug("key-select: fuzzy path %s", comparison.fuzzy_best.path)
            return comparison.fuzzy_best.path
    except ValueError:
        pass
    logger.debug("key-select: standard path %s", exact.path)
    return exact.path


def _merge_rows(
    plan: RowPlan, origins: Sequence[Optional[str]], cascade_cfg: CascadeConfig
) -> Tuple[List[Any], PathMap]:
    """Merge each planned row and collect its mapping under the row index."""
    merged: List[Any] = []
    mapping: PathMap = {}
    for i, (row, where) in enumerate(plan):
        row_origins = [
            None if (p is None or q is None) else (f"{p}.{q}" if p else str(q))
            for p, q in zip(origins, where)
        ]
        item, sub = _merge_column(row, row_origins, cascade_cfg)
        merged.append(item)
        for leaf, srcs in sub.items():
            mapping[f"{i}.{leaf}" if leaf else str(i)] = srcs
    return merged, mapping


def _merge_column(
    values: Sequence[Any],
    origins: Sequence[Optional[str]],
    cascade_cfg: CascadeConfig,
) -> Tuple[Any, PathMap]:
    """One merged aligned structure + mapping from aligned paths to per-source
    original paths."""
    present = [v for v in values if v is not None]
    if not present:
        return None, {}
    head = type(present[0])

    # Scalars / mixed types: first non-null value represents the column, and
    # every source keeps its inherited path (contributing or not).
    if head not in (dict, list) or not all(isinstance(v, head) for v in present):
        return deepcopy(present[0]), {"": list(origins)}

    if head is dict:
        shells = [v if isinstance(v, dict) else {} for v in values]
        merged: Dict[str, Any] = {}
        mapping: PathMap = {}
        for key in sorted({k for d in shells for k in d}):
            child_origins = [
                None if p is None else (f"{p}.{key}" if p else key) for p in origins
            ]
            merged[key], sub = _merge_column(
                [d.get(key) for d in shells], child_origins, cascade_cfg
            )
            for leaf, srcs in sub.items():
                mapping[f"{key}.{leaf}" if leaf else key] = srcs
        return merged, mapping

    rows = [v if isinstance(v, list) else [] for v in values]
    uniform_dicts = all(isinstance(item, dict) for lst in rows if lst for item in lst)
    if uniform_dicts:
        key_paths = _select_key_paths(rows, cascade_cfg)
        if key_paths:
            aligned, positions = _align_lists_by_key(rows, key_paths)
            return _merge_rows(zip(aligned, positions), origins, cascade_cfg)

    # Positional zip for scalar lists / failed key selection. NB the position
    # gate reads len(values[j]) — the raw value, not the list-coerced one —
    # faithfully to the spec (:332).
    logger.debug("key-align: zip fallback")
    width = max((len(lst) for lst in rows), default=0)
    plan = (
        (
            [lst[i] if i < len(lst) else None for lst in rows],
            [
                # len(values[j]) must stay unevaluated for non-contributing
                # sources (the spec only touches it under `p is not None`).
                None
                if origins[j] is None
                else (i if i < len(values[j]) else None)
                for j in range(len(values))
            ],
        )
        for i in range(width)
    )
    return _merge_rows(plan, origins, cascade_cfg)


def _lookup(root: Any, path: Optional[str]) -> Any:
    """Dot-path lookup with integer list indices; '' is the root."""
    if path is None:
        return None
    node = root
    for token in path.split("."):
        if token == "":
            continue
        try:
            i = int(token)
        except ValueError:
            i = None
        if i is not None:
            # Numeric tokens only ever index lists; a dict with a numeric
            # string key is unreachable through them.
            if not (isinstance(node, list) and 0 <= i < len(node)):
                return None
            node = node[i]
        elif isinstance(node, dict) and token in node:
            node = node[token]
        else:
            return None
    return node


def _project(
    aligned_node: Any,
    key_mappings: PathMap,
    source_idx: int,
    current_path: str,
    source_root: Any,
) -> Any:
    """Project the merged structure back into one source's values via the
    path mappings (None where that source contributed nothing)."""
    if isinstance(aligned_node, dict):
        items = aligned_node.items()
    elif isinstance(aligned_node, list):
        items = enumerate(aligned_node)
    else:
        routed = key_mappings.get(current_path)
        if routed is not None and 0 <= source_idx < len(routed):
            return _lookup(source_root, routed[source_idx])
        return deepcopy(aligned_node)

    def child(token):
        return f"{current_path}.{token}" if current_path else str(token)

    projected = (
        (k, _project(v, key_mappings, source_idx, child(k), source_root)) for k, v in items
    )
    if isinstance(aligned_node, dict):
        return dict(projected)
    return [v for _, v in projected]


def recursive_align(
    values: Sequence[Any],
    string_similarity_method: str = "levenshtein",
    min_support_ratio: float = 0.5,
    max_novelty_ratio: float = 0.25,
    current_path: str = "",
    reference_idx: Optional[int] = None,
    min_uniqueness: Optional[float] = None,
    min_coverage: Optional[float] = None,
) -> Tuple[Sequence[Any], PathMap]:
    """Key-based recursive alignment with the similarity aligner's API.

    ``string_similarity_method``/``max_novelty_ratio``/``reference_idx`` are
    accepted for signature parity (the reference ignores them too).
    """
    if not values:
        return list(values), {}
    if all(v is None for v in values):
        return list(values), {current_path: [current_path] * len(values)}

    cascade_cfg = CascadeConfig(
        min_coverage=min_support_ratio if min_coverage is None else min_coverage,
        min_uniqueness=0.5 if min_uniqueness is None else min_uniqueness,
    )

    merged, mapping = _merge_column(values, [current_path] * len(values), cascade_cfg)

    views: List[Any] = []
    for idx, root in enumerate(values):
        if isinstance(root, dict):
            wrapped: Any = root
        elif isinstance(root, list):
            wrapped = {"items": root}
            # NB spec parity: the "items." rewrite mutates the shared mapping
            # inside the source loop (:398-400), so list-valued roots with
            # multiple sources double-prefix. The wired swap point only ever
            # passes dict roots, where this path is never taken.
            if mapping:
                mapping = {(f"items.{k}" if k else "items"): v for k, v in mapping.items()}
        else:
            wrapped = {}
        views.append(
            _project(merged, mapping, idx, current_path="", source_root=wrapped)
        )

    if not current_path:
        return views, mapping
    rebased: PathMap = {}
    for key, paths in mapping.items():
        rebased[f"{current_path}.{key}" if key else current_path] = [
            current_path if not p else f"{current_path}.{p}" for p in paths
        ]
    return views, rebased
