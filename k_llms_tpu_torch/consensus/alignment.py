"""Structural list alignment: dynamic threshold, reference-list election,
Hungarian assignment, support pruning.

Behavioral spec (constants, tie-breaks, thresholds) follows
`k_llms/utils/consensus_utils.py` :109-430 and is pinned by the
differential oracle in ``tests/test_reference_parity.py``; the implementation
here is its own design: every list element gets a row in a flat
:class:`ElementTable` whose dense pairwise-similarity matrix is built once, and
each pipeline stage (threshold estimation, group election, assignment, pruning)
is a masked numpy computation over that matrix instead of nested dict-of-sets
scanning. The Hungarian solve goes through our native C++
(``k_llms_tpu_torch.native``) instead of scipy.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..native import linear_sum_assignment
from .majority import _original_positions, sort_by_original_majority
from .similarity import freeze_key

logger = logging.getLogger(__name__)

Index = Tuple[int, int]  # (list_idx, element_idx)

_BASE_THRESHOLD = 0.5


class ElementTable:
    """Flat view of a list-of-lists with a dense similarity matrix.

    Row ``r`` of the matrix corresponds to element ``self.element(r)``; the
    matrix is symmetric and its diagonal is pinned to 1.0 — an element is
    always a perfect match for itself, whatever the similarity function says.
    The full pipeline touches nearly every pair, so the matrix fills eagerly
    (the scorer's own TTL caches absorb repeats); with ``anchor_list`` set,
    only that list's rows are computed — the known-reference alignment path
    reads nothing else.
    """

    def __init__(
        self,
        sim_fn: Callable[[Any, Any], float],
        lists: Sequence[Sequence[Any]],
        anchor_list: Optional[int] = None,
    ):
        self.lists = [list(lst) for lst in lists]
        self.owner = np.array(
            [li for li, lst in enumerate(self.lists) for _ in lst], dtype=np.int64
        )
        self.slot = np.array(
            [pos for lst in self.lists for pos in range(len(lst))], dtype=np.int64
        )
        flat = [x for lst in self.lists for x in lst]
        self.flat = flat
        # flat row id for a given (list_idx, element_idx)
        self._starts = np.cumsum([0] + [len(lst) for lst in self.lists])

        n = len(flat)
        sim = None
        if anchor_list is None:
            sim = _flat_dict_sim_matrix(flat, sim_fn)
        if sim is None:
            sim = np.ones((n, n))
            if anchor_list is None:
                for a in range(n):
                    for b in range(a + 1, n):
                        sim[a, b] = sim[b, a] = sim_fn(flat[a], flat[b])
            else:
                for a in self.rows_of(anchor_list):
                    for b in range(n):
                        if b != a:
                            sim[a, b] = sim[b, a] = sim_fn(flat[a], flat[b])
        self.sim = sim

    def __len__(self) -> int:
        return len(self.flat)

    def row(self, index: Index) -> int:
        return int(self._starts[index[0]] + index[1])

    def element(self, r: int) -> Index:
        return (int(self.owner[r]), int(self.slot[r]))

    def rows_of(self, list_idx: int) -> np.ndarray:
        return np.arange(self._starts[list_idx], self._starts[list_idx + 1])

    def get(self, a_idx: Index, b_idx: Index) -> float:
        """Pair similarity by (list_idx, element_idx) — the old memo's API."""
        return float(self.sim[self.row(a_idx), self.row(b_idx)])


# Backwards-compatible alias: earlier revisions exposed the memo under this name.
SimilarityCache = ElementTable


def _flat_dict_sim_matrix(flat, sim_fn) -> Optional[np.ndarray]:
    """Vectorized dense similarity matrix for the COMMON alignment shape —
    every element a flat dict of scalar values (extraction rows) scored by a
    SimilarityScorer.generic — bit-equal to the pairwise loop it replaces:

    - per-pair key union and the reasoning___/source___ skip commute with the
      global sorted key set (absent keys contribute exact 0.0 terms, which
      never change left-to-right float accumulation);
    - each UNIQUE (value, value) pair is still scored by the scorer itself
      (same string caches, same numerics), just once instead of per pair;
    - an all-keys-skipped pair scores 1.0, exactly like ``scorer.dict``.

    Returns None (fall back to the generic loop) for non-dict or nested
    elements, foreign sim_fns, or degenerate shapes.
    """
    n = len(flat)
    if n < 3:
        return None  # nothing to win
    scorer = getattr(sim_fn, "__self__", None)
    from .similarity import SimilarityScorer, _key_ignored

    if not isinstance(scorer, SimilarityScorer) or getattr(sim_fn, "__name__", "") != "generic":
        return None
    if not all(type(x) is dict for x in flat):
        return None
    for d in flat:
        if not d:
            return None  # empty dicts hit the falsy rule, not dict()
        for v in d.values():
            if isinstance(v, (dict, list, tuple)):
                return None
    keys = sorted({k for d in flat for k in d})
    keys = [k for k in keys if not _key_ignored(k)]
    if not keys or len(keys) > 64:
        return None

    totals = np.zeros((n, n))
    denom = np.zeros((n, n))
    missing = object()
    for key in keys:
        present = np.array([key in d for d in flat])
        union = present[:, None] | present[None, :]
        vals = [d.get(key) for d in flat]
        mapping: dict = {}
        idx = np.empty(n, np.int64)
        uniq: list = []
        try:
            for i, v in enumerate(vals):
                mk = (type(v).__name__, v if v == v else missing)  # NaN-safe key
                j = mapping.get(mk)
                if j is None:
                    j = mapping[mk] = len(uniq)
                    uniq.append(v)
                idx[i] = j
        except TypeError:
            return None  # unhashable exotic value — generic loop handles it
        u = len(uniq)
        usim = np.empty((u, u))
        for i in range(u):
            usim[i, i] = sim_fn(uniq[i], uniq[i])
            for j in range(i + 1, u):
                usim[i, j] = usim[j, i] = sim_fn(uniq[i], uniq[j])
        simk = usim[np.ix_(idx, idx)]
        totals += np.where(union, simk, 0.0)
        denom += union

    sim = np.where(denom > 0, totals / np.maximum(denom, 1.0), 1.0)
    np.fill_diagonal(sim, 1.0)
    return sim


def low_cutoff_bound(scores) -> float:
    """Outlier cutoff: a significant 'jump' near the low end of sorted scores.

    A gap among the bottom 20% of the sorted scores larger than 3x the median
    bottom-gap marks everything below it as outlier; the cutoff lands just
    above the gap (epsilon keeps the boundary value excluded).
    """
    ordered = np.sort(np.asarray(scores, dtype=float))
    if ordered.size == 0:
        return 0.0
    gaps = np.diff(ordered[: int(0.2 * ordered.size)])
    if gaps.size:
        big = gaps > np.median(gaps) * 3
        if big.any():
            first = int(np.argmax(big))
            return float(ordered[first + 1]) + 1e-4
    return float(ordered[0])


def remove_outliers(data: List[float]) -> List[float]:
    bound = low_cutoff_bound(data)
    return [x for x in data if x >= bound]


def _best_match_scores(table: ElementTable) -> List[float]:
    """Distribution of greedy best-match scores used for the dynamic threshold.

    Scanning sources in order, each element claims its best still-unclaimed
    partner from any LATER list, provided the similarity clears the 0.5 base;
    claims reset per source list. Ties go to the lowest row id (earliest list,
    earliest position) — np.argmax's first-hit rule matches the strict-greater
    scan it replaces.
    """
    scores: List[float] = []
    n_lists = len(table.lists)
    for src in range(n_lists):
        claimed = np.zeros(len(table), dtype=bool)
        later = table.owner > src
        for r in table.rows_of(src):
            pool = later & ~claimed
            if not pool.any():
                continue
            sims = np.where(pool, table.sim[r], -np.inf)
            partner = int(np.argmax(sims))
            if sims[partner] > _BASE_THRESHOLD:
                scores.append(float(sims[partner]))
                claimed[partner] = True
    return scores


def _compute_dynamic_threshold(table: ElementTable) -> float:
    """``max(0.5, 0.95 * min(outlier-pruned best-match scores))``."""
    if len(table.lists) < 2:
        return _BASE_THRESHOLD
    kept = remove_outliers(sorted(_best_match_scores(table)))
    if not kept:
        return _BASE_THRESHOLD
    return max(_BASE_THRESHOLD, 0.95 * kept[0])


@dataclass
class _Group:
    """One support group during reference election."""

    rep: int  # flat row id of the current representative
    members: List[int] = field(default_factory=list)
    source_lists: set = field(default_factory=set)


def _index_medoid(indices: List[Index]) -> Index:
    """Vectorized index-space medoid — bit-equal to running the primitive
    similarity medoid over the (list_idx, pos) tuples, which is what the spec
    prescribes for group-representative re-election but was a measured hot
    spot (O(members^2) pure-Python pair sims on every join at n=32).

    Per-position similarity collapses to: 1.0 iff |a-b| <= 0.01*max(|a|,|b|)
    (math.isclose(rel_tol=0.01); covers equality and the both-zero falsy
    rule), else the 1e-8 floor; the pair score is the positional mean and the
    medoid is the argmax of nan-diagonal row means — np.argmax's first-hit
    tie rule matching `_medoid_consensus` exactly.
    """
    return indices[_index_medoid_pos(tuple(indices))]


@functools.lru_cache(maxsize=65536)
def _index_medoid_pos(indices: tuple) -> int:
    """Memoized core of :func:`_index_medoid` — pure in the index tuple, and
    the same member sets recur across refinement rounds and warm requests."""
    arr = np.asarray(indices, dtype=np.float64)  # [M, 2]
    a, b = arr[:, None, :], arr[None, :, :]
    close = np.abs(a - b) <= 0.01 * np.maximum(np.abs(a), np.abs(b))
    sim = np.where(close, 1.0, 1e-8).mean(axis=-1)
    np.fill_diagonal(sim, np.nan)
    return int(np.argmax(np.nanmean(sim, axis=1)))


def _refinement_pass(
    table: ElementTable, groups: List[_Group], threshold: float
) -> Tuple[List[_Group], bool]:
    """One global re-assignment round over stable representatives.

    Every element joins the most-similar CURRENT medoid rep above ``threshold``
    (one element per source list per group), then each group re-elects a
    content-space medoid (argmax of mean member-to-member similarity). Unlike
    the greedy founding scan, all elements see the same final reps, so a
    cluster that fragmented across competing part-formed groups re-coalesces.
    """
    old_reps = sorted(g.rep for g in groups)
    shells = [_Group(rep=g.rep) for g in groups]
    for r in range(len(table)):
        src = int(table.owner[r])
        best: Optional[_Group] = None
        best_sim = -1.0
        for g in shells:
            if src in g.source_lists:
                continue
            s = table.sim[r, g.rep]
            if s >= threshold and s > best_sim:
                best_sim = s
                best = g
        if best is None:
            best = _Group(rep=r)
            shells.append(best)
        best.members.append(r)
        best.source_lists.add(src)
    shells = [g for g in shells if g.members]
    for g in shells:
        member_rows = np.array(g.members)
        block = table.sim[np.ix_(member_rows, member_rows)]
        g.rep = int(member_rows[int(np.argmax(block.mean(axis=1)))])
    return shells, sorted(g.rep for g in shells) != old_reps


def _elect_reference(
    table: ElementTable,
    threshold: float,
    min_support_ratio: float,
    refinement_rounds: int = 0,
) -> List[Index]:
    """Elect reference elements by greedy similarity grouping.

    Every element joins the most-similar existing group representative above
    ``threshold`` whose group has no element from its source list yet, else
    founds a new group. After each join the representative is re-elected as the
    medoid of the member INDEX TUPLES (an index-space medoid — the spec calls
    the primitive consensus on the (list_idx, pos) pairs themselves; computed
    by the vectorized bit-equal ``_index_medoid``) and the group moves to the
    back of the scan order, mirroring the reference's dict-key reinsertion.
    Groups under ``min_support_ratio`` are dropped; survivors are ordered by
    (-support, representative index).
    """
    groups: List[_Group] = []

    for r in range(len(table)):
        src = int(table.owner[r])
        best: Optional[_Group] = None
        best_sim = -1.0
        for g in groups:
            if src in g.source_lists:
                continue
            s = table.sim[r, g.rep]
            if s >= threshold and s > best_sim:
                best_sim = s
                best = g
        if best is None:
            groups.append(_Group(rep=r, members=[r], source_lists={src}))
            continue
        best.members.append(r)
        best.source_lists.add(src)
        elected = _index_medoid([table.element(m) for m in best.members])
        elected_row = table.row(elected)
        if elected_row != best.rep:
            best.rep = elected_row
            groups.remove(best)
            groups.append(best)

    for _ in range(refinement_rounds):
        groups, changed = _refinement_pass(table, groups, threshold)
        if not changed:
            break

    n_lists = len(table.lists)
    ranked = [
        (len(g.members) / n_lists, table.element(g.rep))
        for g in groups
        if len(g.members) / n_lists >= min_support_ratio
    ]
    ranked.sort(key=lambda t: (-t[0], t[1]))
    return [idx for _, idx in ranked]


def _assign_to_reference(
    table: ElementTable, reference: List[Index], threshold: float
) -> List[List[Any]]:
    """Optimal one-to-one assignment of each list's elements to the reference
    columns (Hungarian on 1 - similarity), keeping matches above ``threshold``."""
    n_refs = len(reference)
    out: List[List[Any]] = [[None] * n_refs for _ in table.lists]
    if not n_refs:
        return out
    ref_rows = np.array([table.row(ix) for ix in reference])

    for li, lst in enumerate(table.lists):
        if not lst:
            continue
        rows = table.rows_of(li)
        sims = table.sim[np.ix_(ref_rows, rows)]
        picked_ref, picked_obj = linear_sum_assignment(1.0 - sims)
        for rp, op in zip(picked_ref, picked_obj):
            if sims[rp, op] >= threshold and out[li][rp] is None:
                out[li][rp] = lst[op]
    return out


def _prune_low_support_elements(
    aligned_lists: List[List[Any]], min_support_ratio: float
) -> List[List[Any]]:
    """Remove columns whose non-None support falls below the threshold.

    If every column fails, the threshold relaxes to the max observed support —
    the emergency degradation of the spec (:136-138).
    """
    if not aligned_lists:
        return aligned_lists
    widths = {len(lst) for lst in aligned_lists}
    if len(widths) != 1:
        logger.warning("All lists must have the same number of columns")
        return aligned_lists
    n_cols = widths.pop()
    if n_cols == 0:
        return aligned_lists

    presence = np.array([[x is not None for x in lst] for lst in aligned_lists])
    support = presence.mean(axis=0)
    cutoff = min_support_ratio
    if support.max() < cutoff:
        logger.warning(
            "All columns below threshold, keeping columns with support %s", support.max()
        )
        cutoff = support.max()
    keep = np.flatnonzero(support >= cutoff)
    return [[lst[i] for i in keep] for lst in aligned_lists]


def lists_alignment(
    list_of_lists: List[List[Any]],
    sim_fn: Callable[[Any, Any], float],
    min_support_ratio: float = 0.5,
    max_novelty_ratio: float = 0.25,
    reference_list_idx: Optional[int] = None,
    refinement_rounds: int = 0,
) -> Tuple[List[List[Any]], List[List[Optional[int]]]]:
    """Align lists of objects by element similarity.

    Returns (aligned_lists, original_position_indices). When
    ``reference_list_idx`` is given, that list is ground truth: alignment runs
    at threshold 0 with no pruning or reordering.
    """
    if not any(list_of_lists):
        return [[] for _ in list_of_lists], [[None] * len(lst) for lst in list_of_lists]

    # Whole-alignment memo: the index table alone determines the output
    # (aligned cells are always the caller's own objects — _original_positions
    # matches by id()), so a hit replays the assignment against the current
    # call's lists and never leaks stale objects across consolidations.
    cache = getattr(getattr(sim_fn, "__self__", None), "_align_cache", None)
    key = None
    if cache is not None:
        frozen = freeze_key(list_of_lists, budget=4096)
        if frozen is not None:
            key = (
                frozen, min_support_ratio, max_novelty_ratio,
                reference_list_idx, refinement_rounds,
            )
            sources = cache.get(key)
            if sources is not None:
                aligned = [
                    [None if s is None else lst[s] for s in srcs]
                    for lst, srcs in zip(list_of_lists, sources)
                ]
                return aligned, [list(srcs) for srcs in sources]

    table = ElementTable(sim_fn, list_of_lists, anchor_list=reference_list_idx)

    if reference_list_idx is not None:
        anchor = list_of_lists[reference_list_idx]
        reference = [(reference_list_idx, i) for i in range(len(anchor))]
        aligned = _assign_to_reference(table, reference, threshold=0.0)
        sources = _original_positions(aligned, list_of_lists)
    else:
        threshold = _compute_dynamic_threshold(table)
        reference = _elect_reference(table, threshold, min_support_ratio, refinement_rounds)
        aligned = _assign_to_reference(table, reference, threshold=0.95 * threshold)
        aligned = _prune_low_support_elements(aligned, min_support_ratio)
        aligned, sources = sort_by_original_majority(aligned, list_of_lists)
    if key is not None:
        cache.set(key, [list(srcs) for srcs in sources])
    return aligned, sources
