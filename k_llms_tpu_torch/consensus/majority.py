"""Pairwise-majority (Condorcet) column ordering for aligned lists.

Behavioral parity with `k_llms/utils/majority_sorting.py:8-112`:
after alignment, columns are reordered to follow the pairwise-majority order of
the elements' original positions. The acyclic part of the majority graph is
emitted by a heap-driven topological sort tie-broken on average original
position; any columns trapped in a Condorcet cycle are appended afterwards,
sorted by that same tie-break key. Cell-to-origin matching is by object
identity (``id``), so the aligner must carry original element objects through
(not copies); duplicate scalars resolve to their last original position, like
the reference's dict-comprehension lookup.

Implementation here is matrix-style (numpy over the tiny n_cols x n_cols win
table) rather than the reference's nested-list loops; the differential suite
(tests/test_reference_parity.py) pins the output equal.
"""

from __future__ import annotations

import heapq
from typing import Any, List, Optional, Tuple

import numpy as np


def _original_positions(
    aligned: List[List[Any]],
    originals: List[List[Any]],
) -> List[List[Optional[int]]]:
    """For every aligned cell, the element's index in its source row (or None)."""
    table: List[List[Optional[int]]] = []
    for row_aligned, row_original in zip(aligned, originals):
        by_identity = {id(obj): idx for idx, obj in enumerate(row_original)}
        table.append(
            [
                by_identity.get(id(cell)) if cell is not None else None
                for cell in row_aligned
            ]
        )
    # Rows beyond the originals (defensive; shapes normally match).
    while len(table) < len(aligned):
        table.append([None] * len(aligned[0]))
    return table


def _win_matrix(pos: List[List[Optional[int]]], n_cols: int) -> np.ndarray:
    """wins[i, j] = number of rows where both columns appear and i precedes j."""
    wins = np.zeros((n_cols, n_cols), dtype=np.int64)
    for row in pos:
        present = [(c, k) for c, k in enumerate(row) if k is not None]
        for ci, ki in present:
            for cj, kj in present:
                if ki < kj:
                    wins[ci, cj] += 1
    return wins


def _tie_break_key(pos: List[List[Optional[int]]], n_cols: int) -> List[float]:
    """Average original position per column; empty columns sort last."""
    sums = np.zeros(n_cols)
    counts = np.zeros(n_cols)
    for row in pos:
        for c, k in enumerate(row):
            if k is not None:
                sums[c] += k
                counts[c] += 1
    return [
        (sums[c] / counts[c]) if counts[c] else float("inf") for c in range(n_cols)
    ]


def _column_order(wins: np.ndarray, tie_key: List[float]) -> List[int]:
    """Kahn's algorithm over the strict-majority digraph, heap-ordered by the
    tie-break key; Condorcet-cycle leftovers appended by the same key."""
    n = wins.shape[0]
    beats = wins > wins.T  # i beats j strictly
    np.fill_diagonal(beats, False)
    indegree = beats.sum(axis=0).astype(int)

    heap: List[Tuple[float, int]] = [
        (tie_key[c], c) for c in range(n) if indegree[c] == 0
    ]
    heapq.heapify(heap)
    order: List[int] = []
    while heap:
        _, u = heapq.heappop(heap)
        order.append(u)
        for v in np.nonzero(beats[u])[0]:
            indegree[v] -= 1
            if indegree[v] == 0:
                heapq.heappush(heap, (tie_key[v], int(v)))

    if len(order) < n:
        emitted = set(order)
        order.extend(
            sorted((c for c in range(n) if c not in emitted), key=lambda c: tie_key[c])
        )
    return order


def sort_by_original_majority(
    aligned_list_of_lists: List[List[Any]],
    initial_list_of_lists: List[List[Any]],
) -> Tuple[List[List[Any]], List[List[Optional[int]]]]:
    """Reorder aligned columns by the pairwise-majority order of original
    indices. Returns (sorted_aligned_lists, sorted_original_indices)."""
    if not aligned_list_of_lists:
        return aligned_list_of_lists, [
            [None for _ in row] for row in aligned_list_of_lists
        ]

    n_cols = len(aligned_list_of_lists[0])
    pos = _original_positions(aligned_list_of_lists, initial_list_of_lists)
    order = _column_order(_win_matrix(pos, n_cols), _tie_break_key(pos, n_cols))

    sorted_lists = [[row[c] for c in order] for row in aligned_list_of_lists]
    sorted_positions = [[row[c] for c in order] for row in pos]
    return sorted_lists, sorted_positions
