"""Join-key discovery and cascade selection.

Behavioral spec: `k_llms/utils/key_selection.py` — path
discovery :100-121, metrics :154-214 (coverage / uniqueness / pairwise-Jaccard
stability / support histogram feeding a 9-component lexicographic score), the
4-stage cascade funnel :310-367, and greedy + brute-force composite search
:412-437 — pinned by the differential oracle in ``tests/test_keyalign.py``.

Design differences from the reference: single and composite keys share ONE
tuple-valued projection (a single key is a 1-tuple — the score depends on
values only through equality, so the wrapping is invisible); metrics are a
frozen dataclass whose ranking tuples are derived properties; and the funnel is
data-driven (a list of (rank, cap) stages folded over the candidate pool). One
cascade serves both the standard and fuzzy selectors via a ``canonicalize``
hook (the reference duplicates the funnel).
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass
from itertools import combinations
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

JSONPath = str

# Record-container keys probed before falling back to auto-detection.
RECORD_LIST_KEYS: List[str] = ["products"]

_SQUEEZE = re.compile(r"\s+")


def normalize_scalar(value: Any) -> Any:
    """Lowercase + collapse whitespace for strings; other scalars pass through."""
    if not isinstance(value, str):
        return value
    return _SQUEEZE.sub(" ", value.strip().lower())


def iter_records(
    extraction: Dict[str, Any], list_key: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Record dicts from ``list_key``, else RECORD_LIST_KEYS, else every
    list-of-dicts value in order."""

    def dicts_in(container: Any) -> Iterator[Dict[str, Any]]:
        if isinstance(container, list):
            yield from (x for x in container if isinstance(x, dict))

    if list_key is not None:
        return list(dicts_in(extraction.get(list_key)))
    named = [r for k in RECORD_LIST_KEYS for r in dicts_in(extraction.get(k))]
    if named:
        return named
    return [r for v in extraction.values() for r in dicts_in(v)]


def _walk(record: Any, dotted: str) -> Any:
    """Resolve a dot path inside nested dicts; a sentinel miss returns None
    (scalar None and a miss are treated the same by every caller)."""
    node = record
    for step in dotted.split("."):
        if not (isinstance(node, dict) and step in node):
            return None
        node = node[step]
    return node


def project_key(
    extraction: Dict[str, Any],
    key: Tuple[JSONPath, ...],
    list_key: Optional[str] = None,
    canonicalize: Callable[[Any], Any] = normalize_scalar,
) -> List[Tuple[Any, ...]]:
    """Canonicalized key tuples across one extraction's records. A record drops
    out when any component is missing, None, or a container."""
    rows: List[Tuple[Any, ...]] = []
    for record in iter_records(extraction, list_key=list_key):
        parts = [_walk(record, p) for p in key]
        if any(v is None or isinstance(v, (dict, list)) for v in parts):
            continue
        rows.append(tuple(canonicalize(v) for v in parts))
    return rows


def discover_scalar_paths(
    extractions: List[Dict[str, Any]], list_key: Optional[str] = None
) -> List[JSONPath]:
    """Dot paths resolving to scalars anywhere in any record (lists excluded)."""

    def scalar_paths(node: Dict[str, Any], base: str) -> Iterator[str]:
        for k, v in node.items():
            dotted = f"{base}.{k}" if base else k
            if isinstance(v, dict):
                yield from scalar_paths(v, dotted)
            elif not isinstance(v, list):
                yield dotted

    found = {
        p
        for e in extractions
        for rec in iter_records(e, list_key=list_key)
        for p in scalar_paths(rec, "")
    }
    return sorted(found)


def jaccard(a: set, b: set) -> float:
    if not (a or b):
        return 1.0
    union = a | b
    return len(a & b) / len(union) if union else 1.0


@dataclass(frozen=True)
class KeyMetrics:
    """Quality profile of one candidate key across the extraction family.

    ``overlap_*`` = pairwise Jaccard of value sets; ``n_all`` / ``n_all_but_1``
    / ``n_shared`` = support histogram (values seen in every / all-but-one /
    >=2 extractions); ``cover_*`` / ``unique_*`` = per-extraction record
    coverage and value uniqueness, min/mean-aggregated."""

    path: Tuple[str, ...]
    cover_lo: float
    cover_avg: float
    unique_lo: float
    unique_avg: float
    overlap_lo: float
    overlap_avg: float
    n_all: int
    n_all_but_1: int
    n_shared: int
    union_n: int

    @property
    def depth(self) -> int:
        return sum(p.count(".") for p in self.path)

    @property
    def score_tuple(self) -> Tuple:
        """9-component lexicographic rank: worst-pair overlap, full/near-full
        support, mean overlap, uniqueness, coverage, small unions, deep paths,
        few components."""
        return (
            round(self.overlap_lo, 6),
            self.n_all,
            self.n_all_but_1,
            round(self.overlap_avg, 6),
            round(self.unique_lo, 6),
            round(self.cover_lo, 6),
            -self.union_n,
            self.depth,
            -len(self.path),
        )

    @property
    def stability(self) -> Tuple:
        return (round(self.overlap_lo, 6), self.n_all, self.n_all_but_1, round(self.overlap_avg, 6))


def measure_key(
    extractions: List[Dict[str, Any]],
    key: Tuple[JSONPath, ...],
    list_key: Optional[str] = None,
    canonicalize: Callable[[Any], Any] = normalize_scalar,
) -> KeyMetrics:
    """Profile one candidate key (any arity) across the extraction family."""
    columns = [
        project_key(e, key, list_key=list_key, canonicalize=canonicalize) for e in extractions
    ]
    value_sets = [set(c) for c in columns]
    n_files = len(extractions)

    cover: List[float] = []
    unique: List[float] = []
    for rows, e in zip(columns, extractions):
        n_records = len(iter_records(e, list_key=list_key))
        cover.append(len(rows) / max(1, n_records))
        if rows:
            tally = Counter(rows)
            unique.append(sum(1 for n in tally.values() if n == 1) / max(1, len(rows)))
        else:
            unique.append(0.0)

    overlaps = [jaccard(a, b) for a, b in combinations(value_sets, 2)]
    seen_in = Counter(v for s in value_sets for v in s)
    histogram = Counter(seen_in.values())

    return KeyMetrics(
        path=key,
        cover_lo=min(cover, default=0.0),
        cover_avg=sum(cover) / len(cover) if cover else 0.0,
        unique_lo=min(unique, default=0.0),
        unique_avg=sum(unique) / len(unique) if unique else 0.0,
        overlap_lo=min(overlaps, default=1.0),
        overlap_avg=sum(overlaps) / len(overlaps) if overlaps else 1.0,
        n_all=histogram.get(n_files, 0),
        n_all_but_1=histogram.get(n_files - 1, 0) if n_files >= 2 else 0,
        n_shared=sum(n for support, n in histogram.items() if support >= 2),
        union_n=len(seen_in),
    )


@dataclass(frozen=True)
class CascadeConfig:
    min_coverage: float = 0.0
    min_uniqueness: float = 0.0
    topk_stage1: int = 30  # survivors of the stability sort
    topk_stage2: int = 12  # survivors of the intra-JSON sort
    topk_stage3: int = 6  # survivors of the union-parsimony sort


@dataclass(frozen=True)
class CascadeReport:
    stage0_kept: List[KeyMetrics]
    stage1_kept: List[KeyMetrics]
    stage2_kept: List[KeyMetrics]
    stage3_kept: List[KeyMetrics]
    final_best: KeyMetrics


def cascade_select_keys(
    extractions: List[Dict[str, Any]],
    candidates: List[str],
    config: CascadeConfig = CascadeConfig(),
    list_key: Optional[str] = None,
    canonicalize: Callable[[Any], Any] = normalize_scalar,
) -> CascadeReport:
    """4-stage funnel: admission gate -> stability -> intra-JSON quality ->
    union parsimony, finished by a depth / fewer-components tie-break."""
    admitted = [
        m
        for m in (
            measure_key(extractions, (p,), list_key=list_key, canonicalize=canonicalize)
            for p in candidates
        )
        if m.n_shared > 0
        and m.overlap_lo > 0.0
        and m.cover_lo >= config.min_coverage
        and m.unique_lo >= config.min_uniqueness
    ]
    if not admitted:
        raise ValueError(
            "No keys pass Stage 0 (require shared values, nonzero worst-pair "
            "overlap, and the coverage/uniqueness gates)."
        )

    funnel = (
        (
            lambda m: (m.n_all, m.n_all_but_1, round(m.overlap_lo, 6), round(m.overlap_avg, 6)),
            True,
            config.topk_stage1,
        ),
        (lambda m: (round(m.unique_lo, 6), round(m.cover_lo, 6)), True, config.topk_stage2),
        (lambda m: m.union_n, False, config.topk_stage3),
    )
    pools = [admitted]
    for rank, descending, cap in funnel:
        pools.append(sorted(pools[-1], key=rank, reverse=descending)[:cap])

    winner = max(pools[-1], key=lambda m: (m.depth, -len(m.path)))
    return CascadeReport(*pools, final_best=winner)


@dataclass(frozen=True)
class KeySelectionResult:
    best_single: KeyMetrics
    best_composite: Optional[KeyMetrics]
    candidate_table: List[KeyMetrics]
    min_support_for_autolock: int
    cascade_report: CascadeReport


def stability_tuple(m: KeyMetrics) -> Tuple:
    return m.stability


def select_best_keys(
    extractions: List[Dict[str, Any]],
    max_candidates_for_composite: int = 20,
    max_k: int = 3,
    min_support_ratio_for_autolock: float = 0.75,
    cascade_cfg: CascadeConfig = CascadeConfig(),
    list_key: Optional[str] = None,
) -> KeySelectionResult:
    """Cascade over singles, then greedy + brute-force composite improvement."""
    if not extractions:
        raise ValueError("No extractions provided.")
    candidates = discover_scalar_paths(extractions, list_key=list_key)
    if not candidates:
        raise ValueError("No scalar candidate paths discovered.")

    report = cascade_select_keys(extractions, candidates, cascade_cfg, list_key=list_key)

    # Ranked table of every admissible single key (diagnostic output).
    table = sorted(
        (
            m
            for m in (measure_key(extractions, (p,), list_key=list_key) for p in candidates)
            if m.n_shared > 0 and m.overlap_lo > 0.0
        ),
        key=lambda m: m.score_tuple[:7],
        reverse=True,
    )

    # Composite search seeded from the stage-3 pool: greedy growth requires a
    # strict improvement on BOTH score and stability; the brute-force sweep over
    # 2..max_k combinations accepts either-improves (reference :426, :436).
    seeds = [m.path[0] for m in report.stage3_kept][:max_candidates_for_composite]
    champion: Optional[KeyMetrics] = None
    if seeds:
        chosen = [seeds[0]]
        champion = measure_key(extractions, tuple(chosen), list_key=list_key)
        growing = True
        while growing and len(chosen) < max_k:
            growing = False
            for extra in seeds:
                if extra in chosen:
                    continue
                trial = measure_key(extractions, tuple(chosen + [extra]), list_key=list_key)
                if trial.score_tuple > champion.score_tuple and trial.stability > champion.stability:
                    champion, chosen, growing = trial, chosen + [extra], True

        for arity in range(2, min(max_k, len(seeds)) + 1):
            for combo in combinations(seeds, arity):
                trial = measure_key(extractions, combo, list_key=list_key)
                if trial.stability > champion.stability or trial.score_tuple > champion.score_tuple:
                    champion = trial

    return KeySelectionResult(
        best_single=report.final_best,
        best_composite=champion,
        candidate_table=table,
        min_support_for_autolock=max(2, math.ceil(min_support_ratio_for_autolock * len(extractions))),
        cascade_report=report,
    )
