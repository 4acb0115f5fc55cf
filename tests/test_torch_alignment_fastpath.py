"""The port's twin of ``tests/test_alignment_fastpath.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

The vectorized flat-dict similarity-matrix fast path must be bit-equal to
the generic pairwise loop it replaces (ElementTable.__init__), across scalar
types, missing keys, skip-pattern keys, NaN, and bool/int aliasing.
"""

import random

import numpy as np

from k_llms_tpu_torch.consensus.alignment import ElementTable, _flat_dict_sim_matrix
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

WORDS = [
    "alpha", "beta widget", "Industrial widget, stainless", "", "x",
    "Express shipping and handling",
]


def _rand_dict(rng):
    d = {}
    for k in ("description", "qty", "price", "ok", "reasoning___w", "extra"):
        if rng.random() < 0.75:
            d[k] = rng.choice(
                [
                    rng.choice(WORDS),
                    rng.randint(0, 20),
                    round(rng.uniform(0, 100), 2),
                    rng.random() < 0.5,
                    None,
                    float("nan"),
                ]
            )
    return d or {"description": "fallback"}


def test_fast_matrix_bit_equals_pairwise_loop():
    rng = random.Random(0)
    checked = 0
    for trial in range(60):
        lists = [
            [_rand_dict(rng) for _ in range(rng.randint(0, 4))]
            for _ in range(rng.randint(2, 8))
        ]
        flat = [x for lst in lists for x in lst]
        if len(flat) < 3:
            continue
        fast = _flat_dict_sim_matrix(flat, SimilarityScorer.levenshtein().generic)
        scorer = SimilarityScorer.levenshtein()
        n = len(flat)
        slow = np.ones((n, n))
        for a in range(n):
            for b in range(a + 1, n):
                slow[a, b] = slow[b, a] = scorer.generic(flat[a], flat[b])
        if fast is None:
            continue  # a guard fired (e.g. empty dict) — the loop serves it
        assert np.array_equal(fast, slow), f"trial {trial}"
        checked += 1
    assert checked >= 30  # the fast path must actually engage


def test_fast_path_falls_back_on_nested_and_foreign():
    scorer = SimilarityScorer.levenshtein()
    nested = [{"a": [1, 2]}, {"a": [1]}, {"a": [2]}]
    assert _flat_dict_sim_matrix(nested, scorer.generic) is None
    scalars = ["x", "y", "z"]
    assert _flat_dict_sim_matrix(scalars, scorer.generic) is None
    flat = [{"a": 1}, {"a": 2}, {"a": 3}]
    assert _flat_dict_sim_matrix(flat, lambda a, b: 0.5) is None  # foreign fn

    # and the table still produces the right matrix through the fallback
    table = ElementTable(scorer.generic, [nested])
    assert table.sim.shape == (3, 3)


def test_fast_path_engages_inside_element_table():
    scorer = SimilarityScorer.levenshtein()
    rows = [{"a": "x", "q": i} for i in range(4)]
    table = ElementTable(scorer.generic, [rows[:2], rows[2:]])
    ref = _flat_dict_sim_matrix(rows, SimilarityScorer.levenshtein().generic)
    assert ref is not None
    np.testing.assert_array_equal(table.sim, ref)
