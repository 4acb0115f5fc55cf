"""The port's twin of ``tests/test_similarity.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Generic similarity semantics (reference consensus_utils :797-917).
"""

import pytest

from k_llms_tpu_torch.consensus.settings import SIMILARITY_SCORE_LOWER_BOUND
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer, cosine_similarity


@pytest.fixture
def scorer():
    return SimilarityScorer(method="levenshtein")


def test_both_falsy_is_perfect(scorer):
    # "" / 0 / [] / False / None all count as agreement
    assert scorer.generic(None, None) == 1.0
    assert scorer.generic("", 0) == 1.0
    assert scorer.generic([], False) == 1.0


def test_single_none_is_floor(scorer):
    assert scorer.generic(None, "x") == SIMILARITY_SCORE_LOWER_BOUND
    assert scorer.generic(5, None) == SIMILARITY_SCORE_LOWER_BOUND


def test_numbers_one_percent_tolerance(scorer):
    assert scorer.generic(100, 100.5) == 1.0
    assert scorer.generic(100, 102) == SIMILARITY_SCORE_LOWER_BOUND
    assert scorer.generic(True, True) == 1.0
    assert scorer.generic(True, False) == SIMILARITY_SCORE_LOWER_BOUND


def test_dict_similarity_skips_reasoning_keys(scorer):
    d1 = {"a": "x", "reasoning___a": "completely different"}
    d2 = {"a": "x", "reasoning___a": "other"}
    assert scorer.generic(d1, d2) == 1.0


def test_dict_union_of_keys(scorer):
    d1 = {"a": "xx"}
    d2 = {"a": "xx", "b": "yy"}
    # key b: d1.get -> None vs "yy" => floor; mean of (1.0, floor)
    assert scorer.generic(d1, d2) == pytest.approx((1.0 + SIMILARITY_SCORE_LOWER_BOUND) / 2)


def test_list_positional_mean(scorer):
    assert scorer.generic(["ab", "cd"], ["ab", "cd"]) == 1.0
    assert scorer.generic(["ab"], ["ab", "cd"]) == pytest.approx(
        (1.0 + SIMILARITY_SCORE_LOWER_BOUND) / 2
    )


def test_mismatched_types_floor(scorer):
    assert scorer.generic("5", 5) == SIMILARITY_SCORE_LOWER_BOUND


def test_cosine_normalization():
    assert cosine_similarity([1.0, 0.0], [1.0, 0.0]) == pytest.approx(1.0)
    assert cosine_similarity([1.0, 0.0], [-1.0, 0.0]) == pytest.approx(SIMILARITY_SCORE_LOWER_BOUND)
    assert cosine_similarity([1.0, 0.0], [0.0, 1.0]) == pytest.approx(0.5)
    assert cosine_similarity([0.0, 0.0], [1.0, 0.0]) == SIMILARITY_SCORE_LOWER_BOUND
    with pytest.raises(ValueError):
        cosine_similarity([1.0], [1.0, 2.0])


def test_embeddings_gate_and_fallback():
    calls = []

    def embed(texts):
        calls.append(texts)
        return [[1.0, 0.0] for _ in texts]

    s = SimilarityScorer(method="embeddings", embed_fn=embed)
    # short strings: no embedding call, levenshtein fallback
    s.string("short", "short")
    assert calls == []
    long_a = "a" * 60
    long_b = "a" * 59 + "b"
    s.string(long_a, long_b)
    assert len(calls) == 2  # one embed call per string


def test_embedding_error_degrades_to_levenshtein():
    def embed(texts):
        raise RuntimeError("no device")

    s = SimilarityScorer(method="embeddings", embed_fn=embed)
    long_a = "x" * 60
    assert s.string(long_a, long_a) == 1.0  # levenshtein fallback


def test_similarity_cache_hit():
    count = 0

    class CountingScorer(SimilarityScorer):
        pass

    s = SimilarityScorer(method="levenshtein")
    r1 = s.string("hello world", "hello word")
    r2 = s.string("hello word", "hello world")  # symmetric key
    assert r1 == r2
