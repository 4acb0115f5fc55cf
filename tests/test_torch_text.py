"""The port's twin of ``tests/test_text.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

String normalization + similarity primitives (reference consensus_utils :660-761).
"""

import pytest

from k_llms_tpu_torch.consensus.text import (
    ascii_fold,
    hamming_similarity,
    jaccard_similarity,
    key_normalization,
    levenshtein_similarity,
    normalize_string,
    sanitize_value,
)
from k_llms_tpu_torch.consensus.settings import SIMILARITY_SCORE_LOWER_BOUND


def test_normalize_string():
    assert normalize_string("Hello, World! 42") == "helloworld42"
    assert normalize_string("") == ""
    assert normalize_string("___") == ""


def test_sanitize_value():
    assert sanitize_value("Crème Brûlée") == "cremebrulee"
    assert sanitize_value("Straße 12") == "strasse12"
    assert sanitize_value(True) == "true"
    assert sanitize_value("A  B") == "ab"


def test_ascii_fold_special_latin():
    assert ascii_fold("Løß œuf þing") == "Loss oeuf thing"


def test_key_normalization():
    assert key_normalization("items.3.name") == "items.*.name"
    assert key_normalization("a.b") == "a.b"


def test_levenshtein_similarity():
    assert levenshtein_similarity("kitten", "kitten") == 1.0
    assert levenshtein_similarity("", "") == 1.0
    # normalized: "kitten" vs "sitting" distance 3, max len 7
    assert levenshtein_similarity("kitten", "sitting") == pytest.approx(1 - 3 / 7)
    assert levenshtein_similarity("abc", "xyz") == SIMILARITY_SCORE_LOWER_BOUND


def test_hamming_similarity():
    assert hamming_similarity("abc", "abc") == 1.0
    assert hamming_similarity("abc", "abd") == pytest.approx(2 / 3)
    # padding with spaces counts as mismatch
    assert hamming_similarity("ab", "abcd") == pytest.approx(0.5)
    assert hamming_similarity("", "") == 1.0


def test_jaccard_similarity():
    assert jaccard_similarity("abc", "bcd") == pytest.approx(2 / 4)
    assert jaccard_similarity("", "") == 1.0
    assert jaccard_similarity("Hello!", "hello") == 1.0  # normalization first
