"""String normalization and string-similarity primitives.

Parity targets in `k_llms/utils/consensus_utils.py`:
``normalize_string`` :660-673, ``hamming_distance_padded``/``hamming_similarity``
:676-717, ``jaccard_similarity`` :720-742, ``levenshtein_similarity`` :745-761,
``sanitize_value`` :925-933, ``key_normalization`` :764-774.

The Levenshtein kernel is our native C++ (``k_llms_tpu_torch.native``) instead of the
python-Levenshtein wheel. Accent folding (the reference's ``unidecode``) is the
first-party transliterator in ``translit.py``: unidecode-faithful tables for
Latin/Cyrillic/Greek/hanzi/kana, algorithmic Hangul, and a deterministic
per-codepoint fallback for unmapped scripts.  Like the real unidecode, CJK
romanization deliberately merges homophones (他/她/它 all vote as "Ta") —
that collapse is reference behavior, not a bug; only the rare long tail keeps
the distinct ``u<hex>`` tokens.
"""

from __future__ import annotations

import functools
import re
from itertools import zip_longest

from ..native import levenshtein_distance
from .settings import SIMILARITY_SCORE_LOWER_BOUND
from .translit import transliterate

_NON_ALNUM = re.compile(r"[^a-zA-Z0-9]")


def ascii_fold(text: str) -> str:
    """ASCII transliteration (unidecode-equivalent; see ``translit.py``)."""
    return transliterate(text)


@functools.lru_cache(maxsize=65536)
def normalize_string(text: str) -> str:
    """Strip non-alphanumeric characters and lowercase."""
    if not text:
        return ""
    return _NON_ALNUM.sub("", text).lower()


# The memo key includes type(v): hash(True) == hash(1) and True == 1, so a bare
# lru_cache on the value would hand bool results to ints (and 1.0, etc.).
@functools.lru_cache(maxsize=65536)
def _sanitize_hashable(v, _t) -> str:
    s = str(v).lower()
    s = s.replace(" ", "")
    s = ascii_fold(s)
    return _NON_ALNUM.sub("", s)


def sanitize_value(v: str | bool) -> str:
    """Canonical vote key: str() -> lowercase -> no spaces -> ASCII fold -> alnum."""
    try:
        return _sanitize_hashable(v, type(v))
    except TypeError:  # unhashable odd-ball value: compute without the memo
        s = str(v).lower().replace(" ", "")
        return _NON_ALNUM.sub("", ascii_fold(s))


def key_normalization(key: str) -> str:
    """Replace numeric path segments with '*' so list-indexed paths compare equal."""
    return ".".join("*" if part.isdigit() else part for part in key.split("."))


def hamming_distance_padded(s: str, t: str) -> int:
    """Hamming distance on normalized strings, shorter one padded with spaces."""
    s = normalize_string(s)
    t = normalize_string(t)
    return sum(a != b for a, b in zip_longest(s, t, fillvalue=" "))


def hamming_similarity(str_1: str, str_2: str) -> float:
    str_1 = normalize_string(str_1)
    str_2 = normalize_string(str_2)
    max_length = max(len(str_1), len(str_2))
    if max_length == 0:
        return 1.0
    dist = hamming_distance_padded(str_1, str_2)
    return max(SIMILARITY_SCORE_LOWER_BOUND, 1 - (dist / max_length))


def jaccard_similarity(str_1: str, str_2: str) -> float:
    """Character-set Jaccard on normalized strings."""
    str_1 = normalize_string(str_1)
    str_2 = normalize_string(str_2)
    set_a = set(str_1)
    set_b = set(str_2)
    union = set_a | set_b
    if not union:
        return 1.0
    return max(SIMILARITY_SCORE_LOWER_BOUND, len(set_a & set_b) / len(union))


def levenshtein_similarity(str_1: str, str_2: str) -> float:
    str_1 = normalize_string(str_1)
    str_2 = normalize_string(str_2)
    max_length = max(len(str_1), len(str_2))
    if max_length == 0:
        return 1.0
    dist = levenshtein_distance(str_1, str_2)
    return max(SIMILARITY_SCORE_LOWER_BOUND, 1 - (dist / max_length))
