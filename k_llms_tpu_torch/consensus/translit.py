"""First-party ASCII transliteration (unidecode-equivalent for the vote-key path).

The reference sanitizes vote keys with the ``unidecode`` wheel
(`k_llms/utils/consensus_utils.py:15`, applied at :925-933).
This module supplies the same behavior without the dependency:

* **Latin specials** — letters NFKD cannot decompose (ß, æ, ø, þ, ...), mapped
  exactly as unidecode maps them.
* **Cyrillic** — full Russian alphabet + common Ukrainian/Belarusian letters,
  using unidecode's ALA-LC-style mappings (ж→zh, х→kh, щ→shch, ю→iu, я→ia, ...).
* **Greek** — full alphabet incl. precomposed accents, unidecode's mappings
  (θ→th, ξ→x, φ→ph, χ→kh, ψ→ps, η→e, ...).
* **Han ideographs** — unidecode-style pinyin for the high-frequency core
  (~1,700 codepoints incl. traditional variants, ``_cjk_data.HANZI``):
  北京 → "Bei Jing ", matching unidecode's capitalized-syllable-plus-space
  format exactly.
* **Kana** — full hiragana/katakana romaji tables (``_cjk_data.KANA``)
  matching unidecode's x030 block: こんにちは → "konnichiha", カード → "ka-do".
* **Hangul** — algorithmic jamo decomposition + Revised-Romanization letter
  values: 서울 → "seoul", 안녕 → "annyeong".
* **Remaining scripts / long-tail CJK** (Arabic, Hebrew, Indic, rare
  ideographs beyond the frequency table, ...) — a deterministic per-codepoint
  token ``u<hex>`` for alphanumeric characters.  This *diverges* from
  unidecode (which carries full Unihan tables) but preserves the property that
  matters for voting: distinct strings stay distinct, so two rare ideographs
  never collapse into one vote bucket.

Tables are hand-derived from unidecode's documented mapping set and pinned by
the fixture vectors in ``tests/fixtures/unidecode_vectors.py``.
"""

from __future__ import annotations

import unicodedata

from ._cjk_data import HANZI, KANA

# Latin letters with no NFKD decomposition, mapped the way unidecode maps them.
_LATIN = {
    "ß": "ss",
    "ẞ": "SS",
    "æ": "ae",
    "Æ": "AE",
    "œ": "oe",
    "Œ": "OE",
    "ø": "o",
    "Ø": "O",
    "đ": "d",
    "Đ": "D",
    "ð": "d",
    "Ð": "D",
    "þ": "th",
    "Þ": "Th",
    "ł": "l",
    "Ł": "L",
    "ı": "i",
    "İ": "I",
}

# Cyrillic, unidecode (ALA-LC-like) romanization.  Lowercase entries; uppercase
# generated below with unidecode's title-style capitalization (Ж→"Zh").
_CYRILLIC_LOWER = {
    "а": "a",
    "б": "b",
    "в": "v",
    "г": "g",
    "д": "d",
    "е": "e",
    "ё": "io",
    "ж": "zh",
    "з": "z",
    "и": "i",
    "й": "i",
    "к": "k",
    "л": "l",
    "м": "m",
    "н": "n",
    "о": "o",
    "п": "p",
    "р": "r",
    "с": "s",
    "т": "t",
    "у": "u",
    "ф": "f",
    "х": "kh",
    "ц": "ts",
    "ч": "ch",
    "ш": "sh",
    "щ": "shch",
    "ъ": '"',
    "ы": "y",
    "ь": "'",
    "э": "e",
    "ю": "iu",
    "я": "ia",
    # Ukrainian / Belarusian
    "є": "ie",
    "і": "i",
    "ї": "i",
    "ґ": "g",
    "ў": "u",
}

_GREEK_LOWER = {
    "α": "a",
    "β": "b",
    "γ": "g",
    "δ": "d",
    "ε": "e",
    "ζ": "z",
    "η": "e",
    "θ": "th",
    "ι": "i",
    "κ": "k",
    "λ": "l",
    "μ": "m",
    "ν": "n",
    "ξ": "x",
    "ο": "o",
    "π": "p",
    "ρ": "r",
    "σ": "s",
    "ς": "s",
    "τ": "t",
    "υ": "u",
    "φ": "ph",
    "χ": "kh",
    "ψ": "ps",
    "ω": "o",
    # precomposed accents (also reachable via NFKD, but direct is exact)
    "ά": "a",
    "έ": "e",
    "ή": "e",
    "ί": "i",
    "ό": "o",
    "ύ": "u",
    "ώ": "o",
    "ϊ": "i",
    "ϋ": "u",
    "ΐ": "i",
    "ΰ": "u",
}


def _with_upper(lower: dict[str, str]) -> dict[str, str]:
    table = dict(lower)
    for ch, out in lower.items():
        up = ch.upper()
        if len(up) == 1 and up != ch and up not in table:
            # unidecode capitalizes the first romanized letter only (Щ → "Shch")
            table[up] = out[:1].upper() + out[1:] if out and out[0].isalpha() else out
    return table


_TABLE: dict[int, str] = {
    ord(k): v
    for k, v in {
        **_LATIN,
        **_with_upper(_CYRILLIC_LOWER),
        **_with_upper(_GREEK_LOWER),
        **KANA,
        **HANZI,
    }.items()
}

# Hangul syllables (U+AC00..U+D7A3) decompose arithmetically into
# (initial, medial, final) jamo; romanize with Revised-Romanization letter
# values (서울 → "seoul").  Index order follows the Unicode syllable algorithm.
_HANGUL_BASE = 0xAC00
_HANGUL_LAST = 0xD7A3
_HANGUL_INITIALS = (
    "g", "kk", "n", "d", "tt", "r", "m", "b", "pp", "s", "ss", "", "j", "jj",
    "ch", "k", "t", "p", "h",
)
_HANGUL_MEDIALS = (
    "a", "ae", "ya", "yae", "eo", "e", "yeo", "ye", "o", "wa", "wae", "oe",
    "yo", "u", "wo", "we", "wi", "yu", "eu", "ui", "i",
)
_HANGUL_FINALS = (
    "", "g", "kk", "gs", "n", "nj", "nh", "d", "l", "lg", "lm", "lb", "ls",
    "lt", "lp", "lh", "m", "b", "bs", "s", "ss", "ng", "j", "ch", "k", "t",
    "p", "h",
)


def _hangul_romanize(cp: int) -> str:
    idx = cp - _HANGUL_BASE
    initial, rest = divmod(idx, 21 * 28)
    medial, final = divmod(rest, 28)
    return _HANGUL_INITIALS[initial] + _HANGUL_MEDIALS[medial] + _HANGUL_FINALS[final]


def transliterate(text: str) -> str:
    """unidecode-equivalent ASCII transliteration.

    Pipeline: mapped-script table (Latin specials, Cyrillic, Greek, kana,
    hanzi) → algorithmic Hangul romanization → NFKD decomposition → per-char
    sweep that keeps ASCII, drops combining marks, maps non-ASCII decimal
    digits to their ASCII digit (unidecode parity), and tokenizes any
    remaining alphanumeric codepoint as ``u<hex>`` so unmapped scripts stay
    distinct.  Hangul runs before NFKD because NFKD shatters syllables into
    conjoining jamo.

    NFD input (e.g. text from macOS filenames or some normalizing pipelines)
    arrives already shattered into conjoining jamo (U+1100–U+11FF), which the
    syllable-range romanizer cannot see; NFC composes those runs back into
    precomposed syllables first, so NFD '서울' romanizes to 'seoul' exactly
    like its NFC form (real unidecode romanizes the jamo block directly, so
    parity holds either way).
    """
    if text.isascii():
        return text
    if any(0x1100 <= ord(ch) <= 0x11FF for ch in text):
        text = unicodedata.normalize("NFC", text)
    text = text.translate(_TABLE)
    if any(_HANGUL_BASE <= ord(ch) <= _HANGUL_LAST for ch in text):
        text = "".join(
            _hangul_romanize(cp) if _HANGUL_BASE <= (cp := ord(ch)) <= _HANGUL_LAST else ch
            for ch in text
        )
    decomposed = unicodedata.normalize("NFKD", text)
    out: list[str] = []
    for ch in decomposed:
        cp = ord(ch)
        if cp < 128:
            out.append(ch)
        elif unicodedata.combining(ch):
            continue
        elif cp in _TABLE:
            # precomposed letters outside the table (e.g. ѝ, polytonic Greek)
            # NFKD-decompose to a mapped base letter + combining mark
            out.append(_TABLE[cp])
        elif (digit := unicodedata.decimal(ch, None)) is not None:
            out.append(str(digit))  # ٣ → 3, ३ → 3 (unidecode parity)
        elif ch.isalnum():
            out.append(f"u{cp:04x}")
        # other non-ASCII symbols (punctuation, emoji, ...) are dropped, as the
        # vote-key regex would strip them anyway
    return "".join(out)
