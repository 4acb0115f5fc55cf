"""On-device consensus: batched kernels for the consolidation hot path.

Counterpart of ``k_llms_tpu/consensus/device.py``. The host consensus engine
(alignment.py / voting.py / primitive.py) is pure Python over one field pair
or one vote column at a time; this module batches its hot work on the
engine's device:

- **Batched Levenshtein** (:func:`batched_levenshtein`): every unique string
  pair of a consolidation, scored in padded ``[pairs, L]`` launches of the
  hand-written kernel ``csrc/levenshtein.cu`` (``ops/levenshtein.py``; its
  plain version, the JAX package's row scan in torch, runs for CPU tensors).
  Pairs go into power-of-two length buckets (8-128) and pair chunks (64-1024).
- **Batched cosine similarity** (:func:`batched_cosine`): embedding-method
  pairs in one ``[pairs, D]`` f32 reduction per embedding width (torch ops).
- **Batched majority vote** (:func:`batched_votes`): enum-like aligned
  columns tallied in one ``[fields, samples, candidates]`` one-hot
  reduction, with the canonical-spelling election (torch ops; ``argmax``
  takes the first of equal counts, as ``jnp.argmax`` does).
- **Greedy assignment scan** (:func:`device_best_match_scores`): the
  ``_best_match_scores`` claim loop, a torch loop over rows; only tests call
  it, as in the JAX package.

Equivalence: the alignment and vote kernels compute only **integers** (edit
distances, tallies, winner indices); every float those paths consume is
derived on the host in float64 by the host path's own expressions, so device
results are bit-identical to host results. The cosine is the carve-out: its
dot and norms run in device f32, held to the host's float64 within 1e-5.

:class:`DeviceSimilarityScorer` is the integration point: ``CudaBackend``
constructs it (``device_consensus``, default on) on the engine's device. Its
``prepare()`` walks the parsed contents into per-path string buckets, scores
each bucket's unique pairs on the device, and publishes the results in a
per-consolidation session consulted by ``string()``; a bucket-level cache
lets warm repeats skip the device. Consolidations that score at once queue
on the scorer's device lock. A consolidation takes the host path, with
identical output and counted in ``CONSENSUS_EVENTS``, only on the
``consensus.device`` failpoint, or, on a CPU device, on an error. On a card
an error of the device work (a kernel that does not build or launch) fails
the consolidation, as a failed K1-K4 launch fails its request. Pairs the
kernel cannot take (normalized strings over :data:`LEV_MAX_LEN`) are scored
by the host native code on either device.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..native import levenshtein_distance
from ..ops.levenshtein import MAX_LEN, levenshtein
from ..reliability import failpoints as _failpoints
from ..analysis.lockcheck import make_lock, note_device_dispatch
from ..utils.observability import CONSENSUS_EVENTS
from .cache import TTLCache
from .settings import (
    SIMILARITY_SCORE_LOWER_BOUND,
    SPECIAL_FIELD_PREFIXES,
)
from .similarity import EMBEDDING_MIN_CHARS, SimilarityScorer
from .text import (
    hamming_similarity,
    jaccard_similarity,
    normalize_string,
    sanitize_value,
)
from .voting import vote_memo_key

logger = logging.getLogger(__name__)

#: Longest normalized string the Levenshtein kernel handles; longer pairs (and
#: anything else the encoder can't express) take the host native path.
LEV_MAX_LEN = MAX_LEN
#: Pair-axis padding buckets: pow2 between these bounds.
_PAIR_MIN_BUCKET = 64
_PAIR_CHUNK = 1024
#: Vote fixed shape: up to 128 samples / 128 distinct spellings per column,
#: fields chunked by 8.
VOTE_MAX_SAMPLES = 128
_VOTE_FIELD_CHUNK = 8
#: Refuse to device-score a bucket above this many pairs (payload-shape guard).
_MAX_BUCKET_PAIRS = 100_000


class DeviceConsensusUnavailable(RuntimeError):
    """The requested device is not usable; callers fall back to the host."""


def resolve_consensus_device(device=None) -> torch.device:
    """The device the batched consensus runs on: the caller's (the engine's),
    else the card. Raises :class:`DeviceConsensusUnavailable` for a card
    that is absent."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceConsensusUnavailable("CUDA is not available")
    return dev


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Kernel 1: batched Levenshtein distance
# ---------------------------------------------------------------------------


def _encode_ascii(strs: List[str], length: int) -> Tuple[np.ndarray, np.ndarray]:
    arr = np.zeros((len(strs), length), dtype=np.int32)
    lens = np.zeros(len(strs), dtype=np.int32)
    for i, s in enumerate(strs):
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        arr[i, : raw.size] = raw
        lens[i] = raw.size
    return arr, lens


def levenshtein_batches(pairs: List[Tuple[str, str]]) -> List[Tuple[int, List[int], int]]:
    """How :func:`batched_levenshtein` cuts ``pairs`` into launches:
    ``(L, pair indices, P)`` per launch, L the pow2 length bucket (8-128) and
    P the pow2 padded pair count (64-1024)."""
    buckets: Dict[int, List[int]] = {}
    for i, (a, b) in enumerate(pairs):
        L = _pow2_bucket(max(len(a), len(b), 1), 8, LEV_MAX_LEN)
        buckets.setdefault(L, []).append(i)
    out = []
    for L, idxs in buckets.items():
        for start in range(0, len(idxs), _PAIR_CHUNK):
            chunk = idxs[start : start + _PAIR_CHUNK]
            out.append((L, chunk, _pow2_bucket(len(chunk), _PAIR_MIN_BUCKET, _PAIR_CHUNK)))
    return out


def batched_levenshtein(pairs: List[Tuple[str, str]], device="cpu") -> List[int]:
    """Exact Levenshtein distances for ASCII string pairs, batched on
    ``device``.

    Strings must already be normalized (``normalize_string``) and no longer
    than :data:`LEV_MAX_LEN`. One launch per :func:`levenshtein_batches`
    entry. Returns plain Python ints, identical to the host native kernel.
    """
    device = torch.device(device)
    results = [0] * len(pairs)
    for L, chunk, P in levenshtein_batches(pairs):
        a_s = [pairs[i][0] for i in chunk] + [""] * (P - len(chunk))
        b_s = [pairs[i][1] for i in chunk] + [""] * (P - len(chunk))
        a, alen = _encode_ascii(a_s, L)
        b, blen = _encode_ascii(b_s, L)
        out = levenshtein(*(torch.as_tensor(x, device=device) for x in (a, alen, b, blen)))
        out = out.cpu().numpy()
        for j, i in enumerate(chunk):
            results[i] = int(out[j])
    return results


# ---------------------------------------------------------------------------
# Kernel 1b: batched cosine similarity over embedding pairs
# ---------------------------------------------------------------------------


def _cosine(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw f32 cosine over ``[P, dim]`` pairs: ``(cos [P], zero_norm [P])``."""
    dot = torch.sum(a * b, dim=-1)
    norm = torch.sqrt(torch.sum(a * a, dim=-1)) * torch.sqrt(torch.sum(b * b, dim=-1))
    return dot / torch.where(norm == 0.0, torch.ones_like(norm), norm), norm == 0.0


def batched_cosine(pairs: List[Tuple[Any, Any]], device="cpu") -> List[float]:
    """Cosine similarities for embedding-vector pairs, batched on ``device``.

    Pairs are grouped by embedding dimensionality and chunked along the pair
    axis with pow2 padding, like :func:`batched_levenshtein`. Mismatched
    shapes within a pair raise ``ValueError`` exactly like the host
    ``cosine_similarity``. The [-1,1] -> [0,1] normalization, the zero-norm
    floor and the [lower_bound, 1] clip are derived on the host in float64.
    """
    device = torch.device(device)
    results = [0.0] * len(pairs)
    by_dim: Dict[int, List[int]] = {}
    mats: Dict[int, Tuple[List[Any], List[Any]]] = {}
    for i, (e1, e2) in enumerate(pairs):
        a1 = np.asarray(e1, dtype=np.float32)
        a2 = np.asarray(e2, dtype=np.float32)
        if a1.shape != a2.shape:
            raise ValueError("Vectors must have the same shape for cosine similarity")
        by_dim.setdefault(a1.size, []).append(i)
        rows = mats.setdefault(a1.size, ([], []))
        rows[0].append(a1.reshape(-1))
        rows[1].append(a2.reshape(-1))
    for dim, idxs in by_dim.items():
        rows_a, rows_b = mats[dim]
        for start in range(0, len(idxs), _PAIR_CHUNK):
            chunk = idxs[start : start + _PAIR_CHUNK]
            P = _pow2_bucket(len(chunk), _PAIR_MIN_BUCKET, _PAIR_CHUNK)
            a = np.zeros((P, dim), dtype=np.float32)
            b = np.zeros((P, dim), dtype=np.float32)
            for j in range(len(chunk)):
                a[j] = rows_a[start + j]
                b[j] = rows_b[start + j]
            cos, zero = _cosine(torch.as_tensor(a, device=device), torch.as_tensor(b, device=device))
            cos = cos.cpu().numpy().astype(np.float64)
            zero = zero.cpu().numpy()
            for j, i in enumerate(chunk):
                if zero[j]:
                    results[i] = SIMILARITY_SCORE_LOWER_BOUND
                else:
                    results[i] = float(
                        np.clip(
                            0.5 * (cos[j] + 1.0), SIMILARITY_SCORE_LOWER_BOUND, 1.0
                        )
                    )
    return results


# ---------------------------------------------------------------------------
# Kernel 2: batched majority vote over aligned columns
# ---------------------------------------------------------------------------


def _vote(codes: torch.Tensor, spell: torch.Tensor, spell_bucket: torch.Tensor):
    """Two-level tally: sanitized-bucket counts pick the winner, then
    exact-spelling counts (masked to the winning bucket) pick the reported
    spelling. ``argmax`` takes the first of equal counts, which is
    first-insertion order (ids are assigned first-seen), matching
    ``Counter.most_common(1)`` and the host's first-occurrence spelling rule.
    codes/spell: [F, S] int32 ids (-1 = absent/padding); spell_bucket: [F, U]
    int32 bucket of each spelling id (-1 = padding)."""
    U = spell_bucket.shape[1]
    cand = torch.arange(U, dtype=torch.int32, device=codes.device)
    b_counts = (codes[:, None, :] == cand[None, :, None]).sum(dim=-1)
    winner = torch.argmax(b_counts, dim=1)
    wcount = torch.gather(b_counts, 1, winner[:, None])[:, 0]
    s_counts = (spell[:, None, :] == cand[None, :, None]).sum(dim=-1)
    eligible = spell_bucket == winner[:, None].to(torch.int32)
    masked = torch.where(eligible, s_counts, torch.full_like(s_counts, -1))
    wspell = torch.argmax(masked, dim=1)
    return winner, wcount, wspell


class _VoteColumn:
    """Host-side encoding of one vote-eligible aligned column."""

    __slots__ = ("key", "codes", "spell", "bucket_of_spell", "spell_values", "valid", "is_bool", "canonical")

    def __init__(self, key, codes, spell, bucket_of_spell, spell_values, valid, is_bool, canonical):
        self.key = key
        self.codes = codes  # sanitized-bucket id per valid sample
        self.spell = spell  # spelling id per valid sample
        self.bucket_of_spell = bucket_of_spell  # spelling id -> bucket id
        self.spell_values = spell_values  # spelling id -> original value
        self.valid = valid  # the values that actually vote, in order
        self.is_bool = is_bool
        self.canonical = canonical  # effective_canonical_spelling at encode time


def _encode_vote_column(values: List[Any], consensus_settings) -> Optional[_VoteColumn]:
    """Encode a column for the vote kernel, or None when the host must do it.

    Mirrors ``voting_consensus`` exactly: booleans vote over ``v or False``
    with None as False; strings vote under ``sanitize_value`` with None a
    distinct candidate only when ``allow_none_as_candidate``. Columns mixing
    bools and strings (or exceeding the kernel shape) are not encoded.
    """
    key = vote_memo_key(values, consensus_settings)
    if key is None or not values or len(values) > VOTE_MAX_SAMPLES:
        return None
    non_none = [v for v in values if v is not None]
    if not non_none:
        return None
    is_bool = isinstance(non_none[0], bool)
    if is_bool:
        if not all(isinstance(v, bool) for v in non_none):
            return None
        valid: List[Any] = [v or False for v in values]
        proc: List[Any] = valid
    else:
        if not all(isinstance(v, str) for v in non_none):
            return None
        valid = list(values) if consensus_settings.allow_none_as_candidate else non_none
        proc = [sanitize_value(v) if v is not None else None for v in valid]

    bucket_ids: Dict[Any, int] = {}
    codes = []
    for p in proc:
        if p not in bucket_ids:
            bucket_ids[p] = len(bucket_ids)
        codes.append(bucket_ids[p])
    spell_ids: Dict[Any, int] = {}
    spell = []
    spell_values: List[Any] = []
    bucket_of_spell: List[int] = []
    for v, c in zip(valid, codes):
        if v not in spell_ids:
            spell_ids[v] = len(spell_ids)
            spell_values.append(v)
            bucket_of_spell.append(c)
        spell.append(spell_ids[v])
    if len(spell_values) > VOTE_MAX_SAMPLES:
        return None
    return _VoteColumn(
        key,
        codes,
        spell,
        bucket_of_spell,
        spell_values,
        valid,
        is_bool,
        bool(consensus_settings.effective_canonical_spelling),
    )


def batched_votes(columns: List[_VoteColumn], device="cpu") -> List[Tuple[Any, int]]:
    """Tally encoded columns on ``device``; returns (best_val, best_count)
    per column, field-chunked into one fixed shape."""
    device = torch.device(device)
    S = VOTE_MAX_SAMPLES
    out: List[Tuple[Any, int]] = []
    for start in range(0, len(columns), _VOTE_FIELD_CHUNK):
        chunk = columns[start : start + _VOTE_FIELD_CHUNK]
        F = _VOTE_FIELD_CHUNK
        codes = np.full((F, S), -1, dtype=np.int32)
        spell = np.full((F, S), -1, dtype=np.int32)
        bucket = np.full((F, S), -1, dtype=np.int32)
        for f, col in enumerate(chunk):
            codes[f, : len(col.codes)] = col.codes
            spell[f, : len(col.spell)] = col.spell
            bucket[f, : len(col.bucket_of_spell)] = col.bucket_of_spell
        winner, wcount, wspell = (
            x.cpu().numpy()
            for x in _vote(*(torch.as_tensor(x, device=device) for x in (codes, spell, bucket)))
        )
        for f, col in enumerate(chunk):
            w, c, ws = int(winner[f]), int(wcount[f]), int(wspell[f])
            out.append((_decode_vote(col, w, c, ws), c))
    return out


def _decode_vote(col: _VoteColumn, winner: int, count: int, wspell: int):
    if col.is_bool or col.canonical:
        # Canonical-spelling election happened in the kernel (spelling counts
        # masked to the winning bucket; argmax = most common, first-seen on
        # ties). Booleans: spelling ids coincide with bucket ids, so this is
        # exactly the host branch's Counter winner.
        return col.spell_values[wspell]
    # Canonical spelling off: the host reports the winning bucket's first
    # occurrence (valid_values[processed.index(best_normalized)]).
    return next(v for v, c in zip(col.valid, col.codes) if c == winner)


# ---------------------------------------------------------------------------
# Kernel 3: greedy assignment scan (device port of _best_match_scores)
# ---------------------------------------------------------------------------


def device_best_match_scores(sim: np.ndarray, owner: np.ndarray, device="cpu") -> List[float]:
    """Greedy best-match score distribution, computed on ``device``: scan
    rows in order; each element claims its best still-unclaimed partner from
    a later list above the 0.5 base threshold; claims reset per source list.
    Validated against the host scan in the tests; the production alignment
    path stays on the host in float64."""
    n = sim.shape[0]
    if n == 0:
        return []
    device = torch.device(device)
    N = _pow2_bucket(n, 8, 1 << 14)
    sim_p = np.full((N, N), -1.0, dtype=np.float32)
    sim_p[:n, :n] = sim
    owner_p = np.full(N, np.iinfo(np.int32).max, dtype=np.int32)
    owner_p[:n] = owner
    sim_t = torch.as_tensor(sim_p, device=device)
    owner_t = torch.as_tensor(owner_p, device=device)
    claimed = torch.zeros(N, dtype=torch.bool, device=device)
    prev = torch.tensor(-1, dtype=torch.int32, device=device)
    scores = []
    neg_inf = torch.tensor(-float("inf"), device=device)
    for r in range(N):
        src = owner_t[r]
        claimed = torch.where(src != prev, torch.zeros_like(claimed), claimed)
        pool = (owner_t > src) & ~claimed
        sims = torch.where(pool, sim_t[r], neg_inf)
        p = torch.argmax(sims)
        ok = sims[p] > 0.5
        claimed[p] = claimed[p] | ok
        prev = src
        scores.append(torch.where(ok, sims[p], torch.tensor(float("nan"), device=device)))
    out = torch.stack(scores).cpu().numpy()[:n]
    return [float(s) for s in out if not np.isnan(s)]


# ---------------------------------------------------------------------------
# Session + scorer integration
# ---------------------------------------------------------------------------


class DeviceConsensusSession:
    """Per-consolidation similarity table published by ``prepare()``: every
    unique in-bucket string pair, pre-scored (device batch, bucket cache, or
    host fallback) and consulted lock-free by ``string()``."""

    __slots__ = ("pair_sims", "hits", "misses")

    def __init__(self) -> None:
        self.pair_sims: Dict[Tuple[str, str], float] = {}
        self.hits = 0
        self.misses = 0


def _collect_string_buckets(contents: List[Any]) -> Dict[str, List[str]]:
    """Group scalar strings by structural path (list indices collapsed to
    ``*``, mirroring ``key_normalization``): alignment and consensus only ever
    compare strings within the same collapsed path."""
    buckets: Dict[str, List[str]] = {}

    def walk(node: Any, path: str) -> None:
        if isinstance(node, str):
            buckets.setdefault(path, []).append(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            child = f"{path}.*" if path else "*"
            for v in node:
                walk(v, child)

    for content in contents:
        walk(content, "")
    return buckets


class DeviceSimilarityScorer(SimilarityScorer):
    """SimilarityScorer whose consolidation hooks run the batched kernels.

    ``device`` is where the batched work runs (the engine's device; None =
    the card). Construction raises :class:`DeviceConsensusUnavailable` when
    that device is unusable, so ``CudaBackend`` degrades to the plain host
    scorer at wiring time. At run time a consolidation takes the host path
    on the ``consensus.device`` failpoint, and on a CPU device on any error,
    recorded in CONSENSUS_EVENTS; on a card an error propagates. Concurrent
    consolidations wait for the device lock in turn.
    """

    def __init__(self, *args: Any, device=None, **kwargs: Any) -> None:
        self.device = resolve_consensus_device(device)
        super().__init__(*args, **kwargs)
        # Persistent bucket-level pair cache: key = sorted unique strings of a
        # bucket, value = the scored pair map. Warm repeats skip the device.
        self._bucket_cache = TTLCache(maxsize=4096, ttl=300.0, name="pairs")
        # kllms: unguarded — threading.local: per-thread storage by design
        self._tls = threading.local()
        # Held across each batched dispatch on purpose: concurrent
        # consolidations queue on the device in turn.
        self._device_lock = make_lock("consensus.device_chip", allow_dispatch=True)

    # -- consolidation hooks ----------------------------------------------
    def prepare(self, contents: List[Any]) -> None:
        self._tls.session = None
        spec = _failpoints.fire("consensus.device")
        if spec is not None and spec.action == "fallback":
            CONSENSUS_EVENTS.record("consensus.fallback_failpoint")
            self._fall_back_to_host(contents)
            return
        try:
            super().prepare(contents)  # embedding prefetch (one batched call)
            session = DeviceConsensusSession()
            self._build_pair_sims(contents, session)
            self._tls.session = session
            CONSENSUS_EVENTS.record("consensus.device_dispatch")
        except Exception:
            if self.device.type == "cuda":
                raise  # no host path on a card: the request fails
            logger.exception("device consensus prepare failed; using host path")
            CONSENSUS_EVENTS.record("consensus.fallback_error")
            self._fall_back_to_host(contents)

    def _fall_back_to_host(self, contents: List[Any]) -> None:
        self._tls.session = None
        CONSENSUS_EVENTS.record("consensus.host_dispatch")
        try:
            super().prepare(contents)
        except Exception:  # prefetch is best-effort on the fallback path too
            logger.exception("host prepare failed during device fallback")

    def prepare_aligned(self, contents: List[Any], consensus_settings: Any) -> None:
        session = getattr(self._tls, "session", None)
        if session is None:
            return
        try:
            self._prefill_votes(list(contents), consensus_settings)
        except Exception:
            if self.device.type == "cuda":
                raise
            # Voting falls back lazily: any column missing from the memo is
            # simply computed by the host voting_consensus.
            logger.exception("device vote prefill failed; host voting takes over")
            CONSENSUS_EVENTS.record("consensus.fallback_error")

    # -- similarity lookup -------------------------------------------------
    def string(self, s1: str, s2: str) -> float:
        session = getattr(self._tls, "session", None)
        if session is not None:
            key = (s1, s2) if s1 <= s2 else (s2, s1)
            sim = session.pair_sims.get(key)
            if sim is not None:
                session.hits += 1
                return sim
            session.misses += 1
        return super().string(s1, s2)

    # -- device work -------------------------------------------------------
    def _build_pair_sims(self, contents: List[Any], session: DeviceConsensusSession) -> None:
        for values in _collect_string_buckets(contents).values():
            unique = list(dict.fromkeys(values))
            if len(unique) < 2:
                continue
            if len(unique) * (len(unique) - 1) // 2 > _MAX_BUCKET_PAIRS:
                continue  # unsupported payload shape: host scores lazily
            bucket_key = (self.method, tuple(sorted(unique)))
            cached = self._bucket_cache.get(bucket_key)
            if cached is not None:
                session.pair_sims.update(cached)
                CONSENSUS_EVENTS.record("consensus.cached_pairs", len(cached))
                continue
            pair_map = self._score_bucket(unique)
            self._bucket_cache.set(bucket_key, pair_map)
            session.pair_sims.update(pair_map)

    def _score_bucket(self, unique: List[str]) -> Dict[Tuple[str, str], float]:
        """Score every unordered pair of a bucket, routing Levenshtein work to
        the device (float derivation bit-identical to the host) and embedding
        pairs to the batched cosine kernel (tolerance-equivalent; the one
        float-producing kernel)."""
        pair_map: Dict[Tuple[str, str], float] = {}
        lev_jobs: List[Tuple[Tuple[str, str], str, str, int]] = []
        cos_jobs: List[Tuple[Tuple[str, str], Any, Any]] = []
        host_pairs = 0
        for i, s1 in enumerate(unique):
            for s2 in unique[i + 1 :]:
                key = (s1, s2) if s1 <= s2 else (s2, s1)
                if key in pair_map:
                    continue
                if (
                    self.method == "embeddings"
                    and len(s1) > EMBEDDING_MIN_CHARS
                    and len(s2) > EMBEDDING_MIN_CHARS
                    and self.embed_fn is not None
                ):
                    try:
                        cos_jobs.append(
                            (key, self.get_embedding(s1), self.get_embedding(s2))
                        )
                        continue
                    except Exception as e:  # degrade to Levenshtein, like host
                        logger.error(
                            "Error getting embeddings for %r and %r", s1, s2,
                            exc_info=e,
                        )
                sim = self._score_host_only(s1, s2)
                if sim is not None:
                    pair_map[key] = sim
                    host_pairs += 1
                    continue
                n1, n2 = normalize_string(s1), normalize_string(s2)
                max_len = max(len(n1), len(n2))
                if max_len == 0:
                    pair_map[key] = 1.0
                elif max_len > LEV_MAX_LEN:
                    # payload shape the kernel doesn't cover: host native
                    dist = levenshtein_distance(n1, n2)
                    pair_map[key] = max(SIMILARITY_SCORE_LOWER_BOUND, 1 - (dist / max_len))
                    host_pairs += 1
                else:
                    lev_jobs.append((key, n1, n2, max_len))
        if lev_jobs:
            dists = self._lev_distances([(n1, n2) for _, n1, n2, _ in lev_jobs])
            for (key, _, _, max_len), dist in zip(lev_jobs, dists):
                pair_map[key] = max(SIMILARITY_SCORE_LOWER_BOUND, 1 - (dist / max_len))
        if cos_jobs:
            sims = self._cosine_sims([(e1, e2) for _, e1, e2 in cos_jobs])
            for (key, _, _), sim in zip(cos_jobs, sims):
                pair_map[key] = sim
        if host_pairs:
            CONSENSUS_EVENTS.record("consensus.host_pairs", host_pairs)
        return pair_map

    def _score_host_only(self, s1: str, s2: str) -> Optional[float]:
        """Methods the device doesn't kernelize, computed here so the bucket
        cache still memoizes them. Returns None for the Levenshtein route
        (embedding-eligible pairs are batched by the caller first)."""
        if self.method == "jaccard":
            return jaccard_similarity(s1, s2)
        if self.method == "hamming":
            return hamming_similarity(s1, s2)
        return None

    def _lev_distances(self, pairs: List[Tuple[str, str]]) -> List[int]:
        """Batched device Levenshtein, after any other consolidation's
        device work (the device lock)."""
        with self._device_lock, self._on_device():
            note_device_dispatch("consensus pair kernel")
            dists = batched_levenshtein(pairs, self.device)
        CONSENSUS_EVENTS.record("consensus.device_pairs", len(pairs))
        return dists

    def _cosine_sims(self, pairs: List[Tuple[Any, Any]]) -> List[float]:
        """Batched device cosine, under the device lock as
        :meth:`_lev_distances`."""
        with self._device_lock, self._on_device():
            note_device_dispatch("consensus cosine kernel")
            sims = batched_cosine(pairs, self.device)
        CONSENSUS_EVENTS.record("consensus.device_cosine", len(pairs))
        return sims

    def _prefill_votes(self, contents: List[Any], consensus_settings: Any) -> None:
        """Batch-tally every vote-eligible aligned column into the vote memo,
        mirroring the consensus_values dispatch gates. Columns the encoder
        skips (mixed types, too wide) are computed lazily by the host."""
        columns: List[List[Any]] = []

        def walk(values: List[Any]) -> None:
            present = [v for v in values if v is not None]
            if not present:
                return
            if isinstance(present[0], (str, bool)) and all(
                len(str(v).strip().split()) < 3 for v in present
            ):
                columns.append(list(values))
                return
            if isinstance(present[0], dict):
                kept = [v for v in values if isinstance(v, dict)]
                for key in dict.fromkeys(k for d in kept for k in d):
                    if any(marker in key for marker in SPECIAL_FIELD_PREFIXES):
                        continue
                    walk([d.get(key) for d in kept])
                return
            if isinstance(present[0], list):
                kept = [v for v in values if isinstance(v, list)]
                width = max((len(lst) for lst in kept), default=0)
                for col in range(width):
                    walk([lst[col] if col < len(lst) else None for lst in kept])

        walk(contents)
        jobs: List[_VoteColumn] = []
        for column in columns:
            enc = _encode_vote_column(column, consensus_settings)
            if enc is None or self._vote_cache.get(enc.key) is not None:
                continue
            jobs.append(enc)
        if not jobs:
            return
        with self._device_lock, self._on_device():
            note_device_dispatch("consensus vote kernel")
            results = batched_votes(jobs, self.device)
        for col, (best_val, best_count) in zip(jobs, results):
            if best_count > 0:
                self._vote_cache.set(col.key, (best_val, best_count))
        CONSENSUS_EVENTS.record("consensus.device_votes", len(jobs))

    def _on_device(self):
        """The scorer's card as the calling thread's device, its default
        stream the one the engine's launches use."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- observability -----------------------------------------------------
    def cache_stats(self) -> dict:
        stats = super().cache_stats()
        stats["pairs"] = self._bucket_cache.stats()
        return stats
