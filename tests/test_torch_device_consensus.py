"""The port's on-device consensus (``k_llms_tpu_torch/consensus/device.py``)
against the JAX package's and against the host path, on the CPU, where the
Levenshtein wrapper runs its plain version (the reference's row scan in
torch).

Twins of ``tests/test_device_consensus.py``: distances exact against the JAX
package's ``batched_levenshtein`` and the native code, the cosine within
1e-5 of the host's float64, votes and the best-match scan equal, device
equal to host on the corpus at n in {3, 8, 32}, the failpoint fallback
lossless and counted, and the port's consolidation equal to the JAX
``DeviceSimilarityScorer``'s. The card's kernel is held to the plain version
in ``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.
"""

import contextlib
import json
import random

import numpy as np
import pytest
import torch

from k_llms_tpu.utils.quality import TRUTH_DOCS, make_noisy_samples
from k_llms_tpu_torch.consensus.consolidation import consolidate_chat_completions
from k_llms_tpu_torch.consensus.device import (
    DeviceSimilarityScorer,
    _encode_vote_column,
    batched_cosine,
    batched_levenshtein,
    batched_votes,
    device_best_match_scores,
    levenshtein_batches,
)
from k_llms_tpu_torch.consensus.settings import ConsensusSettings
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer, cosine_similarity
from k_llms_tpu_torch.consensus.voting import voting_consensus
from k_llms_tpu_torch.native import levenshtein_distance
from k_llms_tpu_torch.ops import _ext
from k_llms_tpu_torch.ops.levenshtein import levenshtein, levenshtein_plain
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.types import ChatCompletion
from k_llms_tpu_torch.utils.observability import CONSENSUS_EVENTS


def _completion(samples):
    return ChatCompletion.model_validate({
        "id": "c", "created": 0, "model": "m", "object": "chat.completion",
        "choices": [
            {"finish_reason": "stop", "index": i, "message": {"role": "assistant", "content": s}}
            for i, s in enumerate(samples)
        ],
    })


def _consolidate(samples, scorer, settings=ConsensusSettings()):
    r = consolidate_chat_completions(_completion(samples), scorer, settings)
    return r.choices[0].message.content, r.likelihoods


def _device_scorer(method="levenshtein", **kw):
    return DeviceSimilarityScorer(method=method, device="cpu", **kw)


def _assert_device_matches_host(samples, settings=ConsensusSettings()):
    """Device output == host output exactly, content and the likelihood tree,
    cold and through the bucket cache."""
    host = _consolidate(samples, SimilarityScorer.levenshtein(), settings)
    scorer = _device_scorer()
    assert _consolidate(samples, scorer, settings) == host
    assert _consolidate(samples, scorer, settings) == host


def _random_pairs(seed, count, max_len, alpha="abcdefg012"):
    rng = random.Random(seed)
    pairs = [("", ""), ("", "abc"), ("same", "same"), ("kitten", "sitting")]
    for _ in range(count):
        a = "".join(rng.choice(alpha) for _ in range(rng.randrange(0, max_len + 1)))
        b = "".join(rng.choice(alpha) for _ in range(rng.randrange(0, max_len + 1)))
        pairs.append((a, b))
    return pairs


# -- the kernel's plain version and the batching --------------------------------

def test_batched_levenshtein_equals_jax_and_native():
    from k_llms_tpu.consensus.device import batched_levenshtein as jax_batched

    pairs = _random_pairs(3, 200, 40)
    # Bucket edges: every pow2 length bucket's limit and one past it, up to
    # the 128-character ceiling.
    for L in (8, 16, 32, 64, 128):
        pairs += [("x" * L, "x" * (L - 3) + "yyy"), ("ab" * (L // 2), "")]
        if L < 128:
            pairs.append(("z" * (L + 1), "z" * L))
    got = batched_levenshtein(pairs, "cpu")
    assert got == [levenshtein_distance(a, b) for a, b in pairs]
    assert got == jax_batched(pairs)


def test_levenshtein_batches_follow_the_reference_buckets():
    pairs = _random_pairs(5, 1500, 9, alpha="ab") + [("q" * 100, "q")]
    plan = levenshtein_batches(pairs)
    # Every pair in exactly one launch; pow2 length buckets 8..128 and pow2
    # pair counts 64..1024, as the JAX package pads them.
    assert sorted(i for _, idx, _ in plan for i in idx) == list(range(len(pairs)))
    for L, idx, P in plan:
        assert L in (8, 16, 32, 64, 128) and P in (64, 128, 256, 512, 1024)
        assert len(idx) <= P
        assert all(max(len(pairs[i][0]), len(pairs[i][1]), 1) <= L for i in idx)
    per_bucket = {}
    for a, b in pairs:
        L = next(L for L in (8, 16, 32, 64, 128) if max(len(a), len(b), 1) <= L)
        per_bucket[L] = per_bucket.get(L, 0) + 1
    for L, count in per_bucket.items():  # chunks of at most 1024 pairs
        assert sum(1 for Lp, _, _ in plan if Lp == L) == -(-count // 1024)
    assert max(per_bucket.values()) > 1024


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    before = dict(_ext.LAUNCH_COUNTS)
    a = torch.tensor([[97, 98, 99, 0], [0, 0, 0, 0]], dtype=torch.int32)
    alen = torch.tensor([3, 0], dtype=torch.int32)
    b = torch.tensor([[97, 120, 99, 100], [97, 0, 0, 0]], dtype=torch.int32)
    blen = torch.tensor([4, 1], dtype=torch.int32)
    out = levenshtein(a, alen, b, blen)
    assert out.tolist() == [2, 1] == levenshtein_plain(a, alen, b, blen).tolist()
    assert _ext.LAUNCH_COUNTS == before


# -- cosine, votes, the best-match scan -----------------------------------------

def test_batched_cosine_matches_host():
    from k_llms_tpu.consensus.device import batched_cosine as jax_cosine

    rng = np.random.default_rng(5)
    pairs = [(rng.normal(size=64).tolist(), rng.normal(size=64).tolist()) for _ in range(130)]
    v = rng.normal(size=64).tolist()
    pairs.append((v, v))
    pairs.append((v, (-np.asarray(v)).tolist()))
    pairs.append(([0.0] * 64, v))
    pairs.append((rng.normal(size=16).tolist(), rng.normal(size=16).tolist()))
    got = batched_cosine(pairs, "cpu")
    assert np.allclose(got, [cosine_similarity(a, b) for a, b in pairs], atol=1e-5)
    assert np.allclose(got, jax_cosine(pairs), atol=1e-5)
    assert got[-2] == 1e-8  # the zero-norm floor is exact
    with pytest.raises(ValueError):
        batched_cosine([([0.0] * 8, [0.0] * 4)], "cpu")


def test_batched_votes_match_voting_consensus_and_jax():
    from k_llms_tpu.consensus.device import _encode_vote_column as jax_encode
    from k_llms_tpu.consensus.device import batched_votes as jax_votes
    from k_llms_tpu.consensus.settings import ConsensusSettings as JaxSettings

    rng = random.Random(7)
    pools = [["alpha", "Alpha", "ALPHA ", "beta", None], ["北京", "東京", "京都", None],
             [True, False, None]]
    combos = [dict(), dict(allow_none_as_candidate=True), dict(canonical_spelling=False),
              dict(canonical_spelling=False, allow_none_as_candidate=True)]
    cols, encs, jax_encs = [], [], []
    for _ in range(60):
        pool = rng.choice(pools)
        col = [rng.choice(pool) for _ in range(rng.randrange(1, 12))]
        for kw in combos:
            enc = _encode_vote_column(col, ConsensusSettings(**kw))
            if enc is not None:
                cols.append((col, kw))
                encs.append(enc)
                jax_encs.append(jax_encode(col, JaxSettings(**kw)))
    # One batched call each (the JAX package's votes take one fixed shape).
    got_all = batched_votes(encs, "cpu")
    assert got_all == jax_votes(jax_encs)
    for (col, kw), (got_val, got_count) in zip(cols, got_all):
        want_val, want_conf = voting_consensus(list(col), ConsensusSettings(**kw))
        assert got_val == want_val and type(got_val) is type(want_val)
        assert abs(round(got_count / len(col), 5) - want_conf) < 1e-12
    checked = len(cols)
    assert checked > 50


def test_device_best_match_scores_matches_host_scan_and_jax():
    from k_llms_tpu.consensus.device import device_best_match_scores as jax_scan
    from k_llms_tpu_torch.consensus.alignment import ElementTable, _best_match_scores

    rng = random.Random(11)
    words = ["red", "green", "blue", "teal", "grey", "pink"]
    for _ in range(10):
        lists = [[rng.choice(words) for _ in range(rng.randrange(0, 5))]
                 for _ in range(rng.randrange(2, 5))]
        if not any(lists):
            continue
        table = ElementTable(SimilarityScorer.levenshtein().generic, lists)
        sim = np.asarray(table.sim, dtype=np.float32)
        owner = table.owner.astype(np.int32)
        got = device_best_match_scores(sim, owner, "cpu")
        want = _best_match_scores(table)
        assert got == jax_scan(sim, owner)
        assert len(got) == len(want)
        assert all(abs(g - w) < 1e-6 for g, w in zip(got, want))


# -- device == host ---------------------------------------------------------------

@pytest.mark.parametrize("doc", sorted(TRUTH_DOCS))
@pytest.mark.parametrize("n", [3, 8, 32])
def test_device_equals_host_on_corpus(doc, n):
    _assert_device_matches_host(make_noisy_samples(TRUTH_DOCS[doc], n, 0.15, seed=7 + n))


@pytest.mark.parametrize("settings", [ConsensusSettings(allow_none_as_candidate=True),
                                      ConsensusSettings(canonical_spelling=False)],
                         ids=["none-candidate", "no-canonical"])
def test_device_equals_host_settings_variants(settings):
    _assert_device_matches_host(make_noisy_samples(TRUTH_DOCS["invoice"], 8, 0.2, seed=5), settings)


def test_device_equals_host_on_degraded_survivors_and_long_strings():
    samples = make_noisy_samples(TRUTH_DOCS["invoice"], 8, 0.15, seed=9)
    samples[1] = '{"vendor": "Acme Corp", "total":'
    samples[5] = "not json at all"
    host = consolidate_chat_completions(_completion(samples), SimilarityScorer.levenshtein())
    dev = consolidate_chat_completions(_completion(samples), _device_scorer())
    assert dev.choices[0].message.content == host.choices[0].message.content
    assert dev.likelihoods == host.likelihoods and dev.degraded == host.degraded
    # Past the kernel's 128 characters: the host native code inside the
    # device session, output still identical.
    long_a, long_b = "tok" * 60, "tok" * 59 + "alt"
    _assert_device_matches_host([json.dumps({"blob": s, "tag": t})
                                 for s, t in ((long_a, "x"), (long_b, "x"), (long_a, "y"))])


def test_port_consolidation_equals_the_jax_device_scorer():
    """The same samples through the JAX package's DeviceSimilarityScorer
    and the port's: the same consensus and likelihoods."""
    from k_llms_tpu.consensus.consolidation import (
        consolidate_chat_completions as jax_consolidate,
    )
    from k_llms_tpu.consensus.device import DeviceSimilarityScorer as JaxDeviceScorer
    from k_llms_tpu.types import ChatCompletion as JaxChatCompletion

    for doc, n in (("invoice", 8), ("profile", 3)):
        samples = make_noisy_samples(TRUTH_DOCS[doc], n, 0.2, seed=41 + n)
        payload = _completion(samples).model_dump()
        ref = jax_consolidate(JaxChatCompletion.model_validate(payload),
                              JaxDeviceScorer(method="levenshtein"))
        got = consolidate_chat_completions(_completion(samples), _device_scorer())
        assert got.choices[0].message.content == ref.choices[0].message.content
        assert got.likelihoods == ref.likelihoods


# -- fallback and the backend -----------------------------------------------------

def test_failpoint_fallback_is_lossless_and_counted():
    samples = make_noisy_samples(TRUTH_DOCS["profile"], 8, 0.15, seed=17)
    host = _consolidate(samples, SimilarityScorer.levenshtein())
    scorer = _device_scorer()
    before = CONSENSUS_EVENTS.snapshot()
    with fp.failpoints({"consensus.device": FailSpec(action="fallback", times=2)}):
        assert _consolidate(samples, scorer) == host
        assert _consolidate(samples, scorer) == host
        assert _consolidate(samples, scorer) == host  # spec exhausted: device
    after = CONSENSUS_EVENTS.snapshot()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert delta("consensus.fallback_failpoint") == 2
    assert delta("consensus.host_dispatch") == 2
    assert delta("consensus.device_dispatch") == 1


def test_busy_device_lock_queues_the_consolidation_on_the_device():
    """A consolidation that finds the device lock held waits for it and then
    scores on the device: no host path, no busy event."""
    import threading

    samples = make_noisy_samples(TRUTH_DOCS["invoice"], 8, 0.15, seed=19)
    host = _consolidate(samples, SimilarityScorer.levenshtein())
    scorer = _device_scorer()
    before = CONSENSUS_EVENTS.snapshot()
    got = []
    with scorer._device_lock:
        worker = threading.Thread(target=lambda: got.append(_consolidate(samples, scorer)))
        worker.start()
        worker.join(0.5)
        assert worker.is_alive() and not got  # waiting for the lock
    worker.join(30)
    assert got == [host]
    after = CONSENSUS_EVENTS.snapshot()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert delta("consensus.device_dispatch") == 1 and delta("consensus.device_pairs") > 0
    assert delta("consensus.device_busy") == 0 and delta("consensus.host_dispatch") == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_device_work_error_falls_back_on_cpu_and_raises_on_a_card(device, monkeypatch):
    """An error of the batched work (as a kernel that fails to build or
    launch raises): on a CPU device the consolidation takes the host path,
    counted; on a card it propagates and nothing is scored on the host."""
    from k_llms_tpu_torch.consensus import device as dc

    samples = make_noisy_samples(TRUTH_DOCS["profile"], 8, 0.15, seed=23)
    host = _consolidate(samples, SimilarityScorer.levenshtein())
    scorer = _device_scorer()
    scorer.device = torch.device(device)  # the card is never touched below
    monkeypatch.setattr(scorer, "_on_device", contextlib.nullcontext)

    def failing(pairs, device="cpu"):
        raise RuntimeError("CUDA kernel levenshtein launch failed with status 700")

    monkeypatch.setattr(dc, "batched_levenshtein", failing)
    before = CONSENSUS_EVENTS.snapshot()
    if device == "cpu":
        assert _consolidate(samples, scorer) == host
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            _consolidate(samples, scorer)
    after = CONSENSUS_EVENTS.snapshot()
    fell_back = after.get("consensus.fallback_error", 0) - before.get("consensus.fallback_error", 0)
    assert fell_back == (1 if device == "cpu" else 0)


def test_backend_health_carries_consensus_and_the_knob_turns_it_off():
    from k_llms_tpu.backends.tpu import BackendConfig as JaxBackendConfig
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS, BackendConfig

    assert "device_consensus" not in UNPORTED_FIELDS
    assert BackendConfig.model_fields["device_consensus"].default is True
    assert JaxBackendConfig.model_fields["device_consensus"].default is True
    client = KLLMs(backend="cuda", model="tiny", device="cpu", max_new_tokens=8)
    backend = client.backend
    scorer = backend.similarity_scorer("levenshtein")
    assert isinstance(scorer, DeviceSimilarityScorer) and scorer.device == torch.device("cpu")
    client.chat.completions.create(messages=[{"role": "user", "content": "hello there"}],
                                   n=3, temperature=1.0, seed=11)
    for snap in (backend.scheduler.health(), backend.health()):
        consensus = snap["consensus"]
        assert consensus["device_consensus"] is True
        assert set(consensus["cache"]) == {"hits", "misses", "entries", "evictions"}
    assert sum(backend.health()["consensus"]["events"].values()) > 0
    client.close()
    off = KLLMs(backend="cuda", model="tiny", device="cpu", device_consensus=False)
    scorer = off.backend.similarity_scorer("levenshtein")
    assert not isinstance(scorer, DeviceSimilarityScorer) and isinstance(scorer, SimilarityScorer)
    assert off.backend.health()["consensus"]["device_consensus"] is False
    off.close()
