"""The port's twin of ``tests/test_embeddings_client.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Client embeddings-helper parity: crop/pricing/validation (`get_embeddings`,
reference `client.py:75-122`) and the async selective-crop + crop-all-retry
ladder (`async_get_embeddings`, reference `client.py:125-196`), plus the two
standalone consensus helpers (`consensus_utils.py:1243-1263`, :1355-1370).
"""

import asyncio
from typing import List

import pytest

from k_llms_tpu_torch.backends.base import Backend, ChatRequest
from k_llms_tpu_torch.client import MAX_TOKENS_PER_MODEL, PRICING, AsyncKLLMs, KLLMs
from k_llms_tpu_torch.consensus import (
    compute_similarity_scores,
    intermediary_consensus_cleanup,
)
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

from reference_oracle import load_reference_engine, reference_available


class RecordingBackend(Backend):
    """Backend that records embedding batches; crops at the character level so
    crop behavior is observable without a tokenizer; optionally fails the first
    embedding call (to exercise the async retry ladder)."""

    def __init__(self, fail_at_call: int = -1, tokens_per_batch: int = 100):
        self.batches: List[List[str]] = []
        self.crop_calls: List[int] = []
        self.models_seen: List[str] = []
        self.fail_at_call = fail_at_call
        self.call_count = 0
        self.tokens_per_batch = tokens_per_batch

    def chat_completion(self, request: ChatRequest):  # pragma: no cover - unused
        raise NotImplementedError

    def embeddings(self, texts: List[str]) -> List[List[float]]:
        self.call_count += 1
        if self.call_count - 1 == self.fail_at_call:
            raise RuntimeError("transient embedding failure")
        self.batches.append(list(texts))
        return [[float(len(t))] for t in texts]

    def embeddings_with_usage(self, texts: List[str], model=None):
        self.models_seen.append(model)
        return self.embeddings(texts), self.tokens_per_batch

    def crop_texts(self, texts: List[str], max_tokens: int, model=None) -> List[str]:
        self.crop_calls.append(len(texts))
        return [t[:max_tokens] for t in texts]


def test_get_embeddings_validates_model():
    client = KLLMs(backend=RecordingBackend())
    with pytest.raises(ValueError, match="not supported"):
        client.get_embeddings(["hello"], model="text-embedding-ada-002")


def test_get_embeddings_crops_and_batches():
    backend = RecordingBackend()
    client = KLLMs(backend=backend)
    texts = ["x" * 10000, "short", "y" * 9000]
    out = client.get_embeddings(texts, model="local", batch_size=2)
    # Character-level crop backend: every text capped at the model's max tokens.
    assert backend.batches[0][0] == "x" * MAX_TOKENS_PER_MODEL["local"]
    assert backend.batches[0][1] == "short"
    assert len(backend.batches) == 2  # 3 texts, batch_size=2
    assert out == [[8191.0], [5.0], [8191.0]]


def test_get_embeddings_pricing_accounting(capsys):
    backend = RecordingBackend(tokens_per_batch=1_000_000)
    client = KLLMs(backend=backend)
    client.get_embeddings(["a", "b"], model="text-embedding-3-small", verbose=True)
    captured = capsys.readouterr().out
    # 1M tokens at $0.020 / 1M == $0.02, printed exactly like the reference.
    assert "TOTAL PRICE: $0.020000" in captured
    assert PRICING["text-embedding-3-small"] == 0.020


def test_async_get_embeddings_selective_crop():
    backend = RecordingBackend()
    client = AsyncKLLMs(backend=backend)
    long_text = "z" * (MAX_TOKENS_PER_MODEL["local"] * 3 + 10)
    out = asyncio.run(client.async_get_embeddings([long_text, "tiny"], model="local"))
    # Selective crop: only the plausibly-over-cap text goes through crop_texts.
    assert backend.crop_calls == [1]
    assert out == [[float(MAX_TOKENS_PER_MODEL["local"])], [4.0]]


def test_async_get_embeddings_short_texts_skip_crop():
    backend = RecordingBackend()
    client = AsyncKLLMs(backend=backend)
    asyncio.run(client.async_get_embeddings(["a", "b", "c"], model="local"))
    assert backend.crop_calls == []


def test_async_get_embeddings_retries_with_crop_all():
    backend = RecordingBackend(fail_at_call=0)
    client = AsyncKLLMs(backend=backend)
    out = asyncio.run(client.async_get_embeddings(["hello", "world!"], model="local"))
    # First attempt failed; retry cropped ALL texts then succeeded.
    assert backend.crop_calls == [2]
    assert out == [[5.0], [6.0]]


def test_async_retry_accumulates_price_across_attempts(capsys):
    # 3 batches of 1; batch 2 (index 1) fails — the successful first batch's
    # tokens must still be billed in the final total (reference keeps one
    # running total_price across the failed try and the fallback loop).
    backend = RecordingBackend(fail_at_call=1, tokens_per_batch=1_000_000)
    client = AsyncKLLMs(backend=backend)
    out = asyncio.run(
        client.async_get_embeddings(
            ["aa", "bb", "cc"], model="text-embedding-3-small", batch_size=1, verbose=True
        )
    )
    assert len(out) == 3
    # 1 successful batch before the failure + 3 on retry = 4M tokens at $0.02/1M.
    assert "TOTAL PRICE: $0.080000" in capsys.readouterr().out


def test_model_passed_through_to_backend():
    backend = RecordingBackend()
    client = KLLMs(backend=backend)
    client.get_embeddings(["x"], model="text-embedding-3-large")
    assert backend.models_seen == ["text-embedding-3-large"]


def test_local_model_resolves_to_backend_default():
    backend = RecordingBackend()
    backend.embedding_model_name = "text-embedding-3-small"
    client = KLLMs(backend=backend)
    client.get_embeddings(["x"], model="local")
    # "local" maps to the model the backend will actually hit, so pricing and
    # crop caps follow it.
    assert backend.models_seen == ["text-embedding-3-small"]


def test_cuda_tokenizer_crop():
    from k_llms_tpu_torch.backends.cuda import CudaBackend

    backend = CudaBackend(device="cpu", model="tiny")
    # Byte tokenizer: 1 token per byte; short texts skip the encode round-trip.
    assert backend.crop_texts(["abcdefgh", "xy"], max_tokens=4) == ["abcd", "xy"]
    # The internal cap in embeddings() agrees with the crop: same vectors.
    long = "q" * 20000
    short = long[:8191]
    assert backend.embeddings([long])[0] == backend.embeddings([short])[0]


def test_paid_backend_unknown_default_model_errors():
    backend = RecordingBackend()
    backend.embedding_model_name = "text-embedding-ada-002"
    backend.bills_usage = True  # paid backend: a $0 fallback would mis-bill
    client = KLLMs(backend=backend)
    with pytest.raises(ValueError, match="not supported"):
        client.get_embeddings(["x"], model="local")


def test_unknown_backend_default_model_is_tolerated():
    backend = RecordingBackend()
    backend.embedding_model_name = "custom-embedder-v2"
    client = KLLMs(backend=backend)
    # "local" resolves to an out-of-table backend default: default cap, $0 price.
    out = client.get_embeddings(["hello"], model="local")
    assert out == [[5.0]]
    assert backend.models_seen == ["custom-embedder-v2"]
    # A USER-named unknown model still errors (reference behavior).
    with pytest.raises(ValueError, match="not supported"):
        client.get_embeddings(["hello"], model="custom-embedder-v2")


# --- standalone consensus helpers -------------------------------------------


def test_compute_similarity_scores_basic():
    scorer = SimilarityScorer(method="levenshtein")
    assert compute_similarity_scores([], scorer) == []
    assert compute_similarity_scores(["solo"], scorer) == [1.0]
    scores = compute_similarity_scores(["alpha", "alpha", "omega"], scorer)
    assert scores[0] == scores[1] > scores[2]


def test_intermediary_consensus_cleanup():
    obj = {
        "keep": "  value  ",
        "empty": "",
        "blank": "   ",
        "nested": {"inner": "", "deep": {"x": "  "}},
        "items": ["", "a", {"b": ""}],
        "num": 0,
        "flag": False,
    }
    cleaned = intermediary_consensus_cleanup(obj)
    assert cleaned == {"keep": "value", "items": ["a"], "num": 0, "flag": False}
    assert intermediary_consensus_cleanup({"a": {"b": ""}}) is None
    assert intermediary_consensus_cleanup([""]) is None


@pytest.mark.skipif(not reference_available(), reason="reference tree not mounted")
def test_helpers_parity_vs_reference():
    ref = load_reference_engine()
    values_sets = [
        ["alpha beta", "alpha betta", "gamma delta"],
        [1.0, 1.01, 5.0, None and 0 or 2.0],
        [{"a": "x"}, {"a": "y"}, {"a": "x"}],
    ]
    settings = ref.ConsensusSettings(string_similarity_method="levenshtein")
    ours = SimilarityScorer(method="levenshtein")
    for values in values_sets:
        expected = ref.compute_similarity_scores(values, settings, None)
        got = compute_similarity_scores(values, ours)
        assert got == expected

    structures = [
        {"a": " x ", "b": "", "c": {"d": "  ", "e": [1, "", {"f": ""}]}},
        ["", "  ", {"g": ["", 0, False]}],
        "  trimmed  ",
        0,
        None,
    ]
    for obj in structures:
        assert intermediary_consensus_cleanup(obj) == ref.intermediary_consensus_cleanup(obj)
