"""The graceful-degradation ladder, port against JAX (twin of
``tests/test_failure_tolerance.py``): failed samples drop out of the vote,
malformed JSON degrades to a text wrap, mixed JSON and garbage still
consolidate, one failed sample does not fail the request, the list form
keeps original indexes; and non-finite logit rows sanitise to the same
tokens and finite logprobs as ``k_llms_tpu/ops/sampling.py`` at
temperature 0 and 1 (the JAX draw's uniforms are ``jax.random``'s, which
the port computes bit for bit)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.consensus import consolidation as jax_consolidation
from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
from k_llms_tpu.ops import sampling as jax_sampling
from k_llms_tpu.types import ChatCompletion as JaxChatCompletion
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.consensus import consolidation
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer
from k_llms_tpu_torch.ops import random as rnd
from k_llms_tpu_torch.ops import sampling
from k_llms_tpu_torch.types import ChatCompletion

PACKAGES = {"port": (consolidation, SimilarityScorer, ChatCompletion),
            "jax": (jax_consolidation, JaxScorer, JaxChatCompletion)}


def _completion(cls, contents):
    return cls.model_validate({
        "id": "c", "created": 0, "model": "m", "object": "chat.completion",
        "choices": [{"finish_reason": "stop", "index": i,
                     "message": {"role": "assistant", "content": content}}
                    for i, content in enumerate(contents)],
    })


def _consolidate_both(make):
    """``consolidate_chat_completions`` in each package on ``make(cls)``:
    the dumps equal; returns the port's result."""
    out = {name: mod.consolidate_chat_completions(make(cls), scorer.levenshtein())
           for name, (mod, scorer, cls) in PACKAGES.items()}
    assert out["port"].model_dump() == out["jax"].model_dump()
    return out["port"]


def test_empty_sample_drops_out_of_vote():
    result = _consolidate_both(lambda cls: _completion(cls, ["yes", "yes", ""]))
    assert result.choices[0].message.content == "yes"
    assert result.likelihoods == {"text": 1.0}
    assert len(result.choices) == 4


@pytest.mark.parametrize("content,wrapped", [("{broken json", {"text": "{broken json"}),
                                             (None, {"text": None}),
                                             ('{"a": 1}', {"a": 1})])
def test_malformed_json_degrades_to_text_wrap(content, wrapped):
    assert consolidation._safe_parse_content(content) == wrapped
    assert jax_consolidation._safe_parse_content(content) == wrapped


def test_mixed_json_and_garbage_still_consolidates():
    result = _consolidate_both(lambda cls: _completion(cls, ['{"a": 1}', '{"a": 1}', "total garbage"]))
    assert result.choices[0].message.content is not None
    assert result.likelihoods is not None


def test_single_sample_failure_does_not_fail_request(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    out = {}
    for name, client_cls in (("port", KLLMs), ("jax", JaxKLLMs)):
        client = client_cls(backend="fake", responses=[["ok answer", "", "ok answer"]])
        out[name] = client.chat.completions.create(messages=[{"role": "user", "content": "q"}],
                                                   model="m", n=3)
    assert out["port"].model_dump() == out["jax"].model_dump()
    assert out["port"].choices[0].message.content == "ok answer"


def test_list_form_preserves_original_sample_indexes():
    def make(cls):
        def one(content):
            return cls.model_validate({
                "id": "c", "created": 0, "model": "m", "object": "chat.completion",
                "choices": [] if content is None else [
                    {"finish_reason": "stop", "index": 0,
                     "message": {"role": "assistant", "content": content}}],
            })
        return [one('{"a": 1}'), one(None), one('{"a": 1}')]

    result = _consolidate_both(make)
    assert [c.index for c in result.choices] == [0, 1, 3]


# Rows: finite; all NaN (uniform after sanitising); one +inf among finite
# values (masked, the best finite value wins greedy); -inf entries; all
# +inf (uniform); NaN beside finite values.
NONFINITE = np.array([
    [1.0, 2.0, 3.0, 4.0, 0.5, -1.0],
    [np.nan] * 6,
    [1.0, np.inf, 0.0, 0.0, -2.0, 0.5],
    [-np.inf, 0.3, -np.inf, 1.2, -0.7, -np.inf],
    [np.inf] * 6,
    [np.nan, -0.5, 2.5, np.nan, 2.4, 0.1],
], np.float32)


def test_sanitize_logits_equals_jax_where_rule():
    got = sampling.sanitize_logits(torch.from_numpy(NONFINITE)).numpy()
    finite = np.isfinite(NONFINITE)
    want = np.where(finite, NONFINITE, -np.inf)
    want = np.where(finite.any(-1, keepdims=True), want, 0.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("key", [0, 7])
def test_nonfinite_logits_sample_as_jax(temperature, key):
    """Tokens equal and every logprob finite and within 1e-6 of JAX's; the
    draw at temperature 1 takes JAX's per-row keys ``fold_in(key, row)``."""
    B, V = NONFINITE.shape
    jt, jl = jax_sampling.sample_logits(jnp.asarray(NONFINITE), jax.random.key(key),
                                        temperature=temperature)
    noise = None
    if temperature > 0:
        keys = rnd.fold_in(rnd.key_data(key).expand(B, 2), torch.arange(B))
        noise = rnd.uniform_tiny(keys, V)
    tt, tl = sampling.sample_logits(torch.from_numpy(NONFINITE), temperature=temperature,
                                    noise=noise)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert np.isfinite(tl.numpy()).all() and np.isfinite(np.asarray(jl)).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    if temperature == 0.0:
        assert tt[0] == 3 and tt[2] == 0  # +inf is masked: the best finite value wins
