"""The embeddings similarity route, port against JAX (twin of
``tests/test_embeddings_route_parity.py``, which runs only where the
reference tree is mounted): both packages' consensus get the same
deterministic embedder (the fake backend's hash-based vectors), so any
divergence is in the similarity plumbing: the >50-char gate, cosine
normalisation, caches, alignment driven by embedding similarities, medoid
election, and the degradation when the embedder fails. Where the reference
tree is mounted, the reference engine's outcome is held too."""

import json

import numpy as np

from k_llms_tpu.consensus import recursion as jax_recursion
from k_llms_tpu.consensus.settings import ConsensusSettings as JaxSettings
from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
from k_llms_tpu_torch.backends.fake import deterministic_embedding
from k_llms_tpu_torch.consensus import recursion
from k_llms_tpu_torch.consensus.settings import ConsensusSettings
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

from reference_oracle import load_reference_engine, reference_available

LONG = {
    "a": "The shipment of industrial widgets departed the Rotterdam warehouse "
    "on Tuesday morning and is expected at the Hamburg depot within three days.",
    "a2": "The shipment of industrial widgets left the Rotterdam warehouse on "
    "Tuesday morning and should reach the Hamburg depot within three days.",
    "b": "Payment terms are net thirty days from the invoice issue date, with a "
    "two percent discount applied for settlement within ten calendar days.",
    "c": "All customer support inquiries should be directed to the billing "
    "department via email and will be answered within two business days.",
}
PACKAGES = ((recursion, ConsensusSettings, SimilarityScorer),
            (jax_recursion, JaxSettings, JaxScorer))


def embed_fn(texts):
    return [deterministic_embedding(t) for t in texts]


def _run(pkg, samples, embed=embed_fn):
    mod, settings_cls, scorer_cls = pkg
    scorer = scorer_cls(method="embeddings", embed_fn=embed)
    settings = settings_cls(string_similarity_method="embeddings")
    aligned, _ = mod.recursive_list_alignments(json.loads(json.dumps(samples)), scorer,
                                               settings.min_support_ratio)
    return mod.consensus_values(aligned, settings, scorer)


def _run_reference(samples, embed=embed_fn):
    ref = load_reference_engine()
    ref.embeddings_cache.clear()
    ref.similarity_cache.clear()
    settings = ref.ConsensusSettings(string_similarity_method="embeddings")
    aligned, _ = ref.recursive_list_alignments(json.loads(json.dumps(samples)), "embeddings",
                                               embed, None, settings.min_support_ratio)
    return ref.consensus_values(aligned, settings, embed, None)


def _assert_deep_close(a, b, path=""):
    assert type(a) is type(b) or (
        isinstance(a, (int, float)) and isinstance(b, (int, float))
    ), f"type mismatch at {path}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert set(a) == set(b), f"key mismatch at {path}: {set(a)} vs {set(b)}"
        for k in a:
            _assert_deep_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), f"length mismatch at {path}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_deep_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=path)
    else:
        assert a == b, f"value mismatch at {path}: {a!r} vs {b!r}"


def _all(samples, embed=embed_fn):
    ours = _run(PACKAGES[0], samples, embed)
    for other in [_run(PACKAGES[1], samples, embed)] + (
            [_run_reference(samples, embed)] if reference_available() else []):
        _assert_deep_close(ours[0], other[0], "value")
        _assert_deep_close(ours[1], other[1], "confidence")
    return ours


def test_long_string_medoid_via_embeddings():
    val, _ = _all([{"summary": LONG["a"]}, {"summary": LONG["a2"]}, {"summary": LONG["b"]}])
    assert val["summary"] in (LONG["a"], LONG["a2"])


def test_list_alignment_driven_by_embeddings():
    val, _ = _all([
        {"notes": [LONG["a"], LONG["b"], LONG["c"]]},
        {"notes": [LONG["b"], LONG["a2"], LONG["c"]]},
        {"notes": [LONG["c"], LONG["b"], LONG["a"]]},
    ])
    assert len(val["notes"]) == 3


def test_mixed_short_strings_use_fallback_identically():
    val, _ = _all([
        {"city": "Amsterdam", "summary": LONG["a"]},
        {"city": "Amsterdem", "summary": LONG["a2"]},
        {"city": "Amsterdam", "summary": LONG["a"]},
    ])
    assert val["city"] == "Amsterdam"


def test_embedding_failure_degrades_identically():
    def flaky_embed(texts):
        raise RuntimeError("embedding backend down")

    val, conf = _all([{"summary": LONG["a"]}, {"summary": LONG["a2"]}, {"summary": LONG["b"]}],
                     flaky_embed)
    assert val["summary"] in LONG.values() and conf is not None
