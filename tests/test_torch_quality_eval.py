"""The port's consensus-quality eval (``utils/quality.py``), twin of
``tests/test_quality_eval.py``: its eight cases on the port, then
``consensus_quality_eval`` through both packages' public pipelines
(``KLLMs(backend="fake")`` -> consolidation -> consensus) over every truth
document, two noise levels and two sample counts, with the accuracies equal
as floats."""

import json

import pytest

from k_llms_tpu.utils import quality as jax_quality
from k_llms_tpu_torch.utils.quality import (
    DEFAULT_TRUTH,
    PO_TRUTH,
    PROFILE_TRUTH,
    TRUTH_DOCS,
    consensus_quality_eval,
    field_accuracy,
    make_noisy_samples,
)

from reference_oracle import load_reference_engine, reference_available


def test_field_accuracy_exact():
    assert field_accuracy(DEFAULT_TRUTH, DEFAULT_TRUTH) == 1.0


def test_field_accuracy_partial():
    pred = dict(DEFAULT_TRUTH)
    pred["vendor"] = "wrong"
    acc = field_accuracy(pred, DEFAULT_TRUTH)
    assert 0 < acc < 1
    assert acc == jax_quality.field_accuracy(pred, DEFAULT_TRUTH)


def test_field_accuracy_float_tolerance():
    pred = json.loads(json.dumps(DEFAULT_TRUTH))
    pred["total"] = DEFAULT_TRUTH["total"] * 1.001  # within 0.5%
    assert field_accuracy(pred, DEFAULT_TRUTH) == 1.0
    pred["total"] = DEFAULT_TRUTH["total"] * 1.2
    assert field_accuracy(pred, DEFAULT_TRUTH) < 1.0


def test_field_accuracy_missing_rows_penalized():
    pred = json.loads(json.dumps(DEFAULT_TRUTH))
    pred["line_items"] = pred["line_items"][:1]
    assert field_accuracy(pred, DEFAULT_TRUTH) < 1.0


def test_noise_model_deterministic():
    a = make_noisy_samples(DEFAULT_TRUTH, 4, 0.3, 42)
    b = make_noisy_samples(DEFAULT_TRUTH, 4, 0.3, 42)
    assert a == b
    assert a != make_noisy_samples(DEFAULT_TRUTH, 4, 0.3, 43)
    for s in a:
        json.loads(s)
    # The same noise draws as the JAX package's copy, for every document.
    for doc in TRUTH_DOCS.values():
        assert make_noisy_samples(doc, 6, 0.3, 9) == jax_quality.make_noisy_samples(doc, 6, 0.3, 9)


def test_noise_zero_is_identity():
    for s in make_noisy_samples(DEFAULT_TRUTH, 3, 0.0, 7):
        assert json.loads(s) == DEFAULT_TRUTH


def test_consensus_beats_single_sample():
    """Consensus over n noisy samples is more accurate than one sample."""
    r = consensus_quality_eval(n_values=(3, 8), trials=8, seed=1)
    assert r["consensus_n3"] >= r["single_sample"]
    assert r["consensus_n8"] > r["single_sample"] + 0.05
    assert r["consensus_n8"] >= 0.85


def test_quality_noise_model_matches_jax_and_reference_consensus():
    """On this noise model the port's consensus (levenshtein mode, the
    reference-exact posture) equals the JAX package's, and the reference
    engine's where its tree is mounted."""
    from k_llms_tpu.consensus import recursion as jax_recursion
    from k_llms_tpu.consensus.settings import ConsensusSettings as JaxSettings
    from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
    from k_llms_tpu_torch.consensus.recursion import consensus_values, recursive_list_alignments
    from k_llms_tpu_torch.consensus.settings import ConsensusSettings
    from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

    def _boom(*a, **kw):  # embeddings must not be consulted in levenshtein mode
        raise RuntimeError("no embeddings in levenshtein mode")

    ref = load_reference_engine() if reference_available() else None
    for trial in range(3):
        samples = [json.loads(s) for s in make_noisy_samples(DEFAULT_TRUTH, 8, 0.25, 500 + trial)]
        results = []
        for settings_cls, scorer_cls, align, values in (
                (ConsensusSettings, SimilarityScorer, recursive_list_alignments, consensus_values),
                (JaxSettings, JaxScorer, jax_recursion.recursive_list_alignments,
                 jax_recursion.consensus_values)):
            scorer = scorer_cls(method="levenshtein", embed_fn=_boom)
            settings = settings_cls(reference_exact=True, string_similarity_method="levenshtein")
            aligned, _ = align(json.loads(json.dumps(samples)), scorer, settings.min_support_ratio)
            results.append(values(aligned, settings, scorer))
        assert results[0] == results[1]
        if ref is not None:
            rsettings = ref.ConsensusSettings(string_similarity_method="levenshtein")
            raligned, _ = ref.recursive_list_alignments(
                samples, "levenshtein", _boom, None, rsettings.min_support_ratio)
            assert results[0][0] == ref.consensus_values(raligned, rsettings, _boom, None)[0]


@pytest.mark.parametrize("n_values", [(3,), (8,)])
@pytest.mark.parametrize("noise", [0.15, 0.35])
@pytest.mark.parametrize("doc", ["DEFAULT_TRUTH", "PO_TRUTH", "PROFILE_TRUTH"])
def test_quality_eval_equals_jax(doc, noise, n_values):
    truth = {"DEFAULT_TRUTH": DEFAULT_TRUTH, "PO_TRUTH": PO_TRUTH,
             "PROFILE_TRUTH": PROFILE_TRUTH}[doc]
    kw = dict(n_values=n_values, trials=3, noise=noise, seed=4, truth=truth)
    got = consensus_quality_eval(**kw)
    want = jax_quality.consensus_quality_eval(**kw)
    assert got == want
    assert set(got) == {f"consensus_n{n_values[0]}", "single_sample", "truth_docs"}
    assert all(isinstance(v, float) for k, v in got.items() if k != "truth_docs")
