"""The backend's embeddings as a similarity signal, port against JAX (twin
of ``tests/test_embedding_signal.py``): ``CudaBackend(device="cpu")``'s
mean-pooled final hidden states equal the JAX ``TpuBackend``'s within 1e-5
on the same tiny weights, and in both packages paraphrases outscore
unrelated text, small corruptions stay close, identical strings score near
one, the embedding route's medoid election rejects the outlier as the
Levenshtein route does, and the backend's scorer takes the live
embeddings."""

import numpy as np
import pytest

from _torch_serving import port_backend
from conftest import shared_engine
from k_llms_tpu.backends.tpu import TpuBackend
from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
from k_llms_tpu.consensus.similarity import cosine_similarity as jax_cosine
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer, cosine_similarity

PARAPHRASES = [
    "The shipment of industrial widgets departed the Rotterdam warehouse on "
    "Tuesday morning and is expected at the Hamburg depot within three days.",
    "The shipment of industrial widgets left the Rotterdam warehouse on "
    "Tuesday morning and should reach the Hamburg depot within three days.",
]
UNRELATED = [
    "Payment terms are net thirty days from the invoice issue date, with a "
    "two percent discount applied for settlement within ten calendar days.",
    "All customer support inquiries should be directed to the billing "
    "department via email and will be answered within two business days.",
]
CORRUPTED = PARAPHRASES[0].replace("Tuesday", "Tuesdya").replace("widgets", "widgtes")


@pytest.fixture(scope="module")
def backends():
    port = port_backend(paged=False)
    jax_backend = TpuBackend(model="tiny", engine=shared_engine("tiny"))
    yield {"port": (port, SimilarityScorer, cosine_similarity),
           "jax": (jax_backend, JaxScorer, jax_cosine)}
    port.close()
    jax_backend.close()


def _cos(backend, cosine, a, b):
    va, vb = backend.embeddings([a, b])
    return cosine(np.asarray(va), np.asarray(vb))


def test_embeddings_equal_jax(backends):
    texts = PARAPHRASES + UNRELATED + [CORRUPTED, "short"]
    got = np.asarray(backends["port"][0].embeddings(texts))
    want = np.asarray(backends["jax"][0].embeddings(texts))
    assert got.shape == want.shape == (len(texts), 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_paraphrases_outscore_unrelated(backends, pkg):
    backend, _, cosine = backends[pkg]
    close = _cos(backend, cosine, PARAPHRASES[0], PARAPHRASES[1])
    far1 = _cos(backend, cosine, PARAPHRASES[0], UNRELATED[0])
    far2 = _cos(backend, cosine, PARAPHRASES[0], UNRELATED[1])
    assert close > far1 and close > far2, (close, far1, far2)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_small_corruptions_stay_close(backends, pkg):
    backend, _, cosine = backends[pkg]
    base = PARAPHRASES[0]
    assert _cos(backend, cosine, base, CORRUPTED) > _cos(backend, cosine, base, UNRELATED[0])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_identical_strings_score_near_one(backends, pkg):
    backend, _, cosine = backends[pkg]
    v = backend.embeddings([PARAPHRASES[0]] * 2)
    assert cosine(np.asarray(v[0]), np.asarray(v[1])) > 0.999


def test_embedding_route_medoid_rejects_outlier(backends):
    """The majority medoid over a cluster of three and an outlier: in the
    cluster under the embedding route (the backend's vectors) and under
    Levenshtein, the outlier's row mean the lowest, and the same row means
    in both packages within 1e-6."""
    majority = PARAPHRASES[0]
    cluster = [majority, majority.replace("Tuesday", "Wednesday"),
               majority.replace("three days", "four days")]
    variants = cluster + [UNRELATED[0]]

    def row_means(scorer):
        return np.array([[scorer.generic(a, b) for b in variants] for a in variants],
                        np.float64).mean(axis=1)

    means = {}
    for pkg, (backend, scorer_cls, _) in backends.items():
        emb = row_means(scorer_cls(method="embeddings", embed_fn=backend.embeddings))
        lev = row_means(scorer_cls(method="levenshtein"))
        assert variants[int(emb.argmax())] in cluster
        assert variants[int(lev.argmax())] in cluster
        assert emb.argmin() == len(variants) - 1
        means[pkg] = (emb, lev)
    np.testing.assert_allclose(means["port"][0], means["jax"][0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(means["port"][1], means["jax"][1])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_backend_scorer_uses_live_embeddings(backends, pkg):
    """The scorer the resources layer builds from the backend (the port's
    device scorer, on its plain versions here) scores >50-char strings by
    the backend's embeddings, not the Levenshtein fallback."""
    backend, _, cosine = backends[pkg]
    scorer = backend.similarity_scorer(method="embeddings")
    got = scorer.generic(PARAPHRASES[0], UNRELATED[0])
    assert got == pytest.approx(_cos(backend, cosine, PARAPHRASES[0], UNRELATED[0]), abs=1e-6)
