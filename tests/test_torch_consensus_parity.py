"""The consensus fuzz, port against JAX (twin of
``tests/test_reference_parity.py``, which runs only where the reference tree
is mounted): the same randomized nested sample sets (random records under
four similarity methods, numeric primitives, votes, gnarly unicode and
mixed-type structures, and the headline n = 24-32) go through both
packages' ``recursive_list_alignments`` and ``consensus_values`` in the
reference-exact posture, and the aligned samples, consensus values,
likelihood structures and key mappings are equal. The sample generators
are the JAX test's own."""

import random

import pytest

from k_llms_tpu.consensus import primitive as jax_primitive
from k_llms_tpu.consensus import recursion as jax_recursion
from k_llms_tpu.consensus import voting as jax_voting
from k_llms_tpu.consensus.settings import ConsensusSettings as JaxSettings
from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
from k_llms_tpu_torch.backends.fake import deterministic_embedding
from k_llms_tpu_torch.consensus import primitive, recursion, voting
from k_llms_tpu_torch.consensus.settings import ConsensusSettings
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer
from test_reference_parity import (
    ENUMS,
    PARITY_CASES,
    _normalize,
    _perturb_number,
    make_gnarly_record,
    make_samples,
    perturb_gnarly,
)

PACKAGES = {"port": (recursion, ConsensusSettings, SimilarityScorer),
            "jax": (jax_recursion, JaxSettings, JaxScorer)}


def embed(texts):
    return [deterministic_embedding(t) for t in texts]


def run(pkg, samples, method):
    mod, settings_cls, scorer_cls = PACKAGES[pkg]
    settings = settings_cls(reference_exact=True, string_similarity_method=method)
    scorer = scorer_cls(method=method, embed_fn=embed)
    aligned, mappings = mod.recursive_list_alignments(samples, scorer, settings.min_support_ratio)
    aligned = [(d if isinstance(d, dict) else {}) for d in aligned]
    value, conf = mod.consensus_values(aligned, settings, scorer)
    return _normalize(aligned), _normalize(value), _normalize(conf), mappings


def assert_same(samples, method):
    ours = run("port", samples, method)
    theirs = run("jax", samples, method)
    for what, a, b in zip(("alignment", "value", "likelihoods", "key mappings"), ours, theirs):
        assert a == b, f"{what} diverged"


@pytest.mark.parametrize("seed,method", PARITY_CASES)
def test_parity_random_structures(seed, method):
    assert_same(make_samples(seed), method)


@pytest.mark.parametrize("seed", range(10))
def test_parity_primitive_numeric(seed):
    rng = random.Random(1000 + seed)
    base = rng.uniform(-100, 100)
    values = [_perturb_number(rng, base, p=0.8) if rng.random() > 0.2 else None
              for _ in range(rng.randint(2, 8))]
    ours = primitive.consensus_as_primitive(
        values, ConsensusSettings(reference_exact=True),
        SimilarityScorer(method="embeddings", embed_fn=embed))
    theirs = jax_primitive.consensus_as_primitive(
        values, JaxSettings(reference_exact=True), JaxScorer(method="embeddings", embed_fn=embed))
    assert ours == theirs


@pytest.mark.parametrize("seed", range(10))
def test_parity_voting(seed):
    rng = random.Random(2000 + seed)
    pool = ENUMS + [None, "São Paulo", "sao paulo"]
    values = [rng.choice(pool) for _ in range(rng.randint(2, 9))]
    assert (voting.voting_consensus(values, ConsensusSettings(reference_exact=True))
            == jax_voting.voting_consensus(values, JaxSettings(reference_exact=True)))


@pytest.mark.parametrize("method", ["levenshtein", "jaccard"])
@pytest.mark.parametrize("seed", range(15))
def test_parity_gnarly_structures(seed, method):
    rng = random.Random(10_000 + seed)
    base = make_gnarly_record(rng)
    n = rng.randint(2, 16)
    assert_same([perturb_gnarly(rng, base) for _ in range(n)], method)


@pytest.mark.parametrize("seed", range(6))
def test_parity_headline_n32(seed):
    rng = random.Random(31_000 + seed)
    base = make_gnarly_record(rng)
    n = rng.randint(24, 32)
    assert_same([perturb_gnarly(rng, base) for _ in range(n)], "levenshtein")
