"""The port's twin of ``tests/test_primitive.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Primitive consensus: hybrid numeric clustering + similarity medoid
(reference consensus_utils :1075-1237).
"""

import pytest

from k_llms_tpu_torch.consensus.primitive import consensus_as_primitive
from k_llms_tpu_torch.consensus.settings import ConsensusSettings
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer


@pytest.fixture
def scorer():
    return SimilarityScorer(method="levenshtein")


def run(values, scorer, settings=None, **kw):
    return consensus_as_primitive(values, settings or ConsensusSettings(), scorer, **kw)


def test_empty_and_single(scorer):
    assert run([None, None], scorer) == (None, 1.0)
    val, conf = run([5, None], scorer)
    assert val == 5
    assert conf == 0.5  # parent_valid_frac * non_none/total


def test_numeric_majority_cluster(scorer):
    # 100, 101 cluster together at 3% rel_eps; 200 is alone
    val, conf = run([100, 101, 200], scorer)
    assert val == pytest.approx(100.5)
    assert conf == round(2 / 3, 5)


def test_numeric_exact_majority(scorer):
    val, conf = run([7, 7, 7, 9999], scorer)
    assert val == pytest.approx(7.0)
    assert conf == 0.75


def test_numeric_tie_power10_support(scorer):
    # Two singleton clusters: 1000 and 100000... power-of-10 closeness breaks tie
    # via support absorption; deterministic outcome matters more than which wins.
    val, conf = run([1000.0, 10.0], scorer)
    assert val in (1000.0, 10.0)


def test_all_bools_go_numeric_branch_and_return_none(scorer):
    # Quirk parity: type(True)() == False isinstance int => numeric branch,
    # xs skips bools => (None, parent_valid_frac)
    val, conf = run([True, False, True], scorer)
    assert val is None
    assert conf == 1.0


def test_string_medoid(scorer):
    vals = ["the cat sat on the mat", "the cat sat on a mat", "dogs everywhere"]
    val, conf = run(vals, scorer)
    assert val in vals[:2]
    assert 0 < conf <= 1.0


def test_medoid_confidence_rounding(scorer):
    val, conf = run(["aaaa", "aaab"], scorer)
    assert conf == round(conf, 5)


def test_index_tuple_medoid(scorer):
    # The reference re-elects alignment group representatives by running
    # consensus_as_primitive on (list_idx, pos) tuples (:308-318)
    vals = [(0, 1), (1, 1), (2, 5)]
    val, conf = run(vals, scorer)
    assert val == (0, 1) or val == (1, 1)


def test_llm_consensus_mode(scorer):
    settings = ConsensusSettings(
        string_consensus_method="llm-consensus", string_similarity_method="embeddings"
    )
    s = SimilarityScorer(method="embeddings", embed_fn=None)
    val, conf = consensus_as_primitive(
        ["The sky is blue", "The sky is blue today", "El cielo es azul"],
        settings,
        s,
        llm_consensus_fn=lambda vs: "The sky is blue",
    )
    assert val == "The sky is blue"
    assert 0 < conf <= 1.0


def test_llm_consensus_requires_fn(scorer):
    settings = ConsensusSettings(
        string_consensus_method="llm-consensus", string_similarity_method="embeddings"
    )
    with pytest.raises(ValueError):
        consensus_as_primitive(["a b c d", "e f g h"], settings, scorer)


def test_none_majority_returns_none(scorer):
    # single non-None short-circuits earlier (:1085), so use two spread values
    val, conf = run([None, None, 5.0, 6.0], scorer)
    assert val is None
    assert conf == 0.5
