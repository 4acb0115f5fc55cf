"""The port's twin of ``tests/test_voting.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Vote-based consensus (reference consensus_utils :936-982).
"""

from k_llms_tpu_torch.consensus.settings import ConsensusSettings
from k_llms_tpu_torch.consensus.voting import voting_consensus


def settings(**kw):
    return ConsensusSettings(**kw)


def test_string_majority():
    val, conf = voting_consensus(["yes", "yes", "no"], settings())
    assert val == "yes"
    assert conf == round(2 / 3, 5)


def test_sanitized_forms_vote_together_original_spelling_wins():
    val, conf = voting_consensus(["São Paulo", "sao paulo", "Rio"], settings())
    assert val == "São Paulo"  # first-seen original spelling
    assert conf == round(2 / 3, 5)


def test_none_excluded_from_candidates_but_counted_in_total():
    val, conf = voting_consensus(["a", None, None], settings())
    assert val == "a"
    assert conf == round(1 / 3, 5)


def test_none_as_candidate_allowed():
    val, conf = voting_consensus(["a", None, None], settings(allow_none_as_candidate=True))
    assert val is None
    assert conf == round(2 / 3, 5)


def test_booleans_none_is_false():
    val, conf = voting_consensus([True, None, False], settings())
    assert val is False
    assert conf == round(2 / 3, 5)


def test_all_none():
    val, conf = voting_consensus([None, None], settings(), parent_valid_frac=0.5)
    assert val is None
    assert conf == 0.5


def test_parent_valid_frac_scales():
    val, conf = voting_consensus(["x", "x"], settings(), parent_valid_frac=0.5)
    assert val == "x"
    assert conf == 0.5
