"""The port's twin of ``tests/test_likelihood_weighting.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Likelihood-weighted consensus (BASELINE.json config 3): sample votes are
weighted by softmax of sequence logprobs; OFF by default (reference-exact).
"""

import math

import pytest

from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.consensus.settings import ConsensusSettings
from k_llms_tpu_torch.consensus.voting import voting_consensus
from k_llms_tpu_torch.consensus.primitive import consensus_as_primitive
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer
from k_llms_tpu_torch.types import ChatCompletion
from k_llms_tpu_torch.consensus.consolidation import consolidate_chat_completions


def test_weighted_voting_flips_majority():
    settings = ConsensusSettings()
    # unweighted: "no" wins 2-1
    val, conf = voting_consensus(["yes", "no", "no"], settings)
    assert val == "no"
    # one confident "yes" outweighs two unconfident "no"s
    val, conf = voting_consensus(["yes", "no", "no"], settings, weights=[0.8, 0.1, 0.1])
    assert val == "yes"
    assert conf == pytest.approx(0.8, abs=1e-4)


def test_weighted_numeric_cluster():
    scorer = SimilarityScorer.levenshtein()
    settings = ConsensusSettings()
    # 100 vs 200: the heavier sample wins even though counts tie
    val, conf = consensus_as_primitive(
        [100.0, 200.0], settings, scorer, weights=[0.9, 0.1]
    )
    assert val == pytest.approx(100.0)
    assert conf == pytest.approx(0.9, abs=1e-4)


def test_weights_none_is_reference_exact():
    scorer = SimilarityScorer.levenshtein()
    settings = ConsensusSettings()
    a = consensus_as_primitive([100, 101, 200], settings, scorer)
    b = consensus_as_primitive([100, 101, 200], settings, scorer, weights=None)
    assert a == b


def _completion_with_logprobs(contents_and_lps):
    return ChatCompletion.model_validate(
        {
            "id": "c",
            "created": 0,
            "model": "m",
            "object": "chat.completion",
            "choices": [
                {
                    "finish_reason": "stop",
                    "index": i,
                    "message": {"role": "assistant", "content": content},
                    "sample_logprob": lp,
                }
                for i, (content, lp) in enumerate(contents_and_lps)
            ],
        }
    )


def test_end_to_end_weighted_consolidation():
    comp = _completion_with_logprobs([("yes", -1.0), ("no", -8.0), ("no", -9.0)])
    scorer = SimilarityScorer.levenshtein()
    # default: agreement voting, "no" wins
    plain = consolidate_chat_completions(comp, scorer)
    assert plain.choices[0].message.content == "no"
    # weighted: the much-more-likely "yes" sample wins
    weighted = consolidate_chat_completions(
        comp, scorer, consensus_settings=ConsensusSettings(likelihood_weighting=True)
    )
    assert weighted.choices[0].message.content == "yes"


def test_cuda_backend_attaches_sample_logprob():
    client = KLLMs(backend="cuda", device="cpu", model="tiny", max_new_tokens=8)
    resp = client.chat.completions.create(
        messages=[{"role": "user", "content": "w"}], model="tiny", n=2, seed=4
    )
    for choice in resp.choices[1:]:
        lp = getattr(choice, "sample_logprob", None)
        assert lp is not None and lp <= 0.0
