"""The local backend's contract on tiny, port against JAX (twin of
``tests/test_tpu_backend.py``): ``CudaBackend(device="cpu")`` and the JAX
``TpuBackend`` on the same weights answer the same requests the same way:
the consensus contract, seed reproducibility, greedy unanimity, the
logprobs and top-logprobs surfaces and their validation, stop strings,
the embeddings and the local llm-consensus, and five concurrent requests
coalescing into one launch with each request's answer equal to its solo
run."""

import threading
import time

import numpy as np
import pytest

from _torch_serving import port_backend
from conftest import shared_engine
from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.backends.tpu import TpuBackend
from k_llms_tpu_torch import KLLMs


@pytest.fixture(scope="module")
def clients():
    port = KLLMs(backend=port_backend(paged=True, max_new_tokens=16), model="tiny")
    jax_client = JaxKLLMs(backend=TpuBackend(
        model="tiny", max_new_tokens=16,
        engine=shared_engine("tiny", kv_layout="paged", kv_page_size=8)), model="tiny")
    yield {"port": port, "jax": jax_client}
    port.close()
    jax_client.close()


def both(clients, **kw):
    """The request through each package: contents, finish reasons,
    likelihoods and usage equal, sample logprobs within 1e-4."""
    got = {k: c.chat.completions.create(model="tiny", **kw) for k, c in clients.items()}
    p, j = got["port"], got["jax"]
    assert [c.message.content for c in p.choices] == [c.message.content for c in j.choices]
    assert [c.finish_reason for c in p.choices] == [c.finish_reason for c in j.choices]
    assert p.likelihoods == j.likelihoods
    assert p.usage.model_dump() == j.usage.model_dump()
    np.testing.assert_allclose([c.sample_logprob or 0.0 for c in p.choices[1:]],
                               [c.sample_logprob or 0.0 for c in j.choices[1:]],
                               atol=1e-4, rtol=0)
    return p, j


def test_create_consensus_contract(clients):
    resp, jresp = both(clients, messages=[{"role": "user", "content": "Tell me something"}],
                       n=4, temperature=1.0, seed=11)
    assert len(resp.choices) == 5 and resp.choices[0].index == 0
    assert resp.likelihoods is not None
    assert resp.usage.prompt_tokens > 0 and resp.usage.completion_tokens > 0
    assert resp.system_fingerprint == "k-llms-tpu-torch/tiny"
    assert jresp.system_fingerprint == "k-llms-tpu/tiny"


def test_create_seed_reproducible(clients):
    kw = dict(messages=[{"role": "user", "content": "again"}], n=3, seed=5)
    a, _ = both(clients, **kw)
    b = clients["port"].chat.completions.create(model="tiny", **kw)
    assert [c.message.content for c in a.choices] == [c.message.content for c in b.choices]


def test_greedy_unanimous_consensus(clients):
    resp, _ = both(clients, messages=[{"role": "user", "content": "x"}], n=3, temperature=0.0,
                   seed=1)
    originals = [c.message.content for c in resp.choices[1:]]
    assert originals[0] == originals[1] == originals[2] == resp.choices[0].message.content
    assert resp.likelihoods == {"text": 1.0}


def _entries(resp, i):
    return [(e.token, e.logprob, [(t.token, t.logprob) for t in e.top_logprobs])
            for e in resp.choices[i].logprobs.content]


@pytest.mark.parametrize("top_logprobs", [None, 3])
def test_logprobs_surfaces(clients, top_logprobs):
    resp, jresp = both(clients, messages=[{"role": "user", "content": "lp"}], n=2, seed=4,
                       logprobs=True, top_logprobs=top_logprobs)
    for i in (1, 2):
        got, want = _entries(resp, i), _entries(jresp, i)
        assert [g[0] for g in got] == [w[0] for w in want] and len(got) > 0
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], atol=1e-5)
        assert got[0][1] <= 0.0
        for (_, lp, tops), (_, _, jtops) in zip(got, want):
            assert [t for t, _ in tops] == [t for t, _ in jtops]
            assert len(tops) == (top_logprobs or 0)
            lps = [x for _, x in tops]
            assert lps == sorted(lps, reverse=True) and all(x <= 0.0 for x in lps)
            if tops:
                assert lps[0] >= lp - 1e-5
                np.testing.assert_allclose(lps, [x for _, x in jtops], atol=1e-5)


def test_top_logprobs_requires_logprobs(clients):
    resp, jresp = both(clients, messages=[{"role": "user", "content": "x"}], n=2, seed=4,
                       top_logprobs=3)
    assert resp.choices[1].logprobs is None and jresp.choices[1].logprobs is None


def test_top_logprobs_range_validated(clients):
    messages = []
    for client in clients.values():
        with pytest.raises(ValueError, match="top_logprobs") as err:
            client.chat.completions.create(messages=[{"role": "user", "content": "x"}],
                                           model="tiny", n=1, logprobs=True, top_logprobs=21)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_stop_string_truncates(clients):
    kw = dict(messages=[{"role": "user", "content": "y"}], n=1, seed=3)
    full = both(clients, **kw)[0].choices[0].message.content
    assert len(full) > 1
    stop_char = full[1]
    resp, _ = both(clients, n=2, stop=stop_char, **{k: v for k, v in kw.items() if k != "n"})
    for choice in resp.choices[1:]:
        assert stop_char not in (choice.message.content or "")


def test_backend_embeddings_and_llm_consensus(clients):
    port, jax_backend = clients["port"].backend, clients["jax"].backend
    texts = ["alpha beta", "alpha beta", "gamma"]
    embs = port.embeddings(texts)
    assert len(embs) == 3
    np.testing.assert_allclose(embs[0], embs[1], rtol=1e-5)
    np.testing.assert_allclose(embs, jax_backend.embeddings(texts), atol=1e-5, rtol=0)
    out = port.llm_consensus(["a", "b", "a"])
    assert isinstance(out, str) and out == jax_backend.llm_consensus(["a", "b", "a"])


def test_concurrent_requests_coalesce(clients):
    """Five concurrent clients with one sampling config decode as one
    coalesced launch, each with its own seed stream: every answer equals
    its solo run, which equals the JAX backend's."""
    client = clients["port"]
    backend = client.backend
    prompts = [f"question number {i}" for i in range(5)]

    def ask(c, i):
        return c.chat.completions.create(messages=[{"role": "user", "content": prompts[i]}],
                                         model="tiny", n=2, seed=100 + i, temperature=0.7)

    solo = [ask(client, i) for i in range(5)]
    jsolo = [ask(clients["jax"], i) for i in range(5)]
    for s, j in zip(solo, jsolo):
        assert [c.message.content for c in s.choices] == [c.message.content for c in j.choices]

    coalesced_before = backend.scheduler.stats["coalesced"]
    gate = threading.Event()
    blocker = backend.scheduler.submit(gate.wait)  # hold the worker
    results, errors = [None] * 5, []

    def call(i):
        try:
            results[i] = ask(client, i)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for _ in range(500):
        if backend.scheduler.stats["queued"] >= 5:
            break
        time.sleep(0.01)
    gate.set()
    for t in threads:
        t.join(timeout=120)
    blocker.result(timeout=5)
    assert errors == []
    assert backend.scheduler.stats["coalesced"] > coalesced_before
    for r, s in zip(results, solo):
        assert len(r.choices) == 3
        assert [c.message.content for c in r.choices] == [c.message.content for c in s.choices]
