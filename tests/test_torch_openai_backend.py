"""The port's OpenAI passthrough (``backends/openai_backend.py``) against the
JAX package's, on a stub ``openai`` module put into ``sys.modules``: the
same scripted responses go through both packages' backends, and the wire
kwargs, the returned completions, the embeddings, the consensus prompt, the
missing-package error (up to the port's backend name in its advice) and the
crop (with a stub ``tiktoken`` and without) are equal. Neither machine has the ``openai`` package, and nothing here
reaches the network."""

import json
import sys
import types

import pytest

from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.backends import base as jax_base
from k_llms_tpu.backends.openai_backend import OpenAIBackend as JaxOpenAIBackend
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends import base
from k_llms_tpu_torch.backends.openai_backend import OpenAIBackend
from test_torch_host_copies import EDITS

PACKAGES = {
    "port": (KLLMs, base, OpenAIBackend),
    "jax": (JaxKLLMs, jax_base, JaxOpenAIBackend),
}


class _Obj(types.SimpleNamespace):
    """An attribute bag with the ``model_dump`` of the SDK's response models."""

    def model_dump(self):
        return json.loads(json.dumps(self, default=vars))


def _completion(contents, model):
    return _Obj(
        id="chatcmpl-stub", object="chat.completion", created=1_700_000_000, model=model,
        system_fingerprint="fp_stub",
        choices=[_Obj(index=i, finish_reason="stop", logprobs=None,
                      message=_Obj(role="assistant", content=c))
                 for i, c in enumerate(contents)],
        usage=_Obj(prompt_tokens=11, completion_tokens=3 * len(contents),
                   total_tokens=11 + 3 * len(contents)),
    )


def _stub_openai(contents):
    """A module with the SDK's ``OpenAI`` surface: each client records its
    constructor kwargs and every call, and answers from ``contents``."""
    mod = types.ModuleType("openai")

    class OpenAI:
        def __init__(self, **kwargs):
            self.init = kwargs
            self.calls = []
            self.chat = _Obj(completions=_Obj(create=self._chat))
            self.embeddings = _Obj(create=self._embed)

        def _chat(self, **params):
            self.calls.append(("chat", params))
            n = params.get("n", 1)
            return _completion(contents[:n] if params["model"] != "gpt-5-mini" else ["merged"],
                               params["model"])

        def _embed(self, input, model):
            self.calls.append(("embeddings", {"input": list(input), "model": model}))
            data = [_Obj(embedding=[float(len(t)), float(sum(map(ord, t)) % 97), 1.0])
                    for t in input]
            return _Obj(data=data, usage=_Obj(prompt_tokens=sum(len(t) for t in input)))

    mod.OpenAI = OpenAI
    return mod


def _stub_tiktoken():
    mod = types.ModuleType("tiktoken")

    class Encoding:
        def encode(self, text):
            return [ord(c) for c in text.replace(" ", "")]

        def decode(self, ids):
            return "".join(map(chr, ids))

    mod.encoding_for_model = lambda model: Encoding()
    return mod


@pytest.fixture
def openai_stub(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.setitem(sys.modules, "openai", _stub_openai(["yes", "yes", "no", "maybe"]))


def _backends(**kw):
    return {name: backend_cls(api_key="sk-stub", **kw)
            for name, (_, _, backend_cls) in PACKAGES.items()}


def test_resolves_by_name_and_passes_the_client_options(openai_stub):
    got = {}
    for name, (_, mod, backend_cls) in PACKAGES.items():
        backend = mod.resolve_backend(" OpenAI ", api_key="sk-stub", base_url="http://h/v1",
                                      timeout=5.0, max_retries=1, model="m")
        assert type(backend) is backend_cls and backend.model_name == "m"
        assert backend.bills_usage and backend.embedding_model_name == "text-embedding-3-small"
        got[name] = backend.client.init
    assert got["port"] == got["jax"] == {"api_key": "sk-stub", "base_url": "http://h/v1",
                                         "timeout": 5.0, "max_retries": 1}
    assert base._BACKEND_ALIASES["openai"] == jax_base._BACKEND_ALIASES["openai"] == "openai"
    with pytest.raises(base.UnknownBackendError) as err:
        base.resolve_backend("tpu")
    assert "'openai'" in str(err.value)


@pytest.mark.parametrize("request_kw", [
    dict(n=1),
    dict(n=3, temperature=0.7, max_tokens=32, top_p=0.9, frequency_penalty=0.1,
         presence_penalty=0.2, stop=["\n"], seed=5, response_format={"type": "json_object"},
         logit_bias={"50256": -100}, logprobs=True, top_logprobs=2,
         extra={"user": "u1"}),
])
def test_request_to_wire_and_completion_equal_jax(openai_stub, request_kw):
    backends = _backends()
    out = {}
    for name, (_, mod, _) in PACKAGES.items():
        req = mod.ChatRequest(messages=[{"role": "user", "content": "q"}], model="gpt-4o",
                              **request_kw)
        out[name] = (backends[name].chat_completion(req).model_dump(),
                     backends[name].client.calls)
    assert out["port"] == out["jax"]
    (_, params), = out["port"][1]
    assert params["stream"] is False and ("n" in params) == (request_kw["n"] > 1)
    assert "logprobs" not in params  # not forwarded, in either package


def test_embeddings_and_usage_equal_jax(openai_stub):
    backends = _backends(embedding_model="text-embedding-3-large")
    texts = ["alpha", "beta gamma", ""]
    out = {}
    for name, backend in backends.items():
        out[name] = (backend.embeddings(texts), backend.embeddings_with_usage(texts),
                     backend.embeddings_with_usage(texts, model="local"),
                     backend.embeddings_with_usage(texts, model="text-embedding-3-small"),
                     backend.client.calls)
    assert out["port"] == out["jax"]
    assert [c[1]["model"] for c in out["port"][-1]] == ["text-embedding-3-large"] * 3 + [
        "text-embedding-3-small"]


def test_llm_consensus_prompt_equal_jax(openai_stub):
    backends = _backends()
    values = ["Acme Corp", "ACME Corporation", 'Acme "Corp"']
    out = {name: (b.llm_consensus(values), b.client.calls) for name, b in backends.items()}
    assert out["port"] == out["jax"]
    merged, ((_, params),) = out["port"]
    assert merged == "merged" and params["model"] == "gpt-5-mini"
    assert params["messages"][1]["content"] == f"Input: {[json.dumps(v) for v in values]}\nOutput:"


def test_client_consensus_over_the_passthrough_equals_jax(openai_stub):
    """``KLLMs(backend="openai")``: one call with native ``n``, then the
    consensus on the host; the responses are equal."""
    got = {}
    for name, (client_cls, _, _) in PACKAGES.items():
        client = client_cls(backend="openai", api_key="sk-stub")
        resp = client.chat.completions.create(
            messages=[{"role": "user", "content": "q"}], model="gpt-4o", n=3, seed=1)
        got[name] = resp.model_dump()
        assert len(resp.choices) == 4 and resp.likelihoods == {"text": round(2 / 3, 5)}
        assert client.backend.client.calls[0][1]["n"] == 3
    assert got["port"] == got["jax"]


def test_missing_openai_raises_the_same_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "openai", None)  # import openai -> ImportError
    messages = {}
    for name, (client_cls, _, backend_cls) in PACKAGES.items():
        with pytest.raises(ImportError) as err:
            backend_cls(api_key="sk-stub")
        with pytest.raises(ImportError) as err_client:
            client_cls(backend="openai")
        assert str(err_client.value) == str(err.value)
        messages[name] = str(err.value)
    # Equal up to the documented edit: the port advises its own local backend.
    for old, new in EDITS["backends/openai_backend.py"]:
        messages["jax"] = messages["jax"].replace(old, new)
    assert messages["port"] == messages["jax"]
    assert "requires the openai package" in messages["port"]
    assert "backend='cuda'" in messages["port"]


@pytest.mark.parametrize("with_tiktoken", [True, False])
def test_crop_texts_equal_jax(openai_stub, monkeypatch, with_tiktoken):
    monkeypatch.setitem(sys.modules, "tiktoken", _stub_tiktoken() if with_tiktoken else None)
    backends = _backends()
    texts = ["a b c d e f g h", "short", "x" * 20]
    out = {name: [b.crop_texts(texts, 4), b.crop_texts(texts, 6, model="local")]
           for name, b in backends.items()}
    assert out["port"] == out["jax"]
    assert out["port"][0] == (["abcd", "shor", "xxxx"] if with_tiktoken
                              else ["a b ", "shor", "xxxx"])
