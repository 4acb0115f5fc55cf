"""The client contract end to end on the scripted backend, port against JAX
(twin of ``tests/test_client_e2e.py``): ``KLLMs``/``AsyncKLLMs`` over
``backend="fake"`` in both packages, the same scripted samples, and every
response's ``model_dump()`` equal (``created`` frozen) beside the JAX
test's own assertions: the ``choices`` layout, JSON contents, ``parse()``
revalidation and ``None`` on failure, nested lists, usage,
``get_embeddings``, similarity caches shared across requests, bare JSON
primitives."""

import asyncio
import json
import time

import pytest
from pydantic import BaseModel

from k_llms_tpu import AsyncKLLMs as JaxAsyncKLLMs
from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.backends.fake import FakeBackend as JaxFakeBackend
from k_llms_tpu_torch import AsyncKLLMs, KLLMs
from k_llms_tpu_torch.backends.fake import FakeBackend

CLIENTS = {"port": (KLLMs, AsyncKLLMs, FakeBackend),
           "jax": (JaxKLLMs, JaxAsyncKLLMs, JaxFakeBackend)}
Q = [{"role": "user", "content": "q"}]


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def both(contents, call):
    """``call(client)`` on a fake-backed client of each package: the two
    responses' dumps equal; returns the port's response."""
    out = {name: call(client_cls(backend="fake", responses=[contents]))
           for name, (client_cls, _, _) in CLIENTS.items()}
    assert out["port"].model_dump() == out["jax"].model_dump()
    return out["port"]


def test_create_n3_contract():
    resp = both(["yes", "yes", "no"],
                lambda c: c.chat.completions.create(messages=Q, model="m", n=3))
    assert len(resp.choices) == 3 + 1
    assert resp.choices[0].index == 0
    assert [c.index for c in resp.choices[1:]] == [1, 2, 3]
    assert resp.choices[0].message.content == "yes"
    assert resp.likelihoods == {"text": round(2 / 3, 5)}
    assert [c.message.content for c in resp.choices[1:]] == ["yes", "yes", "no"]


def test_create_single_choice_passthrough():
    resp = both(["hello"], lambda c: c.chat.completions.create(messages=Q, model="m"))
    assert len(resp.choices) == 1
    assert resp.likelihoods is None


def test_create_json_contents():
    payload = {"city": "Paris", "country": "France"}
    resp = both([json.dumps(payload)] * 2 + [json.dumps({"city": "Paris", "country": "FR"})],
                lambda c: c.chat.completions.create(messages=Q, model="m", n=3))
    consensus = json.loads(resp.choices[0].message.content)
    assert consensus == payload
    assert resp.likelihoods["city"] == 1.0
    assert resp.likelihoods["country"] == round(2 / 3, 5)


class UserInfo(BaseModel):
    name: str
    age: int


def test_parse_revalidates_into_model():
    resp = both([json.dumps({"name": "Bob", "age": 44})] * 3
                + [json.dumps({"name": "Rob", "age": 44})],
                lambda c: c.chat.completions.parse(messages=Q, model="m", n=4,
                                                   response_format=UserInfo))
    parsed = resp.choices[0].message.parsed
    assert isinstance(parsed, UserInfo) and (parsed.name, parsed.age) == ("Bob", 44)
    assert resp.likelihoods["name"] == 0.75


@pytest.mark.parametrize("n", [3, 1])
def test_parse_populates_originals_and_single_sample(n):
    resp = both([json.dumps({"name": "Bob", "age": 44})] * 4,
                lambda c: c.chat.completions.parse(messages=Q, model="m", n=n,
                                                   response_format=UserInfo))
    for choice in resp.choices:
        assert isinstance(choice.message.parsed, UserInfo)
    assert resp.choices[0].message.parsed.name == "Bob"


def test_parse_failure_gives_none_parsed():
    class Strict(BaseModel):
        count: int

    # close ints cluster together -> fractional cluster mean -> validation fails silently
    resp = both([json.dumps({"count": 100}), json.dumps({"count": 102}),
                 json.dumps({"count": 103})],
                lambda c: c.chat.completions.parse(messages=Q, model="m", n=3,
                                                   response_format=Strict))
    assert resp.choices[0].message.parsed is None
    assert json.loads(resp.choices[0].message.content)["count"] == pytest.approx(305 / 3)


def test_nested_list_consolidation():
    docs = [
        {"invoice": {"items": [{"sku": "widget large", "qty": 2}, {"sku": "gadget small", "qty": 1}]}},
        {"invoice": {"items": [{"sku": "gadget small", "qty": 1}, {"sku": "widget large", "qty": 2}]}},
        {"invoice": {"items": [{"sku": "widget large", "qty": 2}]}},
    ]
    resp = both([json.dumps(d) for d in docs],
                lambda c: c.chat.completions.create(messages=Q, model="m", n=3))
    items = json.loads(resp.choices[0].message.content)["invoice"]["items"]
    assert "widget large" in [i["sku"] for i in items]
    assert resp.likelihoods["invoice"]["items"][0]["sku"] >= 0.5


def test_async_client():
    async def main(async_cls):
        client = async_cls(backend="fake", responses=[["a", "a", "b"]])
        return await client.chat.completions.create(messages=Q, model="m", n=3)

    got = {name: asyncio.run(main(async_cls)) for name, (_, async_cls, _) in CLIENTS.items()}
    assert got["port"].model_dump() == got["jax"].model_dump()
    assert got["port"].choices[0].message.content == "a"
    assert len(got["port"].choices) == 4


def test_usage_preserved():
    resp = both(["x", "x"], lambda c: c.chat.completions.create(
        messages=[{"role": "user", "content": "hello world"}], model="m", n=2))
    assert resp.usage is not None
    assert resp.usage.total_tokens == resp.usage.prompt_tokens + resp.usage.completion_tokens


def test_get_embeddings_helper():
    out = {}
    for name, (client_cls, _, _) in CLIENTS.items():
        client = client_cls(backend="fake", responses=[["x"]])
        out[name] = (client.get_embeddings(["alpha", "beta"]), client.get_embeddings(["alpha"]))
    assert out["port"] == out["jax"]
    embs, again = out["port"]
    assert len(embs) == 2 and len(embs[0]) == len(embs[1]) > 0
    assert again[0] == embs[0]


def test_similarity_caches_shared_across_requests():
    """One scorer per similarity method per backend: a second identical
    request, and a second client over the same backend, issue no embedding
    forwards; the same counts and contents in both packages."""
    long_a = ("The quick brown fox jumps over the extremely lazy dog near the "
              "riverbank just before dawn on a cold morning.")
    long_b = ("The quick brown fox leaps over the extremely lazy dog near the "
              "riverbank just before dawn on a cold morning.")
    contents = [json.dumps({"summary": long_a}), json.dumps({"summary": long_a}),
                json.dumps({"summary": long_b})]
    out = {}
    for name, (client_cls, _, fake_cls) in CLIENTS.items():
        class CountingBackend(fake_cls):
            embed_calls = 0

            def embeddings(self, texts):
                self.embed_calls += 1
                return super().embeddings(texts)

        backend = CountingBackend(responses=[contents])
        client = client_cls(backend=backend, model="m")
        first = client.chat.completions.create(messages=Q, model="m", n=3)
        calls_after_first = backend.embed_calls
        second = client.chat.completions.create(messages=Q, model="m", n=3)
        client_cls(backend=backend, model="m").chat.completions.create(messages=Q, model="m", n=3)
        out[name] = (calls_after_first, backend.embed_calls, first.model_dump(),
                     second.model_dump())
        assert calls_after_first > 0 and backend.embed_calls == calls_after_first
        assert second.choices[0].message.content == first.choices[0].message.content
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("contents,consensus,likelihoods", [
    (["5", "5", "7"], "5", {"text": round(2 / 3, 5)}),
    (["[1, 2]", "[1, 2]", "[1, 2]"], "[1, 2]", {"text": 1.0}),
])
def test_bare_primitive_json_contents_degrade_to_text(contents, consensus, likelihoods):
    resp = both(contents, lambda c: c.chat.completions.create(messages=Q, model="m", n=3))
    assert resp.choices[0].message.content == consensus
    assert resp.likelihoods == likelihoods
