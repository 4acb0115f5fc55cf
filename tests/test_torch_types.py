"""The port's twin of ``tests/test_types.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Golden tests for the response contract (SURVEY.md §7 stage 1).
"""

import json

from k_llms_tpu_torch.types import (
    ChatCompletion,
    CompletionUsage,
    KLLMsChatCompletion,
    KLLMsParsedChatCompletion,
)


def make_completion(contents, model="llama-3-8b"):
    return ChatCompletion.model_validate(
        {
            "id": "chatcmpl-test",
            "created": 1735000000,
            "model": model,
            "object": "chat.completion",
            "choices": [
                {
                    "finish_reason": "stop",
                    "index": i,
                    "message": {"role": "assistant", "content": c},
                }
                for i, c in enumerate(contents)
            ],
            "usage": {"prompt_tokens": 10, "completion_tokens": 20, "total_tokens": 30},
        }
    )


def test_chat_completion_roundtrip():
    comp = make_completion(["hello", "world"])
    dumped = comp.model_dump()
    assert dumped["object"] == "chat.completion"
    assert dumped["choices"][0]["message"]["role"] == "assistant"
    assert dumped["choices"][1]["message"]["content"] == "world"
    re = ChatCompletion.model_validate(dumped)
    assert re == comp


def test_kllms_completion_adds_likelihoods():
    comp = make_completion(["x"])
    k = KLLMsChatCompletion.model_validate({**comp.model_dump(), "likelihoods": {"a": 0.5}})
    assert k.likelihoods == {"a": 0.5}
    # default None and survives serialization
    k2 = KLLMsChatCompletion.model_validate(comp.model_dump())
    assert k2.likelihoods is None
    payload = json.loads(k.model_dump_json())
    assert payload["likelihoods"] == {"a": 0.5}


def test_parsed_completion_carries_parsed_field():
    payload = make_completion([json.dumps({"a": 1})]).model_dump()
    payload["choices"][0]["message"]["parsed"] = {"a": 1}
    k = KLLMsParsedChatCompletion.model_validate(payload)
    assert k.choices[0].message.parsed == {"a": 1}


def test_usage_details_optional():
    u = CompletionUsage(prompt_tokens=1, completion_tokens=2, total_tokens=3)
    assert u.prompt_tokens_details is None
    d = u.model_dump()
    assert d["total_tokens"] == 3


def test_unknown_fields_tolerated():
    payload = make_completion(["x"]).model_dump()
    payload["some_future_field"] = {"y": 1}
    comp = ChatCompletion.model_validate(payload)
    assert comp.model_dump()["some_future_field"] == {"y": 1}
