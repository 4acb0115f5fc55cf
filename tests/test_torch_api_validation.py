"""The port's twin of ``tests/test_api_validation.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Parameter validation at the public API boundary — the reference delegates
these 400s to the OpenAI server (README_TESTS.md error-scenario checklist:
invalid model, empty messages, bad parameters); a local engine must reject
them itself with clean errors instead of generating garbage or crashing
mid-trace.
"""

import pytest

from k_llms_tpu_torch import KLLMs


@pytest.fixture(scope="module")
def client():
    return KLLMs(backend="cuda", device="cpu", model="tiny")


MSGS = [{"role": "user", "content": "hello"}]


def test_empty_messages_rejected(client):
    with pytest.raises(ValueError, match="messages"):
        client.chat.completions.create(messages=[], model="tiny", n=2)


def test_invalid_model_name_raises_at_construction():
    with pytest.raises(KeyError):
        KLLMs(backend="cuda", device="cpu", model="no-such-model")


def test_client_model_reaches_backend():
    """KLLMs(backend="cuda", device="cpu", model=X) must BUILD model X, not the default
    labeled as X."""
    c = KLLMs(backend="cuda", device="cpu", model="tiny")
    assert c.backend.model_name == "tiny"


def test_n_zero_rejected(client):
    with pytest.raises(ValueError, match="n must be"):
        client.chat.completions.create(messages=MSGS, model="tiny", n=0)


def test_negative_max_tokens_rejected(client):
    with pytest.raises(ValueError, match="max_tokens"):
        client.chat.completions.create(messages=MSGS, model="tiny", n=1, max_tokens=-5)


def test_temperature_out_of_range_rejected(client):
    for bad in (-1.0, 2.5):
        with pytest.raises(ValueError, match="temperature"):
            client.chat.completions.create(
                messages=MSGS, model="tiny", n=1, temperature=bad
            )


def test_top_p_out_of_range_rejected(client):
    for bad in (1.5, -0.2):
        with pytest.raises(ValueError, match="top_p"):
            client.chat.completions.create(messages=MSGS, model="tiny", n=1, top_p=bad)


def test_valid_edges_still_serve(client):
    r = client.chat.completions.create(
        messages=MSGS, model="tiny", n=1, temperature=0.0, top_p=1.0,
        max_tokens=1, seed=1,
    )
    # n=1 is the reference's single-choice passthrough (no consensus row).
    assert len(r.choices) == 1


def test_parse_validates_too(client):
    from pydantic import BaseModel

    class Out(BaseModel):
        x: int

    with pytest.raises(ValueError, match="messages"):
        client.chat.completions.parse(messages=[], model="tiny", response_format=Out)


def test_default_model_label_follows_backend_weights():
    """KLLMs(backend="cuda", device="cpu") with no model must label requests with the
    backend's ACTUAL model, not an unrelated default name."""
    c = KLLMs(backend="cuda", device="cpu")
    assert c.default_model == c.backend.model_name == "tiny"


def test_conflicting_config_and_model_rejected():
    from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend

    with pytest.raises(ValueError, match="conflicts"):
        CudaBackend(model="llama-3-8b", config=BackendConfig(model="tiny", device="cpu"))
    # Agreeing values are fine.
    b = CudaBackend(model="tiny", config=BackendConfig(model="tiny", device="cpu"))
    assert b.model_name == "tiny"


# -- logit_bias (the reference forwards it to the server; here the decode
# loop applies it) -----------------------------------------------------------

def test_logit_bias_bans_a_token(client):
    """With +100 on both 'A' and 'B' greedy emits only those; additionally
    banning 'A' (-100) must leave pure 'B' output."""
    ab = client.chat.completions.create(
        messages=MSGS, model="tiny", n=1, temperature=0.0, seed=5, max_tokens=4,
        logit_bias={"65": 100, "66": 100},
    )
    assert set(ab.choices[0].message.content) <= {"A", "B"}
    only_b = client.chat.completions.create(
        messages=MSGS, model="tiny", n=1, temperature=0.0, seed=5, max_tokens=4,
        logit_bias={"65": -100, "66": 100},
    )
    assert only_b.choices[0].message.content == "BBBB"


def test_logit_bias_forces_a_token(client):
    """+100 on one ordinary token dominates every step of greedy decode."""
    target = 65  # 'A' in the byte tokenizer
    r = client.chat.completions.create(
        messages=MSGS, model="tiny", n=2, temperature=0.0, seed=6, max_tokens=4,
        logit_bias={str(target): 100},
    )
    for choice in r.choices[1:]:
        assert choice.message.content == "AAAA"


def test_logit_bias_value_range_validated(client):
    with pytest.raises(ValueError, match="logit_bias values"):
        client.chat.completions.create(
            messages=MSGS, model="tiny", n=1, logit_bias={"65": 500}
        )


def test_logit_bias_token_range_validated(client):
    with pytest.raises(ValueError, match="outside vocab"):
        client.chat.completions.create(
            messages=MSGS, model="tiny", n=1, logit_bias={"999999": 1.0}
        )


def test_top_p_zero_is_top1(client):
    # OpenAI accepts top_p=0 (degenerates to top-1); must serve, not 400.
    r = client.chat.completions.create(
        messages=MSGS, model="tiny", n=2, top_p=0.0, seed=8, max_tokens=2,
    )
    assert len(r.choices) == 3


def test_penalty_out_of_range_rejected(client):
    with pytest.raises(ValueError, match="frequency_penalty"):
        client.chat.completions.create(
            messages=MSGS, model="tiny", n=1, frequency_penalty=50.0
        )
    with pytest.raises(ValueError, match="presence_penalty"):
        client.chat.completions.create(
            messages=MSGS, model="tiny", n=1, presence_penalty=-3.0
        )
