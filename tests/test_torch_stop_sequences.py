"""Stop sequences on the device and the billing behind them, port against
JAX (twin of ``tests/test_stop_sequences.py``): rows halt in the decode
loop when their recent-token window matches a tokenized stop sequence,
each row on its own; sequences over ``MAX_STOP_LEN`` are left to the host;
usage bills only the tokens behind the visible text (multi-byte text
included); the earliest stop in the text wins. Every engine launch and
client response is the JAX backend's on the same tiny weights."""

import numpy as np
import pytest
import torch

from _torch_serving import port_backend
from conftest import shared_engine
from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.backends import tpu as jax_tpu
from k_llms_tpu.engine import engine as jax_engine
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends import cuda
from k_llms_tpu_torch.engine import engine as torch_engine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer


@pytest.fixture(scope="module")
def backends():
    port = port_backend(paged=True, max_new_tokens=24)
    jax_backend = jax_tpu.TpuBackend(model="tiny", max_new_tokens=24,
                                     engine=shared_engine("tiny", kv_layout="paged",
                                                          kv_page_size=8))
    yield port, jax_backend
    port.close()
    jax_backend.close()


def generate_both(backends, text, **kw):
    port, jax_backend = backends
    got = port.engine.generate(port.tokenizer.encode(text), **kw)
    want = jax_backend.engine.generate(jax_backend.tokenizer.encode(text), **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert list(got.finish_reasons) == list(want.finish_reasons)
    return got


def create_both(backends, **kw):
    port, jax_backend = backends
    got = KLLMs(backend=port).chat.completions.create(model="tiny", **kw)
    want = JaxKLLMs(backend=jax_backend).chat.completions.create(model="tiny", **kw)
    assert [c.message.content for c in got.choices] == [c.message.content for c in want.choices]
    assert [c.finish_reason for c in got.choices] == [c.finish_reason for c in want.choices]
    assert got.usage.model_dump() == want.usage.model_dump()
    return got


def test_device_halt_on_forced_stop_token(backends):
    kw = dict(n=2, max_new_tokens=16, temperature=1.0, seed=5, logit_bias={65: 100.0})
    free = generate_both(backends, "hello", **kw)
    assert all(length == 16 for length in free.lengths)
    stopped = generate_both(backends, "hello", stop_sequences=[[65, 65]], **kw)
    assert all(length == 2 for length in stopped.lengths)
    assert stopped.finish_reasons == ["stop", "stop"]


@pytest.mark.parametrize("stop_len,want_len", [(1, 1), (torch_engine.MAX_STOP_LEN + 1, 12)])
def test_single_token_stop_and_overlong_stop_skipped(backends, stop_len, want_len):
    """A one-token stop halts at the first emission; a sequence longer than
    ``MAX_STOP_LEN`` is left to the host and never halts the device loop."""
    assert torch_engine.MAX_STOP_LEN == jax_engine.MAX_STOP_LEN
    out = generate_both(backends, "x", n=1, max_new_tokens=12, temperature=1.0, seed=1,
                        logit_bias={66: 100.0}, stop_sequences=[[66] * stop_len])
    assert out.lengths[0] == want_len


def test_usage_zero_when_stop_opens_the_text(backends):
    resp = create_both(backends, messages=[{"role": "user", "content": "y"}], n=2, seed=3,
                       logit_bias={"65": 100}, stop="AAA")
    for choice in resp.choices[1:]:
        assert choice.message.content == "" and choice.finish_reason == "stop"
    assert resp.usage.completion_tokens == 0


def test_usage_trimmed_to_visible_text(backends):
    kw = dict(messages=[{"role": "user", "content": "y"}], n=2, seed=3)
    resp = create_both(backends, **kw)
    full = resp.choices[1].message.content
    assert len(full) > 2
    stopped = create_both(backends, stop=full[2], **kw)
    total_chars = sum(len(c.message.content or "") for c in stopped.choices[1:])
    assert all(full[2] not in (c.message.content or "") for c in stopped.choices[1:])
    assert total_chars <= stopped.usage.completion_tokens < resp.usage.completion_tokens


def test_earliest_stop_in_text_wins(backends):
    kw = dict(messages=[{"role": "user", "content": "q"}], n=2, seed=21)
    full = create_both(backends, **kw).choices[1].message.content
    assert len(full) >= 8
    late, early = full[5:7], full[2:4]
    resp = create_both(backends, stop=[late, early], **kw)
    assert resp.choices[1].message.content == full[:min(full.find(late), full.find(early))]


def test_stop_rows_halt_independently(backends):
    out = generate_both(backends, "z", n=4, max_new_tokens=12, temperature=1.0, seed=11,
                        stop_sequences=[[250]])
    assert (np.asarray(out.lengths) > 0).all()


def test_stop_window_match_equals_jax():
    import jax.numpy as jnp

    stops = np.array([[-1, -1, -1, -1, -1, -1, 7, 9], [-1, -1, -1, -1, -1, -1, -1, 4],
                      [-1] * 8, [-1] * 8], np.int64)
    win = np.array([[1, 2, 3, 4, 5, 6, 7, 9], [1, 2, 3, 4, 5, 6, 9, 7],
                    [1, 2, 3, 4, 5, 6, 7, 4], [7, 9, 3, 4, 5, 6, 1, 2], [-1] * 8], np.int64)
    got = torch_engine.stop_window_match(torch.from_numpy(win), torch.from_numpy(stops))
    want = jax_engine.stop_window_match(jnp.asarray(win, jnp.int32), jnp.asarray(stops, jnp.int32))
    assert [bool(x) for x in got] == [bool(x) for x in want] == [True, False, True, False, False]


class _CleanupTok:
    """Decode cleanup that shrinks the text when a token is appended."""
    _pieces = {1: "a  ", 2: ",", 3: "z"}

    def decode(self, ids):
        return "".join(self._pieces[i] for i in ids).replace("  ,", ",")


@pytest.mark.parametrize("tok,ids,pos", [
    (ByteTokenizer(), list("abc😀STOP".encode()), 4),
    (ByteTokenizer(), list("abc😀STOP".encode()), 3),
    (ByteTokenizer(), list("中文X".encode()), 1),
    (ByteTokenizer(), list("中文X".encode()), 2),
    (ByteTokenizer(), list("aéb".encode()), 2),
    (ByteTokenizer(), list(b"a\xc3X"), 2),
    (ByteTokenizer(), list(b"\x9f\x9fa"), 2),
    (_CleanupTok(), [1, 2, 3], 2),
])
def test_visible_token_count_equals_jax(tok, ids, pos):
    text = tok.decode(ids)
    got = cuda._visible_token_count(tok, ids, pos, text)
    assert got == jax_tpu._visible_token_count(tok, ids, pos, text)
    assert tok.decode(ids[:got])[:pos] == text[:pos]


def test_stop_billing_covers_multibyte_visible_text(backends):
    emoji = "😀".encode()
    resp = create_both(backends, messages=[{"role": "user", "content": "m"}], n=2, seed=17,
                       logprobs=True, logit_bias={str(b): 100 for b in emoji},
                       stop="\N{GRINNING FACE}")
    billed_total = 0
    for choice in resp.choices[1:]:
        text = choice.message.content or ""
        assert "😀" not in text
        entries = choice.logprobs.content if choice.logprobs else []
        billed_total += len(entries)
        billed = b"".join(bytes(e.bytes) for e in entries).decode("utf-8", errors="replace")
        assert billed[: len(text)] == text
    assert resp.usage.completion_tokens == billed_total > 0
