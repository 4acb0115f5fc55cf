"""The port's streaming (the engine's token tap, ``_IncrementalDetok``,
``create(stream=True)``) on the CPU, held against the JAX package's with
the same weights (fp32 ``tiny``, the JAX tree carried over).

- The tap's per-step rows equal the JAX engine's tap on the paged and dense
  coalesced paths (sampled) and on the continuous loop (greedy).
- A group that mixes sinks and no sinks decodes the same tokens as the
  group without sinks; a sink that raises is dropped and the decode
  finishes.
- ``_IncrementalDetok`` gives the JAX class's deltas on the same feeds.
- ``create(stream=True)`` gives JAX's ``TpuBackend`` stream: the same
  ``(index, delta)`` sequence and the same final event, with the listed
  fields normalised.
- The streaming ``backend.dispatch`` failpoint fires once per stream, and
  a stream is never retried.
"""

import numpy as np
import pytest

from _torch_serving import port_backend, port_params, prompt
from conftest import shared_engine
from k_llms_tpu.backends.tpu import _IncrementalDetok as JaxDetok
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends.cuda import _IncrementalDetok
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer

EOS = ByteTokenizer().stop_ids

#: Wire fields that name the package or the clock: the completion id and
#: ``system_fingerprint`` carry the backend's name, ``created`` the second.
NORMALISED = ("id", "created", "system_fingerprint")


def _norm(event):
    return {k: (None if k in NORMALISED else v) for k, v in event.items()}


def _port_engine(layout):
    return LocalEngine("tiny", params=port_params(), device="cpu", kv_layout=layout,
                       kv_page_size=8)


def _collector():
    got = []
    return got, lambda step, toks: got.append((step, [int(t) for t in toks]))


GROUP = [("first request", 2, 5), ("a second, longer request here", 3, 9)]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_tap_rows_equal_the_jax_tap(layout):
    """Two sampled requests in one coalesced launch: each member's sink sees
    steps 0, 1, 2, ... once, with the JAX tap's rows (its n_per rows, the
    padding row included), and the rows are the result's tokens."""
    jeng = shared_engine("tiny", kv_layout="paged") if layout == "paged" else shared_engine("tiny")
    kw = dict(max_new_tokens=10, temperature=0.8, top_p=0.9, eos_ids=EOS)
    taps = {}
    for name, make_spec, eng in (("jax", JaxSpec, jeng),
                                 ("port", GenRequestSpec, _port_engine(layout))):
        sinks = [_collector() for _ in GROUP]
        specs = [make_spec(prompt(t), n, s, None, sink) for (t, n, s), (_, sink) in zip(GROUP, sinks)]
        out = eng.generate_many(specs, **kw)
        taps[name] = ([got for got, _ in sinks], out)
    for member, (got, want) in enumerate(zip(taps["port"][0], taps["jax"][0])):
        assert got == want
        assert [s for s, _ in got] == list(range(len(got)))
        res = taps["port"][1][member]
        steps = np.array([row for _, row in got]).T  # [n_per, steps]
        np.testing.assert_array_equal(steps[: GROUP[member][1]], res.tokens[:, : steps.shape[1]])


def test_loop_tap_rows_equal_the_jax_loop():
    """A greedy request through the continuous loop: the port loop's sink
    sees the JAX loop's rows step for step."""
    from k_llms_tpu.engine.continuous import ContinuousDecodeLoop as JaxLoop
    from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop

    ids = prompt("stream through the loop")
    kw = dict(n=2, max_new=8, temperature=0.0, top_p=None, seed=3)
    taps = []
    for loop in (JaxLoop(shared_engine(model="tiny"), width=4, max_prompt=64, max_new=32),
                 ContinuousDecodeLoop(_port_engine("paged"), width=4, max_prompt=64, max_new=32)):
        got, sink = _collector()
        try:
            loop.submit(list(ids), token_sink=sink, **kw).result(timeout=120)
        finally:
            loop.stop()
        taps.append(got)
    assert taps[1] == taps[0] and [s for s, _ in taps[1]] == list(range(len(taps[1])))


def test_sinks_leave_the_tokens_unchanged_and_a_broken_sink_is_dropped():
    """A group mixing a sink, a sink that raises and no sink decodes the
    tokens and logprobs of the same group without sinks; the raising sink
    is called once and dropped, the good one sees every step."""
    eng = _port_engine("paged")
    kw = dict(max_new_tokens=8, temperature=0.7, eos_ids=EOS)
    texts = ["one", "two requests", "three of them"]
    plain = eng.generate_many([GenRequestSpec(prompt(t), 2, i) for i, t in enumerate(texts)], **kw)
    good, good_sink = _collector()
    calls = []

    def broken(step, toks):
        calls.append(step)
        raise RuntimeError("a client went away")

    specs = [GenRequestSpec(prompt(texts[0]), 2, 0, None, good_sink),
             GenRequestSpec(prompt(texts[1]), 2, 1, None, broken),
             GenRequestSpec(prompt(texts[2]), 2, 2)]
    tapped = eng.generate_many(specs, **kw)
    for a, b in zip(tapped, plain):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert calls == [0]
    assert [s for s, _ in good] == list(range(eng.last_launch_stats["decode_steps"] + 1))


DETOK_FEEDS = {
    # A two-byte and a three-byte character split over steps.
    "split_multibyte": ([[0xC3], [0xA9], [ord("a")], [0xE6], [0x97], [0xA5], [ord("!")]], [], None),
    # A stop string cuts the stream; nothing past it reaches the wire.
    "stop_string": ([[ord(c)] for c in "hello STOP world"], ["STOP"], None),
    # Two samples, one padded from the second step; flush_final completes one
    # and leaves the diverged one alone.
    "flush_final": ([[ord("a"), ord("x")], [ord("b"), 0], [ord("c"), 0]], [], ["abcd", "q"]),
    # A sample that never streamed gets its whole text from flush_final.
    "flush_never_streamed": ([[0], [0]], [], ["all at once"]),
}


@pytest.mark.parametrize("case", sorted(DETOK_FEEDS))
def test_incremental_detok_equals_jax(case):
    feeds, stops, final = DETOK_FEEDS[case]
    tok = ByteTokenizer()
    n = len(feeds[0])
    pad = 0 if case != "split_multibyte" else -1
    outs = []
    for cls in (JaxDetok, _IncrementalDetok):
        got = []
        detok = cls(tok, n, pad, stops, lambda i, d: got.append((i, d)))
        for step, toks in enumerate(feeds):
            detok.feed(step, np.array(toks, np.int32))
        if final is not None:
            detok.flush_final(final)
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1]


@pytest.fixture(scope="module")
def clients():
    from k_llms_tpu import KLLMs as JaxKLLMs
    from k_llms_tpu.backends.tpu import TpuBackend

    jax = JaxKLLMs(backend=TpuBackend(model="tiny", max_new_tokens=8,
                                      engine=shared_engine("tiny", kv_layout="paged")), model="tiny")
    port = KLLMs(backend=port_backend(paged=True), model="tiny")
    yield jax, port
    jax.close()
    port.close()


@pytest.mark.parametrize("body", [
    dict(n=3, seed=11, temperature=0.9, max_tokens=8),
    dict(n=2, seed=5, temperature=0.0, max_tokens=6, stop=["e"]),
], ids=["sampled", "greedy_stop"])
def test_create_stream_equals_jax(clients, body):
    """``create(stream=True)`` through the JAX ``TpuBackend`` and the port's
    backend: the same (index, delta) sequence, finish chunks and final
    consolidated event."""
    req = dict(messages=[{"role": "user", "content": "stream this"}], model="tiny", **body)
    streams = []
    for client in clients:
        events = list(client.chat.completions.create(stream=True, **req))
        streams.append(events)
    jax_events, port_events = streams
    assert [_norm(e) for e in port_events[:-1]] == [_norm(e) for e in jax_events[:-1]]
    assert _norm(port_events[-1]) == _norm(jax_events[-1])
    deltas = [e for e in port_events if e["object"] == "chat.completion.chunk"
              and e["choices"][0]["delta"].get("content")]
    final = port_events[-1]
    assert {e["choices"][0]["index"] for e in deltas} == {
        i for i in range(1, body["n"] + 1) if final["choices"][i]["message"]["content"]}
    for i in range(1, body["n"] + 1):
        text = "".join(e["choices"][0]["delta"]["content"] for e in deltas
                       if e["choices"][0]["index"] == i)
        assert text == final["choices"][i]["message"]["content"]


def test_stream_dispatch_fires_the_failpoint_once_and_is_not_retried(clients):
    """The streaming ``backend.dispatch`` site fires once for a stream; a
    raise there reaches the consumer (one attempt: a retry would have
    succeeded, since the spec fires once), and the next stream is served."""
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec

    _, port = clients
    req = dict(messages=[{"role": "user", "content": "hi"}], model="tiny", n=2, seed=1, max_tokens=4)
    spec = FailSpec(action="raise", times=1)
    with fp.failpoints({"backend.dispatch": spec}):
        with pytest.raises(RuntimeError, match="injected failpoint"):
            list(port.chat.completions.create(stream=True, **req))
    assert spec._fired == 1
    assert list(port.chat.completions.create(stream=True, **req))[-1]["object"] == "chat.completion"


def test_async_stream_equals_the_sync_stream(clients):
    """``AsyncKLLMs.create(stream=True)`` yields the sync stream's events
    (an ``AsyncChatCompletionStream`` over the same worker)."""
    import asyncio

    from k_llms_tpu_torch import AsyncKLLMs

    _, port = clients
    req = dict(messages=[{"role": "user", "content": "async"}], model="tiny", n=2, seed=4,
               temperature=0.9, max_tokens=6)
    sync = [_norm(e) for e in port.chat.completions.create(stream=True, **req)]
    aclient = AsyncKLLMs(backend=port.backend, model="tiny")

    async def consume():
        stream = await aclient.chat.completions.create(stream=True, **req)
        async with stream:
            return [_norm(e) async for e in stream]

    assert asyncio.run(asyncio.wait_for(consume(), 60)) == sync
