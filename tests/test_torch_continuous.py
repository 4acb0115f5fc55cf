"""The port's continuous decode loop (``k_llms_tpu_torch/engine/continuous.py``)
on the CPU, held against the JAX package's loop with the same weights.

Twins of ``tests/test_continuous.py`` on both KV layouts at tiny fp32:
tokens equal the JAX loop's for the same seeds (greedy exactly; sampled
through bit-equal per-row uniforms, a differing sample counted only where
its first differing draw is a near-tie of perturbed scores), sink order,
self-determinism across batch composition, a late request joining in
flight, budget aborts, the bounds, grammar-constrained rows, and the
backend's routing, health, drain, the pinned pool and a coalesced request
decoding while the loop runs.
"""

import threading
import time

import numpy as np
import pytest
import torch

from _torch_serving import port_params, prompt
from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.ops.random import request_keys, threefry_uniform_rows_plain
from k_llms_tpu_torch.reliability.deadline import RequestBudget
from k_llms_tpu_torch.types.wire import RequestCancelledError
from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS

LAYOUTS = ("dense", "paged")


def port_engine(layout, **kw):
    return LocalEngine("tiny", params=port_params(), device="cpu", kv_layout=layout,
                       kv_page_size=8, **kw)


@pytest.fixture(scope="module", params=LAYOUTS)
def loop(request):
    lp = ContinuousDecodeLoop(port_engine(request.param), width=4, max_prompt=64, max_new=32)
    yield lp
    lp.stop()


@pytest.fixture(scope="module")
def jax_loop():
    from conftest import shared_engine

    from k_llms_tpu.engine.continuous import ContinuousDecodeLoop as JaxLoop

    lp = JaxLoop(shared_engine(model="tiny"), width=4, max_prompt=64, max_new=32)
    yield lp
    lp.stop()


def near_tie(engine, ids, res, j, s, seed, temperature, top_p):
    """Whether row j's draw at step s is a near-tie: the perturbed scores of
    the port's token and the runner-up differ by under 1e-4 (the loop's
    logits recomputed by a full forward over the prompt and the row's
    tokens so far)."""
    from k_llms_tpu_torch.engine.continuous import _sample_rows

    toks = list(ids) + [int(t) for t in res.tokens[j][:s]]
    logits, _ = llama.forward(engine.config, engine.params, torch.tensor([toks]),
                              torch.ones((1, len(toks)), dtype=torch.int64))
    row = logits[:, -1].clone()
    row[:, engine.config.pad_token_id] = -float("inf")
    u = threefry_uniform_rows_plain(request_keys([seed], "cpu"), torch.tensor([s], dtype=torch.int32),
                                    torch.tensor([j], dtype=torch.int32), row.shape[-1])
    tok, _, _ = _sample_rows(row, u, torch.tensor([temperature]), torch.tensor([top_p or 1.0]))
    scaled = row[0] / max(temperature, 1e-6) - torch.log(-torch.log(u[0]))
    top2 = torch.topk(scaled, 2).values
    return int(tok[0]) == int(res.tokens[j][s]) and float(top2[0] - top2[1]) < 1e-4


REQUESTS = [
    ([1, 2, 3, 4, 5], dict(n=2, max_new=8, temperature=0.7, top_p=0.9, seed=7)),
    (list(range(1, 40)), dict(n=2, max_new=8, temperature=0.0, top_p=None, seed=3)),
    ([9, 8, 7], dict(n=3, max_new=16, temperature=1.0, top_p=0.95, seed=4)),
]


def test_tokens_equal_the_jax_loop(loop, jax_loop):
    """Every request alone through both loops: greedy tokens exactly equal,
    sampled ones equal up to counted near-ties, logprobs within 1e-5."""
    near_ties = compared = 0
    for ids, kw in REQUESTS:
        ref = jax_loop.submit(ids, **kw).result(timeout=120)
        got = loop.submit(ids, **kw).result(timeout=120)
        for j in range(kw["n"]):
            compared += 1
            a, b = np.asarray(ref.tokens[j]), got.tokens[j]
            if np.array_equal(a, b):
                assert np.allclose(np.asarray(ref.logprobs[j]), got.logprobs[j], atol=1e-5)
                continue
            assert kw["temperature"] > 0, "a greedy row differs from the JAX loop"
            s = int(np.flatnonzero(a != b)[0])
            assert near_tie(loop.engine, ids, got, j, s, kw["seed"], kw["temperature"],
                            kw["top_p"]), f"row {j} differs at step {s}, not at a near-tie"
            near_ties += 1
    print(f"\ncontinuous loop ({'paged' if loop.paged else 'dense'}): "
          f"{near_ties} of {compared} samples differ at a near-tie")


def test_basic_generation_and_sink_order(loop):
    sunk = []
    result = loop.submit([1, 2, 3, 4, 5], n=2, max_new=8, temperature=0.7, top_p=0.9, seed=7,
                         token_sink=lambda step, toks: sunk.append((step, toks.copy()))
                         ).result(timeout=120)
    assert result.tokens.shape == (2, 8)
    assert [s for s, _ in sunk] == list(range(len(sunk)))
    for step, row in sunk:
        for j in range(2):
            if step < result.lengths[j]:
                assert row[j] == result.tokens[j, step]


def test_self_deterministic_across_batch_composition(loop):
    a = loop.submit([1, 2, 3, 4, 5], n=2, max_new=8, temperature=0.7, top_p=0.9, seed=21
                    ).result(timeout=120)
    noise = loop.submit([9, 8, 7], n=2, max_new=16, temperature=1.0, top_p=0.95, seed=4)
    b = loop.submit([1, 2, 3, 4, 5], n=2, max_new=8, temperature=0.7, top_p=0.9, seed=21
                    ).result(timeout=120)
    noise.result(timeout=120)
    assert np.array_equal(a.tokens, b.tokens)
    assert np.allclose(a.logprobs, b.logprobs, atol=1e-5)


def test_greedy_matches_batch_engine(loop):
    cont = loop.submit([1, 2, 3, 4, 5], n=1, max_new=8, temperature=0.0, top_p=None, seed=3
                       ).result(timeout=120)
    batch = loop.engine.generate([1, 2, 3, 4, 5], n=1, max_new_tokens=8, temperature=0.0, seed=3)
    nc, nb = int(cont.lengths[0]), int(batch.lengths[0])
    assert np.array_equal(cont.tokens[0][:nc], batch.tokens[0][:nb])


def test_late_request_joins_in_flight_decode(loop):
    base_joined = loop.stats["joined_in_flight"]
    holder = {}

    def sink(step, _toks):
        if step == 0 and "b" not in holder:
            holder["b"] = loop.submit([4, 5, 6], n=1, max_new=4, temperature=0.8, top_p=0.95,
                                      seed=12)

    a = loop.submit([1, 2, 3], n=2, max_new=32, temperature=0.8, top_p=0.95, seed=11,
                    token_sink=sink).result(timeout=120)
    b = holder["b"].result(timeout=120)
    assert a.tokens.shape[0] == 2 and b.tokens.shape[0] == 1
    st = loop.stats
    assert st["joined_in_flight"] > base_joined and st["max_active_rows"] >= 3
    assert 0 < st["row_steps"] <= st["steps"] * loop.width


def test_budget_abort_retires_rows(loop):
    budget = RequestBudget()
    before = FAILURE_EVENTS.snapshot().get("engine.decode_abort", 0)
    fut = loop.submit([1, 2, 3, 4], n=1, max_new=32, temperature=0.9, top_p=0.9, seed=5,
                      budget=budget)
    time.sleep(0.02)
    budget.cancel()
    with pytest.raises(RequestCancelledError):
        fut.result(timeout=120)
    assert FAILURE_EVENTS.snapshot().get("engine.decode_abort", 0) > before
    ok = loop.submit([1, 2], n=1, max_new=4, temperature=0.0, top_p=None, seed=1).result(timeout=120)
    assert int(ok.lengths[0]) > 0


def test_qualification_bounds(loop):
    assert loop.qualifies(10, 2, 16)
    assert not loop.qualifies(10, loop.width + 1, 16)
    assert not loop.qualifies(loop.max_prompt + 1, 1, 16)
    assert not loop.qualifies(10, 1, loop.max_new + 1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grammar_rows_equal_the_jax_loop(layout, jax_loop):
    """A grammar-constrained request rides the loop under the resident
    grammar (masked steps counted) with the JAX loop's tokens; a request
    under another schema while it decodes raises ValueError."""
    from pydantic import BaseModel

    from k_llms_tpu.engine.grammar import grammar_for_schema as jax_grammar_for_schema
    from k_llms_tpu.engine.grammar import grammar_vocab as jax_grammar_vocab
    from k_llms_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
    from k_llms_tpu_torch.engine.grammar import grammar_for_schema, grammar_vocab
    from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
    from k_llms_tpu_torch.utils.observability import GRAMMAR_EVENTS

    class Rec(BaseModel):
        name: str
        count: int

    class Other(BaseModel):
        flag: bool

    g = grammar_for_schema(Rec.model_json_schema(), grammar_vocab(ByteTokenizer()),
                           vocab_digest="bytetok-rec")
    jg = jax_grammar_for_schema(Rec.model_json_schema(), jax_grammar_vocab(JaxByteTokenizer()),
                                vocab_digest="bytetok-rec")
    other = grammar_for_schema(Other.model_json_schema(), grammar_vocab(ByteTokenizer()),
                               vocab_digest="bytetok-other")
    ids = prompt("extract the record")
    kw = dict(n=2, max_new=24, temperature=1.0, top_p=None, seed=23)
    ref = jax_loop.submit(list(ids), grammar=jg, **kw).result(timeout=120)
    lp = ContinuousDecodeLoop(port_engine(layout), width=4, max_prompt=64, max_new=32)
    try:
        masked = GRAMMAR_EVENTS.get("grammar.masked_steps")
        fut = lp.submit(list(ids), grammar=g, **kw)
        with pytest.raises(ValueError, match="different grammar"):
            lp.submit(list(ids), grammar=other, **kw)
        got = fut.result(timeout=120)
        assert GRAMMAR_EVENTS.get("grammar.masked_steps") > masked
    finally:
        lp.stop()
    assert np.array_equal(np.asarray(ref.tokens), got.tokens)
    assert np.allclose(np.asarray(ref.logprobs), got.logprobs, atol=1e-5)


# -- the backend -------------------------------------------------------------------

LOOP_KNOBS = dict(continuous_batching=True, continuous_width=4, continuous_max_prompt=128,
                  continuous_max_new=64)


def test_loop_fields_take_the_jax_defaults():
    from k_llms_tpu.backends.tpu import BackendConfig as JaxBackendConfig
    from k_llms_tpu_torch.backends.cuda import UNPORTED_FIELDS, BackendConfig, HbmMemoryModel
    from k_llms_tpu_torch.models.config import get_config

    for field in ("continuous_batching", "continuous_width", "continuous_max_prompt",
                  "continuous_max_new", "prefill_chunk_tokens", "device_consensus"):
        assert field not in UNPORTED_FIELDS
        assert BackendConfig.model_fields[field].default == JaxBackendConfig.model_fields[field].default
    assert len(UNPORTED_FIELDS) == 0
    mm = HbmMemoryModel(get_config("tiny"), param_bytes=1 << 20)
    assert mm.prefill_chunk_tokens(4, 32) == 0
    assert mm.prefill_chunk_tokens(32, 2048) == 128
    assert mm.prefill_chunk_tokens(4, 1024) == 32


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_backend_routes_qualifying_requests_to_the_loop(paged):
    """Plain sampling joins the loop; a logit-bias request coalesces and
    runs while the loop decodes, leaving the loop's pool in place; health()
    carries the loop; drain() quiesces it and closes admission."""
    from _torch_serving import port_backend
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.types.wire import BackendUnavailableError, ServerDrainingError

    backend = port_backend(paged=paged, **LOOP_KNOBS)
    client = KLLMs(backend=backend, model="tiny")
    loop = backend._continuous
    msgs = [{"role": "user", "content": "hello"}]
    r = client.chat.completions.create(messages=msgs, n=2, seed=9)
    assert len(r.choices) == 3 and loop.stats["admitted"] == 1
    pool = backend.engine._kv_pool
    tensors = (pool.k, pool.v) if paged else None

    out = {}
    started = threading.Event()

    def long_loop_request():
        started.set()
        out["loop"] = client.chat.completions.create(messages=msgs, n=3, seed=5, max_tokens=64,
                                                     temperature=0.9)

    t = threading.Thread(target=long_loop_request)
    t.start()
    started.wait()
    while loop.stats["steps"] == 0 and t.is_alive():
        time.sleep(0.001)
    launches = []
    generate_many = backend.engine.generate_many

    def counted(items, **kw):
        launches.append(len(items))
        return generate_many(items, **kw)

    backend.engine.generate_many = counted
    biased = client.chat.completions.create(messages=msgs, n=2, seed=3, temperature=0.0,
                                            logit_bias={"65": 5.0})
    del backend.engine.generate_many
    t.join(120)
    assert launches == [1] and len(biased.choices) == 3 and len(out["loop"].choices) == 4
    assert loop.stats["admitted"] == 2 and loop.stats["completed"] == 2
    if paged:
        assert backend.engine._kv_pool is pool and (pool.k, pool.v) == tensors
        assert pool.allocator.total_pages == loop._pool_pages_planned
    health = backend.health()
    assert health["continuous"]["completed"] == 2
    assert backend.drain(timeout=30)
    with pytest.raises((ServerDrainingError, BackendUnavailableError)):
        client.chat.completions.create(messages=msgs)
    client.close()


def test_backend_loop_answers_equal_the_jax_backend_loop():
    """The same requests through a JAX TpuBackend with the loop and the
    port's: the same choices (greedy and sampled) and consensus."""
    from _torch_serving import port_backend
    from conftest import shared_engine

    from k_llms_tpu import KLLMs as JaxKLLMs
    from k_llms_tpu.backends.tpu import TpuBackend
    from k_llms_tpu_torch import KLLMs

    jb = TpuBackend(model="tiny", max_new_tokens=8, engine=shared_engine("tiny"), **LOOP_KNOBS)
    jc = JaxKLLMs(backend=jb, model="tiny")
    pc = KLLMs(backend=port_backend(paged=False, **LOOP_KNOBS), model="tiny")
    try:
        for kw in (dict(n=3, seed=9, temperature=0.0), dict(n=3, seed=4, temperature=0.8)):
            msgs = [{"role": "user", "content": "stream parity"}]
            ref = jc.chat.completions.create(messages=msgs, model="tiny", **kw)
            got = pc.chat.completions.create(messages=msgs, **kw)
            assert [c.message.content for c in got.choices] == [c.message.content for c in ref.choices]
        assert pc.backend._continuous.stats["admitted"] == 2
        assert jb._continuous.stats["admitted"] == 2
    finally:
        jc.close()
        pc.close()


def test_loop_copies_pages_of_a_pool_a_coalesced_launch_built():
    """The first paged use builds the engine's page pool; when that is a
    coalesced launch (under ``torch.inference_mode``) its tensors are
    inference tensors, and the loop's copy-on-write of a shared prompt page
    (two rows of one request diverging) must still write them: the worker
    serves the request instead of crashing into a restart."""
    from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend

    engine = LocalEngine("tiny", params=port_params(), device="cpu", kv_layout="paged",
                         kv_page_size=8)
    backend = CudaBackend(
        config=BackendConfig(model="tiny", device="cpu", max_new_tokens=8,
                             continuous_batching=True, continuous_width=4,
                             continuous_max_prompt=128, continuous_max_new=64),
        engine=engine)
    from k_llms_tpu_torch import KLLMs

    client = KLLMs(backend=backend, model="tiny")
    messages = [{"role": "user", "content": "hi"}]
    try:
        wide = client.chat.completions.create(messages=messages, n=8, seed=1, temperature=0.8)
        assert engine._kv_pool is not None and engine._kv_pool.k.is_inference()
        cows = engine._kv_pool.allocator.snapshot()["cow_copies"]
        out = client.chat.completions.create(messages=messages, n=2, seed=2, temperature=0.8)
        loop = backend.health()["continuous"]
        assert len(wide.choices) == 9 and len(out.choices) == 3
        assert loop["admitted"] == 1 and loop["restarts"] == 0
        assert loop["pages"]["cow_copies"] > cows
    finally:
        client.close()
