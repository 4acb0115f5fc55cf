"""Chunked prefill in the port's continuous loop, on the CPU at tiny fp32.

Twins of ``tests/test_chunked_prefill.py``: chunked-on output tokens equal
chunked-off (logprobs within 1e-5, the JAX package's own differential) on
both KV layouts, and equal the JAX loop's chunked run; the stream and a
grammar row chunk like any other; chunks interleave with in-flight decode;
short prompts skip chunking; a prefix-cache hit skips it bitwise; the knob
normalises as in JAX; a hung chunk rebuilds and replays bitwise; a budget
abort retires the PREFILLING row. ``models.llama.prefill_chunk_step`` is
held against the JAX function directly.
"""

import json
import time

import numpy as np
import pytest
import torch

from _torch_serving import port_params, prompt
from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.deadline import RequestBudget
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.reliability.supervisor import LaunchBudgetModel
from k_llms_tpu_torch.types.wire import RequestCancelledError
from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS, RECOVERY_EVENTS

LONG_PROMPT = list(range(2, 100))  # 98 tokens: 4 chunks at C=32
CHUNK = 32


def _step_budget(seconds):
    return LaunchBudgetModel(base_s=0.1, per_token_s=0.01, multiplier=1.0,
                             min_budget_s=seconds, max_budget_s=seconds)


def _engine(layout, **kw):
    return LocalEngine("tiny", params=port_params(), device="cpu", kv_layout=layout,
                       kv_page_size=16, **kw)


@pytest.fixture(scope="module")
def eng():
    return _engine("dense")


@pytest.fixture(scope="module")
def paged_eng():
    return _engine("paged")


def _run(loop, ids=LONG_PROMPT, **kw):
    kw.setdefault("n", 2)
    kw.setdefault("max_new", 8)
    kw.setdefault("temperature", 0.7)
    kw.setdefault("top_p", 0.9)
    kw.setdefault("seed", 11)
    return loop.submit(list(ids), **kw).result(timeout=120)


def _assert_same_output(on, off, label=""):
    assert np.array_equal(on.tokens, off.tokens), label
    assert list(on.lengths) == list(off.lengths), label
    assert list(on.finish_reasons) == list(off.finish_reasons), label
    assert np.allclose(on.logprobs, off.logprobs, atol=1e-5), label


def _loop(engine, chunk=CHUNK, **kw):
    kw.setdefault("width", 4)
    kw.setdefault("max_prompt", 128)
    kw.setdefault("max_new", 16)
    return ContinuousDecodeLoop(engine, prefill_chunk_tokens=chunk, **kw)


def test_prefill_chunk_step_equals_jax():
    """Four chunks of a 98-token prompt through the port's chunk step and
    the JAX function: the staging cache and the last chunk's logits within
    1e-5, paged columns sliced at the cursor."""
    import jax.numpy as jnp

    from conftest import shared_params
    from k_llms_tpu.models import get_config as jax_get_config
    from k_llms_tpu.models.llama import init_cache as jax_init_cache
    from k_llms_tpu.models.llama import prefill_chunk_step as jax_chunk

    cfg = get_config("tiny")
    jcfg = jax_get_config("tiny")
    jparams = shared_params(jcfg, 0)
    params = port_params()
    cache = llama.init_cache(cfg, 1, 128, "cpu")
    jcache = jax_init_cache(jcfg, 1, 128)
    for start in range(0, len(LONG_PROMPT), CHUNK):
        valid = min(CHUNK, len(LONG_PROMPT) - start)
        chunk = np.full((1, CHUNK), cfg.pad_token_id, np.int64)
        chunk[0, :valid] = LONG_PROMPT[start:start + valid]
        logits, cache, kc, vc = llama.prefill_chunk_step_paged(
            cfg, params, torch.as_tensor(chunk), cache, start, valid)
        assert torch.equal(kc, cache.k[:, 0, start:start + CHUNK])
        jl, jcache = jax_chunk(jcfg, jparams, jnp.asarray(chunk, jnp.int32), jcache,
                               jnp.int32(start), jnp.int32(valid))
    n = len(LONG_PROMPT)
    np.testing.assert_allclose(cache.k[:, :, :n].numpy(), np.asarray(jcache.k)[:, :, :n], atol=1e-5)
    np.testing.assert_allclose(cache.v[:, :, :n].numpy(), np.asarray(jcache.v)[:, :, :n], atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("label,kw", [("greedy", dict(temperature=0.0, top_p=None)),
                                      ("sampled", dict(temperature=0.7, top_p=0.9))])
def test_chunked_on_off_differential_dense(eng, label, kw):
    off = _loop(eng, chunk=0)
    try:
        base = _run(off, **kw)
    finally:
        off.stop()
    on = _loop(eng)
    try:
        got = _run(on, **kw)
        st = dict(on.stats)
    finally:
        on.stop()
    assert st["prefill_chunks"] == (len(LONG_PROMPT) + CHUNK - 1) // CHUNK
    _assert_same_output(got, base, label)


def test_chunked_on_off_differential_paged(paged_eng):
    off = _loop(paged_eng, chunk=0)
    try:
        base, base_g = _run(off), _run(off, temperature=0.0, top_p=None, seed=3)
    finally:
        off.stop()
    on = _loop(paged_eng)
    try:
        assert on.paged
        got, got_g = _run(on), _run(on, temperature=0.0, top_p=None, seed=3)
        alloc = on._pool.allocator
        alloc.verify()
        free_mid = alloc.free_pages
        _run(on, seed=29)
        assert alloc.free_pages == free_mid  # no leak per admission cycle
    finally:
        on.stop()
    alloc.verify()
    _assert_same_output(got, base, "paged sampled")
    _assert_same_output(got_g, base_g, "paged greedy")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunked_run_equals_the_jax_loop(layout):
    from conftest import shared_engine

    from k_llms_tpu.engine.continuous import ContinuousDecodeLoop as JaxLoop

    jl = JaxLoop(shared_engine(model="tiny"), width=4, max_prompt=128, max_new=16,
                 prefill_chunk_tokens=CHUNK)
    try:
        ref = [_run(jl, seed=5), _run(jl, temperature=0.0, top_p=None, seed=6)]
    finally:
        jl.stop()
    on = _loop(_engine(layout))
    try:
        got = [_run(on, seed=5), _run(on, temperature=0.0, top_p=None, seed=6)]
    finally:
        on.stop()
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r.tokens), g.tokens)
        assert np.allclose(np.asarray(r.logprobs), g.logprobs, atol=1e-5)


def test_chunked_stream_sink_is_contiguous_and_identical(eng):
    def collect(loop):
        sunk = []
        got = loop.submit(list(LONG_PROMPT), n=2, max_new=8, temperature=0.8, top_p=0.9, seed=17,
                          token_sink=lambda s, t: sunk.append((s, t.copy()))).result(timeout=120)
        return got, sunk

    off = _loop(eng, chunk=0)
    try:
        base, base_sunk = collect(off)
    finally:
        off.stop()
    on = _loop(eng)
    try:
        got, sunk = collect(on)
    finally:
        on.stop()
    assert np.array_equal(got.tokens, base.tokens)
    steps = [s for s, _ in sunk]
    assert steps == sorted(set(steps))
    assert [(s, r.tolist()) for s, r in sunk] == [(s, r.tolist()) for s, r in base_sunk]


def test_chunked_grammar_row_matches_off(eng):
    from pydantic import BaseModel

    from k_llms_tpu_torch.engine.grammar import (
        grammar_for_schema,
        grammar_vocab,
        validate_grammar_tokens,
    )
    from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer

    class Rec(BaseModel):
        name: str
        count: int

    g = grammar_for_schema(Rec.model_json_schema(), grammar_vocab(ByteTokenizer()),
                           vocab_digest="bytetok-rec")
    ids = prompt("extract the record " * 4)
    assert len(ids) > 2 * CHUNK
    kw = dict(n=1, max_new=96, temperature=1.0, top_p=None, seed=23, grammar=g)
    off = _loop(eng, chunk=0, width=2, max_new=96)
    try:
        base = off.submit(list(ids), **kw).result(timeout=120)
    finally:
        off.stop()
    on = _loop(eng, width=2, max_new=96)
    try:
        got = on.submit(list(ids), **kw).result(timeout=120)
        st = dict(on.stats)
    finally:
        on.stop()
    assert st["prefill_chunks"] >= 2
    assert np.array_equal(got.tokens, base.tokens)
    body = [int(t) for t in got.tokens[0][: int(got.lengths[0])] if t < 256]
    assert validate_grammar_tokens(g, body)[0], bytes(body)
    if got.finish_reasons[0] == "stop":
        Rec.model_validate(json.loads(bytes(body)))


def test_chunks_interleave_with_inflight_decode(eng):
    solo = _loop(eng, chunk=0, max_new=64)
    try:
        base = solo.submit([7, 8, 9], n=1, max_new=48, temperature=0.6, top_p=0.9, seed=5
                           ).result(timeout=120)
    finally:
        solo.stop()
    on = _loop(eng, max_new=64)
    try:
        inflight = on.submit([7, 8, 9], n=1, max_new=48, temperature=0.6, top_p=0.9, seed=5)
        long_fut = on.submit(list(LONG_PROMPT), n=1, max_new=8, temperature=0.0, top_p=None, seed=2)
        got = inflight.result(timeout=120)
        long_res = long_fut.result(timeout=120)
        st = dict(on.stats)
    finally:
        on.stop()
    assert st["prefill_chunks"] >= 1 and st["prefill_interleaved"] >= 1
    assert int(long_res.lengths[0]) > 0
    assert np.array_equal(got.tokens, base.tokens)
    assert np.array_equal(got.logprobs, base.logprobs)


def test_short_prompt_skips_chunking(eng):
    on = _loop(eng, width=2, max_prompt=64, max_new=8)
    try:
        got = _run(on, ids=[1, 2, 3, 4], n=1)
        st = dict(on.stats)
    finally:
        on.stop()
    assert st["prefill_chunks"] == 0 and int(got.lengths[0]) > 0


def test_prefix_cache_hit_skips_chunking_bitwise():
    on = _loop(_engine("paged", prefix_cache_size=4))
    try:
        first = _run(on)
        chunks_after_first = dict(on.stats)["prefill_chunks"]
        again = _run(on)
        st = dict(on.stats)
    finally:
        on.stop()
    assert chunks_after_first == (len(LONG_PROMPT) + CHUNK - 1) // CHUNK
    assert st["prefill_chunks"] == chunks_after_first
    assert np.array_equal(first.tokens, again.tokens)
    assert np.array_equal(first.logprobs, again.logprobs)


def test_chunk_tokens_normalization(eng):
    for given, want in ((0, 0), (-5, 0), (1, 32), (31, 32), (32, 32), (48, 32), (64, 64),
                        (100, 64)):
        loop = ContinuousDecodeLoop(eng, width=1, max_prompt=64, max_new=4,
                                    prefill_chunk_tokens=given)
        try:
            assert loop.prefill_chunk_tokens == want, (given, want)
        finally:
            loop.stop()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mid_chunk_hang_rebuilds_and_replays_bitwise(layout):
    """A chunk wedged past the watchdog budget is abandoned behind the epoch
    fence, the loop rebuilds, and the journaled admission replays from
    cursor 0, bitwise equal to an uninterrupted chunked run."""
    engine = _engine(layout)
    baseline = _loop(engine)
    try:
        base = _run(baseline, seed=23)
    finally:
        baseline.stop()
    loop = _loop(engine, budget_model=_step_budget(2.0), rebuild_fn=lambda: engine,
                 max_rebuilds=3)
    try:
        hangs = RECOVERY_EVENTS.get("continuous.step_hangs")
        with fp.failpoints({"continuous.prefill": FailSpec(action="hang", times=1, delay=8.0)}):
            got = _run(loop, seed=23)
        assert RECOVERY_EVENTS.get("continuous.step_hangs") > hangs
        st = dict(loop.stats)
    finally:
        loop.stop()
    assert st["restarts"] >= 1 and st["last_recovery_reason"] == "hung_step"
    assert np.array_equal(got.tokens, base.tokens)
    assert np.array_equal(got.logprobs, base.logprobs)
    assert list(got.lengths) == list(base.lengths)


def test_prefilling_budget_abort_retires_row(paged_eng):
    budget = RequestBudget()
    before = FAILURE_EVENTS.get("engine.decode_abort")
    loop = _loop(paged_eng)
    try:
        free0 = None
        with fp.failpoints({"continuous.prefill": FailSpec(action="hang", times=1, delay=1.0)}):
            fut = loop.submit(list(LONG_PROMPT), n=2, max_new=16, temperature=0.7, top_p=0.9,
                              seed=11, budget=budget)
            time.sleep(0.2)
            budget.cancel()
            with pytest.raises(RequestCancelledError):
                fut.result(timeout=60)
        assert FAILURE_EVENTS.get("engine.decode_abort") > before
        assert dict(loop.stats)["aborted"] >= 1
        assert dict(loop.stats)["pages"]["loop_refs"] == 0
        free0 = loop._pool.allocator.free_pages
        ok = _run(loop, seed=31)
        assert int(ok.lengths[0]) > 0 and loop._pool.allocator.free_pages == free0
    finally:
        loop.stop()
