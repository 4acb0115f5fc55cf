"""The port's scheduler and its place in the serving chain.

The scheduler is a copy of the JAX package's (``tests/test_torch_host_copies.py``
pins the source). These twins of ``tests/test_scheduler.py`` and
``tests/test_overload.py`` drive the port's copy and the port's backend on
the CPU: serial launches, coalescing by key inside the window, the row cap,
weight-bounded admission with typed 429s, drain, health and the OOM width
backoff. Then the differential: four requests queued behind a parked worker
are served by one launch through the port's scheduler and supervisor, and
each member's tokens equal the JAX engine's ``generate_many`` of the same
specs on the same weights (fp32 ``tiny``, paged and dense, greedy and
sampled), logprobs within 1e-5.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from _torch_serving import port_backend, prompt
from conftest import shared_engine
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu_torch import AsyncKLLMs
from k_llms_tpu_torch.backends.base import ChatRequest
from k_llms_tpu_torch.backends.cuda import HbmMemoryModel
from k_llms_tpu_torch.engine.scheduler import EngineScheduler, ServerState
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.reliability.drills import park_worker, queue_in_order
from k_llms_tpu_torch.types.wire import BackendUnavailableError, RateLimitError

ATOL = 1e-5


def _echo(payloads):
    return list(payloads)


# -- the scheduler copy ------------------------------------------------------


def test_scheduler_serializes_closures():
    sched = EngineScheduler(name="t")
    active, overlap = [], []

    def work(i):
        active.append(i)
        if len(active) > 1:
            overlap.append(tuple(active))
        time.sleep(0.01)
        active.remove(i)
        return i

    futures = [sched.submit(lambda i=i: work(i)) for i in range(8)]
    assert [f.result(timeout=10) for f in futures] == list(range(8))
    assert overlap == []
    assert sched.stats["served"] == 8
    sched.shutdown()


def test_submit_batched_coalesces_only_the_contiguous_same_key_run():
    sched = EngineScheduler(name="t", batch_window=0.0)
    calls = []

    def runner(payloads):
        calls.append(list(payloads))
        return [p * 2 for p in payloads]

    gate = park_worker(sched)
    futs = [sched.submit_batched(key, i, runner) for i, key in
            enumerate([("a",), ("a",), ("a",), ("b",), ("a",)])]
    gate.set()
    assert [f.result(timeout=10) for f in futs] == [0, 2, 4, 6, 8]
    assert calls == [[0, 1, 2], [3], [4]]
    assert sched.stats["batches"] == 3 and sched.stats["coalesced"] == 2
    sched.shutdown()


def test_row_cap_splits_groups():
    """Groups stop growing at the row cap: five n=32 requests never fuse
    into one 160-row launch."""
    sched = EngineScheduler(name="t", max_rows=64, batch_window=0.0)
    calls = []

    def runner(payloads):
        calls.append(list(payloads))
        return list(payloads)

    gate = park_worker(sched)
    futs = [sched.submit_batched(("k",), i, runner, weight=32) for i in range(5)]
    gate.set()
    [f.result(timeout=10) for f in futs]
    assert [len(c) for c in calls] == [2, 2, 1]
    sched.shutdown()


def test_queue_cap_sheds_with_typed_429_and_retry_after():
    sched = EngineScheduler(name="t", batch_window=0.0, max_queue_weight=4)
    gate = park_worker(sched)
    try:
        f1 = sched.submit_batched(("k",), 1, _echo, weight=2)
        f2 = sched.submit_batched(("k",), 2, _echo, weight=2)
        f3 = sched.submit_batched(("k",), 3, _echo, weight=2)
        with pytest.raises(RateLimitError) as ei:
            f3.result(timeout=5)
        assert ei.value.status_code == 429
        assert 0.1 <= ei.value.retry_after <= 60.0
        assert sched.health()["shed_over_capacity"] == 1
        gate.set()
        assert (f1.result(timeout=5), f2.result(timeout=5)) == (1, 2)
    finally:
        gate.set()
        sched.shutdown()


def test_drain_finishes_backlog_then_rejects_with_503():
    sched = EngineScheduler(name="t", batch_window=0.0)
    gate = park_worker(sched)
    queued = [sched.submit(lambda i=i: i * i) for i in range(3)]
    threading.Timer(0.1, gate.set).start()
    assert sched.drain(timeout=10) is True
    assert [f.result(timeout=0) for f in queued] == [0, 1, 4]
    assert sched.state is ServerState.STOPPED
    with pytest.raises(BackendUnavailableError):
        sched.submit(lambda: 1).result(timeout=1)


def test_note_oom_halves_width_then_recovers():
    sched = EngineScheduler(name="t", max_rows=64)
    try:
        sched.note_oom()
        assert sched._effective_max_rows() == 32
        assert sched.state is ServerState.DEGRADED
        for _ in range(3):
            sched.note_recovered()
        assert sched._effective_max_rows() == 64
        assert sched.state is ServerState.READY
    finally:
        sched.shutdown()


# -- the memory model ----------------------------------------------------------


def test_memory_model_rows_shrink_with_seq_len_and_paged_fanout_amortises():
    cfg = get_config("llama-3-8b")
    m = HbmMemoryModel(cfg, param_bytes=16 << 30, hbm_bytes=80 << 30)
    # 8B bf16 KV: 2 * 32 layers * 1024 kv features * 2 bytes per token-row.
    assert m.kv_bytes_per_token == 2 * 32 * 1024 * 2
    assert m.max_rows(256) > m.max_rows(8192) >= 1
    assert m.paged_max_rows(1490, 32, 64, fanout=8) > m.paged_max_rows(1490, 32, 64, fanout=1)
    # Parameters alone beyond the plan: still one row (the OOM guard owns it).
    assert HbmMemoryModel(cfg, param_bytes=16 << 30, hbm_bytes=8 << 30).max_rows(8192) == 1


def test_memory_model_falls_back_to_16_gib_off_the_card():
    m = HbmMemoryModel(get_config("tiny"), param_bytes=1 << 20)
    assert m.hbm_bytes == 16 * (1 << 30)
    assert m.describe()["max_rows_at_max_seq"] > 64


# -- through the port's backend ------------------------------------------------


def test_concurrent_async_requests_share_one_launch():
    """Four gathered ``AsyncKLLMs`` requests, queued behind the parked
    worker, decode as one launch; each equals its solo run."""
    async def main(client):
        reqs = [
            client.chat.completions.create(
                messages=[{"role": "user", "content": "same question"}], n=2, seed=i
            )
            for i in range(4)
        ]
        return await asyncio.gather(*reqs)

    backend = port_backend(batch_window=0.0)
    launches = []
    generate_many = backend.engine.generate_many

    def spy(items, **kw):
        launches.append(len(items))
        return generate_many(items, **kw)

    backend.engine.generate_many = spy
    gate = park_worker(backend.scheduler)

    def release():
        while backend.scheduler.stats["queued"] < 4:
            time.sleep(0.005)
        gate.set()

    threading.Thread(target=release, daemon=True).start()
    results = asyncio.run(main(AsyncKLLMs(backend=backend)))
    assert launches[0] == 4, launches
    solo = port_backend()
    for i, r in enumerate(results):
        want = solo.chat_completion(ChatRequest(
            messages=[{"role": "user", "content": "same question"}], model="tiny", n=2, seed=i))
        assert [c.message.content for c in r.choices[1:]] == [c.message.content for c in want.choices]
    backend.close()
    solo.close()


def test_backend_health_merges_breaker_supervisor_and_memory_model():
    backend = port_backend()
    backend.chat_completion(ChatRequest(messages=[{"role": "user", "content": "hi"}],
                                        model="tiny", n=2, seed=1))
    h = backend.health()
    assert h["state"] == "ready" and h["breaker"] == "closed"
    assert h["engine_oom"] == {"splits": 0, "unrecovered": 0}
    assert h["supervisor"]["rebuilds"] == 0
    assert h["supervisor"]["launch_budget"]["observed_launches"] == 1
    assert h["memory_model"]["hbm_bytes"] == 16 * (1 << 30)
    assert h["hbm"]["paged"] is True and h["hbm"]["page_pool"]["in_use"] == 0
    assert backend.drain(timeout=10) is True
    with pytest.raises(BackendUnavailableError):
        backend.chat_completion(ChatRequest(messages=[{"role": "user", "content": "hi"}],
                                            model="tiny"))
    assert backend.health()["state"] == "stopped"


def test_drain_with_a_queued_request_answers_it_before_stopping():
    backend = port_backend(batch_window=0.0)
    gate = park_worker(backend.scheduler)
    req = ChatRequest(messages=[{"role": "user", "content": "queued"}], model="tiny", n=1, seed=4)
    threads, results = queue_in_order(backend.scheduler, [lambda: backend.chat_completion(req)])
    threading.Timer(0.1, gate.set).start()
    assert backend.drain(timeout=30) is True
    threads[0].join(timeout=30)
    assert len(results[0].choices) == 1
    with pytest.raises(BackendUnavailableError):  # a typed 503 once stopped
        backend.chat_completion(req)


# -- coalesced launches against the JAX engine -----------------------------------

# (prompt text, n, seed): four requests with unequal prompts and n.
GROUP = [("alpha", 2, 5), ("a somewhat longer second prompt", 3, 6),
         ("three", 1, 7), ("the fourth request of the group", 2, 8)]


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_coalesced_group_equals_jax_generate_many(paged, temperature):
    backend = port_backend(paged=paged, batch_window=0.0, max_new_tokens=10)
    eos = backend.tokenizer.stop_ids
    gate = park_worker(backend.scheduler)

    def call(text, n, seed):
        return lambda: backend._generate_batched(
            prompt(text), n=n, max_new=10, temperature=temperature, top_p=None,
            seed=seed, constraint=None,
        )

    threads, got = queue_in_order(backend.scheduler, [call(*g) for g in GROUP])
    assert backend.scheduler.stats["queued"] == len(GROUP)
    gate.set()
    for t in threads:
        t.join(timeout=60)
    stats = backend.scheduler.stats
    assert stats["batches"] == 1 and stats["coalesced"] == len(GROUP) - 1, stats
    assert backend.engine.last_launch_stats["rows"] == 4 * 3  # r_pad 4 x n_per 3

    jeng = shared_engine("tiny", kv_layout="paged") if paged else shared_engine("tiny")
    want = jeng.generate_many(
        [JaxSpec(prompt(text), n, seed) for text, n, seed in GROUP],
        max_new_tokens=10, temperature=temperature, eos_ids=eos,
    )
    for i, w in enumerate(want):
        g = got[i]
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        np.testing.assert_allclose(g.logprobs, np.asarray(w.logprobs), atol=ATOL, rtol=0)
        assert list(g.finish_reasons) == list(w.finish_reasons)
    backend.close()
