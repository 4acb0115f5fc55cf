"""The engine's launch lock: concurrent launches on one ``LocalEngine`` run
one at a time, as the JAX package's scheduler runs every launch on its single
worker.

A paged launch picks the page pool, prefills into it and frees its pages at
its end; a second launch that needs a larger pool replaces it. Without the
lock, a launch started while another sits between its pool pick and its
prefill swapped the pool under it: its prompt pages came from the new pool
while its block tables indexed the old one, and a slot index past the pool,
an exhausted pool or a page freed twice (``PageAccountingError``) followed.
Tiny model on the CPU; each test takes a few seconds.
"""

import asyncio
import threading

import numpy as np

from k_llms_tpu_torch import AsyncKLLMs, KLLMs
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer


def _prompt(text):
    return ByteTokenizer().apply_chat_template([{"role": "user", "content": text}])


# (prompt, n, seed, max_new_tokens): the second launch needs more pages than
# the first, so it would replace the pool the first one picked.
SMALL = (_prompt("hi"), 2, 11, 6)
LARGE = (_prompt("a longer question about invoices " * 6), 4, 12, 24)


def _generate(engine, spec):
    prompt, n, seed, max_new = spec
    return engine.generate(prompt, n=n, seed=seed, max_new_tokens=max_new, temperature=0.8)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.logprobs, want.logprobs)
    assert got.finish_reasons == want.finish_reasons


def test_second_launch_waits_until_the_first_frees_its_pool():
    """The second launch starts while the first sits between its pool pick
    and its prefill (held there by a patched ``_prefill_full``): it waits
    for the first to end, no page is freed twice, and both outputs equal
    sequential runs on an engine with the same weights."""
    ref_engine = LocalEngine("tiny", device="cpu", kv_page_size=16)
    want = {"small": _generate(ref_engine, SMALL), "large": _generate(ref_engine, LARGE)}

    engine = LocalEngine("tiny", device="cpu", kv_page_size=16)
    in_prefill, release = threading.Event(), threading.Event()
    prefill = engine._prefill_full
    held = []

    def gated_prefill(*args, **kwargs):
        if not held:  # the first launch's prefill waits for the release
            held.append(True)
            in_prefill.set()
            assert release.wait(60)
        return prefill(*args, **kwargs)

    engine._prefill_full = gated_prefill
    got = {}

    def run(name, spec):
        try:
            got[name] = _generate(engine, spec)
        except BaseException as e:  # noqa: BLE001 - reported by the asserts below
            got[name] = e

    first = threading.Thread(target=run, args=("small", SMALL))
    first.start()
    assert in_prefill.wait(60)
    second = threading.Thread(target=run, args=("large", LARGE))
    second.start()
    second.join(timeout=2.0)  # unserialised, the second launch runs to its end here
    second_waited = second.is_alive()
    release.set()
    first.join(120)
    second.join(120)
    for name in ("small", "large"):
        assert not isinstance(got[name], BaseException), got[name]
    assert second_waited
    for name, result in got.items():
        _assert_same(result, want[name])
    engine._kv_pool.allocator.verify()
    assert engine._kv_pool.allocator.free_pages == engine._kv_pool.allocator.usable_pages


def test_gathered_async_requests_equal_sequential_runs():
    """Four ``AsyncKLLMs`` requests of different sizes gathered on one
    client (each a thread on one engine) give the responses that the
    sequential ``KLLMs`` runs give for the same seeds."""
    requests = [
        dict(messages=[{"role": "user", "content": "item " * (3 + 9 * i)}], n=2 + i,
             temperature=0.8, seed=100 + i, max_tokens=8 + 6 * i)
        for i in range(4)
    ]

    def summary(resp):
        return ([c.message.content for c in resp.choices],
                [c.sample_logprob for c in resp.choices[1:]], resp.likelihoods)

    sync = KLLMs(backend="cuda", model="tiny", device="cpu")
    want = [summary(sync.chat.completions.create(**r)) for r in requests]
    sync.close()

    async def gathered():
        async with AsyncKLLMs(backend="cuda", model="tiny", device="cpu") as client:
            return await asyncio.gather(*(client.chat.completions.create(**r) for r in requests))

    got = [summary(r) for r in asyncio.run(gathered())]
    assert got == want
