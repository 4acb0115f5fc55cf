"""The paged KV layout against dense, port against JAX (twin of
``tests/test_paged_differential.py``, ``tests/test_paged_coalesced.py``,
``tests/test_paged_allocator.py``, and the loop case of
``tests/test_paged_eviction.py``).

Paging is an optimisation, not a semantic change: on the port, a paged
engine and loop give byte-identical tokens, logprobs, lengths and finish
reasons to their dense twins on equal inputs (n-way prompt sharing,
copy-on-write at a partial page, a mid-flight join, an aborted request's
survivors, prefix-cache runs, both fallbacks to dense, the
``ops.paged_attn`` drill left armed by a launch the pool cannot hold), and
the same tokens as the JAX engine and loop (logprobs within 1e-5). The page
allocator is driven through seeded admit / fork / copy-on-write / retire
schedules beside the JAX package's allocator and an independent
reference, with the block tables and refcounts equal after every
operation; misuse and leaks raise as in JAX. Weights: the JAX package's
seeded tiny tree in both packages."""

import random
import time

import numpy as np
import pytest

from _torch_serving import port_params
from conftest import shared_engine
from k_llms_tpu.engine import paging as jax_paging
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.engine.paging import (
    TRASH_PAGE,
    PageAccountingError,
    PageAllocator,
    PagePoolExhausted,
    flat_slots,
    pages_for,
)
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.deadline import RequestBudget
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.types.wire import RequestCancelledError
from k_llms_tpu_torch.utils.observability import KERNEL_EVENTS

from test_paged_allocator import _RefAllocator

PAGE = 8  # small pages so tiny prompts span and split several


def engine(layout, **kw):
    return LocalEngine("tiny", params=port_params(), device="cpu", kv_layout=layout,
                       kv_page_size=PAGE, **kw)


def assert_identical(a, b, logprobs_atol=0.0):
    """Tokens, lengths and finish reasons equal; logprobs bit-equal
    (port layouts) or within ``logprobs_atol`` (port against JAX)."""
    np.testing.assert_array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
    np.testing.assert_array_equal(np.asarray(a.lengths), np.asarray(b.lengths))
    assert list(a.finish_reasons) == list(b.finish_reasons)
    if logprobs_atol:
        np.testing.assert_allclose(np.asarray(a.logprobs), np.asarray(b.logprobs),
                                   atol=logprobs_atol, rtol=0)
    else:
        np.testing.assert_array_equal(np.asarray(a.logprobs), np.asarray(b.logprobs))


# -- the continuous loop ------------------------------------------------------


@pytest.fixture(scope="module")
def loops():
    from k_llms_tpu.engine.continuous import ContinuousDecodeLoop as JaxLoop

    kw = dict(width=4, max_prompt=64, max_new=16)
    dense = ContinuousDecodeLoop(engine("dense"), **kw)
    paged = ContinuousDecodeLoop(engine("paged"), **kw)
    jax_loop = JaxLoop(shared_engine(model="tiny"), **kw)
    assert not dense.paged and paged.paged
    yield dense, paged, jax_loop
    for lp in (dense, paged, jax_loop):
        lp.stop()


def all_three(loops, prompt, **kw):
    """The request through the dense and paged port loops and the JAX loop:
    the layouts byte-identical, the JAX loop's tokens equal."""
    rd, rp, rj = (lp.submit(prompt, **kw).result(timeout=180) for lp in loops)
    assert_identical(rd, rp)
    assert_identical(rp, rj, logprobs_atol=1e-5)
    return rp


@pytest.mark.parametrize("prompt,n,max_new,seed,cow", [
    ([5, 6, 7, 8, 9, 10, 11], 3, 12, 17, True),  # ends mid-page: n - 1 rows copy
    (list(range(5, 5 + 2 * PAGE)), 2, 10, 23, False),  # exactly two pages: no copy
])
def test_greedy_fanout_at_partial_page_and_page_boundary(loops, prompt, n, max_new, seed, cow):
    cows = loops[1]._pool.allocator.stats["cow_copies"] if loops[1]._pool else 0
    all_three(loops, prompt, n=n, max_new=max_new, temperature=0.0, top_p=None, seed=seed)
    copied = loops[1]._pool.allocator.stats["cow_copies"] - cows
    assert copied >= n - 1 if cow else copied == 0


def test_sampled_identical(loops):
    all_three(loops, [1, 2, 3, 4], n=2, max_new=10, temperature=0.8, top_p=0.9, seed=3)


def test_midflight_join_identical(loops):
    """A request joining a decode in flight comes out as it does alone, on
    both layouts and in the JAX loop; the paged join leaves the first
    request's pages alone."""
    results = []
    for lp in loops:
        holder = {}

        def sink(step, _toks, lp=lp, holder=holder):
            if step == 0 and "b" not in holder:
                holder["b"] = lp.submit([4, 5, 6], n=2, max_new=6, temperature=0.7, top_p=0.95,
                                        seed=12)

        a = lp.submit([1, 2, 3], n=2, max_new=14, temperature=0.7, top_p=0.95, seed=11,
                      token_sink=sink).result(timeout=180)
        results.append((a, holder["b"].result(timeout=180)))
        assert lp.stats["joined_in_flight"] >= 1
    for i in range(2):
        assert_identical(results[0][i], results[1][i])
        assert_identical(results[1][i], results[2][i], logprobs_atol=1e-5)


def test_budget_abort_releases_pages_and_survivors_match(loops):
    dense, paged, _ = loops
    budget = RequestBudget()
    fut = paged.submit([9, 8, 7, 6, 5], n=2, max_new=16, temperature=0.9, top_p=0.9, seed=5,
                       budget=budget)
    time.sleep(0.02)
    budget.cancel()
    with pytest.raises(RequestCancelledError):
        fut.result(timeout=180)
    all_three(loops, [2, 4, 6, 8], n=2, max_new=8, temperature=0.0, top_p=None, seed=9)


def test_drain_leaves_zero_loop_refs(loops):
    paged = loops[1]
    assert paged.drain(timeout=60)
    pages = paged.stats["pages"]
    assert pages["loop_refs"] == 0 and pages["in_use"] == 0
    paged._closing = False  # reopen for the module's later tests


# -- generate_many: the coalesced batch --------------------------------------

PROMPT_A = list(range(3, 20))  # 17 tokens: three pages, a partial tail
PROMPT_B = list(range(5, 16))  # 11 tokens
PROMPT_C = PROMPT_A[:9]  # a strict prefix of A: admission shares its pages


def items(seed0=7, spec=GenRequestSpec):
    return [spec(PROMPT_A, 2, seed0), spec(PROMPT_B, 3, seed0 + 4), spec(PROMPT_C, 1, seed0 + 6)]


@pytest.fixture(scope="module")
def engines():
    # An explicit pool size: the pool is built once, at the first paged
    # launch, and must hold every launch of the module.
    return engine("dense"), engine("paged", kv_pool_pages=256)


def xla_dispatches():
    return KERNEL_EVENTS.snapshot().get("kernel.paged_attn_xla_dispatch", 0)


def assert_batches(rd, rp, top_logprobs=False, logprobs_atol=0.0):
    assert len(rd) == len(rp)
    for a, b in zip(rd, rp):
        assert not isinstance(a, Exception) and not isinstance(b, Exception)
        assert_identical(a, b, logprobs_atol)
        if top_logprobs:
            np.testing.assert_array_equal(np.asarray(a.top_tokens), np.asarray(b.top_tokens))
            if logprobs_atol:
                np.testing.assert_allclose(np.asarray(a.top_logprobs), np.asarray(b.top_logprobs),
                                           atol=logprobs_atol, rtol=0)
            else:
                np.testing.assert_array_equal(np.asarray(a.top_logprobs), np.asarray(b.top_logprobs))


@pytest.mark.parametrize("kw", [dict(max_new_tokens=10, temperature=0.0, top_p=None),
                                dict(max_new_tokens=12, temperature=0.7, top_p=0.9)],
                         ids=["greedy", "sampled"])
def test_coalesced_identical_and_equal_jax(engines, kw):
    """Mixed fan-outs (n = 2, 3, 1), a shared-prefix admission: the paged
    batch byte-identical to dense, one paged launch (the plain attention on
    the CPU), and the tokens of the JAX engine's ``generate_many``."""
    dense, paged = engines
    before = xla_dispatches()
    rd = dense.generate_many(items(), top_logprobs=2, **kw)
    rp = paged.generate_many(items(), top_logprobs=2, **kw)
    assert_batches(rd, rp, top_logprobs=True)
    assert paged.last_launch_stats["kv_layout"] == "paged"
    assert xla_dispatches() == before + 1
    rj = shared_engine(model="tiny").generate_many(items(spec=JaxSpec), top_logprobs=2, **kw)
    assert_batches(rp, rj, top_logprobs=True, logprobs_atol=1e-5)


def test_prefix_cache_hit_identical(engines):
    """The second identical launch admits every prompt from the paged
    prefix cache: outputs do not move; only cache entries hold pages after."""
    dense, _ = engines
    cached = engine("paged", kv_pool_pages=256, prefix_cache_size=4)
    kw = dict(max_new_tokens=8, temperature=0.6, top_p=0.95)
    batch = [GenRequestSpec(PROMPT_A, 2, 31), GenRequestSpec(PROMPT_B, 2, 33)]
    rd = dense.generate_many(batch, **kw)
    rp1 = cached.generate_many(batch, **kw)
    assert cached._prefix_entries
    rp2 = cached.generate_many(batch, **kw)
    assert_batches(rd, rp1)
    assert_batches(rd, rp2)
    assert cached.prefix_cache_stats["hits"] >= 2
    cached._kv_pool.allocator.verify()


def test_streamed_tokens_match(engines):
    """The token tap sees the same (step, tokens) stream on both layouts."""
    streams = {}
    for name, eng in zip(("dense", "paged"), engines):
        got = []
        spec = GenRequestSpec(PROMPT_B, 2, 41,
                              token_sink=lambda s, t, got=got: got.append((int(s), np.array(t))))
        res = eng.generate_many([spec], max_new_tokens=6, temperature=0.5, top_p=0.9)
        assert not isinstance(res[0], Exception)
        streams[name] = dict(got)
        assert [s for s, _ in got] == sorted(streams[name])
    assert streams["dense"].keys() == streams["paged"].keys()
    for s in streams["dense"]:
        np.testing.assert_array_equal(streams["dense"][s], streams["paged"][s])


def test_config_knob_falls_back_dense(engines):
    """``paged_generate_many=False``: the backend's engine takes the dense
    body (the port's engine has one layout), the outputs stay identical,
    and no paged step dispatches."""
    dense, _ = engines
    backend = CudaBackend(config=BackendConfig(model="tiny", device="cpu", kv_page_size=PAGE,
                                               paged_generate_many=False))
    try:
        off = backend.engine
        off.params = port_params()
        assert off.kv_layout == "dense"
        kw = dict(max_new_tokens=8, temperature=0.0, top_p=None)
        before = xla_dispatches()
        assert_batches(dense.generate_many(items(51), **kw), off.generate_many(items(51), **kw))
        assert xla_dispatches() == before
    finally:
        backend.close()


def test_pool_exhausted_unwinds_and_falls_back(engines):
    """An 8-page pool holds the one-page prompts but not the 4 rows × 2
    generation pages the launch reserves: the paged attempt returns every
    page it took and the batch decodes dense, identical to a dense engine."""
    dense, _ = engines
    eng = engine("paged", kv_pool_pages=8)
    pool = eng._ensure_kv_pool()
    assert pool.allocator.total_pages == 8
    free0 = pool.allocator.free_pages
    batch = [GenRequestSpec(list(range(2, 8)), 2, 61), GenRequestSpec(list(range(3, 9)), 2, 63)]
    kw = dict(max_new_tokens=16, temperature=0.0, top_p=None)
    before = xla_dispatches()
    assert_batches(dense.generate_many(batch, **kw), eng.generate_many(batch, **kw))
    assert eng.last_launch_stats["kv_layout"] == "dense"
    assert xla_dispatches() == before
    assert pool.allocator.free_pages == free0
    pool.allocator.verify()


def test_exhausted_pool_leaves_the_paged_attn_drill_armed(engines):
    """The ``ops.paged_attn`` drill is evaluated once a launch's pages are
    held, where the JAX engine resolves its paged kernel: a launch the 8-page
    pool cannot hold decodes dense and consumes no firing, in either
    package. The next launch that holds its pages takes the firing (on the
    CPU the plain version, counted)."""
    from conftest import shared_params
    from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
    from k_llms_tpu.models import get_config
    from k_llms_tpu.reliability import failpoints as jfp
    from k_llms_tpu.utils.observability import KERNEL_EVENTS as JAX_KERNEL_EVENTS

    dense, paged = engines
    batch = [GenRequestSpec(list(range(2, 8)), 2, 61), GenRequestSpec(list(range(3, 9)), 2, 63)]
    kw = dict(max_new_tokens=16, temperature=0.0, top_p=None)
    want = dense.generate_many(batch, **kw)
    small = engine("paged", kv_pool_pages=8)
    cfg = get_config("tiny")
    jax_small = JaxEngine(cfg, params=shared_params(cfg), use_mesh=False, param_seed=0,
                          kv_layout="paged", kv_page_size=PAGE, kv_pool_pages=8,
                          prefix_cache_size=0)
    for eng in (small, jax_small):
        assert eng._ensure_kv_pool().allocator.total_pages == 8
    drill = {"ops.paged_attn": FailSpec(action="fallback", times=1)}
    fallbacks = "kernel.paged_attn_fallback.failpoint"

    before = KERNEL_EVENTS.snapshot()
    with fp.failpoints(drill):
        assert_batches(want, small.generate_many(batch, **kw))
        assert small.last_launch_stats["kv_layout"] == "dense"
        mid = KERNEL_EVENTS.snapshot()
        for name in (fallbacks, "kernel.paged_attn_xla_dispatch",
                     "kernel.paged_attn_cuda_dispatch"):  # no firing, no paged dispatch
            assert mid.get(name, 0) == before.get(name, 0), name
        assert_batches(want, paged.generate_many(batch, **kw))
        assert paged.last_launch_stats["kv_layout"] == "paged"
    after = KERNEL_EVENTS.snapshot()
    assert after.get(fallbacks, 0) == before.get(fallbacks, 0) + 1
    assert xla_dispatches() == before.get("kernel.paged_attn_xla_dispatch", 0) + 1

    jax_before = JAX_KERNEL_EVENTS.snapshot().get(fallbacks, 0)
    with jfp.failpoints({"ops.paged_attn": jfp.FailSpec(action="fallback", times=1)}):
        assert_batches(want, jax_small.generate_many(
            [JaxSpec(b.prompt_ids, b.n, b.seed) for b in batch], **kw), logprobs_atol=1e-5)
        assert JAX_KERNEL_EVENTS.snapshot().get(fallbacks, 0) == jax_before
        assert jfp.fire("ops.paged_attn") is not None  # the firing is still armed
        assert jfp.fire("ops.paged_attn") is None


# -- the batch path's prefix cache as page runs -------------------------------

SYSTEM = [(i * 37) % 200 + 5 for i in range(40)]
DOC_A = [(i * 11) % 190 + 7 for i in range(20)]
DOC_B = [(i * 13) % 180 + 9 for i in range(25)]


@pytest.fixture(scope="module")
def cached_engines():
    kw = dict(prefix_cache_size=4, prefix_cache_min_reuse=16)
    return engine("dense"), engine("dense", **kw), engine("paged", **kw)


def test_batch_exact_hit_serves_from_pages(cached_engines):
    plain, _, paged = cached_engines
    prompt, kw = SYSTEM + DOC_A, dict(n=2, max_new_tokens=4, temperature=0.7, seed=5)
    r1 = paged.generate(prompt, **kw)
    assert paged.prefix_cache_stats["misses"] == 1
    r2 = paged.generate(prompt, **kw)
    assert paged.prefix_cache_stats["hits"] == 1
    assert_identical(r1, r2)
    assert_identical(r1, plain.generate(prompt, **kw))
    assert_identical(r1, shared_engine(model="tiny").generate(prompt, **kw), logprobs_atol=1e-5)
    assert paged._kv_pool is not None and paged._kv_pool.allocator.in_use_pages > 0


def test_batch_continuation_shares_prefix_pages(cached_engines):
    """SYSTEM + DOC_B extends the cached system prefix: the paged entry
    shares the matched run's full pages and generates byte-identically to
    dense and uncached."""
    plain, dense, paged = cached_engines
    for eng in (dense, paged):
        eng.generate(SYSTEM + DOC_A, n=2, max_new_tokens=4, temperature=0.7, seed=7)
    kw = dict(n=2, max_new_tokens=4, temperature=0.7, seed=8)
    r_paged = paged.generate(SYSTEM + DOC_B, **kw)
    assert paged.prefix_cache_stats["partial_hits"] >= 1
    assert_identical(r_paged, dense.generate(SYSTEM + DOC_B, **kw))
    np.testing.assert_array_equal(r_paged.tokens, plain.generate(SYSTEM + DOC_B, **kw).tokens)
    assert paged._kv_pool.allocator.shared_pages > 0


def test_loop_rows_survive_lru_eviction_midflight(loops):
    """Twin of ``tests/test_paged_eviction.py``: loop rows decode from a
    cached prefix run while batch requests evict that entry mid-flight; the
    rows' pages stay live (the rows hold them) and the tokens equal the
    dense port loop's and the JAX loop's."""
    eng = engine("paged", prefix_cache_size=2, prefix_cache_min_reuse=8)
    loop = ContinuousDecodeLoop(eng, width=2, max_prompt=64, max_new=24)
    prompt = [(i * 17) % 140 + 5 for i in range(12)]
    churn = [[(i * 19) % 130 + 6 for i in range(16)], [(i * 23) % 120 + 7 for i in range(18)]]
    evicted = {"done": False}

    def sink(step, _toks):
        if step == 1 and not evicted["done"]:
            evicted["done"] = True
            for c in churn:  # two stores evict the loop request's entry
                eng.generate(c, n=1, max_new_tokens=2, temperature=0.0, seed=3)

    kw = dict(n=2, max_new=16, temperature=0.0, top_p=None, seed=4)
    try:
        got = loop.submit(prompt, token_sink=sink, **kw).result(timeout=180)
        assert evicted["done"] and tuple(prompt) not in eng._prefix_entries
        assert_identical(got, loops[0].submit(prompt, **kw).result(timeout=180))
        assert_identical(got, loops[2].submit(prompt, **kw).result(timeout=180),
                         logprobs_atol=1e-5)
        assert loop.drain(timeout=60)
        assert loop.stats["pages"]["loop_refs"] == 0
    finally:
        loop.stop()


# -- the page allocator -------------------------------------------------------


def _tables_equal(ours, theirs, ref, rows_ours, rows_theirs, rows_ref):
    ours.verify()
    theirs.verify()
    assert ours.free_pages == theirs.free_pages == len(ref.free)
    np.testing.assert_array_equal(ours._ref, theirs._ref)
    want = np.zeros(ours.total_pages, np.int64)
    want[TRASH_PAGE] = 1
    for p, c in ref.ref.items():
        want[p] = c
    np.testing.assert_array_equal(ours._ref, want)
    assert rows_ours == rows_theirs == rows_ref  # block tables page for page
    assert ours.snapshot() == theirs.snapshot()
    for table in rows_ours:
        pos = np.arange(len(table) * ours.page_size + 3)
        np.testing.assert_array_equal(flat_slots(table, pos, ours.page_size),
                                      jax_paging.flat_slots(table, pos, ours.page_size))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_under_random_schedule(seed):
    rng = random.Random(seed)
    ps = 4
    ours, theirs, ref = PageAllocator(48, ps), jax_paging.PageAllocator(48, ps), _RefAllocator(48)
    rows = ([], [], [])  # block tables: port, JAX, reference
    for _ in range(600):
        op = rng.random()
        if op < 0.40:  # admit: a fresh prompt run
            npages = pages_for(rng.randint(1, 20), ps)
            assert npages == jax_paging.pages_for(npages * ps, ps)
            try:
                got = ours.alloc(npages)
            except PagePoolExhausted:
                with pytest.raises(jax_paging.PagePoolExhausted):
                    theirs.alloc(npages)
                with pytest.raises(MemoryError):
                    ref.alloc(npages)
                continue
            for table, new in zip(rows, (got, theirs.alloc(npages), ref.alloc(npages))):
                table.append(list(new))
        elif op < 0.65 and rows[0]:  # fork: a new reader of a table
            i = rng.randrange(len(rows[0]))
            for alloc, table in zip((ours, theirs, ref), rows):
                alloc.incref(table[i])
                table.append(list(table[i]))
        elif op < 0.80 and rows[0]:  # copy-on-write of one shared page
            i = rng.randrange(len(rows[0]))
            j = rng.randrange(len(rows[0][i]))
            if ours.refcount(rows[0][i][j]) > 1:
                try:
                    new = ours.alloc(1)[0]
                except PagePoolExhausted:
                    continue
                for alloc, table, page in zip((ours, theirs, ref), rows,
                                              (new, theirs.alloc(1)[0], ref.alloc(1)[0])):
                    alloc.decref([table[i][j]])
                    table[i][j] = page
                ours.note_cow()
                theirs.note_cow()
        elif rows[0]:  # retire
            i = rng.randrange(len(rows[0]))
            for alloc, table in zip((ours, theirs, ref), rows):
                alloc.decref(table.pop(i))
        _tables_equal(ours, theirs, ref, *rows)
    while rows[0]:
        for alloc, table in zip((ours, theirs, ref), rows):
            alloc.decref(table.pop())
    _tables_equal(ours, theirs, ref, *rows)
    assert ours.free_pages == ours.total_pages - 1 and ours.snapshot()["in_use"] == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_misuse_raises_accounting_errors(pkg):
    mod = {"port": None, "jax": jax_paging}[pkg]
    alloc_cls, accounting, exhausted = (
        (PageAllocator, PageAccountingError, PagePoolExhausted) if mod is None
        else (mod.PageAllocator, mod.PageAccountingError, mod.PagePoolExhausted))
    alloc = alloc_cls(8, 4)
    pages = alloc.alloc(2)
    errors = []
    for call in (lambda: alloc.incref([TRASH_PAGE]), lambda: alloc.decref([5]),
                 lambda: (alloc.decref(pages), alloc.decref(pages))):
        with pytest.raises(accounting) as err:
            call()
        errors.append(str(err.value))
    with pytest.raises(exhausted):
        alloc.alloc(99)
    if pkg == "port":  # the messages are JAX's
        jax_alloc = jax_paging.PageAllocator(8, 4)
        jpages = jax_alloc.alloc(2)
        want = []
        for call in (lambda: jax_alloc.incref([TRASH_PAGE]), lambda: jax_alloc.decref([5]),
                     lambda: (jax_alloc.decref(jpages), jax_alloc.decref(jpages))):
            with pytest.raises(jax_paging.PageAccountingError) as err:
                call()
            want.append(str(err.value))
        assert errors == want


def test_leak_detection_via_verify():
    for alloc_cls, error in ((PageAllocator, PageAccountingError),
                             (jax_paging.PageAllocator, jax_paging.PageAccountingError)):
        alloc = alloc_cls(8, 4)
        alloc.verify()
        alloc.leak(2)
        with pytest.raises(error, match="leak"):
            alloc.verify()


def test_leak_env_syntax_parses():
    fp.configure_from_env("engine.pages=leak:3")
    try:
        spec = fp._registry["engine.pages"]
        assert spec.action == "leak" and spec.kill == 3
    finally:
        fp.clear()
