"""The port's prompt-prefix KV cache against the JAX engine's, on both KV
layouts: the twins of ``tests/test_prefix_cache.py`` and of
``tests/test_paged_eviction.py``'s evicted-pages case. Each case runs the
same calls on a JAX ``LocalEngine`` and on the port's, with the same weights
(tiny, fp32), and holds the tokens equal, the logprobs within 1e-5, and the
hit, partial-hit and miss counts and the entries kept equal; where the JAX
test compares against the uncached engine, so does its twin. On the paged
layout the page pool is also checked: sized once and never replaced while
entries hold its pages, LRU entries evicted for space, a launch the pool
cannot hold served by the dense body with the same tokens.

The windowed and softcapped continuations are here too. Not here yet: the
cache on a mesh (``test_prefix_cache_on_mesh``) waits for the mesh (ROADMAP
Queue 1 item 10).
"""

import jax
import numpy as np
import pytest

from conftest import shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.models.llama import params_from_numpy

SYSTEM = [int(x) for x in jax.random.randint(jax.random.key(0), (48,), 5, 200)]
DOC_A = [int(x) for x in jax.random.randint(jax.random.key(1), (20,), 5, 200)]
DOC_B = [int(x) for x in jax.random.randint(jax.random.key(2), (25,), 5, 200)]
PAGE = 16
LAYOUTS = ["dense", "paged"]


def _pair(layout, overrides=None, **kw):
    """(JAX engine, port engine, uncached port engine) on the same tiny fp32
    weights, the cached two with prefix_cache_size=4, min_reuse=16."""
    overrides = overrides or {}
    jcfg = jax_get_config("tiny").with_(**overrides)
    pcfg = get_config("tiny").with_(**overrides)
    jparams = shared_params(jcfg, 3)
    params = params_from_numpy(jax.device_get(jparams), pcfg)
    cache_kw = dict(prefix_cache_size=4, prefix_cache_min_reuse=16)
    cache_kw.update(kw)
    jax_eng = JaxEngine(jcfg, params=jparams, use_mesh=False, kv_layout=layout,
                        kv_page_size=PAGE, **cache_kw)
    port = LocalEngine(pcfg, params=params, device="cpu", kv_layout=layout, kv_page_size=PAGE,
                       **cache_kw)
    plain = LocalEngine(pcfg, params=params, device="cpu", kv_layout=layout, kv_page_size=PAGE)
    return jax_eng, port, plain


def _same(got, want, lp_atol=1e-5):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=0, atol=lp_atol)
    assert got.finish_reasons == want.finish_reasons


def _both(jax_eng, port, prompt, n, seed, **kw):
    """One request on both engines; the port's result, checked against JAX."""
    want = jax_eng.generate(prompt, n=n, seed=seed, **kw)
    got = port.generate(prompt, n=n, seed=seed, **kw)
    _same(got, want)
    return got


def _stats_equal(jax_eng, port):
    assert port.prefix_cache_stats == jax_eng.prefix_cache_stats
    assert len(port._prefix_entries) == len(jax_eng._prefix_entries)
    assert list(port._prefix_entries) == list(jax_eng._prefix_entries)
    if port._kv_pool is not None:
        port._kv_pool.allocator.verify()


class _Counter:
    """Counts full and continuation prefills on a port engine."""

    def __init__(self, engine, monkeypatch):
        import k_llms_tpu_torch.engine.engine as eng_mod

        self.full = self.cont = 0
        full, cont = engine._prefill_full, eng_mod.prefill_continue

        def count_full(*a, **k):
            self.full += 1
            return full(*a, **k)

        def count_cont(*a, **k):
            self.cont += 1
            return cont(*a, **k)

        monkeypatch.setattr(engine, "_prefill_full", count_full)
        monkeypatch.setattr(eng_mod, "prefill_continue", count_cont)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_exact_hit_skips_device_prefill(layout, monkeypatch):
    jax_eng, port, plain = _pair(layout)
    prompt = SYSTEM + DOC_A
    counter = _Counter(port, monkeypatch)
    r1 = _both(jax_eng, port, prompt, 2, 5, max_new_tokens=4, temperature=0.7)
    assert port.prefix_cache_stats == {"hits": 0, "partial_hits": 0, "misses": 1}
    r2 = _both(jax_eng, port, prompt, 2, 5, max_new_tokens=4, temperature=0.7)
    assert port.prefix_cache_stats["hits"] == 1
    assert (counter.full, counter.cont) == (1, 0)  # the hit ran no prefill
    _same(r2, r1, lp_atol=0.0)
    _same(r1, plain.generate(prompt, n=2, seed=5, max_new_tokens=4, temperature=0.7))
    _stats_equal(jax_eng, port)


@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_shared_system_prefix_continuation_matches_dense(layout, attention_impl, monkeypatch):
    """The second document reuses the first prompt's system-prefix KV and
    prefills only its suffix (under "flash", the flash kernel's plain
    version in its q_offset mode); it matches the uncached engine and the
    JAX engine."""
    jax_eng, port, plain = _pair(layout, {"attention_impl": attention_impl})
    counter = _Counter(port, monkeypatch)
    _both(jax_eng, port, SYSTEM + DOC_A, 2, 7, max_new_tokens=4, temperature=0.7)
    got = _both(jax_eng, port, SYSTEM + DOC_B, 2, 8, max_new_tokens=4, temperature=0.7)
    assert port.prefix_cache_stats["partial_hits"] == 1
    assert (counter.full, counter.cont) == (1, 1)
    _same(got, plain.generate(SYSTEM + DOC_B, n=2, seed=8, max_new_tokens=4, temperature=0.7))
    _stats_equal(jax_eng, port)
    if layout == "paged":
        # The second entry shares the first's full pages below the common
        # prefix (48 tokens: three pages of 16) instead of copying them.
        (_, a, _, _), (_, b, _, _) = port._prefix_entries.values()
        assert a.pages[:3] == b.pages[:3] and a.pages[3:] != b.pages[3:]
        assert all(port._kv_pool.allocator.refcount(p) == 2 for p in a.pages[:3])


@pytest.mark.parametrize("overrides", [
    dict(sliding_window=16, sliding_window_layers="all"),
    dict(sliding_window=16, sliding_window_layers="alternating"),
    dict(attn_softcap=50.0, query_scale=0.125),
    dict(attention_impl="flash", sliding_window=16, sliding_window_layers="all"),
    dict(attention_impl="flash", sliding_window=16, sliding_window_layers="alternating"),
    dict(attention_impl="flash", attn_softcap=50.0, query_scale=0.125),
], ids=["window-all", "window-alternating", "softcap", "flash-window-all",
        "flash-window-alternating", "flash-softcap"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_continuation_matches_dense_on_windowed_and_softcap_configs(layout, overrides,
                                                                    monkeypatch):
    """The continuation's masks are built over absolute positions, so a
    window (past the 48-token shared prefix: 16 keys) and a softcap give
    the uncached engine's tokens and the JAX engine's."""
    jax_eng, port, plain = _pair(layout, overrides)
    counter = _Counter(port, monkeypatch)
    _both(jax_eng, port, SYSTEM + DOC_A, 2, 21, max_new_tokens=3, temperature=0.7)
    got = _both(jax_eng, port, SYSTEM + DOC_B, 2, 22, max_new_tokens=3, temperature=0.7)
    assert port.prefix_cache_stats["partial_hits"] == 1
    assert (counter.full, counter.cont) == (1, 1)
    _same(got, plain.generate(SYSTEM + DOC_B, n=2, seed=22, max_new_tokens=3, temperature=0.7))
    _stats_equal(jax_eng, port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_below_reuse_threshold_takes_full_prefill(layout):
    jax_eng, port, _ = _pair(layout)
    _both(jax_eng, port, SYSTEM + DOC_A, 1, 1, max_new_tokens=2, temperature=0.5)
    # Only 8 common tokens (< min_reuse 16): full prefill, counted as a miss.
    _both(jax_eng, port, SYSTEM[:8] + DOC_B, 1, 1, max_new_tokens=2, temperature=0.5)
    assert port.prefix_cache_stats == {"hits": 0, "partial_hits": 0, "misses": 2}
    _stats_equal(jax_eng, port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_growing_chain_hit_accounting(layout):
    """A growing prompt chain costs one miss then partial hits only; exact
    repeats of the longest prompt are full hits."""
    jax_eng, port, _ = _pair(layout)
    base = SYSTEM + DOC_A
    chain = [base, base + DOC_B, base + DOC_B + DOC_A]
    for p in chain:
        _both(jax_eng, port, p, 1, 1, max_new_tokens=2, temperature=0.0)
    assert port.prefix_cache_stats == {"hits": 0, "partial_hits": 2, "misses": 1}
    for _ in range(2):
        _both(jax_eng, port, chain[-1], 1, 1, max_new_tokens=2, temperature=0.0)
    assert port.prefix_cache_stats == {"hits": 2, "partial_hits": 2, "misses": 1}
    _stats_equal(jax_eng, port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lru_eviction_caps_entries(layout):
    jax_eng, port, _ = _pair(layout)
    jax_eng.prefix_cache_size = port.prefix_cache_size = 2
    for s in range(4):
        prompt = [100 + s] * 40  # four disjoint prompts
        _both(jax_eng, port, prompt, 1, s, max_new_tokens=2, temperature=0.5)
    assert len(port._prefix_entries) == 2
    _stats_equal(jax_eng, port)
    if layout == "paged":
        # The two dropped entries' pages went back: only the kept runs
        # (40 tokens: three pages each) hold pages after the launches.
        assert port._kv_pool.allocator.snapshot()["in_use"] == 6


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prompt_that_is_prefix_of_cached_prompt(layout):
    """A prompt contained in a cached one still gets a correct continuation
    (the common length is capped so at least one suffix token remains)."""
    jax_eng, port, plain = _pair(layout)
    _both(jax_eng, port, SYSTEM + DOC_A, 1, 9, max_new_tokens=3, temperature=0.6)
    short = SYSTEM + DOC_A[:5]
    got = _both(jax_eng, port, short, 1, 10, max_new_tokens=3, temperature=0.6)
    assert port.prefix_cache_stats["partial_hits"] == 1
    _same(got, plain.generate(short, n=1, seed=10, max_new_tokens=3, temperature=0.6))
    _stats_equal(jax_eng, port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_oversized_continuation_falls_back_to_full_prefill(layout):
    jax_eng, port, _ = _pair(layout)
    jax_eng.MAX_CONT_SCORE_BYTES = port.MAX_CONT_SCORE_BYTES = 1
    _both(jax_eng, port, SYSTEM + DOC_A, 1, 50, max_new_tokens=2, temperature=0.5)
    _both(jax_eng, port, SYSTEM + DOC_B, 1, 51, max_new_tokens=2, temperature=0.5)
    assert port.prefix_cache_stats == {"hits": 0, "partial_hits": 0, "misses": 2}
    _stats_equal(jax_eng, port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_flash_continuation_ignores_score_cap(layout):
    jax_eng, port, plain = _pair(layout, {"attention_impl": "flash"})
    jax_eng.MAX_CONT_SCORE_BYTES = port.MAX_CONT_SCORE_BYTES = 1
    _both(jax_eng, port, SYSTEM + DOC_A, 1, 50, max_new_tokens=3, temperature=0.6)
    got = _both(jax_eng, port, SYSTEM + DOC_B, 1, 51, max_new_tokens=3, temperature=0.6)
    assert port.prefix_cache_stats["partial_hits"] == 1
    _same(got, plain.generate(SYSTEM + DOC_B, n=1, seed=51, max_new_tokens=3, temperature=0.6))
    _stats_equal(jax_eng, port)


def test_backend_config_plumbs_prefix_cache():
    client = KLLMs(backend="cuda", model="tiny", device="cpu", prefix_cache_size=3,
                   prefix_cache_min_reuse=8, kv_pool_pages=200)
    engine = client.backend.engine
    assert engine.prefix_cache_size == 3 and engine.prefix_cache_min_reuse == 8
    assert engine.kv_pool_pages == 200
    messages = [{"role": "user", "content": "Extract the invoice total, please."}]
    for _ in range(2):
        client.chat.completions.create(messages=messages, n=2, temperature=0.0, max_tokens=4)
    assert engine.prefix_cache_stats == {"hits": 1, "partial_hits": 0, "misses": 1}
    # An explicit kv_pool_pages wins over the cache's own sizing (four
    # 2048-token runs of 64-token pages: 128).
    assert engine._kv_pool.allocator.total_pages == 200


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generate_many_uses_prefix_cache(layout):
    """Coalesced batches consult and populate the cache per request."""
    jax_eng, port, plain = _pair(layout)
    _both(jax_eng, port, SYSTEM + DOC_A, 2, 40, max_new_tokens=3, temperature=0.6)
    items = [(SYSTEM + DOC_A, 2, 41), (SYSTEM + DOC_B, 2, 42)]
    kw = dict(max_new_tokens=3, temperature=0.6)
    want = jax_eng.generate_many([JaxSpec(p, n, s) for p, n, s in items], **kw)
    got = port.generate_many([GenRequestSpec(p, n, s) for p, n, s in items], **kw)
    assert port.prefix_cache_stats["hits"] == 1  # exact reuse of DOC_A's KV
    assert port.prefix_cache_stats["partial_hits"] == 1  # DOC_B's continuation
    for g, w, (p, n, s) in zip(got, want, items):
        _same(g, w)
        _same(g, plain.generate(p, n=n, seed=s, **kw))
    _stats_equal(jax_eng, port)


def test_evicted_entry_pages_survive_until_reader_retires():
    """Pin an entry's run as an in-flight reader does, evict every entry:
    the pages stay owned (and gather the same values) until the pin drops,
    then return to the free stack."""
    _, eng, _ = _pair("paged", prefix_cache_size=2, prefix_cache_min_reuse=8)
    eng.generate([(i * 31) % 150 + 3 for i in range(20)], n=1, max_new_tokens=2,
                 temperature=0.0, seed=1)
    alloc = eng._kv_pool.allocator
    with eng._launch_lock:
        (entry,) = eng._prefix_entries.values()
        run = entry[1]
        pages = list(run.pages)
        before = run.materialize()
        run.retain()  # the in-flight reader's pin
    try:
        with eng._launch_lock:
            eng._evict_paged_entries(10**9)
        assert not eng._prefix_entries
        assert all(alloc.refcount(p) == 1 for p in pages)
        after = run.materialize()
        assert (before.k[:, :, :20] == after.k[:, :, :20]).all()
        assert (before.v[:, :, :20] == after.v[:, :, :20]).all()
    finally:
        alloc.decref(pages)  # the reader retires: now the pages free
    assert all(alloc.refcount(p) == 0 for p in pages)
    alloc.verify()
    assert alloc.snapshot()["in_use"] == 0


# Two-request launches: the JAX engine takes its paged body only for a
# coalesced batch (a single request decodes dense there), so a pool small
# enough to matter is compared on launches of two.
def _launches():
    docs = [SYSTEM + DOC_A, SYSTEM + DOC_B, [7] * 30 + DOC_A, [9] * 33 + DOC_B,
            SYSTEM + DOC_B + DOC_A]
    return [[(docs[0], 2, 1), (docs[1], 2, 2)], [(docs[2], 2, 3), (docs[3], 2, 4)],
            [(docs[4], 2, 5), (docs[0], 2, 6)], [(docs[1], 2, 7), (docs[3], 2, 8)]]


@pytest.mark.parametrize("cache_size,max_news,layouts", [
    (3, (6, 80, 80, 80), ["paged"] * 4),
    (1, (6, 40, 40, 40), ["paged", "dense", "dense", "dense"]),
])
def test_small_pool_evicts_for_space_then_falls_back_dense(cache_size, max_news, layouts):
    """The pool is sized once, from the cache size and the first (short)
    launch: with three entries the longer launches after it fit only by
    evicting LRU entries for space; with one entry (a 16-page pool) they do
    not fit at all, and each falls back to the dense body after the paged
    attempt releases every page it took. Either way the tokens, the hit,
    partial-hit and miss counts and the entries kept equal the JAX engine's
    on the same pool, and the pool stays the one built first. (max_seq_len
    128 keeps the pool small: a cache entry is sized as one such run.)"""
    jax_eng, port, plain = _pair("paged", {"max_seq_len": 128}, prefix_cache_size=cache_size)
    freed = []
    evict = port._evict_paged_entries

    def counted_evict(need_pages):
        freed.append(evict(need_pages))
        return freed[-1]

    port._evict_paged_entries = counted_evict
    pool, got_layouts = None, []
    for launch, max_new in zip(_launches(), max_news):
        kw = dict(max_new_tokens=max_new, temperature=0.7)
        want = jax_eng.generate_many([JaxSpec(p, n, s) for p, n, s in launch], **kw)
        got = port.generate_many([GenRequestSpec(p, n, s) for p, n, s in launch], **kw)
        got_layouts.append(port.last_launch_stats["kv_layout"])
        for g, w, (p, n, s) in zip(got, want, launch):
            _same(g, w)
            _same(g, plain.generate(p, n=n, seed=s, **kw))
        pool = pool or port._kv_pool
        assert port._kv_pool is pool
        _stats_equal(jax_eng, port)
    assert got_layouts == layouts
    if layouts[-1] == "paged":
        assert sum(freed) > 0  # entries were evicted for space
    else:
        assert pool.allocator.total_pages == 16


def test_pool_lifetime_without_a_cache_equals_jax():
    """With no prefix cache and no kv_pool_pages both engines size the page
    pool at their first paged launch and keep it for their lifetime: a
    later launch the pool cannot hold decodes dense, launch for launch
    where the JAX engine's does (its paged launches read off its
    paged-attention dispatch count). The tokens are the same."""
    from k_llms_tpu.utils.observability import KERNEL_EVENTS as JAX_KERNEL_EVENTS

    jax_eng, port, _ = _pair("paged", prefix_cache_size=0)
    kw = dict(temperature=0.7)
    pool, layouts = None, []
    for launch, max_new in zip(_launches(), (4, 40, 80, 8)):
        dispatches = JAX_KERNEL_EVENTS.get("kernel.paged_attn_xla_dispatch")
        want = jax_eng.generate_many([JaxSpec(p, n, s) for p, n, s in launch],
                                     max_new_tokens=max_new, **kw)
        paged = JAX_KERNEL_EVENTS.get("kernel.paged_attn_xla_dispatch") > dispatches
        got = port.generate_many([GenRequestSpec(p, n, s) for p, n, s in launch],
                                 max_new_tokens=max_new, **kw)
        for g, w in zip(got, want):
            _same(g, w)
        layouts.append(port.last_launch_stats["kv_layout"])
        assert layouts[-1] == ("paged" if paged else "dense")
        pool = pool or port._kv_pool
        assert port._kv_pool is pool
        pool.allocator.verify()
        assert pool.allocator.snapshot()["in_use"] == 0
    assert layouts[0] == "paged" and "dense" in layouts
    assert pool.allocator.total_pages == jax_eng._kv_pool.allocator.total_pages
    assert port.prefix_cache_stats == jax_eng.prefix_cache_stats == {
        "hits": 0, "partial_hits": 0, "misses": 0}


def test_prefix_cached_len_probe():
    _, port, _ = _pair("paged")
    port.generate(SYSTEM + DOC_A, n=1, max_new_tokens=2, temperature=0.0, seed=1)
    stats = dict(port.prefix_cache_stats)
    assert port.prefix_cached_len(SYSTEM + DOC_A) == len(SYSTEM + DOC_A)
    assert port.prefix_cached_len(SYSTEM + DOC_B) == len(SYSTEM)
    assert port.prefix_cached_len(SYSTEM[:8] + DOC_B) == 0
    assert port.prefix_cache_stats == stats  # a pure probe


def test_pool_page_movers_equal_jax():
    """copy_pages (the copy-on-write mover), a run's materialization and its
    padded continuation seed equal the JAX pool's on the same contents."""
    import jax.numpy as jnp
    import torch

    from k_llms_tpu.engine.paging import PagedKVPool as JaxPool
    from k_llms_tpu.engine.paging import PagedPrefixRun as JaxRun
    from k_llms_tpu.models.llama import KVCache as JaxKV
    from k_llms_tpu_torch.engine.paging import PagedKVPool, PagedPrefixRun

    cfg_j, cfg_p = jax_get_config("tiny"), get_config("tiny")
    rng = np.random.default_rng(0)
    shape = (cfg_p.num_layers, 12 * 4, cfg_p.num_kv_heads, cfg_p.head_dim)
    k0, v0 = rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32)
    jpool, pool = JaxPool(cfg_j, 12, 4), PagedKVPool(cfg_p, 12, 4, "cpu")
    jpool.kv = JaxKV(k=jnp.asarray(k0), v=jnp.asarray(v0))
    pool.k.copy_(torch.from_numpy(k0))
    pool.v.copy_(torch.from_numpy(v0))
    jpool.copy_pages([3, 5], [7, 2])
    pool.copy_pages([3, 5], [7, 2])
    np.testing.assert_array_equal(pool.k.numpy(), np.asarray(jpool.kv.k))
    np.testing.assert_array_equal(pool.v.numpy(), np.asarray(jpool.kv.v))
    pages = [4, 9, 1]
    jrun, run = JaxRun(jpool, pages, 10, 16), PagedPrefixRun(pool, pages, 10, 16)
    for got, want in ((run.materialize(), jrun.materialize()),
                      (run.gather_prefix_padded(7, 20), jrun.gather_prefix_padded(7, 20))):
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


@pytest.mark.parametrize("cache_size", [2, 0])
def test_store_of_an_already_scattered_run(cache_size):
    """_prefix_store_paged_run takes an already-scattered page run as an
    entry (the cache then serves the prompt as an exact hit with the
    uncached engine's tokens) or, with the cache off, releases it."""
    _, port, plain = _pair("paged", prefix_cache_size=cache_size)
    ids = SYSTEM + DOC_A
    ids_, plen, bucket = port._prep_prompt(ids)
    port._ensure_kv_pool()
    first_logits, prefix = port._prefill_full(ids_, plen, bucket)
    run = port._run_from_dense(prefix, plen, bucket)
    port._prefix_store_paged_run(ids, first_logits, run)
    alloc = port._kv_pool.allocator
    assert alloc.snapshot()["in_use"] == (len(run.pages) if cache_size else 0)
    got = port.generate(ids, n=2, seed=3, max_new_tokens=4, temperature=0.7)
    _same(got, plain.generate(ids, n=2, seed=3, max_new_tokens=4, temperature=0.7))
    hits = port.prefix_cache_stats["hits"]
    assert hits == (1 if cache_size else 0)
    alloc.verify()
