"""The port's Llama model and paged engine held against the JAX package on
the same carried-over weights (``params_from_numpy`` of the JAX tree), tiny
config in f32.

Model level: ``prefill`` then 8 paged decode steps, logits within atol 1e-5
and greedy tokens equal, for the reference attention ("xla") and the kernel
route ("cuda", which on CPU tensors runs the kernels' plain versions).
Engine level: greedy tokens of ``generate_many`` equal to the JAX
``LocalEngine(use_mesh=False, kv_layout="paged")`` on a coalesced batch (the
solo path with stop sequences is held through the client in
test_torch_client.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config

ATOL = 1e-5
CONFIG_NAME = "tiny"
PS = 8


@pytest.fixture(scope="module")
def weights():
    jax_params = shared_params(jax_get_config(CONFIG_NAME), 0)
    return jax_params, llama.params_from_numpy(jax.device_get(jax_params), get_config(CONFIG_NAME))


def _pool_layout(plen, bucket, B, G, ps):
    """Prompt pages 1.., then ps-aligned fresh gen pages per row; positions
    past the prompt point into the trash page 0."""
    npp = -(-plen // ps)
    prefix_idx = np.array(
        [[(1 + p // ps) * ps + p % ps if p < plen else p % ps for p in range(bucket)]], np.int32
    )
    ngp = -(-G // ps)
    gen_idx = np.array(
        [[(1 + npp + b * ngp + g // ps) * ps + g % ps for g in range(G)] for b in range(B)], np.int32
    )
    return prefix_idx, gen_idx, 1 + npp + B * ngp


PROMPT = [256] + list(b"<user>\nname two colours") + [257] + list(b"<assistant>\n")
BUCKET, ROWS, GEN, STEPS = 64, 2, 16, 8


@pytest.fixture(scope="module")
def jax_reference(weights):
    """The JAX prefill and 8 greedy paged decode steps (the reference
    attention), with the page layout both packages use."""
    jax_params, _ = weights
    jcfg = jax_get_config(CONFIG_NAME)
    plen = len(PROMPT)
    tokens = np.array([PROMPT + [jcfg.pad_token_id] * (BUCKET - plen)], np.int32)
    jl, jcache = jax.jit(partial(jax_llama.prefill, jcfg))(jax_params, jnp.asarray(tokens), jnp.int32(plen))
    prefix_idx, gen_idx, npages = _pool_layout(plen, BUCKET, ROWS, GEN, PS)
    shape = (jcfg.num_layers, npages * PS, jcfg.num_kv_heads, jcfg.head_dim)
    jk = np.zeros(shape, np.float32)
    jv = np.zeros(shape, np.float32)
    jk[:, prefix_idx[0, :plen]] = np.asarray(jcache.k)[:, 0, :plen]
    jv[:, prefix_idx[0, :plen]] = np.asarray(jcache.v)[:, 0, :plen]
    jstep = jax.jit(partial(jax_llama.paged_verify_step, jcfg, attn_impl="xla"))
    jtok = np.repeat(np.asarray(jl).argmax(-1), ROWS).astype(np.int32)
    step_logits = []
    for step in range(STEPS):
        jlog, jkc, jvc = jstep(
            jax_params, jnp.asarray(jtok)[:, None], jnp.full((ROWS,), step, jnp.int32),
            jnp.asarray([plen], jnp.int32), jax_llama.KVCache(k=jnp.asarray(jk), v=jnp.asarray(jv)),
            jnp.asarray(prefix_idx), jnp.asarray(gen_idx),
        )
        jk[:, gen_idx[:, step]] = np.asarray(jkc)
        jv[:, gen_idx[:, step]] = np.asarray(jvc)
        step_logits.append(np.asarray(jlog))
        jtok = np.asarray(jlog)[:, 0].argmax(-1).astype(np.int32)
    return tokens, np.asarray(jl), np.asarray(jcache.k), step_logits, prefix_idx, gen_idx, shape


@pytest.mark.parametrize("impl", ["xla", "cuda"])
def test_prefill_and_paged_decode_match_jax(weights, jax_reference, impl):
    _, params = weights
    tokens, jl, jk_cache, jax_steps, prefix_idx, gen_idx, shape = jax_reference
    cfg = get_config(CONFIG_NAME)
    plen = len(PROMPT)
    tl, (tk, tv) = llama.prefill(cfg, params, torch.from_numpy(tokens), plen)
    np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy()[:, :, :plen], jk_cache[:, :, :plen], atol=ATOL, rtol=0)

    pk = torch.zeros(shape)
    pv = torch.zeros(shape)
    prompt_slots = torch.from_numpy(prefix_idx[0, :plen]).long()
    pk[:, prompt_slots] = tk[:, 0, :plen]
    pv[:, prompt_slots] = tv[:, 0, :plen]
    ttok = tl.argmax(-1).repeat(ROWS)
    assert ttok.tolist() == [int(jl.argmax())] * ROWS
    for step, jlog in enumerate(jax_steps):
        tlog, tkc, tvc = llama.paged_verify_step(
            cfg, params, ttok[:, None], torch.full((ROWS,), step), torch.tensor([plen]),
            pk, pv, torch.from_numpy(prefix_idx), torch.from_numpy(gen_idx),
            attn_impl=impl, page_size=PS,
        )
        np.testing.assert_allclose(tlog.numpy(), jlog, atol=ATOL, rtol=0)
        slots = torch.from_numpy(gen_idx[:, step]).long()
        pk[:, slots] = tkc
        pv[:, slots] = tvc
        ttok = tlog[:, 0].argmax(-1)
        assert (ttok.numpy() == jlog[:, 0].argmax(-1)).all()


def _engines(weights, impl="auto"):
    _, params = weights
    jeng = shared_engine(CONFIG_NAME, kv_layout="paged")
    teng = LocalEngine(CONFIG_NAME, params=params, device="cpu", kv_page_size=PS,
                       paged_attention_impl=impl)
    return jeng, teng


COALESCED = [[256] + list(b"alpha beta gamma"), [256] + list(b"one two three four five six seven")]


@pytest.fixture(scope="module")
def jax_coalesced(weights):
    jeng, _ = _engines(weights)
    return jeng.generate_many(
        [JaxSpec(COALESCED[0], 3, 7), JaxSpec(COALESCED[1], 2, 9)],
        max_new_tokens=12, temperature=0.0,
    )


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_generate_many_greedy_matches_jax_engine(weights, jax_coalesced, impl):
    """Two coalesced requests (JAX: the paged coalesced path) with different
    n and prompt lengths: tokens equal, logprobs within 1e-5."""
    _, teng = _engines(weights, impl)
    prompts = COALESCED
    kw = dict(max_new_tokens=12, temperature=0.0)
    jres = jax_coalesced
    tres = teng.generate_many([GenRequestSpec(prompts[0], 3, 7), GenRequestSpec(prompts[1], 2, 9)], **kw)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(t.lengths, j.lengths)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=ATOL, rtol=0)
        assert t.finish_reasons == j.finish_reasons and t.prompt_len == j.prompt_len


def test_quarantine_of_non_finite_rows(weights):
    """A row whose logits go non-finite freezes, is padded out, and carries a
    numeric_poison sample error; its batch peers are untouched."""
    _, teng = _engines(weights)
    teng = LocalEngine(CONFIG_NAME, params={**teng.params, "lm_head": teng.params["lm_head"].clone()},
                       device="cpu", kv_page_size=PS)
    clean = teng.generate([256, 65, 66], n=2, seed=0, max_new_tokens=6, temperature=0.0)
    teng.params["lm_head"][:, 5] = float("nan")
    bad = teng.generate([256, 65, 66], n=2, seed=0, max_new_tokens=6, temperature=0.0)
    assert bad.sample_errors is not None
    assert all(e["code"] == "numeric_poison" for e in bad.sample_errors)
    assert (bad.lengths == 0).all() and clean.sample_errors is None
    assert teng.quarantine_stats["samples"] == 2


def test_embed_tokens_matches_jax_engine(weights):
    jeng, teng = _engines(weights)
    lists = [[256, 72, 105], list(b"a longer sentence for pooling")]
    np.testing.assert_allclose(teng.embed_tokens(lists), jeng.embed_tokens(lists), atol=ATOL, rtol=0)


def test_kernel_route_prefill_matches_reference_route(weights):
    """attention_impl="flash" (the flash wrapper, plain version on CPU)
    against the reference attention path on the same weights."""
    _, params = weights
    cfg = get_config(CONFIG_NAME)
    tokens = torch.tensor([[256] + list(b"hello flash") + [cfg.pad_token_id] * 20])
    ref, (rk, _) = llama.prefill(cfg, params, tokens, 12)
    out, (ok, _) = llama.prefill(cfg.with_(attention_impl="flash"), params, tokens, 12)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(ok[:, :, :12], rk[:, :, :12], atol=ATOL, rtol=0)


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError):
        llama.check_supported(get_config("gemma-2-2b"))
    with pytest.raises(NotImplementedError):
        llama.check_supported(get_config("mixtral-8x7b"))
    llama.check_supported(get_config("llama-3-8b"))
    llama.check_supported(get_config("qwen2-7b"))


def test_page_pool_scatter_gather_and_accounting():
    """The torch pool round-trips KV through flat slots; the copied
    allocator keeps its conservation laws through a launch's alloc/free."""
    from k_llms_tpu_torch.engine.paging import PageAllocator, PagedKVPool, PagePoolExhausted, flat_slots

    cfg = get_config(CONFIG_NAME)
    pool = PagedKVPool(cfg, total_pages=6, page_size=PS, device="cpu")
    pages = pool.allocator.alloc(2)
    slots = flat_slots(pages, np.arange(11), PS)
    k = torch.randn(cfg.num_layers, 11, cfg.num_kv_heads, cfg.head_dim)
    pool.scatter_tokens(k, -k, slots)
    gk, gv = pool.gather_tokens(slots)
    assert torch.equal(gk[:, 0], k) and torch.equal(gv[:, 0], -k)
    assert pool.pool_bytes() == 2 * k.element_size() * pool.k.numel()
    alloc = PageAllocator(4, PS)
    with pytest.raises(PagePoolExhausted):
        alloc.alloc(4)  # page 0 is the trash page
    got = alloc.alloc(3)
    alloc.incref(got[:1])
    assert alloc.decref(got) == got[1:]
    alloc.decref(got[:1])
    alloc.verify()
