"""Shared checks of the model-family twins (``test_torch_gemma.py``,
``test_torch_model_families.py``, ``test_torch_moe.py``): the port's model
functions and engine held against the JAX package's on the same weights.

Weights come from the JAX ``init_params`` (``conftest.shared_params``),
carried over by ``params_from_numpy``; the configs are tiny and in fp32.
Every check compares logits (and the KV a function writes) within the
parity harness's 1e-5 and greedy tokens exactly. The JAX side runs its
reference attention (``attention_impl="xla"``); the port runs either that
or its flash route (K2's plain version on CPU tensors), which computes the
same function.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config

ATOL = 1e-5
PS = 8  # page size of the paged checks


class Family:
    """One tiny config in both packages, with its weights in both."""

    def __init__(self, overrides, seed=0):
        self.overrides = dict(overrides)
        self.jcfg = jax_get_config("tiny").with_(**overrides)
        self.cfg = get_config("tiny").with_(**overrides)
        self.jparams = shared_params(self.jcfg, seed)
        self.params = llama.params_from_numpy(jax.device_get(self.jparams), self.cfg)

    def port_cfg(self, impl):
        return self.cfg.with_(attention_impl=impl)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _kv(cache):
    return jax_llama.KVCache(k=jnp.asarray(cache[0]), v=jnp.asarray(cache[1]))


def prompt_tokens(S, plen, vocab, seed=0):
    """[1, S] tokens, the first ``plen`` real and the rest pad."""
    rng = np.random.default_rng(seed)
    tokens = np.full((1, S), 258, np.int32)
    tokens[0, :plen] = rng.integers(3, vocab - 4, plen)
    return tokens


def check_forward(fam, impl):
    """forward over two rows, one right-padded: logits and hidden states."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, fam.cfg.vocab_size, size=(2, 24)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 19:] = 0
    want, want_h = jax_llama.forward(fam.jcfg, fam.jparams, jnp.asarray(tokens), jnp.asarray(mask))
    got, got_h = llama.forward(fam.port_cfg(impl), fam.params, torch.from_numpy(tokens),
                               torch.from_numpy(mask))
    _close(got.numpy(), want)
    _close(got_h.numpy(), want_h)
    return got


def check_prefill_and_dense_decode(fam, impl, plen=20, S=32, n=2, steps=6):
    """prefill, then ``steps`` greedy dense decode steps of ``n`` rows:
    logits, the prefix KV and the generated KV each step."""
    tokens = prompt_tokens(S, plen, fam.cfg.vocab_size)
    jl, jcache = jax.jit(partial(jax_llama.prefill, fam.jcfg))(
        fam.jparams, jnp.asarray(tokens), jnp.int32(plen))
    tl, (tk, tv) = llama.prefill(fam.port_cfg(impl), fam.params, torch.from_numpy(tokens), plen)
    _close(tl.numpy(), jl)
    _close(tk.numpy()[:, :, :plen], np.asarray(jcache.k)[:, :, :plen])
    _close(tv.numpy()[:, :, :plen], np.asarray(jcache.v)[:, :, :plen])

    jstep = jax.jit(partial(jax_llama.decode_step, fam.jcfg))
    jgen = jax_llama.init_cache(fam.jcfg, n, steps)
    tgen = llama.init_cache(fam.cfg, n, steps, "cpu")
    prefix = llama.KVCache(k=tk, v=tv)
    tok = np.repeat(np.asarray(jl).argmax(-1), n).astype(np.int32)
    for step in range(steps):
        jlog, jgen = jstep(fam.jparams, jnp.asarray(tok), jnp.int32(step),
                           jnp.asarray([plen], jnp.int32), jgen, jcache)
        tlog, tgen = llama.decode_step(fam.port_cfg(impl), fam.params, torch.from_numpy(tok),
                                       step, torch.tensor([plen]), tgen, prefix)
        _close(tlog.numpy(), jlog)
        _close(tgen.k.numpy()[:, :, : step + 1], np.asarray(jgen.k)[:, :, : step + 1])
        assert (tlog.numpy().argmax(-1) == np.asarray(jlog).argmax(-1)).all()
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    return tlog


def _pool_layout(plen, bucket, B, G):
    npp = -(-plen // PS)
    prefix_idx = np.array(
        [[(1 + p // PS) * PS + p % PS if p < plen else p % PS for p in range(bucket)]], np.int32)
    ngp = -(-G // PS)
    gen_idx = np.array(
        [[(1 + npp + b * ngp + g // PS) * PS + g % PS for g in range(G)] for b in range(B)],
        np.int32)
    return prefix_idx, gen_idx, 1 + npp + B * ngp


def check_paged_decode(fam, impl, attn_impl, plen=20, bucket=32, rows=2, steps=6):
    """prefill into a page pool, then ``steps`` greedy paged steps through
    ``paged_verify_step`` (the port's ``attn_impl``: "xla" or "cuda")
    against the JAX function's reference attention: logits and the
    columns each step writes."""
    tokens = prompt_tokens(bucket, plen, fam.cfg.vocab_size, seed=2)
    jl, jcache = jax.jit(partial(jax_llama.prefill, fam.jcfg))(
        fam.jparams, jnp.asarray(tokens), jnp.int32(plen))
    prefix_idx, gen_idx, npages = _pool_layout(plen, bucket, rows, steps)
    shape = (fam.cfg.num_layers, npages * PS, fam.cfg.num_kv_heads, fam.cfg.head_dim)
    jk, jv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    jk[:, prefix_idx[0, :plen]] = np.asarray(jcache.k)[:, 0, :plen]
    jv[:, prefix_idx[0, :plen]] = np.asarray(jcache.v)[:, 0, :plen]
    pk, pv = torch.from_numpy(jk.copy()), torch.from_numpy(jv.copy())
    jstep = jax.jit(partial(jax_llama.paged_verify_step, fam.jcfg, attn_impl="xla"))
    tok = np.repeat(np.asarray(jl).argmax(-1), rows).astype(np.int32)
    for step in range(steps):
        lengths = np.full((rows,), step, np.int32)
        jlog, jkc, jvc = jstep(fam.jparams, jnp.asarray(tok)[:, None], jnp.asarray(lengths),
                               jnp.asarray([plen], jnp.int32), _kv((jk, jv)),
                               jnp.asarray(prefix_idx), jnp.asarray(gen_idx))
        tlog, tkc, tvc = llama.paged_verify_step(
            fam.port_cfg(impl), fam.params, torch.from_numpy(tok)[:, None],
            torch.from_numpy(lengths), torch.tensor([plen]), pk, pv,
            torch.from_numpy(prefix_idx), torch.from_numpy(gen_idx),
            attn_impl=attn_impl, page_size=PS)
        _close(tlog.numpy(), jlog)
        _close(tkc.numpy(), jkc)
        jk[:, gen_idx[:, step]] = np.asarray(jkc)
        jv[:, gen_idx[:, step]] = np.asarray(jvc)
        slots = torch.from_numpy(gen_idx[:, step]).long()
        pk[:, slots], pv[:, slots] = tkc, tvc
        assert (tlog.numpy()[:, 0].argmax(-1) == np.asarray(jlog)[:, 0].argmax(-1)).all()
        tok = np.asarray(jlog)[:, 0].argmax(-1).astype(np.int32)


def check_verify_step(fam, impl):
    """The loop's dense step at one token per row: per-row write offsets
    and prompt lengths on both sides of the window."""
    rng = np.random.default_rng(3)
    B, P, G = 3, 32, 12
    L, KVH, D = fam.cfg.num_layers, fam.cfg.num_kv_heads, fam.cfg.head_dim
    pk, pv = (rng.normal(size=(L, B, P, KVH, D)).astype(np.float32) for _ in range(2))
    gk, gv = (rng.normal(size=(L, B, G, KVH, D)).astype(np.float32) for _ in range(2))
    tokens = np.array([[5], [300], [77]], np.int32)
    lengths = np.array([0, 11, 4], np.int32)
    prompt_lens = np.array([32, 7, 19], np.int32)
    jlog, jgen = jax.jit(partial(jax_llama.verify_step, fam.jcfg))(
        fam.jparams, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(prompt_lens),
        _kv((gk, gv)), _kv((pk, pv)))
    gen = llama.KVCache(k=torch.tensor(gk), v=torch.tensor(gv))
    logits, gen = llama.verify_step(fam.port_cfg(impl), fam.params, torch.tensor(tokens),
                                    torch.tensor(lengths), torch.tensor(prompt_lens), gen,
                                    llama.KVCache(k=torch.tensor(pk), v=torch.tensor(pv)))
    _close(logits.numpy(), jlog)
    _close(gen.k.numpy(), jgen.k)
    _close(gen.v.numpy(), jgen.v)


def check_continue(fam, impl, p=16, total=29, btot=48, sq=16):
    """prefill_continue of a suffix over a prefix prefilled to ``p``: the
    last valid logits and the whole written cache."""
    tokens = prompt_tokens(btot, total, fam.cfg.vocab_size, seed=4)
    head = tokens.copy()
    head[0, p:] = 258
    jl, jcache = jax.jit(partial(jax_llama.prefill, fam.jcfg))(
        fam.jparams, jnp.asarray(head), jnp.int32(p))
    suffix = np.full((1, sq), 258, np.int32)
    suffix[0, : total - p] = tokens[0, p:total]
    jlog, jout = jax.jit(partial(jax_llama.prefill_continue, fam.jcfg))(
        fam.jparams, jnp.asarray(suffix), jcache, jnp.int32(p), jnp.int32(total))
    cache = llama.KVCache(k=torch.tensor(np.asarray(jcache.k)), v=torch.tensor(np.asarray(jcache.v)))
    tlog, tout = llama.prefill_continue(fam.port_cfg(impl), fam.params, torch.from_numpy(suffix),
                                        cache, p, total)
    _close(tlog.numpy(), jlog)
    _close(tout.k.numpy()[:, :, :total], np.asarray(jout.k)[:, :, :total])
    _close(tout.v.numpy()[:, :, :total], np.asarray(jout.v)[:, :, :total])
    full, _ = jax.jit(partial(jax_llama.prefill, fam.jcfg))(
        fam.jparams, jnp.asarray(tokens), jnp.int32(total))
    _close(tlog.numpy(), full, atol=1e-4)  # the continuation is the whole prompt's prefill


def check_chunks(fam, impl, total=29, chunk=8, bucket=40):
    """Chunked prefill: ``prefill_chunk_step_paged`` (and so
    ``prefill_chunk_step``) chunk by chunk against the JAX function: each
    chunk's columns, and the final chunk's logits."""
    tokens = prompt_tokens(bucket, total, fam.cfg.vocab_size, seed=5)
    L, KVH, D = fam.cfg.num_layers, fam.cfg.num_kv_heads, fam.cfg.head_dim
    jcache = jax_llama.init_cache(fam.jcfg, 1, bucket)
    tcache = llama.init_cache(fam.cfg, 1, bucket, "cpu")
    jchunk = jax.jit(partial(jax_llama.prefill_chunk_step_paged, fam.jcfg))
    for cursor in range(0, total, chunk):
        valid = min(chunk, total - cursor)
        part = np.full((1, chunk), 258, np.int32)
        part[0, :valid] = tokens[0, cursor: cursor + valid]
        jlog, jcache, jkc, jvc = jchunk(fam.jparams, jnp.asarray(part), jcache,
                                        jnp.int32(cursor), jnp.int32(valid))
        tlog, tcache, tkc, tvc = llama.prefill_chunk_step_paged(
            fam.port_cfg(impl), fam.params, torch.from_numpy(part), tcache, cursor, valid)
        assert tkc.shape == (L, chunk, KVH, D)
        _close(tkc.numpy()[:, :valid], np.asarray(jkc)[:, :valid])
        _close(tvc.numpy()[:, :valid], np.asarray(jvc)[:, :valid])
    _close(tlog.numpy(), jlog)


PROMPTS = [
    [256] + list(b"a prompt longer than the window, so the keys slide"),
    [256] + list(b"another one, shorter"),
]


def check_generate_many(fam, layout, temperature, impl="xla", max_new=12, **port_kw):
    """Two coalesced requests (different n and prompt lengths) through the
    JAX engine and the port's on one KV layout: tokens equal, logprobs
    within 1e-5 (``port_kw`` e.g. the kernel route)."""
    jeng = JaxEngine(fam.jcfg, params=fam.jparams, use_mesh=False, kv_layout=layout,
                     kv_page_size=16)
    teng = LocalEngine(fam.port_cfg(impl), params=fam.params, device="cpu", kv_layout=layout,
                       kv_page_size=16, **port_kw)
    kw = dict(max_new_tokens=max_new, temperature=temperature)
    want = jeng.generate_many([JaxSpec(PROMPTS[0], 3, 7), JaxSpec(PROMPTS[1], 2, 9)], **kw)
    got = teng.generate_many([GenRequestSpec(PROMPTS[0], 3, 7), GenRequestSpec(PROMPTS[1], 2, 9)],
                             **kw)
    assert teng.last_launch_stats["kv_layout"] == layout
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=ATOL, rtol=0)
        assert g.finish_reasons == w.finish_reasons
    return teng, got


def check_loop(fam, layout, chunk=32):
    """The continuous loop on both packages over the same weights: greedy
    requests alone, one prompt chunked (longer than ``chunk`` and than the
    window), tokens equal and logprobs within 1e-5."""
    from k_llms_tpu.engine.continuous import ContinuousDecodeLoop as JaxLoop
    from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop

    jeng = JaxEngine(fam.jcfg, params=fam.jparams, use_mesh=False, kv_layout=layout,
                     kv_page_size=8)
    teng = LocalEngine(fam.cfg, params=fam.params, device="cpu", kv_layout=layout, kv_page_size=8)
    jloop = JaxLoop(jeng, width=4, max_prompt=128, max_new=16, prefill_chunk_tokens=chunk)
    tloop = ContinuousDecodeLoop(teng, width=4, max_prompt=128, max_new=16,
                                 prefill_chunk_tokens=chunk)
    try:
        for ids, n in ((PROMPTS[0] + PROMPTS[1][1:], 2), (PROMPTS[1], 3)):
            kw = dict(n=n, max_new=12, temperature=0.0, top_p=None, seed=5)
            want = jloop.submit(ids, **kw).result(timeout=120)
            got = tloop.submit(ids, **kw).result(timeout=120)
            np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
            np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs), atol=ATOL, rtol=0)
        assert tloop.stats["completed"] == 2
    finally:
        jloop.stop()
        tloop.stop()
