"""The port's sequence-parallel forward and the engine's SP routes, held
against the JAX package (twins of ``tests/test_long_context.py``): a gloo
world of two port ranks, a ring of two over ``data``; each rank runs its
half of the sequence and the JAX dense forward (and the JAX engine) is the
reference. fp32 tiny configs: logits within 1e-5, tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import assert_same_on_ranks, jax_mesh, port_config, port_tree, world_fixture
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.engine.long_context import forward_sequence_parallel
from k_llms_tpu.models import get_config, init_params
from k_llms_tpu.models.llama import forward

world = world_fixture(2)

VARIANTS = {
    "qwen2-bias": dict(qkv_bias=True),
    "gemma2-norms": dict(act="gelu", norm_offset=True, embed_scale=True, post_block_norms=True,
                         logit_softcap=30.0, query_scale=0.125),
    "moe": dict(num_experts=4, num_experts_per_tok=2),
}


def _sp(world, cfg, params, tokens, attention="ring"):
    return world.run("sp_forward", shape=(2, 1), config=port_config(cfg),
                     params=port_tree(params, cfg), tokens=np.asarray(tokens).astype(np.int64),
                     attention=attention)


def _whole(res, key):
    return np.concatenate([r[key] for r in res], axis=2 if key in ("k", "v") else 1)


def test_sequence_parallel_matches_dense(world):
    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.key(0))
    B, S = 2, 64
    tokens = jax.random.randint(jax.random.key(1), (B, S), 0, cfg.vocab_size)
    ref_logits, ref_hidden = forward(cfg, params, tokens, jnp.ones((B, S), jnp.int32))
    res = _sp(world, cfg, params, tokens)
    np.testing.assert_allclose(_whole(res, "logits"), np.asarray(ref_logits), atol=1e-5)
    np.testing.assert_allclose(_whole(res, "h"), np.asarray(ref_hidden), atol=1e-5)
    # Each rank's KV is its half of the dense prefill layout.
    assert res[0]["k"].shape == (cfg.num_layers, B, S // 2, cfg.num_kv_heads, cfg.head_dim)
    _, _, jkv = forward_sequence_parallel(cfg, params, tokens, jax_mesh(2, 1), seq_axis="data")
    np.testing.assert_allclose(_whole(res, "k"), np.asarray(jkv.k), atol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sequence_parallel_matches_dense_variants(world, variant):
    cfg = get_config("tiny").with_(**VARIANTS[variant])
    params = init_params(cfg, jax.random.key(2))
    B, S = 2, 32
    tokens = jax.random.randint(jax.random.key(3), (B, S), 0, cfg.vocab_size)
    ref, _ = forward(cfg, params, tokens, jnp.ones((B, S), jnp.int32))
    np.testing.assert_allclose(_whole(_sp(world, cfg, params, tokens), "logits"),
                               np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("over", [dict(attn_softcap=50.0), dict(sliding_window=16)])
def test_sequence_parallel_rejects_softcap_and_window(world, over):
    cfg = get_config("tiny").with_(**over)
    res = _sp(world, cfg, init_params(cfg, jax.random.key(0)), np.zeros((1, 64), np.int64))
    assert all(r["error"] == "NotImplementedError" for r in res)


def test_sequence_parallel_rejects_indivisible(world):
    cfg = get_config("tiny")
    res = _sp(world, cfg, init_params(cfg, jax.random.key(0)), np.zeros((1, 61), np.int64))
    assert all(r["error"] == "ValueError" and "divide" in r["message"] for r in res)


def test_ulysses_rejects_unknown_strategy(world):
    cfg = get_config("tiny")
    res = _sp(world, cfg, init_params(cfg, jax.random.key(0)), np.zeros((1, 64), np.int64),
              attention="zigzag")
    assert all("Unknown sequence-parallel" in r["message"] for r in res)


def test_ulysses_matches_dense_and_ring(world):
    """All-to-all context parallelism (the flash kernel's plain version on
    each rank's head half) equals the dense forward and the ring."""
    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.key(5))
    B, S = 2, 64
    tokens = jax.random.randint(jax.random.key(6), (B, S), 0, cfg.vocab_size)
    ref, _ = forward(cfg, params, tokens, jnp.ones((B, S), jnp.int32))
    uly = _sp(world, cfg, params, tokens, attention="ulysses")
    ring = _sp(world, cfg, params, tokens)
    np.testing.assert_allclose(_whole(uly, "logits"), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(_whole(uly, "logits"), _whole(ring, "logits"), atol=1e-5)
    np.testing.assert_allclose(_whole(uly, "k"), _whole(ring, "k"), atol=1e-5)


def _engine(world, cfg, params, calls, **engine_kwargs):
    res = world.run("engine", shape=(2, 1), config=port_config(cfg),
                    params=port_tree(params, cfg), engine_kwargs=engine_kwargs, calls=calls)
    assert_same_on_ranks(res)
    return res[0]


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_engine_routes_long_prompts_through_sp_prefill(world, attention):
    """A long prompt takes the SP route (its collectives ran) and generates
    what the JAX engine generates on one device."""
    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.key(0))
    prompt = [int(x) for x in jax.random.randint(jax.random.key(9), (70,), 5, 200)]
    kw = dict(n=4, max_new_tokens=5, temperature=0.7, seed=3)
    want = JaxEngine(cfg, params=params, use_mesh=False).generate(prompt, **kw)
    got = _engine(world, cfg, params, [("collectives",), ("generate", (prompt,), kw),
                                       ("collectives",)],
                  sp_prefill_min_tokens=64, sp_attention=attention)
    assert got[2]["ppermute" if attention == "ring" else "all_to_all"] > 0
    np.testing.assert_array_equal(got[1]["tokens"], want.tokens)
    np.testing.assert_allclose(got[1]["logprobs"], want.logprobs, atol=1e-5)


def test_engine_sp_threshold_respects_unsupported_configs(world):
    """A windowed config keeps the dense prefill (never the ring's
    NotImplementedError)."""
    cfg = get_config("tiny").with_(sliding_window=16)
    params = init_params(cfg, jax.random.key(0))
    got = _engine(world, cfg, params, [("collectives",),
                                       ("generate", (list(range(5, 70)),),
                                        dict(n=2, max_new_tokens=3, temperature=0.5, seed=1)),
                                       ("collectives",)], sp_prefill_min_tokens=32)
    assert got[1]["tokens"].shape == (2, 3)
    assert got[2]["ppermute"] == 0 and got[2]["all_to_all"] == 0


def test_generate_many_routes_sp_per_request(world):
    """A coalesced launch routes the long prompt through the SP prefill and
    the short one dense, equals each request served alone, and gives the
    JAX mesh engine's coalesced tokens and logprobs."""
    from k_llms_tpu.engine.engine import GenRequestSpec

    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.key(0))
    long_prompt = [int(x) for x in jax.random.randint(jax.random.key(4), (70,), 5, 200)]
    short_prompt = list(range(5, 15))
    kw = dict(max_new_tokens=4, temperature=0.6)
    got = _engine(world, cfg, params, [
        ("generate", (long_prompt,), dict(n=2, seed=11, **kw)),
        ("generate", (short_prompt,), dict(n=2, seed=12, **kw)),
        ("collectives",),
        ("generate_many", ([(long_prompt, 2, 11), (short_prompt, 2, 12)],), kw),
        ("collectives",)], sp_prefill_min_tokens=64)
    assert got[4]["ppermute"] > 0
    want = JaxEngine(cfg, params=params, mesh=jax_mesh(2, 1), sp_prefill_min_tokens=64).generate_many(
        [GenRequestSpec(long_prompt, 2, 11), GenRequestSpec(short_prompt, 2, 12)], **kw)
    for solo, batched, ref in zip(got[:2], got[3], want):
        np.testing.assert_array_equal(solo["tokens"], batched["tokens"])
        np.testing.assert_array_equal(batched["tokens"], ref.tokens)
        np.testing.assert_allclose(batched["logprobs"], ref.logprobs, atol=1e-5)
