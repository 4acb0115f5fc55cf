"""The port's mesh held against the JAX package's: a gloo world of four
spawned port ranks (``_torch_mesh_worker``) beside the JAX mesh of the same
shape over the forced CPU devices. Tiny fp32 weights from the parity
harness's seed; greedy and sampled tokens equal, logprobs and logits within
1e-5. Twins of ``tests/test_engine.py`` (mesh shapes, n not divisible by the
data axis), ``test_quant.py`` (int8 sharded, the quantized spec tree, a
pre-quantized tree on a mesh), ``test_moe.py``, ``test_model_families.py``,
``test_gemma.py`` (sharded engines), ``test_prefix_cache.py`` (continuation
on a mesh), ``test_loader.py`` (TP equals DP) and ``test_speculative.py``
(speculation on a mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import assert_same_on_ranks, jax_mesh, port_config, port_tree, world_fixture
from conftest import shared_params
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.models import get_config

world = world_fixture(4)

PROMPT = list(range(5, 45))
TINY = get_config("tiny")


def _run(world, shape, cfg, params, calls, engine_kwargs=None, key=None):
    res = world.run("engine", shape=shape, config=port_config(cfg),
                    params=None if params is None else port_tree(params, cfg),
                    engine_kwargs=dict(kv_page_size=8, **(engine_kwargs or {})), calls=calls,
                    key=key)
    assert_same_on_ranks(res)
    return res[0]


def _jax(cfg, params, shape, **kw):
    return JaxEngine(cfg, params=params, mesh=jax_mesh(*shape), **kw)


def test_mesh_shape(world):
    """auto_mesh factors the world (4 ranks) into (data, model) and
    make_mesh refuses a grid the world cannot hold, as on the JAX mesh."""
    res = world.run("mesh_shapes")
    for r in res:
        assert r["auto"] == {"data": 4, "model": 1}
        assert r["auto_mp2"] == {"data": 2, "model": 2}
        assert "needs 16 devices, have 4" in r["too_big"]
        assert "does not divide device count 4" in r["mp3"]
    assert sorted(tuple(r["coords"]) for r in res) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("axis", ["data", "model"])
def test_collectives_over_an_axis(world, axis):
    """psum, pmax, all_gather, ppermute and all_to_all over each axis of a
    (2, 2) mesh, against the values the four ranks contribute."""
    res = world.run("collectives", shape=(2, 2))
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(4)]
    for rank, r in enumerate(res):
        d, m = divmod(rank, 2)
        group = [2 * d, 2 * d + 1] if axis == "model" else [m, 2 + m]
        me = group.index(rank)
        o = r[axis]
        assert o["index"] == me
        np.testing.assert_array_equal(o["psum"], sum(x[g] for g in group))
        np.testing.assert_array_equal(o["pmax"], np.maximum(*[x[g] for g in group]))
        np.testing.assert_array_equal(o["all_gather"], np.concatenate([x[g] for g in group], 1))
        np.testing.assert_array_equal(o["ppermute"], x[group[(me - 1) % 2]])
        chunks = [np.arange(8, dtype=np.float32)[None] + 100 * g for g in group]
        np.testing.assert_array_equal(
            o["all_to_all"], np.concatenate([c[:, 4 * me: 4 * me + 4] for c in chunks], 0))


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("temperature,n", [(0.0, 4), (0.9, 5)])
def test_tensor_parallel_engine_matches_jax_mesh(world, layout, temperature, n):
    """A (2, 2) mesh: tensor-parallel shards, rows whole on each data rank,
    n padded to the data axis; the JAX mesh engine's tokens exactly."""
    params = shared_params(TINY)
    kw = dict(n=n, max_new_tokens=6, temperature=temperature, seed=3)
    ref = _jax(TINY, params, (2, 2)).generate(PROMPT, **kw)
    got = _run(world, (2, 2), TINY, params, [("generate", (PROMPT,), kw)],
               dict(kv_layout=layout))[0]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)
    np.testing.assert_allclose(got["logprobs"], ref.logprobs, atol=1e-5)
    assert got["finish_reasons"] == ref.finish_reasons


def test_generate_n_not_divisible_by_mesh(world):
    """Data axis 4, n = 5: the rows pad to 8 and trim back to 5, and the
    draws land on the rows JAX's padded batch gives them."""
    params = shared_params(TINY)
    kw = dict(n=5, max_new_tokens=4, temperature=1.0, seed=3)
    ref = _jax(TINY, params, (4, 1)).generate(PROMPT[:10], **kw)
    got = _run(world, (4, 1), TINY, params, [("generate", (PROMPT[:10],), kw)])[0]
    assert got["tokens"].shape == (5, 4)
    np.testing.assert_array_equal(got["tokens"], ref.tokens)


def test_prefill_and_decode_step_match_jax_on_shards(world):
    """The model functions on a rank's shard (vocabulary-sharded embedding
    and head, row-parallel psums): prefill logits and a decode step equal
    the JAX functions' within 1e-5."""
    from k_llms_tpu.models.llama import decode_step, init_cache, prefill

    params = shared_params(TINY)
    S = 16
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (1, S), 0, TINY.vocab_size))
    ref_logits, prefix = prefill(TINY, params, jnp.asarray(tokens), jnp.int32(10))
    got = world.run("model_fn", shape=(2, 2), config=port_config(TINY),
                    params=port_tree(params, TINY), fn="prefill", args=[tokens.astype(np.int64), 10])
    for r in got:
        np.testing.assert_allclose(r[0], np.asarray(ref_logits), atol=1e-5)
        # Each model rank holds its kv heads of the layer cache.
    k_full = np.asarray(prefix[0])
    ranks_k = [r[1][0] for r in got]
    np.testing.assert_allclose(np.concatenate(ranks_k[:2], axis=3), k_full, atol=1e-5)
    n = 3
    tk = np.full((n,), tokens[0, 10], np.int64)
    ref_step, _ = decode_step(TINY, params, jnp.asarray(tk), jnp.int32(0), jnp.int32(10),
                              init_cache(TINY, n, 4), prefix)
    got = world.run("decode_on_shards", shape=(2, 2), config=port_config(TINY),
                    params=port_tree(params, TINY), tokens=tokens, prompt_len=10, n=n)
    for r in got:
        np.testing.assert_allclose(r, np.asarray(ref_step), atol=1e-5)


def test_embed_tokens_on_mesh(world):
    params = shared_params(TINY)
    lists = [PROMPT[:7], PROMPT[:7], PROMPT[3:20]]
    ref = _jax(TINY, params, (2, 2)).embed_tokens(lists)
    got = _run(world, (2, 2), TINY, params, [("embed_tokens", (lists,), {})])[0]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_engine_generate_int8_sharded(world):
    """int8 weights on a (2, 2) mesh (twin of test_quant.py)."""
    params = shared_params(TINY)
    kw = dict(n=4, max_new_tokens=6, temperature=0.7, seed=3)
    ref = _jax(TINY, params, (2, 2), quantize=True).generate(PROMPT, **kw)
    got = _run(world, (2, 2), TINY, params, [("generate", (PROMPT,), kw), ("attr", "quantized")],
               dict(quantize="int8"))
    assert got[1] == "int8"
    np.testing.assert_array_equal(got[0]["tokens"], ref.tokens)


def test_quantized_param_specs_structure():
    from k_llms_tpu_torch.models.quant import QTensor, quantized_param_specs
    from k_llms_tpu_torch.parallel.sharding import param_specs

    specs = param_specs(port_config(TINY))
    qspecs = quantized_param_specs(specs)
    assert isinstance(qspecs["layers"]["wq"], QTensor)
    assert qspecs["layers"]["wq"].q == specs["layers"]["wq"]
    assert qspecs["layers"]["wo"].scale[-2] is None
    assert qspecs["final_norm"] == specs["final_norm"]


def test_prequantized_checkpoint_with_quantize_unset_on_mesh(world):
    from k_llms_tpu.models.quant import quantize_params

    qparams = quantize_params(shared_params(TINY))
    got = _run(world, (2, 2), TINY, qparams, [("attr", "quantized"), ("leaf", "wq", None)])
    assert got == ["int8", "QTensor"]


def test_moe_engine_sharded_matches_single(world):
    """Mixtral-style experts shard over the model axis (E/TP a rank, a psum
    combines them): the unsharded JAX engine's greedy tokens."""
    from test_moe import TINY_MOE

    params = shared_params(TINY_MOE, 5)
    kw = dict(n=4, max_new_tokens=6, temperature=0.0, seed=1)
    ref = JaxEngine(TINY_MOE, params=params, use_mesh=False).generate(PROMPT[:12], **kw)
    got = _run(world, (2, 2), TINY_MOE, params, [("generate", (PROMPT[:12],), kw)])[0]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)


@pytest.mark.parametrize("family", ["qwen_int8", "gemma"])
def test_family_engine_sharded(world, family):
    """Qwen-style biases (quantized) and Gemma-2's norms, softcaps and
    windows on a (2, 2) mesh: the JAX mesh engine's sampled tokens."""
    from test_gemma import TINY_GEMMA
    from test_model_families import TINY_QWEN

    cfg, quant = (TINY_QWEN, True) if family == "qwen_int8" else (TINY_GEMMA, False)
    params = shared_params(cfg, 2)
    kw = dict(n=4, max_new_tokens=6, temperature=0.8, seed=2)
    ref = _jax(cfg, params, (2, 2), quantize=quant).generate(PROMPT[:12], **kw)
    got = _run(world, (2, 2), cfg, params, [("generate", (PROMPT[:12],), kw)],
               dict(quantize="int8" if quant else None))[0]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)
    np.testing.assert_allclose(got["logprobs"], ref.logprobs, atol=1e-5)


def test_prefix_cache_on_mesh(world):
    """Continuation prefill on a (2, 2) mesh matches the uncached result
    and the JAX mesh engine's."""
    from test_prefix_cache import DOC_A, DOC_B, SYSTEM

    params = shared_params(TINY, 3)
    kw_a = dict(n=4, max_new_tokens=3, temperature=0.7, seed=31)
    kw_b = dict(n=4, max_new_tokens=3, temperature=0.7, seed=32)
    jc = _jax(TINY, params, (2, 2), prefix_cache_size=4, prefix_cache_min_reuse=16)
    jc.generate(SYSTEM + DOC_A, **kw_a)
    ref = jc.generate(SYSTEM + DOC_B, **kw_b)
    got = _run(world, (2, 2), TINY, params, [
        ("generate", (SYSTEM + DOC_A,), kw_a), ("generate", (SYSTEM + DOC_B,), kw_b),
        ("attr", "prefix_cache_stats")], dict(prefix_cache_size=4, prefix_cache_min_reuse=16))
    assert got[2]["partial_hits"] == 1
    np.testing.assert_array_equal(got[1]["tokens"], ref.tokens)
    plain = _run(world, (2, 2), TINY, params, [("generate", (SYSTEM + DOC_B,), kw_b)])[0]
    np.testing.assert_array_equal(got[1]["tokens"], plain["tokens"])


def test_tensor_parallel_decode_matches_data_parallel(world):
    """The same weights give the same samples sharded (2, 2) or (4, 1)."""
    params = shared_params(TINY)
    kw = dict(n=4, max_new_tokens=8, temperature=0.0, seed=9)
    tp = _run(world, (2, 2), TINY, params, [("generate", (PROMPT,), kw)])[0]
    dp = _run(world, (4, 1), TINY, params, [("generate", (PROMPT,), kw)])[0]
    np.testing.assert_array_equal(tp["tokens"], dp["tokens"])
    np.testing.assert_allclose(tp["logprobs"], dp["logprobs"], atol=2e-5)


@pytest.mark.parametrize("case", ["greedy", "sampled_n3", "features"])
def test_mesh_speculation_matches_jax(world, case):
    """Prompt-lookup speculation on a (2, 2) mesh: the JAX mesh spec
    engine's tokens (greedy, sampled with n not dividing the data axis,
    penalties + bias + stops)."""
    from test_speculative import PROMPT as SPEC_PROMPT

    params = shared_params(TINY)
    kw = {
        "greedy": dict(n=4, max_new_tokens=10, temperature=0.0, seed=3),
        "sampled_n3": dict(n=3, max_new_tokens=8, temperature=0.9, seed=11),
        "features": dict(n=4, max_new_tokens=10, temperature=0.0, seed=6, frequency_penalty=0.5,
                         presence_penalty=0.2, logit_bias={9: 3.0}, stop_sequences=[[13, 14]]),
    }[case]
    spec = dict(speculative="prompt_lookup", spec_lookahead=4)
    ref = _jax(TINY, params, (2, 2), **spec).generate(SPEC_PROMPT, **kw)
    got = _run(world, (2, 2), TINY, params, [("generate", (SPEC_PROMPT,), kw)],
               dict(kv_layout="dense", **spec))[0]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)
    assert got["finish_reasons"] == ref.finish_reasons
    assert got["spec_stats"]["verify_iterations"] >= 1


def test_rank_check_raises_when_one_rank_is_perturbed(world):
    """The cross-rank token check passes on equal tokens and raises on every
    rank when one rank's tokens differ."""
    res = world.run("rank_check", shape=(2, 2), perturb_rank=2)
    for r in res:
        assert r is not None and "ranks [2]" in r


def test_mesh_refuses_shards_that_do_not_divide(world):
    """The port cuts exact shards: tiny's two kv heads cannot split four
    ways."""
    res = world.run("engine_error", shape=(1, 4), config=port_config(TINY),
                    params=port_tree(shared_params(TINY), TINY), engine_kwargs={})
    assert all(r[0] == "ValueError" and "num_kv_heads" in r[1] for r in res)
