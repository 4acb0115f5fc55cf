"""``w4_matmul_tp`` and int4 on a mesh, held against the JAX package: the
port's function on each rank's blocks of a gloo world of four port ranks,
beside the JAX function's ``shard_map`` over the forced CPU devices (its
Pallas kernel in interpret mode on each device's shard); and twins of
``tests/test_w4.py``'s mesh tests (int4 on a mesh against one device, the
downgrade where groups would split, a stored layout's ValueError, a
pre-quantized layout kept)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import assert_same_on_ranks, jax_mesh, port_config, port_tree, world_fixture
from conftest import shared_engine
from k_llms_tpu.models import get_config, init_params
from k_llms_tpu.ops.w4matmul import Q4Tensor as JaxQ4
from k_llms_tpu.ops.w4matmul import w4_matmul_tp as jax_w4_matmul_tp

world = world_fixture(4)


def _int4_cfg():
    return get_config("tiny").with_(
        hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=64, vocab_size=384, max_seq_len=128,
    )


def _problem(rows, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K // 2, N), dtype=np.int8)
    scale = ((rng.random((K // 128, N)) + 0.5) / (4.61 * np.sqrt(K))).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("part", ["col", "row"])
@pytest.mark.parametrize("shape,rows", [((2, 2), 8), ((2, 2), 3), ((1, 4), 8)])
def test_w4_matmul_tp_plain_matches_jax(world, part, shape, rows):
    """Rows over data when they divide (replicated otherwise); ``col`` keeps
    the output's columns sharded over model, ``row`` sums the partials. Each
    rank's block equals the JAX shard_map's block of the same device."""
    K, N = 1024, 512
    x, q, scale = _problem(rows, K, N, seed=rows + len(part))
    mesh = jax_mesh(*shape)
    want = np.asarray(jax_w4_matmul_tp(
        jnp.asarray(x), JaxQ4(jnp.asarray(q), jnp.asarray(scale), part=part, mesh=mesh),
        interpret=True))
    res = world.run("w4_tp", shape=shape, x=x, q=q, scale=scale, part=part)
    d_size, m_size = shape
    for rank, r in enumerate(res):
        d, m = divmod(rank, m_size)
        assert r["routed_equal"]
        assert r["rows_axis"] == ("data" if rows % d_size == 0 else None)
        blk = want
        if r["rows_axis"] == "data":
            blk = blk[d * rows // d_size: (d + 1) * rows // d_size]
        if part == "col":
            blk = blk[:, m * N // m_size: (m + 1) * N // m_size]
        np.testing.assert_allclose(r["out"], blk, rtol=1e-5, atol=1e-5)


def _run(world, shape, cfg, params, calls, **engine_kwargs):
    res = world.run("engine", shape=shape, config=port_config(cfg),
                    params=None if params is None else port_tree(params, cfg),
                    engine_kwargs=engine_kwargs, calls=calls)
    assert_same_on_ranks(res)
    return res[0]


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_int4_on_mesh_bitcompares_single_chip(world, temperature):
    """int4 on a (2, 2) mesh (K4's plain version on each shard through
    w4_matmul_tp) gives the single-device JAX int4 engine's tokens. The
    ranks cut their shards from the JAX engine's int4 tree (the packed
    bytes as JAX quantized them)."""
    cfg = _int4_cfg()
    solo = shared_engine(cfg, param_key=4, quantize="int4")
    prompt = [5, 6, 7, 8, 9]
    kw = dict(n=4, max_new_tokens=6, temperature=temperature, seed=3)
    want = solo.generate(prompt, **kw)
    got = _run(world, (2, 2), cfg, solo.params,
               [("attr", "quantized"), ("leaf", "wo", "part"), ("leaf", "wq", "part"),
                ("generate", (prompt,), kw)], quantize="int4", kv_layout="dense")
    assert got[:3] == ["int4", "row", "col"]
    np.testing.assert_array_equal(got[3]["tokens"], want.tokens)
    np.testing.assert_allclose(got[3]["logprobs"], want.logprobs, atol=1e-4)


def test_int4_downgrades_when_groups_would_split(world):
    """TP 4 over a K = 256 row-parallel weight would split a quantization
    group (K % (128 * 4)): int8 instead, loudly."""
    from k_llms_tpu_torch.models.quant import int4_mesh_compatible

    cfg = _int4_cfg().with_(num_kv_heads=4)  # kv heads that divide four ways
    pcfg = port_config(cfg)
    assert int4_mesh_compatible(pcfg, 2)
    assert not int4_mesh_compatible(pcfg, 4)
    got = _run(world, (1, 4), cfg, None, [("attr", "quantized")], quantize="int4")
    assert got == ["int8"]


@pytest.mark.parametrize("tp,off", [(2, {}), (4, {}), (8, {})])
def test_llama3_8b_int4_shards_off_the_kernel(tp, off):
    """Llama-3-8B int4 shards over 2, 4 and 8 model ranks without splitting
    a group (JAX's rule), and K4 takes every shard: the lm_head shards at 4
    and 8 ([4096, 32064], [4096, 16032]) end inside a column tile, which K4
    masks. So no weight stays int8, drawn or quantized, as in JAX; a weight
    listed off the kernel (``int8_keys``) would stay int8."""
    import torch

    from k_llms_tpu_torch.models.config import get_config as port_get_config
    from k_llms_tpu_torch.models.quant import (
        Q4Tensor, QTensor, init_params_quantized, int4_mesh_compatible, int4_off_kernel_shards,
        quantize_params)
    from k_llms_tpu_torch.models.llama import init_params as port_init_params

    big = port_get_config("llama-3-8b")
    assert int4_mesh_compatible(big, tp)
    assert int4_off_kernel_shards(big, tp) == off
    cfg = port_config(_int4_cfg())
    gen = torch.Generator().manual_seed(0)
    keys = frozenset(off)
    drawn = init_params_quantized(cfg, gen, "cpu", bits=4, int8_keys=keys)
    quantized = quantize_params(port_init_params(cfg, gen, "cpu"), bits=4, int8_keys=keys)
    for tree in (drawn, quantized):
        assert isinstance(tree["lm_head"], QTensor if off else Q4Tensor)
        assert all(isinstance(tree["layers"][k], Q4Tensor) for k in ("wq", "wo", "w_down"))
    # The weights the registry still keeps off K4 at TP <= 8 miss K only.
    from k_llms_tpu_torch.models.config import _REGISTRY

    for name, c in _REGISTRY.items():
        for k, (K, N) in int4_off_kernel_shards(c, tp).items():
            assert K % 256 and N % 16 == 0, (name, tp, k, K, N)
    keep = init_params_quantized(cfg, gen, "cpu", bits=4, int8_keys=frozenset({"lm_head"}))
    assert isinstance(keep["lm_head"], QTensor)


def test_stored_int4_incompatible_mesh_raises(world):
    """A stored int4 tree whose groups cannot shard raises the JAX engine's
    ValueError before any shard is cut, whatever was asked."""
    from k_llms_tpu.models.quant import quantize_params

    cfg = _int4_cfg().with_(num_kv_heads=4)
    tree = port_tree(quantize_params(init_params(cfg, jax.random.key(9)), bits=4), cfg)
    for quantize in ("int4", "int8"):
        res = world.run("engine_error", shape=(1, 4), config=port_config(cfg), params=tree,
                        engine_kwargs=dict(quantize=quantize))
        assert all(r[0] == "ValueError" and "re-quantize to int8 or change the mesh" in r[1]
                   for r in res)


def test_prequantized_checkpoint_layout_survives_mesh_init(world):
    """A pre-quantized tree keeps its stored layout on a mesh: int8 asked as
    int4 stays int8, int4 asked as int8 stays int4 and is marked for
    w4_matmul_tp; both generate as the JAX mesh engine does."""
    from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
    from k_llms_tpu.models.quant import quantize_params

    cfg = _int4_cfg()
    kw = dict(n=4, max_new_tokens=3, temperature=0.5, seed=2)
    for bits, asked, leaf, part in ((8, "int4", "QTensor", None), (4, "int8", "Q4Tensor", "col")):
        tree = quantize_params(init_params(cfg, jax.random.key(6 + bits)), bits=bits)
        want = JaxEngine(cfg, params=tree, mesh=jax_mesh(2, 2), quantize=asked).generate(
            [5, 6, 7], **kw)
        got = _run(world, (2, 2), cfg, tree,
                   [("leaf", "w_gate", None), ("leaf", "w_gate", "part") if part else ("attr", "quantized"),
                    ("generate", ([5, 6, 7],), kw)], quantize=asked, kv_layout="dense")
        assert got[0] == leaf
        assert got[1] == (part or ("int8" if bits == 8 else "int4"))
        np.testing.assert_array_equal(got[2]["tokens"], want.tokens)
