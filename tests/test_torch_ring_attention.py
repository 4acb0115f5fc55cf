"""The port's ring-attention ops held against the JAX package's, each on a
rank's shards of a gloo world of four port ranks (``shard_map``'s bodies in
SPMD): ring attention on rings of two and four (twins of
``tests/test_ops.py``'s ring tests), ring decode and verify over a
sequence-sharded prefix, the one-shot suffix-prefix merge and the scatter
into the ring layout (twins of ``tests/test_sp_decode.py``'s op tests).
fp32, within 2e-5 as the JAX tests hold their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import jax_mesh, world_fixture
from k_llms_tpu.ops.attention import attention_xla
from k_llms_tpu.ops.ring_attention import (
    ring_attention,
    ring_decode_prefix,
    ring_verify_prefix,
    scatter_into_ring,
    suffix_prefix_attention,
)

world = world_fixture(4)


def _qkv(seed, B=2, QH=4, KVH=2, S=64, D=16):
    ks = jax.random.split(jax.random.key(seed), 3)
    q = jax.random.normal(ks[0], (B, QH, S, D), jnp.float32)
    k = jax.random.normal(ks[1], (B, KVH, S, D), jnp.float32)
    v = jax.random.normal(ks[2], (B, KVH, S, D), jnp.float32)
    return q, k, v


def _blocks(results, axis, ring):
    """The ring's blocks in ring order (ranks of model coordinate 0)."""
    ranks = [d * (4 // ring) for d in range(ring)]
    return np.concatenate([results[r] for r in ranks], axis=axis)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_ring_attention_exact(world, causal, shape):
    q, k, v = _qkv(3)
    ref = np.asarray(attention_xla(q, k, v, causal=causal))
    jref = np.asarray(ring_attention(jax_mesh(*shape), q, k, v, seq_axis="data", causal=causal))
    res = world.run("ring_attention", shape=shape, q=np.asarray(q), k=np.asarray(k),
                    v=np.asarray(v), causal=causal)
    got = _blocks(res, 2, shape[0])
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jref, rtol=2e-5, atol=2e-5)


def test_ring_attention_memory_layout(world):
    """GQA (8 query heads on 4 kv heads), batch 1: each rank holds and
    returns its quarter of the sequence."""
    q, k, v = _qkv(4, B=1, QH=8, KVH=4, S=32, D=8)
    ref = np.asarray(attention_xla(q, k, v, causal=True))
    res = world.run("ring_attention", shape=(4, 1), q=np.asarray(q), k=np.asarray(k),
                    v=np.asarray(v), causal=True)
    assert all(r.shape == (1, 8, 8, 8) for r in res)
    np.testing.assert_allclose(_blocks(res, 2, 4), ref, rtol=2e-5, atol=2e-5)


def _decode_case(verify):
    B, QH, KVH, D, S, Sq = 8, 4, 2, 16, 64, 3
    qshape = (B, QH, Sq, D) if verify else (B, QH, D)
    q = jax.random.normal(jax.random.key(1), qshape, jnp.float32)
    pk = jax.random.normal(jax.random.key(2), (1, S, KVH, D), jnp.float32)
    pv = jax.random.normal(jax.random.key(3), (1, S, KVH, D), jnp.float32)
    return q, pk, pv, 50


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_ring_decode_prefix_matches_jax(world, verify, shape):
    """Rows over the ring, heads over model: each rank's (out, m, l) block
    equals the JAX mesh's block of the same devices."""
    q, pk, pv, plen = _decode_case(verify)
    fn = ring_verify_prefix if verify else ring_decode_prefix
    want = [np.asarray(t) for t in fn(jax_mesh(*shape), q, pk, pv, jnp.int32(plen))]
    res = world.run("ring_decode", shape=shape, q=np.asarray(q), pk=np.asarray(pk),
                    pv=np.asarray(pv), plen=plen, verify=verify)
    d_size, m_size = shape
    B, QH = q.shape[0], q.shape[1]
    for rank, r in enumerate(res):
        d, m = divmod(rank, m_size)
        rows = slice(d * B // d_size, (d + 1) * B // d_size)
        heads = slice(m * QH // m_size, (m + 1) * QH // m_size)
        for got, w in zip(r, want):
            np.testing.assert_allclose(got, w[rows, heads], rtol=2e-5, atol=2e-5)


def test_ring_decode_prefix_matches_dense_attention(world):
    """(out, m, l) reproduce plain softmax over the valid prefix keys, and
    (m, l) is its logsumexp."""
    q, pk, pv, plen = _decode_case(False)
    res = world.run("ring_decode", shape=(4, 1), q=np.asarray(q), pk=np.asarray(pk),
                    pv=np.asarray(pv), plen=plen)
    out = np.concatenate([r[0] for r in res])
    m = np.concatenate([r[1] for r in res])
    l = np.concatenate([r[2] for r in res])
    B, QH, D = q.shape
    KVH, G = 2, 2
    qg = np.asarray(q).reshape(B, KVH, G, D)
    s = np.einsum("bhgd,shd->bhgs", qg, np.asarray(pk)[0]) / np.sqrt(D)
    s[..., plen:] = -np.inf
    w = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhgs,shd->bhgd", w / w.sum(-1, keepdims=True), np.asarray(pv)[0])
    np.testing.assert_allclose(out, ref.reshape(B, QH, D), rtol=2e-5, atol=2e-5)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose((m + np.log(l)).reshape(B, KVH, G), lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_suffix_prefix_attention_matches_jax(world, shape):
    QH, KVH, D, S, Sq, plen = 4, 2, 16, 64, 8, 41
    q = jax.random.normal(jax.random.key(1), (1, QH, Sq, D), jnp.float32)
    pk = jax.random.normal(jax.random.key(2), (1, S, KVH, D), jnp.float32)
    pv = jax.random.normal(jax.random.key(3), (1, S, KVH, D), jnp.float32)
    want = [np.asarray(t) for t in
            suffix_prefix_attention(jax_mesh(*shape), q, pk, pv, jnp.int32(plen))]
    res = world.run("suffix_prefix", shape=shape, q=np.asarray(q), pk=np.asarray(pk),
                    pv=np.asarray(pv), plen=plen)
    m_size = shape[1]
    for rank, r in enumerate(res):
        heads = slice((rank % m_size) * QH // m_size, (rank % m_size + 1) * QH // m_size)
        for got, w in zip(r, want):
            np.testing.assert_allclose(got, w[:, heads], rtol=2e-5, atol=2e-5)


def test_scatter_into_ring_writes_only_suffix_rows(world):
    S, Ssuf, KVH, D = 64, 16, 2, 4
    base = np.asarray(jax.random.normal(jax.random.key(1), (1, S, KVH, D), jnp.float32))
    suf = np.asarray(jax.random.normal(jax.random.key(2), (1, Ssuf, KVH, D), jnp.float32))
    start, total = 37, 48
    want = np.asarray(scatter_into_ring(jax_mesh(4, 1), base, suf, jnp.int32(start),
                                        jnp.int32(total)))
    res = world.run("scatter_ring", shape=(4, 1), buf=base, suf=suf, start=start, total=total)
    got = np.concatenate(res, axis=1)
    np.testing.assert_array_equal(got, want)
    expect = base.copy()
    expect[0, start:total] = suf[0, : total - start]
    np.testing.assert_array_equal(got, expect)
