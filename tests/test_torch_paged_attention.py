"""Fused paged decode attention (kernel K1): the port's plain version and its
dense-equivalent reference held against the JAX package's Pallas kernel
(interpret mode) and XLA reference, with tables from
``paged_attention_page_tables``.

Pools, queries and columns are made with numpy from a seed and handed to
both packages in f32; atol 1e-5. The CUDA kernel itself is held against its plain
version on a card, in test_torch_kernels_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import paged_attention as jax_pa
from k_llms_tpu_torch.ops import _ext
from k_llms_tpu_torch.ops import paged_attention as pa

ATOL = 1e-5
TRASH_PAGE = 0



def _build_tables(plens, G, ps, *, continuous):
    """Per-row flat-slot tables as the engines lay them out: prompt pages,
    then gen pages (``continuous`` continues the prompt's last partial page,
    so gen position 0 sits at phase plen % ps). Unmapped positions point into
    the trash page. Returns (prefix_idx [B, P], gen_idx [B, G], pages)."""
    B = len(plens)
    P = (max(int(p) for p in plens) + ps - 1) // ps * ps
    next_page = TRASH_PAGE + 1
    prefix_idx = np.empty((B, P), np.int32)
    gen_idx = np.empty((B, G), np.int32)
    for b, plen in enumerate(int(p) for p in plens):
        n_pp = -(-plen // ps)
        ppages = list(range(next_page, next_page + n_pp))
        next_page += n_pp
        for p in range(P):
            prefix_idx[b, p] = ppages[p // ps] * ps + p % ps if p < plen else TRASH_PAGE * ps + p % ps
        phase = plen % ps if continuous else 0
        n_gp = -(-(phase + G) // ps)
        if continuous and phase:
            gpages = [ppages[-1]] + list(range(next_page, next_page + n_gp - 1))
            next_page += n_gp - 1
        else:
            gpages = list(range(next_page, next_page + n_gp))
            next_page += n_gp
        for g in range(G):
            pos = phase + g
            gen_idx[b, g] = gpages[pos // ps] * ps + pos % ps
    return prefix_idx, gen_idx, next_page


def _data(seed, npages, ps, B, QH, KVH, D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return f(npages * ps, KVH, D), f(npages * ps, KVH, D), f(B, QH, D), f(B, KVH, D), f(B, KVH, D)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("page_size,continuous", [(8, False), (16, True)])
def test_plain_matches_pallas_interpret_and_xla(page_size, continuous):
    """Ragged prompt and gen lengths at every page-boundary class, phase 0
    (coalesced layout) and phase plen % ps (continuous layout), per-row
    tables: the port's plain version == Pallas (interpret) == XLA, and the
    port's reference == the JAX reference."""
    ps = page_size
    B, G, QH, KVH, D = 4, 12, 4, 2, 16
    plens = np.array([1, ps, 2 * ps + 3, 2 * ps - 1], np.int32)
    wis = np.array([0, 3, G - 1, 7], np.int32)
    prefix_idx, gen_idx, npages = _build_tables(plens, G, ps, continuous=continuous)
    pool_k, pool_v, q, nk, nv = _data(ps + continuous, npages, ps, B, QH, KVH, D)
    scale = 1.0 / math.sqrt(D)

    jt = jax_pa.paged_attention_page_tables(jnp.asarray(prefix_idx), jnp.asarray(gen_idx), ps)
    tt = pa.paged_attention_page_tables(*_t(prefix_idx, gen_idx), ps)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if continuous:
        np.testing.assert_array_equal(tt[2].numpy(), plens % ps)

    ref_p = jax_pa.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), *jt,
        jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(plens), jnp.asarray(wis),
        page_size=ps, sm_scale=scale, interpret=True,
    )
    key_mask = np.arange(G)[None, None, :] <= wis[:, None, None]
    prefix_mask = np.arange(prefix_idx.shape[1])[None, None, :] < plens[:, None, None]
    ref_x = jax_pa.paged_decode_attention_xla(
        jnp.asarray(q)[:, None], jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(prefix_idx), jnp.asarray(gen_idx), jnp.asarray(nk)[:, None],
        jnp.asarray(nv)[:, None], jnp.asarray(wis), jnp.asarray(key_mask),
        jnp.asarray(prefix_mask), sm_scale=scale,
    )
    tq, tpk, tpv, tnk, tnv = _t(q, pool_k, pool_v, nk, nv)
    out = pa.paged_decode_attention_plain(
        tq, tpk, tpv, *tt, tnk, tnv, *_t(plens, wis), page_size=ps, sm_scale=scale,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_p), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_x)[:, 0], atol=ATOL, rtol=0)

    port_x = pa.paged_decode_attention_xla(
        tq[:, None], tpk, tpv, *_t(prefix_idx, gen_idx), tnk[:, None], tnv[:, None],
        *_t(wis, key_mask, prefix_mask), sm_scale=scale,
    )
    np.testing.assert_allclose(port_x.numpy(), np.asarray(ref_x), atol=ATOL, rtol=0)


@pytest.mark.parametrize("page_size", [8])
def test_shared_prefix_table_matches_pallas(page_size):
    """An [R, NP] request-major prefix table (the engine's shared-prefix
    layout), phase-shifted gen pages: plain == Pallas on the same shared
    table == plain on the explicitly repeated [B, NP] table."""
    ps = page_size
    R, n_per, G, QH, KVH, D = 2, 2, 9, 4, 2, 16
    B = R * n_per
    plens_req = np.array([ps + 3, 2 * ps - 2], np.int32)
    plens_row = np.repeat(plens_req, n_per)
    wis = np.array([0, 4, 8, 2], np.int32)
    prefix_req, _, npages0 = _build_tables(plens_req, 1, ps, continuous=False)
    gen_idx = np.empty((B, G), np.int32)
    next_page = npages0
    phases = plens_row % ps
    for b in range(B):
        gpages = list(range(next_page, next_page + -(-(phases[b] + G) // ps)))
        next_page += len(gpages)
        for g in range(G):
            pos = phases[b] + g
            gen_idx[b, g] = gpages[pos // ps] * ps + pos % ps
    pool_k, pool_v, q, nk, nv = _data(40 + ps, next_page, ps, B, QH, KVH, D)
    scale = 1.0 / math.sqrt(D)

    jt = jax_pa.paged_attention_page_tables(jnp.asarray(prefix_req), jnp.asarray(gen_idx), ps)
    ref = jax_pa.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), *jt,
        jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(plens_row), jnp.asarray(wis),
        page_size=ps, sm_scale=scale, interpret=True,
    )
    tq, tpk, tpv, tnk, tnv = _t(q, pool_k, pool_v, nk, nv)
    lens = _t(plens_row, wis)
    shared = pa.paged_attention_page_tables(*_t(prefix_req, gen_idx), ps)
    out = pa.paged_decode_attention_plain(tq, tpk, tpv, *shared, tnk, tnv, *lens,
                                          page_size=ps, sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    per_row = pa.paged_attention_page_tables(*_t(np.repeat(prefix_req, n_per, axis=0), gen_idx), ps)
    out_rows = pa.paged_decode_attention_plain(tq, tpk, tpv, *per_row, tnk, tnv, *lens,
                                               page_size=ps, sm_scale=scale)
    np.testing.assert_allclose(out_rows.numpy(), out.numpy(), atol=ATOL, rtol=0)


def test_trash_page_contents_do_not_matter():
    """Masked slots (the trash page, table padding, the phase lead-in)
    contribute an exact 0: poisoning the trash page with huge values leaves
    the plain version's output unchanged."""
    ps, G, QH, KVH, D = 8, 6, 4, 2, 16
    plens = np.array([5, 11], np.int32)
    wis = np.array([2, 5], np.int32)
    prefix_idx, gen_idx, npages = _build_tables(plens, G, ps, continuous=True)
    pool_k, pool_v, q, nk, nv = _data(9, npages, ps, 2, QH, KVH, D)
    tables = pa.paged_attention_page_tables(*_t(prefix_idx, gen_idx), ps)
    args = _t(q, pool_k, pool_v)
    out = pa.paged_decode_attention_plain(*args, *tables, *_t(nk, nv, plens, wis),
                                          page_size=ps, sm_scale=0.25)
    pool_k[:ps] = 1e30
    pool_v[:ps] = -1e30
    out2 = pa.paged_decode_attention_plain(*_t(q, pool_k, pool_v), *tables, *_t(nk, nv, plens, wis),
                                           page_size=ps, sm_scale=0.25)
    assert torch.equal(out, out2)


def test_resolve_impl():
    assert pa.resolve_paged_attention_impl("auto", device="cpu") == "xla"
    assert pa.resolve_paged_attention_impl("auto", device="cuda") == "cuda"
    assert pa.resolve_paged_attention_impl("cuda", device="cpu") == "cuda"
    # The JAX package's name for its kernel selects the hand kernel.
    assert pa.resolve_paged_attention_impl("pallas", device="cpu") == "cuda"
    assert pa.resolve_paged_attention_impl("pallas", device="cuda") == "cuda"
    with pytest.raises(ValueError):
        pa.resolve_paged_attention_impl("triton", device="cpu")


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    ps, G, QH, KVH, D = 8, 5, 4, 2, 16
    plens = np.array([9, 3], np.int32)
    wis = np.array([1, 4], np.int32)
    prefix_idx, gen_idx, npages = _build_tables(plens, G, ps, continuous=False)
    pool_k, pool_v, q, nk, nv = _data(3, npages, ps, 2, QH, KVH, D)
    tables = pa.paged_attention_page_tables(*_t(prefix_idx, gen_idx), ps)
    args = (*_t(q, pool_k, pool_v), *tables, *_t(nk, nv, plens, wis))
    before = dict(_ext.LAUNCH_COUNTS)
    out = pa.paged_decode_attention(*args, page_size=ps, sm_scale=0.25)
    assert torch.equal(out, pa.paged_decode_attention_plain(*args, page_size=ps, sm_scale=0.25))
    assert _ext.LAUNCH_COUNTS == before
