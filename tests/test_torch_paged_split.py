"""K1's redesign (``csrc/paged_decode.cu``): the split plan, the split and
merge, and the rounding of P on the tensor cores, on the CPU.

* The plan (``paged_split_plan``, ``paged_work_items``, the functions the
  wrapper and the kernel follow) covers every page with a valid slot of
  every row exactly once and puts at least 132 CTAs on the card at the main
  path's shape (one request of n = 8 rows, 8 kv heads, 1490 prompt tokens).
* ``paged_decode_attention_split``, the kernel's split and merge in plain
  PyTorch, is held against the JAX package's Pallas kernel in interpret mode
  and against ``paged_decode_attention_plain`` within the card's K1 limit,
  1e-5 absolute, with splits that hold only masked slots or trash pages, a
  prefix shorter than one split, and per-row tables; a bad page id poisons
  its rows alone; a dropped split or a boundary one page off breaks the
  limit.
* The tensor-core kernel's P V, modelled block by block: one bf16 rounding
  of P breaks the 1e-5 limit, the three-piece split the kernel uses holds it
  and stays within f32 summation noise of an f32 P (closer than two pieces).

Inputs are made with numpy from a seed and rounded to bf16 (the card's pool
dtype, so the plan is the tensor-core route's); JAX gets them in f32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import paged_attention as jax_pa
from k_llms_tpu_torch.ops import paged_attention as pa

LIMIT = 1e-5  # chip_smoke.py's K1 limit: absolute, on the f32 output


def _case(seed, R, n_per, QH, KVH, D, ps, plens, glens, *, NP=None, shared=True,
          phase_on=True, extra_gen_pages=1):
    """Kernel arguments as the engine lays them out: shared [R, NP] (or
    per-row [B, NP]) prefix tables whose tails point at the trash page 0,
    per-row gen pages continuing at phase plen % ps. bf16-valued tensors."""
    rng = np.random.default_rng(seed)
    B = R * n_per
    NP = NP or -(-max(plens) // ps)
    NG = -(-max(glens) // ps) + extra_gen_pages
    total = 1 + R * NP + B * NG
    perm = rng.permutation(total - 1).astype(np.int32) + 1
    prefix = perm[: R * NP].reshape(R, NP).copy()
    for r, p in enumerate(plens):
        prefix[r, -(-p // ps):] = 0
    gen = perm[R * NP: R * NP + B * NG].reshape(B, NG).copy()
    plen_row = np.repeat(np.asarray(plens, np.int32), n_per)
    if not shared:
        prefix = np.repeat(prefix, n_per, axis=0)
    phase = plen_row % ps if phase_on else np.zeros_like(plen_row)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    return (bf16(B, QH, D), bf16(total * ps, KVH, D), bf16(total * ps, KVH, D), t(prefix), t(gen),
            t(phase), bf16(B, KVH, D), bf16(B, KVH, D), t(plen_row), t(np.asarray(glens, np.int32)))


def _jax(args, ps, scale):
    q, pk, pv, prefix, gen, phase, nk, nv, plens, glens = args
    f = lambda x: jnp.asarray(x.float().numpy())  # noqa: E731
    i = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    return np.asarray(jax_pa.paged_decode_attention_pallas(
        f(q), f(pk), f(pv), i(prefix), i(gen), i(phase), f(nk), f(nv), i(plens), i(glens),
        page_size=ps, sm_scale=scale, interpret=True))


def _covered(items, b, kind):
    """Table pages each of row b's items of ``kind`` walks, with multiplicity."""
    return sorted(j for k, _, rows, _, pages in items if k == kind and b in rows for j in pages)


@pytest.mark.parametrize("B,R,KVH,NP,ps,plens,glens,phases", [
    (8, 1, 8, 32, 64, [1490] * 8, [16] * 8, [1490 % 64] * 8),  # the main path's shape
    (16, 2, 8, 32, 64, [1500] * 8 + [1437] * 8, [40] * 16, [1500 % 64] * 8 + [1437 % 64] * 8),
    (16, 16, 8, 24, 64, [1500] * 8 + [1437] * 8, [40] * 16, [0] * 16),  # per-row tables
    (6, 2, 2, 5, 16, [50, 48, 3, 37, 37, 0], [0, 7, 20, 3, 11, 19], [2, 0, 15, 5, 5, 0]),
    (4, 1, 1, 40, 8, [9, 17, 4, 30], [1, 0, 8, 13], [7, 1, 0, 6]),  # more splits than pages
])
def test_split_plan_covers_every_valid_page_once(B, R, KVH, NP, ps, plens, glens, phases):
    """Every prefix page with a valid slot for a row is in exactly one of
    that row's prefix items, every gen page with a valid slot in exactly one
    of its gen items, and no item reaches past the table."""
    NG = 3
    splits, items = pa.paged_work_items(B, R, 32, KVH, 128, NP, NG, ps, torch.bfloat16,
                                        plens, glens, phases)
    assert sum(k == "prefix" for k, *_ in items) == R * splits * -(-(B // R) // pa.paged_split_plan(
        B, R, 32, KVH, 128, NP, torch.bfloat16)[1])
    for b in range(B):
        valid_prefix = [j for j in range(NP) if j * ps < plens[b]]
        valid_gen = [j for j in range(NG) if glens[b] > 0 and j * ps - phases[b] < glens[b]
                     and (j + 1) * ps - phases[b] > 0]
        prefix_pages = _covered(items, b, "prefix")
        gen_pages = _covered(items, b, "gen")
        assert [j for j in prefix_pages if j in valid_prefix] == valid_prefix
        assert [j for j in gen_pages if j in valid_gen] == valid_gen
        assert all(j < NP for j in prefix_pages) and all(j < NG for j in gen_pages)
        # Each row's pages are walked by items of its own request or row.
        assert all(t == b // (B // R) for k, _, rows, t, _ in items if k == "prefix" and b in rows)


def test_split_plan_fills_the_card_at_the_main_path_shape():
    """One request of n = 8 rows (32 query heads on 8 kv heads, head dim 128)
    over the 1490-token prompt in its 2048 bucket: one CTA serves all 32
    query rows of a kv head, so each shared page is read once per request;
    the prefix splits give more than one CTA per SM, each with a whole page
    or more."""
    route, rpc, splits = pa.paged_split_plan(8, 1, 32, 8, 128, 32, torch.bfloat16)
    assert (route, rpc) == ("tc", 8)
    splits_, items = pa.paged_work_items(8, 1, 32, 8, 128, 32, 2, 64, torch.bfloat16,
                                         [1490] * 8, [16] * 8, [1490 % 64] * 8)
    assert splits_ == splits
    prefix_items = [pages for k, _, _, _, pages in items if k == "prefix"]
    assert len(prefix_items) * 8 >= 132 and len(items) * 8 >= 132
    assert min(len(pages) for pages in prefix_items) >= 1
    assert sorted(j for pages in prefix_items for j in pages) == list(range(24))
    # The other routes and shapes the engine gives the kernel.
    assert pa.paged_route(torch.float32, 128) == "simt" and pa.paged_route(torch.bfloat16, 16) == "simt"
    assert pa.paged_split_plan(16, 2, 32, 8, 128, 32, torch.bfloat16) == ("tc", 8, 9)
    assert pa.paged_split_plan(16, 16, 32, 8, 128, 24, torch.bfloat16) == ("tc", 1, 2)
    assert pa.paged_split_plan(16, 1, 32, 8, 128, 32, torch.bfloat16)[1] == 8  # n = 16: two chunks
    assert pa.paged_split_plan(12, 3, 4, 2, 16, 3, torch.float32) == ("simt", 4, 3)


# (seed, R, n_per, QH, KVH, D, ps, plens, glens, kwargs)
SPLIT_CASES = {
    # Rows of one request with different prompt lengths: pages past a
    # row's own length are masked for it; more splits than valid pages, so
    # some splits are empty; the gen phase lead-in and table tails point at
    # masked slots and the trash page.
    "masked_and_trash_splits": (0, 2, 3, 8, 1, 64, 16, [50, 37], [0, 7, 20, 3, 11, 19], {"NP": 6}),
    "prefix_shorter_than_a_split": (1, 1, 4, 8, 2, 64, 16, [5], [3, 0, 9, 1], {"NP": 4}),
    "per_row_tables": (2, 2, 3, 8, 2, 64, 8, [29, 44], [4, 12, 1, 0, 17, 6], {"shared": False}),
    "phase_zero_two_chunks": (3, 1, 16, 8, 2, 64, 16, [70], list(range(16)), {"phase_on": False}),
    "main_path_like": (4, 1, 8, 32, 8, 128, 64, [1490], [16] * 8, {"NP": 32}),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_merge_matches_pallas_and_plain(name):
    seed, R, n_per, QH, KVH, D, ps, plens, glens, kw = SPLIT_CASES[name]
    plens_in = [p for p in plens]
    glens_row = glens
    args = _case(seed, R, n_per, QH, KVH, D, ps, plens_in, glens_row, **kw)
    scale = 1.0 / math.sqrt(D)
    got = pa.paged_decode_attention_split(*args, page_size=ps, sm_scale=scale)
    plain = pa.paged_decode_attention_plain(*args, page_size=ps, sm_scale=scale)
    ref = _jax(args, ps, scale)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=LIMIT, rtol=0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=LIMIT, rtol=0)


def test_split_merge_bad_page_poisons_its_rows_alone():
    """A gen page id past the pool makes that row NaN; a shared prefix page
    id past the pool makes every row of its request NaN; other rows are
    unchanged."""
    ps = 16
    args = list(_case(5, 2, 3, 8, 2, 64, ps, [50, 37], [4, 7, 20, 3, 11, 19]))
    scale = 0.125
    good = pa.paged_decode_attention_split(*args, page_size=ps, sm_scale=scale)
    num_pages = args[1].shape[0] // ps
    gen = args[4].clone()
    gen[1, 0] = num_pages + 3
    out = pa.paged_decode_attention_split(*args[:4], gen, *args[5:], page_size=ps, sm_scale=scale)
    assert torch.isnan(out[1]).all() and not torch.isnan(out[[0, 2, 3, 4, 5]]).any()
    assert torch.equal(out[[0, 2, 3, 4, 5]], good[[0, 2, 3, 4, 5]])
    prefix = args[3].clone()
    prefix[1, 0] = -1
    out = pa.paged_decode_attention_split(*args[:3], prefix, *args[4:], page_size=ps, sm_scale=scale)
    assert torch.isnan(out[3:]).all() and torch.equal(out[:3], good[:3])


def test_dropped_split_or_boundary_off_by_one_page_breaks_the_limit():
    """The limit catches a merge that drops one split and a split boundary
    one page off (a page walked by no split), at the timed shape."""
    seed, R, n_per, QH, KVH, D, ps, plens, glens, kw = SPLIT_CASES["main_path_like"]
    args = _case(seed, R, n_per, QH, KVH, D, ps, plens, glens, **kw)
    scale = 1.0 / math.sqrt(D)
    ref = pa.paged_decode_attention_plain(*args, page_size=ps, sm_scale=scale)

    def dropped(n, k):
        ranges = pa.split_page_ranges(n, k)
        return [rg for i, rg in enumerate(ranges) if i != len(ranges) // 2]

    def off_by_one(n, k):
        ranges = pa.split_page_ranges(n, k)
        i = next(i for i in range(len(ranges) - 1) if ranges[i][1] - ranges[i][0] > 1)
        ranges[i] = (ranges[i][0], ranges[i][1] - 1)
        return ranges

    for mutant in (dropped, off_by_one):
        out = pa.paged_decode_attention_split(*args, page_size=ps, sm_scale=scale, page_ranges=mutant)
        assert (out - ref).abs().max().item() > 100 * LIMIT


@pytest.mark.parametrize("n", [0, 1, 5, 24, 31])
@pytest.mark.parametrize("splits", [1, 3, 17, 32])
def test_split_page_ranges_partition_the_pages(n, splits):
    ranges = pa.split_page_ranges(n, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


# --- the tensor-core kernel's P V -------------------------------------------

LOG2E = 1.4426950408889634


def _pv_tile_model(q, k, v, sm_scale, pieces, block=64):
    """paged_decode_tc's arithmetic for one split: bf16 q [rows, D] and k/v
    [n, D]; S in f32 (products of bf16 values are exact), the online softmax
    in log2 units one 64-slot block at a time, P split into ``pieces`` bf16
    pieces each multiplied into the f32 accumulator (0: P kept in f32, the
    reference's P). Returns out / l."""
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((q.shape[0], 1), -math.inf)
    l = torch.zeros((q.shape[0], 1))
    acc = torch.zeros((q.shape[0], q.shape[1]))
    for k0 in range(0, k.shape[0], block):
        s = qf @ kf[k0:k0 + block].T * (sm_scale * LOG2E)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        if pieces == 0:
            acc = acc + p @ vf[k0:k0 + block]
        rest = p
        for _ in range(pieces):
            piece = rest.to(torch.bfloat16).float()
            acc = acc + piece @ vf[k0:k0 + block]
            rest = rest - piece
        m = m_new
    return acc / l


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
def test_pv_rounding_three_bf16_pieces_hold_the_limit(q_scale):
    """32 query rows (n = 8 rows x G = 4) over a 1490-key prefix, unit
    normal K and V, q at unit scale (flat rows, as chip_smoke draws them) and
    at 4x (peaked rows): with one bf16 rounding of P the output is over the
    1e-5 limit; with the kernel's three pieces it is within it, as close to
    what an f32 P gives as the f32 sums' own order allows (under 0.15 of the
    limit), and closer than two pieces."""
    rng = np.random.default_rng(int(q_scale))
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)  # noqa: E731
    q, k, v = bf(32, 128), bf(1490, 128), bf(1490, 128)
    q = (q.float() * q_scale).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(128)
    ref = torch.softmax(q.double() @ k.double().T * scale, -1) @ v.double()
    out = {n: _pv_tile_model(q, k, v, scale, n).double() for n in (0, 1, 2, 3)}
    err = {n: (o - ref).abs().max().item() for n, o in out.items()}
    rep = {n: (out[n] - out[0]).abs().max().item() for n in (1, 2, 3)}
    assert err[1] > LIMIT
    assert err[3] <= LIMIT and err[0] <= LIMIT
    assert rep[3] <= 0.15 * LIMIT and rep[3] < rep[2] < rep[1]
