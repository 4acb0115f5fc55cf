"""K3's redesign (``csrc/decode_prefix.cu``): the split plan, the split and
merge, and the rounding of P on the tensor cores, on the CPU.

* The plan (``decode_prefix_split_plan``, ``split_key_blocks``, the
  functions the wrapper and the kernel follow; each CTA computes its key
  range from the prompt length as :func:`_kernel_key_range` does) covers
  every valid key of every request exactly once and puts at least 132 CTAs
  on the card at the main path's shape (one request of n = 8 rows, 32/8
  heads of 128, 1490 prompt tokens in a 2048 bucket).
* ``decode_prefix_attention_split``, the kernel's split and merge in plain
  PyTorch, is held against the JAX package's Pallas kernel in interpret mode
  at K3's card limit (atol = rtol = 2e-5 on out, m and l), with splits that
  hold only masked keys and a prompt shorter than one split; a dropped split
  or a split boundary one key block off breaks the limit.
* The tensor-core kernel's P V, modelled block by block over the plan's
  splits: one bf16 rounding of P breaks K3's limit at the main shape, and
  the two bf16 pieces the kernel uses hold it with at least 2x margin, on
  flat and on peaked rows.

Inputs are made with numpy from a seed. Every P handed to the JAX kernel is
a multiple of its 32-key block, as in tests/test_torch_decode_prefix.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import attention as jax_att
from k_llms_tpu_torch.ops import attention as att

TOL = dict(atol=2e-5, rtol=2e-5)  # chip_smoke.py's K3 limit, per element
BLOCK = att.PREFIX_KEY_BLOCK


def _over(got, ref):
    """Largest |got - ref| / (2e-5 |ref| + 2e-5) over out, m and l."""
    return max(((g.double() - r.double()).abs() / (2e-5 * r.double().abs() + 2e-5)).max().item()
               for g, r in zip(got, ref))


def _kernel_key_range(plen, P, z, splits):
    """Keys [begin, end) that CTA split ``z`` walks: the kernel's make_work,
    line for line."""
    plen = min(max(plen, 0), P)
    nb = (plen + BLOCK - 1) // BLOCK
    lo, hi = z * nb // splits, (z + 1) * nb // splits
    return lo * BLOCK, min(hi * BLOCK, plen)


def _inputs(seed, R, n_per, QH, KVH, P, D, *, bf16=False, q_scale=1.0):
    rng = np.random.default_rng(seed)
    t = [rng.standard_normal(s, dtype=np.float32)
         for s in ((R * n_per, QH, D), (R, P, KVH, D), (R, P, KVH, D))]
    t[0] *= q_scale
    t = [torch.from_numpy(x) for x in t]
    return [x.to(torch.bfloat16) for x in t] if bf16 else t


@pytest.mark.parametrize("R,n_per,QH,KVH,D,P,plens", [
    (1, 8, 32, 8, 128, 2048, [1490]),  # the main path's shape
    (2, 8, 32, 8, 128, 2048, [1500, 437]),
    (1, 16, 32, 8, 128, 512, [300]),  # two row tiles
    (3, 4, 4, 2, 16, 96, [45, 1, 96]),
    (1, 2, 4, 2, 64, 256, [5]),  # more splits than valid blocks
    (4, 1, 8, 1, 64, 64, [64, 63, 1, 17]),
])
def test_split_plan_covers_every_valid_key_once(R, n_per, QH, KVH, D, P, plens):
    """Each request's splits walk its valid keys [0, plen) exactly once, in
    order, in ranges of whole key blocks (but the prompt's last), computed
    from the prompt length alone; ``split_key_blocks`` is the same cut."""
    B = R * n_per
    route, tiles, splits = att.decode_prefix_split_plan(B, R, QH, KVH, D, P, torch.bfloat16)
    assert tiles == -(-n_per * (QH // KVH) // 32) and 1 <= splits <= -(-P // BLOCK)
    for plen in plens:
        ranges = [_kernel_key_range(plen, P, z, splits) for z in range(splits)]
        covered = [k for lo, hi in ranges for k in range(lo, hi)]
        assert covered == list(range(plen))
        assert all(lo % BLOCK == 0 for lo, hi in ranges if hi > lo)
        nb = -(-plen // BLOCK)
        assert [(lo * BLOCK, min(hi * BLOCK, plen)) for lo, hi in att.split_key_blocks(nb, splits)] \
            == ranges


@pytest.mark.parametrize("n_blocks", [0, 1, 5, 24, 32])
@pytest.mark.parametrize("splits", [1, 3, 17, 32])
def test_split_key_blocks_partition_the_blocks(n_blocks, splits):
    ranges = att.split_key_blocks(n_blocks, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == n_blocks
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


def test_split_plan_fills_the_card_at_the_main_path_shape():
    """One CTA serves all 32 query rows of a (request, kv head), so each
    prefix key is read once per request; 17 key splits put 136 CTAs on the
    132 SMs, each walking at least one of the 24 valid key blocks."""
    route, tiles, splits = att.decode_prefix_split_plan(8, 1, 32, 8, 128, 2048, torch.bfloat16)
    assert (route, tiles, splits) == ("tc", 1, 17)
    assert 1 * tiles * 8 * splits >= 132
    ranges = [_kernel_key_range(1490, 2048, z, splits) for z in range(splits)]
    assert min(hi - lo for lo, hi in ranges) >= BLOCK
    # The other routes and shapes the engine and the tests give the kernel.
    assert att.decode_prefix_route(torch.float32, 128) == "simt"
    assert att.decode_prefix_route(torch.bfloat16, 16) == "simt"
    assert [att.decode_prefix_route(torch.bfloat16, d) for d in (64, 128, 256)] == ["tc"] * 3
    assert att.decode_prefix_split_plan(16, 2, 32, 8, 128, 2048, torch.bfloat16) == ("tc", 1, 9)
    assert att.decode_prefix_split_plan(16, 1, 32, 8, 128, 512, torch.bfloat16) == ("tc", 2, 8)
    assert att.decode_prefix_split_plan(8, 1, 32, 8, 128, 64, torch.bfloat16) == ("tc", 1, 1)
    assert att.decode_prefix_split_plan(12, 3, 4, 2, 16, 96, torch.float32) == ("simt", 1, 2)


# (seed, R, n_per, QH, KVH, P, plens)
SPLIT_CASES = {
    # 17 splits over one block: 16 hold only masked keys (or none at all).
    "prompt_shorter_than_a_split": (0, 1, 8, 32, 8, 1088, [40]),
    # More splits than valid blocks in one request, all blocks in the other.
    "masked_splits_ragged": (1, 2, 4, 4, 2, 320, [7, 320]),
    "mid_block_prompts": (2, 3, 4, 4, 2, 96, [45, 1, 96]),
    "main_heads_two_requests": (3, 2, 8, 32, 8, 640, [640, 131]),
    "two_row_tiles": (4, 1, 16, 32, 8, 512, [300]),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_merge_matches_jax_kernel(name):
    seed, R, n_per, QH, KVH, P, plens = SPLIT_CASES[name]
    D = 16
    q, pk, pv = _inputs(seed, R, n_per, QH, KVH, P, D)
    lens = torch.tensor(plens, dtype=torch.int32)
    ref = jax_att.decode_prefix_attention(
        jnp.asarray(q.numpy()), jnp.asarray(pk.numpy()), jnp.asarray(pv.numpy()),
        jnp.asarray(lens.numpy()), sm_scale=0.25, block_k=32, interpret=True,
    )
    got = att.decode_prefix_attention_split(q, pk, pv, lens, sm_scale=0.25)
    for label, g, r in zip(("out", "m", "l"), got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape, label
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=label, **TOL)


def test_dropped_split_or_boundary_off_by_one_block_breaks_the_limit():
    """At the main path's shape, a merge that drops one split and a split
    boundary one key block off (a block walked by no split) each break
    K3's limit, where the plan's own split holds it."""
    q, pk, pv = _inputs(5, 1, 8, 32, 8, 2048, 128, bf16=True)
    lens = torch.tensor([1490], dtype=torch.int32)
    scale = 1.0 / math.sqrt(128)
    ref = att.decode_prefix_attention_plain(q, pk, pv, lens, sm_scale=scale)

    def dropped(n, k):
        ranges = att.split_key_blocks(n, k)
        return [rg for i, rg in enumerate(ranges) if i != len(ranges) // 2]

    def off_by_one(n, k):
        ranges = att.split_key_blocks(n, k)
        i = next(i for i in range(len(ranges) - 1) if ranges[i][1] - ranges[i][0] > 1)
        ranges[i] = (ranges[i][0], ranges[i][1] - 1)
        return ranges

    assert _over(att.decode_prefix_attention_split(q, pk, pv, lens, sm_scale=scale), ref) <= 1.0
    for mutant in (dropped, off_by_one):
        got = att.decode_prefix_attention_split(q, pk, pv, lens, sm_scale=scale, block_ranges=mutant)
        assert _over(got, ref) > 100.0


# --- the tensor-core kernel's P V -------------------------------------------

LOG2E = 1.4426950408889634


def _tc_model(q, k, v, plen, sm_scale, pieces, splits):
    """decode_prefix_tc's arithmetic for one (request, kv head): bf16 q
    [rows, D] and k/v [P, D]; per split, S in f32 (products of bf16 values
    are exact), the online softmax in log2 units one 64-key block at a time,
    P split into ``pieces`` bf16 pieces each multiplied into the f32
    accumulator, l from the f32 P; then decode_prefix_merge. Returns
    (out, m, l)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = q.shape[0]
    parts = []
    for z in range(splits):
        lo, hi = _kernel_key_range(plen, k.shape[0], z, splits)
        m = torch.full((rows, 1), -math.inf)
        l = torch.zeros((rows, 1))
        acc = torch.zeros((rows, q.shape[1]))
        for k0 in range(lo, hi, BLOCK):
            k1 = min(k0 + BLOCK, hi)
            s = qf @ kf[k0:k1].T * (sm_scale * LOG2E)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha
            rest = p
            for _ in range(pieces):
                piece = rest.to(torch.bfloat16).float()
                acc = acc + piece @ vf[k0:k1]
                rest = rest - piece
            m = m_new
        parts.append((acc, m, l))
    m = torch.stack([pm for _, pm, _ in parts]).amax(0)
    w = [torch.where(pm == -math.inf, torch.zeros_like(pm), torch.exp2(pm - m)) for _, pm, _ in parts]
    acc = sum(wz * po for wz, (po, _, _) in zip(w, parts))
    l = sum(wz * pl for wz, (_, _, pl) in zip(w, parts))
    return acc / l, (m / LOG2E)[:, 0], l[:, 0]


@pytest.mark.parametrize("q_scale", [1.0, 4.0], ids=["flat_rows", "peaked_rows"])
def test_pv_rounding_two_bf16_pieces_hold_the_limit_with_margin(q_scale):
    """32 query rows (n = 8 rows x G = 4) over a 1490-key prefix in its
    2048 bucket, split as the plan splits it, unit normal K and V, q at unit
    scale (flat rows, as chip_smoke draws them) and at 4x (peaked rows):
    with one bf16 rounding of P the output breaks K3's limit; with the
    kernel's two pieces it stays under half of it."""
    rng = np.random.default_rng(int(q_scale))
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)  # noqa: E731
    q, k, v = bf(32, 128), bf(2048, 128), bf(2048, 128)
    q = (q.float() * q_scale).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(128)
    _, _, splits = att.decode_prefix_split_plan(8, 1, 32, 8, 128, 2048, torch.bfloat16)
    s = q.double() @ k[:1490].double().T * scale
    m_ref = s.amax(-1)
    p = torch.exp(s - m_ref[:, None])
    ref = ((p @ v[:1490].double()) / p.sum(-1, keepdim=True), m_ref, p.sum(-1))
    over = {n: _over(_tc_model(q, k, v, 1490, scale, n, splits), ref) for n in (1, 2)}
    assert over[1] > 1.0
    assert over[2] <= 0.5
