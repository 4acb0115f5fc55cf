"""The arithmetic of K2's tensor-core kernel (``csrc/flash_attention.cu``,
``flash_attention_tc``), modelled tile by tile in torch on the CPU and held
to the limit that ``chip_smoke.py`` holds the kernel to on the card.

The kernel multiplies bf16 operands into f32 accumulators. Q K^T is exact
up to summation order (products of bf16 values are exact in f32). The
online softmax runs in f32, one 64-key tile at a time, in log2 units. P
stays f32 in the Pallas kernel; the kernel splits it into P_hi = bf16(P)
and P_lo = bf16(P - P_hi) and multiplies both into the f32 P V
accumulator. The model below does the same, and this file shows:

* the model meets the card's bf16 limit, |out - ref| <= 2**-6 |ref| + 1e-5
  per element, against ``flash_attention_plain`` and against the JAX
  package's Pallas ``flash_attention`` (interpret mode, as the JAX tests
  run it), on seeded numpy inputs;
* rounding P to bf16 once instead breaks that limit, so the split is
  needed.

Inputs are made with numpy, rounded to bf16, and handed to both packages.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import attention as jax_att
from k_llms_tpu_torch.ops import attention as att

LOG2E = 1.4426950408889634
# chip_smoke.py's K2 limit for bf16 outputs: two bf16 ulps of |ref| plus an
# absolute floor for the f32 summation order.
RTOL, ATOL = 2.0 ** -6, 1e-5


def flash_tile_model(q, k, v, key_lengths, *, causal=True, softcap=None, window=None,
                     q_offset=None, split_p=True, block_n=64):
    """K2's tensor-core kernel, tile by tile: bf16 q/k/v [B, H, S, D] in,
    bf16 out. ``split_p=False`` rounds P to bf16 once."""
    B, QH, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = QH // KVH
    scale = 1.0 / math.sqrt(D)
    window = att.NO_WINDOW if window is None else window
    q_offset = 0 if q_offset is None else q_offset
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    valid = att._flash_valid(B, Sq, Sk, key_lengths, causal, window, q_offset, q.device)
    m = torch.full((B, QH, Sq, 1), -math.inf)
    l = torch.zeros((B, QH, Sq, 1))
    acc = torch.zeros((B, QH, Sq, D))
    for k0 in range(0, Sk, block_n):
        x = qf @ kf[:, :, k0:k0 + block_n].transpose(-1, -2) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = torch.where(valid[..., k0:k0 + block_n], x * LOG2E, torch.tensor(-math.inf))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vt = vf[:, :, k0:k0 + block_n]
        p_hi = p.to(torch.bfloat16).float()
        if split_p:
            pv = p_hi @ vt + (p - p_hi).to(torch.bfloat16).float() @ vt
        else:
            pv = p_hi @ vt
        acc = acc * alpha + pv
        m = m_new
    out = torch.where(m == -math.inf, torch.zeros_like(acc), acc / l)
    return out.to(torch.bfloat16)


def over_limit(out, ref):
    """Largest |out - ref| / (RTOL |ref| + ATOL) over the elements."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (RTOL * ref.abs() + ATOL)).max().item()


def _inputs(seed, B, QH, KVH, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
        for shape in ((B, QH, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D))
    )


# (name, B, QH, KVH, Sq, Sk, D, key_lengths, extra): ragged 64-row and
# 64-key tiles, GQA, an all-masked row, q_offset with Sq != Sk, window and
# softcap, both head dims of the main configs.
CASES = [
    ("causal_d128", 1, 4, 2, 130, 130, 128, [130], {}),
    ("key_lengths_all_masked_row_d64", 2, 4, 2, 100, 100, 64, [77, 0], {}),
    ("q_offset_d64", 1, 4, 2, 70, 200, 64, [190], {"q_offset": 130}),
    ("window_softcap_d128", 1, 4, 1, 150, 150, 128, [150], {"window": 40, "softcap": 20.0}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_p_model_meets_the_limit_against_plain(case):
    name, B, QH, KVH, Sq, Sk, D, lens, extra = case
    q, k, v = _inputs(len(name), B, QH, KVH, Sq, Sk, D)
    kl = torch.tensor(lens, dtype=torch.int32)
    out = flash_tile_model(q, k, v, kl, **extra)
    ref = att.flash_attention_plain(q, k, v, key_lengths=kl, **extra)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert over_limit(out, ref) <= 1.0
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_split_p_model_meets_the_limit_against_jax(case):
    """Against the Pallas kernel itself (interpret mode, 64-row and 64-key
    blocks) on the same bf16 inputs: both round one f32 result to bf16."""
    name, B, QH, KVH, Sq, Sk, D, lens, extra = case
    q, k, v = _inputs(len(name), B, QH, KVH, Sq, Sk, D)
    kl = torch.tensor(lens, dtype=torch.int32)
    out = flash_tile_model(q, k, v, kl, **extra)
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    ref = jax_att.flash_attention(
        to_jax(q), to_jax(k), to_jax(v), causal=True, key_lengths=jnp.asarray(lens, jnp.int32),
        sm_scale=1.0 / math.sqrt(D), block_q=64, block_k=64, interpret=True, **extra,
    )
    assert ref.dtype == jnp.bfloat16
    assert over_limit(out, torch.from_numpy(np.asarray(ref.astype(jnp.float32)))) <= 1.0


@pytest.mark.parametrize("case", CASES[::3], ids=[c[0] for c in CASES[::3]])
def test_single_rounding_of_p_breaks_the_limit(case):
    """Rounding P to bf16 once (2**-9 relative) misses outputs that nearly
    cancel by far more than the limit allows: the reason for the split."""
    name, B, QH, KVH, Sq, Sk, D, lens, extra = case
    q, k, v = _inputs(len(name), B, QH, KVH, Sq, Sk, D)
    kl = torch.tensor(lens, dtype=torch.int32)
    ref = att.flash_attention_plain(q, k, v, key_lengths=kl, **extra)
    assert over_limit(flash_tile_model(q, k, v, kl, split_p=False, **extra), ref) > 2.0
    assert over_limit(flash_tile_model(q, k, v, kl, **extra), ref) <= 1.0


def test_flash_route_picks_tensor_cores_for_bf16():
    """The route is a pure function of dtype and head dim: bf16 at the
    tensor-core kernel's head dims, the f32 CUDA-core kernel otherwise (f32
    inputs keep full f32 products)."""
    for d in (64, 128, 256):
        assert att.flash_route(torch.bfloat16, d) == "tc"
        assert att.flash_route(torch.float32, d) == "simt"
    assert att.flash_route(torch.bfloat16, 16) == "simt"
    assert att.flash_route(torch.float32, 16) == "simt"
