"""Prefill flash attention (kernel K2): the port's plain version held against
the JAX package's Pallas kernel (interpret mode) and its XLA reference.

Inputs are made with numpy from a seed and handed to both packages in f32;
the tolerance is atol 1e-5 (f32 sums in another order). The CUDA kernel
itself is held against its plain version on a card, in
test_torch_kernels_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import attention as jax_att
from k_llms_tpu_torch.ops import _ext
from k_llms_tpu_torch.ops import attention as att

ATOL = 1e-5



def _inputs(seed, B, QH, KVH, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, QH, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, KVH, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, KVH, Sk, D), dtype=np.float32)
    return q, k, v


# (name, B, QH, KVH, Sq, Sk, key_lengths, extra kwargs)
CASES = [
    ("causal", 1, 4, 4, 32, 32, None, {}),
    ("key_lengths_gqa", 2, 8, 2, 32, 32, [32, 19], {}),
    ("non_block_multiple_all_masked_row", 2, 4, 2, 37, 37, [37, 0], {}),
    ("q_offset", 1, 4, 2, 16, 48, [48], {"q_offset": 32}),
    ("window", 2, 4, 2, 48, 48, [48, 40], {"window": 8}),
    ("softcap", 1, 4, 2, 32, 32, [30], {"softcap": 5.0}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(case):
    name, B, QH, KVH, Sq, Sk, lens, extra = case
    D = 16
    q, k, v = _inputs(len(name), B, QH, KVH, Sq, Sk, D)
    scale = 1.0 / math.sqrt(D)
    ref = jax_att.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        key_lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
        sm_scale=scale, block_q=16, block_k=16, interpret=True, **extra,
    )
    out = att.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        key_lengths=None if lens is None else torch.tensor(lens, dtype=torch.int32),
        sm_scale=scale, **extra,
    )
    assert out.dtype == torch.float32 and out.shape == (B, QH, Sq, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if lens is not None and lens[-1] == 0:  # a row with no valid key is zeros
        assert not out[-1].any()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_attention_xla(causal):
    """Against the XLA reference (explicit masked softmax) where every query
    row has a valid key; the port's own attention_xla agrees as well."""
    B, QH, KVH, S, D = 2, 8, 2, 24, 16
    q, k, v = _inputs(7 + causal, B, QH, KVH, S, S, D)
    lens = np.array([24, 17], np.int32)
    key_mask = np.arange(S)[None, :] < lens[:, None]
    ref = jax_att.attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        key_mask=jnp.asarray(key_mask),
    )
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = att.flash_attention_plain(tq, tk, tv, causal=causal, key_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    port_xla = att.attention_xla(tq, tk, tv, causal=causal, key_mask=torch.from_numpy(key_mask))
    np.testing.assert_allclose(port_xla.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 20, 20, 16))
    before = dict(_ext.LAUNCH_COUNTS)
    out = att.flash_attention(q, k, v, key_lengths=torch.tensor([15], dtype=torch.int32))
    ref = att.flash_attention_plain(q, k, v, key_lengths=torch.tensor([15], dtype=torch.int32))
    assert torch.equal(out, ref)
    assert _ext.LAUNCH_COUNTS == before


def test_plain_keeps_bf16_output_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(5, 1, 4, 2, 16, 16, 16))
    assert att.flash_attention_plain(q, k, v).dtype == torch.bfloat16
