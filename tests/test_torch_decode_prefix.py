"""Shared-prefix decode attention (kernel K3): the port's plain version held
against the JAX package's Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages in f32,
over the grid of the JAX package's own test (tests/test_ops.py) plus ragged
prompt lengths. out, m and l are each compared at atol 2e-5 and rtol 2e-5,
the JAX test's bound (f32 sums in another order; l grows with the number of
keys, hence the relative part). Every P is a multiple of the JAX kernel's
key block, as the engine's power-of-two buckets are: past the last whole
block the Pallas kernel reads padding, and in interpret mode a NaN there
reaches its output through 0 * NaN. The CUDA kernel itself is held against
its plain version on a card (P not a multiple of its key block included), in
test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.ops import attention as jax_att
from k_llms_tpu_torch.ops import _ext
from k_llms_tpu_torch.ops import attention as att

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, R, n_per, QH, KVH, P, D, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R * n_per, QH, D), dtype=np.float32)
    pk = rng.standard_normal((R, P, KVH, D), dtype=np.float32)
    pv = rng.standard_normal((R, P, KVH, D), dtype=np.float32)
    if lens is None:
        lens = rng.integers(1, P + 1, size=R)
    return q, pk, pv, np.asarray(lens, np.int32)


@pytest.mark.parametrize(
    "R,n_per,QH,KVH,P,lens",
    [
        (1, 8, 4, 2, 32, None),
        (4, 2, 8, 2, 64, None),
        (2, 4, 4, 4, 160, None),
        (3, 4, 4, 2, 96, [1, 96, 45]),  # ragged: one key, a full prefix, mid-block
        (2, 8, 32, 8, 128, [128, 51]),  # Llama-3-8B heads at n=8
    ],
)
def test_decode_prefix_matches_jax_kernel(R, n_per, QH, KVH, P, lens):
    D = 16
    q, pk, pv, lens = _inputs(R * 100 + P, R, n_per, QH, KVH, P, D, lens)
    ref = jax_att.decode_prefix_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lens),
        sm_scale=0.25, block_k=32, interpret=True,
    )
    before = dict(_ext.LAUNCH_COUNTS)
    got = att.decode_prefix_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv), torch.from_numpy(lens),
        sm_scale=0.25,
    )
    assert _ext.LAUNCH_COUNTS == before  # CPU tensors run the plain version
    for name, g, r in zip(("out", "m", "l"), got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_keys_past_the_prompt_do_not_matter():
    """Values past each prompt length (the bucket padding of the dense
    prefix) change none of out, m, l."""
    q, pk, pv, lens = _inputs(7, 2, 4, 4, 2, 64, 16, [20, 33])
    args = (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv), torch.from_numpy(lens))
    base = att.decode_prefix_attention(*args)
    pk2, pv2 = args[1].clone(), args[2].clone()
    pk2[0, 20:] = 1e4
    pv2[1, 33:] = -1e4
    moved = att.decode_prefix_attention(args[0], pk2, pv2, args[3])
    for b, m in zip(base, moved):
        torch.testing.assert_close(m, b, atol=0, rtol=0)


def test_m_and_l_merge_back_to_one_softmax():
    """(out, m, l) of two halves of the keys merged by logsumexp equal one
    softmax over all keys: the contract the decode step's merge relies on."""
    q, pk, pv, _ = _inputs(11, 1, 8, 4, 2, 64, 16, [64])
    q, pk, pv = torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv)
    full = att.decode_prefix_attention_plain(q, pk, pv, torch.tensor([64]))
    a = att.decode_prefix_attention_plain(q, pk[:, :40], pv[:, :40], torch.tensor([40]))
    b = att.decode_prefix_attention_plain(q, pk[:, 40:], pv[:, 40:], torch.tensor([24]))
    m = torch.maximum(a[1], b[1])
    wa, wb = a[2] * torch.exp(a[1] - m), b[2] * torch.exp(b[1] - m)
    out = (a[0] * wa[..., None] + b[0] * wb[..., None]) / (wa + wb)[..., None]
    torch.testing.assert_close(out, full[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(m, full[1], atol=0, rtol=0)
    torch.testing.assert_close(wa + wb, full[2], atol=1e-5, rtol=1e-6)
