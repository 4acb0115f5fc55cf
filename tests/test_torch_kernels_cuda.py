"""The port's CUDA kernels held against their plain PyTorch versions on a card.

These tests need an NVIDIA card (a CUDA kernel has no interpret mode); each
decides inside a fixture whether there is one and skips without it. The
file imports neither JAX nor the JAX package, so the machine with the card,
which has no JAX, runs it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.models.llama import init_params
from k_llms_tpu_torch.ops import _ext
from k_llms_tpu_torch.ops import attention as att
from k_llms_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -6)])
def test_flash_kernel_matches_plain(cuda_device, dtype, rtol):
    """Key lengths with an all-masked row, q_offset, window + softcap, the
    embeddings forward's ragged batch, every instantiated head dim. Both
    compute in f32 and round the output once, so bf16 outputs differ by at
    most one ulp: per element |out - ref| <= rtol |ref| + 1e-5, where rtol
    is two bf16 ulps (0 in f32)."""
    cases = [
        (2, 32, 8, 300, 300, 128, [300, 0], {}),
        (1, 32, 8, 100, 400, 128, [400], {"q_offset": 300}),
        (1, 8, 4, 130, 130, 256, [129], {"window": 33, "softcap": 30.0}),
        (8, 32, 8, 96, 96, 128, [96, 81, 50, 7, 1, 0, 0, 0], {}),
        (1, 4, 2, 77, 77, 16, [70], {}),
        (2, 14, 2, 65, 65, 64, [65, 9], {}),
    ]
    rng = np.random.default_rng(0)
    before = _ext.LAUNCH_COUNTS["flash_attention"]
    for B, QH, KVH, Sq, Sk, D, lens, extra in cases:
        q = _normal(rng, B, QH, Sq, D).to(cuda_device, dtype)
        k = _normal(rng, B, KVH, Sk, D).to(cuda_device, dtype)
        v = _normal(rng, B, KVH, Sk, D).to(cuda_device, dtype)
        kl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        out = att.flash_attention(q, k, v, key_lengths=kl, **extra)
        ref = att.flash_attention_plain(q, k, v, key_lengths=kl, **extra)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        ref = ref.float()
        assert ((out.float() - ref).abs() <= rtol * ref.abs() + 1e-5).all()
        for b, n in enumerate(lens):
            if n == 0:
                assert not out[b].any()
    assert _ext.LAUNCH_COUNTS["flash_attention"] == before + len(cases)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, shared):
    """A shared [R, NP] (or per-row) prefix table with trash-page tails,
    phase-shifted gen pages, ragged lengths; both accumulate in f32 and
    return f32, so they agree to 1e-5 at unit-scale inputs."""
    rng = np.random.default_rng(1)
    ps, R, n_per, QH, KVH, D = 16, 2, 3, 32, 8, 128
    B = R * n_per
    plens = np.array([50, 37], np.int32)
    glens = np.array([0, 7, 20, 3, 11, 19], np.int32)
    NP, NG = 5, 3
    total = 1 + R * NP + B * NG
    perm = rng.permutation(total - 1).astype(np.int32) + 1
    prefix = perm[: R * NP].reshape(R, NP).copy()
    for r, p in enumerate(plens):
        prefix[r, -(-p // ps):] = 0
    gen = perm[R * NP:].reshape(B, NG)
    if not shared:
        prefix = np.repeat(prefix, n_per, axis=0)
    plen_row = np.repeat(plens, n_per)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    pool_k = _normal(rng, total * ps, KVH, D).to(cuda_device, dtype)
    pool_v = _normal(rng, total * ps, KVH, D).to(cuda_device, dtype)
    q = _normal(rng, B, QH, D).to(cuda_device, dtype)
    nk = _normal(rng, B, KVH, D).to(cuda_device, dtype)
    nv = _normal(rng, B, KVH, D).to(cuda_device, dtype)
    args = (q, pool_k, pool_v, on(prefix), on(gen), on(plen_row % ps), nk, nv,
            on(plen_row), on(glens))
    kw = dict(page_size=ps, sm_scale=1 / math.sqrt(D))
    before = _ext.LAUNCH_COUNTS["paged_decode_attention"]
    out = pa.paged_decode_attention(*args, **kw)
    ref = pa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (B, QH, D)
    assert (out - ref).abs().max().item() <= 1e-5
    assert _ext.LAUNCH_COUNTS["paged_decode_attention"] == before + 1

    # A page id past the pool's end is never read: its row comes out NaN
    # (the engine quarantines it) and every other row is unchanged. The
    # plain version is not run on this table: it would index past the pool.
    bad = gen.copy()
    bad[1, 0] = total + 5
    out_bad = pa.paged_decode_attention(q, pool_k, pool_v, on(prefix), on(bad), *args[5:], **kw)
    torch.cuda.synchronize()
    assert torch.isnan(out_bad[1]).all()
    others = torch.arange(B, device=cuda_device) != 1
    assert (out_bad[others] - ref[others]).abs().max().item() <= 1e-5


def test_tiny_greedy_tokens_through_kernels_equal_plain_paths(cuda_device):
    """tiny in fp32 on the card: the engine through both kernels (flash
    prefill, paged decode) and through the plain reference paths emits the
    same greedy tokens."""
    tiny = get_config("tiny")
    params = init_params(tiny, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    prompt = ByteTokenizer().apply_chat_template([{"role": "user", "content": "total due 41.20 EUR"}])
    outs = []
    for cfg, impl in ((tiny.with_(attention_impl="flash"), "cuda"), (tiny, "xla")):
        eng = LocalEngine(cfg, params=params, device=cuda_device, paged_attention_impl=impl,
                          kv_page_size=16)
        _ext.reset_launch_counts()
        outs.append(eng.generate(prompt, n=3, seed=1, max_new_tokens=24, temperature=0.0))
        counts = dict(_ext.LAUNCH_COUNTS)
        if impl == "cuda":
            assert min(counts.values()) > 0
        else:
            assert max(counts.values()) == 0
    np.testing.assert_array_equal(outs[0].tokens, outs[1].tokens)
    np.testing.assert_allclose(outs[0].logprobs, outs[1].logprobs, atol=1e-4, rtol=0)
