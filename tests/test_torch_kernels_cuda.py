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


# (B, QH, KVH, Sq, Sk, D, key_lengths, extra): query counts that leave the
# last query tile (64 or 128 rows) ragged, q_offset with Sq != Sk, window + softcap, and an
# all-masked row, at both head dims the main configs use.
TC_RAGGED = [
    (1, 8, 2, 65, 65, 64, [65], {}),
    (1, 8, 2, 65, 65, 128, [60], {}),
    (1, 8, 2, 1000, 1000, 128, [1000], {}),
    (2, 8, 2, 1000, 1000, 64, [1000, 0], {}),
    (1, 8, 2, 65, 1000, 128, [1000], {"q_offset": 935}),
    (1, 8, 2, 1000, 1500, 64, [1400], {"q_offset": 500}),
    (1, 8, 2, 1000, 1000, 128, [990], {"window": 100, "softcap": 30.0}),
    (2, 8, 2, 65, 65, 64, [65, 40], {"window": 17, "softcap": 20.0}),
]


@pytest.mark.parametrize("case", TC_RAGGED, ids=[f"case{i}" for i in range(len(TC_RAGGED))])
def test_flash_tc_ragged_tiles_match_plain(cuda_device, case):
    """The bf16 tensor-core kernel at ragged query tiles, held to the same
    limit as every K2 case: |out - ref| <= 2**-6 |ref| + 1e-5 per element
    (two bf16 ulps; P is split into two bf16 halves, so only the output's
    single rounding and the f32 sum order differ from the plain version)."""
    B, QH, KVH, Sq, Sk, D, lens, extra = case
    assert att.flash_route(torch.bfloat16, D) == "tc"
    rng = np.random.default_rng(Sq + D)
    q = _normal(rng, B, QH, Sq, D).to(cuda_device, torch.bfloat16)
    k = _normal(rng, B, KVH, Sk, D).to(cuda_device, torch.bfloat16)
    v = _normal(rng, B, KVH, Sk, D).to(cuda_device, torch.bfloat16)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = _ext.LAUNCH_COUNTS["flash_attention"]
    out = att.flash_attention(q, k, v, key_lengths=kl, **extra)
    ref = att.flash_attention_plain(q, k, v, key_lengths=kl, **extra).float()
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["flash_attention"] == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert ((out.float() - ref).abs() <= 2.0 ** -6 * ref.abs() + 1e-5).all()
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()


def _over_k2_limit(out, ref):
    return ((out.float() - ref.float()).abs() / (2.0 ** -6 * ref.float().abs() + 1e-5)).max().item()


@pytest.mark.parametrize("p", [1408, 1401], ids=["p_tile_multiple", "p_off_tile"])
@pytest.mark.parametrize("Sq", [32, 64, 128])
def test_flash_tc_continuation_shapes_match_plain(cuda_device, Sq, p):
    """A prefix-cache continuation's shapes in the model: an Sq-row suffix
    bucket (32-128 rows, fewer than one 128-row query tile) at q_offset p,
    against the 2048-key continuation bucket, key length p plus the suffix's
    valid rows. Held to K2's limit, |out - ref| <= 2**-6 |ref| + 1e-5; a
    query offset one key late and a dropped block of 32 prefix keys must
    each break it."""
    rng = np.random.default_rng(Sq * 7 + p)
    Sk, valid = 2048, p + Sq - 7
    q = _normal(rng, 1, 32, Sq, 128).to(cuda_device, torch.bfloat16)
    k = _normal(rng, 1, 8, Sk, 128).to(cuda_device, torch.bfloat16)
    v = _normal(rng, 1, 8, Sk, 128).to(cuda_device, torch.bfloat16)
    kl = torch.tensor([valid], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, key_lengths=kl, q_offset=p)
    out = att.flash_attention(q, k, v, **kw)
    ref = att.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _over_k2_limit(out, ref) <= 1.0
    late = att.flash_attention_plain(q, k, v, **dict(kw, q_offset=p + 1))
    assert _over_k2_limit(late, ref) > 1.0
    keep = att._flash_valid(1, Sq, Sk, kl, True, att.NO_WINDOW, p, cuda_device)
    keep[..., p // 2: p // 2 + 32] = False
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float().repeat_interleave(4, dim=1))
    s = torch.where(keep, s / math.sqrt(128), torch.full_like(s, att.NEG_INF))
    dropped = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                           v.float().repeat_interleave(4, dim=1)).to(torch.bfloat16)
    assert _over_k2_limit(dropped, ref) > 1.0


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
            assert counts["flash_attention"] > 0 and counts["paged_decode_attention"] > 0
        else:
            assert max(counts.values()) == 0
    np.testing.assert_array_equal(outs[0].tokens, outs[1].tokens)
    np.testing.assert_allclose(outs[0].logprobs, outs[1].logprobs, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_prefix_kernel_matches_plain(cuda_device, dtype):
    """One request and ragged requests, P not a multiple of the kernel's
    64-key block, two 32-row query tiles, every instantiated head dim. Both
    compute in f32 from the same inputs: out, m and l agree per element to
    2e-5 |ref| + 2e-5."""
    cases = [
        (1, 8, 32, 8, 128, 2048, [1490]),
        (2, 8, 32, 8, 128, 130, [130, 51]),
        (1, 16, 32, 8, 128, 300, [299]),
        (3, 4, 4, 2, 16, 96, [45, 1, 96]),
        (2, 8, 4, 2, 64, 128, [77, 128]),
        (1, 8, 8, 4, 256, 200, [129]),
    ]
    rng = np.random.default_rng(2)
    before = _ext.LAUNCH_COUNTS["decode_prefix_attention"]
    for R, n_per, QH, KVH, D, P, lens in cases:
        q = _normal(rng, R * n_per, QH, D).to(cuda_device, dtype)
        pk = _normal(rng, R, P, KVH, D).to(cuda_device, dtype)
        pv = _normal(rng, R, P, KVH, D).to(cuda_device, dtype)
        kl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        got = att.decode_prefix_attention(q, pk, pv, kl, sm_scale=1 / math.sqrt(D))
        ref = att.decode_prefix_attention_plain(q, pk, pv, kl, sm_scale=1 / math.sqrt(D))
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32 and g.shape == r.shape
            assert ((g - r).abs() <= 2e-5 * r.abs() + 2e-5).all()
    assert _ext.LAUNCH_COUNTS["decode_prefix_attention"] == before + len(cases)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 8, 16, 17, 33, 40, 64, 65, 127, 129, 300])
def test_w4_matmul_kernel_matches_plain(cuda_device, dtype, rows):
    """Every kernel route (f32 GEMV with and without split K, f32 tiled, the
    bf16 decode kernel with 1, 2 and 4 n8 tiles, the bf16 prefill
    tensor-core kernel with 64- and 128-row tiles, ragged and split) on
    random packed bytes: f32 sums in another order stay within 1e-5 of the
    sum of |terms|, and a bf16 output within two ulps of |ref| beyond
    that."""
    from k_llms_tpu_torch.ops import w4matmul as w4

    rng = np.random.default_rng(rows)
    before, launches = _ext.LAUNCH_COUNTS["w4_matmul"], 0
    for K, N in ((1024, 768), (512, 384), (4096, 1024)):
        q = torch.from_numpy(rng.integers(-128, 128, (K // 2, N), dtype=np.int8)).to(cuda_device)
        scale = torch.from_numpy((rng.random((K // 128, N), dtype=np.float32) + 0.5) / (4.6 * K ** 0.5))
        w = w4.Q4Tensor(q, scale.to(cuda_device))
        x = _normal(rng, rows, K).to(cuda_device, dtype)
        ref = w4.w4_matmul_plain(x, w).float()
        ints = w4._unpack_ints(w.q).abs().float().reshape(K, N)
        abs_terms = sum(
            (x.float().abs()[:, g * 128:(g + 1) * 128] @ ints[g * 128:(g + 1) * 128]) * w.scale[g]
            for g in range(K // 128)
        )
        rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 0.0
        # At bf16 rows <= 32 both routes the crossover is measured between
        # (the wrapper's own choice is one of them), else the wrapper's.
        for route in ("decode", "tc") if dtype == torch.bfloat16 and rows <= 32 else (None,):
            out = w4.w4_matmul(x, w, route=route)
            torch.cuda.synchronize()
            assert out.dtype == dtype and out.shape == (rows, N)
            assert ((out.float() - ref).abs() <= rtol * ref.abs() + 1e-5 * abs_terms).all()
            launches += 1
    assert _ext.LAUNCH_COUNTS["w4_matmul"] == before + launches
    dense = torch.zeros((rows, 128), dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError, match="not taken by the kernel"):
        w4.w4_matmul(dense, w4.Q4Tensor(q[:64, :128].contiguous(), scale[:1, :128].to(cuda_device)))


def test_tiny_int4_dense_flash_tokens_through_kernels_equal_plain(cuda_device):
    """An int4-eligible small config in f32, dense layout, flash decode: the
    card (K2, K3, K4) and the plain versions on the CPU emit the same greedy
    tokens."""
    from k_llms_tpu_torch.models.quant import quantize_params

    cfg = get_config("tiny").with_(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2, head_dim=64,
        vocab_size=384, max_seq_len=128, attention_impl="flash", decode_attention_impl="flash",
    )
    params = quantize_params(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), bits=4)
    on_card = {k: ({kk: vv.to(cuda_device) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(cuda_device)) for k, v in params.items()}
    prompt = ByteTokenizer().apply_chat_template([{"role": "user", "content": "total due 41.20 EUR"}])
    outs = []
    for p, dev in ((on_card, cuda_device), (params, "cpu")):
        eng = LocalEngine(cfg, params=p, device=dev, kv_layout="dense")
        _ext.reset_launch_counts()
        outs.append(eng.generate(prompt, n=4, seed=1, max_new_tokens=16, temperature=0.0))
        counts = dict(_ext.LAUNCH_COUNTS)
        if dev == "cpu":
            assert max(counts.values()) == 0
        else:
            assert counts["w4_matmul"] > 0 and counts["decode_prefix_attention"] > 0
            assert counts["paged_decode_attention"] == 0
    np.testing.assert_array_equal(outs[0].tokens, outs[1].tokens)
    np.testing.assert_allclose(outs[0].logprobs, outs[1].logprobs, atol=1e-4, rtol=0)


# --- the decode-row redesigns: K4's decode route and K1's split and merge ----

LLAMA3_8B_W4 = {"w_gate_up": (4096, 14336), "w_down": (14336, 4096), "wq_wo": (4096, 4096),
                "wk_wv": (4096, 1024), "lm_head": (4096, 128256)}


def _w4_case(rng, rows, K, N, device):
    from k_llms_tpu_torch.ops import w4matmul as w4

    q = torch.from_numpy(rng.integers(-128, 128, (K // 2, N), dtype=np.int8)).to(device)
    scale = torch.from_numpy((rng.random((K // 128, N), dtype=np.float32) + 0.5) / (4.61 * K ** 0.5))
    w = w4.Q4Tensor(q, scale.to(device))
    x = _normal(rng, rows, K).to(device, torch.bfloat16)
    return x, w


def _w4_group_sums(x, w, scale=None, absolute=False):
    """sum_g (x_g . ints_g) * scale_g in f32 (on |x| and |ints| for the
    limit's scale of the summation error)."""
    from k_llms_tpu_torch.ops import w4matmul as w4

    scale = w.scale if scale is None else scale
    xf = x.float().abs() if absolute else x.float()
    acc = torch.zeros((x.shape[0], w.q.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(x.shape[1] // 128):
        ints = w4._unpack_ints(w.q[g * 64:(g + 1) * 64])[0].float()
        acc += (xf[:, g * 128:(g + 1) * 128] @ (ints.abs() if absolute else ints)) * scale[g]
    return acc


@pytest.mark.parametrize("shape", sorted(LLAMA3_8B_W4))
def test_w4_decode_route_matches_plain_at_8b_shapes(cuda_device, shape):
    """The decode kernel at every Llama-3-8B weight and the row counts it
    serves (1, 2, 4, 8, 16, 32), held to K4's limit, |out - ref| <= 2**-6
    |ref| + 1e-5 (|x| @ |W|), against the plain version, and at 8 and 16
    rows against the prefill tensor-core route too; a plain variant that drops
    one group's scale breaks the limit; two runs give the same bits."""
    from k_llms_tpu_torch.ops import w4matmul as w4

    K, N = LLAMA3_8B_W4[shape]
    rng = np.random.default_rng(K + N)
    for rows in (1, 2, 4, 8, 16, 32):
        x, w = _w4_case(rng, rows, K, N, cuda_device)
        assert w4.w4_route(rows, K, N, torch.bfloat16) == "decode"
        before = _ext.LAUNCH_COUNTS["w4_matmul"]
        out = w4.w4_matmul(x, w)
        again = w4.w4_matmul(x, w)
        torch.cuda.synchronize()
        assert _ext.LAUNCH_COUNTS["w4_matmul"] == before + 2
        ref = w4.w4_matmul_plain(x, w).float()
        room = 2.0 ** -6 * ref.abs() + 1e-5 * _w4_group_sums(x, w, absolute=True)
        assert out.dtype == torch.bfloat16 and torch.equal(out, again)
        assert ((out.float() - ref).abs() <= room).all()
        if rows in (8, 16):
            tc = w4.w4_matmul(x, w, route="tc").float()
            assert ((out.float() - tc).abs() <= 2 * room).all()
        if rows == 8:
            dropped = w.scale.clone()
            dropped[K // 256] = 0.0
            mutant = _w4_group_sums(x, w, scale=dropped).to(torch.bfloat16).float()
            assert ((mutant - ref).abs() > room).any()


def _k1_case(rng, R, n_per, QH, KVH, D, ps, plens, glen, device, *, bucket=None, shared=True):
    B = R * n_per
    NP = -(-(bucket or max(plens)) // ps)
    NG = -(-(glen + 24) // ps) + 1
    total = 1 + R * NP + B * NG
    perm = rng.permutation(total - 1).astype(np.int32) + 1
    prefix = perm[: R * NP].reshape(R, NP).copy()
    for r, p in enumerate(plens):
        prefix[r, -(-p // ps):] = 0
    gen = perm[R * NP: R * NP + B * NG].reshape(B, NG).copy()
    if not shared:
        prefix = np.repeat(prefix, n_per, axis=0)
    plen_row = np.repeat(np.asarray(plens, np.int32), n_per)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)  # noqa: E731
    bf = lambda *sh: _normal(rng, *sh).to(device, torch.bfloat16)  # noqa: E731
    return [bf(B, QH, D), bf(total * ps, KVH, D), bf(total * ps, KVH, D), on(prefix), on(gen),
            on(plen_row % ps), bf(B, KVH, D), bf(B, KVH, D), on(plen_row),
            on(np.full(B, glen, np.int32))]


@pytest.mark.parametrize("shared", [True, False], ids=["shared_table", "per_row_table"])
def test_paged_decode_main_path_shape_matches_plain(cuda_device, shared):
    """K1 at the main path's shape (one request of n = 8 rows, 32/8 heads of
    128, page 64, the 1490-token prompt in its 2048 bucket, 16 generated),
    with a shared and a per-row prefix table: within 1e-5 of the plain
    version, the same bits on a second run, one launch counted; a gen page
    id past the pool poisons that row alone with NaN; a merge that drops a
    split or a split boundary one page off breaks the limit."""
    rng = np.random.default_rng(7)
    ps = 64
    args = _k1_case(rng, 1, 8, 32, 8, 128, ps, [1490], 16, cuda_device, bucket=2048, shared=shared)
    kw = dict(page_size=ps, sm_scale=1 / math.sqrt(128))
    before = _ext.LAUNCH_COUNTS["paged_decode_attention"]
    out = pa.paged_decode_attention(*args, **kw)
    again = pa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["paged_decode_attention"] == before + 2
    ref = pa.paged_decode_attention_plain(*args, **kw)
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 1e-5

    bad = args[4].clone()
    bad[1, 0] = args[1].shape[0] // ps + 5
    out_bad = pa.paged_decode_attention(*args[:4], bad, *args[5:], **kw)
    torch.cuda.synchronize()
    others = torch.arange(8, device=cuda_device) != 1
    assert torch.isnan(out_bad[1]).all()
    assert (out_bad[others] - ref[others]).abs().max().item() <= 1e-5

    def dropped(n, k):
        ranges = pa.split_page_ranges(n, k)
        return [rg for i, rg in enumerate(ranges) if i != len(ranges) // 2]

    def off_by_one(n, k):
        ranges = pa.split_page_ranges(n, k)
        i = next(i for i in range(len(ranges) - 1) if ranges[i][1] - ranges[i][0] > 1)
        ranges[i] = (ranges[i][0], ranges[i][1] - 1)
        return ranges

    for mutant in (dropped, off_by_one):
        got = pa.paged_decode_attention_split(*args, **kw, page_ranges=mutant)
        assert (got - ref).abs().max().item() > 1e-5


@pytest.mark.parametrize("case", [
    (1, 8, 8, 2, 64, 512, [511]),  # head dim 64
    (1, 8, 32, 8, 128, 2048, [1490]),  # the main path's shape: 17 key splits
    (2, 8, 32, 8, 128, 2048, [1500, 437]),  # ragged prompts over two requests
    (1, 16, 32, 8, 128, 512, [300]),  # n = 16: two row tiles
    (1, 8, 32, 8, 128, 2048, [40]),  # 16 of 17 splits empty
    (1, 8, 8, 4, 256, 200, [129]),  # head dim 256
], ids=["d64", "main_shape", "ragged_two_requests", "n16", "empty_splits", "d256"])
def test_decode_prefix_tc_splits_match_plain(cuda_device, case):
    """K3's bf16 tensor-core route with its key walk split over the SMs:
    out, m and l within 2e-5 |ref| + 2e-5 of the plain version and of the
    split model, the same bits on a second call, one launch counted per
    call, and no host sync on the way (the call is captured in a CUDA
    graph)."""
    R, n_per, QH, KVH, D, P, lens = case
    assert att.decode_prefix_route(torch.bfloat16, D) == "tc"
    rng = np.random.default_rng(sum(lens) + D)
    q = _normal(rng, R * n_per, QH, D).to(cuda_device, torch.bfloat16)
    pk = _normal(rng, R, P, KVH, D).to(cuda_device, torch.bfloat16)
    pv = _normal(rng, R, P, KVH, D).to(cuda_device, torch.bfloat16)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    sc = 1 / math.sqrt(D)
    before = _ext.LAUNCH_COUNTS["decode_prefix_attention"]
    got = att.decode_prefix_attention(q, pk, pv, kl, sm_scale=sc)
    again = att.decode_prefix_attention(q, pk, pv, kl, sm_scale=sc)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["decode_prefix_attention"] == before + 2
    ref = att.decode_prefix_attention_plain(q, pk, pv, kl, sm_scale=sc)
    model = att.decode_prefix_attention_split(q, pk, pv, kl, sm_scale=sc)
    for g, a, r, mo in zip(got, again, ref, model):
        assert torch.equal(g, a)
        assert ((g - r).abs() <= 2e-5 * r.abs() + 2e-5).all()
        assert ((g - mo).abs() <= 2e-5 * mo.abs() + 2e-5).all()

    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        captured = att.decode_prefix_attention(q, pk, pv, kl, sm_scale=sc)
    graph.replay()
    torch.cuda.synchronize()
    for c, g in zip(captured, got):
        assert torch.equal(c, g)


# --- the draw kernel: a decode step's uniforms, JAX's threefry bits -----------

def _draw_mutant_swapped(rnd, keys, step, n_per, V):
    """The row folded in before the step."""
    rows = torch.arange(n_per, dtype=torch.int64, device=keys.device)
    row_first = rnd.fold_in(keys[:, None, :], rows[None, :])
    return rnd.uniform_tiny(rnd.fold_in(row_first, step.to(torch.int64)).reshape(-1, 2), V)


def _draw_mutant_rotation(rnd, keys, step, n_per, V, monkeypatch):
    """One rotation constant off by one."""
    with monkeypatch.context() as m:
        m.setattr(rnd, "_ROTATIONS", ((13, 15, 26, 6), (17, 29, 16, 25)))
        return _draw_reference(rnd, keys, step, n_per, V)


def _draw_reference(rnd, keys, step, n_per, V):
    """A coalesced step's uniforms, request-major, from the plain threefry."""
    return rnd.uniform_tiny(rnd.row_keys(keys, step.to(torch.int64), n_per), V)


@pytest.mark.parametrize("R,n_per", [(1, 8), (2, 8)])
@pytest.mark.parametrize("V", [128256, 512])
@pytest.mark.parametrize("step", [0, 1, 63])
def test_threefry_uniform_kernel_bit_equal_plain(cuda_device, monkeypatch, R, n_per, V, step):
    """A coalesced step's draws through the per-row kernel at the smoke's
    shapes: bit-equal to the plain threefry's request-major rows, one launch
    counted per call, and both mutants of the plain version
    (a wrong rotation, the step and row folds swapped) break the equality."""
    from k_llms_tpu_torch.ops import random as rnd

    keys = rnd.request_keys([3000000000, 7][:R], cuda_device)
    step_t = torch.tensor(step, dtype=torch.int32, device=cuda_device)
    before = _ext.LAUNCH_COUNTS["threefry_uniform_rows"]
    got = rnd.threefry_uniform(keys, step_t, n_per, V)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["threefry_uniform_rows"] == before + 1
    bits = got.view(torch.int32)
    assert torch.equal(bits, _draw_reference(rnd, keys, step_t, n_per, V).view(torch.int32))
    assert not torch.equal(bits, _draw_mutant_swapped(rnd, keys, step_t, n_per, V).view(torch.int32))
    assert not torch.equal(
        bits, _draw_mutant_rotation(rnd, keys, step_t, n_per, V, monkeypatch).view(torch.int32))


def test_threefry_uniform_kernel_replays_in_a_cuda_graph(cuda_device):
    """The step is read from the device, so one captured launch replays at
    whatever step the buffer holds."""
    from k_llms_tpu_torch.ops import random as rnd

    keys = rnd.request_keys([11], cuda_device)
    step_t = torch.zeros((), dtype=torch.int32, device=cuda_device)
    rnd.threefry_uniform(keys, step_t, 8, 4096)  # load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        captured = rnd.threefry_uniform(keys, step_t, 8, 4096)
    for step in (0, 5, 63):
        step_t.fill_(step)
        graph.replay()
        torch.cuda.synchronize()
        ref = _draw_reference(rnd, keys, step_t, 8, 4096)
        assert torch.equal(captured.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("V", [128256, 512])
def test_threefry_uniform_rows_kernel_bit_equal_plain(cuda_device, V):
    """The continuous loop's per-row draws at its width (32 rows, each with
    its own seed, step and sample index): bit-equal to the plain version,
    one launch counted, and the step and index swapped breaks equality."""
    from k_llms_tpu_torch.ops import random as rnd

    rng = np.random.default_rng(V)
    keys = rnd.request_keys(rng.integers(0, 2 ** 32, 32).tolist(), cuda_device)
    steps = torch.tensor(rng.integers(0, 97, 32), dtype=torch.int32, device=cuda_device)
    index = torch.tensor(rng.integers(0, 8, 32), dtype=torch.int32, device=cuda_device)
    before = _ext.LAUNCH_COUNTS["threefry_uniform_rows"]
    got = rnd.threefry_uniform_rows(keys, steps, index, V)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["threefry_uniform_rows"] == before + 1
    bits = got.view(torch.int32)
    assert torch.equal(bits, rnd.threefry_uniform_rows_plain(keys, steps, index, V).view(torch.int32))
    assert not torch.equal(bits, rnd.threefry_uniform_rows_plain(keys, index, steps, V).view(torch.int32))


# -- speculative decoding: the verify step, its draws, K4 at its rows -----------

VERIFY_ROWS = (40, 80)  # B * (K + 1) at K = 4 for n = 8 and n = 16


@pytest.mark.parametrize("shape", sorted(LLAMA3_8B_W4))
def test_w4_matmul_at_verify_rows_on_both_routes(cuda_device, shape):
    """K4 at the speculative verify's rows (40 and 80) at every Llama-3-8B
    weight: the wrapper's choice (the prefill tensor-core tile, above the
    crossover) and the decode kernel forced over 32-row chunks (it takes at
    most 32 rows), each within K4's limit, |out - ref| <= 2**-6 |ref| + 1e-5
    (|x| @ |W|), one launch per call counted."""
    from k_llms_tpu_torch.ops import w4matmul as w4

    K, N = LLAMA3_8B_W4[shape]
    rng = np.random.default_rng(K + N + 1)
    for rows in VERIFY_ROWS:
        x, w = _w4_case(rng, rows, K, N, cuda_device)
        assert w4.w4_route(rows, K, N, torch.bfloat16) == "tc"
        before = _ext.LAUNCH_COUNTS["w4_matmul"]
        tc = w4.w4_matmul(x, w)
        chunks = [x[i:i + 32].contiguous() for i in range(0, rows, 32)]
        decode = torch.cat([w4.w4_matmul(c, w, route="decode") for c in chunks])
        torch.cuda.synchronize()
        assert _ext.LAUNCH_COUNTS["w4_matmul"] == before + 1 + len(chunks)
        ref = w4.w4_matmul_plain(x, w).float()
        room = 2.0 ** -6 * ref.abs() + 1e-5 * _w4_group_sums(x, w, absolute=True)
        for out in (tc, decode):
            assert out.dtype == torch.bfloat16 and out.shape == (rows, N)
            assert ((out.float() - ref).abs() <= room).all()


@pytest.mark.parametrize("V", [128256, 512])
def test_verify_draws_bit_equal_plain(cuda_device, V):
    """One verify iteration's draws at B * (K + 1) = 40 rows (two requests
    of four rows, five positions): one launch, bit-equal to the plain chain
    fold_in(fold_in(fold_in(key, it), j), i) row-major (row, position); the
    position and the row folded the other way round break equality; the
    call replays in a CUDA graph."""
    from k_llms_tpu_torch.ops import random as rnd

    keys = rnd.request_keys([3000000000, 7], cuda_device)
    it = torch.tensor(3, dtype=torch.int32, device=cuda_device)
    before = _ext.LAUNCH_COUNTS["threefry_uniform_rows"]
    got = rnd.threefry_uniform_verify(keys, it, 4, 5, V)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["threefry_uniform_rows"] == before + 1
    assert got.shape == (40, V)
    it_keys = rnd.fold_in(keys, 3)[:, None, None, :]
    i = torch.arange(4, device=cuda_device)[None, :, None]
    j = torch.arange(5, device=cuda_device)[None, None, :]
    plain = rnd.uniform_tiny(rnd.fold_in(rnd.fold_in(it_keys, j), i).reshape(-1, 2), V)
    swapped = rnd.uniform_tiny(rnd.fold_in(rnd.fold_in(it_keys, i), j).reshape(-1, 2), V)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert not torch.equal(got.view(torch.int32), swapped.view(torch.int32))
    # The iteration is read from the device: one captured call replays at
    # whatever iteration the buffer holds.
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        captured = rnd.threefry_uniform_verify(keys, it, 4, 5, V)
    it.fill_(9)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured.view(torch.int32),
                       rnd.threefry_uniform_verify(keys, it, 4, 5, V).view(torch.int32))
    assert not torch.equal(captured.view(torch.int32), got.view(torch.int32))


def test_verify_step_at_five_tokens_on_card_matches_cpu(cuda_device):
    """``verify_step`` at Sq = 5 with per-row offsets and prompt lengths,
    fp32 tiny on the card against the same call on the CPU: logits within
    1e-4, the written cache within 1e-5."""
    from k_llms_tpu_torch.models import llama

    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.to(cuda_device) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(cuda_device)) for k, v in params.items()}
    rng = np.random.default_rng(7)
    B, P, G = 3, 32, 16
    L, KVH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    pk, pv, gk, gv = (_normal(rng, L, B, n, KVH, D) for n in (P, P, G, G))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 5)))
    lengths, prompt_lens = torch.tensor([0, 11, 4]), torch.tensor([32, 7, 19])
    outs = []
    for p, dev in ((params, "cpu"), (on_card, cuda_device)):
        gen = llama.KVCache(k=gk.clone().to(dev), v=gv.clone().to(dev))
        logits, gen = llama.verify_step(cfg, p, tokens.to(dev), lengths.to(dev),
                                        prompt_lens.to(dev), gen,
                                        llama.KVCache(k=pk.to(dev), v=pv.to(dev)))
        outs.append((logits.cpu(), gen.k.cpu(), gen.v.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-5, rtol=0)
    torch.testing.assert_close(outs[1][2], outs[0][2], atol=1e-5, rtol=0)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_int4_spec_engine_on_card_equals_cpu(cuda_device, temperature):
    """The int4-eligible small config with prompt-lookup speculation on the
    card (K2 per prefill, K4 in every verify, the draws) and on the CPU's
    plain versions: the same tokens and stats; launches as the iterations
    say: K4 per int4 matmul per prefill and per verify iteration, K1 and K3
    none, a draw per sampled iteration plus the first token's."""
    from k_llms_tpu_torch.models.quant import quantize_params

    cfg = get_config("tiny").with_(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2, head_dim=64,
        vocab_size=384, max_seq_len=128, attention_impl="flash", decode_attention_impl="flash",
    )
    params = quantize_params(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), bits=4)
    on_card = {k: ({kk: vv.to(cuda_device) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(cuda_device)) for k, v in params.items()}
    prompt = ByteTokenizer().apply_chat_template([{"role": "user", "content": "total due 41.20"}])
    outs = []
    for p, dev in ((on_card, cuda_device), (params, "cpu")):
        eng = LocalEngine(cfg, params=p, device=dev, kv_layout="dense",
                          speculative="prompt_lookup", spec_lookahead=4)
        _ext.reset_launch_counts()
        res = eng.generate(prompt, n=4, seed=1, max_new_tokens=16, temperature=temperature)
        outs.append((res, dict(_ext.LAUNCH_COUNTS), dict(eng.spec_stats)))
    (card, counts, stats), (cpu, cpu_counts, cpu_stats) = outs
    np.testing.assert_array_equal(card.tokens, cpu.tokens)
    np.testing.assert_allclose(card.logprobs, cpu.logprobs, atol=1e-4, rtol=0)
    assert stats == cpu_stats and max(cpu_counts.values()) == 0
    its = stats["verify_iterations"]
    assert its > 0
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["w4_matmul"] == (7 * cfg.num_layers + 1) * (1 + its)
    assert counts["paged_decode_attention"] == counts["decode_prefix_attention"] == 0
    assert counts["threefry_uniform_rows"] == ((1 + its) if temperature else 0)


def _code_pairs(rng, P, L):
    """P seeded pairs of ASCII strings of lengths 0..L over a small alphabet
    (so distances vary), with empty strings and the bucket's edge lengths."""
    alpha = np.frombuffer(b"abcde01", np.uint8)
    a = np.zeros((P, L), np.int32)
    b = np.zeros((P, L), np.int32)
    alen = rng.integers(0, L + 1, P).astype(np.int32)
    blen = rng.integers(0, L + 1, P).astype(np.int32)
    alen[:4], blen[:4] = [0, L, 0, L], [0, 0, L, L]
    for p in range(P):
        a[p, : alen[p]] = rng.choice(alpha, alen[p])
        b[p, : blen[p]] = rng.choice(alpha, blen[p])
    return a, alen, b, blen


@pytest.mark.parametrize("L", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("P", [64, 1024])
def test_levenshtein_kernel_equals_plain_and_native(cuda_device, L, P):
    """Every distance equal to the plain version's and the native code's."""
    from k_llms_tpu_torch.native import levenshtein_distance
    from k_llms_tpu_torch.ops.levenshtein import levenshtein, levenshtein_plain

    a, alen, b, blen = _code_pairs(np.random.default_rng(L * P), P, L)
    t = [torch.as_tensor(x, device=cuda_device) for x in (a, alen, b, blen)]
    before = _ext.LAUNCH_COUNTS["levenshtein"]
    got = levenshtein(*t)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["levenshtein"] == before + 1
    assert torch.equal(got, levenshtein_plain(*t))
    native = [levenshtein_distance(a[p, : alen[p]].astype(np.uint8).tobytes().decode(),
                                   b[p, : blen[p]].astype(np.uint8).tobytes().decode())
              for p in range(P)]
    assert got.tolist() == native


def test_continuous_loop_on_card_equals_the_plain_loop(cuda_device):
    """tiny fp32 through the loop on the card (K2 per whole prefill and per
    chunk, K1 per step, the per-row draws per step and admission) and on the
    CPU's plain versions: the same tokens, the kernels' launches exactly as
    the loop's stats say."""
    from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop

    tiny = get_config("tiny")
    params = init_params(tiny, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    reqs = [(list(range(2, 100)), dict(n=2, max_new=12, temperature=0.0, top_p=None, seed=1)),
            ([5, 6, 7], dict(n=3, max_new=16, temperature=0.8, top_p=0.9, seed=2))]
    outs, counts, stats = {}, None, None
    for where, kw in (("card", dict(config=tiny.with_(attention_impl="flash"), params=params,
                                    device=cuda_device, paged_attention_impl="cuda")),
                      ("plain", dict(config=tiny, params=cpu_params, device="cpu"))):
        eng = LocalEngine(kw.pop("config"), kv_page_size=16, **kw)
        loop = ContinuousDecodeLoop(eng, width=8, max_prompt=128, max_new=16,
                                    prefill_chunk_tokens=32)
        _ext.reset_launch_counts()
        futs = [loop.submit(ids, **k) for ids, k in reqs]
        outs[where] = [f.result(timeout=300) for f in futs]
        if where == "card":
            counts, stats = dict(_ext.LAUNCH_COUNTS), loop.stats
        loop.stop()
    for got, ref in zip(outs["card"], outs["plain"]):
        assert np.array_equal(got.tokens, ref.tokens)
    L = tiny.num_layers
    assert stats["prefill_chunks"] == 4
    assert counts["flash_attention"] == L * (stats["prefill_chunks"] + 1)
    assert counts["paged_decode_attention"] == L * stats["steps"]
    assert counts["threefry_uniform_rows"] == stats["steps"] + stats["admitted"]


# -- the serving chain on the card --------------------------------------------


def test_coalesced_tiny_group_through_the_scheduler_equals_plain(cuda_device):
    """Four tiny fp32 requests queued behind the scheduler's parked worker
    run as one launch through K2, K1 and the draws, under the supervisor,
    and equal the plain paths' direct launch of the same specs."""
    from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.reliability.drills import park_worker, queue_in_order

    tiny = get_config("tiny")
    params = init_params(tiny, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    engine = LocalEngine(tiny.with_(attention_impl="flash"), params=params, device=cuda_device,
                         paged_attention_impl="cuda", kv_page_size=16)
    backend = CudaBackend(config=BackendConfig(model="tiny", batch_window=0.0), engine=engine)
    tok = backend.tokenizer
    group = [("alpha", 2, 5), ("a somewhat longer second prompt", 3, 6), ("three", 1, 7),
             ("the fourth request of the group", 2, 8)]
    prompts = [tok.apply_chat_template([{"role": "user", "content": t}]) for t, _, _ in group]
    gate = park_worker(backend.scheduler)
    _ext.reset_launch_counts()
    threads, got = queue_in_order(backend.scheduler, [
        lambda p=p, n=n, s=s: backend._generate_batched(
            p, n=n, max_new=16, temperature=0.8, top_p=None, seed=s, constraint=None)
        for p, (_, n, s) in zip(prompts, group)])
    gate.set()
    for t in threads:
        t.join(timeout=120)
    counts = dict(_ext.LAUNCH_COUNTS)
    assert backend.scheduler.stats["batches"] == 1 and backend.scheduler.stats["coalesced"] == 3
    assert min(counts[k] for k in ("flash_attention", "paged_decode_attention",
                                   "threefry_uniform_rows")) > 0
    plain = LocalEngine(tiny, params=params, device=cuda_device, paged_attention_impl="xla",
                        kv_page_size=16)
    want = plain.generate_many([GenRequestSpec(p, n, s) for p, (_, n, s) in zip(prompts, group)],
                               max_new_tokens=16, temperature=0.8, eos_ids=tok.stop_ids)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i].tokens, w.tokens)
        np.testing.assert_allclose(got[i].logprobs, w.logprobs, atol=1e-4, rtol=0)
    backend.close()


def test_paged_attn_drill_fails_the_card_launch_and_the_next_takes_the_kernel(cuda_device):
    """The ``ops.paged_attn`` drill on a card: the launch's member gets the
    typed 503 and no plain version runs; the next launch runs K1 and
    equals a launch made before the drill."""
    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.ops.paged_attention import KernelUnavailableError
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec
    from k_llms_tpu_torch.utils.observability import KERNEL_EVENTS

    tiny = get_config("tiny")
    params = init_params(tiny, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    engine = LocalEngine(tiny, params=params, device=cuda_device, paged_attention_impl="cuda",
                         kv_page_size=16)
    tok = ByteTokenizer()
    spec = GenRequestSpec(tok.apply_chat_template([{"role": "user", "content": "drill"}]), 2, 9)
    kw = dict(max_new_tokens=8, temperature=0.0, eos_ids=tok.stop_ids)
    want = engine.generate_many([spec], **kw)[0]
    plain = KERNEL_EVENTS.get("kernel.paged_attn_xla_dispatch")
    with fp.failpoints({"ops.paged_attn": FailSpec(action="fallback", times=1)}):
        failed = engine.generate_many([spec], **kw)[0]
    assert isinstance(failed, KernelUnavailableError)
    before = _ext.LAUNCH_COUNTS["paged_decode_attention"]
    got = engine.generate_many([spec], **kw)[0]
    assert _ext.LAUNCH_COUNTS["paged_decode_attention"] > before
    assert KERNEL_EVENTS.get("kernel.paged_attn_xla_dispatch") == plain
    assert engine._kv_pool.allocator.snapshot()["in_use"] == 0
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.logprobs, want.logprobs)


def test_real_oom_splits_the_group_and_serves_each_half(cuda_device):
    """With the process's memory fraction set between a solo launch's peak
    and a two-request group's, the group's launch runs out of device memory
    for real: the guard splits it, every page goes back, and each member
    equals its solo launch. The page pool is sized by the first solo launch
    and kept, as in the JAX engine, so the group decodes dense: with the
    config's wide KV heads (128 KiB a token) its dense KV (two 4096-token
    prompt buckets, 64 rows x 128 tokens) sets its peak apart from a solo's
    by more than the solo launch's reserved slack."""
    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.reliability.drills import (
        launch_peaks, memory_fraction, oom_memory_fraction, reset_launch_memory)

    cfg = get_config("tiny").with_(hidden_size=256, intermediate_size=512, num_heads=32,
                                   num_kv_heads=32, head_dim=128, num_layers=4,
                                   attention_impl="flash", max_seq_len=4096)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    engine = LocalEngine(cfg, params=params, device=cuda_device, paged_attention_impl="cuda",
                         kv_page_size=64)
    tok = ByteTokenizer()
    specs = [GenRequestSpec(tok.apply_chat_template([{"role": "user", "content": c * 400}]), 32, s)
             for c, s in (("abcdefg ", 1), ("hijklmn ", 2))]
    kw = dict(max_new_tokens=128, temperature=0.0, eos_ids=tok.stop_ids)

    solos, peaks = [], []
    for spec in specs:
        reset_launch_memory(engine)
        solos.append(engine.generate_many([spec], **kw)[0])
        assert engine.last_launch_stats["kv_layout"] == "paged"
        peaks.append(launch_peaks(cuda_device)[0])
    reset_launch_memory(engine)
    engine.generate_many(specs, **kw)
    assert engine.last_launch_stats["kv_layout"] == "dense"
    fraction = oom_memory_fraction(max(peaks), launch_peaks(cuda_device)[1], cuda_device)
    reset_launch_memory(engine)
    with memory_fraction(fraction, cuda_device):
        got = engine.generate_many(specs, **kw)
    assert engine.oom_stats == {"splits": 1, "unrecovered": 0}
    assert engine._kv_pool.allocator.snapshot()["in_use"] == 0
    for g, w in zip(got, solos):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.logprobs, w.logprobs)


# --- the other model families: K2 at their prefill shapes, tiny models ------

FAMILY_K2 = {
    # (QH, KVH, D, softcap, window, sm_scale, {mutant: plain keyword changes})
    "gemma2_9b_local": (16, 8, 256, 50.0, 4096, 256.0 ** -0.5,
                        {"softcap_dropped": dict(softcap=None), "wrong_layer_parity": dict(window=None)}),
    "gemma2_9b_global": (16, 8, 256, 50.0, None, 256.0 ** -0.5,
                         {"softcap_dropped": dict(softcap=None),
                          "wrong_layer_parity": dict(window=4096)}),
    "mistral_7b": (32, 8, 128, None, 4096, None, {"wrong_layer_parity": dict(window=None)}),
}


@pytest.mark.parametrize("S,key_length", [(4608, 4608), (8192, 4600)],
                         ids=["prompt", "bucket"])
@pytest.mark.parametrize("case", sorted(FAMILY_K2))
def test_flash_family_prefill_shapes_match_plain(cuda_device, case, S, key_length):
    """K2 at Gemma-2-9B's and Mistral-7B's prefill shapes (a 4608-token
    prompt, past the 4096-key window; and a 4600-token prompt in the 8192
    bucket the engine pads it to, the padded query rows computed too)
    within two bf16 ulps of its plain version; the softcap dropped and the
    other layer kind's window each break the limit (``--phases build,k2``
    of chip_smoke.py times them)."""
    QH, KVH, D, softcap, window, scale, mutants = FAMILY_K2[case]
    rng = np.random.default_rng(11)
    q = _normal(rng, 1, QH, S, D).to(cuda_device, torch.bfloat16)
    k = _normal(rng, 1, KVH, S, D).to(cuda_device, torch.bfloat16)
    v = _normal(rng, 1, KVH, S, D).to(cuda_device, torch.bfloat16)
    kw = dict(causal=True,
              key_lengths=torch.tensor([key_length], dtype=torch.int32, device=cuda_device),
              softcap=softcap, window=window, sm_scale=scale)
    _ext.reset_launch_counts()
    out = att.flash_attention(q, k, v, **kw)
    assert _ext.LAUNCH_COUNTS["flash_attention"] == 1
    ref = att.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(out).all() and _over_k2_limit(out, ref) <= 1.0
    for name, change in mutants.items():
        assert _over_k2_limit(out, att.flash_attention_plain(q, k, v, **dict(kw, **change))) > 1.0, name


def _on(params, device):
    return {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


@pytest.mark.parametrize("family", ["gemma", "mixtral"])
def test_tiny_family_through_kernels_equals_plain_cpu(cuda_device, family):
    """A tiny Gemma-2 (alternating window shorter than the prompt, softcaps,
    head dim 64) and a tiny Mixtral in fp32 on the paged path: the card (K2
    in prefill; K1 in Mixtral's decode, the reference attention in
    Gemma's, as the JAX routing has it) and the same model on the CPU's
    plain paths emit the same greedy tokens."""
    extra = (dict(sliding_window=16, sliding_window_layers="alternating", act="gelu",
                  norm_offset=True, embed_scale=True, post_block_norms=True, attn_softcap=50.0,
                  logit_softcap=30.0, query_scale=64.0 ** -0.5, head_dim=64, num_layers=4)
             if family == "gemma" else dict(num_experts=4, num_experts_per_tok=2))
    cfg = get_config("tiny").with_(attention_impl="flash", **extra)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = ByteTokenizer().apply_chat_template(
        [{"role": "user", "content": "the invoice total due is 41.20 EUR, paid in full"}])
    assert len(prompt) > 16
    outs = []
    for p, dev in ((_on(params, cuda_device), cuda_device), (params, "cpu")):
        eng = LocalEngine(cfg, params=p, device=dev, kv_page_size=16)
        _ext.reset_launch_counts()
        outs.append(eng.generate(prompt, n=3, seed=1, max_new_tokens=24, temperature=0.0))
        counts = dict(_ext.LAUNCH_COUNTS)
        if dev == "cpu":
            assert max(counts.values()) == 0
        else:
            assert counts["flash_attention"] == cfg.num_layers
            assert (counts["paged_decode_attention"] > 0) == (family == "mixtral")
            assert eng.paged_attention_impl == ("cuda" if family == "mixtral" else "xla")
    np.testing.assert_array_equal(outs[0].tokens, outs[1].tokens)
    np.testing.assert_allclose(outs[0].logprobs, outs[1].logprobs, atol=1e-4, rtol=0)


# --- the OpenAI wire over HTTP at the 8B shapes of chip_smoke's serve phase ---

PRINTABLE = {str(t): 10.0 for t in range(32, 127)}


@pytest.fixture(scope="module")
def served_8b():
    """Llama-3-8B in bf16 on the paged path (seeded weights, the byte
    tokenizer, the smoke's 128-page pool) behind ``ServerThread`` on
    loopback."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no interpret mode")
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.serving import ServerThread, create_app

    client = KLLMs(backend="cuda", model="llama-3-8b", kv_pool_pages=128)
    srv = ServerThread(create_app(client)).start()
    yield client, srv.port
    srv.stop(drain=False)
    client.close()


def test_stream_over_http_equals_create(served_8b):
    """Request b of the serve phase (n = 8, T 0.8, top-p 0.95, 64 tokens)
    streamed over a real socket: every sample gets a delta before the final
    event, the deltas concatenate to the final texts, the final event equals
    a non-streamed create() with the same seed, and the stream ends in
    [DONE]; the decode ran K1 and the draws."""
    from chip_smoke import http_stream, normalised, stream_texts

    client, port = served_8b
    body = dict(messages=[{"role": "user", "content": "Name three prime numbers."}], n=8,
                temperature=0.8, top_p=0.95, seed=3, max_tokens=64, logit_bias=PRINTABLE)
    _ext.reset_launch_counts()
    status, frames, ttfd, _ = http_stream(port, body)
    assert _ext.LAUNCH_COUNTS["paged_decode_attention"] > 0
    assert _ext.LAUNCH_COUNTS["threefry_uniform_rows"] > 0
    texts, seen, final = stream_texts(frames, 8)
    assert status == 200 and frames[-1] == "[DONE]" and frames[-2] is final
    assert seen == set(range(1, 9)) and ttfd is not None
    assert texts == [c["message"]["content"] for c in final["choices"][1:]]
    want = client.chat.completions.create(**body).model_dump(mode="json")
    assert normalised(final) == normalised(want)


def test_disconnect_aborts_the_launch(served_8b):
    """A 256-token stream whose client hangs up after the first delta: the
    launch aborts (``engine.decode_abort`` up by one, fewer than 255 decode
    steps), its pages return to the pool, and the next request is served."""
    import time

    from chip_smoke import http_call, http_stream
    from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS

    client, port = served_8b
    engine = client.backend.engine
    body = dict(messages=[{"role": "user", "content": "Name three prime numbers."}], n=8,
                temperature=0.8, top_p=0.95, seed=17, max_tokens=256, logit_bias=PRINTABLE)
    aborts = FAILURE_EVENTS.get("engine.decode_abort")
    status, frames, ttfd, _ = http_stream(port, body, disconnect_after_first_delta=True)
    assert status == 200 and ttfd is not None
    deadline = time.monotonic() + 120
    while FAILURE_EVENTS.get("engine.decode_abort") == aborts:
        assert time.monotonic() < deadline, "the disconnect did not abort the launch"
        time.sleep(0.01)
    st = engine.last_launch_stats
    assert FAILURE_EVENTS.get("engine.decode_abort") == aborts + 1
    assert st["aborted"] and st["decode_steps"] < 255
    with engine._launch_lock:
        assert engine._kv_pool.allocator.snapshot()["in_use"] == 0
    nxt = http_call(port, "POST", "/v1/chat/completions", dict(body, max_tokens=8, stream=False))
    assert nxt[0] == 200


# -- the mesh: K4 at the tensor-parallel shard shapes, a world of one -------

#: Llama-3-8B's int4 weights cut for TP = 2 (the rank's [K, N]): column
#: splits of wq, wk/wv, w_gate/w_up and lm_head, row splits of wo, w_down.
LLAMA3_8B_W4_TP2 = {"wq": (4096, 2048), "wk_wv": (4096, 512), "w_gate_up": (4096, 7168),
                    "lm_head": (4096, 64128), "wo": (2048, 4096), "w_down": (7168, 4096)}


@pytest.mark.parametrize("shape", sorted(LLAMA3_8B_W4_TP2))
@pytest.mark.parametrize("rows", [8, 2048])
def test_w4_matmul_at_tp2_shard_shapes(cuda_device, shape, rows):
    """K4 on each TP = 2 shard of the 8B weights (new split-K plans at N =
    64128 and K = 7168), at a decode batch and the long prefill's bucket,
    within K4's limit of its plain version; through ``w4_matmul_tp`` on a
    trivial mesh (TP = 1) it is the same bits and counts K4's launch."""
    from k_llms_tpu_torch.ops import w4matmul as w4
    from k_llms_tpu_torch.parallel.mesh import Mesh

    K, N = LLAMA3_8B_W4_TP2[shape]
    rng = np.random.default_rng(K + N + rows)
    x, w = _w4_case(rng, rows, K, N, cuda_device)
    assert w4.kernel_supports(K, N)
    out = w4.w4_matmul(x, w)
    before = _ext.LAUNCH_COUNTS["w4_matmul"]
    for part in ("col", "row"):
        tp = w4.w4_matmul_tp(x, w4.Q4Tensor(w.q, w.scale, part=part, mesh=Mesh(1, 1)))
        assert torch.equal(tp, out)
    torch.cuda.synchronize()
    assert _ext.LAUNCH_COUNTS["w4_matmul"] == before + 2
    ref = w4.w4_matmul_plain(x, w).float()
    room = 2.0 ** -6 * ref.abs() + 1e-5 * _w4_group_sums(x, w, absolute=True)
    assert ((out.float() - ref).abs() <= room).all()


def _nccl_world_of_one(store, outq):
    import os
    import sys
    from datetime import timedelta

    sys.path.insert(0, os.getcwd())
    import torch.distributed as dist

    from k_llms_tpu_torch.ops import w4matmul as w4
    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.mesh import make_mesh

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                                timeout=timedelta(seconds=120))
        mesh = make_mesh(1, 1)
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn((4, 8, 16), generator=g, device="cuda").to(torch.bfloat16)
        same = [torch.equal(f(x), x) for f in (
            lambda t: C.psum(t, "model", mesh), lambda t: C.pmax(t, "data", mesh),
            lambda t: C.all_gather(t, "model", mesh, dim=1), lambda t: C.ppermute(t, "data", mesh),
            lambda t: C.all_to_all(t, "model", mesh, split_dim=1, concat_dim=2))]
        q = torch.randint(-128, 128, (2048, 4096), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.rand((32, 4096), generator=g, device="cuda") / 64
        xs = torch.randn((8, 4096), generator=g, device="cuda").to(torch.bfloat16)
        base = w4.w4_matmul(xs, w4.Q4Tensor(q, scale))
        tp = [torch.equal(w4.w4_matmul_tp(xs, w4.Q4Tensor(q, scale, part=p, mesh=mesh)), base)
              for p in ("col", "row")]
        outq.put((mesh.transport, same, tp, C.COLLECTIVE_COUNTS["host_staged_bytes"]))
        dist.destroy_process_group()
    except BaseException as e:
        outq.put(repr(e))


def test_nccl_world_of_one(cuda_device, tmp_path):
    """The path of a machine with a card per rank: an nccl world of one on
    device tensors. Every collective is the identity, nothing is staged
    through the host, and w4_matmul_tp at TP = 1 equals w4_matmul bit for
    bit."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    p = ctx.Process(target=_nccl_world_of_one, args=(str(tmp_path / "store"), outq))
    p.start()
    try:
        res = outq.get(timeout=180)
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert not isinstance(res, str), res
    transport, same, tp, staged = res
    assert transport == "nccl" and all(same) and all(tp) and staged == 0


def _spawn_ranks(target, size, tmp_path, timeout=240):
    """Run ``target(rank, size, store, outq)`` in ``size`` spawned processes;
    returns each rank's answer (None where a rank gave none in time)."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target, args=(r, size, store, outq)) for r in range(size)]
    for p in procs:
        p.start()
    res = [None] * size
    try:
        for _ in range(size):
            try:
                rank, answer = outq.get(timeout=timeout)
            except queue.Empty:
                break
            res[rank] = answer
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return res


def _nccl_two_ranks(rank, size, store, outq):
    import os
    import sys
    from datetime import timedelta

    sys.path.insert(0, os.getcwd())
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=size, timeout=timedelta(seconds=60),
                                device_id=torch.device("cuda", 0))
        x = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        outq.put((rank, float(x[0].item())))
        dist.destroy_process_group()
    except BaseException as e:  # the refusal is the answer
        outq.put((rank, f"{type(e).__name__}: {e}"))


def test_nccl_refuses_two_ranks_on_one_card(cuda_device, tmp_path):
    """Why ranks that share a card take gloo (``parallel/distributed.py``):
    NCCL refuses two ranks on one device ("Duplicate GPU detected"). If it
    ever takes them, the transport rule is to be revisited."""
    res = _spawn_ranks(_nccl_two_ranks, 2, tmp_path, timeout=150)
    assert any(isinstance(r, str) and "Duplicate GPU" in r for r in res), res


def _pid_alive(pid):
    """Whether ``pid`` runs (an exited process not yet reaped counts as
    ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_spawned_world_serves_on_the_card_and_close_leaves_no_child(cuda_device, monkeypatch):
    """A plain ``KLLMs(backend="cuda", model_parallel=2)`` with the forced
    local rank count at 2 starts its follower itself
    (``parallel/launcher.py``): both ranks on the one card over gloo, a
    tensor-parallel (1, 2) mesh, one request served through both ranks'
    kernels, and ``close()`` ends the follower with exit code 0."""
    from k_llms_tpu_torch import KLLMs

    monkeypatch.setenv("KLLMS_LOCAL_RANKS", "2")
    client = KLLMs(backend="cuda", model="tiny", model_parallel=2, max_new_tokens=8)
    world = client.backend.world
    try:
        assert world is not None and len(world.pids) == 1
        mesh = client.backend.engine.mesh
        assert mesh.shape == {"data": 1, "model": 2} and mesh.transport == "gloo"
        _ext.reset_launch_counts()
        resp = client.chat.completions.create(
            messages=[{"role": "user", "content": "hi"}], n=2, seed=1)
        assert len(resp.choices) == 3
        assert sum(_ext.LAUNCH_COUNTS.values()) > 0
    finally:
        client.close()
    assert [p.returncode for p in world.procs] == [0]
    assert not any(_pid_alive(pid) for _, _, pid, _ in world.ended)


def _int4_tp4_rank(rank, size, store, outq):
    import os
    import sys

    sys.path.insert(0, os.getcwd())
    os.environ["KLLMS_RANK_CHECK"] = "1"
    import torch.distributed as dist

    from k_llms_tpu_torch.engine.engine import LocalEngine
    from k_llms_tpu_torch.models.config import get_config
    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.parallel.mesh import make_mesh

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=size)
        cfg = get_config("llama-3-8b").with_(num_layers=2)
        eng = LocalEngine(cfg, device="cuda", quantize="int4", kv_layout="dense",
                          mesh=make_mesh(1, size))
        _ext.reset_launch_counts()
        out = eng.generate(list(range(5, 40)), n=2, max_new_tokens=4, temperature=0.0, seed=1)
        torch.cuda.synchronize()
        head = eng.params["lm_head"]
        outq.put((rank, {"lm_head": type(head).__name__, "lm_head_part": head.part,
                         "lm_head_shape": list(head.shape),
                         "wq": eng.params["layers"]["wq"].part,
                         "tokens": np.asarray(out.tokens).tolist(),
                         "k4": _ext.LAUNCH_COUNTS["w4_matmul"],
                         "steps": eng.last_launch_stats["decode_steps"]}))
        dist.destroy_process_group()
    except BaseException as e:
        outq.put((rank, f"{type(e).__name__}: {e}"))


def test_int4_tp4_keeps_ragged_lm_head_int4(cuda_device, tmp_path):
    """Llama-3-8B int4 at model parallel = 4 (depth cut to two layers): the
    lm_head shard [4096, 32064] ends 64 columns into K4's last column tile,
    which K4 masks, so it stays int4 (as in JAX) and runs through
    w4_matmul_tp with the other weights: per rank and forward, 7 K4 launches
    a layer and one for the head; the four ranks serve a request with the
    same tokens."""
    _ext.build_all()  # once, before the ranks start
    res = _spawn_ranks(_int4_tp4_rank, 4, tmp_path)
    assert all(isinstance(r, dict) for r in res), res
    for r in res:
        assert r["lm_head"] == "Q4Tensor" and r["lm_head_part"] == "col", r
        assert r["lm_head_shape"] == [4096, 32064] and r["wq"] == "col"
        # The prefill and each decode step, two layers: 7 * 2 + 1 apiece.
        assert r["k4"] == (7 * 2 + 1) * (1 + r["steps"]), r
    assert all(r["tokens"] == res[0]["tokens"] for r in res)


#: Llama-3-8B's lm_head shards that end inside K4's last column tile, by
#: model-parallel degree.
LLAMA3_8B_RAGGED_LM_HEAD = {4: (4096, 32064), 8: (4096, 16032)}


@pytest.mark.parametrize("tp", sorted(LLAMA3_8B_RAGGED_LM_HEAD))
@pytest.mark.parametrize("rows,dtype", [(8, torch.bfloat16), (2048, torch.bfloat16),
                                        (8, torch.float32), (96, torch.float32)])
def test_w4_matmul_on_ragged_lm_head_shards(cuda_device, tp, rows, dtype):
    """K4's masked last column tile on every route (decode, tc, gemv,
    tiled) at Llama-3-8B's lm_head shards of TP = 4 and 8: within K4's
    limit of its plain version, every column finite.
    ``int4_off_kernel_shards`` lists no weight of the config at either
    degree."""
    from k_llms_tpu_torch.models.quant import int4_off_kernel_shards
    from k_llms_tpu_torch.ops import w4matmul as w4

    K, N = LLAMA3_8B_RAGGED_LM_HEAD[tp]
    assert N % 128 and w4.kernel_supports(K, N)
    assert int4_off_kernel_shards(get_config("llama-3-8b"), tp) == {}
    rng = np.random.default_rng(K + N + rows)
    x, w = _w4_case(rng, rows, K, N, cuda_device)
    x = x.to(dtype)
    out = w4.w4_matmul(x, w)
    torch.cuda.synchronize()
    assert out.shape == (rows, N) and torch.isfinite(out.float()).all()
    ref = w4.w4_matmul_plain(x, w).float()
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-6
    room = tol * ref.abs() + 1e-5 * _w4_group_sums(x, w, absolute=True)
    assert ((out.float() - ref).abs() <= room).all()


# The train phase's bf16 loss limit (chip_smoke.py, TRAIN_BF16_LOSS_RTOL):
# the card's and the CPU's bf16 matmuls round at other points.
TRAIN_BF16_LOSS_RTOL = 1e-2


def test_bf16_tiny_train_step_on_card_equals_cpu(cuda_device):
    """Two steps of the train step on tiny in bf16, on the card and on the
    CPU from the same tree and batch: each step's loss within the train
    phase's bf16 limit, and each parameter within what two AdamW steps can
    leave between them, per step twice the learning rate (an early Adam
    step moves an element by at most about lr, whatever its gradient's
    rounding) plus one bf16 ulp (2^-7 |p|)."""
    from k_llms_tpu_torch.engine.training import _leaves, make_train_step

    cfg = get_config("tiny").with_(dtype="bfloat16")
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = {k: ({n: t.to(cuda_device) for n, t in v.items()} if isinstance(v, dict)
                else v.to(cuda_device)) for k, v in host.items()}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 256, (4, 32)))
    mask = torch.ones_like(tokens)
    mask[3, 19:] = 0
    init_state, step = make_train_step(cfg)
    opt_h, opt_c = init_state(host), init_state(card)
    steps, lr = 2, 1e-4
    for _ in range(steps):
        lh = step(host, opt_h, tokens, mask)[2].item()
        lc = step(card, opt_c, tokens, mask)[2]
        assert lc.device.type == "cuda"
        assert abs(lc.item() - lh) <= TRAIN_BF16_LOSS_RTOL * abs(lh)
    for (path, h), (_, c) in zip(_leaves(host), _leaves(card)):
        h = h.float()
        limit = steps * (2.1 * lr + 2.0 ** -7 * h.abs())
        assert ((c.float().cpu() - h).abs() <= limit).all(), path


def _differentiable_collectives_world_of_one(store, outq):
    import os
    import sys
    from datetime import timedelta

    sys.path.insert(0, os.getcwd())
    import torch.distributed as dist

    from k_llms_tpu_torch.models import llama
    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.mesh import make_mesh
    from k_llms_tpu_torch.parallel.sharding import shard_params

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                                timeout=timedelta(seconds=120))
        mesh = make_mesh(1, 1)
        x = torch.randn((4, 8), device="cuda")
        counts = {}
        with torch.inference_mode():
            for name, fn, plain in (
                    ("reduce", C.reduce_from_model, lambda t, m: C.psum(t, "model", m)),
                    ("copy", C.copy_to_model, lambda t, m: t),
                    ("gather", C.gather_from_model, lambda t, m: C.all_gather(t, "model", m, -1))):
                C.reset_collective_counts()
                want = plain(x, mesh)
                plain_counts = dict(C.COLLECTIVE_COUNTS)
                C.reset_collective_counts()
                got = fn(x, mesh)
                counts[name] = (bool(torch.equal(got, want)), plain_counts == C.COLLECTIVE_COUNTS)
            cfg = get_config("tiny")
            tree = shard_params(init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                            "cuda"), mesh, cfg)
            C.reset_collective_counts()
            llama.forward(cfg, tree, torch.zeros((1, 8), dtype=torch.long, device="cuda"),
                          torch.ones((1, 8), device="cuda"))
            forward_counts = dict(C.COLLECTIVE_COUNTS)
        # With a gradient: only copy_to_model's backward adds a collective.
        w = x.clone().requires_grad_(True)
        C.reset_collective_counts()
        y = C.gather_from_model(C.reduce_from_model(C.copy_to_model(w, mesh) * 2, mesh), mesh)
        forward_grad_counts = dict(C.COLLECTIVE_COUNTS)
        y.sum().backward()
        grad_ok = bool(torch.equal(w.grad, torch.full_like(w, 2.0)))
        outq.put((counts, forward_counts, forward_grad_counts, dict(C.COLLECTIVE_COUNTS), grad_ok))
        dist.destroy_process_group()
    except BaseException as e:
        outq.put(repr(e))


def test_differentiable_collectives_keep_forward_counts(cuda_device, tmp_path):
    """An nccl world of one on device tensors: under inference mode each
    differentiable collective returns and counts what its plain collective
    does, and the model's forward on a (1, 1) mesh counts nothing, as before
    the train step; with a gradient only ``copy_to_model``'s backward adds
    one psum."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    p = ctx.Process(target=_differentiable_collectives_world_of_one,
                    args=(str(tmp_path / "store"), outq))
    p.start()
    try:
        res = outq.get(timeout=180)
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert not isinstance(res, str), res
    counts, forward_counts, forward_grad, after, grad_ok = res
    assert all(equal and same for equal, same in counts.values()), counts
    assert forward_counts["psum"] == forward_counts["all_gather"] == 0
    assert forward_grad["psum"] == 1 and forward_grad["all_gather"] == 1
    assert after["psum"] == 2 and after["all_gather"] == 1 and grad_ok
