"""int4 and int8 weight quantization (kernel K4, the w4a16 matmul): the port
held against the JAX package.

Packing is byte-identical to the JAX ``pack_int4`` on the same f32 input
(ties rounded half to even, the +-7 clip, 1.0 for an all-zero group).
``w4_matmul`` on the CPU (the kernel's plain version) is held against the
JAX ``w4_matmul(..., interpret=True)`` (the Pallas kernel in interpret mode).
Both take each group's dot in f32 over exact integers and sum the scaled
groups in f32, so in f32 they agree to rtol 1e-5 (plus an absolute 1e-5 of
the largest |output| for elements near zero; the largest error measured is
under 1e-6 of it); bf16 outputs, rounded once from f32 sums that differ in
the last bits, agree within one bf16 ulp (2**-8 relative, rtol 2**-7 here).
The CUDA kernel itself is held against its plain version on a card, in
test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import init_params as jax_init_params
from k_llms_tpu.models import quant as jax_quant
from k_llms_tpu.ops import w4matmul as jax_w4
from k_llms_tpu_torch.models import quant
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.models.llama import params_from_numpy
from k_llms_tpu_torch.ops import w4matmul as w4

ELIGIBLE = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                head_dim=64, vocab_size=384, max_seq_len=128)


def _weights(seed, K, N):
    """Normal weights plus the edge cases of the quantizer: an all-zero
    group, values exactly at +-amax, and halfway ties at scale 1."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32)
    w[:128, 0] = 0.0  # all-zero group -> scale 1.0, all nibbles 0
    w[128:256, 1] = np.linspace(-7.0, 7.0, 128, dtype=np.float32)  # amax 7 -> scale 1
    w[130:138, 1] = [0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -6.5, 6.5]  # ties: half to even
    w[:128, 2] = 0.25
    w[5, 2] = -3.0  # -amax -> -7, and 0.25/(3/7) = 0.583 -> 1
    return w


@pytest.mark.parametrize("K,N,lead", [(256, 128, ()), (512, 384, ()), (256, 128, (3,))])
def test_pack_int4_byte_identical_to_jax(K, N, lead):
    w = _weights(0, K, N)
    if lead:
        w = np.stack([w * (i + 1) for i in range(lead[0])])
    ref = jax_w4.pack_int4(jnp.asarray(w))
    got = w4.pack_int4(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.shape == tuple(w.shape) and got.k_dim == K
    np.testing.assert_array_equal(w4.unpack_int4(got).numpy(), np.asarray(jax_w4.unpack_int4(ref)))
    if lead:
        assert got[1].shape == (K, N)
        np.testing.assert_array_equal(got[1].q.numpy(), np.asarray(ref.q)[1])


def test_pack_int4_edge_values():
    got = w4.pack_int4(torch.from_numpy(_weights(0, 256, 128)))
    ints = w4._unpack_ints(got.q).reshape(256, 128)
    assert (ints[:128, 0] == 0).all() and got.scale[0, 0] == 1.0
    assert got.scale[1, 1] == 1.0
    assert ints[130:138, 1].tolist() == [0, 2, 2, 0, -2, 4, -6, 6]
    assert ints[5, 2] == -7 and ints[0, 2] == 1
    assert ints.abs().max() <= 7


def test_unpack_takes_every_nibble_value():
    """Random packed bytes (as the random int4 init makes them) hold -8 too;
    unpacking matches JAX on all 256 byte values."""
    q = np.arange(-128, 128, dtype=np.int8).reshape(64, 4).repeat(32, axis=1)  # [64, 128]
    scale = np.full((1, 128), 0.5, np.float32)
    ref = jax_w4.unpack_int4(jax_w4.Q4Tensor(jnp.asarray(q), jnp.asarray(scale)))
    got = w4.unpack_int4(w4.Q4Tensor(torch.from_numpy(q), torch.from_numpy(scale)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("K,N", [(512, 512), (1024, 768)])
@pytest.mark.parametrize("rows", [1, 8, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4_matmul_matches_jax_kernel(K, N, rows, dtype):
    rng = np.random.default_rng(K + rows)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.sqrt(K)
    x = rng.standard_normal((rows, K), dtype=np.float32)
    jw = jax_w4.pack_int4(jnp.asarray(w))
    ref = np.asarray(
        jax_w4.w4_matmul(jnp.asarray(x, getattr(jnp, dtype)), jw, interpret=True), np.float32
    )
    tw = w4.Q4Tensor(torch.from_numpy(np.asarray(jw.q)), torch.from_numpy(np.asarray(jw.scale)))
    got = w4.w4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, N)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-6)


def test_w4_matmul_plain_is_the_group_sum():
    """The plain version scales each group's integer dot, not the dequantized
    weight: equal to the group loop written out, close to x @ unpack(w)."""
    rng = np.random.default_rng(3)
    w = w4.pack_int4(torch.from_numpy(rng.standard_normal((512, 256), dtype=np.float32)))
    x = torch.from_numpy(rng.standard_normal((5, 512), dtype=np.float32))
    ints = w4._unpack_ints(w.q).float()  # [4, 128, 256]
    by_group = sum((x[:, g * 128:(g + 1) * 128] @ ints[g]) * w.scale[g] for g in range(4))
    torch.testing.assert_close(w4.w4_matmul_plain(x, w), by_group, atol=0, rtol=0)
    torch.testing.assert_close(w4.w4_matmul_plain(x, w), x @ w4.unpack_int4(w), atol=1e-4, rtol=1e-5)


def test_split_k_fills_the_card_at_decode_rows():
    # The GEMV route (f32 x): 256-column tiles, at least 4 groups per CTA.
    assert w4.split_k(8, 4096, 1024, torch.float32) == 8  # 4 column tiles x 8 splits of 4 groups
    assert w4.split_k(8, 14336, 4096, route="gemv") == 16
    assert w4.split_k(1, 4096, 128256, route="gemv") == 1  # 501 column tiles already
    # The decode route (bf16 x up to the crossover): 128-column tiles, at
    # least 2 groups per CTA, doubled until every SM has a CTA.
    assert w4.split_k(8, 4096, 1024) == 16  # 8 column tiles x 16 splits of 2 groups
    assert w4.split_k(8, 14336, 4096) == 8  # 32 x 8 = 256 CTAs of 14 groups
    assert w4.split_k(8, 4096, 4096) == 8  # 32 x 8 = 256 CTAs of 4 groups
    assert w4.split_k(8, 4096, 14336) == 2  # 112 x 2 = 224 CTAs of 16 groups
    assert w4.split_k(1, 4096, 128256) == 1  # 1002 column tiles already
    # The prefill tensor-core route: until every SM has a CTA.
    assert w4.split_k(8, 4096, 1024, route="tc") == 16  # 8 column tiles x 16 splits of 2 groups
    assert w4.split_k(8, 14336, 4096, route="tc") == 8  # 32 x 8 = 256 CTAs of 14 groups
    assert w4.split_k(40, 4096, 128256) == 1  # 1002 column tiles already
    assert w4.split_k(2048, 4096, 14336) == 1  # 112 x 16 tiles of 128 rows
    assert w4.split_k(40, 1024, 768, torch.float32) == 2  # f32 at 40 rows: GEMV, 8 groups
    assert w4.split_k(300, 512, 384, torch.float32) == 1  # f32 tiled: never split
    assert w4.kernel_supports(4096, 1024) and not w4.kernel_supports(128, 1024)
    # The last column tile is masked: N need only keep the packed rows
    # 16-byte aligned (Llama-3-8B's lm_head over 4 and 8 ranks).
    assert w4.kernel_supports(4096, 64) and w4.kernel_supports(4096, 32064)
    assert w4.kernel_supports(4096, 16032) and not w4.kernel_supports(4096, 40)


# Llama-3-8B's int4 weights (K, N): w_gate/w_up, w_down, wq/wo, wk/wv, lm_head.
LLAMA3_8B_W4 = [(4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024), (4096, 128256)]


@pytest.mark.parametrize("K,N", LLAMA3_8B_W4)
def test_w4_route_and_split_k_at_8b_shapes(K, N):
    """The route is a pure function of dtype and rows: bf16 takes the decode
    kernel up to the measured crossover (32 rows: the last-token logits and
    decode at n <= 32) and the prefill tensor-core kernel above it (every
    prefill bucket); f32 the GEMV up to 64 rows and the tiled kernel above.
    Each tensor-core split (decode or prefill) keeps at least 2 whole groups
    per CTA and stops once the card's 132 SMs each have a CTA."""
    assert w4.TC_CROSSOVER_ROWS == 32
    groups = K // 128
    for rows in range(1, 65):
        route = w4.w4_route(rows, K, N, torch.bfloat16)
        assert route == ("decode" if rows <= 32 else "tc")
        ks = w4.split_k(rows, K, N)
        assert ks == w4.split_k(rows, K, N, route=route)
        tiles, target = N // 128 * (1 if route == "decode" else -(-rows // 64)), 132
        assert groups % ks == 0 and groups // ks >= 2
        if ks > 1:  # every doubling was needed ...
            assert tiles * (ks // 2) < target
        # ... and the split stops once the card is full or the groups run out
        assert tiles * ks >= target or groups % (2 * ks) or groups // (2 * ks) < 2
        assert w4.w4_route(rows, K, N, torch.float32) == "gemv"
    for rows in (65, 512, 2048):
        assert w4.w4_route(rows, K, N, torch.bfloat16) == "tc"
        assert w4.w4_route(rows, K, N, torch.float32) == "tiled"
    assert w4.split_k(2048, K, N, torch.float32) == 1


def test_w4_matmul_route_must_take_the_dtype():
    """A named route that does not take x's dtype raises before any launch
    (on a CPU tensor the plain version runs whatever the route)."""
    w = w4.pack_int4(torch.zeros(256, 128))
    x = torch.zeros(4, 256)
    assert torch.equal(w4.w4_matmul(x, w, route="tc"), w4.w4_matmul_plain(x, w))
    assert set(w4.ROUTES) == {"gemv", "tiled", "tc", "decode"}
    assert w4._DTYPE_ROUTES == {torch.bfloat16: ("decode", "tc"), torch.float32: ("gemv", "tiled")}


# --- the decode kernel's fragments (csrc/w4_matmul.cu, w4_decode_tc) ---------


def _nibble(byte, high):
    """The signed value of a packed byte's low or high nibble."""
    n = (int(byte) >> (4 if high else 0)) & 0xF
    return (n ^ 8) - 8


def _ldmatrix_trans_reg(tile, r0, c0, g, t):
    """ldmatrix.trans of the 8 x 8 b16 matrix at byte rows r0 .. +7, byte
    columns c0 .. +15 of ``tile``: lane (g, t) gets b16 elements [2t][g]
    (low half) and [2t+1][g], i.e. bytes (2t, c0+2g), (2t, c0+2g+1),
    (2t+1, c0+2g), (2t+1, c0+2g+1), lowest first."""
    b = [tile[r0 + 2 * t, c0 + 2 * g], tile[r0 + 2 * t, c0 + 2 * g + 1],
         tile[r0 + 2 * t + 1, c0 + 2 * g], tile[r0 + 2 * t + 1, c0 + 2 * g + 1]]
    return sum(int(v) << (8 * i) for i, v in enumerate(b))


def _nibbles_to_pair(w):
    """nibbles_to_bf16x2 on a register already XOR-ed with 0x88888888: bits
    0-3 and 16-19 become 128 + bits - 136 in bf16, the nibbles' signed
    values (low half, high half)."""
    return (128 + (w & 0xF)) - 136, (128 + ((w >> 16) & 0xF)) - 136


def test_decode_kernel_fragments_rebuild_the_tile():
    """A numpy model of w4_decode_tc's data flow for one warp and one group:
    the ldmatrix.trans registers of the packed bytes, the nibbles taken out
    of them as A fragments (W^T, columns 2i and 2i + 1 of an m16 tile as A
    rows i and i + 8), x's B fragments, the MMAs, the per-row scales and the
    stores. It rebuilds every A tile as the exact integer weights and the
    warp's 32 output columns as x @ (ints * scale) exactly."""
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)  # 64 byte rows x 32 columns
    ints = np.array([[_nibble(tile[k % 64, c], k >= 64) for c in range(32)] for k in range(128)])
    x = rng.integers(-4, 5, size=(8, 128)).astype(np.float64)
    scale = rng.integers(1, 9, size=32).astype(np.float64)
    out = np.zeros((8, 32))
    for c in range(2):  # the warp's two m16 tiles
        part = np.zeros((16, 8))  # outT rows (A rows) x rows of x
        for kk in range(4):
            for half in range(2):  # low nibbles: k-step kk; high: kk + 4
                a = np.zeros((16, 16))
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    # raw[2c]: byte rows 16kk .. +7; raw[2c+1]: 16kk + 8 .. +15.
                    w0 = _ldmatrix_trans_reg(tile, 16 * kk, 16 * c, g, t) ^ 0x88888888
                    w1 = _ldmatrix_trans_reg(tile, 16 * kk + 8, 16 * c, g, t) ^ 0x88888888
                    sh = 4 * half
                    a[g, 2 * t: 2 * t + 2] = _nibbles_to_pair(w0 >> sh)
                    a[g + 8, 2 * t: 2 * t + 2] = _nibbles_to_pair(w0 >> (8 + sh))
                    a[g, 2 * t + 8: 2 * t + 10] = _nibbles_to_pair(w1 >> sh)
                    a[g + 8, 2 * t + 8: 2 * t + 10] = _nibbles_to_pair(w1 >> (8 + sh))
                k0 = 16 * kk + 64 * half
                cols = [16 * c + 2 * i for i in range(8)] + [16 * c + 2 * i + 1 for i in range(8)]
                np.testing.assert_array_equal(a, ints[k0:k0 + 16, cols].T)
                # B fragments by ldmatrix of x: lane (g, t) holds x[g][k0 + 2t ..]
                # and x[g][k0 + 8 + 2t ..]: B[k][n] = x[n][k0 + k].
                bmat = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    bmat[2 * t: 2 * t + 2, g] = x[g, k0 + 2 * t: k0 + 2 * t + 2]
                    bmat[2 * t + 8: 2 * t + 10, g] = x[g, k0 + 8 + 2 * t: k0 + 10 + 2 * t]
                part += a @ bmat
        # Fold at the scales and store: lane (g, t) fragments 0, 1 (A row g,
        # x rows 2t, 2t+1) and 2, 3 (A row g + 8), scales (.x, .y) of columns
        # 16c + 2g and + 1.
        for lane in range(32):
            g, t = lane // 4, lane % 4
            sx, sy = scale[16 * c + 2 * g], scale[16 * c + 2 * g + 1]
            frag = [part[g, 2 * t] * sx, part[g, 2 * t + 1] * sx,
                    part[g + 8, 2 * t] * sy, part[g + 8, 2 * t + 1] * sy]
            for hr in range(2):
                col = 16 * c + 2 * g
                out[2 * t + hr, col] = frag[hr]
                out[2 * t + hr, col + 1] = frag[2 + hr]
    np.testing.assert_array_equal(out, x @ (ints * scale[None, :]))


def test_int8_quantize_and_qdot_equal_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((2, 64, 96), dtype=np.float32)
    w[0, :, 3] = 0.0
    x = rng.standard_normal((3, 7, 64), dtype=np.float32)
    jq = jax_quant.quantize_weight(jnp.asarray(w))
    tq = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    ref = np.asarray(jax_quant.qdot(jnp.asarray(x), jax_quant.QTensor(jq.q[1], jq.scale[1])))
    got = quant.qdot(torch.from_numpy(x), tq[1])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _leaf_kinds(params):
    def kind(w):
        return type(w).__name__ if type(w).__name__ in ("QTensor", "Q4Tensor") else "array"

    return {
        **{k: kind(v) for k, v in params["layers"].items()},
        "lm_head": kind(params["lm_head"]), "embed": kind(params["embed"]),
    }


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("eligible", [False, True])
def test_quantize_params_leaf_types_equal_jax(bits, eligible):
    jcfg = jax_get_config("tiny").with_(**(ELIGIBLE if eligible else {}))
    cfg = get_config("tiny").with_(**(ELIGIBLE if eligible else {}))
    jp = jax_init_params(jcfg, jax.random.key(0))
    ref = jax_quant.quantize_params(jp, bits=bits)
    got = quant.quantize_params(params_from_numpy(jax.device_get(jp), cfg), bits=bits)
    assert _leaf_kinds(got) == _leaf_kinds(ref)
    if eligible and bits == 4:
        assert _leaf_kinds(got)["w_down"] == _leaf_kinds(got)["lm_head"] == "Q4Tensor"
    # Stacked layers quantized layer by layer give JAX's bytes and scales.
    for key in ("wq", "w_down"):
        np.testing.assert_array_equal(got["layers"][key].q.numpy(), np.asarray(ref["layers"][key].q))
        np.testing.assert_array_equal(
            got["layers"][key].scale.numpy(), np.asarray(ref["layers"][key].scale)
        )
    # A quantized tree keeps its stored layout whatever the bits asked.
    again = quant.quantize_params(got, bits=12 - bits)
    assert again["layers"]["w_gate"] is got["layers"]["w_gate"]
    assert quant.stored_quant_layout(got) == ("int4" if eligible and bits == 4 else "int8")
    assert quant.tree_has_q4(got) == (eligible and bits == 4)


@pytest.mark.parametrize("bits", [4, 8])
def test_init_params_quantized_shapes_dtypes_scales_equal_jax(bits):
    jcfg = jax_get_config("tiny").with_(**ELIGIBLE)
    cfg = get_config("tiny").with_(**ELIGIBLE)
    ref = jax.device_get(jax_quant.init_params_quantized(jcfg, jax.random.key(0), bits=bits))
    got = quant.init_params_quantized(cfg, torch.Generator().manual_seed(0), "cpu", bits=bits)
    assert _leaf_kinds(got) == _leaf_kinds(ref)

    def leaves(p):
        out = {"embed": p["embed"], "final_norm": p["final_norm"], "lm_head": p["lm_head"]}
        out.update({f"layers.{k}": v for k, v in p["layers"].items()})
        return out

    for name, r in leaves(ref).items():
        g = leaves(got)[name]
        if type(r).__name__ in ("QTensor", "Q4Tensor"):
            assert tuple(g.q.shape) == r.q.shape and g.q.dtype == torch.int8
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(r.scale))
        else:
            assert tuple(g.shape) == r.shape and str(g.dtype).endswith(str(r.dtype)), name
