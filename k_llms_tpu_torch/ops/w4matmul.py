"""w4a16 matmul: int4 weight-only quantization with a hand-written CUDA kernel.

Counterpart of ``k_llms_tpu/ops/w4matmul.py``. Storage format, byte for byte
the JAX package's: weights are grouped along the contraction axis (GROUP =
128 rows per group, one f32 scale per (group, output column), symmetric,
values clipped to [-7, 7]); a group's rows 0..63 live in the LOW nibbles
and rows 64..127 in the HIGH nibbles of the same 64 packed byte rows.

``w4_matmul`` launches ``csrc/w4_matmul.cu`` for tensors on a card (the
nibbles are unpacked on chip; device memory only ever holds the 4-bit
weights) and runs :func:`w4_matmul_plain`, the kernel's arithmetic in plain
PyTorch, for tensors on the CPU. Unlike the JAX function, it has no
dequantize-then-matmul fallback: a CUDA call on a shape the kernel does not
take raises (``quantize_weight_bits`` never builds a Q4Tensor of one).
"""

from __future__ import annotations

import torch

from . import _ext

GROUP = 128  # contraction rows per quantization group (one scale each)
_HALF = GROUP // 2


class Q4Tensor:
    """Packed int4 weight: ``q`` int8 [..., K/2, N] (two nibbles per byte
    along the contraction axis), ``scale`` f32 [..., K/GROUP, N]. ``w[i]``
    indexes the leading (layer) axis of both."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, idx) -> "Q4Tensor":
        return Q4Tensor(self.q[idx], self.scale[idx])

    def __repr__(self) -> str:
        return f"Q4Tensor(q={tuple(self.q.shape)}, scale={tuple(self.scale.shape)})"

    @property
    def k_dim(self) -> int:
        return self.q.shape[-2] * 2

    @property
    def shape(self):
        return tuple(self.q.shape[:-2]) + (self.k_dim, self.q.shape[-1])

    @property
    def dtype(self):
        return self.q.dtype

    def to(self, device) -> "Q4Tensor":
        return Q4Tensor(self.q.to(device), self.scale.to(device))

    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4


def supports_int4(k: int) -> bool:
    """The kernel needs whole groups and at least one 256-row K block."""
    return k % 256 == 0


def pack_int4(w: torch.Tensor) -> Q4Tensor:
    """Group-wise symmetric int4 quantization of ``w`` [..., K, N]: per
    group of GROUP contraction rows, scale = amax / 7 (1.0 for an all-zero
    group), values rounded half to even and clipped to [-7, 7]. Rows
    [0, 64) of each group pack into low nibbles, rows [64, 128) into high
    nibbles of the same byte rows."""
    *lead, K, N = w.shape
    if K % GROUP != 0:
        raise ValueError(f"contraction dim {K} not a multiple of group {GROUP}")
    g = w.float().reshape(*lead, K // GROUP, GROUP, N)
    amax = g.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -7, 7).to(torch.int32)
    lo = q[..., :_HALF, :]
    hi = q[..., _HALF:, :]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    return Q4Tensor(
        q=packed.reshape(*lead, K // 2, N).contiguous(),
        scale=scale[..., 0, :].reshape(*lead, K // GROUP, N).contiguous(),
    )


def _unpack_ints(q: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., K/2, N] -> signed nibble values int32 [..., K/GROUP,
    GROUP, N] (group-major, low-nibble rows first)."""
    *lead, Kh, N = q.shape
    p = q.to(torch.int32).reshape(*lead, Kh * 2 // GROUP, _HALF, N)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4  # arithmetic shift of the sign-extended byte
    return torch.cat([lo, hi], dim=-2)


def unpack_int4(w: Q4Tensor) -> torch.Tensor:
    """Dequantize to f32 [..., K, N] (reference use only: the model path
    never materializes it)."""
    ints = _unpack_ints(w.q).float()
    deq = ints * w.scale[..., None, :]
    *lead, _, _, N = deq.shape
    return deq.reshape(*lead, w.k_dim, N)


def w4_matmul_plain(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: for each group, the f32 dot
    of x with the group's exact integers, times the group's scales, summed
    over groups in f32. x: [rows, K]; returns [rows, N] in x's dtype."""
    rows, K = x.shape
    if K != w.k_dim or w.q.dim() != 2:
        raise ValueError(f"w4_matmul: x {tuple(x.shape)} vs packed weight {tuple(w.q.shape)}")
    x32 = x.float()
    acc = torch.zeros((rows, w.q.shape[-1]), dtype=torch.float32, device=x.device)
    for g in range(K // GROUP):
        ints = _unpack_ints(w.q[g * _HALF: (g + 1) * _HALF])[0].float()  # [GROUP, N]
        acc += (x32[:, g * GROUP: (g + 1) * GROUP] @ ints) * w.scale[g]
    return acc.to(x.dtype)


# Decode-sized calls (rows <= 64) take the kernel's GEMV path, which splits
# long contractions over CTAs so that about this many run at once.
_TARGET_CTAS = 264
_GEMV_COLS = 256
_GEMV_MAX_ROWS = 64


def split_k(rows: int, K: int, N: int) -> int:
    """How many CTAs share one column tile's contraction (the GEMV path):
    doubled while the card has under ``_TARGET_CTAS`` CTAs and each keeps at
    least 4 groups (one per warp). 1 for the tiled path (rows > 64)."""
    if rows > _GEMV_MAX_ROWS:
        return 1
    groups = K // GROUP
    tiles = -(-N // _GEMV_COLS)
    ksplit = 1
    while groups % (2 * ksplit) == 0 and groups // (2 * ksplit) >= 4 and tiles * ksplit < _TARGET_CTAS:
        ksplit *= 2
    return ksplit


def kernel_supports(K: int, N: int) -> bool:
    return supports_int4(K) and N % 128 == 0


def w4_matmul(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """``x @ dequant(w)`` with 4-bit weight traffic. x: [rows, K] (bf16 or
    f32); returns [rows, N] in x's dtype.

    Tensors on a card go to the CUDA kernel (or the call raises); tensors on
    the CPU go to :func:`w4_matmul_plain`.
    """
    if x.device.type == "cpu":
        return w4_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"w4_matmul: unsupported device {x.device}")
    if x.dim() != 2 or w.q.dim() != 2 or w.scale.dim() != 2:
        raise ValueError(f"w4_matmul: x {tuple(x.shape)} must be 2-D and the weight unstacked")
    rows, K = x.shape
    Kh, N = w.q.shape
    if K != 2 * Kh or w.scale.shape != (K // GROUP, N) or not kernel_supports(K, N) or rows == 0:
        raise ValueError(
            f"w4_matmul: shape x={tuple(x.shape)} q={tuple(w.q.shape)} "
            f"scale={tuple(w.scale.shape)} not taken by the kernel (K % 256, N % 128)"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4_matmul: activations {x.dtype} unsupported")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise ValueError(f"w4_matmul: weight dtypes {w.q.dtype}/{w.scale.dtype} unsupported")
    for name, t in (("x", x), ("q", w.q), ("scale", w.scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w4_matmul: {name} must be contiguous, 16-byte aligned, on {x.device}")
    ksplit = split_k(rows, K, N)
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    partial = (
        torch.empty((ksplit, rows, N), dtype=torch.float32, device=x.device) if ksplit > 1 else None
    )
    lib = _ext.load("w4_matmul")
    status = lib.kllms_w4_matmul(
        x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        rows, K, N, int(x.dtype == torch.bfloat16), ksplit,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _ext.check_status("w4_matmul", status)
    _ext.note_launch("w4_matmul")
    return out
