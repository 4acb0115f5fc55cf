"""w4a16 matmul: int4 weight-only quantization with a hand-written CUDA kernel.

Counterpart of ``k_llms_tpu/ops/w4matmul.py``. Storage format, byte for byte
the JAX package's: weights are grouped along the contraction axis (GROUP =
128 rows per group, one f32 scale per (group, output column), symmetric,
values clipped to [-7, 7]); a group's rows 0..63 live in the LOW nibbles
and rows 64..127 in the HIGH nibbles of the same 64 packed byte rows.

``w4_matmul`` launches ``csrc/w4_matmul.cu`` for tensors on a card (the
nibbles are unpacked on chip; device memory only ever holds the 4-bit
weights; :func:`w4_route` picks its kernel) and runs
:func:`w4_matmul_plain`, the kernel's arithmetic in plain PyTorch, for
tensors on the CPU. Unlike the JAX function, it has no
dequantize-then-matmul fallback: a CUDA call on a shape the kernel does not
take raises (``quantize_weight_bits`` never builds a Q4Tensor of one).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _ext

GROUP = 128  # contraction rows per quantization group (one scale each)
_HALF = GROUP // 2


class Q4Tensor:
    """Packed int4 weight: ``q`` int8 [..., K/2, N] (two nibbles per byte
    along the contraction axis), ``scale`` f32 [..., K/GROUP, N]. ``w[i]``
    indexes the leading (layer) axis of both. On a mesh, ``part`` ("col" or
    "row") and ``mesh`` mark this rank's shard of a tensor-parallel weight,
    and ``quant.qdot`` takes :func:`w4_matmul_tp`."""

    __slots__ = ("q", "scale", "part", "mesh")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, part: Optional[str] = None,
                 mesh=None):
        self.q = q
        self.scale = scale
        self.part = part
        self.mesh = mesh

    def __getitem__(self, idx) -> "Q4Tensor":
        return Q4Tensor(self.q[idx], self.scale[idx], self.part, self.mesh)

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
        return Q4Tensor(self.q.to(device), self.scale.to(device), self.part, self.mesh)

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


# Routes of ``csrc/w4_matmul.cu``: for bf16 x, the decode kernel up to the
# crossover (the weight streamed once through tensor-core MMAs with the rows
# as N; split K finished by the last CTA of each column tile) and the
# prefill tensor-core kernel above it (64-row tiles up to 64 rows, then
# 128); for f32 x, the GEMV kernel up to 64 rows (f32 on the CUDA cores,
# split K over CTAs so that about _TARGET_CTAS run at once) and the f32
# tiled kernel above.
ROUTES = {"gemv": 0, "tiled": 1, "tc": 2, "decode": 3}
_DTYPE_ROUTES = {torch.bfloat16: ("decode", "tc"), torch.float32: ("gemv", "tiled")}
# bf16 rows at or below which the decode kernel beats the prefill
# tensor-core kernel over a Llama-3-8B layer's block matmuls and lm_head
# (chip_smoke.py phase k4 measures both in device time at 1-32 rows; see
# PERF.md): the last-token logits and decode at n <= 32 take the decode
# kernel, every prefill bucket the prefill kernel.
TC_CROSSOVER_ROWS = 32
_DECODE_MAX_ROWS = 32
_F32_GEMV_MAX_ROWS = 64
_TARGET_CTAS = 264
_GEMV_COLS = 256
_TC_COLS = 128
_SMS = 132
_ROW_ALIGN = 16  # packed row bytes: the kernels' 16-byte column chunks


def w4_route(rows: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of ``rows`` x ``K`` @ int4 ``K`` x ``N`` takes:
    "decode" or "tc" (bf16 tensor cores), "gemv" or "tiled" (f32 CUDA
    cores)."""
    del K, N  # one crossover: each 8B weight, lm_head included, agrees with it
    if dtype == torch.bfloat16:
        return "decode" if rows <= TC_CROSSOVER_ROWS else "tc"
    return "gemv" if rows <= _F32_GEMV_MAX_ROWS else "tiled"


def split_k(rows: int, K: int, N: int, dtype: torch.dtype = torch.bfloat16,
            route: Optional[str] = None) -> int:
    """How many CTAs share one output tile's contraction, doubled while the
    card is underfilled and each CTA keeps enough groups: on the GEMV route
    until about ``_TARGET_CTAS`` run (at least 4 groups each, one per
    warp), on the tensor-core routes until every SM has a CTA (at least 2
    groups each; the decode kernel's rows all fit one tile). 1 on the f32
    tiled route, which does not split. ``route`` defaults to
    :func:`w4_route`'s choice."""
    route = route or w4_route(rows, K, N, dtype)
    groups = K // GROUP
    if route == "gemv":
        tiles, target, min_groups = -(-N // _GEMV_COLS), _TARGET_CTAS, 4
    elif route in ("decode", "tc"):
        row_tiles = 1 if route == "decode" else -(-rows // (64 if rows <= 64 else 128))
        tiles, target, min_groups = -(-N // _TC_COLS) * row_tiles, _SMS, 2
    else:
        return 1
    ksplit = 1
    while (groups % (2 * ksplit) == 0 and groups // (2 * ksplit) >= min_groups
           and tiles * ksplit < target):
        ksplit *= 2
    return ksplit


def kernel_supports(K: int, N: int) -> bool:
    """K4 takes whole 256-row K blocks and any N that keeps its packed rows
    16-byte aligned: each route masks its last column tile, so a shard
    such as Llama-3-8B's lm_head over 4 ranks ([4096, 32064]) runs on it."""
    return supports_int4(K) and N % _ROW_ALIGN == 0


def w4_matmul(x: torch.Tensor, w: Q4Tensor, *, route: Optional[str] = None) -> torch.Tensor:
    """``x @ dequant(w)`` with 4-bit weight traffic. x: [rows, K] (bf16 or
    f32); returns [rows, N] in x's dtype.

    Tensors on a card go to the CUDA kernel (or the call raises); tensors on
    the CPU go to :func:`w4_matmul_plain`. ``route`` names the kernel
    instead of :func:`w4_route` (to time the routes against each other at
    one shape); a route that does not take x's dtype raises.
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
            f"scale={tuple(w.scale.shape)} not taken by the kernel (K % 256, N % 16)"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4_matmul: activations {x.dtype} unsupported")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise ValueError(f"w4_matmul: weight dtypes {w.q.dtype}/{w.scale.dtype} unsupported")
    for name, t in (("x", x), ("q", w.q), ("scale", w.scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w4_matmul: {name} must be contiguous, 16-byte aligned, on {x.device}")
    if route is None:
        route = w4_route(rows, K, N, x.dtype)
    if route not in _DTYPE_ROUTES[x.dtype]:
        raise ValueError(f"w4_matmul: route {route!r} does not take {x.dtype} activations")
    if route == "decode" and rows > _DECODE_MAX_ROWS:
        raise ValueError(f"w4_matmul: the decode route takes at most {_DECODE_MAX_ROWS} rows")
    ksplit = split_k(rows, K, N, x.dtype, route)
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    partial = sem = None
    if ksplit > 1:
        partial = torch.empty((ksplit, rows, N), dtype=torch.float32, device=x.device)
        if route == "decode":
            sem = _ext.semaphores(x.device, -(-N // _TC_COLS))
    lib = _ext.load("w4_matmul")
    status = lib.kllms_w4_matmul(
        x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        sem.data_ptr() if sem is not None else None,
        rows, K, N, int(x.dtype == torch.bfloat16), ROUTES[route], ksplit,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _ext.check_status("w4_matmul", status)
    _ext.note_launch("w4_matmul")
    return out


def _w4_matmul_tp(x: torch.Tensor, w: Q4Tensor, matmul) -> torch.Tensor:
    from ..parallel.collectives import psum
    from ..parallel.mesh import MODEL_AXIS

    if w.part == "col":
        return matmul(x, w)
    if w.part == "row":
        return psum(matmul(x, w), MODEL_AXIS, w.mesh)
    raise ValueError(f"unknown partition kind {w.part!r}")


def w4_matmul_tp(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """``x @ dequant(w)`` over the weight's tensor-parallel layout
    (``w.part``/``w.mesh``), the JAX function's ``shard_map`` body on this
    rank: K4 (:func:`w4_matmul`) on the rank's shard, then

    - ``col``: nothing; x [rows, K] replicated over model, the weight and
      the output [rows, N/TP] sharded on their columns;
    - ``row``: the partials [rows, N] summed over model (one ``psum``); x
      [rows, K/TP] arrives sharded on its last dimension, the Megatron
      row-parallel input.

    Rows are whatever this rank holds (the JAX function's rows over
    ``data`` when they divide, else replicated): no collective crosses
    ``data``. On the CPU the shard's product is :func:`w4_matmul_plain`.
    Its launches are K4's (``w4_matmul``'s count)."""
    return _w4_matmul_tp(x, w, w4_matmul)


def w4_matmul_tp_plain(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """:func:`w4_matmul_tp` built on :func:`w4_matmul_plain` (the CPU and
    the tests; never the card path)."""
    return _w4_matmul_tp(x, w, w4_matmul_plain)
