"""Attention kernels: prefill flash attention and shared-prefix decode
attention, each a hand-written CUDA kernel beside its plain version.

Counterpart of ``k_llms_tpu/ops/attention.py``. ``attention_xla`` is the
always-available reference formulation (an explicit score matrix and a
softmax). ``flash_attention`` keeps the Pallas kernel's contract and launches
``csrc/flash_attention.cu`` for tensors on a card (its tensor-core kernel for
bf16, see :func:`flash_route`); for tensors on the CPU it runs
:func:`flash_attention_plain`, the same function written in plain PyTorch.
``decode_prefix_attention`` does the same for the decode step's attention
over a shared prompt prefix (``csrc/decode_prefix.cu`` /
:func:`decode_prefix_attention_plain`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _ext

NEG_INF = float(torch.finfo(torch.float32).min)
NO_WINDOW = 1 << 30


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention. q: [B, QH, Sq, D]; k/v: [B, KVH, Sk, D];
    key_mask: [B, Sk] booleans. Returns [B, QH, Sq, D] (f32)."""
    B, QH, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = QH // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, KVH, G, Sq, D)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        cmask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        scores = scores.masked_fill(~cmask, NEG_INF)
    if key_mask is not None:
        keep = key_mask.to(torch.bool)[:, None, None, None, :]
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights, v.float())
    return out.reshape(B, QH, Sq, D)


def _flash_valid(B, Sq, Sk, key_lengths, causal, window, q_offset, device):
    """[B, 1, Sq, Sk] validity of (query row, key column) under the flash
    contract: c < key_lengths[b], c > pos - window, and c <= pos when
    causal, where pos = row + q_offset."""
    rows = torch.arange(Sq, device=device)[:, None] + int(q_offset)
    cols = torch.arange(Sk, device=device)[None, :]
    valid = cols > rows - int(window)
    if causal:
        valid = valid & (cols <= rows)
    lens = key_lengths.to(device=device, dtype=torch.int64)[:, None, None, None]
    return valid[None, None] & (cols[None, None] < lens)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    key_lengths: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window=None,
    q_offset=None,
) -> torch.Tensor:
    """The flash kernel's function in plain PyTorch (f32 scores and softmax,
    dense score matrix). Same arguments and result as
    :func:`flash_attention`; a row with no valid key is zeros."""
    B, QH, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = QH // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if key_lengths is None:
        key_lengths = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    window = NO_WINDOW if window is None else int(window)
    q_offset = 0 if q_offset is None else int(q_offset)

    qg = q.float().reshape(B, KVH, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.reshape(B, QH, Sq, Sk)
    valid = _flash_valid(B, Sq, Sk, key_lengths, causal, window, q_offset, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bhgqk,bhkd->bhgqd", p.reshape(B, KVH, G, Sq, Sk), v.float()
    ).reshape(B, QH, Sq, D)
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(m == NEG_INF, torch.zeros_like(out), out)
    return out.to(q.dtype)


_SUPPORTED_DIMS = (16, 64, 128, 256)
_TC_DIMS = (64, 128, 256)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a CUDA call takes: "tc"
    (bf16 tensor cores, bf16 at head dims 64, 128 and 256) or "simt" (f32
    on the CUDA cores: f32 inputs, which TF32 would change, and bf16 at
    the other head dims)."""
    return "tc" if dtype == torch.bfloat16 and head_dim in _TC_DIMS else "simt"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    key_lengths: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window=None,
    q_offset=None,
) -> torch.Tensor:
    """Prefill flash attention. q: [B, QH, Sq, D]; k/v: [B, KVH, Sk, D];
    key_lengths: [B] int32 — keys at positions >= length are masked.
    ``softcap`` applies cap*tanh(s/cap) to the scaled scores; ``window``
    limits each query to the last W keys; ``q_offset`` is the absolute
    position of query row 0 (causality and windows are evaluated at
    row + q_offset). Returns [B, QH, Sq, D] in q's dtype.

    Tensors on a card go to the CUDA kernel (or the call raises); tensors on
    the CPU go to :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, key_lengths=key_lengths, sm_scale=sm_scale,
            softcap=softcap, window=window, q_offset=q_offset,
        )
    B, QH, Sq, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    KVH, Sk = k.shape[1], k.shape[2]
    if QH % KVH:
        raise ValueError(f"flash_attention: {QH} query heads do not group over {KVH} kv heads")
    if D not in _SUPPORTED_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_SUPPORTED_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} unsupported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous, 16-byte aligned, on {q.device}")
    if key_lengths is None:
        key_lengths = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    key_lengths = key_lengths.to(device=q.device, dtype=torch.int32).reshape(B).contiguous()
    window = NO_WINDOW if window is None else int(window)
    q_offset = 0 if q_offset is None else int(q_offset)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    out = torch.empty_like(q)
    lib = _ext.load("flash_attention")
    status = lib.kllms_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), key_lengths.data_ptr(),
        B, QH, KVH, Sq, Sk, D, int(q.dtype == torch.bfloat16),
        int(flash_route(q.dtype, D) == "tc"), float(scale), int(bool(causal)),
        float(softcap or 0.0), window, q_offset,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _ext.check_status("flash_attention", status)
    _ext.note_launch("flash_attention")
    return out


def decode_prefix_attention_plain(
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
):
    """The decode-prefix kernel's function in plain PyTorch (f32 scores,
    one softmax over the valid keys). Same arguments and results as
    :func:`decode_prefix_attention`."""
    B, QH, D = q.shape
    R, P, KVH, _ = prefix_k.shape
    G = QH // KVH
    n_per = B // R
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(R, n_per, KVH, G, D)
    s = torch.einsum("rnhgd,rkhd->rnhgk", qg, prefix_k.float()) * scale
    valid = torch.arange(P, device=q.device)[None, :] < prompt_lens.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("rnhgk,rkhd->rnhgd", p, prefix_v.float())
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.reshape(B, QH, D), m.reshape(B, QH), l.reshape(B, QH)


def decode_prefix_attention(
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
):
    """Decode-step attention over the shared prompt prefix.

    q: [B, QH, D] (rows request-major, B % R == 0); prefix_k/prefix_v:
    [R, P, KVH, D]; prompt_lens: [R] valid key counts, each in [1, P].
    Returns (out [B, QH, D] f32 normalized within the prefix, m [B, QH] f32
    the max of the scaled scores over the valid keys, l [B, QH] f32 the
    softmax denominator at m) for the caller's merge with the generated
    tail.

    Tensors on a card go to the CUDA kernel (or the call raises); tensors on
    the CPU go to :func:`decode_prefix_attention_plain`.
    """
    if q.device.type == "cpu":
        return decode_prefix_attention_plain(q, prefix_k, prefix_v, prompt_lens, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_prefix_attention: unsupported device {q.device}")
    B, QH, D = q.shape
    if prefix_k.dim() != 4 or prefix_k.shape != prefix_v.shape or prefix_k.shape[3] != D:
        raise ValueError(
            f"decode_prefix_attention: bad shapes q={tuple(q.shape)} "
            f"k={tuple(prefix_k.shape)} v={tuple(prefix_v.shape)}"
        )
    R, P, KVH, _ = prefix_k.shape
    if QH % KVH or B % R or P == 0:
        raise ValueError(f"decode_prefix_attention: {B} rows / {QH} heads do not group over "
                         f"{R} requests / {KVH} kv heads")
    if D not in _SUPPORTED_DIMS:
        raise ValueError(f"decode_prefix_attention: head dim {D} not in {_SUPPORTED_DIMS}")
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or prefix_k.dtype != dt or prefix_v.dtype != dt:
        raise ValueError(f"decode_prefix_attention: dtypes {dt}/{prefix_k.dtype}/{prefix_v.dtype} unsupported")
    for name, t in (("q", q), ("prefix_k", prefix_k), ("prefix_v", prefix_v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_prefix_attention: {name} must be contiguous, 16-byte aligned, on {q.device}")
    lens = prompt_lens.to(device=q.device, dtype=torch.int32).reshape(R).contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, QH, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, QH), dtype=torch.float32, device=q.device)
    l = torch.empty((B, QH), dtype=torch.float32, device=q.device)
    lib = _ext.load("decode_prefix")
    status = lib.kllms_decode_prefix_attention(
        q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), B, QH, KVH, D, R, P,
        int(dt == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _ext.check_status("decode_prefix_attention", status)
    _ext.note_launch("decode_prefix_attention")
    return out, m, l
