"""Prefill flash attention: a hand-written CUDA kernel and its plain version.

Counterpart of ``k_llms_tpu/ops/attention.py``. ``attention_xla`` is the
always-available reference formulation (an explicit score matrix and a
softmax). ``flash_attention`` keeps the Pallas kernel's contract and launches
``csrc/flash_attention.cu`` for tensors on a card; for tensors on the CPU it
runs :func:`flash_attention_plain`, the same function written in plain
PyTorch. The shared-prefix decode kernel (``decode_prefix_attention``) is not
ported yet.
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
        float(scale), int(bool(causal)), float(softcap or 0.0), window, q_offset,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _ext.check_status("flash_attention", status)
    _ext.note_launch("flash_attention")
    return out
