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
:func:`decode_prefix_attention_plain`), its key walk split over the card's SMs
by :func:`decode_prefix_split_plan` (modelled on the CPU by
:func:`decode_prefix_attention_split`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

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


#: SMs of the card the K1 and K3 split plans fill (an H100 SXM has 132).
_SMS = 132
#: Query rows (of one request and kv head) one CTA of the K3 kernel serves.
PREFIX_TILE_ROWS = 32
#: Keys per block of the K3 kernel's walk; splits cut whole blocks.
PREFIX_KEY_BLOCK = 64


def decode_prefix_route(dtype: torch.dtype, head_dim: int) -> str:
    """The split kernel of ``csrc/decode_prefix.cu`` a CUDA call takes: "tc"
    (bf16 tensor cores, bf16 at head dims 64, 128 and 256) or "simt" (f32
    products on the CUDA cores: f32 inputs, which TF32 would change, and
    bf16 at head dim 16)."""
    return "tc" if dtype == torch.bfloat16 and head_dim in _TC_DIMS else "simt"


def decode_prefix_split_plan(B: int, R: int, QH: int, KVH: int, D: int, P: int,
                             dtype: torch.dtype) -> Tuple[str, int, int]:
    """How the K3 kernel cuts the work, from shapes alone: ``(route, tiles,
    splits)``.

    A CTA serves one tile of up to 32 query rows (``n * G`` rows of a
    request and kv head, ``tiles`` of them) over one of ``splits``
    contiguous ranges of the request's valid key blocks
    (:func:`split_key_blocks`, computed by each CTA from the prompt length
    on the device). ``splits`` is the fewest that put about one CTA on each
    of the card's 132 SMs, at most one per key block of the bucket."""
    QR = (B // R) * (QH // KVH)
    tiles = -(-QR // PREFIX_TILE_ROWS)
    splits = max(1, min(-(-P // PREFIX_KEY_BLOCK), -(-_SMS // (R * tiles * KVH))))
    return decode_prefix_route(dtype, D), tiles, splits


def split_key_blocks(n_blocks: int, splits: int) -> List[Tuple[int, int]]:
    """The key blocks ``[lo, hi)`` each split walks, when the request has
    ``n_blocks`` blocks with a valid key: contiguous, in order, sizes within
    one of each other (some empty when there are more splits than blocks)."""
    return [(s * n_blocks // splits, (s + 1) * n_blocks // splits) for s in range(splits)]


def decode_prefix_attention_split(
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_ranges: Callable[[int, int], List[Tuple[int, int]]] = split_key_blocks,
):
    """The K3 kernel's split and merge in plain f32 PyTorch, for the tests
    and the card's mutants: each split of :func:`decode_prefix_split_plan`
    gives its rows' (unnormalised out, max, denominator) over the keys of its
    blocks (``block_ranges``) that lie before the prompt length, then each
    row's splits are merged in split order, an empty split weighing an exact
    0. Same arguments and results as :func:`decode_prefix_attention`."""
    B, QH, D = q.shape
    R, P, KVH, _ = prefix_k.shape
    G, n_per = QH // KVH, B // R
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    _, _, splits = decode_prefix_split_plan(B, R, QH, KVH, D, P, q.dtype)
    qg = q.float().reshape(R, n_per, KVH, G, D)
    out = torch.empty((R, n_per, KVH, G, D), dtype=torch.float32, device=q.device)
    m_out = torch.empty((R, n_per, KVH, G), dtype=torch.float32, device=q.device)
    l_out = torch.empty_like(m_out)
    for r, plen in enumerate(prompt_lens.tolist()):
        plen = min(max(int(plen), 0), P)
        parts = []
        for lo, hi in block_ranges(-(-plen // PREFIX_KEY_BLOCK), splits):
            keys = slice(lo * PREFIX_KEY_BLOCK, min(hi * PREFIX_KEY_BLOCK, plen))
            o = torch.zeros((n_per, KVH, G, D), device=q.device)
            m = torch.full((n_per, KVH, G), -math.inf, device=q.device)
            l = torch.zeros((n_per, KVH, G), device=q.device)
            if keys.stop > keys.start:
                s = torch.einsum("nhgd,khd->nhgk", qg[r], prefix_k[r, keys].float()) * scale
                m = s.amax(-1)
                p = torch.exp(s - m[..., None])
                l = p.sum(-1)
                o = torch.einsum("nhgk,khd->nhgd", p, prefix_v[r, keys].float())
            parts.append((o, m, l))
        m = torch.stack([pm for _, pm, _ in parts]).amax(0) if parts else torch.full(
            (n_per, KVH, G), -math.inf, device=q.device)
        acc = torch.zeros((n_per, KVH, G, D), device=q.device)
        l = torch.zeros((n_per, KVH, G), device=q.device)
        for po, pm, pl in parts:
            w = torch.where(pm == -math.inf, torch.zeros_like(pm), torch.exp(pm - m))
            acc = acc + w[..., None] * po
            l = l + w * pl
        out[r] = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
        m_out[r] = torch.where(m == -math.inf, torch.full_like(m, NEG_INF), m)
        l_out[r] = l
    return out.reshape(B, QH, D), m_out.reshape(B, QH), l_out.reshape(B, QH)


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

    Tensors on a card go to the CUDA kernel (or the call raises): one launch
    of the split kernel picked by :func:`decode_prefix_split_plan` and one of
    its merge, with no host sync, so the call can be captured in a CUDA
    graph. Tensors on the CPU go to :func:`decode_prefix_attention_plain`.
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
    route, tiles, splits = decode_prefix_split_plan(B, R, QH, KVH, D, P, dt)
    out = torch.empty((B, QH, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, QH), dtype=torch.float32, device=q.device)
    l = torch.empty((B, QH), dtype=torch.float32, device=q.device)
    o_part = torch.empty((splits, B, QH, D), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((splits, B, QH, 2), dtype=torch.float32, device=q.device)
    lib = _ext.load("decode_prefix")
    status = lib.kllms_decode_prefix_attention(
        q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(),
        B, QH, KVH, D, R, P, int(dt == torch.bfloat16), int(route == "tc"), tiles, splits,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _ext.check_status("decode_prefix_attention", status)
    _ext.note_launch("decode_prefix_attention")
    return out, m, l
