"""Fused paged-decode attention: a hand-written CUDA kernel, its plain
version, and the dense-equivalent reference.

Counterpart of ``k_llms_tpu/ops/paged_attention.py``. One contract, three
functions:

- ``paged_decode_attention``: the fused op. Tensors on a card go to
  ``csrc/paged_decode.cu`` (the block-table gather is the kernel's K/V load,
  nothing dense is materialized); tensors on the CPU go to
  :func:`paged_decode_attention_plain`.
- ``paged_decode_attention_plain``: the kernel's function in plain PyTorch,
  on the kernel's arguments (page tables, phases, lengths).
- ``paged_decode_attention_xla``: the reference on flat slot maps and masks,
  operation for operation the dense decode branch of ``models/llama.py`` —
  what the engine runs when the kernel is not selected.

``resolve_paged_attention_impl`` picks between the kernel ("cuda") and the
reference ("xla"): "auto" selects the kernel for a card and the reference on
the CPU.

Masking contract: out-of-table positions point into the trash page; their
values are arbitrary but finite and every consumer masks their scores before
the softmax max, so they contribute an exact 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _ext
from .attention import NEG_INF

#: Values accepted by ``LocalEngine(paged_attention_impl=...)``.
PAGED_ATTENTION_IMPLS = ("auto", "cuda", "xla")


def resolve_paged_attention_impl(requested: str, *, device) -> str:
    """Pick the paged-attention implementation: "cuda" (the kernel) or "xla"
    (the reference). "auto" takes the kernel on a card and the reference on
    the CPU; an explicit "cuda" on CPU tensors runs the kernel's plain
    version through the same wrapper. Models the kernel cannot serve
    (softcaps, sliding windows) are refused earlier, by
    ``models.llama.check_supported``."""
    if requested not in PAGED_ATTENTION_IMPLS:
        raise ValueError(
            f"paged_attention_impl must be one of {PAGED_ATTENTION_IMPLS}, got {requested!r}"
        )
    if requested != "auto":
        return requested
    return "cuda" if torch.device(device).type == "cuda" else "xla"


def paged_decode_attention_xla(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_idx: torch.Tensor,
    gen_idx: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    write_index: torch.Tensor,
    key_mask: torch.Tensor,
    prefix_mask: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Reference paged decode attention, the dense decode math on gathered
    pages. q/new_k/new_v: ``[B, Sq, QH|KVH, D]``; pool_k/pool_v: one layer's
    pool ``[pages * page_size, KVH, D]``; prefix_idx ``[B|R, P]`` / gen_idx
    ``[B, G]``: flat pool slots per logical position; write_index ``[B]``:
    each row's offset into its gen slots; key_mask ``[B, Sq, G]`` /
    prefix_mask ``[B, Sq, P]``. Returns ``[B, Sq, QH, D]`` f32."""
    from ..models.llama import (
        _gqa_scores,
        _gqa_scores_shared,
        _gqa_values,
        _gqa_values_shared,
    )

    pk, pv = pool_k[prefix_idx.long()], pool_v[prefix_idx.long()]  # [B|R, P, KVH, D]
    gk, gv = pool_k[gen_idx.long()], pool_v[gen_idx.long()]  # [B, G, KVH, D]
    # The dense path's per-row cache write: the fresh column lands at each
    # row's own offset before attention reads it.
    B, Sq = q.shape[0], q.shape[1]
    rows = torch.arange(B, device=q.device)[:, None]
    cols = write_index.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    gk[rows, cols] = new_k.to(gk.dtype)
    gv[rows, cols] = new_v.to(gv.dtype)

    scores = _gqa_scores(q, gk) * sm_scale  # [B, QH, Sq, G] f32
    scores = torch.where(key_mask[:, None], scores, torch.full_like(scores, NEG_INF))
    p_scores = _gqa_scores_shared(q, pk) * sm_scale  # [B, QH, Sq, P]
    p_scores = torch.where(
        prefix_mask[:, None], p_scores, torch.full_like(p_scores, NEG_INF)
    )
    weights = torch.softmax(torch.cat([p_scores, scores], dim=-1), dim=-1)
    P = pk.shape[1]
    return _gqa_values_shared(weights[..., :P], pv) + _gqa_values(weights[..., P:], gv)


def paged_attention_page_tables(
    prefix_idx: torch.Tensor, gen_idx: torch.Tensor, page_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Derive per-row PAGE tables from flat-SLOT index maps:
    ``prefix_pages [B|R, ceil(P/ps)]``, ``gen_pages [B, ceil(G/ps) + 1]`` and
    ``gen_phase [B]`` (the in-page offset of gen position 0). The +1 gen page
    absorbs the phase shift's worst case. Layer-invariant: computed once per
    decode step."""
    ps = page_size
    prefix_pages = prefix_idx[..., ::ps] // ps
    G = gen_idx.shape[-1]
    NG = -(-G // ps) + 1
    phase = gen_idx[:, :1] % ps  # [B, 1]
    starts = torch.arange(NG, device=gen_idx.device)[None, :] * ps - phase
    src = starts.clamp(0, G - 1).long()
    gen_pages = torch.gather(gen_idx, 1, src) // ps
    return (
        prefix_pages.to(torch.int32),
        gen_pages.to(torch.int32),
        phase[:, 0].to(torch.int32),
    )


def paged_decode_attention_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_pages: torch.Tensor,
    gen_pages: torch.Tensor,
    gen_phase: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    gen_lens: torch.Tensor,
    *,
    page_size: int,
    sm_scale: float,
) -> torch.Tensor:
    """The paged-decode kernel's function in plain PyTorch: gather every
    table page, mask slots outside ``[0, limit)``, append the fresh column,
    one f32 softmax. Same arguments and result as
    :func:`paged_decode_attention`."""
    B, QH, D = q.shape
    KVH = pool_k.shape[1]
    G = QH // KVH
    ps = page_size
    NP = prefix_pages.shape[1]
    if prefix_pages.shape[0] != B:  # [R, NP] shared prefix -> per-row table
        prefix_pages = prefix_pages.repeat_interleave(B // prefix_pages.shape[0], dim=0)
    tables = torch.cat([prefix_pages, gen_pages], dim=1).long()  # [B, NP + NG]
    slots = (tables[:, :, None] * ps + torch.arange(ps, device=q.device)).reshape(B, -1)
    k = pool_k[slots].float()  # [B, (NP+NG)*ps, KVH, D]
    v = pool_v[slots].float()
    j = torch.arange(tables.shape[1], device=q.device)[:, None]
    offs = torch.arange(ps, device=q.device)[None, :]
    is_prefix = (j < NP)[None]  # [1, NP+NG, 1]
    pos = torch.where(
        is_prefix, j * ps + offs, (j - NP) * ps + offs - gen_phase.long()[:, None, None]
    )
    limit = torch.where(is_prefix, prompt_lens.long()[:, None, None], gen_lens.long()[:, None, None])
    valid = ((pos >= 0) & (pos < limit)).reshape(B, 1, 1, -1)

    qg = q.float().reshape(B, KVH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * sm_scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s_new = torch.einsum("bhgd,bhd->bhg", qg, new_k.float())[..., None] * sm_scale
    w = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w[..., :-1], v)
    out = out + w[..., -1:] * new_v.float()[:, :, None, :]
    return out.reshape(B, QH, D)


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_pages: torch.Tensor,
    gen_pages: torch.Tensor,
    gen_phase: torch.Tensor,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    prompt_lens: torch.Tensor,
    gen_lens: torch.Tensor,
    *,
    page_size: int,
    sm_scale: float,
) -> torch.Tensor:
    """Fused paged decode attention (one query position per row).

    q: [B, QH, D]; pool_k/pool_v: one layer's pool [pages * page_size, KVH,
    D]; prefix_pages [B|R, NP] (an [R, NP] table is shared by each request's
    B/R request-major rows) / gen_pages [B, NG] / gen_phase [B]: from
    :func:`paged_attention_page_tables`; new_k/new_v [B, KVH, D]: this step's
    fresh column; prompt_lens / gen_lens [B]: per-row valid counts (the
    current token excluded). Returns [B, QH, D] f32.

    Tensors on a card go to the CUDA kernel (or the call raises); tensors on
    the CPU go to :func:`paged_decode_attention_plain`.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase, new_k, new_v,
            prompt_lens, gen_lens, page_size=page_size, sm_scale=sm_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    B, QH, D = q.shape
    KVH = pool_k.shape[1]
    ps = int(page_size)
    R, NP = prefix_pages.shape
    NG = gen_pages.shape[1]
    if (
        pool_k.dim() != 3 or pool_k.shape != pool_v.shape or pool_k.shape[2] != D
        or pool_k.shape[0] % ps or QH % KVH or R == 0 or B % R
        or gen_pages.shape[0] != B or new_k.shape != (B, KVH, D) or new_v.shape != new_k.shape
    ):
        raise ValueError(
            f"paged_decode_attention: bad shapes q={tuple(q.shape)} pool={tuple(pool_k.shape)} "
            f"prefix_pages={tuple(prefix_pages.shape)} gen_pages={tuple(gen_pages.shape)} "
            f"new_k={tuple(new_k.shape)} page_size={ps}"
        )
    if D not in (16, 64, 128, 256) or (QH // KVH) * D > 1024:
        raise ValueError(f"paged_decode_attention: head dim {D} x group {QH // KVH} unsupported")
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or any(
        t.dtype != dt for t in (pool_k, pool_v, new_k, new_v)
    ):
        raise ValueError("paged_decode_attention: q, pools and columns must share bf16 or f32")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v), ("new_k", new_k), ("new_v", new_v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be contiguous, 16-byte aligned, on {q.device}")
    ints = [
        t.to(device=q.device, dtype=torch.int32).contiguous()
        for t in (prefix_pages, gen_pages, gen_phase.reshape(B), prompt_lens.reshape(B), gen_lens.reshape(B))
    ]
    out = torch.empty((B, QH, D), dtype=torch.float32, device=q.device)
    lib = _ext.load("paged_decode")
    status = lib.kllms_paged_decode_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), ints[3].data_ptr(), ints[4].data_ptr(),
        out.data_ptr(), B, QH, KVH, D, R, NP, NG, ps, pool_k.shape[0] // ps,
        int(dt == torch.bfloat16), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _ext.check_status("paged_decode_attention", status)
    _ext.note_launch("paged_decode_attention")
    return out
