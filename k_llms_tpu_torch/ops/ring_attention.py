"""Ring attention: exact sequence-parallel attention over a mesh axis.

Counterpart of ``k_llms_tpu/ops/ring_attention.py``. Each function is the
JAX function's ``shard_map`` body on this rank: it takes and returns this
rank's shards under the JAX ``in_specs``/``out_specs``, and the rotation is
:func:`~k_llms_tpu_torch.parallel.collectives.ppermute` over the sequence
axis (``data``). The sequence is sharded over the ring, queries stay put,
and K/V chunks rotate with flash-style online-softmax state in f32, so each
rank holds O(S/P) of the sequence.

Causality uses global positions: rank d of the ring owns query positions
[d*S_local, (d+1)*S_local), and at ring step i it holds the K/V chunk of
rank (d - i) mod P. A ring of P takes P - 1 hops (the JAX loop's last
rotation returns each chunk home and is left out). Plain PyTorch, as the
JAX functions are plain XLA: no TPU kernel sits under them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..parallel.collectives import pmax, ppermute, psum
from ..parallel.mesh import Mesh

NEG_INF = float(torch.finfo(torch.float32).min)


def _rotate(mesh: Mesh, axis: str, k: torch.Tensor, v: torch.Tensor):
    """One ring hop of a K/V chunk pair (one ``ppermute`` for both)."""
    kv = ppermute(torch.stack([k, v]), axis, mesh)
    return kv[0], kv[1]


def _chunk_attention_update(q, k, v, q_pos, k_pos, causal, scale, acc, m, l):
    """One online-softmax accumulation step against a K/V chunk.

    q: [B, QH, Sq, D]; k/v: [B, KVH, Sk, D]; q_pos/k_pos: global positions.
    acc: [B, QH, Sq, D] f32; m/l: [B, QH, Sq, 1] f32."""
    B, QH, Sq, D = q.shape
    KVH = k.shape[1]
    G = QH // KVH
    qg = q.float().reshape(B, KVH, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    s = (s * scale).reshape(B, QH, Sq, -1)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]  # [Sq, Sk]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pg = p.reshape(B, KVH, G, Sq, -1)
    delta = torch.einsum("bhgqk,bhkd->bhgqd", pg, v.float()).reshape(B, QH, Sq, D)
    return acc * alpha + delta, m_new, l_new


def ring_attention(
    mesh: Mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    seq_axis: str = "data",
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """This rank's block of exact attention (``ring_attention_local``).
    q: [B, QH, S_local, D], k/v: [B, KVH, S_local, D], all this rank's
    sequence chunk. Returns [B, QH, S_local, D] in q's dtype."""
    B, QH, S_local, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    p_size = mesh.axis_size(seq_axis)
    my_idx = mesh.axis_index(seq_axis)
    device = q.device
    q_pos = my_idx * S_local + torch.arange(S_local, device=device)
    acc = torch.zeros((B, QH, S_local, D), dtype=torch.float32, device=device)
    m = torch.full((B, QH, S_local, 1), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((B, QH, S_local, 1), dtype=torch.float32, device=device)
    k_cur, v_cur = k, v
    for i in range(p_size):
        src = (my_idx - i) % p_size
        k_pos = src * S_local + torch.arange(S_local, device=device)
        acc, m, l = _chunk_attention_update(q, k_cur, v_cur, q_pos, k_pos, causal, scale, acc, m, l)
        if i + 1 < p_size:
            k_cur, v_cur = _rotate(mesh, seq_axis, k_cur, v_cur)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype)


def ring_verify_prefix(
    mesh: Mesh,
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prefix_len,
    *,
    seq_axis: str = "data",
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score ``Sq`` queries per row against a SEQUENCE-SHARDED prefix in one
    ring pass (a speculative verify block; decode is ``Sq == 1``). Every
    query sits past the prompt, so each sees exactly the ``prefix_len``
    valid keys (non-causal).

    q: [B_local, QH, Sq, D], this rank's rows (rows over ``seq_axis``, heads
    over model); prefix_k/v: [1, S_local, KVH, D], this rank's chunk;
    prefix_len: the valid key count (an int or a 0-d device tensor). Returns (out [B_local, QH, Sq, D] f32,
    normalised within the prefix, m [B_local, QH, Sq], l [B_local, QH, Sq])
    for the caller's logsumexp merge with the generated tail."""
    B, QH, Sq, D = q.shape
    S_local, KVH = prefix_k.shape[1], prefix_k.shape[2]
    G = QH // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    p_size = mesh.axis_size(seq_axis)
    my_idx = mesh.axis_index(seq_axis)
    device = q.device
    qg = q.float().reshape(B, KVH, G, Sq, D)
    acc = torch.zeros((B, QH, Sq, D), dtype=torch.float32, device=device)
    m = torch.full((B, QH, Sq), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((B, QH, Sq), dtype=torch.float32, device=device)
    k_cur, v_cur = prefix_k, prefix_v
    for i in range(p_size):
        src = (my_idx - i) % p_size
        valid = src * S_local + torch.arange(S_local, device=device) < prefix_len
        s = torch.einsum("bhgqd,shd->bhgqs", qg, k_cur[0].float()) * scale
        s = torch.where(valid, s, torch.full_like(s, NEG_INF)).reshape(B, QH, Sq, S_local)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        delta = torch.einsum(
            "bhgqs,shd->bhgqd", p.reshape(B, KVH, G, Sq, S_local), v_cur[0].float()
        ).reshape(B, QH, Sq, D)
        acc = acc * alpha[..., None] + delta
        m = m_new
        if i + 1 < p_size:
            k_cur, v_cur = _rotate(mesh, seq_axis, k_cur, v_cur)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / safe_l[..., None], m, l


def ring_decode_prefix(
    mesh: Mesh,
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prefix_len,
    *,
    seq_axis: str = "data",
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode-step attention over a SEQUENCE-SHARDED prefix: q [B_local, QH,
    D] (this rank's rows); the rest as :func:`ring_verify_prefix`. Returns
    (out [B_local, QH, D] f32, m [B_local, QH], l [B_local, QH]), the
    contract of ``decode_prefix_attention``."""
    out, m, l = ring_verify_prefix(
        mesh, q[:, :, None], prefix_k, prefix_v, prefix_len,
        seq_axis=seq_axis, sm_scale=sm_scale,
    )
    return out[:, :, 0], m[:, :, 0], l[:, :, 0]


def suffix_prefix_attention(
    mesh: Mesh,
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prefix_len,
    *,
    seq_axis: str = "data",
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial-softmax attention of REPLICATED suffix queries over a
    SEQUENCE-SHARDED prefix (the attention half of a continuation prefill on
    a sequence-sharded cache entry). q: [1, QH, Sq, D], the same on every
    rank of the ring; prefix_k/v: [1, S_local, KVH, D], this rank's chunk;
    prefix_len: the reused prefix length. Each rank scores its chunk and the
    partials merge with one ``pmax`` and two ``psum``s. Returns (acc [1, QH,
    Sq, D] f32, UNNORMALISED; m, l [1, QH, Sq])."""
    B, QH, Sq, D = q.shape
    S_loc, KVH = prefix_k.shape[1], prefix_k.shape[2]
    G = QH // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    my_idx = mesh.axis_index(seq_axis)
    device = q.device
    valid = my_idx * S_loc + torch.arange(S_loc, device=device) < prefix_len
    qg = q.float().reshape(B, KVH, G, Sq, D)
    s = torch.einsum("bhgqd,shd->bhgqs", qg, prefix_k[0].float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF)).reshape(B, QH, Sq, S_loc)
    m_loc = s.amax(dim=-1)
    p = torch.exp(s - m_loc[..., None])
    # A rank whose chunk has no valid column contributes l = 0 (its rows
    # would be exp(NEG_INF - NEG_INF) = 1 otherwise).
    p = torch.where(valid.any(), p, torch.zeros_like(p))
    l_loc = p.sum(dim=-1)
    acc_loc = torch.einsum(
        "bhgqs,shd->bhgqd", p.reshape(B, KVH, G, Sq, S_loc), prefix_v[0].float()
    ).reshape(B, QH, Sq, D)
    m_g = pmax(m_loc, seq_axis, mesh)
    w = torch.exp(m_loc - m_g)
    l_g = psum(l_loc * w, seq_axis, mesh)
    acc_g = psum(acc_loc * w[..., None], seq_axis, mesh)
    return acc_g, m_g, l_g


def scatter_into_ring(
    mesh: Mesh,
    prefix: torch.Tensor,
    suffix: torch.Tensor,
    start,
    total_len,
    *,
    seq_axis: str = "data",
) -> torch.Tensor:
    """Write REPLICATED suffix rows into this rank's chunk of a
    SEQUENCE-SHARDED buffer: global row ``start + i`` takes ``suffix[:, i]``
    for i < total_len - start; every other row keeps its value. prefix: [1,
    S_local, KVH, D], this rank's chunk; suffix: [1, Ssuf, KVH, D]. Returns
    the new chunk; no collective."""
    S_loc = prefix.shape[1]
    Ssuf = suffix.shape[1]
    device = prefix.device
    cols = mesh.axis_index(seq_axis) * S_loc + torch.arange(S_loc, device=device)
    idx = cols - start
    take = (idx >= 0) & (idx < Ssuf) & (cols < total_len)
    vals = suffix[0].index_select(0, idx.clamp(0, Ssuf - 1))
    return torch.where(take[None, :, None, None], vals[None].to(prefix.dtype), prefix)
