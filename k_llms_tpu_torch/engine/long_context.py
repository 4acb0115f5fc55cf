"""Sequence-parallel (context-parallel) forward pass for long prompts.

Counterpart of ``k_llms_tpu/engine/long_context.py``, as each rank's part
of the SPMD program. The prompt's positions shard over the mesh's sequence
axis (``data``): every position-wise op (norms, projections, MLP, MoE
routing, quantized weights, and on a tensor-parallel mesh their ``model``
collectives) runs on the rank's chunk through the dense path's own code,
and attention is exact across chunks:

- ``"ring"``: K/V chunks rotate the ring with online-softmax accumulation
  (``ops/ring_attention.py``), O(S/P) attention memory a rank;
- ``"ulysses"``: an ``all_to_all`` turns the sequence-sharded activations
  into head-sharded ones (each rank holds its heads' whole sequence), the
  flash kernel (K2) runs on the rank's heads, and a second ``all_to_all``
  turns the output back.

The resulting KV is each rank's chunk of the prompt's sequence, a
:class:`SeqShardedKV`, which ring decode attends in place
(``models/llama.py`` ``ring_mesh``) or which the engine gathers into the
replicated layout. Score-level features the ring cannot express (attention
softcaps, sliding windows) and a length that does not divide by the ring
raise, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..models.config import ModelConfig
from ..models.llama import (
    KVCache,
    _attn_qkv,
    _attn_residual,
    _embed,
    _final_norm,
    _layer,
    _logits,
    _mlp_sublayer,
)
from ..ops.attention import flash_attention
from ..ops.ring_attention import (
    NEG_INF,
    ring_attention,
    scatter_into_ring,
    suffix_prefix_attention,
)
from ..parallel.collectives import all_gather, all_to_all, psum
from ..parallel.mesh import DATA_AXIS, Mesh

SP_ATTENTIONS = ("ring", "ulysses")


class SeqShardedKV(NamedTuple):
    """A prompt's KV cut along its sequence over the mesh's data axis: this
    rank's chunk, k/v [L, 1, S/P, KVH, D]. The type is the layout label the
    prefix cache reads (the JAX engine reads the array's sharding)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        """Positions of this rank's chunk."""
        return self.k.shape[2]


def gather_sequence(kv: SeqShardedKV, mesh: Mesh, seq_axis: str = DATA_AXIS) -> KVCache:
    """The whole prompt's KV on every rank (the replicated decode layout)."""
    return KVCache(
        k=all_gather(kv.k, seq_axis, mesh, dim=2), v=all_gather(kv.v, seq_axis, mesh, dim=2)
    )


def _check_sp(config: ModelConfig, what: str) -> None:
    if config.attn_softcap is not None or config.sliding_window is not None:
        raise NotImplementedError(
            f"sequence-parallel {what} cannot apply per-score softcap or "
            f"sliding windows; config {config.name!r} must use the dense "
            "prefill path"
        )


def sp_forward_hidden(
    config: ModelConfig,
    params,
    tokens: torch.Tensor,
    mesh: Mesh,
    seq_axis: str = DATA_AXIS,
    attention: str = "ring",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The causal forward over this rank's chunk of ``tokens`` [B, S] (the
    whole prompt, the same on every rank; S divisible by the ring). Returns
    (final-normed hidden [B, S/P, H], k, v [L, B, S/P, KVH, D]), this
    rank's chunk of each."""
    if attention not in SP_ATTENTIONS:
        raise ValueError(f"Unknown sequence-parallel attention {attention!r}")
    _check_sp(config, "attention")
    B, S = tokens.shape
    ring = mesh.axis_size(seq_axis)
    if S % ring != 0:
        raise ValueError(f"sequence length {S} must divide by ring size {ring}")
    S_loc = S // ring
    lo = mesh.axis_index(seq_axis) * S_loc
    device = tokens.device
    positions = (lo + torch.arange(S_loc, device=device))[None, :].expand(B, S_loc)
    x = _embed(config, params, tokens[:, lo: lo + S_loc])
    ks, vs = [], []
    for i in range(config.num_layers):
        layer = _layer(params, i)
        q, k, v = _attn_qkv(config, layer, x, positions)
        ks.append(k)
        vs.append(v)
        qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if attention == "ulysses":
            if kT.shape[1] % ring:
                raise ValueError(
                    f"ulysses needs the {kT.shape[1]} kv heads of a rank to divide by the ring {ring}"
                )
            # Sequence-sharded -> head-sharded: each rank attends its heads
            # over the whole sequence with the flash kernel, then back.
            qh, kh, vh = (all_to_all(t, seq_axis, mesh, split_dim=1, concat_dim=2).contiguous()
                          for t in (qT, kT, vT))
            attn = flash_attention(qh, kh, vh, causal=True, sm_scale=config.query_scale)
            attn = all_to_all(attn, seq_axis, mesh, split_dim=2, concat_dim=1)
        else:
            attn = ring_attention(mesh, qT, kT, vT, seq_axis=seq_axis, causal=True,
                                  sm_scale=config.query_scale)
        attn = attn.transpose(1, 2).to(x.dtype).reshape(B, S_loc, -1)
        x = _mlp_sublayer(config, layer, _attn_residual(config, layer, x, attn))
    return _final_norm(config, params, x), torch.stack(ks), torch.stack(vs)


def forward_sequence_parallel(
    config: ModelConfig,
    params,
    tokens: torch.Tensor,
    mesh: Mesh,
    seq_axis: str = DATA_AXIS,
    attention: str = "ring",
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Full causal forward with the sequence sharded over ``seq_axis``: the
    JAX function's (logits f32 [B, S/P, V], hidden [B, S/P, H], KVCache [L,
    B, S/P, KVH, D]), this rank's chunk of each."""
    h, k, v = sp_forward_hidden(config, params, tokens, mesh, seq_axis, attention)
    return _logits(config, params, h), h, KVCache(k=k, v=v)


def sp_prefill(
    config: ModelConfig,
    params,
    tokens: torch.Tensor,
    prompt_len: int,
    mesh: Mesh,
    seq_axis: str = DATA_AXIS,
    attention: str = "ring",
) -> Tuple[torch.Tensor, SeqShardedKV]:
    """The engine's sequence-parallel prefill: (last-prompt-position logits
    [1, V], the prompt's :class:`SeqShardedKV`). Only the last position's
    hidden state is projected (the whole-sequence logits would dwarf the
    O(S/P) budget): its owner's row reaches every rank through one ``psum``
    of that row and zeros, which is exact, so every rank holds the same
    bytes."""
    h, k, v = sp_forward_hidden(config, params, tokens, mesh, seq_axis, attention)
    S_loc = h.shape[1]
    last = int(prompt_len) - 1
    row = h[:, last % S_loc]
    if last // S_loc != mesh.axis_index(seq_axis):
        row = torch.zeros_like(row)
    h_last = psum(row, seq_axis, mesh)
    return _logits(config, params, h_last), SeqShardedKV(k=k, v=v)


def _regrid(kv: SeqShardedKV, mesh: Mesh, out_bucket: int, seq_axis: str) -> SeqShardedKV:
    """The chunk of a prefix grown to ``out_bucket`` positions: the chunk
    boundaries move, so the sequence is gathered, padded and cut again."""
    full = gather_sequence(kv, mesh, seq_axis)
    pad = (0, 0, 0, 0, 0, out_bucket - full.k.shape[2])
    chunk = out_bucket // mesh.axis_size(seq_axis)
    lo = mesh.axis_index(seq_axis) * chunk
    return SeqShardedKV(
        k=torch.nn.functional.pad(full.k, pad)[:, :, lo: lo + chunk].contiguous(),
        v=torch.nn.functional.pad(full.v, pad)[:, :, lo: lo + chunk].contiguous(),
    )


def forward_sp_continuation(
    config: ModelConfig,
    params,
    suffix_tokens: torch.Tensor,
    prefix: SeqShardedKV,
    mesh: Mesh,
    prefix_len: int,
    total_len: int,
    out_bucket: int,
    seq_axis: str = DATA_AXIS,
) -> Tuple[torch.Tensor, SeqShardedKV]:
    """Continuation prefill on a SEQUENCE-SHARDED prefix: only the suffix
    tokens [1, Ssuf] run forward (the same on every rank of the ring),
    attending the reused prefix in its ring layout (one ``pmax`` + ``psum``
    merge per layer, ``suffix_prefix_attention``) and their own causal
    block densely; the two merge exactly, and the suffix KV is scattered
    into each rank's chunk. ``prefix`` is this rank's chunk of the stored
    entry; ``prefix_len`` the reused length; ``out_bucket`` the output
    sequence bucket (ring-divisible). Returns (last-position logits [1, V],
    the new :class:`SeqShardedKV` at ``out_bucket``)."""
    _check_sp(config, "continuation")
    B, Ssuf = suffix_tokens.shape
    D = config.head_dim
    scale = config.query_scale if config.query_scale is not None else 1.0 / math.sqrt(D)
    if prefix.k.shape[2] * mesh.axis_size(seq_axis) < out_bucket:
        prefix = _regrid(prefix, mesh, out_bucket, seq_axis)
    device = suffix_tokens.device
    p, total = int(prefix_len), int(total_len)
    positions = (p + torch.arange(Ssuf, device=device))[None, :]
    x = _embed(config, params, suffix_tokens)
    causal = torch.ones((Ssuf, Ssuf), dtype=torch.bool, device=device).tril()
    ks, vs = [], []
    for i in range(config.num_layers):
        layer = _layer(params, i)
        q, k, v = _attn_qkv(config, layer, x, positions)
        QH, KVH = q.shape[2], k.shape[2]
        G = QH // KVH
        qT = q.transpose(1, 2)  # [B, QH, Ssuf, D]
        acc1, m1, l1 = suffix_prefix_attention(
            mesh, qT, prefix.k[i], prefix.v[i], p, seq_axis=seq_axis, sm_scale=config.query_scale
        )
        qg = qT.float().reshape(B, KVH, G, Ssuf, D)
        s2 = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.transpose(1, 2).float()) * scale
        s2 = torch.where(causal, s2, torch.full_like(s2, NEG_INF)).reshape(B, QH, Ssuf, Ssuf)
        m2 = s2.amax(dim=-1)
        p2 = torch.exp(s2 - m2[..., None])
        l2 = p2.sum(dim=-1)
        acc2 = torch.einsum(
            "bhgqk,bhkd->bhgqd", p2.reshape(B, KVH, G, Ssuf, Ssuf), v.transpose(1, 2).float()
        ).reshape(B, QH, Ssuf, D)
        m = torch.maximum(m1, m2)
        a1 = torch.exp(m1 - m)
        a2 = torch.exp(m2 - m)
        l = l1 * a1 + l2 * a2
        safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
        attn = (acc1 * a1[..., None] + acc2 * a2[..., None]) / safe_l[..., None]
        attn = attn.to(x.dtype).transpose(1, 2).reshape(B, Ssuf, -1)
        x = _mlp_sublayer(config, layer, _attn_residual(config, layer, x, attn))
        ks.append(scatter_into_ring(mesh, prefix.k[i], k, p, total, seq_axis=seq_axis))
        vs.append(scatter_into_ring(mesh, prefix.v[i], v, p, total, seq_axis=seq_axis))
    h = _final_norm(config, params, x[:, total - p - 1])
    return _logits(config, params, h), SeqShardedKV(k=torch.stack(ks), v=torch.stack(vs))
