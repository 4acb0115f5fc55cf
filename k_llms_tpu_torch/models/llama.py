"""Llama-family transformer (GQA + RoPE + RMSNorm + SwiGLU) in PyTorch.

Counterpart of ``k_llms_tpu/models/llama.py``, Llama family only: the
prefill (``prefill``), the full-sequence ``forward``/``encode`` behind
embeddings, and the paged decode step (``paged_verify_step`` at ``Sq == 1``).
Parameters keep the JAX package's tree: a plain dict whose per-layer weights
are stacked on a leading layer axis, laid out (features_in, features_out) so
``params_from_numpy`` carries a JAX tree over as it is. The layer stack is a
Python loop over that axis.

bf16 rounds where the JAX functions round: ``rms_norm`` casts the normalised
activations to the model dtype before the weight multiply, ``_gqa_values``
casts the softmax weights to the value dtype, and RoPE rotates the two halves
of each head. Score and value einsums accumulate in f32 (inputs widened to
f32, which is exact for bf16).

Not ported yet (raise ``NotImplementedError``): the dense-cache decode and
verify steps, continuation and chunked prefill, mixture-of-experts MLPs,
the Gemma variants (offset norms, post-block norms, softcaps, embedding
scale, GeGLU) and sliding windows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import NEG_INF, flash_attention
from .config import ModelConfig

Params = Dict[str, Any]

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
_BIAS_KEYS = ("bq", "bk", "bv")


def check_supported(config: ModelConfig) -> None:
    """Raise for config features outside this port's Llama-family slice."""
    unsupported = []
    if config.num_experts:
        unsupported.append("mixture-of-experts MLPs")
    if config.sliding_window is not None:
        unsupported.append("sliding-window attention")
    if config.attn_softcap is not None or config.logit_softcap is not None:
        unsupported.append("softcaps")
    if config.norm_offset or config.embed_scale or config.post_block_norms or config.act != "silu":
        unsupported.append("Gemma variants")
    if config.decode_attention_impl != "xla":
        unsupported.append(f"decode_attention_impl={config.decode_attention_impl!r}")
    if config.attention_impl not in ("xla", "flash"):
        unsupported.append(f"attention_impl={config.attention_impl!r}")
    if unsupported:
        raise NotImplementedError(
            f"{config.name}: {', '.join(unsupported)} not ported to k_llms_tpu_torch yet"
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(
    config: ModelConfig, generator: torch.Generator, device, dtype=None
) -> Params:
    """Random scaled-normal parameters drawn from ``generator`` on ``device``
    (same shapes and scales as the JAX package's ``init_params``; the draws
    differ, since torch and jax.random are different generators). Large
    tensors are drawn one layer at a time so the f32 draw never holds more
    than one layer."""
    check_supported(config)
    dtype = dtype or config.torch_dtype
    device = torch.device(device)
    H, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    L, Q, KV = config.num_layers, config.q_dim, config.kv_dim

    def normal(shape, scale, layered=False):
        out = torch.empty(shape, dtype=dtype, device=device)
        parts = out if layered else out[None]
        for part in parts:
            draw = torch.randn(part.shape, generator=generator, device=device, dtype=torch.float32)
            part.copy_(draw.mul_(scale))
        return out

    layers = {
        "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "wq": normal((L, H, Q), 1.0 / math.sqrt(H), True),
        "wk": normal((L, H, KV), 1.0 / math.sqrt(H), True),
        "wv": normal((L, H, KV), 1.0 / math.sqrt(H), True),
        "wo": normal((L, Q, H), 1.0 / math.sqrt(Q), True),
        "mlp_norm": torch.ones((L, H), dtype=dtype, device=device),
        "w_gate": normal((L, H, I), 1.0 / math.sqrt(H), True),
        "w_up": normal((L, H, I), 1.0 / math.sqrt(H), True),
        "w_down": normal((L, I, H), 1.0 / math.sqrt(I), True),
    }
    if config.qkv_bias:
        layers["bq"] = torch.zeros((L, Q), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((L, KV), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((L, KV), dtype=dtype, device=device)
    return {
        "embed": normal((V, H), 1.0 / math.sqrt(H)),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
        "lm_head": normal((H, V), 1.0 / math.sqrt(H)),
    }


def params_from_numpy(tree: Dict[str, Any], config: ModelConfig, device="cpu") -> Params:
    """Turn a JAX parameter tree (leaves as numpy arrays, e.g. from
    ``jax.device_get``) into the port's parameters on ``device``, in the
    config's dtype."""
    check_supported(config)
    dtype = config.torch_dtype

    def conv(x):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: go through f32
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=dtype)

    layer_keys = _LAYER_KEYS + (_BIAS_KEYS if config.qkv_bias else ())
    missing = [k for k in layer_keys if k not in tree["layers"]]
    if missing:
        raise ValueError(f"parameter tree lacks layer weights {missing}")
    return {
        "embed": conv(tree["embed"]),
        "layers": {k: conv(tree["layers"][k]) for k in layer_keys},
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


def _layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight


def _rope_inv_freq(d: int, theta: float, scaling, device) -> torch.Tensor:
    """Per-pair inverse frequencies, with optional llama3-style scaling (HF
    rope_type="llama3")."""
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv_freq = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponent)
    if scaling is None:
        return inv_freq
    factor, low_freq_factor, high_freq_factor, orig_ctx = scaling
    wavelen = 2.0 * math.pi / inv_freq
    low_wavelen = orig_ctx / low_freq_factor
    high_wavelen = orig_ctx / high_freq_factor
    smooth = (orig_ctx / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    interpolated = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, interpolated)
    return torch.where(wavelen < high_wavelen, inv_freq, scaled)


def rope_embed(x: torch.Tensor, positions: torch.Tensor, theta: float, scaling=None) -> torch.Tensor:
    """Rotary embedding over the two halves of each head. x: [B, S, heads,
    D], positions: [B, S]."""
    d = x.shape[-1]
    inv_freq = _rope_inv_freq(d, theta, scaling, x.device)
    angles = positions.float()[..., None] * inv_freq  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, Sq, QH, D], k: [B, Sk, KVH, D] -> scores [B, QH, Sq, Sk] f32."""
    B, Sq, QH, D = q.shape
    KVH = k.shape[2]
    qg = q.float().reshape(B, Sq, KVH, QH // KVH, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    return scores.reshape(B, QH, Sq, k.shape[1])


def _gqa_scores_shared(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, QH, D] against R shared key sets k [R, Sk, KVH, D]; rows are
    request-major (row b belongs to request b // (B // R))."""
    B, Sq, QH, D = q.shape
    R, Sk, KVH, _ = k.shape
    qg = q.float().reshape(R, B // R, Sq, KVH, QH // KVH, D)
    scores = torch.einsum("rnqhgd,rkhd->rnhgqk", qg, k.float())
    return scores.reshape(B, QH, Sq, Sk)


def _gqa_values(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights [B, QH, Sq, Sk], v [B, Sk, KVH, D] -> [B, Sq, QH, D] f32; the
    weights round to v's dtype first, as in the JAX function."""
    B, QH, Sq, Sk = weights.shape
    KVH = v.shape[2]
    wg = weights.to(v.dtype).float().reshape(B, KVH, QH // KVH, Sq, Sk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", wg, v.float())
    return out.reshape(B, Sq, QH, v.shape[3])


def _gqa_values_shared(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights [B, QH, Sq, Sk], R shared value sets v [R, Sk, KVH, D] ->
    [B, Sq, QH, D] f32."""
    B, QH, Sq, Sk = weights.shape
    R, _, KVH, _ = v.shape
    wg = weights.to(v.dtype).float().reshape(R, B // R, KVH, QH // KVH, Sq, Sk)
    out = torch.einsum("rnhgqk,rkhd->rnqhgd", wg, v.float())
    return out.reshape(B, Sq, QH, v.shape[3])


def _attn_qkv(config: ModelConfig, layer: Params, x: torch.Tensor, positions: torch.Tensor):
    """Pre-norm -> QKV projection (+ optional biases) -> head split -> RoPE."""
    B, Sq, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], config.rms_eps)
    q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
    if "bq" in layer:  # Qwen2-family QKV biases
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(B, Sq, config.num_heads, config.head_dim)
    k = k.reshape(B, Sq, config.num_kv_heads, config.head_dim)
    v = v.reshape(B, Sq, config.num_kv_heads, config.head_dim)
    q = rope_embed(q, positions, config.rope_theta, config.rope_scaling)
    k = rope_embed(k, positions, config.rope_theta, config.rope_scaling)
    return q, k, v


def _mlp_sublayer(config: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    """Post-attention SwiGLU MLP with its residual."""
    h = rms_norm(x, layer["mlp_norm"], config.rms_eps)
    gate = torch.nn.functional.silu(h @ layer["w_gate"])
    return x + (gate * (h @ layer["w_up"])) @ layer["w_down"]


def _attn_residual(layer: Params, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    return x + attn @ layer["wo"]


def _block(
    config: ModelConfig,
    layer: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    key_mask: torch.Tensor,
    key_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One full-sequence (prefill) block. x: [B, S, H]; key_mask: [B|1, S, S]
    booleans for the plain path; key_lengths: [B] valid keys for the flash
    path. Returns (x, (k, v)) with k/v [B, S, KVH, D] — the layer's cache."""
    B, Sq, _ = x.shape
    scale = config.query_scale or 1.0 / math.sqrt(config.head_dim)
    q, k, v = _attn_qkv(config, layer, x, positions)
    if config.attention_impl == "flash":
        attn = flash_attention(
            q.transpose(1, 2).contiguous(),
            k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(),
            causal=True,
            key_lengths=key_lengths,
            sm_scale=scale,
        ).transpose(1, 2)
    else:
        scores = _gqa_scores(q, k) * scale  # [B, QH, S, S] f32
        scores = torch.where(key_mask[:, None], scores, torch.full_like(scores, NEG_INF))
        attn = _gqa_values(torch.softmax(scores, dim=-1), v)
    attn = attn.to(x.dtype).reshape(B, Sq, config.q_dim)
    return _mlp_sublayer(config, layer, _attn_residual(layer, x, attn)), (k, v)


def _apply_stack(config, params, x, positions, key_mask, key_lengths):
    """All layers of the full-sequence path. Returns (x, k [L, B, S, KVH, D],
    v [L, B, S, KVH, D])."""
    ks, vs = [], []
    for i in range(config.num_layers):
        x, (k, v) = _block(config, _layer(params, i), x, positions, key_mask, key_lengths)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _logits(params: Params, h: torch.Tensor) -> torch.Tensor:
    return (h @ params["lm_head"]).float()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def forward(config: ModelConfig, params: Params, tokens: torch.Tensor, pad_mask: torch.Tensor):
    """Full-sequence causal forward (no cache). Returns (logits f32 [B, S,
    V], final hidden states [B, S, H])."""
    h = encode(config, params, tokens, pad_mask)
    return _logits(params, h), h


def encode(config: ModelConfig, params: Params, tokens: torch.Tensor, pad_mask: torch.Tensor):
    """Final hidden states [B, S, H] — the embedding provider mean-pools
    them; the lm_head projection is skipped."""
    check_supported(config)
    B, S = tokens.shape
    positions = (torch.cumsum(pad_mask.long(), dim=1) - 1).clamp_min(0)
    x = params["embed"][tokens.long()]
    causal = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    key_mask = causal[None] & pad_mask.bool()[:, None, :]
    key_lengths = pad_mask.long().sum(dim=1).to(torch.int32)
    x, _, _ = _apply_stack(config, params, x, positions, key_mask, key_lengths)
    return rms_norm(x, params["final_norm"], config.rms_eps)


def prefill(config: ModelConfig, params: Params, tokens: torch.Tensor, prompt_len: int):
    """Prefill the shared prompt at batch=1. tokens: [1, S] (bucket-padded on
    the right), prompt_len: valid length. Returns (last-token logits [1, V],
    (k, v) each [L, 1, S, KVH, D])."""
    check_supported(config)
    B, S = tokens.shape
    device = tokens.device
    positions = torch.arange(S, device=device)[None, :].expand(B, S)
    x = params["embed"][tokens.long()]
    causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    valid = torch.arange(S, device=device)[None, :] < int(prompt_len)
    key_mask = causal[None] & valid[:, None, :]
    key_lengths = torch.full((B,), int(prompt_len), dtype=torch.int32, device=device)
    x, k, v = _apply_stack(config, params, x, positions, key_mask, key_lengths)
    h = rms_norm(x[:, int(prompt_len) - 1], params["final_norm"], config.rms_eps)
    return _logits(params, h), (k, v)


def _block_paged(
    config: ModelConfig,
    layer: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    pool_k_l: torch.Tensor,
    pool_v_l: torch.Tensor,
    prefix_idx: torch.Tensor,
    gen_idx: torch.Tensor,
    write_index: torch.Tensor,
    key_mask: torch.Tensor,
    prefix_mask: torch.Tensor,
    page_tables,
    page_size: int,
    attn_impl: str,
):
    """Paged twin of the decode block at ``Sq == 1``: KV comes from one
    layer's flat page pool through block tables. "cuda" runs the fused
    kernel (its plain version for CPU tensors), "xla" the dense-equivalent
    reference. Returns (x, (k_col, v_col)) with the cols [B, KVH, D] in pool
    dtype — this step's column, which the caller scatters into the pool."""
    from ..ops.paged_attention import paged_decode_attention, paged_decode_attention_xla

    B, Sq, _ = x.shape
    scale = config.query_scale or 1.0 / math.sqrt(config.head_dim)
    q, k, v = _attn_qkv(config, layer, x, positions)
    k_col = k[:, 0].to(pool_k_l.dtype)
    v_col = v[:, 0].to(pool_v_l.dtype)
    if attn_impl == "cuda":
        prefix_pages, gen_pages, gen_phase, plen32, glen32 = page_tables
        attn = paged_decode_attention(
            q[:, 0].contiguous(), pool_k_l, pool_v_l, prefix_pages, gen_pages, gen_phase,
            k_col.contiguous(), v_col.contiguous(), plen32, glen32,
            page_size=page_size, sm_scale=scale,
        )[:, None]
    else:
        attn = paged_decode_attention_xla(
            q, pool_k_l, pool_v_l, prefix_idx, gen_idx, k, v, write_index,
            key_mask, prefix_mask, sm_scale=scale,
        )
    attn = attn.to(x.dtype).reshape(B, Sq, config.q_dim)
    x = _attn_residual(layer, x, attn)
    return _mlp_sublayer(config, layer, x), (k_col, v_col)


def paged_verify_step(
    config: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    prompt_len: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    prefix_idx: torch.Tensor,
    gen_idx: torch.Tensor,
    attn_impl: str = "xla",
    page_size: Optional[int] = None,
):
    """One paged decode step at ``Sq == 1`` for every row.

    tokens: [B, 1] current tokens; lengths: [B] generated counts (each row's
    write offset into its gen slots); prompt_len: [R] per-request prompt
    lengths (rows request-major); pool_k/pool_v: ``[L, pages * ps, KVH,
    D]``; prefix_idx [R, P] / gen_idx [B, G]: flat pool slots per logical
    position. Masks are built as in the JAX function. Returns (logits f32
    [B, 1, V], k_cols, v_cols [L, B, KVH, D]). The pool is only read here.
    """
    from ..ops.paged_attention import paged_attention_page_tables

    check_supported(config)
    B, Sq = tokens.shape
    if Sq != 1:
        raise NotImplementedError("paged_verify_step: only Sq == 1 is ported")
    device = tokens.device
    G = gen_idx.shape[1]
    P = prefix_idx.shape[1]
    pl = prompt_len.reshape(-1).to(device=device, dtype=torch.int64)
    pl_row = pl.repeat_interleave(B // pl.shape[0])  # [B]
    lengths = lengths.to(device=device, dtype=torch.int64)

    positions = pl_row[:, None] + lengths[:, None]  # [B, 1]
    x = params["embed"][tokens.long()]
    self_mask = torch.arange(G, device=device)[None, None, :] <= lengths[:, None, None]
    prefix_mask = torch.arange(P, device=device)[None, None, :] < pl_row[:, None, None]

    page_tables = None
    if attn_impl == "cuda":
        # Layer-invariant kernel arguments, built once per step.
        page_tables = paged_attention_page_tables(prefix_idx, gen_idx, page_size) + (
            pl_row.to(torch.int32), lengths.to(torch.int32),
        )
    k_cols, v_cols = [], []
    for i in range(config.num_layers):
        x, (kc, vc) = _block_paged(
            config, _layer(params, i), x, positions, pool_k[i], pool_v[i],
            prefix_idx, gen_idx, lengths, self_mask, prefix_mask,
            page_tables, page_size, attn_impl,
        )
        k_cols.append(kc)
        v_cols.append(vc)
    h = rms_norm(x, params["final_norm"], config.rms_eps)
    return _logits(params, h), torch.stack(k_cols), torch.stack(v_cols)
