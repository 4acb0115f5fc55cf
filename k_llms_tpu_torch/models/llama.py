"""Llama-family transformer (GQA + RoPE + RMSNorm + SwiGLU) in PyTorch, with
the Gemma-2, Mistral and Mixtral variants.

Counterpart of ``k_llms_tpu/models/llama.py``: the prefill (``prefill``) and
its continuation over a cached prefix (``prefill_continue``) or by chunks,
the full-sequence ``forward``/``encode`` behind embeddings, the dense
shared-prefix decode step (``decode_step``, ``verify_step`` at ``Sq == 1``)
and the paged decode step (``paged_verify_step`` at ``Sq == 1``). The
variants follow the JAX functions: offset norms, post-block norms, GeGLU,
the embedding scale and the attention and logit softcaps (Gemma-2), sliding
windows on every layer (Mistral) or on the even layers (Gemma-2), and the
top-k mixture-of-experts MLP computed densely over all experts (Mixtral).
Parameters keep the JAX package's tree: a plain dict whose per-layer weights
are stacked on a leading layer axis, laid out (features_in, features_out) so
``params_from_numpy`` carries a JAX tree over as it is, quantized leaves
included. Every matmul weight goes through ``quant.qdot`` (the expert stacks
through ``quant.qeinsum``), so a weight may be a tensor, an int8 ``QTensor``
or an int4 ``Q4Tensor`` (the w4a16 kernel). The layer stack is a Python
loop over that axis: where the JAX function scans a per-layer window flag,
each layer here picks its window and its masks as Python values.

bf16 rounds where the JAX functions round: ``rms_norm`` casts the normalised
activations to the model dtype before the weight multiply, ``_gqa_values``
casts the softmax weights to the value dtype, and RoPE rotates the two halves
of each head. Score and value einsums accumulate in f32 (inputs widened to
f32, which is exact for bf16).

The dense decode step updates its generated-token cache in place (the JAX
function returns a new one); ``verify_step`` is that step with per-row
write offsets, at ``Sq == 1`` for the continuous loop's dense step and at
``Sq = K + 1`` for speculative verification, and
``prefill_chunk_step``/``prefill_chunk_step_paged`` extend a staging prefix
one prompt chunk at a time through ``prefill_continue``. With ``decode_attention_impl="flash"`` its
attention over the shared prompt prefix runs the decode-prefix kernel
(``ops.attention.decode_prefix_attention``) and merges the per-row generated
tail in plain tensor code, behind the JAX package's gate (which leaves out
softcapped and windowed models, as the paged kernel's gate does).

On a mesh the parameters are this rank's shard (``parallel.shard_params``,
which leaves the mesh under the tree's ``"mesh"`` key) and every function
runs the rank's part of the Megatron layout, as GSPMD partitions the JAX
functions: heads are read from the weights' shapes (QH/TP and KVH/TP a
rank), the row-parallel ``wo`` and ``w_down`` (or the rank's experts) are
followed by one ``psum`` over ``model``, the vocabulary-sharded embedding
masks the rows it does not own and sums, and the head's vocabulary shards
are gathered into whole logits. Those boundaries go through the
differentiable collectives (``reduce_from_model``, ``copy_to_model``,
``gather_from_model``), so a train step's gradients are the unsharded
ones, cut the same way. A decode or verify step given ``ring_mesh``
attends a SEQUENCE-SHARDED prefix (each rank's chunk) through ring
attention (``ops/ring_attention.py``), the JAX ``sp_ring_mesh`` arm.

``paged_verify_step`` stays at ``Sq == 1``:
the JAX package has no caller of it at ``Sq > 1`` (its paged block keeps
only the first column, and speculative launches decode dense).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import NEG_INF, decode_prefix_attention, flash_attention
from ..ops.w4matmul import Q4Tensor
from ..parallel.collectives import copy_to_model, gather_from_model, reduce_from_model
from ..parallel.mesh import MODEL_AXIS, is_tensor_parallel
from .config import ModelConfig
from .quant import QTensor, qdot, qeinsum

Params = Dict[str, Any]

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
_BIAS_KEYS = ("bq", "bk", "bv")
_POST_NORM_KEYS = ("post_attn_norm", "post_mlp_norm")


def _layer_keys(config: ModelConfig) -> Tuple[str, ...]:
    """The per-layer weights a config's tree holds."""
    return (
        _LAYER_KEYS
        + (_BIAS_KEYS if config.qkv_bias else ())
        + (_POST_NORM_KEYS if config.post_block_norms else ())
        + (("w_router",) if config.num_experts > 0 else ())
    )


def check_supported(config: ModelConfig) -> None:
    """Raise for config values this port does not implement."""
    unsupported = []
    if config.decode_attention_impl not in ("xla", "flash"):
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
    config: ModelConfig, generator: torch.Generator, device, dtype=None, shard=None
) -> Params:
    """Random scaled-normal parameters drawn from ``generator`` on ``device``
    (same shapes and scales as the JAX package's ``init_params``; the draws
    differ, since torch and jax.random are different generators). Large
    tensors are drawn one layer at a time so the f32 draw never holds more
    than one layer. ``shard(key, leaf)``, when given, takes each leaf as
    soon as it is drawn (a mesh rank keeps its shard and frees the rest, so
    the full tree never exists at once); the draws are the same."""
    check_supported(config)
    S = shard or (lambda key, leaf: leaf)
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

    def norm(shape):
        # Offset norms (Gemma) scale by (1 + w): their identity is 0.
        fill = torch.zeros if config.norm_offset else torch.ones
        return fill(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": S("attn_norm", norm((L, H))),
        "wq": S("wq", normal((L, H, Q), 1.0 / math.sqrt(H), True)),
        "wk": S("wk", normal((L, H, KV), 1.0 / math.sqrt(H), True)),
        "wv": S("wv", normal((L, H, KV), 1.0 / math.sqrt(H), True)),
        "wo": S("wo", normal((L, Q, H), 1.0 / math.sqrt(Q), True)),
        "mlp_norm": S("mlp_norm", norm((L, H))),
    }
    if config.num_experts > 0:  # Mixtral: a router and E experts per layer
        E = config.num_experts
        layers["w_router"] = S("w_router", normal((L, H, E), 1.0 / math.sqrt(H), True))
        layers["w_gate"] = S("w_gate", normal((L, E, H, I), 1.0 / math.sqrt(H), True))
        layers["w_up"] = S("w_up", normal((L, E, H, I), 1.0 / math.sqrt(H), True))
        layers["w_down"] = S("w_down", normal((L, E, I, H), 1.0 / math.sqrt(I), True))
    else:
        layers["w_gate"] = S("w_gate", normal((L, H, I), 1.0 / math.sqrt(H), True))
        layers["w_up"] = S("w_up", normal((L, H, I), 1.0 / math.sqrt(H), True))
        layers["w_down"] = S("w_down", normal((L, I, H), 1.0 / math.sqrt(I), True))
    if config.qkv_bias:
        layers["bq"] = S("bq", torch.zeros((L, Q), dtype=dtype, device=device))
        layers["bk"] = S("bk", torch.zeros((L, KV), dtype=dtype, device=device))
        layers["bv"] = S("bv", torch.zeros((L, KV), dtype=dtype, device=device))
    if config.post_block_norms:  # Gemma-2: norms on the attention and MLP outputs
        layers["post_attn_norm"] = S("post_attn_norm", norm((L, H)))
        layers["post_mlp_norm"] = S("post_mlp_norm", norm((L, H)))
    return {
        "embed": S("embed", normal((V, H), 1.0 / math.sqrt(H))),
        "layers": layers,
        "final_norm": S("final_norm", norm((H,))),
        "lm_head": S("lm_head", normal((H, V), 1.0 / math.sqrt(H))),
    }


def params_from_numpy(tree: Dict[str, Any], config: ModelConfig, device="cpu") -> Params:
    """Turn a JAX parameter tree (leaves as numpy arrays, e.g. from
    ``jax.device_get``) into the port's parameters on ``device``. Plain
    leaves take the config's dtype. Quantized leaves — the JAX package's
    ``QTensor(q, scale)`` (int8, ``models/quant.py``) and ``Q4Tensor(q,
    scale)`` (packed int4, ``ops/w4matmul.py``), recognised by class name so
    that the JAX package is not imported — become the port's ``QTensor`` and
    ``Q4Tensor`` with their bytes and f32 scales unchanged."""
    check_supported(config)
    dtype = config.torch_dtype

    def array(x, to_dtype=None):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: go through f32
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device=device, dtype=to_dtype) if to_dtype is not None else t.to(device)

    def conv(x):
        kind = type(x).__name__
        if kind == "Q4Tensor":
            return Q4Tensor(array(x.q, torch.int8), array(x.scale, torch.float32))
        if kind == "QTensor":
            return QTensor(array(x.q, torch.int8), array(x.scale, torch.float32))
        return array(x, dtype)

    layer_keys = _layer_keys(config)
    missing = [k for k in layer_keys if k not in tree["layers"]]
    if missing:
        raise ValueError(f"parameter tree lacks layer weights {missing}")
    return {
        "embed": conv(tree["embed"]),
        "layers": {k: conv(tree["layers"][k]) for k in layer_keys},
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


def params_to_numpy(tree: Params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy` for an unsharded tree of
    plain tensors (a trained tree): the JAX package's layout with numpy
    leaves, bf16 widened to f32 (numpy has no bf16; the widening is exact,
    and ``params_from_numpy`` rounds it back bit for bit)."""
    if _tp_mesh(tree) is not None:
        raise ValueError("params_to_numpy takes an unsharded tree, not a tensor-parallel shard")

    def array(t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"params_to_numpy takes plain tensors, not {type(t).__name__}")
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return {
        "embed": array(tree["embed"]),
        "layers": {k: array(v) for k, v in tree["layers"].items()},
        "final_norm": array(tree["final_norm"]),
        "lm_head": array(tree["lm_head"]),
    }


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s weights; quantized leaves slice their payload and
    scales together. A sharded tree's mesh rides along under ``"mesh"``."""
    layer = {k: v[i] for k, v in params["layers"].items()}
    if params.get("mesh") is not None:
        layer["mesh"] = params["mesh"]
    return layer


def _tp_mesh(tree: Params):
    """The tree's mesh when its model axis is sharded, else None."""
    mesh = tree.get("mesh")
    return mesh if is_tensor_parallel(mesh) else None


def _row_parallel_dot(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight: on a tensor-parallel mesh the
    rank's partial product summed over ``model`` (one ``psum``; a marked
    int4 weight's ``w4_matmul_tp`` makes it)."""
    out = qdot(x, w)
    if mesh is not None and not (isinstance(w, Q4Tensor) and w.part == "row" and w.mesh is not None):
        out = reduce_from_model(out, mesh)
    return out


class KVCache(NamedTuple):
    """Stacked per-layer cache: k/v are [num_layers, batch, max_len,
    kv_heads, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(config: ModelConfig, batch: int, max_len: int, device, dtype=None) -> KVCache:
    dtype = dtype or config.torch_dtype
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, offset: bool = False) -> torch.Tensor:
    """RMSNorm; ``offset`` (Gemma) scales by ``1 + w``, formed in f32 and
    cast to x's dtype."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    w = (1.0 + weight.float()).to(x.dtype) if offset else weight
    return (x32 * scale).to(x.dtype) * w


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 soft capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def _activation(config: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if config.act == "gelu":  # GeGLU (Gemma): the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu(x)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values in descending
    order, a tie taken by the lower index (a stable descending sort;
    ``torch.topk`` does not promise which index wins a tie)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_mlp(config: ModelConfig, layer: Params, h: torch.Tensor) -> torch.Tensor:
    """Mixtral's top-k token-choice MoE, computed densely over every expert
    as the JAX function does (one einsum per projection over the stacked
    experts; no gather, no sparse dispatch): router logits in f32, a softmax
    over the k selected only, scattered back to a [B, S, E] combine weight
    by a one-hot sum."""
    E, K = config.num_experts, config.num_experts_per_tok
    router_logits = (h @ layer["w_router"]).float()  # [B, S, E]
    top_vals, top_idx = _top_k(router_logits, K)
    top_w = torch.softmax(top_vals, dim=-1)  # [B, S, K]
    one_hot = torch.nn.functional.one_hot(top_idx, E).float()  # [B, S, K, E]
    combine = (one_hot * top_w[..., None]).sum(dim=-2)  # [B, S, E]
    mesh = _tp_mesh(layer)
    if mesh is not None:  # this rank's experts, combined by a psum below
        e_local = layer["w_gate"].shape[0]
        lo = mesh.axis_index(MODEL_AXIS) * e_local
        # The replicated router's gradient reaches each rank through its
        # experts' columns only: summed over model, as the expert inputs'.
        combine = copy_to_model(combine, mesh)[..., lo: lo + e_local]
        h = copy_to_model(h, mesh)

    gate = _activation(config, qeinsum("bsh,ehi->bsei", h, layer["w_gate"]))
    up = qeinsum("bsh,ehi->bsei", h, layer["w_up"])
    expert_out = qeinsum("bsei,eih->bseh", gate * up, layer["w_down"])
    out = torch.einsum("bseh,bse->bsh", expert_out, combine.to(expert_out.dtype))
    return out if mesh is None else reduce_from_model(out, mesh)


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
    h = copy_to_model(rms_norm(x, layer["attn_norm"], config.rms_eps, config.norm_offset),
                      _tp_mesh(layer))
    q, k, v = qdot(h, layer["wq"]), qdot(h, layer["wk"]), qdot(h, layer["wv"])
    if "bq" in layer:  # Qwen2-family QKV biases
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    # Heads from the weights: QH/TP and KVH/TP on a tensor-parallel rank.
    q = q.reshape(B, Sq, -1, config.head_dim)
    k = k.reshape(B, Sq, -1, config.head_dim)
    v = v.reshape(B, Sq, -1, config.head_dim)
    q = rope_embed(q, positions, config.rope_theta, config.rope_scaling)
    k = rope_embed(k, positions, config.rope_theta, config.rope_scaling)
    return q, k, v


def _mlp_sublayer(config: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    """Post-attention MLP sublayer (gated dense MLP or MoE) with its
    residual; Gemma-2 normalises the MLP's output before the add."""
    offset = config.norm_offset
    h = rms_norm(x, layer["mlp_norm"], config.rms_eps, offset)
    if "w_router" in layer:  # MoE (Mixtral)
        out = _moe_mlp(config, layer, h)
    else:
        mesh = _tp_mesh(layer)
        h = copy_to_model(h, mesh)
        gate = _activation(config, qdot(h, layer["w_gate"]))
        out = _row_parallel_dot(gate * qdot(h, layer["w_up"]), layer["w_down"], mesh)
    if "post_mlp_norm" in layer:
        out = rms_norm(out, layer["post_mlp_norm"], config.rms_eps, offset)
    return x + out


def _attn_residual(config: ModelConfig, layer: Params, x: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Attention output projection plus the block's first residual."""
    out = _row_parallel_dot(attn, layer["wo"], _tp_mesh(layer))
    if "post_attn_norm" in layer:
        out = rms_norm(out, layer["post_attn_norm"], config.rms_eps, config.norm_offset)
    return x + out


def _is_local(config: ModelConfig, i: int) -> bool:
    """Whether layer ``i`` attends through the sliding window: every layer
    of an "all" config, the even layers of an alternating one (the JAX
    ``_local_layer_flags``)."""
    if config.sliding_window is None:
        return False
    return config.sliding_window_layers == "all" or i % 2 == 0


def _layer_window(config: ModelConfig, i: int) -> Optional[int]:
    """Layer ``i``'s window for the flash kernel: the config's window on a
    local layer, none on a global one."""
    return config.sliding_window if _is_local(config, i) else None


def _pick(config: ModelConfig, i: int, windowed, global_):
    """Layer ``i``'s mask: the windowed one on a local layer (or everywhere
    when no layer is global), else the global one."""
    return windowed if global_ is None or _is_local(config, i) else global_


def _alternating(config: ModelConfig) -> bool:
    return config.sliding_window is not None and config.sliding_window_layers != "all"


def _merge_prefix_tail(q, cache_k, cache_v, key_mask, scale, out_p, m_p, l_p):
    """Exact logsumexp merge of a prefix-phase partial (normalized out
    [B, QH, Sq, D], running max m and denominator l [B, QH, Sq]) with the
    per-row generated-KV tail. Returns the merged attention [B, Sq, QH, D]
    f32."""
    s_g = _gqa_scores(q, cache_k) * scale  # [B, QH, Sq, G]
    s_g = torch.where(key_mask[:, None], s_g, torch.full_like(s_g, NEG_INF))
    m_g = s_g.amax(dim=-1)  # [B, QH, Sq]
    p_g = torch.exp(s_g - m_g[..., None])
    l_g = p_g.sum(dim=-1)
    out_g = _gqa_values(p_g, cache_v).transpose(1, 2)  # [B, QH, Sq, D]

    m = torch.maximum(m_p, m_g)
    a_p = torch.exp(m_p - m)
    a_g = torch.exp(m_g - m)
    denom = l_p * a_p + l_g * a_g
    merged = (out_p * (l_p * a_p)[..., None] + out_g * a_g[..., None]) / torch.where(
        denom == 0.0, torch.ones_like(denom), denom
    )[..., None]
    return merged.transpose(1, 2)


def flash_prefix_gate(config: ModelConfig, B: int, R: int, Sq: int,
                      n_per: Optional[int] = None) -> bool:
    """Whether a decode step takes the decode-prefix kernel: the JAX
    package's gate (``models/llama.py`` ``_block``), at least 8 query rows
    per request and kv head. ``n_per`` is the launch's rows per request
    where a data rank holds only a share of them (JAX judges the global
    batch); else ``B // R``."""
    return (
        config.decode_attention_impl == "flash"
        and config.sliding_window is None
        and config.attn_softcap is None
        and Sq == 1
        and (n_per or B // R) * (config.num_heads // config.num_kv_heads) >= 8
    )


def decode_attention(q, cache_k, cache_v, key_mask, pk, pv, prefix_mask, prefix_lengths,
                     *, scale: float, flash_prefix: bool,
                     softcap: Optional[float] = None, ring_mesh=None) -> torch.Tensor:
    """Decode-step attention over a shared prefix (pk/pv [R, P, KVH, D],
    prefix_mask [B, Sq, P], prefix_lengths [R]) and each row's own cache
    (cache_k/cache_v [B, G, KVH, D], key_mask [B, Sq, G]) for queries q
    [B, Sq, QH, D]. ``flash_prefix`` runs the decode-prefix kernel on the
    prefix and merges the tail (never with a softcap: the gate leaves those
    models out); otherwise one concatenated softmax, the ``softcap`` applied
    to the scaled scores before the masks. Returns [B, Sq, QH, D] f32.
    Shared by the dense and the paged reference step, so the two agree
    operation for operation. With ``ring_mesh`` the prefix is this rank's
    chunk of a single request's SEQUENCE-SHARDED prefix (R = 1) and ring
    attention scores it (the JAX ``sp_ring_mesh`` arm, any ``Sq``); the B
    rows are this rank's share of the launch's, as JAX's ``q_spec`` places
    the queries over the ring's axis."""
    if ring_mesh is not None:
        from ..ops.ring_attention import ring_verify_prefix

        out_p, m_p, l_p = ring_verify_prefix(
            ring_mesh, q.transpose(1, 2), pk, pv, prefix_lengths.reshape(-1)[0], sm_scale=scale
        )
        return _merge_prefix_tail(q, cache_k, cache_v, key_mask, scale, out_p, m_p, l_p)
    if flash_prefix:
        out_p, m_p, l_p = decode_prefix_attention(
            q[:, 0].contiguous(), pk, pv, prefix_lengths, sm_scale=scale
        )
        return _merge_prefix_tail(
            q, cache_k, cache_v, key_mask, scale,
            out_p[:, :, None], m_p[:, :, None], l_p[:, :, None],
        )
    scores = _gqa_scores(q, cache_k) * scale  # [B, QH, Sq, G] f32
    if softcap is not None:
        scores = _softcap(scores, softcap)
    scores = torch.where(key_mask[:, None], scores, torch.full_like(scores, NEG_INF))
    p_scores = _gqa_scores_shared(q, pk) * scale  # [B, QH, Sq, P]
    if softcap is not None:
        p_scores = _softcap(p_scores, softcap)
    p_scores = torch.where(prefix_mask[:, None], p_scores, torch.full_like(p_scores, NEG_INF))
    weights = torch.softmax(torch.cat([p_scores, scores], dim=-1), dim=-1)
    P = pk.shape[1]
    return _gqa_values_shared(weights[..., :P], pv) + _gqa_values(weights[..., P:], cache_v)


def _block(
    config: ModelConfig,
    layer: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    key_mask: torch.Tensor,
    key_lengths: torch.Tensor,
    window: Optional[int],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One full-sequence (prefill) block. x: [B, S, H]; key_mask: [B|1, S, S]
    booleans for the plain path (this layer's, windowed or not); key_lengths:
    [B] valid keys and ``window`` this layer's window for the flash path.
    Returns (x, (k, v)) with k/v [B, S, KVH, D] — the layer's cache."""
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
            softcap=config.attn_softcap,
            window=window,
        ).transpose(1, 2)
    else:
        scores = _gqa_scores(q, k) * scale  # [B, QH, S, S] f32
        if config.attn_softcap is not None:
            scores = _softcap(scores, config.attn_softcap)
        scores = torch.where(key_mask[:, None], scores, torch.full_like(scores, NEG_INF))
        attn = _gqa_values(torch.softmax(scores, dim=-1), v)
    attn = attn.to(x.dtype).reshape(B, Sq, -1)
    return _mlp_sublayer(config, layer, _attn_residual(config, layer, x, attn)), (k, v)


def _apply_stack(config, params, x, positions, key_mask, key_lengths, key_mask_global=None):
    """All layers of the full-sequence path; ``key_mask`` is the windowed
    mask where the config has a window, ``key_mask_global`` the causal one
    its global layers take (alternating configs only). Returns (x, k [L, B,
    S, KVH, D], v [L, B, S, KVH, D])."""
    ks, vs = [], []
    for i in range(config.num_layers):
        x, (k, v) = _block(
            config, _layer(params, i), x, positions,
            _pick(config, i, key_mask, key_mask_global), key_lengths, _layer_window(config, i),
        )
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _embed(config: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    mesh = _tp_mesh(params)
    if mesh is None:
        x = params["embed"][tokens.long()]
    else:
        # Vocabulary-sharded table: each rank looks up the rows it owns,
        # zeroes the rest, and one psum assembles every row exactly.
        v_local = params["embed"].shape[0]
        local = tokens.long() - mesh.axis_index(MODEL_AXIS) * v_local
        owned = (local >= 0) & (local < v_local)
        x = params["embed"][local.clamp(0, v_local - 1)]
        x = reduce_from_model(torch.where(owned[..., None], x, torch.zeros_like(x)), mesh)
    if config.embed_scale:  # Gemma: sqrt(H), rounded to the model dtype first
        x = x * torch.tensor(math.sqrt(config.hidden_size), dtype=x.dtype, device=x.device)
    return x


def _final_norm(config: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], config.rms_eps, config.norm_offset)


def _logits(config: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    mesh = _tp_mesh(params)
    # Vocabulary shards -> whole logits on a tensor-parallel mesh.
    logits = gather_from_model(qdot(copy_to_model(h, mesh), params["lm_head"]).float(), mesh)
    if config.logit_softcap is not None:
        logits = _softcap(logits, config.logit_softcap)
    return logits


def _full_sequence_masks(config: ModelConfig, causal: torch.Tensor, valid: torch.Tensor):
    """(key_mask, key_mask_global) of a full-sequence pass from its causal
    [S, S] mask and the valid keys [B, S]: with a window, query i sees keys
    (i - W, i]; an alternating config keeps the causal mask for its global
    layers."""
    key_mask_global = None
    if config.sliding_window is not None:
        S = causal.shape[0]
        band = causal & torch.ones((S, S), dtype=torch.bool, device=causal.device).triu(
            -(config.sliding_window - 1))
        if _alternating(config):
            key_mask_global = causal[None] & valid[:, None, :]
        causal = band
    return causal[None] & valid[:, None, :], key_mask_global


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def forward(config: ModelConfig, params: Params, tokens: torch.Tensor, pad_mask: torch.Tensor):
    """Full-sequence causal forward (no cache). Returns (logits f32 [B, S,
    V], final hidden states [B, S, H])."""
    h = encode(config, params, tokens, pad_mask)
    return _logits(config, params, h), h


def encode(config: ModelConfig, params: Params, tokens: torch.Tensor, pad_mask: torch.Tensor):
    """Final hidden states [B, S, H] — the embedding provider mean-pools
    them; the lm_head projection is skipped."""
    check_supported(config)
    B, S = tokens.shape
    positions = (torch.cumsum(pad_mask.long(), dim=1) - 1).clamp_min(0)
    x = _embed(config, params, tokens)
    causal = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    key_mask, key_mask_global = _full_sequence_masks(config, causal, pad_mask.bool())
    key_lengths = pad_mask.long().sum(dim=1).to(torch.int32)
    x, _, _ = _apply_stack(config, params, x, positions, key_mask, key_lengths, key_mask_global)
    return _final_norm(config, params, x)


def prefill(config: ModelConfig, params: Params, tokens: torch.Tensor, prompt_len: int):
    """Prefill the shared prompt at batch=1. tokens: [1, S] (bucket-padded on
    the right), prompt_len: valid length. Returns (last-token logits [1, V],
    (k, v) each [L, 1, S, KVH, D])."""
    check_supported(config)
    B, S = tokens.shape
    device = tokens.device
    positions = torch.arange(S, device=device)[None, :].expand(B, S)
    x = _embed(config, params, tokens)
    causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    valid = torch.arange(S, device=device)[None, :] < int(prompt_len)
    key_mask, key_mask_global = _full_sequence_masks(config, causal, valid)
    key_lengths = torch.full((B,), int(prompt_len), dtype=torch.int32, device=device)
    x, k, v = _apply_stack(config, params, x, positions, key_mask, key_lengths, key_mask_global)
    h = _final_norm(config, params, x[:, int(prompt_len) - 1])
    return _logits(config, params, h), (k, v)


def prefill_continue(
    config: ModelConfig,
    params: Params,
    suffix_tokens: torch.Tensor,
    cache: KVCache,
    prefix_len: int,
    total_len: int,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a prompt SUFFIX against an already-computed prompt-prefix KV
    (the prefix cache's partial hit).

    ``cache`` [L, 1, Btot, KVH, D] holds the reused prefix KV at positions
    0..prefix_len (the rest arbitrary); suffix_tokens: [1, Sq] right-padded.
    The suffix KV is written in place at positions prefix_len.., and the
    updated cache is returned: directly the decode loop's shared prefix and
    the next cache entry. Attention masks are built over absolute positions:
    under ``attention_impl="flash"`` the suffix rows reach the flash kernel
    with ``q_offset = prefix_len`` and ``key_lengths = total_len`` (a valid
    row sees keys up to its own position either way, so the key length
    changes only the padded rows); otherwise one masked softmax over the
    whole cache, as in the JAX function. Windows and softcaps apply as in
    prefill, the window at absolute positions. Returns (last-valid-token
    logits [1, V], the cache)."""
    check_supported(config)
    B, Sq = suffix_tokens.shape
    Btot = cache.k.shape[2]
    device = suffix_tokens.device
    p, total = int(prefix_len), int(total_len)
    positions = (p + torch.arange(Sq, device=device))[None, :].expand(B, Sq)
    x = _embed(config, params, suffix_tokens)
    rows = p + torch.arange(Sq, device=device)[None, :, None]  # absolute query positions
    cols = torch.arange(Btot, device=device)[None, None, :]
    key_mask = cols <= rows  # [1, Sq, Btot]
    key_mask_global = None
    if config.sliding_window is not None:
        if _alternating(config):
            key_mask_global = key_mask
        key_mask = key_mask & (cols > rows - config.sliding_window)
    key_lengths = torch.full((B,), total, dtype=torch.int32, device=device)
    scale = config.query_scale or 1.0 / math.sqrt(config.head_dim)
    for i in range(config.num_layers):
        layer = _layer(params, i)
        cache_k, cache_v = cache.k[i], cache.v[i]
        q, k, v = _attn_qkv(config, layer, x, positions)
        cache_k[:, p: p + Sq] = k.to(cache_k.dtype)
        cache_v[:, p: p + Sq] = v.to(cache_v.dtype)
        if config.attention_impl == "flash":
            attn = flash_attention(
                q.transpose(1, 2).contiguous(),
                cache_k.transpose(1, 2).contiguous(),
                cache_v.transpose(1, 2).contiguous(),
                causal=True,
                key_lengths=key_lengths,
                sm_scale=scale,
                softcap=config.attn_softcap,
                window=_layer_window(config, i),
                q_offset=p,
            ).transpose(1, 2)
        else:
            scores = _gqa_scores(q, cache_k) * scale  # [B, QH, Sq, Btot] f32
            if config.attn_softcap is not None:
                scores = _softcap(scores, config.attn_softcap)
            mask = _pick(config, i, key_mask, key_mask_global)
            scores = torch.where(mask[:, None], scores, torch.full_like(scores, NEG_INF))
            attn = _gqa_values(torch.softmax(scores, dim=-1), cache_v)
        attn = attn.to(x.dtype).reshape(B, Sq, -1)
        x = _mlp_sublayer(config, layer, _attn_residual(config, layer, x, attn))
    h = _final_norm(config, params, x[:, total - p - 1])
    return _logits(config, params, h), cache


def _block_decode(
    config: ModelConfig,
    layer: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    write_index,
    key_mask: torch.Tensor,
    prefix_kv: Tuple[torch.Tensor, torch.Tensor],
    prefix_mask: torch.Tensor,
    prefix_lengths: torch.Tensor,
    ring_mesh=None,
    n_per: Optional[int] = None,
) -> torch.Tensor:
    """The dense decode branch of the JAX ``_block``: this step's ``Sq``
    k/v columns are written into the layer's cache (cache_k/cache_v [B, G,
    KVH, D], updated in place) at ``write_index`` (an int for every row, or
    a [B] tensor of per-row offsets: column j of row b goes to slot
    ``write_index[b] + j``), then the queries attend the shared prefix
    (prefix_kv [R, P, KVH, D]) and the cache. Returns x."""
    B, Sq, _ = x.shape
    scale = config.query_scale or 1.0 / math.sqrt(config.head_dim)
    q, k, v = _attn_qkv(config, layer, x, positions)
    if isinstance(write_index, torch.Tensor):  # per-row offsets [B] (verify_step)
        rows = torch.arange(B, device=x.device)[:, None]
        slots = write_index[:, None] + torch.arange(Sq, device=x.device)[None, :]
        cache_k[rows, slots] = k.to(cache_k.dtype)
        cache_v[rows, slots] = v.to(cache_v.dtype)
    else:
        cache_k[:, write_index: write_index + Sq] = k.to(cache_k.dtype)
        cache_v[:, write_index: write_index + Sq] = v.to(cache_v.dtype)
    pk, pv = prefix_kv
    attn = decode_attention(
        q, cache_k, cache_v, key_mask, pk, pv, prefix_mask, prefix_lengths,
        scale=scale, flash_prefix=flash_prefix_gate(config, B, pk.shape[0], Sq, n_per),
        softcap=config.attn_softcap, ring_mesh=ring_mesh,
    )
    attn = attn.to(x.dtype).reshape(B, Sq, -1)
    return _mlp_sublayer(config, layer, _attn_residual(config, layer, x, attn))


def _step_masks(config: ModelConfig, lengths, pl_row, positions, G: int, P: int, Sq: int = 1):
    """The verify step's masks, as the JAX ``verify_step`` (and, at ``Sq ==
    1``, ``paged_verify_step``) builds them: (self_mask [B, Sq, G],
    prefix_mask [B, 1, P] or, with a window, [B, Sq, P], and their global
    twins for an alternating config, else None). Query j of row b sees gen
    slot s when ``s <= lengths[b] + j``; with a window also ``s > lengths[b]
    + j - W``, and prefix column c when ``c > positions[b, j] - W``."""
    device = lengths.device
    s = torch.arange(G, device=device)[None, None, :]
    c = torch.arange(P, device=device)[None, None, :]
    qpos = (lengths[:, None] + torch.arange(Sq, device=device)[None, :])[:, :, None]
    self_mask = s <= qpos
    prefix_mask = c < pl_row[:, None, None]
    self_global = prefix_global = None
    if config.sliding_window is not None:
        W = config.sliding_window
        if _alternating(config):
            self_global, prefix_global = self_mask, prefix_mask
        self_mask = self_mask & (s > qpos - W)
        prefix_mask = prefix_mask & (c > positions[:, :, None] - W)
    return self_mask, prefix_mask, self_global, prefix_global


def decode_step(
    config: ModelConfig,
    params: Params,
    token: torch.Tensor,
    step: int,
    prompt_len: torch.Tensor,
    gen_cache: KVCache,
    prefix: KVCache,
    ring_mesh=None,
    n_per: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for all samples against their shared prefix(es).

    token: [B] current tokens; step: decode index (0-based); prompt_len: [R]
    per-request prompt lengths (rows request-major, B % R == 0); gen_cache:
    [L, B, G, KVH, D], written in place at slot ``step``; prefix: [L, R, P,
    KVH, D], or with ``ring_mesh`` this rank's chunk [L, 1, P/ring, KVH, D]
    of a sequence-sharded prefix. ``n_per``: the launch's rows per request
    when these B rows are a data rank's share (the decode-prefix gate's
    count). Returns (logits f32 [B, V], gen_cache)."""
    check_supported(config)
    B = token.shape[0]
    device = token.device
    G = gen_cache.max_len
    P = prefix.max_len
    pl = prompt_len.reshape(-1).to(device=device, dtype=torch.int64)
    pl_row = pl.repeat_interleave(B // pl.shape[0])  # [B]
    step = int(step)

    positions = (pl_row + step)[:, None]
    x = _embed(config, params, token[:, None])
    # Generated slots 0..step are valid after this step's write: the verify
    # step's masks at lengths = step on every row.
    self_mask, prefix_mask, self_global, prefix_global = _step_masks(
        config, torch.full((B,), step, device=device), pl_row, positions, G, P)
    plen32 = pl.to(torch.int32)
    for i in range(config.num_layers):
        x = _block_decode(
            config, _layer(params, i), x, positions, gen_cache.k[i], gen_cache.v[i],
            step, _pick(config, i, self_mask, self_global),
            prefix_mask=_pick(config, i, prefix_mask, prefix_global),
            prefix_kv=(prefix.k[i], prefix.v[i]), prefix_lengths=plen32,
            ring_mesh=ring_mesh, n_per=n_per,
        )
    h = _final_norm(config, params, x)
    return _logits(config, params, h[:, 0]), gen_cache


def verify_step(
    config: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    prompt_len: torch.Tensor,
    gen_cache: KVCache,
    prefix: KVCache,
    ring_mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """The JAX ``verify_step``: score ``Sq`` tokens per row in one forward
    at per-row offsets. At ``Sq == 1`` it is the continuous loop's dense
    step; at ``Sq = K + 1`` speculative verification (the row's last
    accepted token followed by its K drafts).

    tokens: [B, Sq]; lengths: [B] generated counts (each row's write offset
    into its gen cache slots: column j goes to slot ``lengths[b] + j``, and
    rejected slots are overwritten by a later verify); prompt_len: [R]
    per-request prompt lengths, rows request-major; gen_cache [L, B, G,
    KVH, D], written in place (the caller keeps ``lengths + Sq <= G``);
    prefix [L, R, P, KVH, D]. Masks as in the JAX function: query j of row b
    sees slot s when ``s <= lengths[b] + j``, at position ``prompt_len +
    lengths[b] + j``. The attention is the plain concatenated softmax
    whenever ``Sq > 1`` (the decode-prefix kernel's gate needs ``Sq == 1``,
    as in JAX); ``ring_mesh`` as in :func:`decode_step`. Returns (logits
    f32 [B, Sq, V], where logits[b, j] conditions on tokens[b, :j+1], and
    gen_cache)."""
    check_supported(config)
    B, Sq = tokens.shape
    device = tokens.device
    G = gen_cache.max_len
    P = prefix.max_len
    pl = prompt_len.reshape(-1).to(device=device, dtype=torch.int64)
    pl_row = pl.repeat_interleave(B // pl.shape[0])  # [B]
    lengths = lengths.to(device=device, dtype=torch.int64)

    positions = pl_row[:, None] + lengths[:, None] + torch.arange(Sq, device=device)[None, :]
    x = _embed(config, params, tokens)
    self_mask, prefix_mask, self_global, prefix_global = _step_masks(
        config, lengths, pl_row, positions, G, P, Sq)
    plen32 = pl.to(torch.int32)
    for i in range(config.num_layers):
        x = _block_decode(
            config, _layer(params, i), x, positions, gen_cache.k[i], gen_cache.v[i],
            lengths, _pick(config, i, self_mask, self_global),
            prefix_mask=_pick(config, i, prefix_mask, prefix_global),
            prefix_kv=(prefix.k[i], prefix.v[i]), prefix_lengths=plen32,
            ring_mesh=ring_mesh,
        )
    h = _final_norm(config, params, x)
    return _logits(config, params, h), gen_cache


def prefill_chunk_step(
    config: ModelConfig,
    params: Params,
    chunk_tokens: torch.Tensor,
    cache: KVCache,
    cursor: int,
    valid_len: int,
) -> Tuple[torch.Tensor, KVCache]:
    """Extend a partially filled prompt prefix by one chunk (chunked
    prefill). ``chunk_tokens`` [1, C] the next C prompt tokens,
    right-padded; ``cache`` [L, 1, bucket, KVH, D] the staging cache holding
    positions 0..cursor, written in place; ``valid_len`` the chunk's real
    tokens. A chunk is a prompt-suffix continuation, so this is
    :func:`prefill_continue` (K2 in its ``q_offset`` mode under
    ``attention_impl="flash"``), as in the JAX function. Returns
    (last-valid-token logits [1, V], meaningful on the final chunk; the
    cache)."""
    return prefill_continue(config, params, chunk_tokens, cache, int(cursor),
                            int(cursor) + int(valid_len))


def prefill_chunk_step_paged(
    config: ModelConfig,
    params: Params,
    chunk_tokens: torch.Tensor,
    cache: KVCache,
    cursor: int,
    valid_len: int,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor, torch.Tensor]:
    """:func:`prefill_chunk_step` plus the chunk's KV columns sliced out of
    the staging cache (k_cols, v_cols [L, C, KVH, D]) for the caller to
    scatter into the row's reserved page run."""
    C = chunk_tokens.shape[1]
    logits, cache = prefill_chunk_step(config, params, chunk_tokens, cache, cursor, valid_len)
    c = int(cursor)
    return logits, cache, cache.k[:, 0, c: c + C], cache.v[:, 0, c: c + C]


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
    prefix_lengths: Optional[torch.Tensor],
    n_per: Optional[int] = None,
):
    """Paged twin of the decode block at ``Sq == 1``: KV comes from one
    layer's flat page pool through block tables. "cuda" runs the fused
    kernel (its plain version for CPU tensors), "xla" the dense-equivalent
    reference, which takes the decode-prefix kernel behind the same gate as
    the dense step. Returns (x, (k_col, v_col)) with the cols [B, KVH, D] in
    pool dtype — this step's column, which the caller scatters into the
    pool."""
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
            key_mask, prefix_mask, sm_scale=scale, softcap=config.attn_softcap,
            prefix_lengths=prefix_lengths,
            flash_prefix=flash_prefix_gate(config, B, prefix_idx.shape[0], Sq, n_per),
        )
    attn = attn.to(x.dtype).reshape(B, Sq, -1)
    x = _attn_residual(config, layer, x, attn)
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
    n_per: Optional[int] = None,
):
    """One paged decode step at ``Sq == 1`` for every row.

    tokens: [B, 1] current tokens; lengths: [B] generated counts (each row's
    write offset into its gen slots); prompt_len: [R] per-request prompt
    lengths (rows request-major); pool_k/pool_v: ``[L, pages * ps, KVH,
    D]``; prefix_idx [R, P] / gen_idx [B, G]: flat pool slots per logical
    position. Masks are built as in the JAX function. ``n_per`` as in
    :func:`decode_step`. Returns (logits f32 [B, 1, V], k_cols, v_cols [L,
    B, KVH, D]). The pool is only read here.
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
    x = _embed(config, params, tokens)
    self_mask, prefix_mask, self_global, prefix_global = _step_masks(
        config, lengths, pl_row, positions, G, P)
    if config.attn_softcap is not None or config.sliding_window is not None:
        # The JAX gate (``_block_paged``): the kernel serves neither softcaps
        # nor windows; the engine resolves such configs to "xla" already.
        attn_impl = "xla"

    # Layer-invariant arguments, built once per step: the kernel's tables,
    # or the reference's prefix lengths.
    page_tables = plen32 = None
    if attn_impl == "cuda":
        page_tables = paged_attention_page_tables(prefix_idx, gen_idx, page_size) + (
            pl_row.to(torch.int32), lengths.to(torch.int32),
        )
    else:
        plen32 = pl.to(torch.int32)
    k_cols, v_cols = [], []
    for i in range(config.num_layers):
        x, (kc, vc) = _block_paged(
            config, _layer(params, i), x, positions, pool_k[i], pool_v[i],
            prefix_idx, gen_idx, lengths, _pick(config, i, self_mask, self_global),
            _pick(config, i, prefix_mask, prefix_global),
            page_tables, page_size, attn_impl, plen32, n_per,
        )
        k_cols.append(kc)
        v_cols.append(vc)
    h = _final_norm(config, params, x)
    return _logits(config, params, h), torch.stack(k_cols), torch.stack(v_cols)
