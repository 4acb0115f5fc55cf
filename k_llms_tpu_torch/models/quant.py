"""Weight-only quantization of the matmul weights (int8 and int4).

Counterpart of ``k_llms_tpu/models/quant.py``, without the mesh helpers
(the port has no tensor-parallel mesh yet). A :class:`QTensor` (int8
payload, per-output-channel f32 scale) or a
:class:`~k_llms_tpu_torch.ops.w4matmul.Q4Tensor` (packed nibbles, per-group
f32 scales) takes the place of a weight in the parameter dict; ``qdot(x, w)``
dispatches on the weight's type, and ``qeinsum`` does the same for the
mixture-of-experts einsums, so the model code is quantization-agnostic.
Expert stacks ([L, E, in, out]) stay int8 under int4, as in the JAX package.
Embeddings, norms and the MoE router stay in the model dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch

from ..ops.w4matmul import GROUP, Q4Tensor, pack_int4, supports_int4, w4_matmul


class QTensor:
    """Symmetric per-output-channel int8 weight: ``q`` has the weight's
    shape [..., in, out]; ``scale`` is f32 [..., 1, out]. ``w[i]`` indexes
    the leading (layer) axis of both."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.q[idx], self.scale[idx])

    def __repr__(self) -> str:
        return f"QTensor(q={tuple(self.q.shape)}, scale={tuple(self.scale.shape)})"

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.q.dtype

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))

    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4


WeightLike = Union[torch.Tensor, QTensor, Q4Tensor]

# Matmul weights to quantize (all contract over axis -2). Embeddings and
# norms stay in the model dtype.
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quant_leaf_nodes(params: Dict[str, Any]):
    for key in QUANT_LAYER_KEYS:
        yield params["layers"].get(key)
    yield params.get("lm_head")


def tree_has_q4(params: Dict[str, Any]) -> bool:
    """True when any quantized matmul leaf is stored int4."""
    return any(isinstance(w, Q4Tensor) for w in _quant_leaf_nodes(params))


def stored_quant_layout(params: Dict[str, Any]) -> Optional[str]:
    """The quantization a parameter dict actually stores: "int4" if any leaf
    is a Q4Tensor, "int8" if any is a QTensor, None for plain weights."""
    nodes = list(_quant_leaf_nodes(params))
    if any(isinstance(w, Q4Tensor) for w in nodes):
        return "int4"
    if any(isinstance(w, QTensor) for w in nodes):
        return "int8"
    return None


def quantize_weight(w: torch.Tensor) -> QTensor:
    """Symmetric int8 per-output-channel: scale over the contraction axis."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def qdot(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """``x @ w`` for a plain tensor, a QTensor, or a Q4Tensor. For a QTensor
    the int8 payload is cast to x's dtype inside the matmul and the
    per-channel scale is applied to the output; for a Q4Tensor the w4a16
    kernel runs (its plain version on the CPU)."""
    if isinstance(w, Q4Tensor):
        out = w4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
        return out.reshape(*x.shape[:-1], w.q.shape[-1])
    if isinstance(w, QTensor):
        out = x @ w.q.to(x.dtype)
        return out * w.scale[..., 0, :].to(out.dtype)
    return x @ w


def qeinsum(spec: str, x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """``einsum(spec, x, w)`` for a plain tensor or a QTensor weight: the
    int8 payload cast to x's dtype, then the squeezed per-channel scale on
    the output, whose trailing axes line up with the weight's non-contracted
    ones (the MoE einsums "bsh,ehi->bsei" and "bsei,eih->bseh"). Plain
    PyTorch, as the JAX function is plain XLA."""
    if isinstance(w, QTensor):
        out = torch.einsum(spec, x, w.q.to(x.dtype))
        return out * w.scale[..., 0, :].to(out.dtype)
    return torch.einsum(spec, x, w)


def int4_eligible_shape(ndim: int, k: int, n: int) -> bool:
    """Q4 needs whole 256-row K blocks and 128-column N blocks; stacks of
    more than three axes (expert weights) stay int8. Small test models fail
    the divisibility and stay int8 too. One predicate for both the quantize
    path and the random-init path, as in the JAX package."""
    return ndim <= 3 and supports_int4(k) and n % 128 == 0


def quantize_weight_bits(w: WeightLike, bits: int) -> WeightLike:
    if isinstance(w, (QTensor, Q4Tensor)):
        # Already quantized: keep the stored layout (re-quantizing the lossy
        # payload would only lose more precision).
        return w
    if bits == 4 and int4_eligible_shape(w.dim(), w.shape[-2], w.shape[-1]):
        return pack_int4(w)
    return quantize_weight(w)


def quantize_params(params: Dict[str, Any], bits: int = 8) -> Dict[str, Any]:
    """Quantize the seven block matmuls and lm_head; leave embed/norms as
    they are. ``bits=4`` packs eligible weights int4 and the rest int8.
    Stacked weights are quantized one layer at a time, so the f32 working
    copy never holds more than one layer."""

    def quant(w):
        if isinstance(w, (QTensor, Q4Tensor)) or w.dim() < 3:
            return quantize_weight_bits(w, bits)
        # Eligibility is the whole stack's (an expert stack's four axes keep
        # it int8), decided before the per-layer slices.
        b = bits if int4_eligible_shape(w.dim(), w.shape[-2], w.shape[-1]) else 8
        parts = [quantize_weight_bits(w[i], b) for i in range(w.shape[0])]
        if isinstance(parts[0], Q4Tensor):
            return Q4Tensor(torch.stack([p.q for p in parts]), torch.stack([p.scale for p in parts]))
        return QTensor(torch.stack([p.q for p in parts]), torch.stack([p.scale for p in parts]))

    layers = dict(params["layers"])
    for key in QUANT_LAYER_KEYS:
        layers[key] = quant(layers[key])
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = quant(params["lm_head"])
    return out


def init_params_quantized(
    config, generator: torch.Generator, device, dtype=None, bits: int = 8
) -> Dict[str, Any]:
    """Random quantized parameters, built directly (the bf16 tree is never
    made): int8 payloads drawn uniformly in [-127, 127], int4 packed bytes
    uniformly in [-128, 127] (two uniform nibbles in [-8, 7]), with constant
    scales chosen so the effective weights have ~N(0, 1/fan_in) magnitude —
    the JAX package's ``init_params_quantized(dist="random")`` shapes, dtypes
    and scales; the draws come from ``generator`` and differ."""
    from .llama import check_supported

    check_supported(config)
    dtype = dtype or config.torch_dtype
    device = torch.device(device)
    H, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    L, Q, KV = config.num_layers, config.q_dim, config.kv_dim

    def qinit(shape) -> WeightLike:
        K, N = shape[-2], shape[-1]
        if bits == 4 and int4_eligible_shape(len(shape), K, N):
            nibble_std = math.sqrt(sum(v * v for v in range(-8, 8)) / 16 - 0.25)
            q = torch.randint(-128, 128, shape[:-2] + (K // 2, N), generator=generator,
                              device=device, dtype=torch.int8)
            scale = torch.full(shape[:-2] + (K // GROUP, N), 1.0 / (nibble_std * math.sqrt(K)),
                               dtype=torch.float32, device=device)
            return Q4Tensor(q=q, scale=scale)
        q = torch.randint(-127, 128, shape, generator=generator, device=device, dtype=torch.int8)
        scale = torch.full(shape[:-2] + (1, N), math.sqrt(3.0) / (127.0 * math.sqrt(K)),
                           dtype=torch.float32, device=device)
        return QTensor(q=q, scale=scale)

    def normal(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.copy_(torch.randn(shape, generator=generator, device=device).mul_(scale))

    def norm(shape):
        # Offset norms (Gemma) scale by (1 + w): their identity is 0.
        fill = torch.zeros if config.norm_offset else torch.ones
        return fill(shape, dtype=dtype, device=device)

    embed = normal((V, H), 1.0 / math.sqrt(H))
    layers: Dict[str, Any] = {
        "attn_norm": norm((L, H)),
        "wq": qinit((L, H, Q)),
        "wk": qinit((L, H, KV)),
        "wv": qinit((L, H, KV)),
        "wo": qinit((L, Q, H)),
        "mlp_norm": norm((L, H)),
    }
    if config.num_experts > 0:  # the router drawn plain, the experts int8
        E = config.num_experts
        layers["w_router"] = normal((L, H, E), 1.0 / math.sqrt(H))
        layers["w_gate"] = qinit((L, E, H, I))
        layers["w_up"] = qinit((L, E, H, I))
        layers["w_down"] = qinit((L, E, I, H))
    else:
        layers["w_gate"] = qinit((L, H, I))
        layers["w_up"] = qinit((L, H, I))
        layers["w_down"] = qinit((L, I, H))
    if config.qkv_bias:
        layers["bq"] = torch.zeros((L, Q), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((L, KV), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((L, KV), dtype=dtype, device=device)
    if config.post_block_norms:
        layers["post_attn_norm"] = norm((L, H))
        layers["post_mlp_norm"] = norm((L, H))
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": norm((H,)),
        "lm_head": qinit((H, V)),
    }
