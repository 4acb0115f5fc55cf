"""Weight-only quantization of the matmul weights (int8 and int4).

Counterpart of ``k_llms_tpu/models/quant.py``, with its mesh helpers (the
int4 mesh check, the quantized spec tree, the tensor-parallel marks that
send a marked int4 leaf through ``w4_matmul_tp``). A :class:`QTensor` (int8
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

from ..ops.w4matmul import (
    GROUP,
    Q4Tensor,
    kernel_supports,
    pack_int4,
    supports_int4,
    w4_matmul,
    w4_matmul_tp,
)


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
# Megatron-style tensor-parallel layout of the quantized matmuls: column-
# parallel weights shard output columns over the model axis; row-parallel
# weights shard the contraction axis (their matmul psums partials).
COL_PARALLEL_KEYS = frozenset({"wq", "wk", "wv", "w_gate", "w_up"})
ROW_PARALLEL_KEYS = frozenset({"wo", "w_down"})


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
    kernel runs (its plain version on the CPU); a Q4Tensor marked with its
    tensor-parallel layout takes ``w4_matmul_tp`` (K4 on the shard, then
    the row split's ``psum``)."""
    if isinstance(w, Q4Tensor):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if w.part is not None and w.mesh is not None:
            out = w4_matmul_tp(x2, w)
        else:
            out = w4_matmul(x2, w)
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


def _dense_quant_shapes(config) -> Dict[str, tuple]:
    """(K, N) of each dense layer matmul (a layer's slice)."""
    H, I = config.hidden_size, config.intermediate_size
    Q, KV = config.q_dim, config.kv_dim
    return {
        "wq": (H, Q),
        "wk": (H, KV),
        "wv": (H, KV),
        "wo": (Q, H),
        "w_gate": (H, I),
        "w_up": (H, I),
        "w_down": (I, H),
    }


def _int4_local_shards(config, tp: int) -> Optional[Dict[str, tuple]]:
    """The local (K, N) of each int4-eligible dense weight on ``tp`` model-
    axis ranks, or None when one cannot shard: row-parallel needs
    K % (GROUP * tp) == 0 (no quantization group split), col-parallel
    N % tp == 0."""
    shapes = dict(_dense_quant_shapes(config))
    shapes["lm_head"] = (config.hidden_size, config.vocab_size)
    local = {}
    for key, (k, n) in shapes.items():
        ndim = 2 if key == "lm_head" else 3
        if not int4_eligible_shape(ndim, k, n):
            continue  # stays int8
        if key in ROW_PARALLEL_KEYS:
            if k % (GROUP * tp):
                return None
            local[key] = (k // tp, n)
        else:
            if n % tp:
                return None
            local[key] = (k, n // tp)
    return local


def int4_mesh_compatible(config, tp: int) -> bool:
    """True when every int4-eligible weight can shard over ``tp`` model-axis
    ranks without splitting a quantization group or fracturing columns
    (``_int4_local_shards``); MoE configs keep int4 off the experts, and on
    a mesh turn to int8 (the JAX package's rule)."""
    if tp <= 1:
        return True
    if config.num_experts > 0:
        return False  # expert einsums have no sharded-int4 path
    return _int4_local_shards(config, tp) is not None


def int4_off_kernel_shards(config, tp: int) -> Dict[str, tuple]:
    """The int4-eligible weights whose local shard on ``tp`` ranks K4 does
    not take (``kernel_supports``: K % 256, N % 16), with that shard's (K,
    N). K4 masks its last column tile, so Llama-3-8B's ``lm_head`` shards
    at tp = 4 ([4096, 32064]) and 8 ([4096, 16032]) run on it, and no
    registered model lists a weight at tp <= 8. The JAX package takes such a
    shard through its dequantize fallback; the port has none, so on a card
    the engine keeps a listed weight int8 (the plain version on the CPU
    takes any shard)."""
    if not int4_mesh_compatible(config, tp):
        return {}
    local = _int4_local_shards(config, tp) or {}
    return {key: kn for key, kn in local.items() if not kernel_supports(*kn)}


def quantized_param_specs(specs: Dict[str, Any], bits: int = 8, config=None) -> Dict[str, Any]:
    """Map a plain spec tree (``parallel.sharding.param_specs``) to the
    quantized tree: an int8 payload keeps its weight's spec and its scale
    drops the contraction axis (size 1); with ``bits=4`` the int4-eligible
    keys get Q4Tensor nodes whose payload and group scales both keep the
    weight's spec. (``shard_params`` follows the leaves a tree holds, so a
    pre-quantized tree needs no reconciled spec tree.)"""
    from ..parallel.sharding import scale_spec

    q4_keys = set()
    if bits == 4 and config is not None:
        for key, (k, n) in _dense_quant_shapes(config).items():
            if config.num_experts > 0 and key in ("w_gate", "w_up", "w_down"):
                continue  # 4-D expert stacks stay int8
            if int4_eligible_shape(3, k, n):
                q4_keys.add(key)
        if int4_eligible_shape(2, config.hidden_size, config.vocab_size):
            q4_keys.add("lm_head")

    def qspec(key, spec):
        if key in q4_keys:
            return Q4Tensor(q=spec, scale=spec)
        return QTensor(q=spec, scale=scale_spec(spec))

    layers = dict(specs["layers"])
    for key in QUANT_LAYER_KEYS:
        layers[key] = qspec(key, layers[key])
    out = dict(specs)
    out["layers"] = layers
    out["lm_head"] = qspec("lm_head", specs["lm_head"])
    return out


def mark_int4_partitioning(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Stamp every Q4Tensor leaf with its tensor-parallel layout and the
    mesh, so ``qdot`` routes it through ``w4_matmul_tp``. Idempotent; trees
    without Q4 leaves pass through unchanged."""
    layers = dict(params["layers"])
    for key in QUANT_LAYER_KEYS:
        w = layers.get(key)
        if isinstance(w, Q4Tensor):
            part = "col" if key in COL_PARALLEL_KEYS else "row"
            layers[key] = Q4Tensor(w.q, w.scale, part=part, mesh=mesh)
    out = dict(params)
    out["layers"] = layers
    head = out.get("lm_head")
    if isinstance(head, Q4Tensor):
        out["lm_head"] = Q4Tensor(head.q, head.scale, part="col", mesh=mesh)
    return out


def quantize_weight_bits(w: WeightLike, bits: int) -> WeightLike:
    if isinstance(w, (QTensor, Q4Tensor)):
        # Already quantized: keep the stored layout (re-quantizing the lossy
        # payload would only lose more precision).
        return w
    if bits == 4 and int4_eligible_shape(w.dim(), w.shape[-2], w.shape[-1]):
        return pack_int4(w)
    return quantize_weight(w)


def quantize_params(params: Dict[str, Any], bits: int = 8, int8_keys=frozenset()) -> Dict[str, Any]:
    """Quantize the seven block matmuls and lm_head; leave embed/norms as
    they are. ``bits=4`` packs eligible weights int4 and the rest int8, and
    the weights named in ``int8_keys`` int8 too. Stacked weights are
    quantized one layer at a time, so the f32 working copy never holds more
    than one layer."""

    def quant(w, b):
        if isinstance(w, (QTensor, Q4Tensor)) or w.dim() < 3:
            return quantize_weight_bits(w, b)
        # Eligibility is the whole stack's (an expert stack's four axes keep
        # it int8), decided before the per-layer slices.
        b = b if int4_eligible_shape(w.dim(), w.shape[-2], w.shape[-1]) else 8
        parts = [quantize_weight_bits(w[i], b) for i in range(w.shape[0])]
        if isinstance(parts[0], Q4Tensor):
            return Q4Tensor(torch.stack([p.q for p in parts]), torch.stack([p.scale for p in parts]))
        return QTensor(torch.stack([p.q for p in parts]), torch.stack([p.scale for p in parts]))

    def key_bits(key):
        return 8 if key in int8_keys else bits

    layers = dict(params["layers"])
    for key in QUANT_LAYER_KEYS:
        layers[key] = quant(layers[key], key_bits(key))
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = quant(params["lm_head"], key_bits("lm_head"))
    return out


def init_params_quantized(
    config, generator: torch.Generator, device, dtype=None, bits: int = 8, shard=None,
    int8_keys=frozenset(),
) -> Dict[str, Any]:
    """Random quantized parameters, built directly (the bf16 tree is never
    made): int8 payloads drawn uniformly in [-127, 127], int4 packed bytes
    uniformly in [-128, 127] (two uniform nibbles in [-8, 7]), with constant
    scales chosen so the effective weights have ~N(0, 1/fan_in) magnitude —
    the JAX package's ``init_params_quantized(dist="random")`` shapes, dtypes
    and scales; the draws come from ``generator`` and differ. ``shard`` as
    in ``llama.init_params``; the weights named in ``int8_keys`` stay int8."""
    from .llama import check_supported

    check_supported(config)
    S = shard or (lambda key, leaf: leaf)
    dtype = dtype or config.torch_dtype
    device = torch.device(device)
    H, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    L, Q, KV = config.num_layers, config.q_dim, config.kv_dim

    def qinit(key, shape) -> WeightLike:
        K, N = shape[-2], shape[-1]
        if bits == 4 and key not in int8_keys and int4_eligible_shape(len(shape), K, N):
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

    embed = S("embed", normal((V, H), 1.0 / math.sqrt(H)))
    layers: Dict[str, Any] = {
        "attn_norm": S("attn_norm", norm((L, H))),
        "wq": S("wq", qinit("wq", (L, H, Q))),
        "wk": S("wk", qinit("wk", (L, H, KV))),
        "wv": S("wv", qinit("wv", (L, H, KV))),
        "wo": S("wo", qinit("wo", (L, Q, H))),
        "mlp_norm": S("mlp_norm", norm((L, H))),
    }
    if config.num_experts > 0:  # the router drawn plain, the experts int8
        E = config.num_experts
        layers["w_router"] = S("w_router", normal((L, H, E), 1.0 / math.sqrt(H)))
        layers["w_gate"] = S("w_gate", qinit("w_gate", (L, E, H, I)))
        layers["w_up"] = S("w_up", qinit("w_up", (L, E, H, I)))
        layers["w_down"] = S("w_down", qinit("w_down", (L, E, I, H)))
    else:
        layers["w_gate"] = S("w_gate", qinit("w_gate", (L, H, I)))
        layers["w_up"] = S("w_up", qinit("w_up", (L, H, I)))
        layers["w_down"] = S("w_down", qinit("w_down", (L, I, H)))
    if config.qkv_bias:
        layers["bq"] = S("bq", torch.zeros((L, Q), dtype=dtype, device=device))
        layers["bk"] = S("bk", torch.zeros((L, KV), dtype=dtype, device=device))
        layers["bv"] = S("bv", torch.zeros((L, KV), dtype=dtype, device=device))
    if config.post_block_norms:
        layers["post_attn_norm"] = S("post_attn_norm", norm((L, H)))
        layers["post_mlp_norm"] = S("post_mlp_norm", norm((L, H)))
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": S("final_norm", norm((H,))),
        "lm_head": S("lm_head", qinit("lm_head", (H, V))),
    }
