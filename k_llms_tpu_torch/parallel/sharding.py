"""Partition specs for the Llama parameter and cache trees, and the cut of
a full tree into one rank's shard.

Counterpart of ``k_llms_tpu/parallel/sharding.py``: Megatron-style tensor
parallelism, column-parallel in-projections (wq/wk/wv/w_gate/w_up and the
QKV biases sharded on the output feature axis), row-parallel
out-projections (wo/w_down sharded on the input feature axis, each followed
by one ``psum`` over ``model``), a vocabulary-sharded embedding and head,
norms replicated; Mixtral's experts shard over ``model``. KV caches shard
kv heads over ``model`` and their batch rows over ``data`` (the engine's
coalesced bodies; the shared prefix stays replicated over ``data``).

A spec is a tuple with one entry per axis of the leaf: an axis name or
None, as a JAX ``PartitionSpec``. :func:`shard_params` is the weight
carrier for the mesh: every rank cuts its shard out of the same full tree
(numpy or torch leaves, quantized ones too), following the leaves it
actually holds, as the JAX engine's ``align_quantized_specs`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


class P(tuple):
    """A partition spec: ``P(None, MODEL_AXIS)`` shards axis 1 over model."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def param_specs(config) -> Dict[str, Any]:
    """Tree of specs matching ``models.llama.init_params``."""
    layers = {
        "attn_norm": P(None, None),
        "wq": P(None, None, MODEL_AXIS),
        "wk": P(None, None, MODEL_AXIS),
        "wv": P(None, None, MODEL_AXIS),
        "wo": P(None, MODEL_AXIS, None),
        "mlp_norm": P(None, None),
        "w_gate": P(None, None, MODEL_AXIS),
        "w_up": P(None, None, MODEL_AXIS),
        "w_down": P(None, MODEL_AXIS, None),
    }
    if config.num_experts > 0:
        # Expert parallelism: the expert axis of [L, E, H, I] weights shards
        # over "model"; each rank computes its experts and a psum combines
        # them. The router replicates.
        layers["w_router"] = P(None, None, None)
        layers["w_gate"] = P(None, MODEL_AXIS, None, None)
        layers["w_up"] = P(None, MODEL_AXIS, None, None)
        layers["w_down"] = P(None, MODEL_AXIS, None, None)
    if config.qkv_bias:
        layers["bq"] = P(None, MODEL_AXIS)
        layers["bk"] = P(None, MODEL_AXIS)
        layers["bv"] = P(None, MODEL_AXIS)
    if config.post_block_norms:
        layers["post_attn_norm"] = P(None, None)
        layers["post_mlp_norm"] = P(None, None)
    return {
        "embed": P(MODEL_AXIS, None),  # vocab-sharded
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(None, MODEL_AXIS),
    }


def cache_specs(shared_prefix: bool = False) -> P:
    """KV cache [L, B, S, KVH, D]: samples over data, kv heads over model.
    The shared prefix has batch 1, so only heads shard."""
    if shared_prefix:
        return P(None, None, None, MODEL_AXIS, None)
    return P(None, DATA_AXIS, None, MODEL_AXIS, None)


def batch_spec() -> P:
    """Per-sample vectors (tokens, logprobs, done flags): sharded over data."""
    return P(DATA_AXIS)


def scale_spec(spec: P) -> P:
    """An int8 scale's spec: the weight's, but its contraction axis has size
    1 (the keepdims reduce) and does not shard."""
    parts = list(spec)
    if len(parts) >= 2:
        parts[-2] = None
    return P(*parts)


def shard_leaf(x, spec: P, mesh: Mesh):
    """This rank's block of ``x`` under ``spec``: each axis named in the spec
    is cut into that mesh axis's size and the rank's coordinate picks the
    block. A torch result is a contiguous copy on ``x``'s device (the full
    leaf is not kept alive); a numpy one a copy. A spec that cuts nothing
    on this mesh (every named axis of size 1) returns ``x`` itself."""
    if all(axis is None or mesh.axis_size(axis) == 1 for axis in spec):
        return x
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = mesh.axis_size(axis)
        size = x.shape[dim]
        if size % n:
            raise ValueError(
                f"axis {dim} of a {tuple(x.shape)} leaf does not divide over {axis}={n}"
            )
        block = size // n
        i = mesh.axis_index(axis)
        index.append(slice(i * block, (i + 1) * block))
    out = x[tuple(index)]
    if isinstance(out, torch.Tensor):
        return out.contiguous().clone()
    return np.array(out, copy=True)


def shard_node(w, spec: P, mesh: Mesh):
    """This rank's shard of one leaf under its weight's spec: a quantized
    leaf cuts its payload and scales together."""
    kind = type(w).__name__
    if kind == "Q4Tensor":
        # Packed payload [.., K/2, N] and group scales [.., K/GROUP, N] keep
        # the weight's spec: a quantization group never splits ranks while
        # K % (GROUP * TP) == 0 (quant.int4_mesh_compatible).
        return type(w)(shard_leaf(w.q, spec, mesh), shard_leaf(w.scale, spec, mesh))
    if kind == "QTensor":
        return type(w)(shard_leaf(w.q, spec, mesh), shard_leaf(w.scale, scale_spec(spec), mesh))
    return shard_leaf(w, spec, mesh)


def shard_params(tree: Dict[str, Any], mesh: Mesh, config=None,
                 specs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Cut a full parameter tree into this rank's shard under
    :func:`param_specs` (or ``specs``). The result carries the mesh under
    ``"mesh"``: the model functions of ``models/llama.py`` read it to place
    their collectives. A trivial mesh, or a model axis of 1, cuts nothing."""
    if specs is None:
        if config is None:
            raise ValueError("shard_params needs the config or the spec tree")
        specs = param_specs(config)
    layers = {
        key: shard_node(w, specs["layers"][key], mesh)
        for key, w in tree["layers"].items()
    }
    out = {
        "embed": shard_node(tree["embed"], specs["embed"], mesh),
        "layers": layers,
        "final_norm": shard_node(tree["final_norm"], specs["final_norm"], mesh),
        "lm_head": shard_node(tree["lm_head"], specs["lm_head"], mesh),
        "mesh": mesh,
    }
    return out
