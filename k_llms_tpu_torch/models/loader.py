"""Checkpoint I/O: the port's native save/load and the HF safetensors import.

Counterpart of ``k_llms_tpu/models/loader.py``. Both formats are read and
written by ``models/safetensors_io.py`` (numpy and torch only; the
``safetensors`` package is not needed):

- **native**: the flattened parameter tree in one ``params.safetensors``
  file, marked by its ``__metadata__`` (the JAX package writes orbax here).
  Quantized nodes are stored as ``{q, scale, fmt}`` with the explicit
  ``fmt`` leaf of the JAX package (4 = group-wise int4, 8 = per-channel
  int8), and restore dispatches on it.
- **safetensors**: import path for Hugging Face checkpoints
  (``model*.safetensors`` + ``config.json``), remapped into the stacked-layer
  layout.

The import streams: each leaf is allocated once on the target device, then
the shards are mapped one at a time and layer i's matrix is copied from the
mapping into slot i (transposed there on the device), so the host holds one
mapped shard and about one matrix, and the device the final tree plus one
matrix. The JAX loader holds every tensor, then every stacked copy, on the
host.

Every load verifies the weights (finite floats, scanned on the device leaf
by leaf, and the checksum of a save-time manifest when one exists) and
raises :class:`CheckpointCorruptError` rather than serve corrupt ones. The
``loader.params`` failpoint (action ``corrupt``) writes NaN into the first
float leaf after the load, so that verification must trip.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.w4matmul import Q4Tensor
from ..reliability import failpoints as _failpoints
from ..types.wire import CheckpointCorruptError
from ..utils.observability import QUARANTINE_EVENTS
from .config import ModelConfig
from .quant import QTensor
from .safetensors_io import SafetensorsFile, save_file

logger = logging.getLogger(__name__)

#: The ``__metadata__`` that marks a native checkpoint file.
NATIVE_METADATA = {"format": "k_llms_tpu_torch.params"}
NATIVE_FILE = "params.safetensors"
# Host bytes one step of the checksum moves off the device.
_CHUNK_BYTES = 1 << 26
# Threads that copy chunks to the host and checksum them (both release the
# GIL); at most this many chunks are on the host at once.
_CHECKSUM_WORKERS = min(8, os.cpu_count() or 1)


def _tree_leaves(tree: Any, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every leaf, in the JAX package's pytree order and
    with its ``keystr`` paths: dict keys sorted as ``['key']``, an int8
    ``QTensor`` (a NamedTuple there) as ``.q``/``.scale``, an int4
    ``Q4Tensor`` (a registered pytree class there) as ``[<flat index 0>]``
    and ``[<flat index 1>]``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _tree_leaves(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, QTensor):
        return [(f"{path}.q", tree.q), (f"{path}.scale", tree.scale)]
    if isinstance(tree, Q4Tensor):
        return [(f"{path}[<flat index 0>]", tree.q), (f"{path}[<flat index 1>]", tree.scale)]
    return [(path, tree)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _chunk_ranges(t: torch.Tensor) -> List[Tuple[int, int]]:
    """[lo, hi) element ranges of the flattened tensor, each at most
    ``_CHUNK_BYTES``, in row-major order."""
    step = max(1, _CHUNK_BYTES // t.element_size())
    n = t.numel()
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _chunk_crc(flat: torch.Tensor, lo: int, hi: int, local: threading.local) -> int:
    """crc32 (from 0) of elements [lo, hi) of ``flat``; a chunk on a card is
    copied into the calling thread's reused host buffer first."""
    part = flat[lo:hi].view(torch.uint8)
    if part.device.type != "cpu":
        buf = getattr(local, "buf", None)
        if buf is None or buf.numel() < part.numel():
            buf = local.buf = torch.empty(max(part.numel(), _CHUNK_BYTES), dtype=torch.uint8)
        part = buf[: part.numel()].copy_(part)
    return zlib.crc32(memoryview(part.numpy()))


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


@functools.lru_cache(maxsize=64)
def _zeros_operator(nbytes: int) -> Tuple[int, ...]:
    """The GF(2) matrix that advances a crc32 over ``nbytes`` zero bytes
    (zlib's ``crc32_combine``, with the operator kept for reuse)."""
    op = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    for _ in range(3):  # eight zero bits: one byte
        op = [_gf2_times(op, op[n]) for n in range(32)]
    out = None
    while nbytes:
        if nbytes & 1:
            out = op if out is None else [_gf2_times(op, out[n]) for n in range(32)]
        nbytes >>= 1
        if nbytes:
            op = [_gf2_times(op, op[n]) for n in range(32)]
    return tuple(out if out is not None else [1 << n for n in range(32)])


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A + B from crc32(A), crc32(B) and len(B)."""
    return _gf2_times(_zeros_operator(len2), crc1) ^ crc2


def param_summary(params: Any) -> Dict[str, Any]:
    """Operator-facing weight identity, the JAX package's: total bytes,
    dtype histogram (leaf counts) and a crc32 content checksum over each
    leaf's path string and bytes in pytree order. On the same weights it
    equals the JAX function's result. Leaves on a card are copied to the
    host a chunk at a time; the chunks are checksummed in parallel and their
    crc32s combined in order."""
    leaves = _tree_leaves(params)
    total = 0
    hist: Dict[str, int] = {}
    parts = []  # (leaf index, flat, lo, hi)
    for i, (_, leaf) in enumerate(leaves):
        total += leaf.numel() * leaf.element_size()
        key = _dtype_name(leaf)
        hist[key] = hist.get(key, 0) + 1
        flat = leaf.detach().contiguous().reshape(-1)
        parts += [(i, flat, lo, hi) for lo, hi in _chunk_ranges(flat)]
    local = threading.local()
    with ThreadPoolExecutor(max_workers=_CHECKSUM_WORKERS) as pool:
        crcs = list(pool.map(lambda p: _chunk_crc(*p[1:], local), parts))
    crc, k = 0, 0
    for i, (path, _) in enumerate(leaves):
        crc = zlib.crc32(path.encode(), crc)
        while k < len(parts) and parts[k][0] == i:
            _, flat, lo, hi = parts[k]
            crc = _crc32_combine(crc, crcs[k], (hi - lo) * flat.element_size())
            k += 1
    return {
        "total_bytes": total,
        "num_leaves": len(leaves),
        "dtype_histogram": hist,
        "checksum": f"{crc & 0xFFFFFFFF:08x}",
    }


def _manifest_path(path: str) -> str:
    # A sibling of the checkpoint directory, as in the JAX package.
    return os.path.abspath(path).rstrip("/") + ".params.json"


def _all_finite(t: torch.Tensor) -> bool:
    """Every element finite, scanned where the tensor lives in slices of
    at most 64 M elements (a bounded temporary)."""
    flat = t.detach().reshape(-1)
    step = 1 << 26
    return all(bool(torch.isfinite(flat[lo: lo + step]).all()) for lo in range(0, flat.numel(), step))


def verify_param_integrity(
    params: Any, manifest: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Fail-fast weight verification at load time: every float leaf must be
    fully finite, and a save-time manifest's checksum must match the
    recomputed one. Raises :class:`CheckpointCorruptError` and counts
    ``quarantine.checksum_failures`` on either failure. Returns the computed
    summary."""
    for path, leaf in _tree_leaves(params):
        if not leaf.is_floating_point() or leaf.numel() == 0:
            continue
        if not _all_finite(leaf):
            QUARANTINE_EVENTS.record("quarantine.checksum_failures")
            raise CheckpointCorruptError(
                f"checkpoint leaf {path} contains non-finite values; refusing to "
                "serve corrupted weights"
            )
    summary = param_summary(params)
    if manifest is not None and manifest.get("checksum") not in (None, summary["checksum"]):
        QUARANTINE_EVENTS.record("quarantine.checksum_failures")
        raise CheckpointCorruptError(
            f"checkpoint checksum mismatch: loaded {summary['checksum']}, "
            f"manifest records {manifest['checksum']}"
        )
    return summary


def _corrupt_params(params: Any) -> None:
    """``loader.params=corrupt`` failpoint: overwrite the leading values of
    the first float leaf with NaN in place, the bit-rot a corrupted
    checkpoint shows, so :func:`verify_param_integrity` must trip."""
    for _, leaf in _tree_leaves(params):
        if leaf.is_floating_point() and leaf.numel():
            leaf.view(-1)[:16] = float("nan")
            return


# -- native format -----------------------------------------------------------


def _to_checkpoint_tree(tree: Any) -> Any:
    """Quantized weight nodes as plain dicts with an explicit ``fmt`` leaf
    (4 = group-wise int4, 8 = per-channel int8), the JAX package's."""
    if isinstance(tree, Q4Tensor):
        return {"q": tree.q, "scale": tree.scale, "fmt": torch.tensor(4, dtype=torch.int32)}
    if isinstance(tree, QTensor):
        return {"q": tree.q, "scale": tree.scale, "fmt": torch.tensor(8, dtype=torch.int32)}
    if isinstance(tree, dict):
        return {k: _to_checkpoint_tree(v) for k, v in tree.items()}
    return tree


def _flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _rebuild_qtensors(tree: Any) -> Any:
    """Rebuild QTensor/Q4Tensor nodes from ``{q, scale, fmt}`` dicts."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale", "fmt"}:
            fmt = int(tree["fmt"])
            if fmt == 4:
                return Q4Tensor(tree["q"], tree["scale"])
            if fmt == 8:
                return QTensor(tree["q"], tree["scale"])
            raise ValueError(f"unknown quantized-weight fmt {fmt} in checkpoint")
        return {k: _rebuild_qtensors(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, params: Dict[str, Any]) -> None:
    """Write ``params`` (any device; quantized nodes included) as a native
    checkpoint directory, and its integrity manifest as a sibling file
    (best-effort, as in the JAX package: a read-only destination must not
    fail the save)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    save_file(_flatten(_to_checkpoint_tree(params)), os.path.join(path, NATIVE_FILE),
              metadata=NATIVE_METADATA)
    try:
        with open(_manifest_path(path), "w") as f:
            json.dump(param_summary(params), f)
    except OSError:
        logger.warning("could not write param manifest next to %s", path, exc_info=True)


def _is_native(path: str) -> bool:
    f = os.path.join(path, NATIVE_FILE)
    return os.path.exists(f) and SafetensorsFile(f).metadata == NATIVE_METADATA


def load_native(path: str, device="cpu") -> Dict[str, Any]:
    """A native checkpoint's tree on ``device``, in its stored dtypes."""
    f = SafetensorsFile(os.path.join(path, NATIVE_FILE))
    tree: Dict[str, Any] = {}
    for key in f.keys():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = f.get_tensor(key).to(device=device, copy=True)
    return _rebuild_qtensors(tree)


# -- HF safetensors import ---------------------------------------------------


def _hf_key(layer: int, name: str) -> str:
    return f"model.layers.{layer}.{name}.weight"


def load_safetensors(path: str, config: ModelConfig, dtype=None, device="cpu") -> Dict[str, Any]:
    """Import an HF checkpoint directory into the stacked-params layout on
    ``device`` (the JAX package's tree: the Llama, Qwen2 bias, tied
    embedding, Gemma-2 norm-name and Mixtral expert branches).

    HF stores per-layer [out, in] matrices; ours are [in, out] stacked on a
    leading layer axis. HF Llama applies rotary with the same split-half
    convention as ``rope_embed``, so q/k weights import without
    re-permutation. Every leaf is allocated once, from the shards' headers;
    then the shards are read one at a time, in file order, each source
    tensor going from the mapped file to the device, where it is transposed
    (and cast) into its slot, and each shard is unmapped before the next.
    """
    dtype = dtype or config.torch_dtype
    device = torch.device(device)
    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path!r}")
    readers = [SafetensorsFile(f) for f in files]
    shapes = {key: r.shape(key) for r in readers for key in r.keys()}
    # source key -> the (destination view, transpose) it fills
    targets: Dict[str, List[Tuple[torch.Tensor, bool]]] = {}

    def leaf(keys: List[List[str]], transpose: bool = True, squeeze: bool = False) -> torch.Tensor:
        """A leaf of ``len(keys)`` x ``len(keys[0])`` slots (one key per
        layer, or E per layer for a [L, E, ...] leaf), or one tensor
        (``squeeze``)."""
        for row in keys:
            for key in row:
                if key not in shapes:
                    raise KeyError(f"checkpoint {path!r} has no tensor {key!r}")
        shape = shapes[keys[0][0]]
        shape = tuple(shape[::-1] if transpose else shape)
        grid = () if squeeze else (len(keys),) + (() if len(keys[0]) == 1 else (len(keys[0]),))
        out = torch.empty(grid + shape, dtype=dtype, device=device)
        for i, row in enumerate(keys):
            for e, key in enumerate(row):
                view = out if squeeze else (out[i, e] if len(row) > 1 else out[i])
                targets.setdefault(key, []).append((view, transpose))
        return out

    L = config.num_layers

    def per_layer(name: str, transpose: bool = True) -> torch.Tensor:
        return leaf([[_hf_key(i, name)] for i in range(L)], transpose)

    # Gemma-2 checkpoints name the PRE-MLP norm "pre_feedforward_layernorm"
    # and reuse "post_attention_layernorm" for the post-norm on the
    # attention output; Llama-family checkpoints use
    # "post_attention_layernorm" as the pre-MLP norm.
    mlp_norm_key = (
        "pre_feedforward_layernorm" if config.post_block_norms else "post_attention_layernorm"
    )
    layers = {
        "attn_norm": per_layer("input_layernorm", transpose=False),
        "wq": per_layer("self_attn.q_proj"),
        "wk": per_layer("self_attn.k_proj"),
        "wv": per_layer("self_attn.v_proj"),
        "wo": per_layer("self_attn.o_proj"),
        "mlp_norm": per_layer(mlp_norm_key, transpose=False),
    }
    if config.num_experts > 0:
        # Mixtral: block_sparse_moe.gate = router [E, H]; experts.{e}.w1/w3/w2
        # are gate/up/down. Stacked experts within layers: [L, E, in, out].
        E = config.num_experts
        layers["w_router"] = leaf(
            [[f"model.layers.{i}.block_sparse_moe.gate.weight"] for i in range(L)]
        )
        for ours, hf in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            layers[ours] = leaf(
                [[f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight" for e in range(E)]
                 for i in range(L)]
            )
    else:
        layers["w_gate"] = per_layer("mlp.gate_proj")
        layers["w_up"] = per_layer("mlp.up_proj")
        layers["w_down"] = per_layer("mlp.down_proj")
    if config.post_block_norms:  # Gemma-2
        layers["post_attn_norm"] = per_layer("post_attention_layernorm", transpose=False)
        layers["post_mlp_norm"] = per_layer("post_feedforward_layernorm", transpose=False)
    if config.qkv_bias:  # Qwen2 family
        for ours, hf_name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            layers[ours] = leaf(
                [[f"model.layers.{i}.self_attn.{hf_name}.bias"] for i in range(L)], False
            )
    params = {
        "embed": leaf([["model.embed_tokens.weight"]], False, squeeze=True),
        "layers": layers,
        "final_norm": leaf([["model.norm.weight"]], False, squeeze=True),
        # Tied embeddings (llama-3.2-1b) fill lm_head from the embedding.
        "lm_head": leaf([["lm_head.weight" if "lm_head.weight" in shapes
                          else "model.embed_tokens.weight"]], True, squeeze=True),
    }
    for i in range(len(readers)):
        reader, readers[i] = readers[i], None
        for key in reader.keys():
            for view, transpose in targets.pop(key, ()):
                src = reader.get_tensor(key)
                if device.type != "cpu":
                    src = src.to(device)
                view.copy_(src.t() if transpose else src)
                del src
        del reader  # no view of the shard is left: this unmaps it
    return params


def load_checkpoint(path: str, config: ModelConfig, dtype=None, device="cpu") -> Dict[str, Any]:
    """Dispatch on content: a native checkpoint or an HF safetensors
    directory, loaded onto ``device``. Every load runs
    :func:`verify_param_integrity` (finite floats, and the manifest's
    checksum when one was written at save time) and records its summary in
    :data:`last_load_summary`."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory {path!r} does not exist")
    if _is_native(path):
        params = load_native(path, device)
    else:
        params = load_safetensors(path, config, dtype, device)
    fp = _failpoints.fire("loader.params")
    if fp is not None and fp.action == "corrupt":
        _corrupt_params(params)
    manifest = None
    if os.path.exists(_manifest_path(path)):
        with open(_manifest_path(path)) as f:
            manifest = json.load(f)
    global last_load_summary
    last_load_summary = verify_param_integrity(params, manifest)
    return params


#: Summary of the most recent successful load_checkpoint, for backends to
#: surface without re-hashing the whole tree.
last_load_summary: Optional[Dict[str, Any]] = None


def _rope_scaling_from_hf(rs: Optional[dict]):
    """HF rope_scaling dict -> our (factor, low, high, original_ctx) tuple.
    Only rope_type="llama3" (Llama-3.1/3.2) is modeled; other types raise so
    a checkpoint never silently runs with wrong frequencies."""
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind == "llama3":
        return (
            float(rs["factor"]),
            float(rs.get("low_freq_factor", 1.0)),
            float(rs.get("high_freq_factor", 4.0)),
            int(rs.get("original_max_position_embeddings", 8192)),
        )
    if kind in ("default", None):
        return None
    raise ValueError(f"unsupported rope_scaling type {kind!r}")


def config_from_hf(path: str) -> Optional[ModelConfig]:
    """Build a ModelConfig from an HF config.json, if present."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        hf = json.load(f)
    hidden = hf["hidden_size"]
    heads = hf["num_attention_heads"]
    model_type = hf.get("model_type", "llama")
    # Qwen2 ships a huge nominal sliding_window with use_sliding_window=false;
    # Mistral configs carry the real window (or null for v0.3+).
    sliding_window = hf.get("sliding_window")
    if model_type == "qwen2" and not hf.get("use_sliding_window", False):
        sliding_window = None
    gemma2 = model_type == "gemma2"
    query_scale = None
    if hf.get("query_pre_attn_scalar"):
        query_scale = float(hf["query_pre_attn_scalar"]) ** -0.5
    return ModelConfig(
        qkv_bias=model_type == "qwen2" or hf.get("attention_bias", False),
        sliding_window=sliding_window,
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        sliding_window_layers="alternating" if gemma2 else "all",
        act="gelu" if gemma2 else "silu",
        norm_offset=gemma2,
        embed_scale=gemma2,
        post_block_norms=gemma2,
        attn_softcap=hf.get("attn_logit_softcapping"),
        logit_softcap=hf.get("final_logit_softcapping"),
        query_scale=query_scale,
        name=os.path.basename(os.path.normpath(path)),
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim", hidden // heads),
        rope_theta=hf.get("rope_theta", 500000.0),
        rope_scaling=_rope_scaling_from_hf(hf.get("rope_scaling")),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=min(hf.get("max_position_embeddings", 8192), 8192),
        bos_token_id=hf.get("bos_token_id", 128000),
        eos_token_id=hf.get("eos_token_id", 128001),
        pad_token_id=hf.get("pad_token_id") or hf.get("eos_token_id", 128001),
    )
