"""The port's checkpoint loader (``k_llms_tpu_torch/models/loader.py``)
against the JAX package's (``k_llms_tpu/models/loader.py``): HF safetensors
trees leaf for leaf on every branch (Llama, Qwen2 biases, tied lm_head,
Gemma-2 norm names, Mixtral experts), ``config_from_hf`` field for field,
``param_summary`` (checksum, bytes, dtype histogram) on the same weights,
the native save/load round trip, and a corrupt checkpoint refused with
``CheckpointCorruptError`` and counted.

The HF directories are written with the ``safetensors`` package in F32 and
F16 (the JAX loader reads them through numpy, which has no bfloat16); the
port's own BF16 path is held in ``tests/test_torch_safetensors_io.py`` and,
at 8B, on the card by ``chip_smoke.py``."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import loader as jax_loader
from k_llms_tpu_torch.models import loader
from k_llms_tpu_torch.models.config import get_config
from k_llms_tpu_torch.models.llama import params_from_numpy
from k_llms_tpu_torch.models.quant import QTensor, quantize_params
from k_llms_tpu_torch.ops.w4matmul import Q4Tensor
from k_llms_tpu_torch.types.wire import CheckpointCorruptError
from k_llms_tpu_torch.utils.observability import QUARANTINE_EVENTS

_HF_MATS = {
    "wq": ("self_attn.q_proj", "q_dim", "hidden_size"),
    "wk": ("self_attn.k_proj", "kv_dim", "hidden_size"),
    "wv": ("self_attn.v_proj", "kv_dim", "hidden_size"),
    "wo": ("self_attn.o_proj", "hidden_size", "q_dim"),
}


def _hf_tensors(cfg, seed, *, tied=False, f16=False):
    """A random HF-layout tensor dict for ``cfg`` ([out, in] matrices)."""
    rng = np.random.default_rng(seed)
    dt = np.float16 if f16 else np.float32

    def r(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(dt)

    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    dims = {"hidden_size": H, "q_dim": cfg.num_heads * cfg.head_dim,
            "kv_dim": cfg.num_kv_heads * cfg.head_dim}
    t = {"model.embed_tokens.weight": r(V, H), "model.norm.weight": r(H)}
    if not tied:
        t["lm_head.weight"] = r(V, H)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for hf, out_d, in_d in _HF_MATS.values():
            t[pre + hf + ".weight"] = r(dims[out_d], dims[in_d])
        t[pre + "input_layernorm.weight"] = r(H)
        t[pre + "post_attention_layernorm.weight"] = r(H)
        if cfg.post_block_norms:
            t[pre + "pre_feedforward_layernorm.weight"] = r(H)
            t[pre + "post_feedforward_layernorm.weight"] = r(H)
        if cfg.num_experts:
            t[pre + "block_sparse_moe.gate.weight"] = r(cfg.num_experts, H)
            for e in range(cfg.num_experts):
                for w, (o, n) in (("w1", (I, H)), ("w3", (I, H)), ("w2", (H, I))):
                    t[pre + f"block_sparse_moe.experts.{e}.{w}.weight"] = r(o, n)
        else:
            t[pre + "mlp.gate_proj.weight"] = r(I, H)
            t[pre + "mlp.up_proj.weight"] = r(I, H)
            t[pre + "mlp.down_proj.weight"] = r(H, I)
        if cfg.qkv_bias:
            t[pre + "self_attn.q_proj.bias"] = r(dims["q_dim"])
            t[pre + "self_attn.k_proj.bias"] = r(dims["kv_dim"])
            t[pre + "self_attn.v_proj.bias"] = r(dims["kv_dim"])
    return t


def _write_hf(directory, tensors, shards=2):
    """Shard the tensors over ``shards`` files, as a real checkpoint is."""
    from safetensors.numpy import save_file

    os.makedirs(directory, exist_ok=True)
    keys = sorted(tensors)
    for s in range(shards):
        part = {k: tensors[k] for k in keys[s::shards]}
        save_file(part, os.path.join(directory, f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    return str(directory)


def _np(leaf):
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _port_np(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _assert_trees_equal(port_tree, jax_tree):
    """Same keys, shapes, dtypes and bytes, leaf for leaf."""
    assert isinstance(port_tree, dict) == isinstance(jax_tree, dict)
    if isinstance(port_tree, dict):
        assert sorted(port_tree) == sorted(jax_tree)
        for k in port_tree:
            _assert_trees_equal(port_tree[k], jax_tree[k])
        return
    want = _np(jax_tree)
    got = _port_np(port_tree)
    assert got.shape == want.shape
    assert str(port_tree.dtype).replace("torch.", "") == np.asarray(jax_tree).dtype.name
    np.testing.assert_array_equal(got, want)


# (name, ModelConfig overrides of tiny, HF file options)
BRANCHES = [
    ("llama", {}, {}),
    ("llama_f16_file", {}, {"f16": True}),
    ("qwen2_bias", {"qkv_bias": True}, {}),
    ("tied_lm_head", {}, {"tied": True}),
    ("gemma2_norm_names", {"post_block_norms": True, "norm_offset": True, "act": "gelu"}, {}),
    ("mixtral_experts", {"num_experts": 2, "num_experts_per_tok": 2}, {}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,overrides,opts", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_load_safetensors_tree_equals_jax(tmp_path, name, overrides, opts, dtype):
    jcfg = jax_get_config("tiny").with_(dtype=dtype, **overrides)
    pcfg = get_config("tiny").with_(dtype=dtype, **overrides)
    d = _write_hf(tmp_path / name, _hf_tensors(jcfg, 3, **opts))
    want = jax_loader.load_safetensors(d, jcfg)
    got = loader.load_safetensors(d, pcfg)
    _assert_trees_equal(got, jax.device_get(want))
    # Every stacked leaf was allocated once, contiguous, in the config dtype.
    for leaf in list(got["layers"].values()) + [got["lm_head"], got["embed"]]:
        assert leaf.is_contiguous() and leaf.dtype == pcfg.torch_dtype


def test_load_safetensors_names_a_missing_tensor(tmp_path):
    cfg = get_config("tiny")
    t = _hf_tensors(cfg, 4)
    del t["model.layers.1.mlp.up_proj.weight"]
    d = _write_hf(tmp_path / "missing", t)
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        loader.load_safetensors(d, cfg)


HF_CONFIGS = {
    "llama3": {
        "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
        "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 8192, "bos_token_id": 128000, "eos_token_id": 128001,
    },
    "llama3_1": {
        "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
        "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 131072, "bos_token_id": 128000, "eos_token_id": 128009,
        "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    },
    "qwen2": {
        "model_type": "qwen2", "vocab_size": 151936, "hidden_size": 1536,
        "intermediate_size": 8960, "num_hidden_layers": 28, "num_attention_heads": 12,
        "num_key_value_heads": 2, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 32768, "sliding_window": 32768,
        "use_sliding_window": False, "bos_token_id": 151643, "eos_token_id": 151645,
    },
    "gemma2": {
        "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 2304,
        "intermediate_size": 9216, "num_hidden_layers": 26, "num_attention_heads": 8,
        "num_key_value_heads": 4, "head_dim": 256, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 8192, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "query_pre_attn_scalar": 256, "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
    },
    "mistral": {
        "model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
        "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 32768, "sliding_window": 4096, "bos_token_id": 1,
        "eos_token_id": 2,
    },
    "mixtral": {
        "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
        "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 32768, "sliding_window": None, "num_local_experts": 8,
        "num_experts_per_tok": 2, "bos_token_id": 1, "eos_token_id": 2,
    },
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_equals_jax(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    got = loader.config_from_hf(str(d))
    want = jax_loader.config_from_hf(str(d))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert loader.config_from_hf(str(tmp_path / "nope")) is None


def test_unknown_rope_type_raises(tmp_path):
    d = tmp_path / "yarn"
    d.mkdir()
    cfg = dict(HF_CONFIGS["llama3"], rope_scaling={"rope_type": "yarn", "factor": 4.0})
    (d / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="yarn"):
        loader.config_from_hf(str(d))
    with pytest.raises(ValueError, match="yarn"):
        jax_loader.config_from_hf(str(d))


def _eligible(mod_get_config):
    """An int4-eligible small config (every matmul K % 256 == 0)."""
    return mod_get_config("tiny").with_(hidden_size=256, intermediate_size=512, num_heads=4,
                                        num_kv_heads=2, head_dim=64, vocab_size=384)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_param_summary_equals_jax(bits):
    """Checksum, bytes, leaf count and dtype histogram equal the JAX
    function's on the same weights: a bf16 tree, and int8 and int4 trees
    quantized by the JAX package and carried over. The quantized nodes'
    path strings are the JAX package's pytree paths (``.q``/``.scale`` of
    the int8 NamedTuple, ``[<flat index 0>]``/``[<flat index 1>]`` of the
    int4 pytree class), so the checksums can agree."""
    from k_llms_tpu.models import init_params as jax_init
    from k_llms_tpu.models.quant import quantize_params as jax_quantize

    jcfg = _eligible(jax_get_config).with_(dtype="bfloat16")
    pcfg = _eligible(get_config).with_(dtype="bfloat16")
    tree = jax_init(jcfg, jax.random.key(5))
    if bits:
        tree = jax_quantize(tree, bits=bits)
    host = jax.device_get(tree)
    want = jax_loader.param_summary(host)
    got = loader.param_summary(params_from_numpy(host, pcfg))
    assert got == want
    assert got["num_leaves"] == {None: 12, 8: 20, 4: 20}[bits]


@pytest.mark.parametrize("chunk_bytes", [2, 4096, 3 * 1000 + 1])
def test_param_summary_over_many_chunks_equals_jax(monkeypatch, chunk_bytes):
    """Leaves split into many chunks (checksummed in parallel, their
    crc32s combined in order), the last one short: the same summary as the
    JAX function's one pass."""
    from k_llms_tpu.models import init_params as jax_init

    jcfg = _eligible(jax_get_config).with_(dtype="bfloat16")
    pcfg = _eligible(get_config).with_(dtype="bfloat16")
    host = jax.device_get(jax_init(jcfg, jax.random.key(6)))
    monkeypatch.setattr(loader, "_CHUNK_BYTES", chunk_bytes)
    params = params_from_numpy(host, pcfg)
    if chunk_bytes == 2:  # a chunk of one bf16 element: the final norm alone
        params = {"final_norm": params["final_norm"]}
        host = {"final_norm": host["final_norm"]}
    assert loader.param_summary(params) == jax_loader.param_summary(host)


def test_param_summary_of_a_loaded_checkpoint_equals_jax(tmp_path):
    cfg_j = jax_get_config("tiny").with_(dtype="bfloat16", qkv_bias=True)
    cfg_p = get_config("tiny").with_(dtype="bfloat16", qkv_bias=True)
    d = _write_hf(tmp_path / "hf", _hf_tensors(cfg_j, 6))
    want = jax_loader.load_checkpoint(d, cfg_j)
    got = loader.load_checkpoint(d, cfg_p)
    assert loader.last_load_summary == jax_loader.last_load_summary
    assert loader.param_summary(got) == jax_loader.param_summary(jax.device_get(want))


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_native_round_trip(tmp_path, bits):
    """save_checkpoint then load_checkpoint gives the same tree (quantized
    nodes rebuilt from their fmt leaf), and the manifest sibling verifies."""
    cfg = _eligible(get_config).with_(dtype="bfloat16")
    gen = torch.Generator().manual_seed(7)
    from k_llms_tpu_torch.models.llama import init_params

    params = init_params(cfg, gen, "cpu")
    if bits:
        params = quantize_params(params, bits=bits)
    path = str(tmp_path / "ckpt")
    loader.save_checkpoint(path, params)
    assert os.path.exists(path + ".params.json")
    restored = loader.load_checkpoint(path, cfg)
    kind = {None: torch.Tensor, 8: QTensor, 4: Q4Tensor}[bits]
    assert isinstance(restored["layers"]["wq"], kind)
    assert isinstance(restored["lm_head"], kind)
    assert loader.param_summary(restored) == loader.param_summary(params)
    assert loader.last_load_summary == loader.param_summary(params)

    def flat(t):
        return [leaf for _, leaf in loader._tree_leaves(t)]

    for a, b in zip(flat(restored), flat(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_nan_leaf_is_refused_and_counted(tmp_path):
    cfg = get_config("tiny")
    t = _hf_tensors(cfg, 8)
    t["model.layers.1.self_attn.v_proj.weight"][3, 5] = np.nan
    d = _write_hf(tmp_path / "nan", t)
    before = QUARANTINE_EVENTS.snapshot().get("quarantine.checksum_failures", 0)
    with pytest.raises(CheckpointCorruptError, match=r"\['layers'\]\['wv'\]"):
        loader.load_checkpoint(d, cfg)
    assert QUARANTINE_EVENTS.snapshot()["quarantine.checksum_failures"] == before + 1


def test_manifest_mismatch_is_refused_and_counted(tmp_path):
    cfg = get_config("tiny")
    from k_llms_tpu_torch.models.llama import init_params

    params = init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    path = str(tmp_path / "ckpt")
    loader.save_checkpoint(path, params)
    manifest = json.loads(open(path + ".params.json").read())
    assert manifest == loader.param_summary(params)
    manifest["checksum"] = "00000000"
    open(path + ".params.json", "w").write(json.dumps(manifest))
    before = QUARANTINE_EVENTS.snapshot().get("quarantine.checksum_failures", 0)
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        loader.load_checkpoint(path, cfg)
    assert QUARANTINE_EVENTS.snapshot()["quarantine.checksum_failures"] == before + 1
