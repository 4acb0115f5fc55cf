"""Model architecture configs: the JAX package's registry with torch dtypes.

Every registered config is carried over field for field (the CPU tests hold
the two registries equal). Llama-3-8B is the flagship: its bf16 weights
(~16 GB) fit one H100's 80 GB, so the port serves it on one card. ``tiny``
keeps the CPU tests fast.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 500000.0
    # Llama-3.1/3.2-style frequency-dependent RoPE scaling:
    # (factor, low_freq_factor, high_freq_factor, original_max_position).
    # None = vanilla RoPE. Long wavelengths (past original_max/low_freq)
    # divide by factor, short ones keep, the band between interpolates —
    # matching HF's rope_type="llama3".
    rope_scaling: "tuple[float, float, float, int] | None" = None
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    # Prefill attention implementation: "xla" (the plain einsum path, runs
    # anywhere) or "flash" (ops/attention.py::flash_attention — the CUDA
    # kernel on a card, its plain version on the CPU).
    attention_impl: str = "xla"
    # Decode-step attention of the dense path: "xla" (default) or "flash"
    # (the shared-prefix decode kernel, not ported yet: the port decodes
    # through the paged path and raises for "flash" here).
    decode_attention_impl: str = "xla"
    # Architecture variants beyond Llama:
    # - qkv_bias: additive bias on q/k/v projections (Qwen2 family).
    # - sliding_window: each query attends only to the last W keys
    #   (Mistral family); None = full causal.
    # - sliding_window_layers: "all" (every layer windowed — Mistral) or
    #   "alternating" (even layers windowed, odd layers global — Gemma-2).
    qkv_bias: bool = False
    sliding_window: "int | None" = None
    sliding_window_layers: str = "all"
    # Gemma-family variants:
    # - act: MLP gate activation, "silu" (Llama) or "gelu" (GeGLU).
    # - norm_offset: RMSNorm scales by (1 + w) instead of w.
    # - embed_scale: multiply token embeddings by sqrt(hidden_size).
    # - post_block_norms: Gemma-2 extra norms on the attention and MLP outputs
    #   (before each residual add).
    # - attn_softcap / logit_softcap: cap*tanh(x/cap) on attention scores /
    #   final logits.
    # - query_scale: attention score scale; None = 1/sqrt(head_dim).
    act: str = "silu"
    norm_offset: bool = False
    embed_scale: bool = False
    post_block_norms: bool = False
    attn_softcap: "float | None" = None
    logit_softcap: "float | None" = None
    query_scale: "float | None" = None
    # Mixture-of-experts (Mixtral family): every MLP becomes num_experts
    # experts with top-k token-choice routing. 0 = dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # byte tokenizer vocab fits any vocab_size >= 260; HF tokenizers use the full space
    bos_token_id: int = 256
    eos_token_id: int = 257
    pad_token_id: int = 258

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


_REGISTRY: Dict[str, ModelConfig] = {}


def register_config(config: ModelConfig) -> ModelConfig:
    _REGISTRY[config.name] = config
    return config


def get_config(name: str) -> ModelConfig:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


register_config(
    ModelConfig(
        name="llama-3-8b",
        attention_impl="flash",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        max_seq_len=8192,
    )
)

register_config(
    ModelConfig(
        name="llama-3.2-1b",
        attention_impl="flash",
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        rope_theta=500000.0,
        # Llama-3.2 checkpoints ship rope_type="llama3" with factor 32.
        rope_scaling=(32.0, 1.0, 4.0, 8192),
        max_seq_len=8192,
    )
)

# Bench-scale model with a byte-level vocab: all FLOPs in the transformer
# stack, negligible embedding table.
register_config(
    ModelConfig(
        name="llama-1b-byte",
        attention_impl="flash",
        vocab_size=512,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=4096,
    )
)

# Gemma-2 family: GeGLU, (1+w) RMSNorm, post-block norms, sqrt(H) embedding
# scale, attention + final-logit softcaps, alternating local/global attention,
# tied embeddings, big head_dim with a fixed query scale.
register_config(
    ModelConfig(
        name="gemma-2-2b",
        vocab_size=256000,  # HF gemma-2 safetensors layout (not the 256128 padded Flax release)
        hidden_size=2304,
        intermediate_size=9216,
        num_layers=26,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        rope_theta=10000.0,
        rms_eps=1e-6,
        max_seq_len=8192,
        sliding_window=4096,
        sliding_window_layers="alternating",
        act="gelu",
        norm_offset=True,
        embed_scale=True,
        post_block_norms=True,
        attn_softcap=50.0,
        logit_softcap=30.0,
        query_scale=256.0**-0.5,  # query_pre_attn_scalar=256
        bos_token_id=2,
        eos_token_id=1,
        pad_token_id=0,
    )
)

register_config(
    ModelConfig(
        name="gemma-2-9b",
        vocab_size=256000,  # HF gemma-2 safetensors layout (not the 256128 padded Flax release)
        hidden_size=3584,
        intermediate_size=14336,
        num_layers=42,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        rope_theta=10000.0,
        rms_eps=1e-6,
        max_seq_len=8192,
        sliding_window=4096,
        sliding_window_layers="alternating",
        act="gelu",
        norm_offset=True,
        embed_scale=True,
        post_block_norms=True,
        attn_softcap=50.0,
        logit_softcap=30.0,
        query_scale=256.0**-0.5,
        bos_token_id=2,
        eos_token_id=1,
        pad_token_id=0,
    )
)

# Qwen2 family: Llama architecture + QKV biases, 1e6 rope theta.
register_config(
    ModelConfig(
        name="qwen2-7b",
        attention_impl="flash",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        max_seq_len=8192,
        qkv_bias=True,
        bos_token_id=151643,
        eos_token_id=151645,
        pad_token_id=151643,
    )
)

register_config(
    ModelConfig(
        name="qwen2.5-0.5b",
        attention_impl="flash",
        vocab_size=151936,
        hidden_size=896,
        intermediate_size=4864,
        num_layers=24,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        max_seq_len=8192,
        qkv_bias=True,
        bos_token_id=151643,
        eos_token_id=151645,
        pad_token_id=151643,
    )
)

# Mixtral family: Mistral attention + 8-expert top-2 MoE MLPs.
register_config(
    ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1000000.0,
        rms_eps=1e-5,
        max_seq_len=8192,
        num_experts=8,
        num_experts_per_tok=2,
        bos_token_id=1,
        eos_token_id=2,
        pad_token_id=2,
    )
)

# Mistral family: Llama architecture + sliding-window attention.
register_config(
    ModelConfig(
        name="mistral-7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
        rms_eps=1e-5,
        max_seq_len=8192,
        sliding_window=4096,
        bos_token_id=1,
        eos_token_id=2,
        pad_token_id=2,
    )
)

register_config(
    ModelConfig(
        name="tiny",
        vocab_size=512,
        hidden_size=64,
        intermediate_size=160,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=4096,
        dtype="float32",
    )
)
