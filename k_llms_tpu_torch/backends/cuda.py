"""CUDA backend: KLLMs(backend="cuda") — the local PyTorch engine.

Counterpart of ``k_llms_tpu/backends/tpu.py``: the chat template, stop
strings, per-sample logprobs and usage of ``chat_completion`` are carried
over; the request goes straight to ``LocalEngine.generate_many``. The model
overrides (dtype, max_seq_len, attention impls), weight quantization, the
KV-layout knobs, the prompt-prefix cache and checkpoint loading of the JAX
package's ``BackendConfig`` are carried over under the same names and
defaults: ``checkpoint_path`` loads a native or an HF safetensors checkpoint
(``models/loader.py``, integrity-verified; its summary is
``param_summary``), and a ``model`` name that is not registered takes its
config from the checkpoint's ``config.json``. So is grammar-constrained
decoding: a
``response_format`` compiles (once per schema and vocabulary, through the
process-wide grammar cache) into a token-mask automaton that the engine
applies inside decode, so every sample is valid by construction
(``constrained_decoding=True``, the default). The scheduler, supervisor,
continuous loop, streaming and the device consensus scorer are not ported
yet; a keyword that names one of the JAX package's other ``BackendConfig``
fields raises ``NotImplementedError`` rather than being dropped.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
from pydantic import BaseModel

from ..consensus.prompts import SYSTEM_PROMPT_STRING_CONSENSUS_LLM
from ..engine.engine import (
    MAX_STOP_LEN,
    MAX_STOP_SEQS,
    GenRequestSpec,
    LocalEngine,
    resolve_device,
)
from ..engine.tokenizer import get_tokenizer
from ..models import loader
from ..models.config import get_config
from ..types import ChatCompletion
from .base import Backend, ChatRequest

# Embedding inputs crop at the same token cap as the reference client.
MAX_EMBEDDING_TOKENS = 8191


def _visible_token_count(tok, ids: List[int], pos: int, text: str) -> int:
    """Shortest token prefix whose decode reproduces the visible text
    ``text[:pos]`` (``text`` = the full decode of ``ids``)."""
    visible = text[:pos]
    for k in range(len(ids) + 1):
        prefix = tok.decode(ids[:k])
        if len(prefix) >= pos and prefix[:pos] == visible:
            return k
    return len(ids)


class BackendConfig(BaseModel):
    """The part of the JAX package's BackendConfig this backend serves, with
    its names and defaults."""

    model: str = "tiny"
    # A native or HF safetensors checkpoint directory (models/loader.py);
    # None = seeded random weights (param_seed).
    checkpoint_path: Optional[str] = None
    tokenizer_path: Optional[str] = None
    max_new_tokens: int = 256
    param_seed: int = 0
    # Model-config overrides.
    dtype: Optional[str] = None  # e.g. "bfloat16" | "float32"
    max_seq_len: Optional[int] = None
    attention_impl: Optional[str] = None  # prefill: "xla" | "flash"
    decode_attention_impl: Optional[str] = None  # dense decode: "xla" | "flash"
    # Weight quantization: None (model dtype), "int8" (per-channel) or
    # "int4" (group-wise, the w4a16 kernel).
    quantization: Optional[str] = None
    # KV layout: paged (pool pages, block tables) or dense (a stacked shared
    # prefix plus per-row generated caches).
    paged_kv: bool = True
    kv_page_size: int = 64
    paged_attention_impl: str = "auto"  # "auto" | "cuda" (or "pallas") | "xla"
    paged_generate_many: bool = True
    # Prompt-prefix KV cache: keep the last N prompts' KV and reuse the
    # longest common token prefix (>= prefix_cache_min_reuse tokens) of a
    # new prompt, prefilling only its suffix. 0 disables.
    prefix_cache_size: int = 0
    prefix_cache_min_reuse: int = 32
    # Page pool size; None sizes it from the first paged launch (and, with a
    # prefix cache, from the cache's size).
    kv_pool_pages: Optional[int] = None
    # Compile response_format JSON schemas into token-level grammar masks
    # (engine/grammar.py) applied in-decode. Unsupported schema features
    # degrade to the generic JSON mask, compile errors to unconstrained
    # decode; parse()'s post-hoc validation stays authoritative either way.
    # False = decode unconstrained and validate after the fact.
    constrained_decoding: bool = True
    # Where the engine runs: None = the CUDA card (raises without one);
    # "cpu" runs the kernels' plain PyTorch versions.
    device: Optional[str] = None


#: Fields of the JAX package's BackendConfig that this backend has not
#: ported. A keyword naming one raises NotImplementedError.
UNPORTED_FIELDS = frozenset({
    "model_parallel", "sp_prefill_min_tokens", "sp_attention", "sp_decode", "speculative",
    "spec_lookahead", "batch_window", "max_queue_weight", "max_batch_rows", "hbm_bytes",
    "hbm_headroom", "drain_timeout", "sse_ping_interval_s", "debug_endpoints",
    "watchdog_base_s", "watchdog_per_token_s", "watchdog_multiplier",
    "watchdog_min_budget_s", "watchdog_max_budget_s", "max_rebuilds", "poison_threshold",
    "poison_window", "continuous_batching", "continuous_width", "continuous_max_prompt",
    "continuous_max_new", "prefill_chunk_tokens", "device_consensus",
    "tenant_default_weight", "tenant_default_slo",
    "tenant_default_requests_per_s", "tenant_default_rows_per_s", "tenants",
    "tenant_api_keys", "brownout_high_water", "batch_store_dir", "batch_max_in_flight",
    "batch_item_retries", "jobstore_ttl_s",
})

_MODEL_OVERRIDES = ("dtype", "max_seq_len", "attention_impl", "decode_attention_impl")


class CudaBackend(Backend):
    def __init__(
        self,
        model: Optional[str] = None,
        config: Optional[BackendConfig] = None,
        engine: Optional[LocalEngine] = None,
        **kwargs: Any,
    ):
        unported = sorted(UNPORTED_FIELDS.intersection(kwargs))
        if unported:
            raise NotImplementedError(
                f"BackendConfig field(s) {unported} of the JAX package are not ported "
                "to k_llms_tpu_torch yet"
            )
        unknown = sorted(set(kwargs) - set(BackendConfig.model_fields))
        if unknown:
            raise TypeError(f"CudaBackend got unknown keyword argument(s) {unknown}")
        if config is not None and model is not None and model != config.model:
            raise ValueError(
                f"model={model!r} conflicts with config.model={config.model!r}; "
                "pass one or make them agree"
            )
        cfg = config or BackendConfig(model=model or "tiny", **kwargs)
        self.backend_config = cfg
        self.model_name = cfg.model
        try:
            model_config = get_config(cfg.model)
        except KeyError:
            # Not a registered architecture name: a local HF checkpoint
            # directory carries its own config.json.
            model_config = (
                loader.config_from_hf(cfg.checkpoint_path) if cfg.checkpoint_path else None
            )
            if model_config is None:
                raise
        overrides = {k: getattr(cfg, k) for k in _MODEL_OVERRIDES if getattr(cfg, k) is not None}
        if overrides:
            model_config = model_config.with_(**overrides)
        if cfg.quantization not in (None, "int8", "int4"):
            raise ValueError(
                f"Unsupported quantization {cfg.quantization!r}; use 'int8' or 'int4'"
            )
        self.tokenizer = get_tokenizer(cfg.tokenizer_path)
        self.param_summary: Optional[Dict[str, Any]] = None
        self.engine = engine if engine is not None else self._build_engine(model_config)
        self.default_max_new_tokens = cfg.max_new_tokens

    def _build_engine(self, model_config) -> LocalEngine:
        """The engine, on weights from ``checkpoint_path`` (loaded onto the
        engine's device and integrity-verified: a corrupt checkpoint raises
        CheckpointCorruptError) or seeded from ``param_seed``."""
        cfg = self.backend_config
        params = None
        if cfg.checkpoint_path:
            params = loader.load_checkpoint(
                cfg.checkpoint_path, model_config, device=resolve_device(cfg.device)
            )
            self.param_summary = loader.last_load_summary
        return LocalEngine(
            model_config,
            params=params,
            param_seed=cfg.param_seed,
            device=cfg.device,
            quantize=cfg.quantization,
            # The port has no continuous loop, so paged_generate_many=False
            # leaves generate_many the dense body, as the JAX engine does.
            kv_layout="paged" if cfg.paged_kv and cfg.paged_generate_many else "dense",
            kv_page_size=cfg.kv_page_size,
            paged_attention_impl=cfg.paged_attention_impl,
            prefix_cache_size=cfg.prefix_cache_size,
            prefix_cache_min_reuse=cfg.prefix_cache_min_reuse,
            kv_pool_pages=cfg.kv_pool_pages,
        )

    # -- chat -------------------------------------------------------------
    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        tok = self.tokenizer
        prompt_ids = tok.apply_chat_template(request.messages, add_generation_prompt=True)
        n = max(1, request.n)
        temperature = 1.0 if request.temperature is None else float(request.temperature)
        max_new = request.max_tokens or self.default_max_new_tokens
        # Structured-output requests decode under a grammar mask: a pydantic
        # response_format compiles to a CompiledGrammar over this tokenizer's
        # byte strings; anything the schema compiler cannot express degrades
        # to the valid-JSON mask, and compile errors or
        # constrained_decoding=False to unconstrained decode.
        constraint = self._constraint_for(request.response_format)
        top_lp = request.top_logprobs if request.logprobs else None
        logit_bias = None
        if request.logit_bias:
            V = self.engine.config.vocab_size
            logit_bias = {}
            for tok_id, bias in request.logit_bias.items():
                t = int(tok_id)
                if not 0 <= t < V:
                    raise ValueError(f"logit_bias token id {t} outside vocab (0..{V-1})")
                logit_bias[t] = float(bias)
        stop_strings: List[str] = []
        if isinstance(request.stop, str):
            stop_strings = [request.stop]
        elif isinstance(request.stop, list):
            stop_strings = [s for s in request.stop if s]
        # Tokenized stops halt rows in the decode loop; the text scan below
        # stays authoritative for over-long stops and re-tokenization cases.
        stop_seqs = [
            ids_s
            for ids_s in (tok.encode(s) for s in stop_strings)
            if 0 < len(ids_s) <= MAX_STOP_LEN
        ][:MAX_STOP_SEQS] or None

        result = self.engine.generate_many(
            [GenRequestSpec(list(prompt_ids), n, request.seed, request.budget)],
            max_new_tokens=max_new,
            temperature=temperature,
            top_p=request.top_p,
            eos_ids=tok.stop_ids,
            top_logprobs=top_lp,
            frequency_penalty=float(request.frequency_penalty or 0.0),
            presence_penalty=float(request.presence_penalty or 0.0),
            logit_bias=logit_bias,
            stop_sequences=stop_seqs,
            constraint=constraint,
        )[0]
        if isinstance(result, BaseException):
            raise result

        choices: List[Dict[str, Any]] = []
        completion_tokens = 0
        for i in range(n):
            err = result.sample_errors[i] if result.sample_errors else None
            if err is not None:
                choices.append(
                    {
                        "finish_reason": "stop",
                        "index": i,
                        "message": {"role": "assistant", "content": ""},
                        "logprobs": None,
                        "sample_logprob": 0.0,
                        "sample_error": dict(err),
                    }
                )
                continue
            length = int(result.lengths[i])
            ids = [int(t) for t in result.tokens[i][:length]]
            text = tok.decode(ids)
            finish = result.finish_reasons[i]
            cuts = [pos for s in stop_strings if (pos := text.find(s)) != -1]
            if cuts:
                pos = min(cuts)
                finish = "stop"
                length = _visible_token_count(tok, ids, pos, text)
                text = text[:pos]
            completion_tokens += length
            logprobs_payload = None
            if request.logprobs:
                _tok_bytes = getattr(
                    tok, "token_bytes", lambda t: tok.decode([t]).encode("utf-8")
                )

                def _top_entries(step: int):
                    if result.top_tokens is None:
                        return []
                    return [
                        {
                            "token": tok.decode([int(tid)]),
                            "logprob": float(tlp),
                            "bytes": list(_tok_bytes(int(tid))),
                        }
                        for tid, tlp in zip(
                            result.top_tokens[i][step].tolist(),
                            result.top_logprobs[i][step].tolist(),
                        )
                    ]

                logprobs_payload = {
                    "content": [
                        {
                            "token": tok.decode([t]),
                            "logprob": float(lp),
                            "bytes": list(_tok_bytes(int(t))),
                            "top_logprobs": _top_entries(j),
                        }
                        for j, (t, lp) in enumerate(
                            zip(ids, result.logprobs[i][:length].tolist())
                        )
                    ]
                }
            choices.append(
                {
                    "finish_reason": finish,
                    "index": i,
                    "message": {"role": "assistant", "content": text},
                    "logprobs": logprobs_payload,
                    # Sequence-level sample log-likelihood (extension field);
                    # feeds likelihood-weighted consensus.
                    "sample_logprob": float(np.sum(result.logprobs[i][:length])),
                }
            )

        digest = hashlib.md5(repr((request.messages, request.seed)).encode()).hexdigest()[:12]
        payload: Dict[str, Any] = {
            "id": f"chatcmpl-cuda-{digest}",
            "choices": choices,
            "created": int(time.time()),
            "model": request.model or self.model_name,
            "object": "chat.completion",
            "system_fingerprint": f"k-llms-tpu-torch/{self.model_name}",
            "usage": {
                "prompt_tokens": result.prompt_len,
                "completion_tokens": completion_tokens,
                "total_tokens": result.prompt_len + completion_tokens,
            },
        }
        return ChatCompletion.model_validate(payload)

    def _constraint_for(self, response_format: Any):
        if response_format is None:
            return None
        schema = None
        wants_json = False
        if isinstance(response_format, type) and hasattr(response_format, "model_json_schema"):
            schema = response_format.model_json_schema()
        elif isinstance(response_format, dict):
            kind = response_format.get("type")
            if kind == "json_object":
                wants_json = True
            elif kind == "json_schema":
                # OpenAI wire form: {"type": "json_schema", "json_schema": {"schema": ...}}
                schema = (response_format.get("json_schema") or {}).get("schema")
                wants_json = True  # schema-less json_schema payload degrades to JSON mask
        if schema is None and not wants_json:
            # {"type": "text"} and unrecognized forms are unconstrained — only
            # an explicit JSON request earns the grammar mask.
            return None
        if not self.backend_config.constrained_decoding:
            # Post-hoc-only posture: decode unconstrained, parse() validates
            # after the fact (byte-identical to no response_format).
            return None
        # Compile-or-fetch through the process-wide grammar cache, keyed by
        # (schema digest, vocab digest). Never raises; None = unconstrained
        # + post-hoc validation (a compile error, counted in GRAMMAR_EVENTS).
        from ..engine.grammar import grammar_for_schema

        vocab, vocab_digest = self._grammar_vocab()
        return grammar_for_schema(schema, vocab, vocab_digest=vocab_digest)

    def _grammar_vocab(self):
        """(per-token byte strings, digest) for this backend's tokenizer —
        computed once; the digest is the grammar cache key's vocabulary half."""
        if getattr(self, "_grammar_vocab_cache", None) is None:
            from ..engine.grammar import grammar_vocab
            from ..engine.token_constraint import _vocab_digest

            vocab = grammar_vocab(self.tokenizer)
            self._grammar_vocab_cache = (vocab, _vocab_digest(vocab))
        return self._grammar_vocab_cache

    # -- embeddings -------------------------------------------------------
    def embeddings(self, texts: List[str]) -> List[List[float]]:
        token_lists = [self.tokenizer.encode(t)[:MAX_EMBEDDING_TOKENS] for t in texts]
        pooled = self.engine.embed_tokens(token_lists)
        return [[float(x) for x in row] for row in pooled]

    def crop_texts(
        self, texts: List[str], max_tokens: int, model: Optional[str] = None
    ) -> List[str]:
        tok = self.tokenizer
        return [
            t
            if len(t.encode("utf-8")) < max_tokens
            else tok.decode(tok.encode(t)[:max_tokens])
            for t in texts
        ]

    # -- llm-consensus ----------------------------------------------------
    def llm_consensus(self, values: List[str]) -> str:
        assert len(values) > 0, "Cannot build consensus string from empty list"
        messages = [
            {"role": "system", "content": SYSTEM_PROMPT_STRING_CONSENSUS_LLM},
            {"role": "user", "content": f"Input: {[json.dumps(v) for v in values]}\nOutput:"},
        ]
        ids = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        result = self.engine.generate(
            ids, n=1, max_new_tokens=128, temperature=0.0, eos_ids=self.tokenizer.stop_ids
        )
        text = self.tokenizer.decode(
            [int(t) for t in result.tokens[0][: int(result.lengths[0])]]
        ).strip()
        return text if text else values[0]
