"""CUDA backend: KLLMs(backend="cuda") — the local PyTorch engine.

Counterpart of ``k_llms_tpu/backends/tpu.py``: the chat template, stop
strings, per-sample logprobs and usage of ``chat_completion`` are carried
over; the request goes straight to ``LocalEngine.generate_many``. The
scheduler, supervisor, continuous loop, grammar-constrained decoding,
streaming and the device consensus scorer are not ported yet (``parse()``
validates after the fact).
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
from pydantic import BaseModel

from ..consensus.prompts import SYSTEM_PROMPT_STRING_CONSENSUS_LLM
from ..engine.engine import MAX_STOP_LEN, MAX_STOP_SEQS, GenRequestSpec, LocalEngine
from ..engine.tokenizer import get_tokenizer
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
    """The part of the JAX package's BackendConfig this backend uses."""

    model: str = "tiny"
    tokenizer_path: Optional[str] = None
    max_new_tokens: int = 256
    param_seed: int = 0
    # Where the engine runs: None = the CUDA card (raises without one);
    # "cpu" runs the kernels' plain PyTorch versions.
    device: Optional[str] = None


class CudaBackend(Backend):
    def __init__(
        self,
        model: Optional[str] = None,
        config: Optional[BackendConfig] = None,
        engine: Optional[LocalEngine] = None,
        **kwargs: Any,
    ):
        if config is not None and model is not None and model != config.model:
            raise ValueError(
                f"model={model!r} conflicts with config.model={config.model!r}; "
                "pass one or make them agree"
            )
        cfg = config or BackendConfig(model=model or "tiny", **{
            k: v for k, v in kwargs.items() if k in BackendConfig.model_fields
        })
        self.backend_config = cfg
        self.model_name = cfg.model
        self.tokenizer = get_tokenizer(cfg.tokenizer_path)
        self.engine = engine if engine is not None else LocalEngine(
            get_config(cfg.model), param_seed=cfg.param_seed, device=cfg.device
        )
        self.default_max_new_tokens = cfg.max_new_tokens

    # -- chat -------------------------------------------------------------
    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        tok = self.tokenizer
        prompt_ids = tok.apply_chat_template(request.messages, add_generation_prompt=True)
        n = max(1, request.n)
        temperature = 1.0 if request.temperature is None else float(request.temperature)
        max_new = request.max_tokens or self.default_max_new_tokens
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
