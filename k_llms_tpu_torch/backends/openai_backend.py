"""OpenAI HTTP passthrough backend (optional).

Reproduces the reference's only execution path — one HTTPS call with native ``n``
(`k_llms/resources/completions/completions.py:70-87`) and the
embeddings side-channel (`client.py:75-122`). Requires the ``openai`` package;
the local CUDA backend never needs it.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..types import ChatCompletion
from .base import Backend, ChatRequest


class OpenAIBackend(Backend):
    bills_usage = True

    def __init__(
        self,
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
        timeout: Optional[float] = None,
        max_retries: int = 2,
        embedding_model: str = "text-embedding-3-small",
        model: Optional[str] = None,
        **kwargs: Any,
    ):
        # ``model`` is accepted for constructor symmetry with the local
        # backends (the client injects it); the remote API takes the model
        # per-request, so it is only recorded here.
        self.model_name = model
        try:
            from openai import OpenAI  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "backend='openai' requires the openai package; use backend='cuda' "
                "or backend='fake' on hosts without it"
            ) from e
        import os

        self._client = OpenAI(
            api_key=api_key or os.environ.get("OPENAI_API_KEY"),
            base_url=base_url,
            timeout=timeout,
            max_retries=max_retries,
            **kwargs,
        )
        self._embedding_model = embedding_model
        self.embedding_model_name = embedding_model

    @property
    def client(self):
        return self._client

    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        params: dict = {"messages": request.messages, "model": request.model, "stream": False}
        for name in (
            "temperature",
            "max_tokens",
            "top_p",
            "frequency_penalty",
            "presence_penalty",
            "stop",
            "seed",
            "response_format",
            "logit_bias",
        ):
            val = getattr(request, name)
            if val is not None:
                params[name] = val
        if request.n and request.n > 1:
            params["n"] = request.n
        params.update(request.extra)
        raw = self._client.chat.completions.create(**params)
        return ChatCompletion.model_validate(raw.model_dump())

    def embeddings(self, texts: List[str]) -> List[List[float]]:
        response = self._client.embeddings.create(input=texts, model=self._embedding_model)
        return [item.embedding for item in response.data]

    def embeddings_with_usage(self, texts: List[str], model: Optional[str] = None):
        effective = model if model and model != "local" else self._embedding_model
        response = self._client.embeddings.create(input=texts, model=effective)
        tokens = response.usage.prompt_tokens if response.usage else 0
        return [item.embedding for item in response.data], tokens

    def crop_texts(
        self, texts: List[str], max_tokens: int, model: Optional[str] = None
    ) -> List[str]:
        effective = model if model and model != "local" else self._embedding_model
        try:
            import tiktoken  # type: ignore
        except ImportError:  # pragma: no cover
            # Conservative fallback: one token is at least one character, so a
            # char-level crop can never exceed the cap (an uncropped send would
            # make the client's crop-all retry a guaranteed second failure).
            return [t[:max_tokens] for t in texts]
        enc = tiktoken.encoding_for_model(effective)
        return [enc.decode(enc.encode(t)[:max_tokens]) for t in texts]

    def llm_consensus(self, values: List[str]) -> str:
        import json

        from ..consensus.prompts import SYSTEM_PROMPT_STRING_CONSENSUS_LLM

        values_json_dumped = [json.dumps(v) for v in values]
        response = self._client.chat.completions.create(
            model="gpt-5-mini",
            messages=[
                {"role": "system", "content": SYSTEM_PROMPT_STRING_CONSENSUS_LLM},
                {"role": "user", "content": f"Input: {values_json_dumped}\nOutput:"},
            ],
        )
        content = response.choices[0].message.content
        if content is None:
            return values[0]
        return str(content).strip()
