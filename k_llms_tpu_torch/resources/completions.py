"""Completions resource: the public create/parse API surface.

Counterpart of ``k_llms_tpu/resources/completions.py``: same keyword
signatures and validation, native ``n`` passed to ONE backend call,
consolidation on the multi-choice result. Streaming and request tracing are
not ported yet: ``stream=True`` raises a typed 400.
"""

from __future__ import annotations

import asyncio
from typing import TYPE_CHECKING, Any, List, Optional, Type, Union

from pydantic import BaseModel

from ..backends.base import ChatRequest
from ..consensus.consolidation import (
    consolidate_chat_completions,
    consolidate_parsed_chat_completions,
)
from ..consensus.settings import ConsensusSettings
from ..consensus.similarity import SimilarityScorer
from ..reliability.deadline import RequestBudget
from ..types import KLLMsChatCompletion, KLLMsParsedChatCompletion
from ..types.wire import InvalidRequestError

if TYPE_CHECKING:  # pragma: no cover
    from ..client import AsyncKLLMs, KLLMs


def _build_request(
    messages: List[dict],
    model: str,
    n: Optional[int],
    temperature: Optional[float],
    max_tokens: Optional[int],
    top_p: Optional[float],
    frequency_penalty: Optional[float],
    presence_penalty: Optional[float],
    stop: Optional[Union[str, List[str]]],
    seed: Optional[int],
    response_format: Optional[Any],
    kwargs: dict,
    timeout: Optional[float] = None,
    tenant: Optional[str] = None,
) -> ChatRequest:
    kwargs = dict(kwargs)
    # ``stream`` is an explicit parameter of create()/parse() now; anything
    # still arriving here came through **kwargs on an internal path and must
    # not leak into ChatRequest.extra.
    kwargs.pop("stream", None)
    # Lifecycle budget: ``timeout=`` (seconds, the OpenAI per-call wire
    # contract) builds one; advanced callers pass ``budget=`` directly to hold
    # the cancel handle. Deadline.from_timeout 400s a negative timeout here,
    # with the other parameter errors.
    budget = kwargs.pop("budget", None)
    if budget is not None and not isinstance(budget, RequestBudget):
        raise ValueError(
            f"budget must be a RequestBudget, got {type(budget).__name__}"
        )
    if budget is None and timeout is not None:
        budget = RequestBudget.from_timeout(timeout)
    logprobs = kwargs.pop("logprobs", None)
    top_logprobs = kwargs.pop("top_logprobs", None)
    if top_logprobs is not None and not 0 <= int(top_logprobs) <= 20:
        # OpenAI's documented range; also bounds the per-k compile count of
        # the jitted decode loop, and fails here as a parameter error instead
        # of an opaque trace error inside top_k.
        raise ValueError(f"top_logprobs must be in 0..20, got {top_logprobs}")
    # Parameter validation with OpenAI's documented bounds (the reference
    # delegates these 400s to the server; a local engine must 400 them itself
    # rather than generate garbage or crash mid-trace).
    if not messages:
        raise ValueError("messages must be a non-empty list")
    if n is not None and n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if max_tokens is not None and max_tokens < 1:
        raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
    if temperature is not None and not 0.0 <= temperature <= 2.0:
        raise ValueError(f"temperature must be in [0, 2], got {temperature}")
    if top_p is not None and not 0.0 <= top_p <= 1.0:
        # OpenAI's documented range is [0, 1]; top_p=0 degenerates to top-1
        # (the boundary token always stays in the kept set).
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    for pname, pval in (("frequency_penalty", frequency_penalty),
                        ("presence_penalty", presence_penalty)):
        if pval is not None and not -2.0 <= pval <= 2.0:
            raise ValueError(f"{pname} must be in [-2, 2], got {pval}")
    logit_bias = kwargs.pop("logit_bias", None)
    if logit_bias is not None:
        for tok, bias in logit_bias.items():
            if not -100.0 <= float(bias) <= 100.0:
                raise ValueError(
                    f"logit_bias values must be in [-100, 100], got {bias} for {tok}"
                )
    return ChatRequest(
        logprobs=logprobs,
        top_logprobs=top_logprobs,
        logit_bias=logit_bias,
        messages=messages,
        model=model,
        n=n or 1,
        temperature=temperature,
        max_tokens=max_tokens,
        top_p=top_p,
        frequency_penalty=frequency_penalty,
        presence_penalty=presence_penalty,
        stop=stop,
        seed=seed,
        response_format=response_format,
        budget=budget,
        tenant=tenant,
        extra=kwargs,
    )


def _no_stream(stream: bool, api: str) -> None:
    if stream:
        raise InvalidRequestError(
            f"stream=True is not supported by {api} in k_llms_tpu_torch yet",
            param="stream",
        )


class Completions:
    def __init__(self, wrapper: "KLLMs"):
        self._wrapper = wrapper

    def _scorer(self, settings: ConsensusSettings) -> SimilarityScorer:
        # Shared per-backend scorer: similarity/embedding TTL caches persist
        # across requests.
        return self._wrapper.backend.similarity_scorer(
            settings.string_similarity_method
        )

    def create(
        self,
        *,
        messages: List[dict],
        model: Optional[str] = None,
        n: Optional[int] = None,
        temperature: Optional[float] = None,
        max_tokens: Optional[int] = None,
        top_p: Optional[float] = None,
        frequency_penalty: Optional[float] = None,
        presence_penalty: Optional[float] = None,
        stop: Optional[Union[str, List[str]]] = None,
        seed: Optional[int] = None,
        response_format: Optional[Any] = None,
        consensus_settings: Optional[ConsensusSettings] = None,
        timeout: Optional[float] = None,
        stream: bool = False,
        tenant: Optional[str] = None,
        **kwargs: Any,
    ) -> KLLMsChatCompletion:
        _no_stream(stream, "create()")
        settings = consensus_settings or ConsensusSettings()
        if timeout is None:
            timeout = getattr(self._wrapper, "default_timeout", None)
        request = _build_request(
            messages, model or self._wrapper.default_model, n, temperature, max_tokens,
            top_p, frequency_penalty, presence_penalty, stop, seed, response_format, kwargs,
            timeout=timeout, tenant=tenant,
        )
        completion = self._wrapper.backend.dispatch_chat_completion(request)
        return consolidate_chat_completions(
            completion,
            self._scorer(settings),
            consensus_settings=settings,
            llm_consensus_fn=self._wrapper.backend.llm_consensus,
            budget=request.budget,
        )

    def parse(
        self,
        *,
        messages: List[dict],
        response_format: Type[BaseModel],
        model: Optional[str] = None,
        n: Optional[int] = None,
        temperature: Optional[float] = None,
        max_tokens: Optional[int] = None,
        top_p: Optional[float] = None,
        frequency_penalty: Optional[float] = None,
        presence_penalty: Optional[float] = None,
        stop: Optional[Union[str, List[str]]] = None,
        seed: Optional[int] = None,
        consensus_settings: Optional[ConsensusSettings] = None,
        timeout: Optional[float] = None,
        stream: bool = False,
        tenant: Optional[str] = None,
        **kwargs: Any,
    ) -> KLLMsParsedChatCompletion:
        """Structured output validated after the fact: the samples decode
        unconstrained and consolidation parses them into ``response_format``
        (grammar-constrained decoding is not ported yet)."""
        _no_stream(stream, "parse()")
        settings = consensus_settings or ConsensusSettings()
        if timeout is None:
            timeout = getattr(self._wrapper, "default_timeout", None)
        request = _build_request(
            messages, model or self._wrapper.default_model, n, temperature, max_tokens,
            top_p, frequency_penalty, presence_penalty, stop, seed, response_format, kwargs,
            timeout=timeout, tenant=tenant,
        )
        completion = self._wrapper.backend.dispatch_chat_completion(request)
        return consolidate_parsed_chat_completions(
            completion,
            self._scorer(settings),
            consensus_settings=settings,
            response_format=response_format,
            llm_consensus_fn=self._wrapper.backend.llm_consensus,
            budget=request.budget,
        )


class AsyncCompletions:
    """Async frontend over the same core, thread-offloaded."""

    def __init__(self, wrapper: "AsyncKLLMs"):
        self._wrapper = wrapper
        self._sync = Completions(wrapper)  # type: ignore[arg-type]

    async def create(self, **kwargs: Any) -> KLLMsChatCompletion:
        return await asyncio.to_thread(lambda: self._sync.create(**kwargs))

    async def parse(self, **kwargs: Any) -> KLLMsParsedChatCompletion:
        return await asyncio.to_thread(lambda: self._sync.parse(**kwargs))
