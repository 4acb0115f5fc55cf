"""Completions resource: the public create/parse API surface.

Parity target: `k_llms/resources/completions/completions.py` —
same keyword signatures, streaming forced off (:36, :173-174), native ``n``
passed to ONE model call (:70-73), consolidation on the multi-choice result.
The model call goes to a pluggable :class:`Backend` instead of the OpenAI HTTP
client, and the per-call embeddings closure (:67-68) becomes the backend's
embedding provider wired into a :class:`SimilarityScorer`.
"""

from __future__ import annotations

import asyncio
import hashlib
import queue
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, Iterator, List, Optional, Type, Union

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
from ..utils.observability import LATENCY, TRACER, Trace, use_trace

import logging
import os

logger = logging.getLogger(__name__)


def _attach_trace(result, trace: Trace, backend=None):
    """Phase timings: logged at DEBUG always; attached to the response as a
    ``timings`` extension only when KLLMS_TRACE=1 (keeps the default wire
    payload byte-identical to the reference contract). The payload is the
    trace's full phase breakdown (queue_wait/prefill/decode/... accumulate
    from the scheduler and decode loops) plus its trace_id, so a caller can
    join a response to its ``/debug/requests`` flight record. With a local
    backend the trace also carries the engine-side serving stats (speculative
    acceptance/fallback mode, prefix-cache hit mix, scheduler coalescing) —
    the numbers operators tune speculative/prefix/batch knobs against."""
    logger.debug("request timings: %s", trace.as_dict())
    if os.getenv("KLLMS_TRACE") == "1":
        timings = dict(trace.as_dict())
        if trace.trace_id:
            timings["trace_id"] = trace.trace_id
        result.timings = timings
        # CudaBackend attaches engine_stats to the completion payload at
        # generation time (race-free under concurrency: the spec stats ride
        # the GenerationResult, not shared engine state) and the wire types'
        # extra="allow" carries them through consolidation. Fall back to a
        # live engine snapshot only for backends that don't attach them.
        if getattr(result, "engine_stats", None) is None:
            engine = getattr(backend, "engine", None)
            if engine is not None:
                result.engine_stats = {
                    "spec": dict(engine.spec_stats),
                    "prefix_cache": dict(engine.prefix_cache_stats),
                    "scheduler": dict(getattr(backend, "scheduler").stats)
                    if hasattr(backend, "scheduler")
                    else None,
                }
    return result

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


class ChatCompletionStream:
    """Iterator of OpenAI-wire streaming events for one n-way request.

    Yields plain dicts ready for ``json.dumps``: ``chat.completion.chunk``
    deltas for the n live samples (wire ``choices`` index ``i+1`` — index 0 is
    reserved for the consensus), a finish chunk per sample once sampling
    completes, then ONE final ``chat.completion`` event carrying the fully
    consolidated response (consensus ``choices[0]`` + ``likelihoods``).

    The backend dispatch + consolidation run on a dedicated worker thread so
    deltas reach the consumer as they land; the consumer-side iterator is the
    only queue reader. ``close()`` cancels the request's budget, which aborts
    decode at token granularity through the engine's abort poller — this is
    what a client disconnect maps to. Every stream owns a budget (one is
    created when the caller passed none) precisely so that handle exists.
    """

    def __init__(
        self,
        backend: Any,
        request: ChatRequest,
        settings: ConsensusSettings,
        scorer: SimilarityScorer,
        llm_consensus_fn: Any,
    ) -> None:
        if request.budget is None:
            request.budget = RequestBudget()
        self._backend = backend
        self._request = request
        self._settings = settings
        self._scorer = scorer
        self._llm_consensus_fn = llm_consensus_fn
        self._id = "chatcmpl-stream-" + hashlib.md5(
            f"{request.messages}|{request.seed}".encode()
        ).hexdigest()[:12]
        self._created = int(time.time())
        self._events: "queue.Queue[tuple]" = queue.Queue()
        self._pending: List[Dict[str, Any]] = []
        self._roles_sent: set = set()
        self._response: Optional[KLLMsChatCompletion] = None
        self._completion: Optional[Any] = None
        self._closed = False
        self._exhausted = False
        # Capture the request trace on the submitting thread (the worker is a
        # plain Thread, which does NOT inherit contextvars) and remember
        # ownership: an HTTP front door that started the trace finishes it;
        # an in-process stream owns and finishes its own.
        self.trace, self._owns_trace = TRACER.current_or_start()
        self._t0 = time.monotonic()
        self._first_delta_seen = False
        self._thread = threading.Thread(
            target=self._run, name="kllms-stream", daemon=True
        )
        self._thread.start()

    # -- worker side ---------------------------------------------------------

    def _emit(self, sample_idx: int, delta: str) -> None:
        if not self._first_delta_seen:
            # TTFT: first streamed token for the whole n-way request,
            # measured from stream construction (host wall clock).
            self._first_delta_seen = True
            ttft = time.monotonic() - self._t0
            LATENCY.observe("request.ttft", ttft)
            if self._request.tenant:
                LATENCY.observe(f"request.ttft.{self._request.tenant}", ttft)
            self.trace.annotate("ttft_s", round(ttft, 6))
        self._events.put(("delta", sample_idx, delta))

    def _run(self) -> None:
        try:
            # Re-enter the captured trace so the backend's scheduler /
            # continuous-loop submissions on this thread attribute to it.
            with use_trace(self.trace):
                with self.trace.phase("sample"):
                    completion = self._backend.dispatch_chat_completion_stream(
                        self._request, self._emit
                    )
                # Finish chunks can go out while consolidation is still
                # running.
                self._events.put(("sampled", completion))
                t0 = time.perf_counter()
                with self.trace.phase("consolidate"):
                    result = consolidate_chat_completions(
                        completion,
                        self._scorer,
                        consensus_settings=self._settings,
                        llm_consensus_fn=self._llm_consensus_fn,
                        budget=self._request.budget,
                    )
                LATENCY.observe(
                    "consensus.consolidate", time.perf_counter() - t0
                )
            self._events.put(("final", result))
        except BaseException as e:  # surfaced on the consumer side
            if self._owns_trace:
                TRACER.finish(
                    self.trace,
                    route="stream",
                    status="error",
                    n=self._request.n,
                    error=e,
                    tenant=self._request.tenant,
                )
            self._events.put(("error", e))
        else:
            if self._owns_trace:
                TRACER.finish(
                    self.trace,
                    route="stream",
                    status="ok",
                    n=self._request.n,
                    tenant=self._request.tenant,
                )
            self._events.put(("done", None))

    # -- consumer side -------------------------------------------------------

    def _chunk(
        self,
        wire_index: int,
        delta: Dict[str, Any],
        finish_reason: Optional[str] = None,
    ) -> Dict[str, Any]:
        return {
            "id": self._id,
            "object": "chat.completion.chunk",
            "created": self._created,
            "model": self._request.model,
            "choices": [
                {
                    "index": wire_index,
                    "delta": delta,
                    "finish_reason": finish_reason,
                    "logprobs": None,
                }
            ],
        }

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        while True:
            if self._pending:
                return self._pending.pop(0)
            if self._exhausted:
                raise StopIteration
            kind, *payload = self._events.get()
            if kind == "delta":
                sample_idx, text = payload
                delta: Dict[str, Any] = {"content": text}
                if sample_idx not in self._roles_sent:
                    self._roles_sent.add(sample_idx)
                    delta = {"role": "assistant", "content": text}
                return self._chunk(sample_idx + 1, delta)
            if kind == "sampled":
                (completion,) = payload
                self._completion = completion
                for i, choice in enumerate(completion.choices):
                    chunk = self._chunk(
                        i + 1, {}, finish_reason=choice.finish_reason
                    )
                    err = getattr(choice, "sample_error", None)
                    if err is not None:
                        # Terminal typed per-sample error: this row was lost
                        # mid-decode (numeric quarantine, injected kill) and
                        # produced no further deltas — the finish chunk
                        # carries the same ``sample_error`` payload the
                        # non-streaming response attaches, so streaming
                        # clients learn WHY the sample went silent instead
                        # of seeing a bare early "stop".
                        chunk["choices"][0]["sample_error"] = dict(err)
                    self._pending.append(chunk)
                continue
            if kind == "final":
                (result,) = payload
                self._response = result
                return result.model_dump(mode="json")
            if kind == "error":
                self._exhausted = True
                raise payload[0]
            # "done"
            self._exhausted = True
            raise StopIteration

    @property
    def response(self) -> Optional[KLLMsChatCompletion]:
        """The consolidated final response; None until the final event."""
        return self._response

    def close(self) -> None:
        """Abandon the stream: cancel the budget (aborts decode through the
        engine's poller) and unblock/join the worker. Idempotent; safe from a
        disconnect handler racing normal completion."""
        if self._closed:
            return
        self._closed = True
        self._exhausted = True
        if self._owns_trace:
            # No-op if the worker already finished the trace normally
            # (mark_finished is first-caller-wins).
            TRACER.finish(
                self.trace,
                route="stream",
                status="aborted",
                n=self._request.n,
                tenant=self._request.tenant,
            )
        if self._request.budget is not None:
            self._request.budget.cancel()
        # Drain whatever the worker still enqueues so its puts never block
        # (unbounded queue — this is belt-and-braces) and join it briefly;
        # daemon=True means a wedged backend cannot hang interpreter exit.
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "ChatCompletionStream":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class AsyncChatCompletionStream:
    """Async-iterator facade over :class:`ChatCompletionStream` — each event is
    pulled with ``asyncio.to_thread`` so the loop never blocks on the queue."""

    _SENTINEL = object()

    def __init__(self, stream: ChatCompletionStream) -> None:
        self._stream = stream

    def __aiter__(self) -> "AsyncChatCompletionStream":
        return self

    async def __anext__(self) -> Dict[str, Any]:
        item = await asyncio.to_thread(next, self._stream, self._SENTINEL)
        if item is self._SENTINEL:
            raise StopAsyncIteration
        return item

    @property
    def response(self) -> Optional[KLLMsChatCompletion]:
        return self._stream.response

    async def close(self) -> None:
        await asyncio.to_thread(self._stream.close)

    async def __aenter__(self) -> "AsyncChatCompletionStream":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()


class Completions:
    def __init__(self, wrapper: "KLLMs"):
        self._wrapper = wrapper

    def _scorer(self, settings: ConsensusSettings) -> SimilarityScorer:
        # Shared per-backend scorer: similarity/embedding TTL caches persist
        # across requests (the reference's caches are module-global,
        # `consensus_utils.py:620-623`), so repeated extraction workloads do
        # not re-embed the same strings every call.
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
    ) -> Union[KLLMsChatCompletion, ChatCompletionStream]:
        settings = consensus_settings or ConsensusSettings()
        if timeout is None:
            timeout = getattr(self._wrapper, "default_timeout", None)
        request = _build_request(
            messages, model or self._wrapper.default_model, n, temperature, max_tokens,
            top_p, frequency_penalty, presence_penalty, stop, seed, response_format, kwargs,
            timeout=timeout, tenant=tenant,
        )
        if stream:
            backend = self._wrapper.backend
            if not getattr(backend, "supports_streaming", False):
                raise InvalidRequestError(
                    f"stream=True is not supported by {type(backend).__name__}; "
                    "use stream=False or a streaming-capable backend",
                    param="stream",
                )
            return ChatCompletionStream(
                backend,
                request,
                settings,
                self._scorer(settings),
                backend.llm_consensus,
            )
        # Adopt the front door's trace when one is bound to this context
        # (asyncio.to_thread copies the contextvar into this thread);
        # otherwise this call is the trace owner and must finish it.
        trace, owned = TRACER.current_or_start()
        try:
            with use_trace(trace):
                with trace.phase("sample"):
                    completion = self._wrapper.backend.dispatch_chat_completion(
                        request
                    )
                t0 = time.perf_counter()
                with trace.phase("consolidate"):
                    result = consolidate_chat_completions(
                        completion,
                        self._scorer(settings),
                        consensus_settings=settings,
                        llm_consensus_fn=self._wrapper.backend.llm_consensus,
                        budget=request.budget,
                    )
                LATENCY.observe(
                    "consensus.consolidate", time.perf_counter() - t0
                )
        except BaseException as e:
            if owned:
                TRACER.finish(
                    trace, route="create", status="error", n=request.n,
                    error=e, tenant=request.tenant,
                )
            raise
        result = _attach_trace(result, trace, self._wrapper.backend)
        if owned:
            TRACER.finish(
                trace, route="create", status="ok", n=request.n,
                tenant=request.tenant,
            )
        return result

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
        if stream:
            # Structured parse needs the complete body to validate against the
            # schema; partial JSON deltas would parse to garbage. Typed 400,
            # mirroring OpenAI's "stream is not supported with parse".
            raise InvalidRequestError(
                "stream=True is not supported with parse(); "
                "use create(stream=True) or parse(stream=False)",
                param="stream",
            )
        settings = consensus_settings or ConsensusSettings()
        if timeout is None:
            timeout = getattr(self._wrapper, "default_timeout", None)
        request = _build_request(
            messages, model or self._wrapper.default_model, n, temperature, max_tokens,
            top_p, frequency_penalty, presence_penalty, stop, seed, response_format, kwargs,
            timeout=timeout, tenant=tenant,
        )
        trace, owned = TRACER.current_or_start()
        try:
            with use_trace(trace):
                with trace.phase("sample"):
                    completion = self._wrapper.backend.dispatch_chat_completion(
                        request
                    )
                t0 = time.perf_counter()
                with trace.phase("consolidate"):
                    result = consolidate_parsed_chat_completions(
                        completion,
                        self._scorer(settings),
                        consensus_settings=settings,
                        response_format=response_format,
                        llm_consensus_fn=self._wrapper.backend.llm_consensus,
                        budget=request.budget,
                    )
                LATENCY.observe(
                    "consensus.consolidate", time.perf_counter() - t0
                )
        except BaseException as e:
            if owned:
                TRACER.finish(
                    trace, route="parse", status="error", n=request.n,
                    error=e, tenant=request.tenant,
                )
            raise
        result = _attach_trace(result, trace, self._wrapper.backend)
        if owned:
            TRACER.finish(
                trace, route="parse", status="ok", n=request.n,
                tenant=request.tenant,
            )
        return result


class AsyncCompletions:
    """Async frontend over the same core; device work is internally parallel, so
    the reference's full async mirror collapses into thread-offloaded adapters."""

    def __init__(self, wrapper: "AsyncKLLMs"):
        self._wrapper = wrapper
        self._sync = Completions(wrapper)  # type: ignore[arg-type]

    async def create(
        self, **kwargs: Any
    ) -> Union[KLLMsChatCompletion, AsyncChatCompletionStream]:
        result = await asyncio.to_thread(lambda: self._sync.create(**kwargs))
        if isinstance(result, ChatCompletionStream):
            return AsyncChatCompletionStream(result)
        return result

    async def parse(self, **kwargs: Any) -> KLLMsParsedChatCompletion:
        return await asyncio.to_thread(lambda: self._sync.parse(**kwargs))
