"""Backend protocol: what the resources layer needs from a model engine.

Counterpart of ``k_llms_tpu/backends/base.py`` with its reliability layer:
``dispatch_chat_completion`` gates on a per-backend circuit breaker, checks
the request budget and retries under a bounded backoff policy, and fires the
``backend.dispatch`` failpoint on every attempt. A stream gets exactly one
attempt behind the same gate and failpoint.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Union

from ..reliability import failpoints as _failpoints
from ..reliability.deadline import RequestBudget
from ..reliability.retry import CircuitBreaker, RetryPolicy
from ..types import ChatCompletion
from ..types.wire import (
    InvalidRequestError,
    RateLimitError,
    RequestCancelledError,
    RequestTimeoutError,
    ServerDrainingError,
)
from ..analysis.lockcheck import make_lock

if TYPE_CHECKING:  # pragma: no cover
    from ..consensus.similarity import SimilarityScorer


@dataclass
class ChatRequest:
    """Normalized chat-completion request."""

    messages: List[Dict[str, Any]]
    model: str
    n: int = 1
    temperature: Optional[float] = None
    max_tokens: Optional[int] = None
    top_p: Optional[float] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    response_format: Optional[Any] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    # OpenAI logit_bias: {token_id: bias in [-100, 100]} added to the logits
    # at sampling time.
    logit_bias: Optional[Dict[str, float]] = None
    # Lifecycle budget built from the caller's ``timeout=`` plus a
    # cooperative cancel token; threaded into scheduler admission and the
    # engine's decode loop (polled every step). None = unbounded.
    budget: Optional[RequestBudget] = None
    # Tenant this request bills against; None = the permissive "default"
    # tenant. The scheduler resolves it to a TenantContext at admission.
    tenant: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


class Backend(abc.ABC):
    """A model engine that can answer one n-way chat completion request."""

    @abc.abstractmethod
    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        """Return ONE ChatCompletion carrying n choices (the n samples)."""

    #: True when ``chat_completion_stream`` delivers incremental deltas. The
    #: resources layer checks this before opening a stream, so ``stream=True``
    #: against a non-streaming backend fails as a typed 400 up front.
    supports_streaming: bool = False

    def chat_completion_stream(
        self, request: ChatRequest, emit: "Callable[[int, str], None]"
    ) -> ChatCompletion:
        """Run one n-way completion, calling ``emit(sample_idx, text_delta)``
        as sample text lands (sample_idx in 0..n-1, request order), then
        return the finished ChatCompletion exactly as ``chat_completion``
        would. Backends that cannot stream raise the OpenAI-shaped 400."""
        raise InvalidRequestError(
            f"{type(self).__name__} does not support stream=True; "
            "use a streaming-capable backend (cuda, fake) or stream=False",
            param="stream",
        )

    def dispatch_chat_completion_stream(
        self, request: ChatRequest, emit: "Callable[[int, str], None]"
    ) -> ChatCompletion:
        """``chat_completion_stream`` behind the circuit-breaker gate and the
        ``backend.dispatch`` failpoint. Not retried: once deltas have reached
        the client a retry would replay text mid-stream, so a stream gets
        exactly one attempt and surfaces its fault."""
        breaker = self.circuit_breaker
        breaker.allow()
        try:
            _failpoints.fire("backend.dispatch")
            out = self.chat_completion_stream(request, emit)
        except BaseException as e:
            # Caller deadlines and cancels and admission sheds are not
            # backend-health signals.
            if not isinstance(
                e,
                (RequestTimeoutError, RequestCancelledError, RateLimitError, ServerDrainingError),
            ):
                breaker.record_failure()
            raise
        breaker.record_success()
        return out

    #: Dispatch-layer reliability knobs, overridable per instance (pass a
    #: seeded RetryPolicy in tests to pin backoff schedules). The breaker is
    #: lazily per-instance so one flapping backend never opens another's
    #: circuit.
    retry_policy: RetryPolicy = RetryPolicy()

    @property
    def circuit_breaker(self) -> CircuitBreaker:
        breaker = self.__dict__.get("_circuit_breaker")
        if breaker is None:
            breaker = CircuitBreaker(name=type(self).__name__)
            self.__dict__["_circuit_breaker"] = breaker
        return breaker

    def dispatch_chat_completion(self, request: ChatRequest) -> ChatCompletion:
        """``chat_completion`` wrapped in the reliability layer: circuit-breaker
        gate, budget check, bounded retry with backoff, and the
        ``backend.dispatch`` failpoint. This is what the resources layer
        calls; ``chat_completion`` stays the single-attempt primitive."""
        breaker = self.circuit_breaker

        def attempt() -> ChatCompletion:
            breaker.allow()
            try:
                _failpoints.fire("backend.dispatch")
                out = self.chat_completion(request)
            except BaseException as e:
                # A caller's own deadline/cancel is not a backend-health
                # signal, and admission sheds (queue full, draining) are load
                # signals: only genuine dispatch faults trip the circuit.
                if not isinstance(
                    e,
                    (
                        RequestTimeoutError,
                        RequestCancelledError,
                        RateLimitError,
                        ServerDrainingError,
                    ),
                ):
                    breaker.record_failure()
                raise
            breaker.record_success()
            return out

        return self.retry_policy.call(attempt, budget=request.budget)

    @abc.abstractmethod
    def embeddings(self, texts: List[str]) -> List[List[float]]:
        """Similarity-side-channel embeddings."""

    #: Model name the plain ``embeddings()`` entry point uses.
    embedding_model_name: str = "local"

    #: True for backends whose embedding calls cost real money.
    bills_usage: bool = False

    def embeddings_with_usage(
        self, texts: List[str], model: Optional[str] = None
    ) -> "tuple[List[List[float]], int]":
        """Embeddings plus billed prompt-token count (local backends bill 0)."""
        return self.embeddings(texts), 0

    def crop_texts(
        self, texts: List[str], max_tokens: int, model: Optional[str] = None
    ) -> List[str]:
        return list(texts)

    _scorer_registry_lock = make_lock("backends.scorer_registry")

    def similarity_scorer(self, method: str) -> "SimilarityScorer":
        """The shared per-method host similarity scorer for this backend, so
        embedding/similarity TTL caches amortize across requests."""
        from ..consensus.similarity import SimilarityScorer

        with Backend._scorer_registry_lock:
            registry = self.__dict__.setdefault("_similarity_scorers", {})
            scorer = registry.get(method)
            if scorer is None:
                scorer = SimilarityScorer(method=method, embed_fn=self.embeddings)
                registry[method] = scorer
            return scorer

    def llm_consensus(self, values: List[str]) -> str:
        """Build a consensus string from candidates. Default: the first."""
        return values[0]

    def health(self) -> Dict[str, Any]:
        """Point-in-time serving-health snapshot. Backends without a
        scheduler report their breaker state; CudaBackend overrides with the
        scheduler's lifecycle view."""
        breaker = self.__dict__.get("_circuit_breaker")
        return {
            "state": "ready",
            "breaker": breaker.state if breaker is not None else "closed",
        }

    def drain(self, timeout: float = 30.0) -> bool:
        self.close()
        return True

    def close(self) -> None:  # pragma: no cover - optional
        pass


class UnknownBackendError(ValueError):
    """``resolve_backend`` got a name (or object) it cannot turn into a
    Backend."""

    def __init__(self, backend: Any, known: List[str]):
        self.backend = backend
        self.known = list(known)
        shown = ", ".join(repr(k) for k in self.known)
        super().__init__(
            f"Unknown backend {backend!r}; expected one of {shown} "
            "(a name, case-insensitive), or a Backend instance"
        )


#: Accepted backend names (case/whitespace-insensitive) -> canonical family.
_BACKEND_ALIASES: Dict[str, str] = {
    "fake": "fake",
    "cuda": "cuda",
    "local": "cuda",
    "openai": "openai",
    "replicas": "replicas",
    "replica": "replicas",
    "replicaset": "replicas",
    "replica_set": "replicas",
}


def resolve_backend(backend: Union[str, Backend, None], **kwargs: Any) -> Backend:
    """Instantiate a backend from a name ("cuda" | "fake" | "openai" |
    "replicas", plus aliases; None defaults to "cuda") or pass a Backend
    instance through unchanged."""
    if isinstance(backend, Backend):
        return backend
    known = sorted(_BACKEND_ALIASES)
    if backend is not None and not isinstance(backend, str):
        raise UnknownBackendError(backend, known)
    name = _BACKEND_ALIASES.get((backend or "cuda").strip().lower())
    if name == "fake":
        from .fake import FakeBackend

        return FakeBackend(**kwargs)
    if name == "cuda":
        from .cuda import CudaBackend

        return CudaBackend(**kwargs)
    if name == "openai":
        from .openai_backend import OpenAIBackend

        return OpenAIBackend(**kwargs)
    if name == "replicas":
        from ..reliability.replicas import ReplicaSet

        return ReplicaSet(**kwargs)
    raise UnknownBackendError(backend, known)
