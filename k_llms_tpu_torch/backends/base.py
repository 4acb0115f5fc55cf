"""Backend protocol: what the resources layer needs from a model engine.

Counterpart of ``k_llms_tpu/backends/base.py`` without its reliability layer
(circuit breaker, retry policy, failpoints, replicas), which is not ported
yet: ``dispatch_chat_completion`` is one attempt.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Union

from ..reliability.deadline import RequestBudget
from ..types import ChatCompletion
from ..utils.locks import make_lock

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
    # Lifecycle budget built from the caller's ``timeout=``; checked before
    # prefill and after decode. None = unbounded.
    budget: Optional[RequestBudget] = None
    tenant: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


class Backend(abc.ABC):
    """A model engine that can answer one n-way chat completion request."""

    @abc.abstractmethod
    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        """Return ONE ChatCompletion carrying n choices (the n samples)."""

    supports_streaming: bool = False

    def dispatch_chat_completion(self, request: ChatRequest) -> ChatCompletion:
        """What the resources layer calls: one attempt, after a budget check."""
        if request.budget is not None:
            request.budget.check("dispatch")
        return self.chat_completion(request)

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
        return {"state": "ready"}

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
_BACKEND_ALIASES: Dict[str, str] = {"cuda": "cuda", "local": "cuda"}


def resolve_backend(backend: Union[str, Backend, None], **kwargs: Any) -> Backend:
    """Instantiate a backend from a name ("cuda" and aliases; None defaults
    to "cuda") or pass a Backend instance through unchanged."""
    if isinstance(backend, Backend):
        return backend
    known = sorted(_BACKEND_ALIASES)
    if backend is not None and not isinstance(backend, str):
        raise UnknownBackendError(backend, known)
    name = _BACKEND_ALIASES.get((backend or "cuda").strip().lower())
    if name == "cuda":
        from .cuda import CudaBackend

        return CudaBackend(**kwargs)
    raise UnknownBackendError(backend, known)
