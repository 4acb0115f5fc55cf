"""Vendored OpenAI-compatible chat-completion wire types.

The reference (k-LLMs) subclasses pydantic models from the ``openai`` package
(`k_llms/types/completions.py:7`, `parsed.py:7`) and so depends on it
for types only. On TPU hosts we must run with zero OpenAI dependency, so this module
vendors a minimal-but-faithful pydantic replica of the wire types the reference's
surface uses: ``ChatCompletion``, ``Choice``, ``ChatCompletionMessage``,
``CompletionUsage`` (with token-detail subobjects), the logprob containers, and the
``Parsed*`` generics. Field names, defaults, and JSON layout match the OpenAI SDK so
serialized payloads are drop-in compatible.

If the real ``openai`` package is installed, ``k_llms_tpu_torch.types`` prefers it (see
``k_llms_tpu_torch/types/__init__.py``) — these models are the fallback.
"""

from __future__ import annotations

from typing import Any, Dict, Generic, List, Literal, Optional, TypeVar

from pydantic import BaseModel, ConfigDict


class _Model(BaseModel):
    """Base config mirroring openai._models.BaseModel: tolerate unknown fields."""

    model_config = ConfigDict(extra="allow")


class FunctionCall(_Model):
    arguments: str
    name: str


class Function(_Model):
    arguments: str
    name: str


class ChatCompletionMessageToolCall(_Model):
    id: str
    function: Function
    type: Literal["function"] = "function"


class TopLogprob(_Model):
    token: str
    bytes: Optional[List[int]] = None
    logprob: float


class ChatCompletionTokenLogprob(_Model):
    token: str
    bytes: Optional[List[int]] = None
    logprob: float
    top_logprobs: List[TopLogprob] = []


class ChoiceLogprobs(_Model):
    content: Optional[List[ChatCompletionTokenLogprob]] = None
    refusal: Optional[List[ChatCompletionTokenLogprob]] = None


class ChatCompletionMessage(_Model):
    content: Optional[str] = None
    refusal: Optional[str] = None
    role: Literal["assistant"] = "assistant"
    function_call: Optional[FunctionCall] = None
    tool_calls: Optional[List[ChatCompletionMessageToolCall]] = None


FinishReason = Literal["stop", "length", "tool_calls", "content_filter", "function_call"]


class Choice(_Model):
    finish_reason: FinishReason
    index: int
    logprobs: Optional[ChoiceLogprobs] = None
    message: ChatCompletionMessage


class PromptTokensDetails(_Model):
    audio_tokens: Optional[int] = None
    cached_tokens: Optional[int] = None


class CompletionTokensDetails(_Model):
    accepted_prediction_tokens: Optional[int] = None
    audio_tokens: Optional[int] = None
    reasoning_tokens: Optional[int] = None
    rejected_prediction_tokens: Optional[int] = None


class CompletionUsage(_Model):
    completion_tokens: int
    prompt_tokens: int
    total_tokens: int
    completion_tokens_details: Optional[CompletionTokensDetails] = None
    prompt_tokens_details: Optional[PromptTokensDetails] = None


class ChatCompletion(_Model):
    id: str
    choices: List[Choice]
    created: int
    model: str
    object: Literal["chat.completion"] = "chat.completion"
    service_tier: Optional[str] = None
    system_fingerprint: Optional[str] = None
    usage: Optional[CompletionUsage] = None


ContentType = TypeVar("ContentType")


class ParsedChatCompletionMessage(ChatCompletionMessage, Generic[ContentType]):
    parsed: Optional[ContentType] = None


class ParsedChoice(Choice, Generic[ContentType]):
    message: ParsedChatCompletionMessage[ContentType]


class ParsedChatCompletion(ChatCompletion, Generic[ContentType]):
    choices: List[ParsedChoice[ContentType]]  # type: ignore[assignment]


# Request-side aliases (the reference types these loosely; we accept plain dicts)
ChatCompletionMessageParam = Dict[str, Any]


# ---------------------------------------------------------------------------
# Typed request-lifecycle errors (OpenAI error shapes)
# ---------------------------------------------------------------------------
# The reference leans on the ``openai`` client's exception hierarchy
# (APITimeoutError, APIConnectionError, InternalServerError); a local engine
# must supply the same reliability contract itself. These carry the OpenAI
# wire error payload ({"error": {"message", "type", "code"}}) so a serving
# frontend can return them byte-compatibly.


class KLLMsError(Exception):
    """Base typed error; subclasses pin ``type``/``code``/``status_code`` to
    the OpenAI wire values for the failure class they represent."""

    type: str = "api_error"
    code: Optional[str] = None
    status_code: int = 500

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def as_wire(self) -> Dict[str, Any]:
        """The OpenAI HTTP error body for this exception."""
        return {
            "error": {
                "message": self.message,
                "type": self.type,
                "code": self.code,
                "param": None,
            }
        }


class InvalidRequestError(KLLMsError):
    """Caller error: a parameter the backend cannot honor (e.g. ``stream=True``
    on a backend with no streaming path) or a malformed request body. OpenAI's
    ``invalid_request_error`` wire shape, HTTP 400. ``param`` names the
    offending field when known, so the wire body points at it."""

    type = "invalid_request_error"
    status_code = 400

    def __init__(self, message: str, param: Optional[str] = None, code: Optional[str] = None):
        super().__init__(message)
        self.param = param
        if code is not None:
            self.code = code

    def as_wire(self) -> Dict[str, Any]:
        body = super().as_wire()
        body["error"]["param"] = self.param
        return body


class RequestTimeoutError(KLLMsError):
    """Deadline exceeded — queued past its deadline, or cancelled at token
    granularity mid-decode (openai.APITimeoutError's wire shape)."""

    type = "timeout"
    code = "request_timeout"
    status_code = 408


class RequestCancelledError(KLLMsError):
    """Caller cancelled the request via its :class:`RequestBudget`."""

    type = "cancelled"
    code = "request_cancelled"
    status_code = 499  # nginx's client-closed-request; OpenAI has no cancel code


class BackendUnavailableError(KLLMsError):
    """The model engine cannot serve: circuit open, retries exhausted, or all
    samples lost (openai.InternalServerError / APIConnectionError class)."""

    type = "server_error"
    code = "backend_unavailable"
    status_code = 503


class NoHealthyReplicasError(BackendUnavailableError):
    """Every member of a :class:`ReplicaSet` is out of rotation (breaker open,
    supervisor RECOVERING, draining, or pulled after a dispatch failure) and no
    probe could bring one back. ``reasons`` maps replica id → why that member
    is unavailable, so the 503 body tells an operator which members to look at
    rather than just that the set is down."""

    code = "no_healthy_replicas"

    def __init__(self, message: str, reasons: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.reasons = dict(reasons or {})

    def as_wire(self) -> Dict[str, Any]:
        body = super().as_wire()
        body["error"]["replicas"] = dict(self.reasons)
        return body


class EngineHungError(BackendUnavailableError):
    """A device launch exceeded its wall-clock watchdog budget and was
    declared hung. The supervisor replays the work on a rebuilt engine, so
    callers normally never see this; it surfaces only when rebuild attempts
    are exhausted (then as the terminal member error). Subclasses
    BackendUnavailableError so every existing 503/breaker/retry treatment of
    an unavailable backend applies unchanged."""

    code = "engine_hung"


class CheckpointCorruptError(KLLMsError):
    """Weight integrity verification failed at load time: the checkpoint's
    bytes do not match its recorded checksums. Fail-fast and non-retryable —
    serving garbage weights is strictly worse than refusing to start."""

    type = "server_error"
    code = "checkpoint_corrupt"
    status_code = 500


class RateLimitError(KLLMsError):
    """Admission shed: the scheduler's queue is at its weight cap and this
    request was rejected instead of queued unboundedly (openai.RateLimitError's
    wire shape). ``retry_after`` is the scheduler's estimate, in seconds, of
    when the queue will have drained enough to admit work of this weight —
    serving frontends map it to the HTTP ``Retry-After`` header (OpenAI carries
    it as a header, not in the error body, so ``as_wire`` stays unchanged)."""

    type = "rate_limit_error"
    code = "rate_limit_exceeded"
    status_code = 429

    def __init__(self, message: str, retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = retry_after


class ServerDrainingError(KLLMsError):
    """The serving process is draining (or has stopped): admission is closed
    while in-flight work finishes. A load balancer should retry the request
    against another replica — hence 503, the standard drain signal."""

    type = "server_error"
    code = "server_draining"
    status_code = 503
