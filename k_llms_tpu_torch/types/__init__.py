"""Public return types: the k-LLMs response contract.

Prefers the real ``openai`` package's models when available (drop-in identical to the
reference, `k_llms/types/*.py`); otherwise uses the vendored replicas
in :mod:`k_llms_tpu_torch.types.wire`.
"""

try:  # pragma: no cover - exercised only when openai is installed
    from openai.types.chat import ChatCompletion, ParsedChatCompletion  # type: ignore
    from openai.types.chat.chat_completion import Choice  # type: ignore
    from openai.types.chat import ChatCompletionMessage  # type: ignore
    from openai.types.chat.parsed_chat_completion import (  # type: ignore
        ParsedChatCompletionMessage,
        ParsedChoice,
    )
    from openai.types.chat.chat_completion import ChoiceLogprobs  # type: ignore
    from openai.types.completion_usage import (  # type: ignore
        CompletionTokensDetails,
        CompletionUsage,
        PromptTokensDetails,
    )

    HAVE_OPENAI = True
except ImportError:  # vendored fallback
    from .wire import (
        ChatCompletion,
        ChatCompletionMessage,
        Choice,
        ChoiceLogprobs,
        CompletionTokensDetails,
        CompletionUsage,
        ParsedChatCompletion,
        ParsedChatCompletionMessage,
        ParsedChoice,
        PromptTokensDetails,
    )

    HAVE_OPENAI = False

from .completions import KLLMsChatCompletion
from .parsed import KLLMsParsedChatCompletion

# Typed request-lifecycle errors are always ours (the openai package's
# exceptions wrap httpx responses we don't have), vendored in wire.py.
from .wire import (
    BackendUnavailableError,
    KLLMsError,
    RateLimitError,
    RequestCancelledError,
    RequestTimeoutError,
    ServerDrainingError,
)

__all__ = [
    "BackendUnavailableError",
    "KLLMsError",
    "RateLimitError",
    "RequestCancelledError",
    "RequestTimeoutError",
    "ServerDrainingError",
    "ChatCompletion",
    "ChatCompletionMessage",
    "Choice",
    "ChoiceLogprobs",
    "CompletionTokensDetails",
    "CompletionUsage",
    "HAVE_OPENAI",
    "KLLMsChatCompletion",
    "KLLMsParsedChatCompletion",
    "ParsedChatCompletion",
    "ParsedChatCompletionMessage",
    "ParsedChoice",
    "PromptTokensDetails",
]
