"""KLLMsParsedChatCompletion — consensus response contract for structured outputs.

Parity target: `k_llms/types/parsed.py:7-15`.
``choices[0].message.parsed`` holds the consensus object re-validated into the user's
``response_format`` model (`k-LLMs README.md:77-78`).
"""

from typing import Any, Dict, Optional

from pydantic import Field


def _parsed_chat_completion_base():
    try:  # pragma: no cover
        from openai.types.chat import ParsedChatCompletion  # type: ignore

        return ParsedChatCompletion
    except ImportError:
        from .wire import ParsedChatCompletion

        return ParsedChatCompletion


class KLLMsParsedChatCompletion(_parsed_chat_completion_base()):
    """Enhanced ParsedChatCompletion that includes likelihoods for consensus results."""

    likelihoods: Optional[Dict[str, Any]] = Field(
        default=None,
        description=(
            "Object defining the uncertainties of the fields extracted when using "
            "consensus. Follows the same structure as the extraction object."
        ),
    )

    degraded: Optional[Dict[str, Any]] = Field(
        default=None,
        description=(
            "Partial-failure marker: present when fewer than the requested n "
            "samples survived; see KLLMsChatCompletion.degraded."
        ),
    )
