"""KLLMsChatCompletion — the consensus response contract.

Parity target: `k_llms/types/completions.py:7-15`. The contract
(`k-LLMs README.md:112-114`): ``choices[0]`` is the consolidated consensus
result, ``choices[1..n]`` are the n original samples, and ``likelihoods`` mirrors the
structure of the extracted object with per-field confidence scores.
"""

from typing import Any, Dict, Optional

from pydantic import Field


def _chat_completion_base():
    try:  # pragma: no cover
        from openai.types.chat import ChatCompletion  # type: ignore

        return ChatCompletion
    except ImportError:
        from .wire import ChatCompletion

        return ChatCompletion


class KLLMsChatCompletion(_chat_completion_base()):
    """Enhanced ChatCompletion that includes likelihoods for consensus results."""

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
            "samples survived (timeout, decode fault, failpoint). Carries "
            "requested/survived counts, the survival fraction the likelihoods "
            "were scaled by, and per-sample error records."
        ),
    )
