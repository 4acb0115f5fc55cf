"""Token-usage aggregation across the n samples.

Parity target: ``consolidate_consensus_usage`` at
`k_llms/utils/consensus_utils.py:1458-1516` (dead in-package
there; live here — the local engine reports real per-sample token counts and the
TPU backend sums them through this).
"""

from __future__ import annotations

from typing import List, Optional

from ..types import CompletionTokensDetails, CompletionUsage, PromptTokensDetails


def consolidate_consensus_usage(result_list: List) -> Optional[CompletionUsage]:
    """Sum prompt/completion/total token usage, including nested detail fields."""
    if not result_list:
        return None
    consensus_usage = CompletionUsage(prompt_tokens=0, completion_tokens=0, total_tokens=0)
    for model_result in result_list:
        usage = getattr(model_result, "usage", None)
        if usage is None:
            continue
        consensus_usage.prompt_tokens += usage.prompt_tokens or 0
        consensus_usage.completion_tokens += usage.completion_tokens or 0
        consensus_usage.total_tokens += usage.total_tokens or 0

        ptd = getattr(usage, "prompt_tokens_details", None)
        if ptd is not None:
            if consensus_usage.prompt_tokens_details is None:
                consensus_usage.prompt_tokens_details = PromptTokensDetails()
            for field in ("audio_tokens", "cached_tokens"):
                val = getattr(ptd, field, None)
                if val is not None:
                    cur = getattr(consensus_usage.prompt_tokens_details, field) or 0
                    setattr(consensus_usage.prompt_tokens_details, field, cur + val)

        ctd = getattr(usage, "completion_tokens_details", None)
        if ctd is not None:
            if consensus_usage.completion_tokens_details is None:
                consensus_usage.completion_tokens_details = CompletionTokensDetails()
            for field in (
                "audio_tokens",
                "accepted_prediction_tokens",
                "rejected_prediction_tokens",
                "reasoning_tokens",
            ):
                val = getattr(ctd, field, None)
                if val is not None:
                    cur = getattr(consensus_usage.completion_tokens_details, field) or 0
                    setattr(consensus_usage.completion_tokens_details, field, cur + val)

    return consensus_usage
