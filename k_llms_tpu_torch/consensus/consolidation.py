"""Rebuild a KLLMs(Parsed)ChatCompletion from n samples + consensus.

Parity target: `k_llms/utils/consolidation.py` —
``_safe_parse_content`` :25-38, ``_format_consensus_content`` :41-60,
``consolidate_chat_completions`` :63-216 (single-choice passthrough, align,
consensus, choice rebuild with consensus at index 0 and originals at 1..n),
``consolidate_parsed_chat_completions`` :306-399 (re-validates the consensus dict
into the user's Pydantic ``response_format``, silently None on failure :356-365).

The reference's async twins (:219-303, :402-493) duplicate the algorithm line for
line; here they are ``asyncio.to_thread`` adapters over the one sync core — the
local TPU engine launches device work once and is internally parallel, so there is
nothing to interleave per string pair (SURVEY.md §3.3).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional, Type, Union

from pydantic import BaseModel

from ..reliability import failpoints as _failpoints
from ..reliability.deadline import RequestBudget
from ..types import (
    BackendUnavailableError,
    ChatCompletion,
    ChatCompletionMessage,
    Choice,
    KLLMsChatCompletion,
    KLLMsParsedChatCompletion,
    ParsedChatCompletion,
    ParsedChatCompletionMessage,
    ParsedChoice,
    RequestTimeoutError,
)
from ..utils.observability import FAILURE_EVENTS
from .primitive import LlmConsensusFn
from .recursion import consensus_values, recursive_list_alignments
from .settings import ConsensusSettings
from .similarity import SimilarityScorer


def _safe_parse_content(content: str) -> Dict[str, Any]:
    """Parse content as JSON; wrap free text as {"text": content} on failure."""
    try:
        return json.loads(content)
    except (json.JSONDecodeError, TypeError):
        return {"text": content}


def _format_consensus_content(consensus_content: Optional[Dict[str, Any]]) -> str:
    """Unwrap the {"text": ...} free-form wrapper; JSON-encode everything else."""
    if consensus_content is None:
        return ""
    if (
        isinstance(consensus_content, dict)
        and len(consensus_content) == 1
        and "text" in consensus_content
        and isinstance(consensus_content["text"], str)
    ):
        return consensus_content["text"]
    return json.dumps(consensus_content)


def _collect_strings(node: Any, out: Optional[List[str]] = None) -> List[str]:
    """All string values in a nested structure (for embedding prefetch)."""
    if out is None:
        out = []
    if isinstance(node, str):
        out.append(node)
    elif isinstance(node, dict):
        for v in node.values():
            _collect_strings(v, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _collect_strings(v, out)
    return out


def _sample_weights(choices, contents_mask: List[bool]) -> Optional[List[float]]:
    """Softmax of per-sample sequence logprobs (the engine attaches
    ``sample_logprob`` to each choice); None when any sample lacks one."""
    logprobs = []
    for choice, used in zip(choices, contents_mask):
        if not used:
            continue
        lp = getattr(choice, "sample_logprob", None)
        if lp is None:
            return None
        logprobs.append(float(lp))
    if not logprobs:
        return None
    import math

    mx = max(logprobs)
    exps = [math.exp(lp - mx) for lp in logprobs]
    total = sum(exps)
    return [e / total for e in exps]


def _consensus_over_contents(
    contents: List[Dict[str, Any]],
    scorer: SimilarityScorer,
    consensus_settings: ConsensusSettings,
    llm_consensus_fn: Optional[LlmConsensusFn],
    weights: Optional[List[float]] = None,
):
    """Shared align-then-vote step over parsed choice contents."""
    if len(contents) >= 2:
        # Pre-alignment hook: host scorers batch-prefetch embeddings; the
        # device scorer additionally computes all pairwise field similarities
        # in batched JAX kernels on the chip (consensus/device.py).
        scorer.prepare(contents)
        if consensus_settings.aligner == "key":
            # Swap point (reference `consolidation.py:22`): key-based aligner
            # behind the same signature.
            from ..keyalign import recursive_align

            aligned_seq, _ = recursive_align(
                contents,
                consensus_settings.string_similarity_method,
                consensus_settings.min_support_ratio,
            )
        else:
            aligned_seq, _ = recursive_list_alignments(
                contents,
                scorer,
                consensus_settings.min_support_ratio,
                refinement_rounds=consensus_settings.effective_refinement_rounds,
            )
        contents = list(aligned_seq)
        if not (consensus_settings.likelihood_weighting and weights):
            # Post-alignment hook: the device scorer batch-votes the aligned
            # enum columns in one kernel call (host scorers: no-op). Weighted
            # voting stays host-side, so skip the prefill there.
            scorer.prepare_aligned(contents, consensus_settings)
    return consensus_values(
        contents,
        consensus_settings,
        scorer,
        llm_consensus_fn=llm_consensus_fn,
        weights=weights if consensus_settings.likelihood_weighting else None,
    )


def _consensus_with_degrade(
    contents: List[Any],
    texts: List[str],
    scorer: SimilarityScorer,
    consensus_settings: ConsensusSettings,
    llm_consensus_fn: Optional[LlmConsensusFn],
    weights: Optional[List[float]] = None,
):
    """Consensus with the wire-contract crash-rescue: when top-level contents
    are bare JSON primitives/lists (a model answering "5" or "[1, 2]"), the
    likelihood structure is not the dict ``KLLMsChatCompletion`` requires —
    the reference CRASHES here (`types/completions.py:13-15`). Degrade such
    content to free-text consensus ({"text": ...}), the same treatment
    non-JSON content gets; if even that yields nothing (all samples empty),
    fall back to (None, None) — likelihoods is Optional on the wire."""
    consensus_content, likelihoods = _consensus_over_contents(
        contents, scorer, consensus_settings, llm_consensus_fn, weights=weights
    )
    if isinstance(likelihoods, dict):
        return consensus_content, likelihoods
    if texts:
        consensus_content, likelihoods = _consensus_over_contents(
            [{"text": t} for t in texts],
            scorer,
            consensus_settings,
            llm_consensus_fn,
            weights=weights,
        )
        if isinstance(likelihoods, dict):
            return consensus_content, likelihoods
    return None, None


def _degraded_info(choices) -> Optional[Dict[str, Any]]:
    """Partial-failure accounting from the backend's per-choice
    ``sample_error`` extensions (samples lost mid-decode to a fault, abort,
    injected kill, or the numeric-integrity quarantine's ``numeric_poison``
    code — a sample whose logits went NaN/Inf/degenerate mid-decode and was
    excluded rather than allowed to vote garbage). None when every sample is
    healthy. Distinct from a sample that merely returned EMPTY content — that
    is a model outcome, not a failure, and must not trigger degraded marking
    or likelihood scaling. ``error_codes`` breaks the losses down by typed
    code so operators can tell quarantine from timeouts at a glance."""
    errors: List[Dict[str, Any]] = []
    for i, choice in enumerate(choices):
        err = getattr(choice, "sample_error", None)
        if err:
            errors.append({"sample_index": i, **dict(err)})
    if not errors:
        return None
    requested = len(choices)
    survived = requested - len(errors)
    by_code: Dict[str, int] = {}
    for e in errors:
        code = str(e.get("code") or "unknown")
        by_code[code] = by_code.get(code, 0) + 1
    return {
        "requested": requested,
        "survived": survived,
        "survival_fraction": survived / requested,
        "sample_errors": errors,
        "error_codes": by_code,
    }


def _raise_if_no_survivors(
    degraded: Optional[Dict[str, Any]], budget: Optional[RequestBudget]
) -> None:
    """Zero survivors is not a consensus, it is a failure: raise the typed
    error that best describes WHY (caller's budget verdict wins; otherwise
    homogeneous timeout losses surface as timeout, anything else as a
    backend fault)."""
    if degraded is None or degraded["survived"] > 0:
        return
    FAILURE_EVENTS.record("consensus.zero_survivors")
    if budget is not None and budget.should_abort():
        raise budget.error("consolidation")
    codes = {e.get("code") for e in degraded["sample_errors"]}
    n = degraded["requested"]
    if codes <= {"request_timeout"}:
        raise RequestTimeoutError(f"all {n} samples timed out before completing")
    raise BackendUnavailableError(f"all {n} samples failed during generation")


def _scale_tree(node: Any, frac: float) -> Any:
    """Scale every confidence in a likelihoods tree by the survival fraction:
    agreement among r of n requested samples is weaker evidence than the same
    agreement among all n, and the scores must say so."""
    if isinstance(node, dict):
        return {k: _scale_tree(v, frac) for k, v in node.items()}
    if isinstance(node, list):
        return [_scale_tree(v, frac) for v in node]
    if isinstance(node, (int, float)) and not isinstance(node, bool):
        return float(node) * frac
    return node


def consolidate_chat_completions(
    completions: Union[List[ChatCompletion], ChatCompletion],
    scorer: SimilarityScorer,
    consensus_settings: ConsensusSettings = ConsensusSettings(),
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
    budget: Optional[RequestBudget] = None,
) -> KLLMsChatCompletion:
    """Consolidate one multi-choice completion (or a list of completions) into a
    KLLMsChatCompletion: choices[0] = consensus, choices[1..n] = originals."""
    _failpoints.fire("consensus.consolidate")
    if isinstance(completions, ChatCompletion):
        completion = completions
        assert len(completion.choices) > 0, "Cannot consolidate empty list of choices"

        degraded = _degraded_info(completion.choices)
        _raise_if_no_survivors(degraded, budget)

        if len(completion.choices) == 1:
            return KLLMsChatCompletion.model_validate(completion.model_dump())

        choice_contents: List[Dict[str, Any]] = []
        used_mask: List[bool] = []
        for choice in completion.choices:
            used = bool(choice.message.content)
            used_mask.append(used)
            if used:
                choice_contents.append(_safe_parse_content(choice.message.content))

        consensus_content, likelihoods = _consensus_with_degrade(
            choice_contents,
            [
                str(choice.message.content)
                for choice, used in zip(completion.choices, used_mask)
                if used
            ],
            scorer,
            consensus_settings,
            llm_consensus_fn,
            weights=_sample_weights(completion.choices, used_mask),
        )

        if degraded is not None and isinstance(likelihoods, dict):
            likelihoods = _scale_tree(likelihoods, degraded["survival_fraction"])

        return _rebuild_completion(
            completion,
            list(enumerate(completion.choices)),
            consensus_content,
            likelihoods,
            degraded=degraded,
        )

    # List-of-completions form: one sample per completion's first choice.
    completion_list = completions
    assert len(completion_list) > 0, "Cannot consolidate empty list of completions"

    degraded = _degraded_info(
        [c.choices[0] for c in completion_list if c.choices]
    )
    _raise_if_no_survivors(degraded, budget)

    if len(completion_list) == 1:
        return KLLMsChatCompletion.model_validate(completion_list[0].model_dump())

    completion_contents: List[Dict[str, Any]] = []
    for completion in completion_list:
        if completion.choices and completion.choices[0].message.content:
            completion_contents.append(_safe_parse_content(completion.choices[0].message.content))

    consensus_content, likelihoods = _consensus_with_degrade(
        completion_contents,
        [
            str(c.choices[0].message.content)
            for c in completion_list
            if c.choices and c.choices[0].message.content
        ],
        scorer,
        consensus_settings,
        llm_consensus_fn,
    )

    if degraded is not None and isinstance(likelihoods, dict):
        likelihoods = _scale_tree(likelihoods, degraded["survival_fraction"])

    return _rebuild_completion(
        completion_list[0],
        [(i, c.choices[0]) for i, c in enumerate(completion_list) if c.choices],
        consensus_content,
        likelihoods,
        degraded=degraded,
    )


def _rebuild_completion(
    base_completion,
    original_choices,
    consensus_content,
    likelihoods,
    *,
    message_cls=ChatCompletionMessage,
    choice_cls=Choice,
    result_cls=KLLMsChatCompletion,
    parsed=None,
    include_parsed: bool = False,
    degraded: Optional[Dict[str, Any]] = None,
):
    """Assemble the wire-contract result shared by every consolidation shape:
    choices[0] = the consensus, rebuilt around the base choice's metadata
    (finish_reason/logprobs/tool fields, README.md:112-114); choices[1..n] =
    the originals re-indexed — rebuilt from dumps so extension fields (e.g.
    the engine's sample_logprob) survive — plus the likelihoods tree."""
    base_choice = base_completion.choices[0] if base_completion.choices else None
    msg_kwargs = dict(
        role="assistant",
        content=_format_consensus_content(consensus_content),
        function_call=base_choice.message.function_call if base_choice else None,
        tool_calls=base_choice.message.tool_calls if base_choice else None,
        refusal=base_choice.message.refusal if base_choice else None,
    )
    if include_parsed:
        msg_kwargs["parsed"] = parsed
    consolidated_choice = choice_cls(
        finish_reason=base_choice.finish_reason if base_choice else "stop",
        index=0,
        message=message_cls(**msg_kwargs),
        logprobs=base_choice.logprobs if base_choice else None,
    )
    # ``original_choices``: (original sample position, choice) pairs — indexes
    # must track the ORIGINATING sample, not compact over skipped (empty)
    # samples, or downstream index-keyed correlation silently misattributes.
    individual_choices = [
        choice_cls.model_validate({**c.model_dump(), "index": i + 1})
        for i, c in original_choices
    ]
    return result_cls.model_validate(
        {
            **base_completion.model_dump(),
            "choices": [c.model_dump() for c in [consolidated_choice] + individual_choices],
            "likelihoods": likelihoods,
            "degraded": degraded,
            "usage": base_completion.usage.model_dump() if base_completion.usage else None,
        }
    )


def consolidate_parsed_chat_completions(
    completion: ParsedChatCompletion,
    scorer: SimilarityScorer,
    consensus_settings: ConsensusSettings = ConsensusSettings(),
    response_format: Optional[Type[BaseModel]] = None,
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
    budget: Optional[RequestBudget] = None,
) -> KLLMsParsedChatCompletion:
    """Structured-output variant: the consensus dict is re-validated into the
    user's ``response_format`` model; ``parsed`` is silently None on failure."""
    _failpoints.fire("consensus.consolidate")
    assert len(completion.choices) > 0, "Cannot consolidate empty list of choices"

    degraded = _degraded_info(completion.choices)
    _raise_if_no_survivors(degraded, budget)

    if len(completion.choices) == 1:
        result = KLLMsParsedChatCompletion.model_validate(completion.model_dump())
        _fill_parsed(result.choices, response_format)
        return result

    parsed_choice_contents: List[Dict[str, Any]] = []
    used_mask: List[bool] = []
    for choice in completion.choices:
        used = bool(choice.message.content)
        used_mask.append(used)
        if used:
            parsed_choice_contents.append(_safe_parse_content(choice.message.content))

    consensus_content, likelihoods = _consensus_with_degrade(
        parsed_choice_contents,
        [
            str(choice.message.content)
            for choice, used in zip(completion.choices, used_mask)
            if used
        ],
        scorer,
        consensus_settings,
        llm_consensus_fn,
        weights=_sample_weights(completion.choices, used_mask),
    )

    if degraded is not None and isinstance(likelihoods, dict):
        likelihoods = _scale_tree(likelihoods, degraded["survival_fraction"])

    parsed_consensus = None
    if response_format and consensus_content is not None:
        try:
            if isinstance(response_format, type) and issubclass(response_format, BaseModel):
                parsed_consensus = response_format.model_validate(consensus_content)
        except Exception:
            parsed_consensus = None

    result = _rebuild_completion(
        completion,
        list(enumerate(completion.choices)),
        consensus_content,
        likelihoods,
        message_cls=ParsedChatCompletionMessage,
        choice_cls=ParsedChoice,
        result_cls=KLLMsParsedChatCompletion,
        parsed=parsed_consensus,
        include_parsed=True,
        degraded=degraded,
    )
    # model_dump flattened `parsed` to a dict; restore the validated model object
    # on the consensus choice (the reference keeps the live object because openai's
    # ParsedChatCompletion generics re-validate; our vendored generic stores Any).
    if parsed_consensus is not None:
        result.choices[0].message.parsed = parsed_consensus
    _fill_parsed(result.choices[1:], response_format)
    return result


def _fill_parsed(choices, response_format: Optional[Type[BaseModel]]) -> None:
    """Validate raw sample text into ``response_format`` in place.

    The reference's originals arrive server-parsed (completions.py:134); our
    local backend emits plain text, so the parse happens here — same
    silent-None degradation as the consensus choice.
    """
    if not (
        response_format
        and isinstance(response_format, type)
        and issubclass(response_format, BaseModel)
    ):
        return
    for choice in choices:
        if choice.message.parsed is None and choice.message.content:
            try:
                choice.message.parsed = response_format.model_validate(
                    _safe_parse_content(choice.message.content)
                )
            except Exception:
                pass


async def async_consolidate_chat_completions(
    completion: ChatCompletion,
    scorer: SimilarityScorer,
    consensus_settings: ConsensusSettings = ConsensusSettings(),
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
) -> KLLMsChatCompletion:
    """Async adapter over the sync core (runs in a worker thread)."""
    return await asyncio.to_thread(
        consolidate_chat_completions,
        completion,
        scorer,
        consensus_settings,
        llm_consensus_fn,
    )


async def async_consolidate_parsed_chat_completions(
    completion: ParsedChatCompletion,
    scorer: SimilarityScorer,
    consensus_settings: ConsensusSettings = ConsensusSettings(),
    response_format: Optional[Type[BaseModel]] = None,
    llm_consensus_fn: Optional[LlmConsensusFn] = None,
) -> KLLMsParsedChatCompletion:
    """Async adapter over the sync core (runs in a worker thread)."""
    return await asyncio.to_thread(
        consolidate_parsed_chat_completions,
        completion,
        scorer,
        consensus_settings,
        response_format,
        llm_consensus_fn,
    )
