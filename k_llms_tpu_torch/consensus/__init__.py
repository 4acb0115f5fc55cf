"""Host-side k-way consensus engine.

Behavioral-parity reimplementation of the reference consensus stack
(`k_llms/utils/consensus_utils.py`, `majority_sorting.py`,
`consolidation.py`) restructured for a local TPU backend:

- one sync core engine (the reference's 750-line async mirror collapses into thin
  adapters — device work is launched once and is internally parallel);
- similarity is provided by a pluggable :class:`SimilarityScorer` instead of a
  hardwired OpenAI-embeddings callback, so the TPU backend can plug in on-device
  embeddings and a local llm-consensus model;
- the scalar hot loops (Levenshtein, Hungarian assignment) call into native C++
  (``k_llms_tpu_torch.native``) with pure-Python fallbacks.
"""

from .settings import ConsensusSettings, SIMILARITY_SCORE_LOWER_BOUND
from .similarity import SimilarityScorer
from .voting import voting_consensus, sanitize_value
from .primitive import compute_similarity_scores, consensus_as_primitive
from .majority import sort_by_original_majority
from .alignment import lists_alignment
from .recursion import (
    consensus_dict,
    consensus_list,
    consensus_values,
    intermediary_consensus_cleanup,
    recursive_list_alignments,
)
from .consolidation import (
    consolidate_chat_completions,
    consolidate_parsed_chat_completions,
    async_consolidate_chat_completions,
    async_consolidate_parsed_chat_completions,
)
from .usage import consolidate_consensus_usage

__all__ = [
    "ConsensusSettings",
    "SIMILARITY_SCORE_LOWER_BOUND",
    "SimilarityScorer",
    "voting_consensus",
    "sanitize_value",
    "compute_similarity_scores",
    "consensus_as_primitive",
    "intermediary_consensus_cleanup",
    "sort_by_original_majority",
    "lists_alignment",
    "consensus_dict",
    "consensus_list",
    "consensus_values",
    "recursive_list_alignments",
    "consolidate_chat_completions",
    "consolidate_parsed_chat_completions",
    "async_consolidate_chat_completions",
    "async_consolidate_parsed_chat_completions",
    "consolidate_consensus_usage",
]
