"""Consensus knobs.

Parity target: ``ConsensusSettings`` at
`k_llms/utils/consensus_utils.py:53-69`. Every default here is
load-bearing — the dynamic alignment threshold, numeric clustering, and vote
thresholds are tuned around them (SURVEY.md §2.2).
"""

from typing import Literal, Optional

from pydantic import BaseModel

StringSimilarityMethod = Literal["levenshtein", "jaccard", "hamming", "embeddings"]
StringConsensusMethod = Literal["centroid", "llm-consensus"]
AlignerMethod = Literal["similarity", "key"]

# Floor used everywhere a similarity must stay strictly positive
# (reference `consensus_utils.py:78`).
SIMILARITY_SCORE_LOWER_BOUND = 1e-8

# Keys matched by these regexes are skipped during dict similarity
# (reference `consensus_utils.py:38-43`; matching is `re.match`, i.e. anchored at
# the start of the key).
IGNORED_KEY_PATTERNS = [
    r"reasoning___",
    r"source___",
]

# Prefixes skipped entirely during dict consensus (reference
# `consensus_utils.py:1287`; matching is substring containment there).
SPECIAL_FIELD_PREFIXES = ["reasoning___", "source___"]


class ConsensusSettings(BaseModel):
    # Posture switch. The reference's greedy alignment pass is
    # order-dependent: at high n one true cluster can fragment into groups that
    # each miss min_support_ratio and get pruned (its headline n=32 config
    # scores BELOW its own n=8 because of it), and its first-seen spelling rule
    # lets one case-mangled sample speak for a whole vote bucket. By DEFAULT
    # this framework fixes both (refinement rounds + canonical spelling below
    # resolve to 2/True), which is monotone in n and beats the reference at
    # every n on the bench's structured-extraction suite. Set
    # ``reference_exact=True`` to reproduce the reference's behavior bit-for-
    # bit instead — the differential oracle suite pins that mode.
    reference_exact: bool = False
    allow_none_as_candidate: bool = False
    # Structural aligner: "similarity" (default pipeline) or "key" (the latent
    # key-based aligner — the reference's swap point at `consolidation.py:22`).
    aligner: AlignerMethod = "similarity"
    # Strictly-additional mode (BASELINE.json config 3): weight each sample's
    # vote by softmax of its sequence log-likelihood (captured on-device by the
    # local engine). False = reference-exact agreement scoring.
    likelihood_weighting: bool = False
    # String-specific settings
    string_similarity_method: StringSimilarityMethod = "embeddings"
    string_consensus_method: StringConsensusMethod = "centroid"
    # Align objects with a minimum similarity threshold
    minimum_voters_threshold: float = 0.75
    min_support_ratio: float = 0.51  # at least 51% of the voters must agree
    # Numeric consensus parameters (hybrid vote-or-mean)
    rel_eps: float = 0.03  # relative closeness (e.g. 3%)
    abs_eps: float = 1e-6  # absolute closeness to protect near zero
    # Majority threshold for voting (slightly easier for small n if maj_loosen_k>0)
    base_maj_thresh: float = 0.6
    maj_loosen_k: float = 0.1
    # Global refinement passes after the greedy reference election. The
    # reference's single greedy scan (consensus_utils.py:255-333) is
    # order-dependent: at high n one true cluster can fragment into several
    # groups that each miss min_support_ratio and get pruned, silently
    # dropping list rows the majority of samples agree on. Each refinement
    # round re-assigns every element to its best stable medoid representative
    # and re-elects medoids, undoing the fragmentation. None = auto: 2 unless
    # ``reference_exact`` (0 reproduces the reference's single greedy scan).
    alignment_refinement_rounds: Optional[int] = None
    # Report vote/medoid winners in the bucket's most COMMON exact spelling
    # instead of the first-seen one. The reference returns the first original
    # whose sanitized form matches the winning key (consensus_utils.py:970),
    # so a case-mangled sample that happens to sit first speaks for the whole
    # bucket; with this knob the majority spelling wins and that error rate
    # decays with n instead of staying constant. None = auto: True unless
    # ``reference_exact``.
    canonical_spelling: Optional[bool] = None
    # Robust mean (used only when n >= 5)
    trim_frac: float = 0.2

    @property
    def effective_refinement_rounds(self) -> int:
        """Alignment refinement rounds after auto-resolution (see
        ``alignment_refinement_rounds``). Use-site accessor so every consumer
        applies the same posture rule."""
        if self.alignment_refinement_rounds is not None:
            return self.alignment_refinement_rounds
        return 0 if self.reference_exact else 2

    @property
    def effective_canonical_spelling(self) -> bool:
        """Canonical-spelling election after auto-resolution (see
        ``canonical_spelling``)."""
        if self.canonical_spelling is not None:
            return self.canonical_spelling
        return not self.reference_exact
