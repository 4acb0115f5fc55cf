"""Consensus-quality evaluation: does k-way consensus beat one sample?

The reference's (missing) benchmark suite reports a consensus "quality" score
(~0.85 for n=3 extraction, `k-LLMs README_TESTS.md:205-214`) but ships
no way to reproduce it. This module is the hermetic equivalent: corrupt a known
ground-truth extraction JSON with a scripted noise model, run the REAL public
pipeline (``KLLMs(backend="fake")`` → consolidation → consensus), and score the
consensus object's leaf-field accuracy against the truth — alongside the
single-sample baseline the consensus must beat.

Its tests are ``tests/test_torch_quality_eval.py``.
"""

from __future__ import annotations

import json
import math
import random
import string
from typing import Any, Dict, List, Optional, Tuple

# A realistic extraction target: mixed primitive types, an enum-ish field, a
# nested list of records — the shapes the consensus engine dispatches on
# (voting / numeric clustering / similarity medoid / list alignment).
DEFAULT_TRUTH: Dict[str, Any] = {
    "vendor": "Acme Corporation International",
    "invoice_number": "INV-2024-00417",
    "date": "2024-03-03",
    "currency": "USD",
    "total": 4310.55,
    "paid": False,
    "contact": "billing@acme.example",
    "line_items": [
        {"description": "Industrial widget, stainless", "quantity": 12, "unit_price": 149.5},
        {"description": "Express shipping and handling", "quantity": 1, "unit_price": 89.0},
        {"description": "Extended warranty, 24 months", "quantity": 12, "unit_price": 35.05},
    ],
}

# Distinct document shapes so the eval is not tuned to one structure
# (at least three truth documents): a purchase order heavy on enums/booleans
# and a long-list shape, and a candidate profile with long free-text strings
# (exercising the >50-char embeddings gate) and a deeply nested record.
PO_TRUTH: Dict[str, Any] = {
    "po_number": "PO-88-3312",
    "status": "approved",
    "expedited": True,
    "buyer": {"name": "Dana Whitfield", "department": "Facilities Operations"},
    "approvals": ["manager", "finance", "legal"],
    "items": [
        {"sku": "CHR-0042", "name": "Ergonomic task chair", "qty": 24, "price": 219.99, "in_stock": True},
        {"sku": "DSK-1107", "name": "Standing desk, walnut", "qty": 24, "price": 540.0, "in_stock": False},
        {"sku": "LMP-0093", "name": "LED desk lamp", "qty": 30, "price": 42.5, "in_stock": True},
        {"sku": "CBL-2210", "name": "Cable management tray", "qty": 48, "price": 18.75, "in_stock": True},
    ],
}

PROFILE_TRUTH: Dict[str, Any] = {
    "name": "Priya Raghunathan",
    "headline": "Staff infrastructure engineer focused on large-scale stream processing and storage",
    "years_experience": 11,
    "remote": False,
    "summary": (
        "Led the migration of a petabyte-scale event pipeline onto a tiered "
        "object-storage architecture, cutting storage spend by forty percent"
    ),
    "skills": ["distributed systems", "capacity planning", "incident response"],
    "positions": [
        {
            "company": "Meridian Data Systems",
            "title": "Staff Engineer",
            "start_year": 2021,
            "achievement": "Designed the cross-region replication layer that now carries all production traffic",
        },
        {
            "company": "Halcyon Analytics",
            "title": "Senior Engineer",
            "start_year": 2017,
            "achievement": "Rebuilt the ingestion tier around idempotent batch commits, halving duplicate rates",
        },
    ],
}

TRUTH_DOCS: Dict[str, Dict[str, Any]] = {
    "invoice": DEFAULT_TRUTH,
    "purchase_order": PO_TRUTH,
    "profile": PROFILE_TRUTH,
}


# ---------------------------------------------------------------------------
# Noise model
# ---------------------------------------------------------------------------

def _corrupt_string(s: str, rng: random.Random) -> str:
    roll = rng.random()
    if not s:
        return "unknown"
    if roll < 0.3:  # typo: swap two adjacent characters
        i = rng.randrange(max(1, len(s) - 1))
        return s[:i] + s[i + 1 : i + 2] + s[i : i + 1] + s[i + 2 :]
    if roll < 0.5:  # drop a character
        i = rng.randrange(len(s))
        return s[:i] + s[i + 1 :]
    if roll < 0.7:  # case mangle
        return s.swapcase()
    if roll < 0.9:  # insert noise character
        i = rng.randrange(len(s) + 1)
        return s[:i] + rng.choice(string.ascii_lowercase) + s[i:]
    return "".join(rng.sample(s, len(s)))  # scramble


def _corrupt_number(x: float, rng: random.Random):
    roll = rng.random()
    if roll < 0.3:  # small relative error (beyond the 3% cluster eps)
        return round(x * (1 + rng.choice([-1, 1]) * rng.uniform(0.08, 0.5)), 2)
    if roll < 0.5:  # order-of-magnitude slip
        return round(x * rng.choice([0.1, 10.0]), 2)
    if roll < 0.7:  # digit-level perturbation
        return round(x + rng.choice([-1, 1]) * rng.uniform(1, 9), 2)
    if roll < 0.85:
        return None
    return round(rng.uniform(0, 2 * abs(x) + 1), 2)  # unrelated value


def _corrupt_value(value: Any, rng: random.Random, noise: float) -> Any:
    """Corrupt one leaf with probability ``noise`` (containers recurse)."""
    if isinstance(value, dict):
        return {k: _corrupt_value(v, rng, noise) for k, v in value.items()}
    if isinstance(value, list):
        out = [_corrupt_value(v, rng, noise) for v in value]
        if rng.random() < noise * 0.6 and len(out) > 1:  # drop an element
            out.pop(rng.randrange(len(out)))
        if rng.random() < noise * 0.4:  # shuffle order (alignment must undo)
            rng.shuffle(out)
        return out
    if rng.random() >= noise:
        return value
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return _corrupt_number(float(value), rng)
    if isinstance(value, str):
        return _corrupt_string(value, rng)
    return value


def make_noisy_samples(
    truth: Dict[str, Any], n: int, noise: float, seed: int
) -> List[str]:
    """n JSON strings, each an independently corrupted copy of ``truth``."""
    rng = random.Random(seed)
    return [json.dumps(_corrupt_value(truth, rng, noise)) for _ in range(n)]


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def _leaves(obj: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(obj, dict):
        out = []
        for k, v in obj.items():
            out.extend(_leaves(v, path + (k,)))
        return out
    if isinstance(obj, list):
        out = []
        for i, v in enumerate(obj):
            out.extend(_leaves(v, path + (i,)))
        return out
    return [(path, obj)]


def _lookup(obj: Any, path: Tuple) -> Any:
    for p in path:
        if isinstance(obj, dict):
            obj = obj.get(p)
        elif isinstance(obj, list) and isinstance(p, int) and p < len(obj):
            obj = obj[p]
        else:
            return None
    return obj


def field_accuracy(pred: Any, truth: Dict[str, Any]) -> float:
    """Fraction of ground-truth LEAF fields reproduced exactly (floats within
    0.5%). Missing paths count as wrong — dropped list rows are penalized."""
    leaves = _leaves(truth)
    if not leaves:
        return 1.0
    correct = 0
    for path, want in leaves:
        got = _lookup(pred, path)
        if isinstance(want, bool) or not isinstance(want, (int, float)):
            correct += got == want
        else:
            correct += isinstance(got, (int, float)) and not isinstance(got, bool) and (
                math.isclose(float(got), float(want), rel_tol=0.005, abs_tol=1e-9)
            )
    return correct / len(leaves)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

def consensus_quality_eval(
    n_values: Tuple[int, ...] = (1, 3, 8, 32),
    trials: int = 20,
    noise: float = 0.15,
    seed: int = 0,
    truth: Optional[Dict[str, Any]] = None,
    consensus_settings=None,
) -> Dict[str, float]:
    """Run the full public pipeline on scripted noisy samples and score it.

    Returns {"single_sample": baseline_acc, "consensus_n3": ..., ...}: the
    baseline is the mean accuracy of every ORIGINAL sample (what you'd get
    asking once); consensus_nK is the accuracy of choices[0] after k-way
    consolidation. The reference's comparable number is quality ~0.85
    (`README_TESTS.md:212`); the default noise level is calibrated so the
    single-sample baseline sits near the reference's single-request quality
    (~0.85, `README_TESTS.md:136-141`). Consensus outputs on this noise model
    are differentially verified bit-identical to the reference engine's, so
    the gap measured here is the algorithm's true value-add, not an artifact
    of this implementation.
    """
    from ..backends.fake import FakeBackend
    from ..client import KLLMs

    # One explicit truth keeps the old single-document behavior; default runs
    # every document in TRUTH_DOCS and averages (each doc weighs equally).
    docs = {"truth": truth} if truth is not None else TRUTH_DOCS
    results: Dict[str, float] = {}
    single_accs: List[float] = []

    for n in n_values:
        cons_accs: List[float] = []
        for doc_idx, doc in enumerate(docs.values()):
            for t in range(trials):
                samples = make_noisy_samples(doc, n, noise, seed + 1000 * t + n + 77777 * doc_idx)
                client = KLLMs(backend=FakeBackend(responses=[samples]), model="m")
                resp = client.chat.completions.create(
                    messages=[{"role": "user", "content": "extract"}],
                    model="m",
                    n=n,
                    consensus_settings=consensus_settings,
                )
                consensus = json.loads(resp.choices[0].message.content)
                cons_accs.append(field_accuracy(consensus, doc))
                for c in resp.choices[1:]:
                    try:
                        single_accs.append(field_accuracy(json.loads(c.message.content), doc))
                    except json.JSONDecodeError:  # pragma: no cover
                        single_accs.append(0.0)
        results[f"consensus_n{n}"] = round(sum(cons_accs) / len(cons_accs), 4)

    results["single_sample"] = round(sum(single_accs) / len(single_accs), 4)
    results["truth_docs"] = len(docs)
    return results
