"""The port's twin of ``tests/test_cache_stress.py``: the JAX package's test
vectors through ``k_llms_tpu_torch`` (its copies of the host modules,
and its ``cuda`` backend on the CPU where a backend is built).

The reference's docstring:

Threading stress for the locked TTL caches (the race-safety subsystem,
SURVEY.md §5): concurrent readers/writers across shared scorers must never
corrupt entries, lose updates to other keys, or deadlock.
"""

import threading

from k_llms_tpu_torch.consensus.cache import TTLCache
from k_llms_tpu_torch.consensus.similarity import SimilarityScorer


def test_ttl_cache_concurrent_hammer():
    cache = TTLCache(maxsize=64, ttl=300.0)
    errors = []

    def worker(tid):
        try:
            for i in range(2000):
                k = f"k{(tid * 7 + i) % 97}"
                cache.set(k, (tid, i))
                got = cache.get(k)
                # Entry may have been evicted/overwritten by another thread,
                # but a present value must be a well-formed tuple some thread
                # wrote — never a torn/partial state.
                if got is not None and not (
                    isinstance(got, tuple) and len(got) == 2
                ):
                    errors.append(("torn", k, got))
        except Exception as e:  # pragma: no cover
            errors.append(("exc", tid, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:5]


def test_shared_scorer_concurrent_scoring():
    """The per-backend shared scorer is hit by concurrent requests; scores
    must be deterministic regardless of interleaving (cache hit or miss)."""
    scorer = SimilarityScorer(method="levenshtein")
    pairs = [
        ("the quick brown fox", "the quick brown fix"),
        ("alpha beta gamma", "alpha beta gamma"),
        ("completely different", "nothing alike here"),
    ]
    expected = [scorer.string(a, b) for a, b in pairs]
    results = {}

    def worker(tid):
        out = []
        for _ in range(500):
            for (a, b), want in zip(pairs, expected):
                out.append(scorer.string(a, b) == want)
        results[tid] = all(out)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(results.values())
