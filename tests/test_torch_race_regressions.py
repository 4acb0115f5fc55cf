"""Two-thread oracles for the races the guarded-by rule surfaced in the JAX
package, held against the port's counterparts of the fixed methods (twin
of ``tests/test_race_regressions.py``).

Each test pins the fix with a deterministic mutual-exclusion oracle: the
main thread HOLDS the guarding lock while a second real thread calls the
method. A method that touched the shared state without the lock would
complete (or snapshot stale state) at once; a locked one blocks until the
lock is released and then sees the mutation made while it was held. A
scheduling delay can only make a lock-free method's failure less likely to
be missed, never fail the locked one.

``PagedKVPool.pool_bytes`` is the port's own repair: it read the pool's
tensors without the pool lock, which the JAX method takes.
"""

import threading
import time

import pytest

from k_llms_tpu_torch.backends.fake import FakeBackend
from k_llms_tpu_torch.reliability.replicas import ReplicaSet

# The blocked-reader probe window: long enough for the worker thread to hit
# the contended section, short enough to keep tier-1 fast.
_WINDOW_S = 0.15


def _start(fn):
    out = {}

    def run():
        out["value"] = fn()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _finish(t, out):
    t.join(timeout=5.0)
    assert not t.is_alive()
    return out["value"]


def _engine(**kw):
    from _torch_serving import port_params
    from k_llms_tpu_torch.engine.engine import LocalEngine

    return LocalEngine("tiny", params=port_params(), device="cpu", **kw)


@pytest.mark.duration_budget(30)
def test_continuous_stats_snapshot_is_taken_under_the_loop_lock():
    from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop

    loop = ContinuousDecodeLoop(_engine(kv_layout="dense"), width=2, max_prompt=64, max_new=32)
    try:
        with loop._lock:
            t, out = _start(lambda: loop.stats)
            time.sleep(_WINDOW_S)
            # A snapshot taken outside the lock has already run
            # dict(self._stats) and cannot see this key.
            loop._stats["race_probe"] = "set-under-lock"
        snap = _finish(t, out)
        assert snap["race_probe"] == "set-under-lock"
    finally:
        loop.stop()


def test_pool_bytes_waits_for_the_pool_lock():
    from k_llms_tpu_torch.engine.paging import PagedKVPool
    from k_llms_tpu_torch.models.config import get_config

    pool = PagedKVPool(get_config("tiny"), total_pages=4, page_size=8, device="cpu")
    with pool.lock:
        t, out = _start(pool.pool_bytes)
        time.sleep(_WINDOW_S)
        assert not out, "pool_bytes completed while the pool lock was held"
    size = _finish(t, out)
    assert size == pool.pool_bytes() > 0


def _replica_set():
    return ReplicaSet(members=[FakeBackend(["ok"])], model="fake", hedge=False)


def test_eligible_reads_rotation_state_under_the_handle_lock():
    rs = _replica_set()
    handle = rs._handles[0]
    with handle.lock:
        t, out = _start(lambda: rs._eligible(frozenset()))
        time.sleep(_WINDOW_S)
        assert not out, "_eligible read in_rotation without the handle lock"
    eligible, reasons = _finish(t, out)
    assert len(eligible) == 1 and reasons == {}


def test_crop_texts_reads_rotation_state_under_the_handle_lock():
    rs = _replica_set()
    handle = rs._handles[0]
    with handle.lock:
        t, out = _start(lambda: rs.crop_texts(["hello world"], 1))
        time.sleep(_WINDOW_S)
        assert not out, "crop_texts read in_rotation without the handle lock"
    assert _finish(t, out)


def test_probe_stamps_last_probe_at_under_the_handle_lock():
    rs = _replica_set()
    handle = rs._handles[0]
    before = handle.last_probe_at
    with handle.lock:
        t, out = _start(lambda: rs._probe(handle))
        time.sleep(_WINDOW_S)
        assert handle.last_probe_at == before, (
            "_probe wrote last_probe_at without the handle lock"
        )
    assert _finish(t, out) is True
    assert handle.last_probe_at > before


@pytest.mark.duration_budget(30)
def test_prefix_match_scan_runs_under_the_paged_mutex():
    """The port's ``_prefix_match`` (JAX: ``_match_prefix_entries``) scans
    the cache under the launch lock, which carries the JAX mutex's id."""
    eng = _engine(prefix_cache_size=4)
    assert eng._launch_lock is not None
    with eng._launch_lock:
        t, out = _start(lambda: eng._prefix_match([1, 2, 3]))
        time.sleep(_WINDOW_S)
        assert not out, "_prefix_match scanned the cache without the launch lock"
    assert _finish(t, out) == (None, 0)
