"""The port's runtime lock-order sanitizer (KLLMS_LOCKCHECK=1) and lockset
sanitizer (KLLMS_RACECHECK=1): the cases of ``tests/test_lockcheck.py`` on
``k_llms_tpu_torch.analysis.lockcheck``.

The sanitizer must (a) stay a zero-overhead pass-through when the env var is
unset, (b) fold per-thread acquisition stacks into a global order graph and
flag a real A->B / B->A inversion built by two threads, (c) flag device
dispatch under a lock not declared ``allow_dispatch=True``, and (d) keep
Condition.wait bookkeeping honest (wait releases the lock; no phantom holds).
"""

import threading
import time

import pytest

from k_llms_tpu_torch.analysis import lockcheck


@pytest.fixture
def checked(monkeypatch):
    """Enable the sanitizer and isolate its process-wide state."""
    monkeypatch.setenv("KLLMS_LOCKCHECK", "1")
    lockcheck.reset_state()
    yield
    lockcheck.reset_state()


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_factories_return_plain_primitives_when_disabled(monkeypatch):
    monkeypatch.delenv("KLLMS_LOCKCHECK", raising=False)
    assert not lockcheck.lockcheck_enabled()
    lock = lockcheck.make_lock("t.plain")
    rlock = lockcheck.make_rlock("t.plain_r")
    cv = lockcheck.make_condition("t.plain_cv")
    for obj in (lock, rlock, cv):
        assert not isinstance(obj, lockcheck._CheckedBase)
    with lock, rlock, cv:
        pass


def test_enabled_values(monkeypatch):
    for val, expect in [("1", True), ("true", True), ("ON", True),
                        ("0", False), ("off", False), ("", False)]:
        monkeypatch.setenv("KLLMS_LOCKCHECK", val)
        assert lockcheck.lockcheck_enabled() is expect


def test_two_thread_inversion_is_reported_as_cycle(checked):
    a = lockcheck.make_lock("t.a")
    b = lockcheck.make_lock("t.b")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    # Sequenced via join so the test never actually deadlocks; the graph
    # still records a->b from thread 1 and b->a from thread 2.
    _in_thread(forward)
    _in_thread(backward)

    found = lockcheck.violations()
    assert len(found) == 1
    assert "lock-order cycle" in found[0]
    assert "t.a" in found[0] and "t.b" in found[0]
    assert "test_torch_lockcheck.py" in found[0]  # closing site is actionable
    with pytest.raises(lockcheck.LockCheckError, match="lock-order cycle"):
        lockcheck.assert_clean()


def test_consistent_order_is_clean(checked):
    a = lockcheck.make_lock("t.a")
    b = lockcheck.make_lock("t.b")

    def forward():
        with a:
            with b:
                pass

    _in_thread(forward)
    _in_thread(forward)
    with a:
        with b:
            pass
    assert set(lockcheck.graph()) == {("t.a", "t.b")}
    lockcheck.assert_clean()


def test_rlock_reentrancy_is_not_a_violation(checked):
    r = lockcheck.make_rlock("t.r")
    with r:
        with r:
            pass
    lockcheck.assert_clean()
    assert ("t.r", "t.r") not in lockcheck.graph()


def test_same_name_instances_are_orderless_peers(checked):
    # Per-member locks (reliability.replica.{id}) share a canonical name;
    # nesting two distinct instances must not fabricate a self-cycle.
    m1 = lockcheck.make_lock("t.member")
    m2 = lockcheck.make_lock("t.member")
    with m1:
        with m2:
            pass
    with m2:
        with m1:
            pass
    lockcheck.assert_clean()


def test_dispatch_under_plain_lock_is_a_violation(checked):
    guard = lockcheck.make_lock("t.guard")
    with guard:
        lockcheck.note_device_dispatch("unit step")
    found = lockcheck.violations()
    assert len(found) == 1
    assert "unit step" in found[0] and "t.guard" in found[0]
    assert "allow_dispatch" in found[0]


def test_dispatch_under_allow_dispatch_lock_is_clean(checked):
    gate = lockcheck.make_lock("t.gate", allow_dispatch=True)
    with gate:
        lockcheck.note_device_dispatch("unit step")
    lockcheck.assert_clean()


def test_dispatch_with_nothing_held_is_clean(checked):
    lockcheck.note_device_dispatch("free step")
    lockcheck.assert_clean()


def test_condition_wait_releases_and_notify_wakes(checked):
    cv = lockcheck.make_condition("t.cv")
    woke = []
    flag = []

    def waiter():
        with cv:
            cv.wait_for(lambda: flag, timeout=5.0)
            woke.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    # If wait() failed to release the underlying lock this acquire would
    # block until the waiter's timeout; the join below would then fail.
    with cv:
        flag.append(1)
        cv.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert woke == [True]
    lockcheck.assert_clean()


def test_condition_hold_still_counts_for_ordering(checked):
    cv = lockcheck.make_condition("t.cv")
    inner = lockcheck.make_lock("t.inner")
    with cv:
        with inner:
            pass
    assert ("t.cv", "t.inner") in lockcheck.graph()


def test_reset_state_clears_violations_and_graph(checked):
    guard = lockcheck.make_lock("t.guard")
    with guard:
        lockcheck.note_device_dispatch("unit step")
    assert lockcheck.violations()
    lockcheck.reset_state()
    assert lockcheck.violations() == []
    assert lockcheck.graph() == {}
    lockcheck.assert_clean()


def test_violations_deduplicate(checked):
    guard = lockcheck.make_lock("t.guard")
    for _ in range(3):
        with guard:
            lockcheck.note_device_dispatch("unit step")
    assert len(lockcheck.violations()) == 1


# ---------------------------------------------------------------------------
# racecheck: the Eraser-style lockset sanitizer (KLLMS_RACECHECK=1)
# ---------------------------------------------------------------------------


@pytest.fixture
def racecheck(monkeypatch):
    """Enable the lockset sanitizer (without lockcheck, proving it carries
    its own instrumentation) and isolate process-wide state."""
    monkeypatch.setenv("KLLMS_RACECHECK", "1")
    monkeypatch.delenv("KLLMS_LOCKCHECK", raising=False)
    lockcheck.reset_state()
    yield
    lockcheck.reset_state()


def test_two_thread_unguarded_write_race_reports_both_stacks(racecheck):
    class Loop:
        def __init__(self):
            self._lock = lockcheck.make_lock("t.race_loop")

        def first_writer(self):
            self.gauge = 1

        def second_writer(self):
            self.gauge = 2

    loop = Loop()
    # The factory saw ``self`` in its caller's frame and auto-registered it.
    assert getattr(type(loop), "_kllms_is_tracked", False)
    t1 = threading.Thread(target=loop.first_writer, name="racecheck-w1")
    t1.start()
    t1.join(timeout=5.0)
    t2 = threading.Thread(target=loop.second_writer, name="racecheck-w2")
    t2.start()
    t2.join(timeout=5.0)
    found = lockcheck.violations()
    assert len(found) == 1, found
    msg = found[0]
    assert "racecheck" in msg and "Loop.gauge" in msg
    assert "'t.race_loop'" in msg
    # BOTH access stacks, each attributed to its thread and call site.
    assert "access A [write by racecheck-w1]" in msg
    assert "access B [write by racecheck-w2]" in msg
    assert "first_writer" in msg and "second_writer" in msg
    with pytest.raises(lockcheck.LockCheckError, match="racecheck"):
        lockcheck.assert_clean()
    lockcheck.reset_state()
    lockcheck.assert_clean()


def test_correctly_guarded_field_stays_clean(racecheck):
    class Box:
        def __init__(self):
            self._lock = lockcheck.make_lock("t.race_box")
            self.total = 0

        def bump(self):
            for _ in range(200):
                with self._lock:
                    self.total += 1

    box = Box()
    threads = [threading.Thread(target=box.bump) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()
    with box._lock:
        assert box.total == 600
    lockcheck.assert_clean()


def test_init_phase_single_thread_writes_are_exempt(racecheck):
    class Cfg:
        def __init__(self):
            self._lock = lockcheck.make_lock("t.race_cfg")
            self.width = 0

    cfg = Cfg()
    for i in range(50):
        cfg.width = i  # still the first thread: Eraser's exclusive state
    assert lockcheck.violations() == []
    # A second thread that only READS moves the field to shared — reported
    # only if it later goes shared-modified, which a pure reader never does.
    _in_thread(lambda: [cfg.width for _ in range(10)])
    lockcheck.assert_clean()


def test_racecheck_off_allocates_no_instrumentation(monkeypatch):
    monkeypatch.delenv("KLLMS_RACECHECK", raising=False)
    monkeypatch.delenv("KLLMS_LOCKCHECK", raising=False)
    before = dict(lockcheck._tracked_classes)

    class Plain:
        def __init__(self):
            self._lock = lockcheck.make_lock("t.race_plain")
            self.value = 0

    p = Plain()
    assert type(p) is Plain  # class never swapped
    assert not isinstance(p._lock, lockcheck._CheckedBase)
    assert "_kllms_race_fields" not in p.__dict__
    assert lockcheck._tracked_classes == before
    # The public registration surface is equally a no-op when disabled.
    lockcheck.shared_state(p, "t.race_plain")
    lockcheck.race_exempt(p, "value")
    assert type(p) is Plain
    assert "_kllms_race_fields" not in p.__dict__
    assert "_kllms_race_exempt" not in p.__dict__


def test_race_exempt_mirrors_unguarded_annotation(racecheck):
    class Latch:
        def __init__(self):
            self._lock = lockcheck.make_lock("t.race_latch")
            self.closed = False
            lockcheck.race_exempt(self, "closed")

        def close(self):
            self.closed = True

    latch = Latch()
    _in_thread(latch.close)
    _in_thread(latch.close)
    assert latch.closed is True
    lockcheck.assert_clean()


def test_shared_state_explicit_registration_without_a_factory(racecheck):
    class Bare:
        pass

    bare = Bare()
    lockcheck.shared_state(bare, "t.race_bare")

    def w1():
        bare.x = 1

    def w2():
        bare.x = 2

    _in_thread(w1)
    _in_thread(w2)
    assert any("Bare.x" in m for m in lockcheck.violations())
