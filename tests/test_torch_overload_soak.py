"""The port's twin of the chaos soak in ``tests/test_overload.py``: sustained
over-capacity load through the port's scheduler, with an injected device
OOM split, under ``KLLMS_LOCKCHECK=1`` and ``KLLMS_RACECHECK=1``, ending in
a graceful drain and a clean ``assert_clean()``. The backend runs at tiny on
the CPU.
"""

import threading
import time

import pytest

from k_llms_tpu_torch.analysis import lockcheck
from k_llms_tpu_torch.backends.base import ChatRequest
from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
from k_llms_tpu_torch.engine.scheduler import ServerState
from k_llms_tpu_torch.reliability.failpoints import FailSpec, failpoints
from k_llms_tpu_torch.types import (
    BackendUnavailableError,
    KLLMsError,
    ServerDrainingError,
)


def _req(i, n=2):
    return ChatRequest(
        messages=[{"role": "user", "content": f"overload probe {i}"}],
        model="tiny",
        n=n,
        max_tokens=4,
        temperature=1.0,
        seed=i,
    )


@pytest.mark.slow
@pytest.mark.duration_budget(300)
def test_overload_soak_4x_capacity_bounded_and_typed(monkeypatch):
    """Sustained >= 4x over-capacity for >= 30 s with
    queue weight never over the cap, zero hung futures, every rejection a
    typed 429/503/timeout wire error, >= 1 injected RESOURCE_EXHAUSTED
    recovered via group split with all survivors completing, and drain()
    returning with the queue empty and the worker joined.

    Runs under KLLMS_LOCKCHECK=1 + KLLMS_RACECHECK=1: every lock the backend
    creates below is instrumented and every factory-locked object's fields go
    through the lockset sanitizer; the soak must end with a clean lock-order
    graph and zero empty-lockset findings."""
    monkeypatch.setenv("KLLMS_LOCKCHECK", "1")
    monkeypatch.setenv("KLLMS_RACECHECK", "1")
    lockcheck.reset_state()
    # The reference's cap holds its four-request split episode exactly
    # (four requests of n = 2 at 8 rows each on its 8-way data-parallel
    # mesh); the port's rows are n, so the same four requests weigh 8.
    cap = 8
    b = CudaBackend(
        config=BackendConfig(
            model="tiny", device="cpu", max_new_tokens=4, batch_window=0.01,
            max_queue_weight=cap,
        )
    )
    b.chat_completion(_req(0))  # warm solo launch

    # -- deterministic OOM-split episode: park the worker, build a backlog so
    # the next group is guaranteed coalesced, inject one RESOURCE_EXHAUSTED.
    gate = threading.Event()
    b.scheduler.submit(gate.wait)
    time.sleep(0.05)
    split_results, split_errors = [], []

    def run_split(i):
        try:
            split_results.append(b.chat_completion(_req(i)))
        except Exception as e:
            split_errors.append(e)

    with failpoints({"engine.launch": FailSpec(action="oom", times=1)}):
        threads = [threading.Thread(target=run_split, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)  # let all four queue behind the gate
        gate.set()
        for t in threads:
            t.join(180)
    assert not split_errors, f"split survivors failed: {split_errors!r}"
    assert len(split_results) == 4
    assert b.engine.oom_stats["splits"] >= 1
    assert b.engine.oom_stats["unrecovered"] == 0

    # -- 30+ s sustained overload: 8 closed-loop clients against a queue cap
    # sized for ~4 queued requests (weight 2 each) = well over the
    # admissible backlog; a monitor samples queue weight.
    stop = threading.Event()
    outcomes = {"ok": 0, "shed": 0}
    bad_errors = []
    max_seen_weight = [0]
    lock = threading.Lock()

    def client(tid):
        i = 0
        while not stop.is_set():
            i += 1
            try:
                b.dispatch_chat_completion(_req(tid * 100000 + i))
                with lock:
                    outcomes["ok"] += 1
            except KLLMsError as e:
                with lock:
                    if e.status_code in (429, 503, 408):
                        outcomes["shed"] += 1
                    else:  # pragma: no cover - would fail the assertion below
                        bad_errors.append(e)
            except Exception as e:  # pragma: no cover
                with lock:
                    bad_errors.append(e)

    def monitor():
        while not stop.is_set():
            h = b.scheduler.health()
            with lock:
                max_seen_weight[0] = max(max_seen_weight[0], h["queue_weight"])
            assert h["queue_weight"] <= cap
            time.sleep(0.01)

    workers = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    mon = threading.Thread(target=monitor)
    mon.start()
    for w in workers:
        w.start()
    time.sleep(31.0)
    stop.set()
    for w in workers:
        w.join(180)
        assert not w.is_alive(), "hung client thread = hung future"
    mon.join(10)

    assert not bad_errors, f"untyped/unexpected errors during soak: {bad_errors!r}"
    assert outcomes["ok"] > 0, "overloaded server must still serve"
    assert outcomes["shed"] > 0, "4x over-capacity must shed"
    assert max_seen_weight[0] <= cap

    # -- graceful drain: queue empties, worker joins.
    assert b.drain(timeout=60) is True
    assert b.scheduler.state is ServerState.STOPPED
    assert b.scheduler.health()["queue_depth"] == 0
    assert not b.scheduler._worker.is_alive()
    with pytest.raises((ServerDrainingError, BackendUnavailableError)):
        b.chat_completion(_req(1))

    # The whole soak ran under the lock sanitizer: no ordering inversions,
    # no device dispatch under an undeclared lock.
    lockcheck.assert_clean()
