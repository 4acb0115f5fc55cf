"""The port's twin of ``tests/test_tenancy_chaos.py``: the
starvation-freedom chaos soak for multi-tenant isolation, on the port's
backend at tiny on the CPU.

The acceptance drill: a batch-class tenant floods the continuous-batching
backend with far more offered load than it can drain while an interactive
tenant keeps a steady trickle — with the lock-order graph and the
Eraser-style lockset sanitizer armed (KLLMS_LOCKCHECK=1 + KLLMS_RACECHECK=1)
and the keyed ``scheduler.tenant=exhaust`` failpoint firing against the
flooding tenant mid-soak. Invariants: the interactive tenant is NEVER
starved (every chat request completes, bounded p99), zero hung futures,
every failure is a typed KLLMsError, sheds land on the batch tenant only,
and both sanitizers come out clean at exit.
"""

import threading
import time

import pytest

from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends.cuda import CudaBackend
from k_llms_tpu_torch.analysis import lockcheck
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.types.wire import KLLMsError, RateLimitError
from k_llms_tpu_torch.utils.observability import LATENCY, TENANT_EVENTS

#: Interactive requests must clear the flooded queue well inside this bound —
#: generous against CPU noise, tiny against the flood's total drain time.
CHAT_P99_BOUND_S = 90.0


def _backend():
    return CudaBackend(
        model="tiny", device="cpu", max_new_tokens=8,
        continuous_batching=True, continuous_width=4,
        continuous_max_prompt=128, continuous_max_new=64,
        # Equal weights: isolation must come from the SLO class (interactive
        # before batch in WFQ selection), not from a weight thumb on the
        # scale.
        tenants={
            "bulk": {"slo": "batch", "weight": 1.0},
            "chat": {"slo": "interactive", "weight": 1.0},
        },
    )


@pytest.mark.slow
@pytest.mark.duration_budget(300)
def test_interactive_tenant_never_starves_under_batch_flood(monkeypatch):
    monkeypatch.setenv("KLLMS_LOCKCHECK", "1")
    monkeypatch.setenv("KLLMS_RACECHECK", "1")
    lockcheck.reset_state()
    LATENCY.reset()
    TENANT_EVENTS.reset()
    backend = _backend()
    client = KLLMs(backend=backend, model="tiny")
    results = {}
    chat_e2e = {}
    lock = threading.Lock()

    def worker(key, tenant, seed):
        msgs = [{"role": "user", "content": f"soak {key}"}]
        t0 = time.monotonic()
        try:
            cc = client.chat.completions.create(
                messages=msgs, model="tiny", n=2, seed=seed,
                temperature=0.8, tenant=tenant,
            )
            with lock:
                results[key] = ("ok", cc)
                if tenant == "chat":
                    chat_e2e[key] = time.monotonic() - t0
        except KLLMsError as e:
            # Typed errors only — anything else propagates and fails the test.
            with lock:
                results[key] = ("typed", e)

    n_bulk, n_chat = 18, 6
    # The flood: every bulk request submitted up front, far over what a
    # width-4 loop drains promptly. Mid-flood the keyed failpoint force-
    # exhausts bulk's buckets twice — those two requests must land as typed
    # 429s on bulk alone while chat rides through untouched.
    threads = []
    with fp.failpoints(
        {"scheduler.tenant": FailSpec(action="exhaust", member="bulk", times=2)}
    ):
        for i in range(n_bulk):
            t = threading.Thread(target=worker, args=(f"bulk{i}", "bulk", 400 + i))
            threads.append(t)
            t.start()
        # Steady interactive trickle while the flood is queued: each chat
        # request arrives AFTER bulk work is already piled up, so finishing
        # promptly proves class-first WFQ selection, not lucky ordering.
        for i in range(n_chat):
            time.sleep(0.5)
            t = threading.Thread(target=worker, args=(f"chat{i}", "chat", 600 + i))
            threads.append(t)
            t.start()
        for t in threads:
            t.join(timeout=240.0)
        # The headline invariant: zero hung futures / zero hung clients.
        assert not any(t.is_alive() for t in threads)

    assert len(results) == n_bulk + n_chat

    # Interactive starvation freedom: every chat request SUCCEEDED (no sheds,
    # no 429s) and its e2e latency stayed bounded despite the standing flood.
    chat_results = {k: r for k, r in results.items() if k.startswith("chat")}
    assert all(r[0] == "ok" for r in chat_results.values()), chat_results
    assert len(chat_e2e) == n_chat
    p99 = sorted(chat_e2e.values())[-1]
    assert p99 < CHAT_P99_BOUND_S, f"interactive p99 {p99:.1f}s — starved"

    # The forced exhausts hit bulk (typed RateLimitError with the tenant's
    # own refill horizon) and ONLY bulk.
    rate_limited = [
        r[1] for r in results.values() if r[0] == "typed"
    ]
    assert all(isinstance(e, RateLimitError) for e in rate_limited)
    assert len(rate_limited) == 2
    for e in rate_limited:
        assert "bulk" in str(e) and "forced by failpoint" in str(e)
        assert e.retry_after is not None and e.retry_after >= 0.1
    events = TENANT_EVENTS.snapshot()
    assert events.get("tenant.shed_quota.bulk", 0) == 2
    for shed in ("shed_quota", "shed_brownout", "shed_over_capacity", "evicted"):
        assert events.get(f"tenant.{shed}.chat", 0) == 0, (shed, events)

    # Every non-shed bulk request still completed: batch class is deprioritized,
    # never abandoned.
    bulk_ok = [k for k in results if k.startswith("bulk") and results[k][0] == "ok"]
    assert len(bulk_ok) == n_bulk - 2

    # Per-tenant observability came along for the ride: both tenants have
    # queue-wait attribution, and admissions were counted per tenant.
    lat = LATENCY.snapshot()
    chat_wait = lat.get("scheduler.queue_wait.chat", {})
    assert chat_wait.get("count", 0) >= n_chat
    # Bounded p99 queue wait for the interactive class, straight off the
    # histogram: EVERY chat observation landed inside the largest finite
    # bucket at or under the bound (cumulative count == total count).
    in_bound = max(
        (cum for bound, cum in chat_wait["buckets"] if bound <= CHAT_P99_BOUND_S),
        default=0,
    )
    assert in_bound == chat_wait["count"], chat_wait
    assert lat.get("scheduler.queue_wait.bulk", {}).get("count", 0) >= 1
    assert events.get("tenant.admitted.chat", 0) == n_chat
    assert events.get("tenant.admitted.bulk", 0) == n_bulk - 2

    assert backend.health()["state"] == "ready"
    client.close()
    lockcheck.assert_clean()
