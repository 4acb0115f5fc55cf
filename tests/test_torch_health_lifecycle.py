"""Health snapshots across the lifecycle, held against the JAX package's:
twins of ``tests/test_health_lifecycle.py`` and of the ``/healthz``
lifecycle in ``tests/test_serving.py``.

The port's scheduler (a copy) walks READY -> DEGRADED -> RECOVERING ->
DEGRADED -> READY -> STOPPED beside the JAX scheduler through the same
hooks, and every snapshot equals JAX's (the drain rate, a measured rate,
and the process-wide event sections aside). Then ``/healthz`` over the port's backend on the CPU answers 200
while it admits work and 503 once drained, as the JAX backend's does, and a
chat request after the drain gets the typed 503.
"""

import threading
import time

import pytest

from _torch_serving import port_backend
from _torch_wire import BODY, both, exchange, pkg

INT_FIELDS = ("queue_depth", "queue_weight", "in_flight", "effective_max_rows", "max_rows",
              "served", "errors", "shed", "shed_over_capacity", "evicted", "oom_splits",
              "recoveries", "recovery_attempt", "quarantined")


def _snap(s):
    """The scheduler's own snapshot: the measured drain rate and the
    process-wide event sections (kernel, grammar, consensus counters, which
    other tests in the process move) left out."""
    return {k: v for k, v in s.health().items()
            if k != "drain_rate" and (k == "tenants" or not isinstance(v, dict))}


def _walk(p):
    """The lifecycle through the hooks the engine and supervisor call; the
    snapshot after each step."""
    s = p.scheduler.EngineScheduler(name="lifecycle", max_rows=8)
    deadline = time.monotonic() + 10
    while s.health()["state"] == "starting" and time.monotonic() < deadline:
        time.sleep(0.005)
    snaps = [_snap(s)]
    for step in (lambda: s.note_oom(), lambda: s.note_recovering(1, "hung_launch"),
                 lambda: (s.note_quarantine(3), s.note_quarantine(0)), lambda: s.note_rebuilt(),
                 lambda: [s.note_recovered() for _ in range(3)],
                 lambda: s.note_recovering(1, "poison_rate"), lambda: s.note_rebuilt()):
        step()
        snaps.append(_snap(s))
    assert s.drain(timeout=5.0)
    snaps.append(_snap(s))
    return snaps


def test_lifecycle_snapshots_equal_jax():
    jax, port = (_walk(p) for p in both())
    assert port == jax
    states = [h["state"] for h in port]
    assert states == ["ready", "degraded", "recovering", "recovering", "degraded", "ready",
                      "recovering", "ready", "stopped"]
    for h in port:
        assert all(isinstance(h[k], int) for k in INT_FIELDS)
        assert h["last_recovery_reason"] is None or isinstance(h["last_recovery_reason"], str)


def test_draining_is_observable_and_ends_stopped():
    p = pkg("k_llms_tpu_torch")
    s = p.scheduler.EngineScheduler(name="drainer", batch_window=0.0)
    s.call(lambda: 1)
    t = threading.Thread(target=lambda: s.drain(timeout=5.0))
    t.start()
    for _ in range(100):
        if s.health()["state"] in ("draining", "stopped"):
            break
        time.sleep(0.01)
    assert s.health()["state"] in ("draining", "stopped")
    t.join(timeout=10.0)
    assert not t.is_alive() and s.health()["state"] == "stopped"


def test_rebuild_failure_stops_and_flushes_typed_as_in_jax():
    outs = []
    for p in both():
        s = p.scheduler.EngineScheduler(name="terminal")
        s.note_rebuild_failed(RuntimeError("rebuild exploded"))
        with pytest.raises(p.wire.BackendUnavailableError) as err:
            s.call(lambda: 1)
        outs.append((_snap(s), err.value.status_code, err.value.as_wire()))
    assert outs[1] == outs[0] and outs[1][1] == 503


@pytest.mark.parametrize("package", ["k_llms_tpu", "k_llms_tpu_torch"])
def test_healthz_follows_the_backend_lifecycle(package):
    """``/healthz`` answers 200 while the backend admits work and 503 once
    it is drained; a chat request after the drain gets the typed 503. The
    JAX backend (``TpuBackend``) and the port's behave alike."""
    p = pkg(package)
    if package == "k_llms_tpu":
        from conftest import shared_engine
        from k_llms_tpu.backends.tpu import TpuBackend

        backend = TpuBackend(model="tiny", max_new_tokens=8, engine=shared_engine("tiny"))
    else:
        backend = port_backend(paged=True)
    client = p.KLLMs(backend=backend, model="tiny")
    app = p.ServingApp(client)
    try:
        (ready,) = exchange(app, [("GET", "/healthz", {})])
        assert ready.status_code == 200 and ready.json()["state"] == "ready"
        client.backend.drain(timeout=30)
        drained, chat = exchange(app, [("GET", "/healthz", {}), (
            "POST", "/v1/chat/completions", {"json": {**BODY, "model": "tiny"}})])
        assert drained.status_code == 503
        assert drained.json()["state"] in ("draining", "stopped")
        assert chat.status_code == 503 and chat.json()["error"]["type"]
    finally:
        client.close()
