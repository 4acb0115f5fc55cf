"""A ``ReplicaSet`` over two port backends on the CPU (``tiny`` with the JAX
package's weights): a member that goes down mid-dispatch fails over to the
other with the same answer an uninterrupted run gives, probes gate a
member's way back into rotation, and a hedged request's loser is cancelled
through its engine's abort poller without touching a breaker."""

import dataclasses
import threading
import time

import pytest

from _torch_serving import port_backend
from k_llms_tpu_torch.backends.base import ChatRequest, resolve_backend
from k_llms_tpu_torch.backends.cuda import CudaBackend
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.reliability.replicas import ReplicaSet
from k_llms_tpu_torch.types.wire import NoHealthyReplicasError
from k_llms_tpu_torch.utils.observability import (
    FAILOVER_EVENTS,
    FAILURE_EVENTS,
    HEDGE_EVENTS,
    ROUTE_EVENTS,
)


@pytest.fixture(scope="module")
def members():
    b0, b1 = port_backend(max_new_tokens=8), port_backend(max_new_tokens=8)
    yield b0, b1
    b0.close()
    b1.close()


def _req(seed=3, max_tokens=8, n=2):
    return ChatRequest(messages=[{"role": "user", "content": "replica question"}],
                       model="tiny", n=n, temperature=0.8, seed=seed, max_tokens=max_tokens)


def _texts(out):
    return [c.message.content for c in out.choices]


def _shutdown(rs):
    rs._executor.shutdown(wait=False)


def test_down_member_fails_over_with_the_uninterrupted_answer(members):
    b0, b1 = members
    want = b1.chat_completion(_req())
    rs = ReplicaSet(members=[b0, b1], model="tiny", hedge=False, route_policy="round_robin")
    before = FAILOVER_EVENTS.get("failover.attempts")
    # Probes of r0 fail until the drill ends, so it stays out of rotation.
    with fp.failpoints({"replica.dispatch": FailSpec(action="down", member="r0", times=1),
                        "replica.probe": FailSpec(action="fail", member="r0")}):
        out = rs.dispatch_chat_completion(_req())
        assert _texts(out) == _texts(want)
        assert FAILOVER_EVENTS.get("failover.attempts") == before + 1
        health = rs.health()
        assert health["state"] == "degraded" and health["healthy_members"] == 1
        assert health["replicas"]["r0"]["in_rotation"] is False
        assert b1.scheduler.stats["failovers"] >= 1
        # The probe (a real tiny generation) gates r0's way back.
        assert rs.probe("r0") is False
    rejoins = ROUTE_EVENTS.get("route.rejoins")
    assert rs.probe("r0") is True
    assert ROUTE_EVENTS.get("route.rejoins") == rejoins + 1
    assert rs.health()["state"] == "ready"
    _shutdown(rs)


def test_unseeded_request_is_pinned_before_the_first_attempt(members):
    b0, b1 = members
    rs = ReplicaSet(members=[b0, b1], model="tiny", hedge=False, route_policy="round_robin")
    unseeded = dataclasses.replace(_req(), seed=None)
    with fp.failpoints({"replica.dispatch": FailSpec(action="down", member="r0", times=1)}):
        out = rs.dispatch_chat_completion(unseeded)
    assert len(out.choices) == 2
    for handle in rs._handles:
        handle.rejoin()
    _shutdown(rs)


def test_no_healthy_member_is_a_typed_503(members):
    rs = ReplicaSet(members=list(members), model="tiny", hedge=False, probe_interval_s=60.0)
    for handle in rs._handles:
        handle.mark_down("drill")
        handle.last_probe_at = time.monotonic()
    with pytest.raises(NoHealthyReplicasError) as ei:
        rs.dispatch_chat_completion(_req())
    assert ei.value.status_code == 503 and set(ei.value.reasons) == {"r0", "r1"}
    for handle in rs._handles:
        handle.rejoin()
    _shutdown(rs)


def test_hedge_winner_returns_and_the_loser_is_cancelled_mid_decode(members):
    b0, b1 = members
    # The primary decodes slowly (every step waits), so it is mid-decode when
    # the hedge on the other member finishes.
    decode = b0.engine._decode

    def slowed(step_fn, *args, **kwargs):
        def step(tok, i):
            time.sleep(0.02)
            return step_fn(tok, i)
        return decode(step, *args, **kwargs)

    b0.engine._decode = slowed
    try:
        rs = ReplicaSet(members=[b0, b1], model="tiny", hedge=True, hedge_delay_s=0.05,
                        route_policy="round_robin")
        aborts = FAILURE_EVENTS.get("engine.decode_abort")
        won = HEDGE_EVENTS.get("hedge.won_hedge")
        out = rs.dispatch_chat_completion(_req(max_tokens=200))
        assert len(out.choices) == 2
        assert HEDGE_EVENTS.get("hedge.won_hedge") == won + 1
        deadline = time.monotonic() + 20
        while FAILURE_EVENTS.get("engine.decode_abort") == aborts and time.monotonic() < deadline:
            time.sleep(0.02)
        assert FAILURE_EVENTS.get("engine.decode_abort") == aborts + 1
        assert b0.engine.last_launch_stats["aborted"]  # the poller froze the loser's rows
        assert b0.engine.last_launch_stats["decode_steps"] < 199
        assert b0.circuit_breaker.state == b1.circuit_breaker.state == "closed"
        assert rs.health()["replicas"]["r0"]["in_rotation"] is True
        _shutdown(rs)
    finally:
        b0.engine._decode = decode


def test_resolve_backend_builds_a_set_of_cuda_members():
    rs = resolve_backend("replicas", members=[{"id": "west", "model": "tiny", "device": "cpu"},
                                              "cuda"], model="tiny", device="cpu")
    assert isinstance(rs, ReplicaSet)
    assert [h.replica_id for h in rs._handles] == ["west", "r1"]
    assert all(isinstance(h.backend, CudaBackend) for h in rs._handles)
    out = rs.dispatch_chat_completion(_req(n=1, max_tokens=3))
    assert len(out.choices) == 1
    rs.close()
    assert all(h.backend.scheduler.state.value == "stopped" for h in rs._handles)


def test_concurrent_traffic_through_the_set_resolves_every_request(members):
    rs = ReplicaSet(members=list(members), model="tiny", hedge=False)
    results = []

    def client(i):
        results.append(rs.dispatch_chat_completion(_req(seed=i, n=1, max_tokens=4)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 6 and all(len(r.choices) == 1 for r in results)
    _shutdown(rs)
