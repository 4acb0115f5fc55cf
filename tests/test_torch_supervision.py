"""The port's supervisor on the CPU: a hung launch is declared hung by the
watchdog, the engine rebuilt and the launch replayed, and the replay equals
an uninterrupted run; rebuilds that never lead to a good launch end in
STOPPED and typed 503s; poison above the threshold escalates to a rebuild.

Twins of ``tests/test_supervision.py``: the end-to-end cases through the
port's backend, whose watchdog budgets are set from a warm launch measured
here (at least ten times it, and at least 2 s) so that a loaded machine
running the suite in parallel does not declare a healthy launch hung; then
the supervisor copy on its own with fake launches (budget model, epoch
fencing, sticky exhaustion, the poison window) and a corrupt checkpoint
reloaded by a rebuild.
"""

import time

import pytest

from _torch_serving import port_params
from k_llms_tpu_torch.backends.base import ChatRequest
from k_llms_tpu_torch.backends.cuda import CudaBackend
from k_llms_tpu_torch.engine.scheduler import ServerState
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.reliability.supervisor import EngineSupervisor, LaunchBudgetModel
from k_llms_tpu_torch.types.wire import (
    BackendUnavailableError,
    CheckpointCorruptError,
    EngineHungError,
)
from k_llms_tpu_torch.utils.observability import RECOVERY_EVENTS

# Long enough that only the watchdog can end the hung launch within a test.
HANG_S = 120.0


def _req(n=2, max_tokens=8, seed=123, temperature=1.0, content="determinism"):
    return ChatRequest(model="tiny", messages=[{"role": "user", "content": content}],
                       n=n, max_tokens=max_tokens, temperature=temperature, seed=seed)


def _warm_launch_s():
    """One warm launch's seconds on this machine, now."""
    b = CudaBackend(model="tiny", device="cpu")
    try:
        b.chat_completion(_req())
        t0 = time.perf_counter()
        b.chat_completion(_req())
        return time.perf_counter() - t0
    finally:
        b.close()


def _watched_backend(**kw):
    """A backend whose watchdog budget is fixed at max(2 s, 10 x a warm
    launch)."""
    budget = max(2.0, 10.0 * _warm_launch_s())
    kw.update(watchdog_min_budget_s=budget, watchdog_max_budget_s=budget)
    return CudaBackend(model="tiny", device="cpu", **kw), budget


@pytest.mark.duration_budget(30)
def test_hung_launch_rebuilds_and_replays_equal_to_an_uninterrupted_run():
    baseline_backend = CudaBackend(model="tiny", device="cpu")
    baseline = baseline_backend.chat_completion(_req())
    baseline_backend.close()

    before = RECOVERY_EVENTS.get("supervisor.hung_launches")
    b, budget = _watched_backend()
    try:
        old_engine = b.engine
        with fp.failpoints({"engine.launch": FailSpec(action="hang", times=1, delay=HANG_S)}):
            t0 = time.perf_counter()
            out = b.chat_completion(_req())
            elapsed = time.perf_counter() - t0
        assert budget <= elapsed < budget + 30
        assert [c.message.content for c in out.choices] == [
            c.message.content for c in baseline.choices
        ]
        assert b.engine is not old_engine
        h = b.health()
        assert h["state"] == "ready"
        sup = h["supervisor"]
        assert (sup["hung_launches"], sup["rebuilds"], sup["consecutive_rebuilds"]) == (1, 1, 0)
        assert sup["replayed"] >= 1 and sup["last_rebuild_reason"] == "hung_launch"
        assert h["recoveries"] == 1 and h["last_recovery_reason"] == "hung_launch"
        assert RECOVERY_EVENTS.get("supervisor.hung_launches") == before + 1
    finally:
        b.close()


@pytest.mark.duration_budget(30)
def test_rebuild_exhaustion_stops_with_typed_503s():
    b, _ = _watched_backend(max_rebuilds=1)
    try:
        with fp.failpoints({"engine.launch": FailSpec(action="hang", delay=HANG_S)}):
            with pytest.raises(EngineHungError, match="did not recover after 1 rebuild"):
                b.chat_completion(_req(n=1, max_tokens=4))
        assert b.scheduler.state is ServerState.STOPPED
        assert b.health()["supervisor"]["stopped"] is True
        with pytest.raises(BackendUnavailableError) as ei:
            b.chat_completion(_req(n=1, max_tokens=4))
        assert ei.value.status_code == 503
    finally:
        b.close()


def test_poison_above_the_threshold_escalates_to_a_rebuild():
    b = CudaBackend(model="tiny", device="cpu", poison_threshold=0.5)
    clean = CudaBackend(model="tiny", device="cpu")
    try:
        with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=0)}):
            poisoned = b.chat_completion(_req(seed=1))
        errors = [c for c in poisoned.choices if getattr(c, "sample_error", None)]
        assert len(errors) == 1 and errors[0].sample_error["code"] == "numeric_poison"
        assert b.health()["quarantined"] == 1
        assert b.supervisor.stats()["rebuilds"] == 0  # escalation waits for the next launch
        out = b.chat_completion(_req(seed=2))
        sup = b.supervisor.stats()
        assert sup["rebuilds"] == 1 and sup["last_rebuild_reason"] == "poison_rate"
        assert b.health()["state"] == "ready"
        want = clean.chat_completion(_req(seed=2))
        assert [c.message.content for c in out.choices] == [c.message.content for c in want.choices]
    finally:
        b.close()
        clean.close()


# -- the supervisor copy on its own (fake launches, a 0.25 s watchdog) -------


def _tight_budget():
    return LaunchBudgetModel(base_s=0.05, per_token_s=0.01, multiplier=1.0,
                             min_budget_s=0.25, max_budget_s=0.25)


def test_launch_budget_model_clamps_and_learns():
    m = LaunchBudgetModel(base_s=1.0, per_token_s=0.5, multiplier=2.0, min_budget_s=5.0,
                          max_budget_s=50.0)
    assert m.budget(4, 1) == 5.0 and m.budget(4, 1000) == 50.0
    m.observe(4, 100, 10.0)
    assert m.stats()["per_token_s"] == pytest.approx(0.1)
    m.observe(4, 100, 30.0)
    assert 0.1 < m.stats()["per_token_s"] < 0.3


def test_stale_result_of_a_hung_launch_is_discarded():
    before = RECOVERY_EVENTS.get("supervisor.stale_results_discarded")
    calls = []
    sup = EngineSupervisor(rebuild_fn=lambda: None, budget_model=_tight_budget())

    def launch():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.6)
            return "stale"
        return "fresh"

    assert sup.supervised_launch(launch, rows=2) == "fresh"
    time.sleep(0.8)
    assert RECOVERY_EVENTS.get("supervisor.stale_results_discarded") >= before + 1
    st = sup.stats()
    assert st["epoch"] == 1 and st["replayed"] == 2 and st["hung_launches"] == 1


def test_exhaustion_is_sticky_and_a_raising_launch_is_not_a_hang():
    failed, rebuilds = [], []
    sup = EngineSupervisor(rebuild_fn=lambda: rebuilds.append(1), budget_model=_tight_budget(),
                           max_rebuilds=1, on_rebuild_failed=failed.append)
    with pytest.raises(ValueError, match="boom"):
        sup.supervised_launch(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert not rebuilds and not sup.stats()["stopped"]
    with pytest.raises(EngineHungError, match="did not recover after 1"):
        sup.supervised_launch(lambda: time.sleep(1.0))
    assert len(failed) == 1 and sup.stats()["stopped"]
    with pytest.raises(EngineHungError, match="stopped"):
        sup.supervised_launch(lambda: "never reached")


def test_poison_window_decays_and_escalates_once():
    rebuilds = []
    sup = EngineSupervisor(rebuild_fn=lambda: rebuilds.append(1), budget_model=_tight_budget(),
                           poison_threshold=0.5, poison_window=4)
    sup.note_poison(0, 4)
    sup.note_poison(1, 4)
    assert sup.supervised_launch(lambda: "ok") == "ok" and not rebuilds
    sup.note_poison(4, 4)
    sup.note_poison(4, 4)
    assert sup.supervised_launch(lambda: "ok") == "ok" and len(rebuilds) == 1
    assert sup.supervised_launch(lambda: "ok") == "ok" and len(rebuilds) == 1


def test_corrupt_checkpoint_on_rebuild_is_terminal(tmp_path):
    """A rebuild reloads the checkpoint; a corrupt one stops the backend
    with the precise typed error, and the params summary rides health()."""
    from k_llms_tpu_torch.models import loader

    path = str(tmp_path / "ckpt")
    loader.save_checkpoint(path, port_params())
    b = CudaBackend(model="tiny", device="cpu", checkpoint_path=path, poison_threshold=0.5)
    try:
        assert b.health()["params"]["checksum"] == loader.param_summary(port_params())["checksum"]
        with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=0)}):
            b.chat_completion(_req(seed=1))
        with fp.failpoints({"loader.params": FailSpec(action="corrupt", times=1)}):
            with pytest.raises(CheckpointCorruptError, match="non-finite"):
                b.chat_completion(_req(seed=2))
        assert b.scheduler.state is ServerState.STOPPED
        with pytest.raises(BackendUnavailableError):
            b.chat_completion(_req(seed=3))
    finally:
        b.close()
