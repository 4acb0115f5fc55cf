"""A world the controlling process started (``parallel/launcher.py``) owns
its followers' lives: a lost follower is started again instead of stopping
the world, as JAX's one process, which has no follower to lose, serves the
next request after a launch that raised.

Four plain scripts (``tests/_torch_spawned_script.py``) run two at a time,
each starting its own followers on the CPU at ``tiny``:

- ``restart``, two ranks (1, 2) with the continuous loop: a follower
  ``SIGKILL``ed while idle costs no request (the next ones equal the
  uninterrupted run's); one killed during a coalesced launch, and one during
  a loop step, gives that request the typed 503 (``FollowerFaultError``)
  within seconds and the next is served, equal to the uninterrupted run;
  ``close()`` ends every child with exit code 0 and leaves none alive;
- ``stop``: every restarted follower fails its first launch, and
  ``max_rebuilds`` restarts without a good launch end in ``STOPPED`` and
  typed 503s, as the supervisor's bound does;
- ``hung``: a follower hung inside a launch past the watchdog, whose
  rebuild plan cannot reach it: the world is started again and the launch
  replayed on it, equal to the first run;
- ``orphan``: the controller ``SIGKILL``ed, every follower ends within 30 s.

A hand-started world keeps its stop (``tests/test_torch_controller.py::
test_follower_fault_is_a_typed_503_within_seconds``, unchanged).
"""

import json
import os
import select
import signal
import time

import pytest

from _torch_spawned import result, start

#: Seconds within which a killed follower's request gets its typed 503.
FAULT_LIMIT_S = 10.0


def _started(*cases):
    """A module fixture running ``cases`` (name, kwargs) at once, two at a
    time at most, so the file adds few processes to a loaded run."""

    @pytest.fixture(scope="module")
    def fixture():
        procs = {name: start(name, **kw) for name, kw in cases}
        yield procs
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()

    return fixture


scripts = _started(("restart", {}), ("stop", {"max_rebuilds": 1}))
later = _started(("hung", {"budget_s": 3.0}), ("orphan", {}))


@pytest.fixture(scope="module")
def restart(scripts):
    return result(scripts["restart"], timeout=150)


@pytest.mark.duration_budget(25)
def test_a_follower_killed_while_idle_costs_no_request(restart):
    assert restart["idle"]["loop"] == restart["loop"]
    assert restart["idle"]["coalesced"] == restart["coalesced"]
    assert restart["idle"]["restart_s"] < 60.0


@pytest.mark.duration_budget(25)
def test_a_follower_killed_during_a_coalesced_launch_is_a_typed_503(restart):
    err = restart["launch_error"]
    assert err is not None and err["type"] == "FollowerFaultError" and err["status"] == 503, err
    assert err["seconds"] < FAULT_LIMIT_S
    assert restart["after_launch"] == restart["coalesced"]


@pytest.mark.duration_budget(25)
def test_a_follower_killed_during_a_loop_step_fails_its_rows_typed(restart):
    err = restart["step_error"]
    assert err is not None and err["type"] == "FollowerFaultError" and err["status"] == 503, err
    assert err["seconds"] < FAULT_LIMIT_S
    assert restart["after_step"] == restart["loop"]
    assert restart["loop_stats"]["last_recovery_reason"] == "world_lost"
    assert restart["loop_stats"]["restarts"] == 1
    assert restart["state"] == "ready"
    assert restart["world"]["restarts"] == 3 and restart["world"]["generation"] == 4


@pytest.mark.duration_budget(25)
def test_close_ends_every_child_with_zero(restart):
    close = restart["close"]
    assert close["exit_codes"] == [0] and close["alive"] == []
    assert [(gen, code) for gen, _, _, code in close["ended"]] == [
        (1, -signal.SIGKILL), (2, -signal.SIGKILL), (3, -signal.SIGKILL), (4, 0)]


@pytest.mark.duration_budget(25)
def test_restarts_without_a_good_launch_stop_the_world(scripts):
    out = result(scripts["stop"], timeout=150)
    assert out["state"] == "stopped"
    assert ["FollowerFaultError", 503] in out["errors"]
    assert out["after"] == ["BackendUnavailableError", 503]
    assert out["world"]["terminal"] is not None and out["world"]["restarts"] == 1
    assert out["close"]["alive"] == []


@pytest.mark.duration_budget(25)
def test_a_follower_hung_past_the_rebuild_is_restarted_and_replayed(later):
    out = result(later["hung"], timeout=150)
    assert out["replayed"] == out["first"]
    assert out["supervisor"]["hung_launches"] == 1 and out["supervisor"]["replayed"] > 0
    assert out["world"]["restarts"] == 2 and out["state"] == "ready"
    assert out["close"]["exit_codes"] == [0] and out["close"]["alive"] == []


@pytest.mark.duration_budget(25)
def test_followers_end_with_their_controller(later):
    proc = later["orphan"]
    deadline, line = time.monotonic() + 90, ""
    while not line.startswith("PIDS") and time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            assert line, f"the script ended: {proc.communicate()}"
    pids = json.loads(line.split(" ", 1)[1])
    assert len(pids) == 2
    proc.kill()
    proc.wait()
    deadline = time.monotonic() + 30
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in pids if _alive(p)]
        time.sleep(0.05)
    assert alive == []


def _alive(pid):
    """Whether ``pid`` runs (an exited child not yet reaped by its new
    parent counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False
