"""The engine rebuilt across a world of ranks (``parallel/controller.py``'s
rebuild plan), held against the JAX package's backend on the same mesh.

A gloo world of two spawned port ranks (``_torch_mesh_worker``) builds
``CudaBackend`` over the parity harness's tiny fp32 weights on the (2, 1) or
the (1, 2) mesh; rank 0 is the controller. A rebuild builds every rank's
engine again over those weights on the backend's mesh; beside it, JAX's
``TpuBackend`` over ``shared_engine("tiny", mesh_shape=shape)`` on the
forced CPU devices answers the same requests uninterrupted. Watchdog budgets
are fixed at ``BUDGET_S``.

- A coalesced launch hung before its plan (``engine.launch``): the watchdog
  declares it hung, every rank rebuilds, the replay equals JAX's answer, and
  the hung thread, waking on the retired engine, sends no plan.
- A poison escalation (``engine.logits`` nan on one row): the next launch
  rebuilds every rank first and equals JAX's answer.
- A launch hung after its plan (``engine.decode``, the followers inside
  it): the rebuild waits for it to end and then heals; one that outlasts
  the wait stops the world, and the follower is released once it ends.
- Exhaustion: every launch hangs, ``max_rebuilds`` = 1 ends in ``STOPPED``
  with typed 503s, and the follower's serving ends normally at close.
- A launch bound to an engine that the loop's rebuild path retires before
  the launch announces itself runs on the new engine.
- Seeded engines on the world's auto mesh: a rebuild makes no new device
  mesh (``init_device_mesh`` is a collective over the whole world).
- The continuous loop on (2, 1) with its pool corrupted mid-decode: the
  quarantine rebuilds every rank, the survivors equal JAX's loop, and the
  replicas' pool digests equal the controller's."""

import numpy as np
import pytest

from _torch_mesh import port_config, port_tree
from _torch_mesh_worker import World
from conftest import shared_engine, shared_params
from k_llms_tpu.models import get_config
from test_torch_loop_mesh import LOOP, REQUESTS, _assert_replicas_agree, _assert_same

TINY = get_config("tiny")
BUDGET_S = 3.0
WATCHDOG = dict(watchdog_min_budget_s=BUDGET_S, watchdog_max_budget_s=BUDGET_S)
MESSAGES = [{"role": "user", "content": "determinism"}]
REQ = [dict(messages=MESSAGES, n=2, max_tokens=8, seed=123, temperature=1.0),
       dict(messages=[{"role": "user", "content": "after"}], n=3, max_tokens=6, seed=7,
            temperature=0.8)]
HANG = ("engine.launch", dict(action="hang", times=1, delay=BUDGET_S + 3.0))
SHAPES = pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["dp2", "tp2"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("rebuild2"), env={"KLLMS_RANK_CHECK": "1"})
    yield w
    w.close()


@pytest.fixture(scope="module")
def jax_texts():
    """JAX's uninterrupted answer to a request on the mesh of a shape."""
    from k_llms_tpu import KLLMs as JaxKLLMs
    from k_llms_tpu.backends.tpu import TpuBackend

    made = {}

    def get(shape, req, **knobs):
        key = (shape, tuple(sorted(knobs.items())))
        if key not in made:
            made[key] = TpuBackend(model="tiny", max_new_tokens=8,
                                   engine=shared_engine("tiny", mesh_shape=shape), **knobs)
        r = JaxKLLMs(backend=made[key], model="tiny").chat.completions.create(
            model="tiny", **req)
        return [c.message.content for c in r.choices]

    yield get
    for b in made.values():
        b.close()


def _run(world, shape, script, backend_kwargs=None, seeded=False, **script_kwargs):
    ctl, fol = world.run(
        "controller", shape=shape, config=port_config(TINY),
        params=port_tree(shared_params(TINY), TINY), script=script,
        engine_kwargs=dict(kv_page_size=8),
        backend_kwargs=dict(max_new_tokens=8, **(backend_kwargs or {})),
        script_kwargs=script_kwargs, seeded=seeded)
    assert fol["follower"] is True
    return ctl, fol


def _healed(ctl, fol, reason, hung):
    sup = ctl["supervisor"]
    assert (sup["hung_launches"], sup["rebuilds"], sup["consecutive_rebuilds"]) == (hung, 1, 0)
    assert sup["last_rebuild_reason"] == reason and ctl["state"] == "ready"
    assert ctl["rebuilds"] == fol["rebuilds"] == 1
    assert ctl["first_retired"] and ctl["replaced"] and ctl["stopped"] is None
    assert fol["plans"] == ctl["plans_after_wake"]


@SHAPES
def test_hung_launch_rebuilds_every_rank_and_replays_equal_to_jax(world, jax_texts, shape):
    """The launch hangs before its plan; both ranks rebuild (the rebuild
    plan is counted on each), the replay and the next request equal JAX's
    uninterrupted answers, and the hung thread wakes on its retired engine
    without sending a plan."""
    ctl, fol = _run(world, shape, "rebuild", WATCHDOG, requests=REQ, failpoint=HANG,
                    wake_s=HANG[1]["delay"] + 1.0)
    for got, req in zip(ctl["answers"], REQ):
        assert got.get("texts") == jax_texts(shape, req), got
    _healed(ctl, fol, "hung_launch", hung=1)
    assert ctl["supervisor"]["replayed"] >= 1
    # The replay's launch, the rebuild plan and the next launch: no plan
    # from the woken thread.
    assert ctl["plans_after_wake"] == ctl["plans"] == 3


@SHAPES
def test_poison_escalation_rebuilds_every_rank(world, jax_texts, shape):
    """One poisoned row of two crosses the threshold; the next launch
    rebuilds every rank first and equals JAX's answer."""
    ctl, fol = _run(world, shape, "rebuild", dict(poison_threshold=0.5), requests=REQ,
                    failpoint=("engine.logits", dict(action="nan", kill=1, seed=0)))
    assert ctl["answers"][0].get("texts") is not None
    assert ctl["answers"][1]["texts"] == jax_texts(shape, REQ[1])
    _healed(ctl, fol, "poison_rate", hung=0)
    assert ctl["plans"] == 3


def test_rebuild_waits_for_an_announced_launch_to_end(world, jax_texts):
    """The launch hangs after its plan (the followers are inside it) for
    less than the wait: the rebuild plan goes out once it ends, and the
    replay equals JAX's answer."""
    hang = ("engine.decode", dict(action="hang", times=1, delay=1.5 * BUDGET_S))
    ctl, fol = _run(world, (2, 1), "rebuild", WATCHDOG, requests=REQ[:1], failpoint=hang)
    assert ctl["answers"][0]["texts"] == jax_texts((2, 1), REQ[0])
    _healed(ctl, fol, "hung_launch", hung=1)


def test_an_announced_launch_that_outlasts_the_wait_stops_the_world(world):
    """The launch hangs after its plan for longer than the wait: the world
    stops with the typed 503, and the follower, once the launch ends, is
    released by the close plan."""
    hang = ("engine.decode", dict(action="hang", times=1, delay=3.0 * BUDGET_S))
    ctl, fol = _run(world, (2, 1), "rebuild", WATCHDOG, requests=REQ, failpoint=hang,
                    wake_s=3.0 * BUDGET_S + 1.0)
    first, nxt = ctl["answers"]
    assert first["status"] == 503 and "world is stopped" in first["message"], first
    assert nxt["status"] == 503 and ctl["state"] == "stopped"
    assert ctl["stopped"] is not None and ctl["rebuilds"] == fol["rebuilds"] == 0
    assert fol["plans"] == 1  # the launch (the close plan is not counted)


def test_exhaustion_stops_with_typed_503s_and_releases_the_follower(world):
    """Every launch hangs and max_rebuilds is 1: the replay's hang exhausts
    the supervisor, the request and the next one get typed 503s, and the
    follower's serving ends at the controller's close."""
    hang = ("engine.launch", dict(action="hang", delay=BUDGET_S + 1.0))
    ctl, fol = _run(world, (2, 1), "rebuild", dict(max_rebuilds=1, **WATCHDOG),
                    requests=REQ, failpoint=hang, wake_s=2 * BUDGET_S + 4.0)
    first, nxt = ctl["answers"]
    assert first["error"] == "EngineHungError" and first["status"] == 503, first
    assert "did not recover after 1 rebuild" in first["message"]
    assert nxt["status"] == 503 and ctl["state"] == "stopped"
    assert ctl["supervisor"]["stopped"] and ctl["supervisor"]["hung_launches"] == 2
    assert ctl["rebuilds"] == fol["rebuilds"] == 1
    # The rebuild plan; then the replay's thread, waking on the engine the
    # stopped supervisor kept, runs its launch on every rank (its result is
    # discarded by the epoch fence, as in one process).
    assert ctl["plans"] == 1 and fol["plans"] == ctl["plans_after_wake"] == 2


def test_a_launch_bound_to_a_retired_engine_runs_on_the_new_one(world, jax_texts):
    """A launch has taken the engine but not yet announced itself (asleep
    at its failpoint) when the loop's rebuild path retires that engine
    across the host: its announcement is refused, nothing ran, and it runs
    on the new engine instead, equal to JAX's answer."""
    ctl, fol = _run(world, (2, 1), "retire_race", request=REQ[0], sleep_s=2.0,
                    rebuild_after_s=0.5)
    assert ctl["answer"].get("texts") == jax_texts((2, 1), REQ[0]), ctl["answer"]
    assert ctl["first_retired"] and ctl["rebuilds"] == fol["rebuilds"] == 1
    assert ctl["supervisor"]["hung_launches"] == 0 and ctl["supervisor"]["rebuilds"] == 0
    assert ctl["plans"] == fol["plans"] == 2  # the rebuild plan, then the launch


def test_rebuild_keeps_the_world_mesh(world):
    """Seeded engines on the world's auto mesh: a poison rebuild makes no
    device mesh on any rank, and the request served after it equals the
    same request served before it."""
    ctl, fol = _run(world, None, "rebuild", dict(poison_threshold=0.5), seeded=True,
                    requests=[REQ[0], REQ[1], REQ[0]], fault_at=1,
                    failpoint=("engine.logits", dict(action="nan", kill=3, seed=0)))
    assert ctl["mesh_inits"] == fol["mesh_inits"] == 1
    assert ctl["answers"][2]["texts"] == ctl["answers"][0]["texts"]
    assert ctl["rebuilds"] == fol["rebuilds"] == 1


def test_corrupt_loop_pool_rebuilds_every_rank_and_replays(world):
    """The controller's page pool loses a page mid-decode: the quarantine
    rebuilds every rank, each replica starts empty on its new engine, the
    survivors re-admitted through announced admissions equal JAX's loop, and
    every replica ends with the controller's counters and pool digest."""
    from k_llms_tpu.backends.tpu import TpuBackend

    ref = TpuBackend(model="tiny", max_new_tokens=8,
                     engine=shared_engine("tiny", mesh_shape=(2, 1)), **LOOP)
    try:
        want = [ref._continuous.submit(ids, **kw).result(timeout=120) for ids, kw in REQUESTS[:2]]
    finally:
        ref.close()
    ctl, fol = world.run(
        "controller", shape=(2, 1), config=port_config(TINY),
        params=port_tree(shared_params(TINY), TINY), script="loop",
        engine_kwargs=dict(kv_page_size=8), backend_kwargs=dict(max_new_tokens=8, **LOOP),
        script_kwargs=dict(requests=REQUESTS[:2], after=[0, 0], corrupt_at=2))
    assert ctl["corrupted"] == {"quarantined": True, "error": ctl["corrupted"]["error"]}
    for i in range(2):
        _assert_same(ctl["results"][i], want[i])
    _assert_same(ctl["next"], want[0])
    assert ctl["restarts"] == 1 and ctl["last_recovery_reason"] == "page_accounting"
    assert ctl["rebuilds"] == fol["rebuilds"] == 1 and ctl["stopped"] is None
    _assert_replicas_agree(ctl, [fol])
    np.testing.assert_equal(fol["snapshots"][-1]["pages"], ctl["stats"]["pages"])
