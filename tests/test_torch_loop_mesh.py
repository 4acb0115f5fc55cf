"""The continuous decode loop across a world of ranks (``engine/continuous.py``
under ``parallel/controller.py``), held against the JAX package's loop on the
same mesh.

Gloo worlds of two and four spawned port ranks (``_torch_mesh_worker``) build
``CudaBackend(continuous_batching=True)`` over the parity harness's tiny fp32
weights with ``kv_page_size=8``: rank 0 is the controller and the only one
called; the others hold replicas of its loop and replay its admissions,
prefill chunks and steps. Beside them, JAX's
``TpuBackend(continuous_batching=True)`` over ``shared_engine("tiny",
mesh_shape=shape)`` on the forced CPU devices. ``KLLMS_RANK_CHECK=1`` holds
every rank's slot mirrors and page allocator equal after every loop plan.

- The paged loop on (2, 1), (1, 2) and (2, 2) and the dense loop on (2, 1),
  with staggered joins and one chunked admission: greedy and seeded sampled
  tokens exactly JAX's, logprobs within 1e-5; every follower's loop counters
  and pool digest equal the controller's.
- A ``json_object`` grammar request and a streamed request riding the loop
  (twins of ``tests/test_continuous.py:135-206``), and a logit-bias request
  taking the coalescing path between loop steps.
- Faults (twins of ``tests/test_continuous_recovery.py``): a member aborted
  on the controller stops on the follower at the same step; a
  ``continuous.worker`` crash fails the in-flight request typed and resets
  both ranks; a hung ``continuous.step`` rebuilds the engine on both ranks
  and the request is replayed equal to JAX's; a follower's
  ``continuous.step`` fault reaches the controller as the typed 503 and ends
  the follower with ``FOLLOWER_FAULT_EXIT``.
- The loop's width and chunk equal JAX's backend's on the same mesh.
"""

import time

import numpy as np
import pytest

from _torch_mesh import port_config, port_tree
from _torch_mesh_worker import World
from conftest import shared_engine, shared_params
from k_llms_tpu.models import get_config

TINY = get_config("tiny")
LOOP = dict(continuous_batching=True, continuous_width=8, continuous_max_prompt=128,
            continuous_max_new=32, prefill_chunk_tokens=32)
# (prompt ids, loop.submit keywords); the second prompt (70 tokens) is
# ingested in three chunks of 32. The first runs the loop's 32 tokens, so
# the others join it in flight however slowly their submitter polls.
REQUESTS = [
    (list(range(1, 12)), dict(n=2, max_new=32, temperature=0.0, top_p=None, seed=1)),
    (list(range(20, 90)), dict(n=2, max_new=10, temperature=0.8, top_p=0.9, seed=5)),
    ([9, 8, 7, 6, 5], dict(n=3, max_new=12, temperature=1.0, top_p=0.95, seed=4)),
]
MESSAGES = [{"role": "user", "content": "stream parity"}]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The file's gloo worlds by (size, name), all started at once so that
    their ranks boot while the first JAX references compile (a world whose
    follower was made to fail is closed by its case)."""
    made = {key: World(key[0], tmp_path_factory.mktemp(f"{key[1]}{key[0]}"),
                       env={"KLLMS_RANK_CHECK": "1"})
            for key in ((2, "loop"), (4, "loop"), (2, "fault"))}

    yield lambda size, name="loop": made[size, name]
    for w in made.values():
        w.close()


@pytest.fixture(scope="module")
def jax_backend():
    """JAX's TpuBackend with the loop over the shared mesh engine of a
    shape, one per (shape, knobs), closed at the end."""
    from k_llms_tpu.backends.tpu import TpuBackend

    made = {}

    def get(shape, engine_kwargs=(), **knobs):
        key = (shape, engine_kwargs, tuple(sorted(knobs.items())))
        if key not in made:
            engine = shared_engine("tiny", mesh_shape=shape, **dict(engine_kwargs))
            made[key] = TpuBackend(model="tiny", max_new_tokens=8, engine=engine, **knobs)
        return made[key]

    yield get
    for b in made.values():
        b.close()


def _world_run(worlds, shape, script, engine_kwargs=None, backend_kwargs=None,
               world_name="loop", loop=LOOP, **kwargs):
    size = shape[0] * shape[1]
    res = worlds(size, world_name).run(
        "controller", shape=shape, config=port_config(TINY),
        params=port_tree(shared_params(TINY), TINY), script=script,
        engine_kwargs=dict(kv_page_size=8, **(engine_kwargs or {})),
        backend_kwargs=dict(max_new_tokens=8, **loop, **(backend_kwargs or {})), **kwargs)
    if not isinstance(res[1], int):
        assert all(r["follower"] is True for r in res[1:])
    return res


def _jax_results(backend, requests):
    """Each request alone through JAX's loop (self-deterministic: its tokens
    do not depend on what shares the batch)."""
    return [backend._continuous.submit(ids, **kw).result(timeout=120) for ids, kw in requests]


def _assert_same(got, want):
    assert "error" not in got, got
    np.testing.assert_array_equal(got["tokens"], np.asarray(want.tokens))
    np.testing.assert_allclose(got["logprobs"], np.asarray(want.logprobs), atol=1e-5, rtol=0)


def _assert_replicas_agree(ctl, followers):
    """Every follower ran every plan and ended with the controller's loop
    counters and page-allocator digest (its last ``loop_snapshot``)."""
    for fol in followers:
        assert fol["plans"] == ctl["plans"]
        assert fol["snapshots"][-1] == ctl["stats"]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=["dp2", "tp2", "dp2tp2"])
def test_paged_loop_across_ranks_equals_the_jax_loop(worlds, jax_backend, shape):
    """Three requests joining at steps 0, 1 and 2, the second chunked: their
    tokens are the JAX mesh loop's, each follower replayed every admission,
    chunk and step, and the next request is served."""
    want = _jax_results(jax_backend(shape, **LOOP), REQUESTS)
    ctl, *fols = _world_run(worlds, shape, "loop",
                            script_kwargs=dict(requests=REQUESTS, after=[0, 1, 2]))
    for i in range(len(REQUESTS)):
        _assert_same(ctl["results"][i], want[i])
    _assert_same(ctl["next"], want[0])
    st = ctl["stats"]
    assert st["admitted"] == 3 and st["joined_in_flight"] >= 1 and st["prefill_chunks"] == 3
    assert st["pages"] is not None and ctl["restarts"] == 0
    _assert_replicas_agree(ctl, fols)


def test_dense_loop_across_data_ranks_equals_the_jax_loop(worlds, jax_backend):
    want = _jax_results(jax_backend((2, 1), **LOOP), REQUESTS)
    ctl, fol = _world_run(worlds, (2, 1), "loop", engine_kwargs=dict(kv_layout="dense"),
                          script_kwargs=dict(requests=REQUESTS, after=[0, 1, 2]))
    for i in range(len(REQUESTS)):
        _assert_same(ctl["results"][i], want[i])
    assert ctl["stats"]["pages"] is None and ctl["stats"]["prefill_chunks"] == 3
    _assert_replicas_agree(ctl, [fol])


def test_grammar_and_streamed_requests_ride_the_loop(worlds, jax_backend):
    """A json_object request (its grammar sent to the follower in the
    admission's plan) and a sampled request plain and streamed: the loop
    admits all three, the streamed texts are the plain ones, and every text
    is the JAX mesh backend's."""
    from k_llms_tpu import KLLMs as JaxKLLMs

    reqs = [dict(n=2, seed=9, max_tokens=6, response_format={"type": "json_object"}),
            dict(n=2, seed=33, temperature=0.8)]
    ctl, fol = _world_run(worlds, (2, 1), "loop_client",
                          script_kwargs=dict(messages=MESSAGES, requests=reqs[:1]))
    ctl_s, fol_s = _world_run(worlds, (2, 1), "loop_client",
                              script_kwargs=dict(messages=MESSAGES, requests=reqs[1:],
                                                 stream_too=True))
    jc = JaxKLLMs(backend=jax_backend((2, 1), **LOOP), model="tiny")
    for got, kw in ((ctl["outs"][0], reqs[0]), (ctl_s["outs"][0], reqs[1])):
        want = jc.chat.completions.create(messages=MESSAGES, model="tiny", **kw)
        assert got["texts"] == [c.message.content for c in want.choices]
    assert ctl_s["outs"][0]["streamed"] == ctl_s["outs"][0]["texts"]
    assert ctl_s["outs"][0]["stream_chunks"] > 1
    assert ctl["admitted"] == 1 and ctl_s["admitted"] == 2
    _assert_replicas_agree(ctl, [fol])
    _assert_replicas_agree(ctl_s, [fol_s])


def test_coalesced_request_between_loop_steps(worlds, jax_backend):
    """A logit-bias request takes the coalescing path while the loop decodes:
    one launch, announced between two loop plans; its texts are JAX's, and
    the loop's requests still equal the JAX loop's."""
    from k_llms_tpu import KLLMs as JaxKLLMs

    ctl, fol = _world_run(worlds, (2, 1), "loop",
                          script_kwargs=dict(requests=REQUESTS[:2], after=[0, 0], bias_at=2))
    biased = ctl["biased"]
    assert "error" not in biased and biased["launches"] == 1
    jb = jax_backend((2, 1), **LOOP)
    want = JaxKLLMs(backend=jb, model="tiny").chat.completions.create(
        messages=[{"role": "user", "content": "spell"}], model="tiny", n=2, seed=3,
        temperature=0.0, max_tokens=6, logit_bias={"65": 5.0})
    assert biased["texts"] == [c.message.content for c in want.choices]
    for i, (ids, kw) in enumerate(REQUESTS[:2]):
        _assert_same(ctl["results"][i], jb._continuous.submit(ids, **kw).result(timeout=120))
    _assert_replicas_agree(ctl, [fol])


def test_abort_on_the_controller_retires_the_follower_rows(worlds, jax_backend):
    """Request 0's budget is spent at its third poll: the step's plan carries
    the abort, both ranks retire its rows after the same step (equal
    row-steps and pool digests), request 1 runs on, the next is served."""
    from k_llms_tpu_torch.types.wire import RequestCancelledError

    ctl, fol = _world_run(worlds, (2, 1), "loop",
                          script_kwargs=dict(requests=REQUESTS[:2], budget_polls=(0, 3)))
    assert ctl["results"][0]["error"] == RequestCancelledError.__name__
    ref = jax_backend((2, 1), **LOOP)._continuous
    _assert_same(ctl["results"][1], ref.submit(*REQUESTS[1][:1], **REQUESTS[1][1]).result(120))
    assert ctl["stats"]["aborted"] == 1
    _assert_replicas_agree(ctl, [fol])
    _assert_same(ctl["next"], ref.submit(REQUESTS[0][0], **REQUESTS[0][1]).result(timeout=120))


def test_worker_crash_resets_every_rank_and_serves_on(worlds, jax_backend):
    """The controller's continuous.worker crash fails the in-flight request
    typed; the reset plan retires its rows on the follower too (equal pool
    digests), and the next request equals JAX's."""
    ctl, fol = _world_run(worlds, (2, 1), "loop",
                          script_kwargs=dict(requests=REQUESTS[:1], crash_at=2))
    err = ctl["results"][0]
    assert err["error"] == "BackendUnavailableError" and "worker crashed" in err["message"]
    assert ctl["restarts"] == 1 and ctl["last_recovery_reason"] == "worker_crash"
    assert ctl["stats"]["active_rows"] == 0 and ctl["stopped"] is None
    _assert_replicas_agree(ctl, [fol])
    ref = jax_backend((2, 1), **LOOP)._continuous
    _assert_same(ctl["next"], ref.submit(REQUESTS[0][0], **REQUESTS[0][1]).result(timeout=120))


def test_hung_step_stops_the_world_with_a_typed_503(worlds, jax_backend):
    """A hung continuous.step (before its plan) on the controller, which
    once stopped the world: the watchdog's fault now rebuilds the engine on
    both ranks (the rebuild plan), the follower's replica starts empty on
    its new engine, the journalled request is re-admitted through announced
    admissions and equals JAX's loop, and the next request is served."""
    ctl, fol = _world_run(worlds, (2, 1), "loop",
                          backend_kwargs=dict(watchdog_min_budget_s=1.0,
                                              watchdog_max_budget_s=1.0),
                          script_kwargs=dict(requests=REQUESTS[:1], hang_at=2))
    ref = jax_backend((2, 1), **LOOP)._continuous
    want = ref.submit(REQUESTS[0][0], **REQUESTS[0][1]).result(timeout=120)
    _assert_same(ctl["results"][0], want)
    _assert_same(ctl["next"], want)
    assert ctl["restarts"] == 1 and ctl["last_recovery_reason"] == "hung_step"
    assert ctl["stopped"] is None and ctl["snapshot_error"] is None
    assert ctl["rebuilds"] == fol["rebuilds"] == 1
    _assert_replicas_agree(ctl, [fol])


def test_follower_step_fault_is_a_typed_503_and_ends_the_follower(worlds):
    """The follower's continuous.step raises on its first replayed step: it
    records the error and ends with FOLLOWER_FAULT_EXIT; the controller's
    request fails as the typed 503 naming that error, well within 60 s, and
    the next one gets the stopped world's 503."""
    from k_llms_tpu_torch.parallel.controller import FOLLOWER_FAULT_EXIT

    t0 = time.monotonic()
    ctl, code = _world_run(worlds, (2, 1), "loop", world_name="fault",
                           script_kwargs=dict(requests=REQUESTS[:1]),
                           follower_failpoints={"continuous.step": dict(action="raise", times=1)},
                           expect_exit={1: FOLLOWER_FAULT_EXIT})
    assert code == FOLLOWER_FAULT_EXIT and time.monotonic() - t0 < 60.0
    res = ctl["results"][0]
    assert res["error"] == "FollowerFaultError" and res["status"] == 503, res
    assert "injected failpoint fault" in res["message"]
    assert ctl["next"]["status"] == 503 and ctl["stopped"] is not None


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["dp2", "tp2"])
def test_loop_width_and_chunk_are_the_jax_backends(worlds, jax_backend, shape):
    """Without an explicit width the loop is sized by the memory model's
    mesh terms (tp divides the KV, dp multiplies the rows); the chunk is
    the auto one: both equal JAX's backend's on the same mesh, and the
    follower's replica has the controller's geometry."""
    knobs = dict(continuous_batching=True, continuous_max_prompt=128, continuous_max_new=32,
                 hbm_bytes=2_000_000)
    ctl, fol = _world_run(worlds, shape, "loop", loop=knobs, script_kwargs=dict(requests=[]))
    paged = (("kv_layout", "paged"), ("kv_page_size", 8))
    ref = jax_backend(shape, engine_kwargs=paged, **knobs)._continuous
    assert ctl["geometry"]["width"] == ref.width < 32
    assert ctl["geometry"]["prefill_chunk_tokens"] == ref.prefill_chunk_tokens > 0
    assert fol["snapshots"][-1]["width"] == ref.width
    assert fol["snapshots"][-1]["prefill_chunk_tokens"] == ref.prefill_chunk_tokens
