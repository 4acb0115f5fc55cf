"""Speculative launches and the ring decode with their rows split over the
data axis, held against the JAX package's mesh engines: gloo worlds of two
and four spawned port ranks (``_torch_mesh_worker``) on the (2, 1) and
(2, 2) meshes beside the JAX mesh engine of the same shape on the forced CPU
devices. Tiny fp32 weights from the parity harness's seed.

- Prompt-lookup speculation, solo (n = 4) and coalesced (three requests
  with n = 3: n pads to 4 and the requests to four, B = 16 rows), greedy and
  seeded-sampled: tokens exactly JAX's, logprobs within 1e-5, the results'
  and the engine's ``spec_stats`` (and ``last_launch_stats["spec"]``) equal
  to JAX's, and each rank decoded B/D rows (``rank_rows``).
- Two requests whose rows sit on different data ranks and finish after
  different numbers of verify iterations: both ranks run the longer count
  (the loop test is decided over ``data``), and the results equal JAX's.
- The ring decode (``sp_decode``) on (2, 1): a solo request's rows split
  over the ring's axis, tokens and logprobs equal to JAX's sp-decode mesh
  engine, and its speculative twin likewise."""

import jax
import numpy as np
import pytest

from _torch_mesh import port_config, port_tree
from _torch_mesh_worker import World
from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config

TINY = get_config("tiny")
SPEC = dict(speculative="prompt_lookup", spec_lookahead=4)
# A prompt that repeats itself (drafts get accepted) and two that do not.
LOOP = [int(x) for x in jax.random.randint(jax.random.key(1), (12,), 5, 200)]
PROMPTS = [LOOP * 4, list(range(60, 75)), list(range(100, 160))]
SEEDS = [7, 8, 9]
SP = dict(sp_prefill_min_tokens=48, sp_decode=True)
SP_PROMPT = [int(x) for x in jax.random.randint(jax.random.key(40), (64,), 5, 200)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world per size, made on first use and kept for the file."""
    made = {}

    def get(size):
        if size not in made:
            made[size] = World(size, tmp_path_factory.mktemp(f"specrows{size}"),
                               env={"KLLMS_RANK_CHECK": "1"})
        return made[size]

    yield get
    for w in made.values():
        w.close()


def _port(worlds, shape, calls, engine_kwargs, key):
    return worlds(shape[0] * shape[1]).run(
        "engine", shape=shape, config=port_config(TINY),
        params=port_tree(shared_params(TINY), TINY),
        engine_kwargs=dict(kv_page_size=8, **engine_kwargs),
        calls=calls + [("attr", "last_launch_stats"), ("attr", "spec_stats")], key=key)


def _same(got, want):
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=1e-5, rtol=0)
    assert got["finish_reasons"] == want.finish_reasons
    assert got["spec_stats"] == want.spec_stats


def _check_mirrors(stats, spec_stats, eng, rows, rank_rows):
    assert stats["rows"] == rows and stats["rank_rows"] == rank_rows, stats
    assert spec_stats == eng.spec_stats
    assert stats["spec"] == eng.spec_stats


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_solo_speculation_splits_rows_and_matches_jax_mesh(worlds, shape, temperature):
    """A solo spec launch of n = 4: each data rank verifies its 2 rows, and
    the gathered result and stats are the JAX mesh spec engine's."""
    kw = dict(n=4, max_new_tokens=12, temperature=temperature, seed=11)
    eng = shared_engine("tiny", mesh_shape=shape, **SPEC)
    want = eng.generate(PROMPTS[0], **kw)
    res = _port(worlds, shape, [("generate", (PROMPTS[0],), kw)], SPEC, ("spec", shape))
    for got, stats, spec_stats in res:
        _same(got, want)
        _check_mirrors(stats, spec_stats, eng, rows=4, rank_rows=2)
    assert want.spec_stats["verify_iterations"] >= 1


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_coalesced_speculation_splits_rows_and_matches_jax_mesh(worlds, shape, temperature):
    """Three requests of n = 3 in one spec launch (B = 16, 8 a rank): every
    member equals JAX's, with its iterations and rate, and the engine's
    coalesced mirror is JAX's."""
    kw = dict(max_new_tokens=10, temperature=temperature)
    eng = shared_engine("tiny", mesh_shape=shape, **SPEC)
    want = eng.generate_many([JaxSpec(p, 3, s) for p, s in zip(PROMPTS, SEEDS)], **kw)
    res = _port(worlds, shape,
                [("generate_many", ([(p, 3, s) for p, s in zip(PROMPTS, SEEDS)],), kw)],
                SPEC, ("spec", shape))
    for out, stats, spec_stats in res:
        for got, w in zip(out, want):
            _same(got, w)
        _check_mirrors(stats, spec_stats, eng, rows=16, rank_rows=8)
        assert spec_stats["coalesced_requests"] == 3


def test_ranks_whose_rows_finish_apart_run_the_same_iterations(worlds):
    """Request 0 (the repeating prompt, accepted drafts) sits on data rank
    0 and request 1 on rank 1; their rows need different numbers of verify
    iterations, and both ranks run the larger count, as JAX's sharded
    while_loop does."""
    kw = dict(max_new_tokens=16, temperature=0.0)
    members = [(PROMPTS[0], 2, 3), (PROMPTS[2], 2, 4)]
    eng = shared_engine("tiny", mesh_shape=(2, 1), **SPEC)
    want = eng.generate_many([JaxSpec(*m) for m in members], **kw)
    res = _port(worlds, (2, 1), [("generate_many", (members,), kw)], SPEC, ("spec", (2, 1)))
    iters = [w.spec_stats["verify_iterations"] for w in want]
    assert iters[0] != iters[1], iters
    for out, stats, spec_stats in res:
        for got, w in zip(out, want):
            _same(got, w)
        assert stats["rank_rows"] == 2
        assert stats["decode_steps"] == max(iters) == spec_stats["verify_iterations"]


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "speculative"])
def test_ring_decode_splits_rows_and_matches_jax_sp_engine(worlds, spec):
    """The ring-decode route on (2, 1): a solo request of n = 4 over its
    sequence-sharded prefix, each rank's 2 rows rotating the ring; the JAX
    sp-decode mesh engine's tokens and logprobs."""
    knobs = dict(SP, **(SPEC if spec else {}))
    kw = dict(n=4, max_new_tokens=8, temperature=0.7, seed=5)
    eng = shared_engine("tiny", mesh_shape=(2, 1), **knobs)
    want = eng.generate(SP_PROMPT, **kw)
    res = _port(worlds, (2, 1), [("collectives",), ("generate", (SP_PROMPT,), kw),
                                 ("collectives",)], knobs, ("sp", spec))
    for _, got, counts, stats, _ in res:
        np.testing.assert_array_equal(got["tokens"], want.tokens)
        np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=1e-5, rtol=0)
        assert stats["rows"] == 4 and stats["rank_rows"] == 2
        assert counts["ppermute"] > 0
        # One all_gather of the results at the launch's end, none a layer.
        assert counts["all_gather"] == 1, counts


def test_controller_abort_stops_speculation_on_every_rank(worlds):
    """Under the controlling rank a spec member cancelled by the
    controller's poller stops on the follower at the same verify iteration
    (the loop test's reduction carries the flag); the other member runs on,
    and the world serves the next request."""
    ctl, fol = worlds(2).run(
        "controller", shape=(2, 1), config=port_config(TINY),
        params=port_tree(shared_params(TINY), TINY), script="abort",
        engine_kwargs=dict(kv_page_size=8, **SPEC), backend_kwargs=dict(max_new_tokens=8),
        script_kwargs=dict(prompt=list(range(5, 30)), n=2, seed=3, max_tokens=24, polls=3))
    assert ctl["outcomes"][0] == "RequestCancelledError"
    assert isinstance(ctl["outcomes"][1], dict)
    aborted = ctl["stats"]["aborted"]
    assert list(aborted) == [0]
    snap = fol["snapshots"][0]
    assert {j: s for j, (s, _) in snap["aborted"].items()} == {0: aborted[0][0]}
    assert snap["decode_steps"] == ctl["stats"]["decode_steps"]
    assert snap["rank_rows"] == ctl["stats"]["rank_rows"] == 2
    assert len(ctl["next"]) == 3
