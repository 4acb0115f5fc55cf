"""A plain process builds its host's world, as JAX's one process drives
every local chip (``parallel/launcher.py``): the port's twin of
``KLLMs(backend="tpu", model_parallel=...)`` on the forced CPU devices of
``tests/conftest.py``.

One subprocess (``tests/_torch_spawned_script.py``) sets the forced local
rank count (``KLLMS_LOCAL_RANKS``) to 2, 2 and 4 in turn and builds
``KLLMs(backend="cuda", device="cpu", model_parallel=m)`` over a native
checkpoint written from the parity harness's JAX tree (each follower loads
its own shard). On (1, 2), (2, 1) and (2, 2) the greedy tokens equal the JAX
mesh engine's exactly and the logprobs and every rank's prefill logits stay
within 1e-5; ``close()`` ends every follower with exit code 0. A model
registered only in the controlling process (a cut depth) is served on every
rank. A process of a world started rank by rank (``LOCAL_RANK`` set) or
inside a process group spawns nothing (the hand-started twins, unchanged,
are the end-to-end check), and a ``model_parallel`` that does not divide
the rank count raises JAX's ``auto_mesh`` error before any child starts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import port_config, port_tree
from _torch_spawned import result, start
from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config

TINY = get_config("tiny")
SHAPES = [(1, 2), (2, 1), (2, 2)]
PROMPT = list(range(7, 40))
N, MAX_NEW = 3, 6


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from k_llms_tpu_torch.models import loader

    ckpt = str(tmp_path_factory.mktemp("spawned") / "tiny")
    loader.save_checkpoint(ckpt, port_tree(shared_params(TINY), TINY))
    return result(start("world", shapes=SHAPES, ckpt=ckpt, prompt=PROMPT, n=N,
                        max_new=MAX_NEW), timeout=150)


@pytest.mark.duration_budget(25)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{m}" for d, m in SHAPES])
def test_spawned_world_equals_the_jax_mesh(spawned, shape):
    from k_llms_tpu.models.llama import prefill

    d, m = shape
    got = spawned[f"{d}x{m}"]
    assert got["mesh"] == {"data": d, "model": m}
    assert got["is_controller"] and got["followers"] == d * m - 1
    ref = shared_engine("tiny", mesh_shape=shape).generate_many(
        [JaxSpec(PROMPT, N, 3)], max_new_tokens=MAX_NEW, temperature=0.0)[0]
    np.testing.assert_array_equal(np.asarray(got["tokens"]), ref.tokens)
    np.testing.assert_allclose(np.asarray(got["logprobs"]), ref.logprobs, atol=1e-5, rtol=0)
    params = shared_params(TINY)
    assert len(got["ranks"]) == d * m
    for rank in got["ranks"]:
        tokens = rank["ids"] + [TINY.pad_token_id] * (rank["bucket"] - rank["plen"])
        want, _ = prefill(TINY, params, jnp.asarray([tokens]), jnp.int32(rank["plen"]))
        np.testing.assert_allclose(np.asarray(rank["logits"]), np.asarray(want)[0],
                                   atol=1e-5, rtol=0)
    assert got["exit_codes"] == [0] * (d * m - 1) and got["alive"] == []


@pytest.mark.duration_budget(25)
def test_a_model_registered_only_in_the_controller_is_served(spawned):
    """``tiny-cut`` exists only in the controlling process's registry: the
    followers serve the resolved config they are sent."""
    cut = spawned["cut"]
    assert cut["models"] == [["tiny-cut", 1], ["tiny-cut", 1]]
    assert len(cut["texts"]) == 3
    assert cut["exit_codes"] == [0] and cut["alive"] == []


def test_model_parallel_must_divide_the_local_ranks(monkeypatch):
    """JAX's auto_mesh error, before any follower starts."""
    from k_llms_tpu.parallel.mesh import auto_mesh
    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.parallel import launcher

    with pytest.raises(ValueError) as want:
        auto_mesh(jax.devices()[:3], model_parallel=2)

    def no_world(*a, **k):
        raise AssertionError("a follower was started")

    monkeypatch.setattr(launcher, "SpawnedWorld", no_world)
    monkeypatch.setenv("KLLMS_LOCAL_RANKS", "3")
    with pytest.raises(ValueError) as got:
        KLLMs(backend="cuda", model="tiny", device="cpu", model_parallel=2)
    assert str(got.value) == str(want.value)


def test_only_a_plain_process_spawns(monkeypatch):
    """A process counts its host's ranks as JAX counts its devices: the
    forced count of 4 starts 3 followers, with or without the ``KLLMS_*``
    variables of a world of several processes (each process drives its
    host's ranks); a rank started rank by rank (``LOCAL_RANK`` set, as
    ``torchrun`` and the launcher's own followers have it), a forced count of
    one, or the CPU without a forced count start none."""
    from k_llms_tpu_torch.parallel.distributed import local_rank_count, spawns_world

    for name in ("KLLMS_LOCAL_RANKS", "KLLMS_COORDINATOR", "KLLMS_NUM_PROCESSES",
                 "KLLMS_PROCESS_ID", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert local_rank_count("cpu") == 1 and spawns_world("cpu") == 0
    monkeypatch.setenv("KLLMS_LOCAL_RANKS", "4")
    assert spawns_world("cpu") == 3
    for name, value in (("KLLMS_COORDINATOR", "127.0.0.1:1"), ("KLLMS_NUM_PROCESSES", "2"),
                        ("KLLMS_PROCESS_ID", "1")):
        monkeypatch.setenv(name, value)
        assert spawns_world("cpu") == 3
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert spawns_world("cpu") == 0
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("KLLMS_LOCAL_RANKS", "1")
    assert spawns_world("cpu") == 0
