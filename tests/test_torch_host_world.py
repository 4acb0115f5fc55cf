"""JAX's multi-process start in the port (``parallel/distributed.py``,
``parallel/launcher.py``): the ``KLLMS_*`` variables count *processes*, and
each process drives its host's ranks, as ``jax.distributed`` gives each
process its local devices (``tests/test_multihost.py``: two processes of two
local devices see four).

Two plain subprocesses act as two hosts (``tests/_torch_hosts_script.py``):
``KLLMS_COORDINATOR`` on loopback, ``KLLMS_NUM_PROCESSES=2``,
``KLLMS_PROCESS_ID`` 0 and 1 and ``KLLMS_LOCAL_RANKS=2`` each. Each calls
``initialize_multihost()``, which starts its follower into the global world
of four ranks (host-major: host 0 holds ranks 0 and 1), and builds
``KLLMs(backend="cuda", device="cpu", model_parallel=m)`` over a native
checkpoint written from the parity harness's JAX tree, making the same calls
as the other host:

- on (2, 2) (the model axis inside a host, ``data`` across the hosts) and
  (4, 1), the greedy tokens equal the JAX mesh engine's of the same shape
  exactly, and the logprobs and every rank's prefill logits stay within
  1e-5; both hosts give equal responses; the world outlives the client, as
  JAX's distributed runtime does: a second client on it sees the same four
  ranks, the world's close ends every follower with exit code 0, and a
  client built after it raises rather than start a world of fewer ranks;
- JAX's two-process collective test at its shape, as a hook of the (4, 1)
  client on every rank: the ``psum`` over ``data`` crosses the process
  boundary, and the loss equals the JAX forward's (rel 1e-5);
- a follower killed on host 1 while idle, or during a launch (from host
  0's first streamed token's sink), stops the world on both hosts within
  seconds: ``STOPPED``, the launch in flight and the next request on each
  host get the typed 503; every host process exits 0 and no follower
  outlives it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_hosts import results, start_hosts
from _torch_mesh import port_tree
from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config

TINY = get_config("tiny")
SHAPES = [(2, 2), (4, 1)]
PROMPT = list(range(7, 40))
N, MAX_NEW = 3, 6
#: Seconds within which a killed follower stops the world on every host.
STOP_LIMIT_S = 10.0


def _collective_weights(path):
    """JAX's two-process test's inputs: the 2-layer tiny weights and each
    process's two rows of 16 tokens, in one ``.npz``; the JAX forward's
    loss over all four rows."""
    import jax

    from k_llms_tpu.models import init_params
    from k_llms_tpu.models.llama import forward

    cfg = TINY.with_(num_layers=2)
    params = jax.device_get(init_params(cfg, jax.random.key(0)))
    tokens = np.concatenate([(np.arange(2 * 16).reshape(2, 16) + 100 * pid) % cfg.vocab_size
                             for pid in range(2)]).astype(np.int64)
    arrays = {"tokens": tokens}
    for name, leaf in params.items():
        if name == "layers":
            arrays.update({f"layers/{k}": np.asarray(v) for k, v in leaf.items()})
        else:
            arrays[name] = np.asarray(leaf)
    np.savez(path, **arrays)
    logits, _ = forward(cfg, params, jnp.asarray(tokens, jnp.int32),
                        jnp.ones(tokens.shape, jnp.int32))
    return float(jnp.mean(jnp.square(logits.astype(jnp.float32))))


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """Both shapes' worlds, started at once (two hosts each); the (4, 1)
    one also runs the collective test. ``loss``: the JAX forward's."""
    from k_llms_tpu_torch.models import loader

    tmp = tmp_path_factory.mktemp("hosts")
    ckpt = str(tmp / "tiny")
    loader.save_checkpoint(ckpt, port_tree(shared_params(TINY), TINY))
    weights = str(tmp / "weights.npz")
    loss = _collective_weights(weights)
    procs = {shape: start_hosts("world", shape=list(shape), ckpt=ckpt, prompt=PROMPT, n=N,
                                max_new=MAX_NEW, weights=weights if shape == (4, 1) else None)
             for shape in SHAPES}
    return {"loss": loss, **{shape: results(p) for shape, p in procs.items()}}


@pytest.mark.duration_budget(30)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{m}" for d, m in SHAPES])
def test_two_hosts_of_two_ranks_equal_the_jax_mesh(hosts, shape):
    from k_llms_tpu.models.llama import prefill

    d, m = shape
    got = hosts[shape]
    # The world counts every process's ranks, host-major.
    assert [h["world"] for h in got] == [4, 4]
    assert [h["host_ranks"] for h in got] == [[0, 1], [2, 3]]
    assert [h["rank"] for h in got] == [0, 2]
    ref = shared_engine("tiny", mesh_shape=shape).generate_many(
        [JaxSpec(PROMPT, N, 3)], max_new_tokens=MAX_NEW, temperature=0.0)[0]
    params = shared_params(TINY)
    for host in got:
        assert host["mesh"] == {"data": d, "model": m}
        assert host["is_controller"] and host["followers"] == 1
        np.testing.assert_array_equal(np.asarray(host["tokens"]), ref.tokens)
        np.testing.assert_allclose(np.asarray(host["logprobs"]), ref.logprobs, atol=1e-5, rtol=0)
        assert len(host["ranks"]) == 2
        for rank in host["ranks"]:
            tokens = rank["ids"] + [TINY.pad_token_id] * (rank["bucket"] - rank["plen"])
            want, _ = prefill(TINY, params, jnp.asarray([tokens]), jnp.int32(rank["plen"]))
            np.testing.assert_allclose(np.asarray(rank["logits"]), np.asarray(want)[0],
                                       atol=1e-5, rtol=0)
        # The world outlives the client: a second one sees the same ranks
        # and serves the same tokens; the world's close ends the follower.
        assert host["alive_after_close"] == [True]
        second = host["second"]
        assert second["same_world"] and second["mesh"] == host["mesh"]
        assert (second["world"], second["rank"]) == (4, host["rank"])
        assert second["host_ranks"] == host["host_ranks"]
        assert second["tokens"] == host["tokens"]
        assert host["exit_codes"] == [0] and host["alive"] == []
        # Once the world has closed, no client starts a smaller one.
        assert host["after_end"]["type"] == "RuntimeError", host["after_end"]
        assert "has closed" in host["after_end"]["message"]
    # Both hosts made the same calls and give the same response.
    assert got[0]["texts"] == got[1]["texts"] and len(got[0]["texts"]) == 3
    assert got[0]["likelihoods"] == got[1]["likelihoods"]


def test_two_processes_of_two_ranks_see_four(hosts):
    """JAX's ``tests/test_multihost.py`` at its shape: two processes of two
    local ranks, a world of four."""
    got = hosts[(4, 1)]
    ranks = [r for h in got for r in h["collectives"]]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["mesh"] == {"data": 4, "model": 1}
        assert r["total"] == 0 + 1 + 10 + 11
        assert r["dotsum"] == 2 * (0 + 1 + 10 + 11)
        assert r["loss"] == ranks[0]["loss"]
        assert r["loss"] == pytest.approx(hosts["loss"], rel=1e-5)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture(scope="module")
def faults():
    """The idle kill's world and the in-flight kill's, started at once."""
    procs = {case: start_hosts(case, stop_limit_s=STOP_LIMIT_S) for case in ("fault", "inflight")}
    return {case: results(p) for case, p in procs.items()}


@pytest.mark.duration_budget(30)
def test_a_follower_lost_on_one_host_stops_the_world_on_every_host(faults):
    fault = faults["fault"]
    killed_at = fault[1]["killed_at"]
    assert fault[0]["first"] == fault[1]["first"]
    for host in fault:
        assert host["state"] == "stopped", host
        assert host["terminal"] is not None
        assert host["stopped_at"] - killed_at < STOP_LIMIT_S
        err = host["error"]
        assert err is not None and err["status"] == 503, host
        assert "BackendUnavailableError" in err["bases"]
        assert host["error_s"] < 1.0
        # The killed follower, and host 0's, which its host ended.
        assert host["alive"] == [] and len(host["exit_codes"]) == 1


def test_a_follower_lost_during_a_launch_fails_it_on_every_host(faults):
    inflight = faults["inflight"]
    # Host 0 killed host 1's follower from its first streamed token.
    killed_at = inflight[0]["killed_at"]
    assert killed_at is not None
    for host in inflight:
        # The launch in flight on each host: the typed 503 within seconds.
        err = host["error"]
        assert err is not None and err["status"] == 503, host
        assert "BackendUnavailableError" in err["bases"]
        assert err["at"] - killed_at < STOP_LIMIT_S
        assert host["state"] == "stopped", host
        after = host["after"]
        assert after is not None and after["status"] == 503, host
        # Both host processes exited 0 (``results``); their exits ended
        # every follower.
        assert not any(_alive(pid) for pid in host["followers"])


def test_a_process_without_a_card_must_ask_for_the_cpu(monkeypatch):
    """Nothing falls back: a process of a world of several processes that
    sees no card raises, before it reaches the coordinator, unless it asked
    for the CPU."""
    import torch

    from k_llms_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, value in (("KLLMS_COORDINATOR", "127.0.0.1:1"), ("KLLMS_NUM_PROCESSES", "2"),
                        ("KLLMS_PROCESS_ID", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_multihost()
