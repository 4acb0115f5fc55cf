"""The controlling rank (``parallel/controller.py``), JAX's single controller
on one process per card: only rank 0 is called, and the host's other ranks
replay its plans.

- In a gloo world of two spawned ranks (``_torch_mesh_worker``) on the
  (2, 1) mesh with the parity harness's tiny fp32 weights: three threads'
  ``create()`` coalesce into one launch whose rows split over ``data``, equal
  to the JAX mesh engine's coalesced group on ``make_mesh(2, 1)``; a
  grammar-constrained ``parse()`` (its schema compiled on the follower)
  equals the one-process port's; a member aborted on the controller stops on
  the follower at the same step, and the world serves the next request.
- The one script on two OS processes started from the ``KLLMS_*``
  environment (``initialize_multihost``, host names through the
  coordinator's store): ``close()`` ends the follower with exit code 0, and a
  follower's fault reaches the controller as the typed 503 within seconds,
  the follower ending with ``FOLLOWER_FAULT_EXIT``.
- The host-rank derivation from host names, and the memory model's row caps
  against the JAX package's for the same ``tp``, ``dp`` and config.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from _torch_mesh import port_config, port_tree, world_fixture
from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = get_config("tiny")

world = world_fixture(2)


def _controller(world, script, shape=(2, 1), backend_kwargs=None, **script_kwargs):
    res = world.run("controller", shape=shape, config=port_config(TINY),
                    params=port_tree(shared_params(TINY), TINY), script=script,
                    engine_kwargs=dict(kv_page_size=8),
                    backend_kwargs=dict(max_new_tokens=8, **(backend_kwargs or {})),
                    script_kwargs=script_kwargs)
    assert res[1]["follower"] is True
    return res


def test_concurrent_creates_coalesce_into_one_launch_equal_to_jax(world):
    """Three threads call create() on the controller only: one launch of
    three requests (B = 16 rows, 8 a rank), replayed once on the follower,
    and its tokens are the JAX mesh engine's for the same members."""
    ctl, fol = _controller(world, "coalesce", backend_kwargs=dict(batch_window=1.0),
                           contents=["alpha", "bravo two", "charlie three"], n=3, seed=21,
                           max_tokens=6, temperature=0.8)
    assert len(ctl["launches"]) == 1, ctl["launches"]
    launch = ctl["launches"][0]
    assert len(launch["members"]) == 3
    assert launch["stats"]["rows"] == 16 and launch["stats"]["rank_rows"] == 8
    assert fol["plans"] == ctl["plans"] == 1
    ref = shared_engine("tiny", mesh_shape=(2, 1)).generate_many(
        [JaxSpec(ids, n, seed) for ids, n, seed in launch["members"]], **launch["kw"])
    for got, want in zip(launch["results"], ref):
        np.testing.assert_array_equal(got["tokens"], want.tokens)
        np.testing.assert_allclose(got["logprobs"], want.logprobs, atol=1e-5, rtol=0)
    assert all(len(t) == 4 for t in ctl["texts"])


def test_parse_travels_as_its_schema_and_equals_one_process(world):
    """parse() through the controller: the follower compiles the schema's
    grammar itself (same digest), and the texts equal a one-process port
    backend's on the same weights."""
    from _torch_serving import port_backend
    from k_llms_tpu_torch import KLLMs

    req = dict(content="extract the item", n=2, seed=4, max_tokens=24)
    ctl, fol = _controller(world, "parse", **req)
    assert fol["plans"] == 1 and len(ctl["launches"]) == 1
    assert type(ctl["launches"][0]["constraint"]).__name__ == "CompiledGrammar"
    one = KLLMs(backend=port_backend(max_new_tokens=8))
    try:
        import pydantic

        class Item(pydantic.BaseModel):
            name: str
            qty: int

        r = one.chat.completions.parse(
            messages=[{"role": "user", "content": req["content"]}], response_format=Item,
            n=req["n"], seed=req["seed"], max_tokens=req["max_tokens"], temperature=0.0)
    finally:
        one.close()
    assert ctl["texts"] == [c.message.content for c in r.choices]


def test_abort_on_the_controller_stops_the_follower_rows(world):
    """A coalesced member cancelled by the controller's poller stops on the
    follower at the same step (the loop test's reduction carries the flag);
    the other member runs on; the world serves the next request."""
    ctl, fol = _controller(world, "abort", prompt=list(range(5, 30)), n=2, seed=3,
                           max_tokens=24, polls=3)
    assert ctl["outcomes"][0] == "RequestCancelledError"
    assert isinstance(ctl["outcomes"][1], dict)
    aborted = ctl["stats"]["aborted"]
    assert list(aborted) == [0]
    snap = fol["snapshots"][0]
    assert {j: s for j, (s, _) in snap["aborted"].items()} == {0: aborted[0][0]}
    assert snap["decode_steps"] == ctl["stats"]["decode_steps"]
    assert snap["rank_rows"] == ctl["stats"]["rank_rows"] == 2
    assert len(ctl["next"]) == 3
    assert fol["plans"] == 3  # the launch, the snapshot hook, the next launch


WORKER = r"""
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch
torch.set_num_threads(1)
from k_llms_tpu_torch.parallel.distributed import host_ranks, initialize_multihost
assert initialize_multihost(device="cpu")
import torch.distributed as dist
from k_llms_tpu_torch import KLLMs

client = KLLMs(backend="cuda", model="tiny", device="cpu", max_new_tokens=6)
host = host_ranks()
print(f"HOST {dist.get_rank()} {host.local_rank} {host.local_world} {host.ranks}", flush=True)
if client.backend.is_controller:
    for _ in range(2):
        t0 = time.monotonic()
        try:
            r = client.chat.completions.create(
                messages=[{"role": "user", "content": "hi"}], n=2, seed=1)
            print("OK", len(r.choices), flush=True)
        except Exception as e:
            print("ERR", type(e).__name__, getattr(e, "status_code", None),
                  round(time.monotonic() - t0, 3), str(e).replace(chr(10), " "), flush=True)
else:
    print("FOLLOWER_PLANS", client.backend.controller.plans, flush=True)
client.close()
print("DONE", dist.get_rank(), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _one_script(follower_env=None, timeout=90):
    """The README's one script on two processes; returns (exit codes, outputs)."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PYTEST") and k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
        env.update(KLLMS_COORDINATOR=f"127.0.0.1:{port}", KLLMS_NUM_PROCESSES="2",
                   KLLMS_PROCESS_ID=str(pid), KLLMS_FAILPOINTS="")
        if pid == 1:
            env.update(follower_env or {})
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def test_one_script_close_ends_the_follower_with_zero():
    """Both processes run the same script; the host's ranks come from the
    host names exchanged through the coordinator's store; the follower's
    constructor returns after the controller's close() and it exits 0."""
    codes, outs = _one_script()
    assert codes == [0, 0], outs
    assert "HOST 0 0 2 [0, 1]" in outs[0] and "HOST 1 1 2 [0, 1]" in outs[1], outs
    assert outs[0].count("OK 3") == 2
    assert "FOLLOWER_PLANS 2" in outs[1] and "DONE 1" in outs[1]


def test_follower_fault_is_a_typed_503_within_seconds():
    """A follower whose launch raises (the engine.launch failpoint armed in
    its process only) ends its process; the controller's request fails as
    the typed 503 within seconds, never hanging in a collective, and the
    stopped world answers the next request with the same 503."""
    from k_llms_tpu_torch.parallel.controller import FOLLOWER_FAULT_EXIT

    codes, outs = _one_script({"KLLMS_FAILPOINTS": "engine.launch=raise:1"})
    assert codes == [0, FOLLOWER_FAULT_EXIT], outs
    errs = [line.split() for line in outs[0].splitlines() if line.startswith("ERR")]
    assert len(errs) == 2, outs[0]
    for err in errs:
        assert err[1] == "FollowerFaultError" and err[2] == "503", err
        assert float(err[3]) < 20.0
    assert "injected failpoint fault" in outs[0]


def test_host_ranks_from_host_names():
    """Ranks sharing a host name share a host: two hosts of four."""
    from k_llms_tpu_torch.parallel.distributed import (default_transport,
                                                       host_ranks_from_names)

    names = ["a"] * 4 + ["b"] * 4
    assert host_ranks_from_names(names, 0) == (0, 4, [0, 1, 2, 3])
    h = host_ranks_from_names(names, 6)
    assert h == (2, 4, [4, 5, 6, 7])
    assert default_transport("cuda", h.local_world, 4) == "nccl"
    assert host_ranks_from_names(["x", "y", "x", "y"], 3) == (1, 2, [1, 3])


@pytest.mark.parametrize("tp,dp", [(1, 1), (2, 1), (1, 4), (2, 2), (4, 2)])
def test_memory_model_caps_equal_jax(tp, dp):
    """The port's HbmMemoryModel gives the JAX package's row caps, dense and
    paged, for the same config, whole-tree bytes, tp and dp."""
    from k_llms_tpu.backends.tpu import HbmMemoryModel as JaxModel
    from k_llms_tpu_torch.backends.cuda import HbmMemoryModel
    from k_llms_tpu_torch.models.config import get_config as port_get_config

    for name in ("llama-3-8b", "tiny"):
        kw = dict(param_bytes=16_060_000_000 if name != "tiny" else 10_000_000,
                  hbm_bytes=80 * (1 << 30), headroom=0.85, tp=tp, dp=dp)
        port = HbmMemoryModel(port_get_config(name), **kw)
        jax_model = JaxModel(get_config(name), **kw)
        assert port.budget_bytes() == jax_model.budget_bytes()
        for seq in (64, 2048, 8192):
            assert port.max_rows(seq) == jax_model.max_rows(seq)
        for plen, new, fan in ((100, 64, 1), (3000, 256, 8), (40, 500, 32)):
            assert port.paged_max_rows(plen, new, 64, fan) == jax_model.paged_max_rows(
                plen, new, 64, fan)
        assert port.describe()["tp"] == tp and port.describe()["dp"] == dp


def test_whole_tree_bytes_are_the_jax_engines(world):
    """On a (1, 2) mesh the port engine measures its shard; its whole-tree
    count (what the memory model divides by tp) equals the JAX mesh engine's
    param_footprint_bytes, int8 scales included."""
    from _torch_mesh import jax_mesh
    from k_llms_tpu.engine.engine import LocalEngine as JaxEngine

    params = shared_params(TINY)
    res = world.run("engine", shape=(1, 2), config=port_config(TINY),
                    params=port_tree(params, TINY), engine_kwargs=dict(quantize="int8"),
                    calls=[("fn", "param_bytes", (False,)), ("fn", "param_bytes", (True,))])
    want = JaxEngine(TINY, params=params, mesh=jax_mesh(1, 2), quantize=True).param_footprint_bytes()
    for shard, whole in res:
        assert whole == want and shard < whole
