"""The scripts of the multi-process twins: one process a host, started with
JAX's ``KLLMS_COORDINATOR``/``KLLMS_NUM_PROCESSES``/``KLLMS_PROCESS_ID`` and
``KLLMS_LOCAL_RANKS`` ranks a host, which calls ``initialize_multihost`` as
a JAX script does (it starts the host's followers into the world of every
process) and then runs one case. The world outlives the case's clients and
ends with the process, unless the case closes it.

Run as ``python tests/_torch_hosts_script.py <case> <json kwargs>`` (the
test sets the variables); the last line of standard output is ``RESULT
<json>`` (the followers write to standard error). A case is a function
``case_<name>(**kwargs)`` of this module. This module imports torch and the
port only, never JAX: the JAX references are computed in the test process.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from k_llms_tpu_torch.parallel.distributed import host_ranks, initialize_multihost  # noqa: E402

REQ = dict(messages=[{"role": "user", "content": "count the apples"}], n=2, seed=5,
           temperature=0.7, max_tokens=8)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _place():
    host = host_ranks()
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "host_ranks": host.ranks}


def _end(world):
    """The host's world closed (what the process's exit does otherwise):
    each follower's exit code, and the followers still alive."""
    world.close()
    return {"exit_codes": [p.returncode for p in world.procs],
            "alive": [pid for _, _, pid, _ in world.ended if _alive(pid)]}


def collective_body(engine, weights):
    """JAX's two-process test on every rank of the host, a hook of a client
    over a (4, 1) mesh: a psum over ``data`` of each device's value
    (``arange(2) + 10 * process``) and the tiny forward with the batch's
    rows split over ``data``, its loss reduced over the world; gathered on
    the host's ranks."""
    import numpy as np

    from k_llms_tpu_torch.models.config import get_config
    from k_llms_tpu_torch.models.llama import forward, params_from_numpy
    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.mesh import DATA_AXIS

    mesh = engine.mesh
    host = host_ranks()
    rank = dist.get_rank()
    process = (rank - host.local_rank) // host.local_world
    mine = torch.tensor([float(host.local_rank + 10 * process)])
    total = float(C.psum(mine, DATA_AXIS, mesh))
    dotsum = float(C.psum((mine * 2.0).sum(), DATA_AXIS, mesh))
    cfg = get_config("tiny").with_(num_layers=2)
    with np.load(weights) as f:
        arrays = dict(f)
    tokens = torch.from_numpy(arrays.pop("tokens"))
    tree = {"layers": {}}
    for name, arr in arrays.items():
        if name.startswith("layers/"):
            tree["layers"][name[len("layers/"):]] = arr
        else:
            tree[name] = arr
    params = params_from_numpy(tree, cfg)
    rows = tokens.shape[0] // mesh.axis_size(DATA_AXIS)
    idx = mesh.axis_index(DATA_AXIS)
    mine_rows = tokens[idx * rows:(idx + 1) * rows]
    logits, _ = forward(cfg, params, mine_rows, torch.ones_like(mine_rows))
    sq = C.psum((logits.double() ** 2).sum(), DATA_AXIS, mesh)
    loss = float(sq) / (tokens.numel() * logits.shape[-1])
    return engine.host_controller.gather({"rank": rank, "mesh": dict(mesh.shape),
                                          "total": total, "dotsum": dotsum, "loss": loss})


def case_world(shape, ckpt, prompt, n, max_new, weights=None):
    """A greedy launch through the host's engine (replayed on its
    followers; its rows split over ``data`` across the hosts), every rank
    of the host's prefill logits, one sampled ``create()`` and, given
    ``weights``, JAX's collective test as a hook; then close(), a second
    client on the same world (the world outlives the first), the world's
    close, and a client after it (refused)."""
    from _torch_spawned_script import rank_prefill

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.parallel.controller import register_hook
    from k_llms_tpu_torch.parallel.launcher import host_world

    register_hook("rank_prefill", rank_prefill)
    register_hook("collectives", collective_body)
    data, model = shape

    def build():
        return KLLMs(backend="cuda", device="cpu", model="tiny", checkpoint_path=ckpt,
                     model_parallel=model, max_new_tokens=max_new, kv_page_size=8)

    def greedy(engine):
        return engine.generate_many([GenRequestSpec(list(prompt), n, 3)],
                                    max_new_tokens=max_new, temperature=0.0)[0]

    client = build()
    backend = client.backend
    engine = backend.engine
    res = greedy(engine)
    ranks = backend.controller.hook("rank_prefill", list(prompt))
    collectives = None if weights is None else backend.controller.hook("collectives", weights)
    resp = client.chat.completions.create(**REQ)
    out = {**_place(), "mesh": dict(engine.mesh.shape), "is_controller": backend.is_controller,
           "followers": len(backend.world.pids), "tokens": res.tokens.tolist(),
           "logprobs": res.logprobs.tolist(), "ranks": ranks, "collectives": collectives,
           "texts": [c.message.content for c in resp.choices],
           "likelihoods": resp.likelihoods}
    world = host_world()
    client.close()
    out["alive_after_close"] = [p.poll() is None for p in world.procs]
    client = build()
    out["second"] = {**_place(), "same_world": client.backend.world is world,
                     "mesh": dict(client.backend.engine.mesh.shape),
                     "tokens": greedy(client.backend.engine).tokens.tolist()}
    client.close()
    out.update(_end(world))
    # No client builds on fewer ranks than the processes announced.
    out["after_end"] = _error(build)
    return out


def _error(fn):
    try:
        fn()
    except Exception as e:
        return {"type": type(e).__name__, "status": getattr(e, "status_code", None),
                "bases": [c.__name__ for c in type(e).__mro__], "message": str(e),
                "at": time.time()}
    return None


def _tiny_client():
    from k_llms_tpu_torch import KLLMs

    return KLLMs(backend="cuda", device="cpu", model="tiny", model_parallel=2,
                 max_new_tokens=48)


def _wait_stopped(backend, limit_s):
    deadline = time.monotonic() + limit_s
    while backend.health()["state"] != "stopped" and time.monotonic() < deadline:
        time.sleep(0.01)
    return time.time()


def case_fault(stop_limit_s):
    """Two ranks a host on (2, 2): the last process kills its follower
    while idle; every host waits for its own scheduler's stop, then makes
    the next request and closes."""
    client = _tiny_client()
    backend = client.backend
    world = backend.world
    first = [c.message.content for c in client.chat.completions.create(**REQ).choices]
    killed_at = None
    if world.host.process_id == world.host.processes - 1:
        killed_at = time.time()
        os.kill(world.pids[0], signal.SIGKILL)
    stopped_at = _wait_stopped(backend, stop_limit_s)
    health = backend.health()
    t0 = time.monotonic()
    err = _error(lambda: client.chat.completions.create(**REQ))
    err_s = time.monotonic() - t0
    client.close()
    return {**_place(), "first": first, "killed_at": killed_at, "stopped_at": stopped_at,
            "state": health["state"], "terminal": health["world"]["terminal"],
            "error": err, "error_s": err_s, **_end(world)}


def case_inflight(stop_limit_s):
    """Two ranks a host on (2, 2): every host streams the same request, and
    host 0 (the data axis's first rank, which delivers the streamed tokens
    of every data rank) kills the last host's follower from its first
    streamed token's sink; each host's request in flight gets the typed
    503, then the next, and the process exits with the world still open
    (its exit closes it)."""
    client = _tiny_client()
    backend = client.backend
    world = backend.world
    store, pid = world.host.store, world.host.process_id
    if pid == world.host.processes - 1:
        store.set("test/victim", str(world.pids[0]))
    victim = int(store.get("test/victim"))
    killed = {}

    def stream():
        for _ in client.chat.completions.create(stream=True, **dict(REQ, max_tokens=48)):
            if pid == 0 and not killed:
                killed["at"] = time.time()
                os.kill(victim, signal.SIGKILL)

    err = _error(stream)
    stopped_at = _wait_stopped(backend, stop_limit_s)
    state = backend.health()["state"]
    after = _error(lambda: client.chat.completions.create(**REQ))
    client.close()
    return {**_place(), "killed_at": killed.get("at"), "error": err, "stopped_at": stopped_at,
            "state": state, "after": after, "followers": world.pids}


if __name__ == "__main__":
    torch.set_num_threads(1)
    case, kwargs = sys.argv[1], json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    assert initialize_multihost(device="cpu")
    result = globals()[f"case_{case}"](**kwargs)
    print("RESULT " + json.dumps(result), flush=True)
