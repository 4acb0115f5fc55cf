"""The plain scripts of the spawned-world twins: one process that builds
``KLLMs(backend="cuda", device="cpu", ...)`` with ``KLLMS_LOCAL_RANKS`` set,
so the backend starts its host's followers itself (``parallel/launcher.py``).

Run as ``python tests/_torch_spawned_script.py <case> <json kwargs>``; the
last line of standard output is ``RESULT <json>`` (the followers write to
standard error). A case is a function ``case_<name>(**kwargs)`` of this
module. This module imports torch and the port only, never JAX: the JAX
references are computed in the test process.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k_llms_tpu_torch import KLLMs  # noqa: E402
from k_llms_tpu_torch.parallel.controller import register_hook  # noqa: E402

REQ = dict(messages=[{"role": "user", "content": "count the apples"}], n=2, seed=5,
           temperature=0.7, max_tokens=12)
#: A logit bias keeps a request off the continuous loop (the coalescing path).
REQ_COALESCED = dict(REQ, logit_bias={"65": 1.0})


def rank_prefill(engine, prompt):
    """Every rank's last-position prefill logits of ``prompt`` (the
    bucket-padded ids and length with them), gathered on each rank: a
    module-level hook, which a follower imports from this script."""
    ids, plen, bucket = engine._prep_prompt(prompt)
    with torch.inference_mode():
        logits, _ = engine._prefill_full(ids, plen, bucket)
    mine = {"ids": ids, "plen": plen, "bucket": bucket,
            "logits": logits[0].float().tolist()}
    return engine.host_controller.gather(mine)


def rank_model(engine):
    """Every rank's model name and depth."""
    return engine.host_controller.gather((engine.config.name, engine.config.num_layers))


def _client(ranks, **kw):
    os.environ["KLLMS_LOCAL_RANKS"] = str(ranks)
    return KLLMs(backend="cuda", device="cpu", **kw)


def _texts(resp):
    return [c.message.content for c in resp.choices]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _close(client):
    """close(), then each child's exit code and whether any started child
    is still alive."""
    world = client.backend.world
    client.close()
    return {"exit_codes": [p.returncode for p in world.procs],
            "alive": [pid for _, _, pid, _ in world.ended if _alive(pid)],
            "ended": [list(e) for e in world.ended]}


def case_world(shapes, ckpt, prompt, n, max_new):
    """Per (data, model) shape: a greedy launch through the controller's
    engine (replayed on every follower), every rank's prefill logits, the
    mesh and close(). Then a cut depth registered only here, served."""
    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.models.config import get_config, register_config

    out = {}
    register_hook("rank_prefill", rank_prefill)
    register_hook("rank_model", rank_model)
    for data, model in shapes:
        client = _client(data * model, model="tiny", checkpoint_path=ckpt,
                         model_parallel=model, max_new_tokens=max_new, kv_page_size=8)
        backend = client.backend
        engine = backend.engine
        res = engine.generate_many([GenRequestSpec(list(prompt), n, 3)],
                                   max_new_tokens=max_new, temperature=0.0)[0]
        ranks = backend.controller.hook("rank_prefill", list(prompt))
        out[f"{data}x{model}"] = {
            "mesh": dict(engine.mesh.shape), "is_controller": backend.is_controller,
            "followers": len(backend.world.pids), "tokens": res.tokens.tolist(),
            "logprobs": res.logprobs.tolist(), "ranks": ranks, **_close(client)}
    register_config(get_config("tiny").with_(name="tiny-cut", num_layers=1))
    client = _client(2, model="tiny-cut", model_parallel=2, max_new_tokens=6)
    resp = client.chat.completions.create(**dict(REQ, max_tokens=6))
    out["cut"] = {"texts": _texts(resp),
                  "models": client.backend.controller.hook("rank_model"), **_close(client)}
    return out


def _wait_restarts(world, k, timeout=120.0):
    deadline = time.monotonic() + timeout
    while world.restarts < k:
        if time.monotonic() > deadline:
            raise TimeoutError(f"the world did not restart {k} times: {world.stats()}")
        time.sleep(0.01)


def _killed_stream(client, pid, req):
    """Stream ``req`` and SIGKILL ``pid`` at its first chunk: the error
    (type, status, seconds from the kill)."""
    t0 = None
    try:
        for _ in client.chat.completions.create(stream=True, **req):
            if t0 is None:
                t0 = time.monotonic()
                os.kill(pid, signal.SIGKILL)
    except Exception as e:
        return {"type": type(e).__name__, "status": getattr(e, "status_code", None),
                "seconds": time.monotonic() - t0, "message": str(e)}
    return None


def case_restart():
    """Two ranks (1, 2) with the continuous loop: a follower killed while
    idle, during a coalesced launch and during a loop step, each followed by
    the next request; then close()."""
    client = _client(2, model="tiny", model_parallel=2, max_new_tokens=12,
                     continuous_batching=True, continuous_width=4, continuous_max_prompt=64,
                     continuous_max_new=32)
    backend = client.backend
    world = backend.world
    out = {"loop": _texts(client.chat.completions.create(**REQ)),
           "coalesced": _texts(client.chat.completions.create(**REQ_COALESCED))}
    t0 = time.monotonic()
    os.kill(world.pids[0], signal.SIGKILL)
    _wait_restarts(world, 1)
    out["idle"] = {"loop": _texts(client.chat.completions.create(**REQ)),
                   "restart_s": time.monotonic() - t0,
                   "coalesced": _texts(client.chat.completions.create(**REQ_COALESCED))}
    out["launch_error"] = _killed_stream(client, world.pids[0], REQ_COALESCED)
    _wait_restarts(world, 2)
    out["after_launch"] = _texts(client.chat.completions.create(**REQ_COALESCED))
    out["step_error"] = _killed_stream(client, world.pids[0], dict(REQ, max_tokens=24))
    _wait_restarts(world, 3)
    out["after_step"] = _texts(client.chat.completions.create(**REQ))
    health = backend.health()
    out["state"] = health["state"]
    out["loop_stats"] = {k: health["continuous"][k]
                         for k in ("restarts", "completed", "last_recovery_reason")}
    out["world"] = health["world"]
    out["close"] = _close(client)
    return out


def case_stop(max_rebuilds):
    """Two ranks whose every restarted follower fails its first launch
    (``KLLMS_FAILPOINTS``, armed for the children only): ``max_rebuilds``
    restarts without a good launch stop the scheduler."""
    client = _client(2, model="tiny", max_new_tokens=6, max_rebuilds=max_rebuilds)
    backend = client.backend
    first = _texts(client.chat.completions.create(**REQ_COALESCED))
    os.environ["KLLMS_FAILPOINTS"] = "engine.launch=raise"
    os.kill(backend.world.pids[0], signal.SIGKILL)
    _wait_restarts(backend.world, 1)
    errors = []
    deadline = time.monotonic() + 60
    while backend.scheduler.state.value != "stopped" and time.monotonic() < deadline:
        try:
            client.chat.completions.create(**REQ_COALESCED)
            errors.append(None)
        except Exception as e:
            errors.append([type(e).__name__, getattr(e, "status_code", None)])
        time.sleep(0.2)
    try:
        client.chat.completions.create(**REQ_COALESCED)
        after = None
    except Exception as e:
        after = [type(e).__name__, getattr(e, "status_code", None)]
    out = {"first": first, "errors": errors, "after": after,
           "state": backend.scheduler.state.value, "world": backend.world.stats()}
    out["close"] = _close(client)
    return out


def case_hung(budget_s):
    """Two ranks under a ``budget_s`` watchdog; the followers of the first
    restart hang in their first launch (``KLLMS_FAILPOINTS``, armed for
    them only): the watchdog's rebuild cannot reach them, the world is
    started again, and the launch is replayed on it."""
    budget = dict(watchdog_base_s=budget_s, watchdog_min_budget_s=budget_s,
                  watchdog_max_budget_s=budget_s)
    client = _client(2, model="tiny", max_new_tokens=6, **budget)
    backend = client.backend
    first = _texts(client.chat.completions.create(**REQ_COALESCED))
    os.environ["KLLMS_FAILPOINTS"] = "engine.launch=hang:1:30"
    os.kill(backend.world.pids[0], signal.SIGKILL)
    _wait_restarts(backend.world, 1)
    del os.environ["KLLMS_FAILPOINTS"]
    t0 = time.monotonic()
    replayed = _texts(client.chat.completions.create(**REQ_COALESCED))
    out = {"first": first, "replayed": replayed, "seconds": time.monotonic() - t0,
           "supervisor": backend.supervisor.stats(), "world": backend.world.stats(),
           "state": backend.scheduler.state.value}
    out["close"] = _close(client)
    return out


def case_orphan():
    """A world of three ranks; prints the followers' pids and waits to be
    killed."""
    client = _client(3, model="tiny", max_new_tokens=4)
    print("PIDS", json.dumps(client.backend.world.pids), flush=True)
    time.sleep(600)


if __name__ == "__main__":
    torch.set_num_threads(1)
    case, kwargs = sys.argv[1], json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    result = globals()[f"case_{case}"](**kwargs)
    print("RESULT " + json.dumps(result), flush=True)
