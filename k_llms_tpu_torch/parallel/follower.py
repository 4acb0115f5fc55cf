"""A follower rank of a world its controller started (:mod:`.launcher`).

The controlling process runs this module as a fresh interpreter
(``python -m k_llms_tpu_torch.parallel.follower``) with the ``KLLMS_*``
world variables (its global rank and the world's rank count) and
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` (its index on the host and the host's
rank count) set, so it takes the rank-by-rank path and never starts a world
in turn. It reaches the world's store, reads its host's start (the
controller's main module, thread count, device type and transport) under
the host's prefix, joins the world and runs the host's tasks in order:
each a client's ``BackendConfig`` and resolved ``ModelConfig`` (a model
registered only in the controller's process is served too), from which it
builds the same backend: its constructor draws or loads this rank's shard of
the weights and replays the controller's plans until the client's close
plan, and the follower takes the next task. The end task ends the world
here and the process exits 0. It ends within a fraction of a second of its
controller's process (:func:`.launcher.watch_parent`).
"""

from __future__ import annotations

import gc
import os
import pickle
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from . import launcher
from .distributed import end_world, initialize_multihost, local_device


def _next_task(tasks, k: int):
    key = f"{launcher.TASK_KEY}{k}"
    while not tasks.check([key]):
        time.sleep(launcher.POLL_S)
    return pickle.loads(tasks.get(key))


def main() -> int:
    launcher.watch_parent()
    host, port = os.environ["KLLMS_COORDINATOR"].rsplit(":", 1)
    world, rank = int(os.environ["KLLMS_NUM_PROCESSES"]), int(os.environ["KLLMS_PROCESS_ID"])
    local = int(os.environ["LOCAL_RANK"])
    store = dist.TCPStore(host, int(port), world, is_master=False,
                          timeout=timedelta(seconds=launcher.START_TIMEOUT_S))
    tasks = dist.PrefixStore(launcher.host_prefix(rank - local), store)
    start = pickle.loads(tasks.get(launcher.INIT_KEY))
    launcher.adopt_main_spec(start["main"])
    torch.set_num_threads(start["threads"])
    device = local_device(rank, start["kind"])
    tasks.set(f"{launcher.READY_KEY}{local}", b"1")
    initialize_multihost(device=device, store=store, transport=start["transport"])
    k = 0
    while True:
        task = _next_task(tasks, k)
        if task[0] != "backend":  # the end
            break
        payload = task[1]
        config = payload["config"]
        if device.type == "cuda":
            # Each rank on its own card (ranks past the card count share them).
            config = config.model_copy(update={"device": str(device)})
        from ..backends.cuda import CudaBackend

        # Returns after the client's close plan; the next task follows.
        CudaBackend(config=config, model_config=payload["model_config"])
        gc.collect()
        k += 1
    end_world()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # The world is ended and every plan served: the interpreter's teardown is
    # skipped, since a thread of torch.distributed's left to a C++
    # destructor there has aborted a clean close (exit -6) now and then.
    os._exit(code)
