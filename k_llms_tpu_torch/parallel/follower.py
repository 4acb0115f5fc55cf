"""A follower rank of a world its controller started (:mod:`.launcher`).

The controlling process runs this module as a fresh interpreter
(``python -m k_llms_tpu_torch.parallel.follower``) with the ``KLLMS_*``
world variables and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` set, so it takes the
hand-started path and never starts a world in turn. It reaches the
controller's store, reads the controller's ``BackendConfig`` and resolved
``ModelConfig`` (a model registered only in the controller's process is
served too), joins the world and builds the same backend: its constructor
draws or loads this rank's shard of the weights and replays the
controller's plans until the close plan, and the process then exits 0. It
ends within a fraction of a second of its controller's process
(:func:`.launcher.watch_parent`).
"""

from __future__ import annotations

import os
import pickle
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from . import launcher
from .distributed import end_world, initialize_multihost, local_device


def main() -> int:
    launcher.watch_parent()
    host, port = os.environ["KLLMS_COORDINATOR"].rsplit(":", 1)
    world, rank = int(os.environ["KLLMS_NUM_PROCESSES"]), int(os.environ["KLLMS_PROCESS_ID"])
    store = dist.TCPStore(host, int(port), world, is_master=False,
                          timeout=timedelta(seconds=launcher.START_TIMEOUT_S))
    payload = pickle.loads(store.get(launcher.PAYLOAD_KEY))
    launcher.adopt_main_spec(payload["main"])
    torch.set_num_threads(payload["threads"])
    config = payload["config"]
    kind = "cpu" if config.device is not None and torch.device(config.device).type == "cpu" \
        else "cuda"
    device = local_device(rank, kind)
    if kind == "cuda":
        # Each rank on its own card (ranks past the card count share them).
        config = config.model_copy(update={"device": str(device)})
    store.set(f"{launcher.READY_KEY}{rank}", b"1")
    initialize_multihost(device=device, store=store)
    from ..backends.cuda import CudaBackend

    # Returns after the controller's close plan.
    CudaBackend(config=config, model_config=payload["model_config"])
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
