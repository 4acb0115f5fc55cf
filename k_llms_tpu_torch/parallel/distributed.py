"""Multi-process initialisation: one process per rank.

Counterpart of ``k_llms_tpu/parallel/distributed.py``. Every rank calls
:func:`initialize_multihost` before it builds an engine; it reads the JAX
package's environment (``KLLMS_COORDINATOR`` as ``host:port``,
``KLLMS_NUM_PROCESSES``, ``KLLMS_PROCESS_ID``) or its arguments and starts
the default ``torch.distributed`` process group over TCP.

The transport is chosen once, here: ``nccl`` when every rank has a card of
its own (the host's ranks, ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, at
most its card count), ``gloo`` on the CPU and where ranks share a card (NCCL does not
take two ranks on one device). Under ``gloo`` the work stays on the card and
only each collective's bytes cross host memory (:mod:`.collectives`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> bool:
    """Start the default process group from the arguments or the
    environment. Returns True when a group was started (or one already
    runs), False for a single process (neither a coordinator nor a process
    count given). The transport is :func:`default_transport` for
    ``device`` (the rank's device, default :func:`local_device`)."""
    coordinator_address = coordinator_address or os.getenv("KLLMS_COORDINATOR")
    num_processes = num_processes or _int_env("KLLMS_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("KLLMS_PROCESS_ID")

    if coordinator_address is None and num_processes is None:
        return False  # single process
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "multi-process init needs KLLMS_COORDINATOR (host:port), "
            "KLLMS_NUM_PROCESSES and KLLMS_PROCESS_ID"
        )
    if device is None:
        device = local_device(process_id, "cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    transport = default_transport(device, local_world_size(int(num_processes)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        transport,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    logger.info(
        "torch.distributed initialized: process %s/%s over %s on %s",
        dist.get_rank(), dist.get_world_size(), transport, device,
    )
    return True


def local_device(rank: Optional[int] = None, kind: str = "cuda") -> torch.device:
    """The rank's device: ``cuda:{local_rank % device_count}`` (ranks past
    the card count share cards), or the CPU."""
    if kind != "cuda":
        return torch.device("cpu")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = _int_env("LOCAL_RANK")
    local = rank if local is None else local
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def local_world_size(world: int) -> int:
    """This host's ranks: ``LOCAL_WORLD_SIZE``, else the whole world (one
    host)."""
    local = _int_env("LOCAL_WORLD_SIZE")
    return world if local is None else local


def default_transport(device, local_ranks: int, device_count: Optional[int] = None) -> str:
    """``nccl`` when this host's ``local_ranks`` ranks are on cards of their
    own (no more of them than ``device_count``, default the host's card
    count), else ``gloo``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    if device_count is None:
        device_count = torch.cuda.device_count()
    return "nccl" if local_ranks <= device_count else "gloo"


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _int_env(name: str) -> Optional[int]:
    val = os.getenv(name)
    return int(val) if val else None


def global_mesh_devices():
    """The world's ranks, in order (the JAX function's device list)."""
    return list(range(world_size()))
