"""Multi-process initialisation: one process per rank.

Counterpart of ``k_llms_tpu/parallel/distributed.py``. Every rank calls
:func:`initialize_multihost` before it builds an engine; it reads the JAX
package's environment (``KLLMS_COORDINATOR`` as ``host:port``,
``KLLMS_NUM_PROCESSES``, ``KLLMS_PROCESS_ID``) or its arguments and starts
the default ``torch.distributed`` process group over TCP.

The transport is chosen once, here: ``nccl`` when every rank has a card of
its own (the host's ranks at most its card count), ``gloo`` on the CPU and
where ranks share a card (NCCL does not take two ranks on one device). Under
``gloo`` the work stays on the card and only each collective's bytes cross
host memory (:mod:`.collectives`).

The host's ranks are derived before the transport is chosen:
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` where ``torchrun`` sets them, else each
rank's host name exchanged through the coordinator's TCP store, so a world
started from the ``KLLMS_*`` variables alone on two hosts of four cards
counts four ranks a host (and takes nccl). :func:`host_ranks` exposes the
result; the controlling rank of :mod:`.controller` is the host's first.

A plain process starts its host's world itself, as JAX's one process drives
every local chip: :func:`local_rank_count` is the host's rank count (one a
card, or the forced :data:`LOCAL_RANKS_ENV`), :func:`spawns_world` says
whether a backend built here starts the others (:mod:`.launcher`), and
:func:`initialize_local_world` joins the controlling process to the world it
started. :func:`end_world` forgets a world so that another can start.
"""

from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: Seconds a rank waits for the others' host names in the coordinator's store.
HOST_EXCHANGE_TIMEOUT_S = 300.0
#: The variables of a world started rank by rank.
WORLD_ENV = ("KLLMS_COORDINATOR", "KLLMS_NUM_PROCESSES", "KLLMS_PROCESS_ID")
#: The forced count of this host's ranks: the port's counterpart of
#: ``--xla_force_host_platform_device_count`` (ranks on the CPU, or ranks
#: that share a card).
LOCAL_RANKS_ENV = "KLLMS_LOCAL_RANKS"


class HostRanks(NamedTuple):
    """This rank's place on its host: its index among the host's ranks, their
    count, and their global ranks in order."""

    local_rank: int
    local_world: int
    ranks: List[int]


# This process's host ranks, set by initialize_multihost (or the first
# host_ranks() of a world started elsewhere).
_HOST: Optional[HostRanks] = None


def host_ranks_from_names(names: Sequence[str], rank: int) -> HostRanks:
    """The ranks whose host name is ``rank``'s, from every rank's host name
    in rank order."""
    ranks = [r for r, name in enumerate(names) if name == names[rank]]
    return HostRanks(ranks.index(rank), len(ranks), ranks)


def _host_ranks_from_env(rank: int, world: int) -> Optional[HostRanks]:
    """``torchrun``'s layout: the host's ranks are the contiguous block of
    ``LOCAL_WORLD_SIZE`` that holds ``rank`` at ``LOCAL_RANK``."""
    local_rank, local_world = _int_env("LOCAL_RANK"), _int_env("LOCAL_WORLD_SIZE")
    if local_rank is None or local_world is None:
        return None
    first = rank - local_rank
    return HostRanks(local_rank, local_world, list(range(first, min(first + local_world, world))))


def _exchange_host_names(store, rank: int, world: int) -> List[str]:
    store.set(f"kllms/host/{rank}", socket.gethostname())
    keys = [f"kllms/host/{r}" for r in range(world)]
    store.wait(keys, timedelta(seconds=HOST_EXCHANGE_TIMEOUT_S))
    return [store.get(k).decode() for k in keys]


def host_ranks() -> HostRanks:
    """This rank's host ranks (:class:`HostRanks`). In a world that
    :func:`initialize_multihost` did not start, the first call is a
    collective of the whole world: ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
    where set, else one ``all_gather_object`` of the host names."""
    global _HOST
    if _HOST is None:
        if not dist.is_initialized():
            return HostRanks(0, 1, [0])
        rank, world = dist.get_rank(), dist.get_world_size()
        host = _host_ranks_from_env(rank, world)
        if host is None:
            names: List[Optional[str]] = [None] * world
            dist.all_gather_object(names, socket.gethostname())
            host = host_ranks_from_names(names, rank)
        _HOST = host
    return _HOST


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    store=None,
) -> bool:
    """Start the default process group from the arguments or the
    environment. Returns True when a group was started (or one already
    runs), False for a single process (neither a coordinator nor a process
    count given). The transport is :func:`default_transport` for
    ``device`` (the rank's device, default :func:`local_device`).
    ``store``: the coordinator's store, already reached (a follower its
    controller started), instead of a new connection to it."""
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
    global _HOST
    world, rank = int(num_processes), int(process_id)
    if store is None:
        host, port = coordinator_address.rsplit(":", 1)
        # The coordinator's store, made here so that the host names cross it
        # before the transport is chosen; the process group then shares it.
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=timedelta(seconds=HOST_EXCHANGE_TIMEOUT_S))
    _HOST = _host_ranks_from_env(rank, world) or host_ranks_from_names(
        _exchange_host_names(store, rank, world), rank)
    _init_group(store, world, rank, device)
    return True


def initialize_local_world(store, local_ranks: int, device=None) -> None:
    """Join the world this process started as its rank 0: ``local_ranks``
    ranks, all on this host, meeting at ``store`` (the master this process
    serves). The controller's side of :func:`initialize_multihost`."""
    global _HOST
    _HOST = HostRanks(0, int(local_ranks), list(range(int(local_ranks))))
    _init_group(store, int(local_ranks), 0, device)


def _init_group(store, world: int, rank: int, device) -> None:
    if device is None:
        device = local_device(rank, "cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    transport = default_transport(device, _HOST.local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(transport, store=store, world_size=world, rank=rank)
    logger.info(
        "torch.distributed initialized: process %s/%s over %s on %s (host ranks %s)",
        dist.get_rank(), dist.get_world_size(), transport, device, _HOST.ranks,
    )


def end_world() -> None:
    """Destroy the default group, and with it every group made from it, and
    forget this process's host ranks: a world started again in this process
    (:mod:`.launcher`'s restart) derives everything anew."""
    global _HOST
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST = None


def local_rank_count(device) -> int:
    """This host's rank count as a plain process sees it, the way JAX counts
    its local devices: :data:`LOCAL_RANKS_ENV` where set, else one rank a
    card for a ``cuda`` device, else one."""
    forced = _int_env(LOCAL_RANKS_ENV)
    if forced is not None:
        return forced
    device = torch.device(device) if device is not None else None
    if (device is None or device.type == "cuda") and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def spawns_world(device) -> int:
    """The rank count of the world a backend built in this process starts
    (:mod:`.launcher`), or 0 where it starts none: a process group already
    runs, a ``KLLMS_*`` world variable is set (a rank started by hand, or a
    follower), or the host counts one rank."""
    if dist.is_initialized() or any(os.getenv(v) for v in WORLD_ENV):
        return 0
    n = local_rank_count(device)
    return n if n > 1 else 0


def local_device(rank: Optional[int] = None, kind: str = "cuda") -> torch.device:
    """The rank's device: ``cuda:{local_rank % device_count}`` (ranks past
    the card count share cards), or the CPU. The local rank is the host's
    (:data:`_HOST`, once known), else ``LOCAL_RANK``, else ``rank``."""
    if kind != "cuda":
        return torch.device("cpu")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = _HOST.local_rank if _HOST is not None else _int_env("LOCAL_RANK")
    local = rank if local is None else local
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def local_world_size(world: int) -> int:
    """This host's ranks: ``LOCAL_WORLD_SIZE``, else the host ranks once
    known, else the whole world (one host)."""
    local = _int_env("LOCAL_WORLD_SIZE")
    if local is None and _HOST is not None:
        local = _HOST.local_world
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
