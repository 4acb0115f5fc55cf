"""Multi-process initialisation: JAX's processes, each driving its host's
ranks.

Counterpart of ``k_llms_tpu/parallel/distributed.py``. Every process calls
:func:`initialize_multihost` before it builds an engine; it reads the JAX
package's environment (``KLLMS_COORDINATOR`` as ``host:port``,
``KLLMS_NUM_PROCESSES``, ``KLLMS_PROCESS_ID``) or its arguments and starts
the default ``torch.distributed`` process group over TCP. As in JAX, the
variables count *processes*, and each process drives every rank of its host
(:func:`local_rank_count`: one a card it sees, or :data:`LOCAL_RANKS_ENV`):
the processes exchange their counts through the coordinator's store, the
world's size is their sum, and the ranks are host-major (process ``p``'s
follow those of the processes before it, as ``jax.devices()`` orders
devices by process), so ``auto_mesh(model_parallel=m)`` keeps the model axis
inside a host. A process of several ranks starts its followers here
(:class:`.launcher.SpawnedWorld`), into the global world, and is its host's
rank 0; its client hands them its configuration later.

A process counts as one rank where ``LOCAL_RANK`` is set (``torchrun``, and
the followers a process started), and a world whose every process counts
one rank is started rank by rank, as before: the host's ranks from
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` or each rank's host name exchanged
through the coordinator's store. :func:`host_ranks` exposes the result; the
controlling rank of :mod:`.controller` is the host's first.

The transport is chosen once, here: ``nccl`` when every rank has a card of
its own (the host's ranks at most its card count, on every host), ``gloo``
on the CPU and where ranks share a card (NCCL does not take two ranks on one
device). Under ``gloo`` the work stays on the card and only each
collective's bytes cross host memory (:mod:`.collectives`).

A plain process (no ``KLLMS_*`` world) starts its host's world when its
client is built, as JAX's one process drives every local chip:
:func:`spawns_world` says how many followers a process starts, and
:func:`join_host_world` joins the controlling process to the world it
started. :func:`end_world` forgets a world so that another can start.
"""

from __future__ import annotations

import json
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
#: Where each process of a multi-process world leaves its host name, rank
#: count and transport in the coordinator's store (its process id appended).
PROCESS_KEY = "kllms/process/"
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
    transport: Optional[str] = None,
) -> bool:
    """Start the default process group from the arguments or the
    environment. Returns True when a group was started (or one already
    runs), False for a single process (neither a coordinator nor a process
    count given). ``device``: this process's device (default
    :func:`local_device`; its type is every local rank's). A process of
    several ranks (:func:`spawns_world`) starts its followers into the world
    before it joins, and raises, with every process of the world, when one
    cannot start. ``store`` and ``transport``: a follower's, already reached
    and agreed (with ``LOCAL_RANK`` set, the process is one rank)."""
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
    one_rank = _int_env("LOCAL_RANK") is not None
    if not one_rank and device is None and not torch.cuda.is_available():
        raise RuntimeError("this process sees no CUDA device: pass device='cpu' to start a "
                           "world on the CPU")
    global _HOST
    processes, pid = int(num_processes), int(process_id)
    if store is None:
        host, port = coordinator_address.rsplit(":", 1)
        # The coordinator's store, made here so that the processes' counts
        # cross it before the world is laid out; the process group then
        # shares it.
        store = dist.TCPStore(host, int(port), processes, is_master=pid == 0,
                              timeout=timedelta(seconds=HOST_EXCHANGE_TIMEOUT_S))
    if one_rank:
        # One rank of a world started rank by rank (torchrun, or a follower).
        _HOST = _host_ranks_from_env(pid, processes)
        _init_group(store, processes, pid, device, transport)
        return True
    kind = "cuda" if device is None else torch.device(device).type
    count = spawns_world(kind) + 1
    places = _exchange_places(store, pid, processes, count, default_transport(kind, count))
    if all(p[1] == 1 for p in places):
        # Every process one rank: the world started rank by rank, the
        # host's ranks from the host names.
        _HOST = host_ranks_from_names([p[0] for p in places], pid)
        _init_group(store, processes, pid, device)
        return True
    offset = sum(p[1] for p in places[:pid])
    transport = "nccl" if all(p[2] == "nccl" for p in places) else "gloo"
    from .launcher import SpawnedWorld, adopt_host_world

    spawned = SpawnedWorld(count, local_device(0, kind),
                           HostPlace(coordinator_address, store, pid, processes, offset,
                                     sum(p[1] for p in places), transport))
    spawned.start()
    adopt_host_world(spawned)
    return True


class HostPlace(NamedTuple):
    """A process's place in the world it starts its followers into: the
    coordinator's address and store, the process's id among ``processes``,
    its first global rank (``offset``), the world's rank count and its
    transport. A plain process's world is one of a single process, on a
    loopback store of its own (:func:`.launcher.local_place`)."""

    coordinator: str
    store: object
    process_id: int
    processes: int
    offset: int
    world: int
    transport: str


def _exchange_places(store, pid: int, processes: int, count: int,
                     transport: str) -> List[tuple]:
    """Every process's (host name, rank count, transport), in process order,
    through the coordinator's store."""
    store.set(f"{PROCESS_KEY}{pid}", json.dumps([socket.gethostname(), count, transport]))
    keys = [f"{PROCESS_KEY}{p}" for p in range(processes)]
    store.wait(keys, timedelta(seconds=HOST_EXCHANGE_TIMEOUT_S))
    return [tuple(json.loads(store.get(k))) for k in keys]


def join_host_world(place: "HostPlace", local_ranks: int, device) -> None:
    """Join the world at ``place`` as the first of this process's
    ``local_ranks`` ranks, whose followers (:mod:`.launcher`) hold the
    others. The controlling process's side of a world it started."""
    global _HOST
    _HOST = HostRanks(0, int(local_ranks), list(range(place.offset, place.offset + local_ranks)))
    try:
        _init_group(place.store, place.world, place.offset, device, place.transport)
    except BaseException:
        _HOST = None
        raise


def _init_group(store, world: int, rank: int, device, transport: Optional[str] = None) -> None:
    if device is None:
        device = local_device(rank, "cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    transport = transport or default_transport(device, _HOST.local_world)
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
    """How many followers this process starts (:mod:`.launcher`): its
    host's rank count less one, or 0 where it starts none: a process group
    already runs, ``LOCAL_RANK`` is set (one rank of a world started rank by
    rank: ``torchrun``, or a follower), or the host counts one rank. A
    process of a multi-process world starts them in
    :func:`initialize_multihost`, a plain one when its backend is built."""
    if dist.is_initialized() or _int_env("LOCAL_RANK") is not None:
        return 0
    return max(0, local_rank_count(device) - 1)


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
