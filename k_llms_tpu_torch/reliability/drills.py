"""Helpers that drive the serving layer's drills from outside a launch.

- :func:`park_worker` blocks the scheduler's worker, so that requests queued
  until it is released coalesce whatever the host's timing;
- :func:`queue_in_order` queues blocking requests from threads in a known
  order;
- :func:`reset_launch_memory`, :func:`launch_peaks`,
  :func:`oom_memory_fraction` and :func:`memory_fraction` set up a real
  device OOM: a per-process memory fraction that a solo launch fits under
  and a coalesced group does not.

``chip_smoke.py`` and the port's tests use them; no serving path does."""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch


def park_worker(scheduler, *, hold: float = 60.0, wait: float = 30.0) -> threading.Event:
    """Block ``scheduler``'s worker on an Event (returned) for at most
    ``hold`` seconds: items submitted until it is set queue up behind the
    blocker. Raises TimeoutError if the worker has not picked the blocker
    up within ``wait`` seconds."""
    gate = threading.Event()
    blocker = scheduler.submit(lambda: gate.wait(hold))
    deadline = time.monotonic() + wait
    while not (scheduler.stats["queued"] == 0 and blocker.running()):
        if time.monotonic() > deadline:
            gate.set()
            raise TimeoutError("the scheduler's worker did not pick up the blocker")
        time.sleep(0.005)
    return gate


def queue_in_order(
    scheduler, calls: Sequence[Callable[[], Any]], *, wait: float = 30.0
) -> Tuple[List[threading.Thread], Dict[int, Any]]:
    """Run each zero-argument ``calls[i]`` (a blocking request) on its own
    thread, starting the next only once the previous one is queued (or has
    returned), so that the queue holds them in list order. Returns
    (threads, results): a result is the call's return value or the
    exception it raised. Raises TimeoutError if a call is neither queued
    nor returned within ``wait`` seconds."""
    results: Dict[int, Any] = {}
    threads: List[threading.Thread] = []
    for i, call in enumerate(calls):
        queued = scheduler.stats["queued"]

        def run(i=i, call=call):
            try:
                results[i] = call()
            except BaseException as e:  # noqa: BLE001 - the caller inspects it
                results[i] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + wait
        while scheduler.stats["queued"] == queued and i not in results:
            if time.monotonic() > deadline:
                raise TimeoutError(f"request {i} was not queued")
            time.sleep(0.002)
    return threads, results


def reset_launch_memory(engine) -> None:
    """No cached blocks: the card's peak counters read the engine's next
    launch alone. The page pool stays: an engine keeps its first pool, as
    the JAX engine does, and a launch it cannot hold decodes dense."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(engine.device)


def launch_peaks(device) -> Tuple[int, int]:
    """(reserved, allocated) peak bytes since the last reset."""
    return torch.cuda.max_memory_reserved(device), torch.cuda.max_memory_allocated(device)


#: The least room between a solo launch's reserved peak and a group's
#: allocated peak for a limit between them to be a drill, not a coin toss.
MIN_OOM_GAP_BYTES = 16 << 20


def oom_memory_fraction(solo_reserved_peak: int, group_allocated_peak: int, device) -> float:
    """The per-process memory fraction midway between a solo launch's
    reserved peak and a coalesced group's allocated peak. The fraction
    limits the allocator's reserved memory: a solo launch whose reserved
    peak is below it never reaches it, and a group whose allocated peak is
    above it cannot fit. Raises RuntimeError when less than
    ``MIN_OOM_GAP_BYTES`` separates the two."""
    gap = group_allocated_peak - solo_reserved_peak
    if gap < MIN_OOM_GAP_BYTES:
        raise RuntimeError(
            f"no memory limit separates the solo launch (reserved peak {solo_reserved_peak} B) "
            f"from the group (allocated peak {group_allocated_peak} B): gap {gap} B"
        )
    total = torch.cuda.get_device_properties(device).total_memory
    return (solo_reserved_peak + group_allocated_peak) / 2 / total


@contextlib.contextmanager
def memory_fraction(fraction: float, device) -> Iterator[None]:
    """The process's memory fraction on ``device``'s card set to
    ``fraction`` for the block; afterwards back to 1.0, with the cached
    blocks given back to the card."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    torch.cuda.set_per_process_memory_fraction(fraction, index)
    try:
        yield
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, index)
        torch.cuda.empty_cache()
