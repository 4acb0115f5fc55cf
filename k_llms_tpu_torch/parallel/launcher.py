"""The host's followers, started by the controlling process itself.

JAX drives every chip of its host from one process, so
``KLLMs(backend="tpu", model_parallel=2)`` on a host of four chips serves on
a (2, 2) mesh with no further setup. The port runs one process per rank; a
process whose host counts more than one rank (:func:`.distributed.spawns_world`)
starts the others itself, as :class:`SpawnedWorld`: each other rank is a
fresh interpreter running :mod:`.follower` (never ``fork``: CUDA may be
initialised already) with the ``KLLMS_*`` variables and
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` set, and this process is the host's rank
0. From there the world is a hand-started one: the engine's mesh,
:class:`.controller.HostController` and every plan. The followers run
*tasks* from a store, in order: a client's backend configuration (``KLLMs``
built here hands it to them; each builds the same backend and replays the
controller's plans until the client's close, then waits for the next task),
or the end.

Every world is one of :class:`.distributed.HostPlace`'s: processes, each
with its host's ranks, meeting at a coordinator's store, their tasks under
the host's prefix there. A plain process (no ``KLLMS_*`` world) makes a
world of itself alone when its client is built: a store on a free loopback
port (:func:`local_place`). JAX's ``initialize_multihost`` makes one of
every process of the ``KLLMS_*`` variables. The starts, stops and closes are
the same; what the owner does with a lost follower (a fault's exit 70, a
kill, or a launch across the world that failed) is its own, as ``on_lost``:

- the backend that started a world of its process alone starts it again:
  the surviving children are ended, the process group destroyed, and a new
  store, new children, a new controller and mesh and a new engine on every
  rank take their place, bounded by the backend's ``max_rebuilds``; the
  client's ``close()`` ends the world;
- a world of several processes outlives its clients, as JAX's distributed
  runtime does (a client's ``close()`` hands the followers back to their
  tasks, and the next client builds on every rank), and ends at the
  process's exit. As a JAX job cannot survive a lost process, a lost
  follower stops it on every host: the process that sees it marks the
  coordinator's store (:data:`STOP_KEY`), every process's watcher reads the
  mark, ends its followers and answers typed 503s from then on.

``close()`` joins every child after the end task and ends with a barrier
of every process (:data:`CLOSED_KEY`), so process 0, whose process holds
the coordinator's store, outlives every other's close, as
``jax.distributed.shutdown`` waits for every task. A child whose
controller's process ends (even by ``SIGKILL``) ends within a fraction of a
second (:func:`watch_parent`).

A follower writes its standard output to the controller's standard error,
so nothing of a child follows the controller's own last line. Hooks
(:func:`.controller.register_hook`) of a world started here travel as
references to module-level functions: a follower imports their module, and
the controller's main module as ``multiprocessing``'s spawn does
(:func:`resolve_function`), the first time one is called.
"""

from __future__ import annotations

import atexit
import importlib
import logging
import os
import pickle
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..analysis.lockcheck import make_lock, race_exempt
from .controller import FollowerFaultError
from .distributed import HostPlace, default_transport, end_world, join_host_world

logger = logging.getLogger(__name__)

#: The module every follower runs (``python -m``).
FOLLOWER_MODULE = "k_llms_tpu_torch.parallel.follower"
#: Where the controller leaves its followers' start (its main module, thread
#: count, device type and transport), under the host's prefix
#: (:func:`host_prefix`).
INIT_KEY = "init"
#: Where a follower marks that it reached the store (its local rank appended).
READY_KEY = "ready/"
#: The host's tasks, in order (their index appended).
TASK_KEY = "task/"
#: The reason the world stopped, in the coordinator's store.
STOP_KEY = "kllms/world/stopped"
#: A process whose followers reached the store (its process id appended).
STARTED_KEY = "kllms/world/started/"
#: A process at its close barrier, and one past it (its process id appended).
CLOSED_KEY = "kllms/world/closed/"
LEFT_KEY = "kllms/world/left/"
#: Seconds the controller waits for every follower to reach its store.
START_TIMEOUT_S = 300.0
#: Seconds ``close()`` waits for each follower to end after the close plan.
CLOSE_TIMEOUT_S = 60.0
#: How often the watcher polls the children, and a child its parent.
POLL_S = 0.05
#: How often the watcher of a world of several processes reads the stop mark.
STOP_POLL_S = 0.2
#: A follower's exit code when its controller's process has ended.
ORPHAN_EXIT = 71

#: The controller's main module as a follower imports it (set from the
#: payload in a follower's process).
_MAIN_SPEC: Dict[str, Any] = {}
_MAIN_DONE = False


def main_spec() -> Dict[str, Any]:
    """What a follower needs to import this process's main module as
    ``multiprocessing``'s spawn does, and this process's ``sys.path``."""
    from multiprocessing import spawn

    data = spawn.get_preparation_data("kllms-follower")
    return {k: data[k] for k in ("sys_path", "init_main_from_name", "init_main_from_path")
            if k in data}


def adopt_main_spec(spec: Dict[str, Any]) -> None:
    """A follower's part: the controller's ``sys.path`` entries join this
    process's (nothing is imported yet) and its main module is kept for
    :func:`resolve_function`."""
    for entry in spec.get("sys_path", []):
        if entry not in sys.path:
            sys.path.append(entry)
    _MAIN_SPEC.clear()
    _MAIN_SPEC.update(spec)


def function_ref(fn: Callable[..., Any]):
    """(module, qualified name) of a module-level function, or None for a
    closure, which no follower can import."""
    qualname = getattr(fn, "__qualname__", "")
    module = getattr(fn, "__module__", None)
    if module is None or "<locals>" in qualname:
        return None
    return module, qualname


def resolve_function(ref) -> Callable[..., Any]:
    """The function of :func:`function_ref`'s ``ref`` in this process. The
    controller's main module (``__main__`` there) is imported once, as
    ``__mp_main__``, the first time it is needed."""
    global _MAIN_DONE
    module, qualname = ref
    if module in ("__main__", "__mp_main__"):
        if not _MAIN_DONE:
            from multiprocessing import spawn

            spawn.prepare({k: v for k, v in _MAIN_SPEC.items() if k != "sys_path"})
            _MAIN_DONE = True
        obj = sys.modules.get("__mp_main__") or sys.modules["__main__"]
    else:
        obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def watch_parent() -> None:
    """End this process (:data:`ORPHAN_EXIT`) as soon as the process that
    started it has ended (its children are re-parented): a daemon thread
    polls ``getppid``."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(POLL_S)
            if os.getppid() != parent:
                os._exit(ORPHAN_EXIT)

    threading.Thread(target=watch, name="kllms-parent-watch", daemon=True).start()


def host_prefix(first_rank: int) -> str:
    """The store prefix of the host whose first global rank is ``first_rank``."""
    return f"kllms/launcher/{first_rank}/"


def _child_env(coordinator: str, world: int, rank: int, local: int, size: int) -> Dict[str, str]:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(KLLMS_COORDINATOR=coordinator, KLLMS_NUM_PROCESSES=str(world),
               KLLMS_PROCESS_ID=str(rank), LOCAL_RANK=str(local), LOCAL_WORLD_SIZE=str(size))
    return env


# The world initialize_multihost started in this process.
_HOST_WORLD: Optional["SpawnedWorld"] = None


def adopt_host_world(world: "SpawnedWorld") -> None:
    """Keep the world :func:`.distributed.initialize_multihost` started: each
    backend built here in turn hands it its configuration, and the process's
    exit closes it (its followers exit 0)."""
    global _HOST_WORLD
    _HOST_WORLD = world
    world.watch()
    atexit.register(_close_at_exit, world)


def _close_at_exit(world: "SpawnedWorld") -> None:
    if world._closed:
        return
    if world._backend_task is not None:
        # A client that was never closed: its followers wait for plans.
        world.end_children()
    world.close()


def host_world() -> Optional["SpawnedWorld"]:
    """The world :func:`.distributed.initialize_multihost` started in this
    process (a closed one too: a client built after its close raises), or
    None."""
    return _HOST_WORLD


def local_place(size: int, device) -> HostPlace:
    """A world of this process alone: ``size`` ranks meeting at a store on a
    free loopback port."""
    store = dist.TCPStore("127.0.0.1", 0, size, is_master=True, wait_for_workers=False,
                          timeout=timedelta(seconds=START_TIMEOUT_S))
    return HostPlace(f"127.0.0.1:{store.port}", store, 0, 1, 0, size,
                     default_transport(device, size))


class SpawnedWorld:
    """The host's ``size`` ranks, whose rank 0 is this process, at ``host``
    (:class:`.distributed.HostPlace`). ``device`` is rank 0's; ``on_lost(reason)``
    is the owner's answer to a lost rank, run on the watcher thread (None:
    the world is given up, :meth:`fail`); ``restartable``: whether that
    answer starts the world again (a world of this process alone, whose
    owner calls :meth:`restart`), or stops it."""

    def __init__(self, size: int, device, host: HostPlace,
                 on_lost: Optional[Callable[[str], None]] = None, *, restartable: bool = False):
        self.size = int(size)
        self.device = torch.device(device)
        self.restartable = restartable
        self.on_lost = on_lost
        self._lock = make_lock("launcher.world")
        # kllms: unguarded — swapped by the one thread that starts or restarts the world
        self.host = host
        # kllms: unguarded — swapped by the one thread that starts or restarts the world
        self.procs: List[subprocess.Popen] = []
        # kllms: unguarded — counted by the one thread that starts the world
        self.generation = 0
        # kllms: unguarded — counted by the watcher thread
        self.restarts = 0
        # kllms: unguarded — set once, when the world is given up; readers raise it
        self.terminal: Optional[BaseException] = None
        # Each child ever started: (generation, rank, pid, exit code or None).
        self.ended: List[tuple] = []
        # kllms: unguarded — the host's task queue, posted by the one thread that starts the world or builds its backend
        self._tasks = None
        # kllms: unguarded — numbered by the one thread that starts the world or builds its backend
        self._next_task = 0
        race_exempt(self, "host", "procs", "generation", "restarts", "terminal", "_tasks",
                    "_next_task", "_backend_task")
        # kllms: unguarded — the served client's task (a restart posts it again); set and cleared by the thread that builds and closes clients
        self._backend_task = None
        self._closing = False
        self._closed = False
        self._restarting = False
        self._wanted: Optional[str] = None
        # Set while the world serves; clear while it is started again.
        self._serving = threading.Event()
        self._serving.set()
        # Set once the world is given up.
        self._stopped = threading.Event()
        # Launches whose callers got the stop's 503 while they waited in a
        # collective (:meth:`until_stopped`).
        self._abandoned: List[threading.Thread] = []
        self._watcher: Optional[threading.Thread] = None

    # -- start --------------------------------------------------------------
    def start(self) -> None:
        """Start the followers, wait until every process's have reached the
        store, and join the world as the host's rank 0 (a restart then hands
        the new followers the client's task). Raises when a follower ends,
        or does not reach the store, before the world forms: the started
        children are ended, and the stop mark makes every other process of
        the world raise too."""
        host = self.host
        tasks = dist.PrefixStore(host_prefix(host.offset), host.store)
        tasks.set(INIT_KEY, pickle.dumps({"main": main_spec(), "threads": torch.get_num_threads(),
                                          "kind": self.device.type, "transport": host.transport}))
        procs = [subprocess.Popen([sys.executable, "-m", FOLLOWER_MODULE],
                                  env=_child_env(host.coordinator, host.world, host.offset + r, r,
                                                 self.size),
                                  stdout=2)
                 for r in range(1, self.size)]
        self.procs, self._tasks, self._next_task = procs, tasks, 0
        self.generation += 1
        try:
            self._wait([f"{READY_KEY}{r}" for r in range(1, self.size)], tasks,
                       "reach the store")
            host.store.set(f"{STARTED_KEY}{host.process_id}", b"1")
            self._wait([f"{STARTED_KEY}{p}" for p in range(host.processes)], host.store,
                       "start on every process")
            join_host_world(host, self.size, self.device)
        except BaseException as e:
            self._mark_stop(f"process {host.process_id} did not start its ranks: "
                            f"{type(e).__name__}: {e}")
            self.end_children()
            raise
        if self._backend_task is not None:
            self._post(self._backend_task)
        logger.info("started the host's %d ranks (generation %d): followers %s",
                    self.size, self.generation, [p.pid for p in procs])

    def _wait(self, keys: List[str], store, what: str) -> None:
        """Wait until ``store`` holds ``keys``; raise when a follower ends,
        another process marks the world stopped, or the start times out."""
        deadline = time.monotonic() + START_TIMEOUT_S
        while not store.check(keys):
            ended = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                     if p.poll() is not None]
            if ended:
                raise RuntimeError(
                    f"follower rank {ended[0][0]} ended with exit code {ended[0][1]} "
                    "before it joined the world")
            stop = self._read_stop()
            if stop is not None:
                raise RuntimeError(f"the world did not start: {stop}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not {what} in {START_TIMEOUT_S:.0f} s")
            time.sleep(POLL_S)

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    # -- tasks ----------------------------------------------------------------
    def _post(self, task) -> None:
        k = self._next_task
        self._next_task += 1
        self._tasks.set(f"{TASK_KEY}{k}", pickle.dumps(task))

    def serve_backend(self, payload: Dict[str, Any]) -> None:
        """Hand every follower a client's ``payload`` (its ``BackendConfig``
        and resolved ``ModelConfig``): each builds the same backend and
        replays the controller's plans until its close, then waits for the
        next task. Raises while another client is served."""
        if self._closed:
            raise RuntimeError("the world of the host's ranks has closed: no client builds "
                               "on fewer ranks than its processes announced")
        if self._backend_task is not None:
            raise RuntimeError("the host's ranks serve another client; close it before "
                               "building the next")
        self._backend_task = ("backend", payload)
        self._post(self._backend_task)

    def release_backend(self) -> None:
        """The client served now has closed (its close plan ended the
        followers' backends): the world waits for the next, and a lost rank
        gives it up from now on."""
        self._backend_task = None
        self.on_lost = None

    # -- the watcher ----------------------------------------------------------
    def watch(self) -> None:
        """Start the watcher thread (once)."""
        if self._watcher is None:
            self._watcher = threading.Thread(target=self._watch, name="kllms-world-watch",
                                             daemon=True)
            self._watcher.start()

    def _watch(self) -> None:
        next_stop_read = 0.0
        while True:
            with self._lock:
                if self._closing or self.terminal is not None:
                    return
                reason, self._wanted = self._wanted, None
            for r, p in enumerate(self.procs, 1):
                if reason is None and p.poll() is not None:
                    reason = f"follower rank {r} (pid {p.pid}) ended with exit code {p.returncode}"
            if reason is None and time.monotonic() >= next_stop_read:
                next_stop_read = time.monotonic() + STOP_POLL_S
                reason = self._read_stop()
            if reason is None:
                time.sleep(POLL_S)
                continue
            logger.error("the host's world lost a rank: %s; %s", reason,
                         "starting it again" if self.restartable else "stopping the world")
            with self._lock:
                # This answer covers every request made of this world so far.
                self._restarting, self._wanted = True, None
            try:
                if self.on_lost is None:
                    self.fail(FollowerFaultError(f"the world is stopped: {reason}"))
                else:
                    self.on_lost(reason)
            except BaseException as e:  # the owner's answer must never kill the watcher
                logger.exception("the owner's answer to a lost rank raised")
                self.fail(e)
            finally:
                with self._lock:
                    self._restarting = False

    def request_restart(self, generation: int, reason: str) -> None:
        """Hand the watcher a lost world (a launch across the world of
        ``generation`` failed): the owner starts it again, or stops it on
        every process. Ignored for an older world, while the owner answers
        and once the world closes."""
        with self._lock:
            if (self._closing or self.terminal is not None or self._restarting
                    or generation != self.generation):
                return
            self._wanted = self._wanted or reason

    # -- the stop mark ------------------------------------------------------------
    def _read_stop(self) -> Optional[str]:
        """The stop mark a process of the world left in the coordinator's
        store."""
        try:
            store = self.host.store
            if store.check([STOP_KEY]):
                return store.get(STOP_KEY).decode()
        except Exception:  # the coordinator's process has ended
            return "the coordinator's store is gone"
        return None

    def _mark_stop(self, reason: str) -> None:
        try:
            self.host.store.compare_set(STOP_KEY, "", reason)
        except Exception:
            logger.debug("the stop mark did not reach the coordinator's store", exc_info=True)

    def until_stopped(self, fn: Callable[..., Any], *args, **kwargs):
        """``fn(*args, **kwargs)`` on a thread of its own, whose caller
        returns its result, or raises the world's terminal error as soon as
        the world is given up: a launch of a world of several processes can
        wait in a collective on another host's rank that left it, and its
        caller gets the typed 503 meanwhile."""
        if self.terminal is not None:
            raise self.terminal
        done = threading.Event()
        box: Dict[str, Any] = {}

        def run():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # delivered to the caller below
                box["error"] = e
            finally:
                done.set()

        thread = threading.Thread(target=run, name="kllms-world-launch", daemon=True)
        thread.start()
        while not done.wait(POLL_S):
            if self._stopped.is_set():
                self._abandoned.append(thread)
                raise self.terminal
        if "error" in box:
            raise box["error"]
        return box["result"]

    # -- restart ----------------------------------------------------------------
    def pause(self) -> None:
        """Launches wait (:meth:`wait_serving`) until :meth:`resume`."""
        self._serving.clear()

    def resume(self) -> None:
        with self._lock:
            self._restarting = False
        self.restarts += 1
        self._serving.set()

    def wait_serving(self) -> None:
        """Return once the world serves; raise its terminal error once it
        has been given up."""
        self._serving.wait()
        if self.terminal is not None:
            raise self.terminal

    def restart(self) -> None:
        """End the children and the world, then start a new world of this
        process alone (:func:`local_place`)."""
        self.end_children()
        end_world()
        self.host = local_place(self.size, self.device)
        self.start()

    def fail(self, error: BaseException) -> None:
        """Give the world up: the stop mark makes every process of the world
        stop its own, the children end and every waiter gets ``error``. The
        group and the store are kept for :meth:`close`'s barrier."""
        self.terminal = error
        self._mark_stop(f"process {self.host.process_id}: {error}")
        self.end_children()
        self._stopped.set()
        self._serving.set()

    def end_children(self) -> None:
        """Kill every child still running and reap them all."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        self._reap()

    def _reap(self, timeout: float = CLOSE_TIMEOUT_S) -> None:
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if not any(e[2] == p.pid and e[0] == self.generation for e in self.ended):
                self.ended.append((self.generation, r, p.pid, p.returncode))

    # -- close ------------------------------------------------------------------
    def closing(self) -> None:
        """Stop watching (a restart in progress ends first): the children's
        exits from now on are the close's."""
        with self._lock:
            self._closing = True
        if self._watcher is not None and self._watcher is not threading.current_thread():
            self._watcher.join()

    def close(self) -> List[Optional[int]]:
        """Tell the followers to end (a client's close plan has ended their
        backends), join every child (killed after :data:`CLOSE_TIMEOUT_S`),
        meet every process of the world at the close barrier and end the
        world. Idempotent. Returns the children's exit codes, in rank
        order."""
        if not self._closed:
            self._closed = True
            self.closing()
            if self._tasks is not None:
                try:
                    self._post(("end",))
                except Exception:  # the coordinator's process has ended
                    logger.warning("the end task did not reach the store", exc_info=True)
            self._reap()
            self._barrier()
            self._join_abandoned()
            end_world()
        return [p.returncode for p in self.procs]

    def _barrier(self) -> None:
        """Every process of the world reaches its close, then leaves; the
        coordinator's process (whose store the others use) leaves last."""
        host = self.host
        store, pid = host.store, host.process_id
        procs = range(host.processes)
        wait = timedelta(seconds=CLOSE_TIMEOUT_S)
        try:
            store.set(f"{CLOSED_KEY}{pid}", b"1")
            store.wait([f"{CLOSED_KEY}{p}" for p in procs], wait)
            store.set(f"{LEFT_KEY}{pid}", b"1")
            if pid == 0:
                store.wait([f"{LEFT_KEY}{p}" for p in procs], wait)
        except Exception as e:  # a process that ended, or the store's process gone
            logger.warning("the close barrier ended early: %s", e)

    def _join_abandoned(self) -> None:
        """Wait (at most :data:`CLOSE_TIMEOUT_S` in all) for launches
        abandoned by the stop: each waits on a rank of another process, and
        ends as that process ends its close, whose sockets close with it; a
        thread still in a collective when the interpreter ends aborts it."""
        deadline = time.monotonic() + CLOSE_TIMEOUT_S
        for thread in self._abandoned:
            thread.join(max(0.0, deadline - time.monotonic()))
            if thread.is_alive():
                logger.warning("a launch abandoned by the world's stop is still in a "
                               "collective")

    def stats(self) -> Dict[str, Any]:
        host = self.host
        return {"size": self.size, "generation": self.generation, "restarts": self.restarts,
                "pids": self.pids, "serving": self._serving.is_set(),
                "terminal": None if self.terminal is None else str(self.terminal),
                "ended": list(self.ended), "process_id": host.process_id,
                "processes": host.processes, "offset": host.offset, "world": host.world}
