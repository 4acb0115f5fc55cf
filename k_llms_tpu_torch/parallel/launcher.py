"""The host's followers, started by the controlling process itself.

JAX drives every chip of its host from one process, so
``KLLMs(backend="tpu", model_parallel=2)`` on a host of four chips serves on
a (2, 2) mesh with no further setup. The port runs one process per rank; a
plain process (no process group, none of the ``KLLMS_*`` world variables)
whose host counts more than one rank (:func:`.distributed.spawns_world`)
starts the others itself: :class:`SpawnedWorld` makes a ``TCPStore`` on a
free loopback port, starts each other rank as a fresh interpreter running
:mod:`.follower` (never ``fork``: CUDA may be initialised already) with the
``KLLMS_*`` variables and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` set, hands
them the controller's backend configuration through the store, and joins
the world as its rank 0. From there the world is a hand-started one: the
engine's mesh, :class:`.controller.HostController` and every plan.

The controller owns its followers' lives. A watcher thread polls the
children; a follower that ends (a fault's exit 70, a kill), or a launch
across the world that failed, hands the owner (the backend) a restart: the
surviving children are ended, the process group destroyed, and a new store,
new children, a new controller and mesh and a new engine on every rank take
their place, bounded by the backend's ``max_rebuilds``. ``close()`` joins
every child after the controller's close plan. A child whose controller's
process ends (even by ``SIGKILL``) ends within a fraction of a second
(:func:`watch_parent`).

A follower writes its standard output to the controller's standard error,
so nothing of a child follows the controller's own last line. Hooks
(:func:`.controller.register_hook`) of a world started here travel as
references to module-level functions: a follower imports their module, and
the controller's main module as ``multiprocessing``'s spawn does
(:func:`resolve_function`), the first time one is called.
"""

from __future__ import annotations

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
from .distributed import end_world, initialize_local_world

logger = logging.getLogger(__name__)

#: The module every follower runs (``python -m``).
FOLLOWER_MODULE = "k_llms_tpu_torch.parallel.follower"
#: Where the controller leaves a follower's payload in its store.
PAYLOAD_KEY = "kllms/launcher/payload"
#: Where a follower marks that it reached the store (its rank appended).
READY_KEY = "kllms/launcher/ready/"
#: Seconds the controller waits for every follower to reach its store.
START_TIMEOUT_S = 300.0
#: Seconds ``close()`` waits for each follower to end after the close plan.
CLOSE_TIMEOUT_S = 60.0
#: How often the watcher polls the children, and a child its parent.
POLL_S = 0.05
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


def _child_env(port: int, size: int, rank: int) -> Dict[str, str]:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(KLLMS_COORDINATOR=f"127.0.0.1:{port}", KLLMS_NUM_PROCESSES=str(size),
               KLLMS_PROCESS_ID=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    return env


class SpawnedWorld:
    """A world of ``size`` ranks on this host whose rank 0 is this process.
    ``payload`` (picklable) is what every follower reads from the store;
    ``device`` is rank 0's; ``on_lost(reason)`` is the owner's restart,
    run on the watcher thread when a child ends or a restart is asked for."""

    def __init__(self, size: int, payload: Dict[str, Any], device,
                 on_lost: Callable[[str], None]):
        self.size = int(size)
        self.payload = dict(payload, main=main_spec(), threads=torch.get_num_threads())
        self.device = device
        self.on_lost = on_lost
        self._lock = make_lock("launcher.world")
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
        # kllms: unguarded — the world's store, kept alive by the one thread that starts or ends the world
        self._store = None
        race_exempt(self, "procs", "generation", "restarts", "terminal", "_store")
        self._closing = False
        self._restarting = False
        self._wanted: Optional[str] = None
        # Set while the world serves; clear while it is started again.
        self._serving = threading.Event()
        self._serving.set()
        self._watcher: Optional[threading.Thread] = None

    # -- start --------------------------------------------------------------
    def start(self) -> None:
        """Start the followers and join the world as rank 0. Raises when a
        follower ends, or does not reach the store, before the world forms
        (the started children are ended)."""
        store = dist.TCPStore("127.0.0.1", 0, self.size, is_master=True,
                              wait_for_workers=False,
                              timeout=timedelta(seconds=START_TIMEOUT_S))
        store.set(PAYLOAD_KEY, pickle.dumps(self.payload))
        procs = [subprocess.Popen([sys.executable, "-m", FOLLOWER_MODULE],
                                  env=_child_env(store.port, self.size, r), stdout=2)
                 for r in range(1, self.size)]
        self.procs = procs
        self.generation += 1
        try:
            deadline = time.monotonic() + START_TIMEOUT_S
            keys = [f"{READY_KEY}{r}" for r in range(1, self.size)]
            while not store.check(keys):
                ended = [(r, p.returncode) for r, p in enumerate(procs, 1) if p.poll() is not None]
                if ended:
                    raise RuntimeError(
                        f"follower rank {ended[0][0]} ended with exit code {ended[0][1]} "
                        "before it joined the world")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the followers did not reach the store in "
                                       f"{START_TIMEOUT_S:.0f} s")
                time.sleep(POLL_S)
            initialize_local_world(store, self.size, self.device)
        except BaseException:
            self.end_children()
            raise
        self._store = store
        logger.info("started a world of %d ranks (generation %d): followers %s",
                    self.size, self.generation, [p.pid for p in procs])

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    # -- the watcher ----------------------------------------------------------
    def watch(self) -> None:
        """Start the watcher thread (once)."""
        if self._watcher is None:
            self._watcher = threading.Thread(target=self._watch, name="kllms-world-watch",
                                             daemon=True)
            self._watcher.start()

    def _watch(self) -> None:
        while True:
            with self._lock:
                if self._closing or self.terminal is not None:
                    return
                reason, self._wanted = self._wanted, None
            for r, p in enumerate(self.procs, 1):
                if reason is None and p.poll() is not None:
                    reason = f"follower rank {r} (pid {p.pid}) ended with exit code {p.returncode}"
            if reason is None:
                time.sleep(POLL_S)
                continue
            logger.error("the host's world lost a rank: %s; starting it again", reason)
            with self._lock:
                # This restart answers every request made of this world so far.
                self._restarting, self._wanted = True, None
            try:
                self.on_lost(reason)
            except BaseException as e:  # the owner's restart must never kill the watcher
                logger.exception("the world's restart raised")
                self.fail(e)
            finally:
                with self._lock:
                    self._restarting = False

    def request_restart(self, generation: int, reason: str) -> None:
        """Ask the watcher to start the world again (a launch across the
        world of ``generation`` failed). Ignored for an older world, during
        a restart and once the world closes."""
        with self._lock:
            if (self._closing or self.terminal is not None or self._restarting
                    or generation != self.generation):
                return
            self._wanted = self._wanted or reason

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
        """End the children and the world, then start a new one."""
        self.end_children()
        end_world()
        self._store = None
        self.start()

    def fail(self, error: BaseException) -> None:
        """Give the world up: its children and group end, and every waiter
        gets ``error``."""
        self.terminal = error
        self.end_children()
        end_world()
        self._store = None
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
        exits from now on are the close plan's."""
        with self._lock:
            self._closing = True
        if self._watcher is not None and self._watcher is not threading.current_thread():
            self._watcher.join()

    def close(self) -> List[Optional[int]]:
        """After the controller's close plan: join every child (killed after
        :data:`CLOSE_TIMEOUT_S`) and end the world. Returns the children's
        exit codes, in rank order."""
        self.closing()
        self._reap()
        end_world()
        self._store = None
        return [p.returncode for p in self.procs]

    def stats(self) -> Dict[str, Any]:
        return {"size": self.size, "generation": self.generation, "restarts": self.restarts,
                "pids": self.pids, "serving": self._serving.is_set(),
                "terminal": None if self.terminal is None else str(self.terminal),
                "ended": list(self.ended)}
