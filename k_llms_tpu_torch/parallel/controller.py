"""The controlling rank: JAX's single controller, mapped onto one process per
card.

JAX drives every chip of its host from one process, so the scheduler, the
abort poller and the HTTP front door live in that process and concurrent
clients coalesce into one launch across all chips. The port runs one process
per card. On each host the first rank (:func:`.distributed.host_ranks`) is
the *controller*: it builds the whole serving stack (``KLLMs`` over
``CudaBackend``: scheduler, supervisor, tenancy, the front door). The host's
other ranks are *followers*: they build the same engine on their own shard of
the weights, own no serving state, and replay what the controller announces.

Every engine entry the serving stack calls announces itself before it runs,
under the engine's launch lock, so the followers run the launches in the
controller's order: a *plan* goes to the host's ranks over a gloo group
(``broadcast_object_list``) and every rank then runs the entry, taking part
in its collectives. A launch's plan holds its members' prompt ids, n and
seeds (those left unset are drawn on the controller), which members stream,
the sampling settings, stop sequences and max tokens, the ``engine.logits``
drill's rows, and its constraint: a compiled schema grammar travels as its
schema and is compiled on the follower through the port's grammar cache
(its digest checked), anything else as the object. The members' budgets
stay on the controller: its abort poller's flags ride the decode loop's
per-step reduction, so an aborted member stops on every rank at the same
step.

The same script runs on every rank::

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.parallel.distributed import initialize_multihost

    initialize_multihost()                   # the KLLMS_* variables
    client = KLLMs(backend="cuda", model="llama-3-8b", model_parallel=2)
    if client.backend.is_controller:         # the host's first rank
        serve(client)                        # threads, the HTTP front door
    client.close()                           # a follower's close is a no-op

On a follower, building the client hands the rank to the controller: the
constructor replays plans and returns only after the controller's
``close()``. A follower whose plan raises records its error in the
coordinator's store and ends its process (:data:`FOLLOWER_FAULT_EXIT`),
which closes its connections: every collective the others wait in fails at
once, and the controller's launch fails as the typed 503
(``BackendUnavailableError``, ``KernelUnavailableError`` for a kernel) with
the follower's error. A world started rank by rank is then stopped: every
later request gets the same 503 (its followers' processes cannot be started
again from inside the world). A world of one host the controller's own
process started (:mod:`.launcher`, its :attr:`HostController.owner`) is
started again instead: the controller asks its owner for a restart whenever it would stop
(a follower that failed or was killed, an announced operation that never
ended), and the owner builds a new world, controller and engine. The hosts'
followers of a world of several processes (JAX's ``initialize_multihost``)
are started by each host's process too, and its owner stops the world on
every host instead, as a JAX job stops with a lost process.

Plans go out under a lock of their own (``controller.plans``), taken after
the engine's launch lock where a launch holds both, never before it. A
fault of the controller's that JAX heals by rebuilding its engine (a hung
launch, a poison escalation, a hung loop step or chunk, a corrupt loop
pool) is healed across the host the same way: the controller retires its
engine and sends the ``("rebuild", epoch)`` plan (:meth:`HostController.
rebuild`), every follower drops its engine and builds a new one on the same
mesh (the backend's :attr:`HostController.on_rebuild`), and the
controller's request is replayed on its new engine, with the supervisor's
and the loop's bounds. A retired engine announces nothing: a hung thread
that wakes on it gets :class:`EngineRetiredError` and no follower receives
its plan. A launch, call or hook announced before its thread hung leaves
the followers inside it: the rebuild waits for it to end (at most the
budget the backend gives), and stops the world if it does not.

The continuous decode loop (``engine/continuous.py``) runs on every rank:
the controller's loop is the one users submit to, and each follower holds a
*replica* of it, built from the controller's ``("loop", "init")`` plan with
the same geometry. Every device operation of the loop is a plan of its own
(an admission, one prefill chunk, one decode step, a reset after a worker
crash), announced by the controller's worker under the engine's launch lock
and replayed by the replicas in plan order, so every rank's slot table, page
allocator, prefix cache and grammar states stay identical. The budgets stay
on the controller: its aborts ride the next step's plan. With
``KLLMS_RANK_CHECK=1`` every loop plan ends with :meth:`HostController.agree`
over the slot mirrors and the allocator's digest. A rebuild plan empties
every replica onto the follower's new engine, and the controller's loop
re-admits its journalled survivors through ordinary announced admissions.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch.distributed as dist

from ..analysis.lockcheck import make_rlock, race_exempt
from ..reliability import failpoints as _failpoints
from ..types.wire import BackendUnavailableError
from .collectives import RankDivergenceError
from .distributed import host_ranks

logger = logging.getLogger(__name__)

#: The plan group waits this long for the next plan: an idle server is not
#: a fault.
PLAN_TIMEOUT = timedelta(days=365)
#: Where a failing follower leaves its error, in the default group's store.
FAULT_KEY = "kllms/controller/fault"
#: A follower's exit code after a fault.
FOLLOWER_FAULT_EXIT = 70

#: Functions every rank runs on its engine when the controller calls
#: :meth:`HostController.hook` (counting windows in tests and the card
#: smoke), by name: ``fn(engine, *args)``.
HOOKS: Dict[str, Callable[..., Any]] = {}


def register_hook(name: str, fn: Callable[..., Any]) -> None:
    HOOKS[name] = fn


class FollowerFaultError(BackendUnavailableError):
    """A follower failed while the world served: the world is stopped."""

    code = "follower_fault"


class EngineRetiredError(BackendUnavailableError):
    """An engine the controller has rebuilt tried to announce an operation:
    nothing was sent and nothing ran (the caller may run it again on the
    current engine)."""

    code = "engine_retired"


def _discard(step, tokens) -> None:
    """A follower's stand-in token sink: it marks the member as streamed so
    the decode loop gathers each step, and drops the tokens."""


class HostController:
    """One host's controller or follower, beside its engine. Built on every
    rank of a world larger than one (:meth:`for_world`, a collective)."""

    def __init__(self, engine, group, ranks: Sequence[int]):
        self.engine = engine
        self.group = group
        self.ranks = list(ranks)
        self.root = self.ranks[0]
        self.is_controller = dist.get_rank() == self.root
        # The backend's constraint codec (a schema grammar travels as its
        # schema); identity by default.
        self.encode_constraint: Callable[[Any], Any] = lambda c: ("object", c)
        self.decode_constraint: Callable[[Any], Any] = lambda c: c[1]
        # kllms: unguarded — set once, when the world stops; readers raise it
        self.stopped: Optional[BackendUnavailableError] = None
        # The world's owner where this process started it (a
        # launcher.SpawnedWorld, asked for a restart, or for the stop on
        # every process, where a hand-started world stops) and the world's
        # generation there.
        self.owner = None
        self.generation = 0
        # kllms: unguarded — counted by the one thread that sends or serves plans
        self.plans = 0
        # The continuous loop on this rank: the controller's own (set by the
        # backend) or a follower's replica (built by the "init" plan).
        self.loop = None
        # Plans go out one at a time under a lock of their own, so that a
        # hung launch holding its engine's launch lock cannot hold back the
        # rebuild plan.
        self._plan_lock = make_rlock("controller.plans")
        # Clear while a launch, call or hook announced to the followers is
        # still running on the controller (they are inside it).
        self._idle = threading.Event()
        self._idle.set()
        # A follower's part of a rebuild plan (the backend's): drop the
        # engine, build a new one on the same mesh, adopt it.
        self.on_rebuild: Optional[Callable[[], None]] = None
        # kllms: unguarded — the rebuild epoch, written under the plan lock
        self.rebuilds = 0
        # kllms: unguarded — swapped by the one rebuilding thread; a retired engine's plans are refused under the plan lock
        self.engine = None
        # Runtime twin of the annotations above (KLLMS_RACECHECK=1).
        race_exempt(self, "stopped", "plans", "rebuilds", "engine")
        self.adopt(engine)

    def adopt(self, engine) -> None:
        """Make ``engine`` this rank's: it announces through this controller
        (on the host's first rank) and marks itself controlled."""
        self.engine = engine
        engine.controlled = True
        engine.host_controller = self
        if self.is_controller:
            engine.controller = self

    @property
    def restartable(self) -> bool:
        """Whether a stop of this world is healed by starting a new one (the
        controller's process started a world of its host alone and has not
        given it up)."""
        return (self.owner is not None and self.owner.restartable
                and self.owner.terminal is None)

    @classmethod
    def for_world(cls, engine) -> Optional["HostController"]:
        """The controller (on each host's first rank) or follower for
        ``engine``; None in a world of one. Every rank of the world must
        call it, in the same order as its other group calls: each host's
        plan group is made by every rank."""
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return None
        mine = host_ranks().ranks
        hosts: List[Optional[List[int]]] = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, mine)
        group = None
        for ranks in sorted({tuple(h) for h in hosts}):
            g = dist.new_group(list(ranks), backend="gloo", timeout=PLAN_TIMEOUT)
            if list(ranks) == mine:
                group = g
        return cls(engine, group, mine)

    # -- the controller -------------------------------------------------------
    def _send(self, plan, source=None, opens: bool = False) -> None:
        """Broadcast ``plan`` under the plan lock. ``source``: the engine the
        plan comes from; a retired one raises :class:`EngineRetiredError`
        and sends nothing. ``opens``: the plan starts an operation that runs
        until its :meth:`guard` ends."""
        with self._plan_lock:
            # A retired engine's caller may run again on the current one,
            # which a restarted world's stopped one is not.
            if source is not None and source.retired:
                raise EngineRetiredError(
                    "this engine was retired by a rebuild; its operation was not announced")
            if self.stopped is not None:
                raise self.stopped
            self._broadcast(plan)
            if opens:
                self._idle.clear()

    def _broadcast(self, plan) -> None:
        try:
            dist.broadcast_object_list([plan], src=self.root, group=self.group)
        except Exception as e:
            raise self._stop(e) from e
        self.plans += 1

    def announce_loop(self, op: str, payload: Any = None) -> None:
        """Hand the followers' replica loops one operation of the
        controller's continuous loop. The loop's worker calls it inside its
        operation's section, which holds the launch lock from here to the
        operation's end."""
        self._send(("loop", op, payload), source=self.loop.engine)

    def gather(self, value: Any) -> List[Any]:
        """Every rank's ``value`` (picklable), in the host's rank order: one
        ``all_gather_object`` over the plan group, uncounted. Every rank
        calls it at the same point of the same plan."""
        values: List[Any] = [None] * len(self.ranks)
        dist.all_gather_object(values, value, group=self.group)
        return values

    def agree(self, value: Any, what: str) -> None:
        """Raise :class:`RankDivergenceError` on every rank of the host
        unless all hold the same ``value`` (:meth:`gather`). Every rank
        calls it at the same point of the same plan: the loop's rank
        check."""
        values = self.gather(value)
        differ = [self.ranks[i] for i, v in enumerate(values) if v != values[0]]
        if differ:
            raise RankDivergenceError(
                f"ranks {differ} hold another {what} than rank {self.ranks[0]} "
                f"(rank {dist.get_rank()} checking)"
            )

    def stop_world(self, cause: BaseException) -> BackendUnavailableError:
        """Stop the world for a fault of the controller's own loop that left
        the followers inside an announced operation (the typed 503 from now
        on)."""
        return self._stop(cause)

    def rebuild(self, build: Callable[[], Any], wait_s: float):
        """Rebuild the engine on every rank of the host; returns the
        controller's new engine from ``build()``. Once no announced launch,
        call or hook is open (waiting at most ``wait_s`` for one to end), the
        current engine is retired and the ``("rebuild", epoch)`` plan sent,
        both under the plan lock; then ``build()`` runs here and the new
        engine is adopted. An operation still open after ``wait_s`` stops the
        world: the followers are inside it and cannot read the plan."""
        deadline = time.monotonic() + wait_s
        while True:
            if self.stopped is not None:
                raise self.stopped
            with self._plan_lock:
                if self._idle.is_set():
                    self.engine.retired = True
                    self.rebuilds += 1
                    self._broadcast(("rebuild", self.rebuilds))
                    break
            if not self._idle.wait(max(0.0, deadline - time.monotonic())):
                err = self._stop(RuntimeError(
                    f"an announced operation did not end within {wait_s:.1f} s of its "
                    "engine's rebuild; the followers are still inside it"))
                threading.Thread(target=self._release_when_idle, daemon=True,
                                 name="kllms-world-release").start()
                raise err
        engine = build()
        self.adopt(engine)
        return engine

    def _release_when_idle(self) -> None:
        """Send the stopped world's close plan once the operation the
        followers are inside ends (never, for a kernel wedged on a card)."""
        self._idle.wait()
        with self._plan_lock:
            try:
                self._broadcast(("close",))
            except BackendUnavailableError:
                logger.debug("controller: the close plan did not reach the followers")

    def announce_launch(self, items, kwargs: Dict[str, Any],
                        poison_rows: Optional[List[int]], source) -> None:
        """Hand the followers a coalesced launch of ``source`` (the engine's
        ``_launch`` calls it under the launch lock, before any device work;
        :meth:`guard` then runs it)."""
        kw = dict(kwargs)
        if kw.get("constraint") is not None:
            kw["constraint"] = self.encode_constraint(kw["constraint"])
        members = [(list(map(int, it.prompt_ids)), int(it.n), int(it.seed),
                    it.token_sink is not None) for it in items]
        self._send(("launch", members, kw, poison_rows), source=source, opens=True)

    def call(self, source, method: str, *args, **kwargs):
        """Run ``engine.<method>(*args, **kwargs)`` on every rank of the
        host, in plan order, for the engine ``source``; returns the
        controller's result."""
        with source._launch_lock:
            self._send(("call", method, args, kwargs), source=source, opens=True)
            return self.guard(getattr(source, method), *args, **kwargs)

    def hook(self, name: str, *args):
        """Run the registered hook ``name(engine, *args)`` on every rank, in
        plan order; returns the controller's result. In a world this
        process started, a module-level hook travels as its reference and
        its followers import it (:func:`.launcher.resolve_function`)."""
        engine = self.engine
        fn = HOOKS[name]
        plan = ("hook", name, args)
        if self.owner is not None:
            from .launcher import function_ref

            ref = function_ref(fn)
            if ref is None:
                raise ValueError(
                    f"hook {name!r} is a closure; the followers this process started "
                    "import their hooks, so it must be a module-level function")
            plan += (ref,)
        with engine._launch_lock:
            self._send(plan, source=engine, opens=True)
            return self.guard(fn, engine, *args)

    def guard(self, fn, *args, **kwargs):
        """Run the controller's part of an announced entry, which ends the
        open operation. An exception escaping it leaves the followers inside
        the entry: the world stops, and the exception becomes the typed 503
        (with a follower's recorded error, if one failed)."""
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            raise self._stop(e) from e
        finally:
            self._idle.set()

    def close(self) -> None:
        """End the followers' loops (each follower's client constructor then
        returns). Idempotent; nothing is sent once the world has stopped."""
        if self.stopped is not None:
            return
        try:
            self._send(("close",))
        except BackendUnavailableError:
            pass
        self.stopped = BackendUnavailableError("the world was closed")

    def lose(self, reason: str) -> BackendUnavailableError:
        """The owner's part when a rank of its world is lost: the engine is
        retired and the world stopped (the typed error, with a follower's
        recorded one), so that nothing more is announced on it."""
        with self._plan_lock:
            if self.engine is not None:
                self.engine.retired = True
        return self._stop(RuntimeError(reason), "a follower was lost")

    def _stop(self, cause: BaseException, what: Optional[str] = None) -> BackendUnavailableError:
        if self.stopped is None:
            fault = _read_fault()
            kind, message = fault if fault else (type(cause).__name__, str(cause))
            err_type = FollowerFaultError
            if kind == "KernelUnavailableError" or message.startswith("CUDA kernel"):
                from ..ops.paged_attention import KernelUnavailableError

                err_type = KernelUnavailableError
            if fault:
                what = "a follower failed"
            what = what or "a launch across the host's ranks failed"
            then = "the world is started again" if self.restartable else "the world is stopped"
            self.stopped = err_type(f"{what}; {then}: {kind}: {message}")
            logger.error("controller: %s", self.stopped)
        if self.owner is not None and self.owner.terminal is None:
            # The owner starts a world of its host again, or stops one of
            # several processes on every host.
            self.owner.request_restart(self.generation, str(self.stopped))
        return self.stopped

    # -- a follower -----------------------------------------------------------
    def serve(self) -> int:
        """Replay the controller's plans until its ``close()``; returns the
        number of plans run. A plan that raises ends the process
        (:data:`FOLLOWER_FAULT_EXIT`) after recording the error."""
        while True:
            box: List[Any] = [None]
            dist.broadcast_object_list(box, src=self.root, group=self.group)
            plan = box[0]
            if plan[0] == "close":
                return self.plans
            try:
                self._execute(plan)
            except BaseException as e:
                _fault(e)
            self.plans += 1

    def _execute(self, plan) -> None:
        kind = plan[0]
        if kind == "rebuild":
            # Before any local takes the engine: the follower drops its
            # last reference before it builds the next one.
            self.rebuilds = plan[1]
            self.on_rebuild()
            return
        engine = self.engine
        if kind == "launch":
            from ..engine.engine import GenRequestSpec

            _, members, kw, poison_rows = plan
            # The controller's check of this site ran before it announced;
            # a follower's fires here (the follower-fault drill).
            _failpoints.fire("engine.launch")
            kw = dict(kw)
            if kw.get("constraint") is not None:
                kw["constraint"] = self.decode_constraint(kw["constraint"])
            items = [GenRequestSpec(ids, n, seed, token_sink=_discard if streamed else None)
                     for ids, n, seed, streamed in members]
            engine.replay_launch(items, kw, poison_rows)
        elif kind == "call":
            _, method, args, kwargs = plan
            with engine._launch_lock, engine._on_card():
                getattr(engine, method)(*args, **kwargs)
        elif kind == "hook":
            fn = HOOKS.get(plan[1])
            if len(plan) > 3 and plan[3] is not None:
                from .launcher import resolve_function

                fn = resolve_function(plan[3])
            with engine._on_card():
                fn(engine, *plan[2])
        elif kind == "loop":
            _, op, payload = plan
            if op == "init":
                from ..engine.continuous import ContinuousDecodeLoop

                self.loop = ContinuousDecodeLoop.replica(engine, self, **payload)
            else:
                self.loop.replay(op, payload)
        else:
            raise ValueError(f"unknown plan {kind!r}")


def _store():
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


def _read_fault() -> Optional[tuple]:
    """(exception type, message) a follower recorded, or None."""
    try:
        store = _store()
        if store.check([FAULT_KEY]):
            kind, _, message = store.get(FAULT_KEY).decode().partition("\n")
            return kind, message
    except Exception:  # a store that is gone has no record
        logger.debug("controller: no fault record readable", exc_info=True)
    return None


def _fault(e: BaseException) -> None:
    """Record a follower's error and end its process, closing its
    connections so that no rank waits on it in a collective."""
    logger.error("follower rank %d failed a plan; ending the process:\n%s",
                 dist.get_rank(), traceback.format_exc())
    try:
        _store().set(FAULT_KEY, f"{type(e).__name__}\nrank {dist.get_rank()}: {e}")
    except Exception:
        logger.exception("follower: could not record the fault")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(FOLLOWER_FAULT_EXIT)
