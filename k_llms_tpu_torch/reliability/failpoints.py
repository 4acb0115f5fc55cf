"""Deterministic failpoint registry (fail-rs / Jepsen-style fault injection).

Every hardened failure path in the serving stack must be exercisable on CPU
without real faults. Sites are named strings compiled into the hot path as a
single dict lookup against an almost-always-empty registry (no-op in
production); activation is per-test via the ``failpoints`` context manager or
process-wide via ``KLLMS_FAILPOINTS``.

Injection sites wired in this package:

- ``scheduler.admit``    — evaluated at submit time (admission control)
- ``engine.launch``      — evaluated at the top of every coalesced batch
                           launch, inside the OOM guard; the ``oom`` action
                           here exercises split-and-requeue without a device
- ``engine.decode``      — evaluated per request around the decode loop;
                           ``kill_samples`` marks a seeded subset of the n
                           samples as lost mid-decode
- ``engine.logits``      — evaluated once per launch before the decode loop;
                           the ``nan`` action poisons a seeded subset of the
                           batch rows' first-step logits, exercising the
                           numeric-integrity quarantine
- ``loader.params``      — evaluated inside ``load_checkpoint``; ``corrupt``
                           flips bytes in a loaded float leaf so integrity
                           verification must fail fast
- ``backend.dispatch``   — evaluated per dispatch attempt (retry/circuit path)
- ``consensus.consolidate`` — evaluated at consolidation entry
- ``replica.dispatch``   — evaluated (keyed by replica id) before every member
                           dispatch of a :class:`ReplicaSet` — primary,
                           failover, and hedge attempts alike; the ``down``
                           action kills the attempt with a replica-health
                           error so routing must fail over
- ``replica.probe``      — evaluated (keyed by replica id) at the top of a
                           replica health probe; ``fail`` keeps a pulled
                           member out of rotation until the spec exhausts
- ``engine.pages``       — evaluated when the continuous decode loop releases
                           a retired slot's KV pages; the ``leak`` action
                           drops ``kill`` pages from the pool's free stack
                           without accounting, so the page-conservation
                           invariant (``ContinuousDecodeLoop.stats``) must
                           fail fast instead of serving from a corrupt pool
- ``serving.request``    — evaluated by the HTTP front door at request entry
                           (``serving/app.py``); the ``disconnect`` action
                           makes the server treat the client as having dropped
                           mid-stream after the first delta chunk, exercising
                           the disconnect → budget-cancel → decode-abort path
                           without a real socket teardown
- ``consensus.device``   — evaluated at the top of the device-consensus
                           prepare step (``consensus/device.py``); the
                           ``fallback`` action forces the scorer to degrade to
                           the host similarity/voting path for that
                           consolidation, exercising the automatic-fallback
                           contract (zero request failures) mid-traffic
- ``ops.paged_attn``     — evaluated when a decode loop/launch resolves its
                           paged-attention implementation
                           (``ops/paged_attention.py``); the ``fallback``
                           action sends one CPU launch to the plain version
                           (recording ``kernel.paged_attn_fallback.failpoint``)
                           and fails one card launch with a typed 503
                           (recording ``kernel.paged_attn_unavailable.failpoint``):
                           nothing on a card gives way to the plain version
- ``engine.grammar``     — evaluated when ``grammar_for_schema`` resolves a
                           compiled grammar mask (``engine/grammar.py``); the
                           ``fallback`` action degrades the request to
                           unconstrained decode + post-hoc validation
                           (recording ``grammar.fallback_failpoint``), and a
                           ``raise`` spec simulates a grammar compile error
                           (caught in-module, recorded as
                           ``grammar.fallback_error``) — the contract under
                           drill is that constrained decoding never errors a
                           request
- ``continuous.step``    — evaluated inside the continuous decode loop's
                           per-step device dispatch (``engine/continuous.py``),
                           i.e. under the loop watchdog's step budget; a
                           ``hang`` spec wedges the dispatch so the watchdog
                           must epoch-fence the abandoned thread, rebuild the
                           engine, and replay the journaled in-flight rows
- ``continuous.prefill`` — evaluated inside the continuous loop's chunked-
                           prefill device dispatch (``engine/continuous.py``),
                           i.e. once per prompt chunk under the same watchdog
                           budget as a decode step; a ``hang`` spec wedges the
                           chunk mid-prompt so recovery must epoch-fence the
                           abandoned thread, rebuild, and REPLAY the
                           half-prefilled admission from cursor 0 with
                           byte-identical output
- ``continuous.worker``  — evaluated at the top of every continuous-loop
                           worker iteration, OUTSIDE the step-level error
                           guard; the ``crash`` action kills the worker thread
                           itself so crash containment must flush every queued
                           and in-flight future with a typed error and restart
                           the loop (bounded by ``max_rebuilds``)
- ``serving.trace``      — evaluated when the tracer starts a request trace
                           (``observability/trace.py``); the ``drop`` action
                           degrades the tracer to no-op spans for that
                           request (no timings, no flight record) while the
                           request itself completes untouched — the contract
                           under drill is that tracing never fails a request
- ``scheduler.tenant``   — evaluated (keyed by tenant name) when the
                           scheduler charges a request against its tenant's
                           token buckets (``engine/scheduler.py``); the
                           ``exhaust`` action forces a quota miss for the
                           named tenant so the typed 429 path — bucket-refill
                           ``retry_after``, per-tenant shed counters — is
                           exercisable without actually draining a bucket
- ``batch.store``        — evaluated inside every batch job-store journal
                           append (``reliability/jobstore.py``); the ``torn``
                           action writes only a PREFIX of the CRC frame and
                           then raises, leaving exactly the on-disk state a
                           kill mid-append leaves, so torn-tail truncation on
                           recovery is exercisable without killing a process
- ``batch.worker``       — evaluated at the top of every batch-lane worker
                           iteration, after an item is dequeued but BEFORE it
                           is marked started (``serving/batch.py``); the
                           ``crash`` action kills the worker thread itself so
                           crash containment must checkpoint the dequeued
                           item back to pending and the lane's exactly-once
                           recovery must complete the job after restart

Actions (``FailSpec.action``):

- ``"raise"``        — raise ``error_factory()`` (default RuntimeError)
- ``"oom"``          — raise a RESOURCE_EXHAUSTED-shaped RuntimeError matching
                       what jax surfaces on device HBM exhaustion, so the
                       engine's OOM guard (not generic error handling) catches
- ``"sleep"``        — block ``delay`` seconds (deadline-expiry simulation)
- ``"hang"``         — block ``delay`` seconds (default effectively forever);
                       distinct from ``sleep`` so a hung-launch spec reads as
                       what it simulates and defaults to "never returns",
                       which is what the launch watchdog must survive
- ``"kill_samples"`` — no-op at the site itself; the engine reads ``kill`` and
                       ``seed`` and marks that many samples failed
- ``"nan"``          — no-op at the site itself; the engine reads ``kill``
                       (row count) and ``seed`` and poisons that many batch
                       rows' logits with NaN
- ``"corrupt"``      — no-op at the site itself; the loader flips bytes in a
                       param leaf after load so checksum verification trips
- ``"down"``         — raise ``EngineHungError`` (a replica-health error) for
                       the member named by ``member``; other members of the
                       keyed site pass through without consuming ``times``
- ``"fail"``         — raise RuntimeError for the member named by ``member``
                       (generic probe/dispatch failure, keyed like ``down``)
- ``"disconnect"``   — no-op at the site itself; the serving layer reads the
                       spec and simulates the client dropping the connection
                       mid-stream (cancel budget, abort the SSE response)
- ``"leak"``         — no-op at the site itself; the paged-KV release path
                       reads ``kill`` and drops that many pages from the free
                       stack unaccounted (a simulated lost decref)
- ``"fallback"``     — no-op at the site itself; the consumer reads the spec
                       and silently degrades to its host/reference path while
                       recording the fallback counters (device consensus ->
                       host scorer; paged attention -> XLA reference;
                       grammar mask -> unconstrained + post-hoc validation)
- ``"crash"``        — raise a RuntimeError shaped like an unexpected worker
                       death; distinct from ``raise`` so a crash-containment
                       spec reads as what it simulates and so the env syntax
                       defaults to firing once (a crash on *every* iteration
                       is a rebuild storm, not a drill)
- ``"drop"``         — no-op at the site itself; the tracer reads the spec
                       and hands out a no-op trace (spans, annotations, and
                       the flight record all degrade to nothing) while the
                       request proceeds normally
- ``"exhaust"``      — no-op at the site itself; the scheduler's tenant-quota
                       charge reads the spec and treats the named tenant's
                       buckets as empty for that request (typed 429 with the
                       bucket's own refill ``retry_after``), keyed by tenant
                       name like the replica sites
- ``"torn"``         — the job store's journal append reads the spec, writes
                       a partial frame (no fsync), and raises — a simulated
                       power cut mid-write; recovery must truncate the torn
                       tail and re-admit the affected items exactly once

``times`` bounds how often a spec fires (fail-rs' ``N*action``): after that
many evaluations the site reverts to no-op — this is how "backend fails twice
then recovers" retry tests are scripted.

Env syntax (comma-separated):
    KLLMS_FAILPOINTS="backend.dispatch=raise:2,engine.decode=kill_samples:3:7"
    KLLMS_FAILPOINTS="engine.launch=oom:1"
    KLLMS_FAILPOINTS="engine.launch=hang:1:30,engine.logits=nan:2:7"
    KLLMS_FAILPOINTS="loader.params=corrupt:1"
    KLLMS_FAILPOINTS="replica.dispatch=down:r1:2,replica.probe=fail:r1:1"
    KLLMS_FAILPOINTS="serving.request=disconnect:1"
    KLLMS_FAILPOINTS="engine.pages=leak:2"
    KLLMS_FAILPOINTS="consensus.device=fallback:3"
    KLLMS_FAILPOINTS="ops.paged_attn=fallback:2"
    KLLMS_FAILPOINTS="engine.grammar=fallback:1"
    KLLMS_FAILPOINTS="engine.grammar=raise:1"
    KLLMS_FAILPOINTS="continuous.step=hang:1:3"
    KLLMS_FAILPOINTS="continuous.prefill=hang:1:3"
    KLLMS_FAILPOINTS="continuous.worker=crash:1"
    KLLMS_FAILPOINTS="serving.trace=drop:2"
    KLLMS_FAILPOINTS="scheduler.tenant=exhaust:bulk:2"
    KLLMS_FAILPOINTS="batch.store=torn:1"
    KLLMS_FAILPOINTS="batch.worker=crash:1"
where the first numeric arg is ``times`` for
raise/sleep/oom/corrupt/disconnect/fallback/drop/torn/crash specs (crash
defaults to firing once), ``times[:delay]`` for hang, ``kill[:seed]`` for
kill_samples/nan, ``kill`` (pages to drop) for leak, and ``member[:times]``
for down/fail/exhaust (keyed sites: replica sites by replica id,
``scheduler.tenant`` by tenant name).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional

import contextlib

logger = logging.getLogger(__name__)

SITES = (
    "scheduler.admit",
    "engine.launch",
    "engine.decode",
    "engine.logits",
    "engine.pages",
    "loader.params",
    "backend.dispatch",
    "consensus.consolidate",
    "replica.dispatch",
    "replica.probe",
    "serving.request",
    "consensus.device",
    "ops.paged_attn",
    "engine.grammar",
    "continuous.step",
    "continuous.prefill",
    "continuous.worker",
    "serving.trace",
    "scheduler.tenant",
    "batch.store",
    "batch.worker",
)

#: Default "hang" duration: long enough that a watchdog MUST intervene for the
#: test to finish, short enough that a leaked spec can't wedge a CI job past
#: its own timeout.
HANG_DELAY = 3600.0


def _injected_oom() -> BaseException:
    # Mirrors the message jaxlib's XlaRuntimeError carries on HBM exhaustion;
    # the engine's OOM guard matches on the RESOURCE_EXHAUSTED marker, so the
    # injected fault takes exactly the split-and-requeue path a real one would.
    return RuntimeError(
        "RESOURCE_EXHAUSTED: injected device OOM (failpoint): "
        "Out of memory while trying to allocate batch buffers"
    )


@dataclass
class FailSpec:
    # "raise" | "oom" | "sleep" | "hang" | "kill_samples" | "nan" | "corrupt"
    # | "down" | "fail" | "disconnect" | "leak" | "fallback" | "crash"
    # | "drop" | "exhaust" | "torn"
    action: str = "raise"
    error_factory: Callable[[], BaseException] = field(
        default=lambda: RuntimeError("injected failpoint fault")
    )
    times: Optional[int] = None  # fire at most N times; None = every time
    delay: float = 0.0  # for action="sleep"/"hang" (hang defaults to HANG_DELAY)
    kill: int = 0  # kill_samples: samples to mark lost; nan: rows to poison
    seed: int = 0  # deterministic sample-kill / row-poison selection
    member: Optional[str] = None  # keyed sites: only fire for this replica id
    _fired: int = field(default=0, init=False, repr=False)

    def __post_init__(self) -> None:
        if self.action not in (
            "raise",
            "oom",
            "sleep",
            "hang",
            "kill_samples",
            "nan",
            "corrupt",
            "down",
            "fail",
            "disconnect",
            "leak",
            "fallback",
            "crash",
            "drop",
            "exhaust",
            "torn",
        ):
            raise ValueError(f"unknown failpoint action {self.action!r}")
        if self.action == "hang" and self.delay <= 0:
            self.delay = HANG_DELAY


# Import-time module lock: this module configures itself from the env at
# import, before any KLLMS_LOCKCHECK opt-in. Leaf by design — registry
# mutation only, never nested with another lock.
# kllms: ignore[lock-order] — import-time module lock, leaf by design
_lock = threading.Lock()
_registry: Dict[str, FailSpec] = {}


def active() -> bool:
    return bool(_registry)


def fire(site: str) -> Optional[FailSpec]:
    """Evaluate a site. Returns the spec for data-carrying actions
    (``kill_samples``); performs ``raise``/``sleep`` directly. The common
    production path is one falsy dict check."""
    if not _registry:
        return None
    with _lock:
        spec = _registry.get(site)
        if spec is None:
            return None
        if spec.times is not None:
            if spec._fired >= spec.times:
                return None
            spec._fired += 1
    logger.debug("failpoint %s fired (%s)", site, spec.action)
    if spec.action == "raise":
        raise spec.error_factory()
    if spec.action == "crash":
        raise RuntimeError(
            f"injected worker crash (failpoint): site {site} killed its thread"
        )
    if spec.action == "oom":
        raise _injected_oom()
    if spec.action in ("sleep", "hang"):
        time.sleep(spec.delay)
        return None
    return spec  # kill_samples/nan/corrupt/disconnect/torn/...: the site's owner interprets it


def fire_keyed(site: str, key: str) -> Optional[FailSpec]:
    """Evaluate a keyed site (the ``replica.*`` sites, keyed by replica id).

    The spec applies only when its ``member`` is ``None`` or equals ``key``; a
    non-matching member neither fires nor consumes ``times``, so
    ``down:r1:2`` kills exactly two dispatches *on r1* regardless of how many
    healthy-member dispatches are interleaved."""
    if not _registry:
        return None
    with _lock:
        spec = _registry.get(site)
        if spec is None:
            return None
        if spec.member is not None and spec.member != key:
            return None
        if spec.times is not None:
            if spec._fired >= spec.times:
                return None
            spec._fired += 1
    logger.debug("failpoint %s fired for %s (%s)", site, key, spec.action)
    if spec.action == "down":
        # Lazy import: wire depends on nothing here, but keep this module
        # import-light for the production no-op path.
        from ..types.wire import EngineHungError

        raise EngineHungError(f"injected replica fault (failpoint): member {key} is down")
    if spec.action == "fail":
        raise RuntimeError(f"injected replica fault (failpoint): member {key} failed")
    if spec.action == "raise":
        raise spec.error_factory()
    if spec.action == "oom":
        raise _injected_oom()
    if spec.action in ("sleep", "hang"):
        time.sleep(spec.delay)
        return None
    return spec


@contextlib.contextmanager
def failpoints(specs: Dict[str, FailSpec]) -> Iterator[None]:
    """Activate failpoints for a block; restores the previous registry (so
    nested scopes and test isolation compose)."""
    unknown = [s for s in specs if s not in SITES]
    if unknown:
        raise ValueError(f"unknown failpoint site(s) {unknown}; known: {list(SITES)}")
    with _lock:
        prev = dict(_registry)
        _registry.update(specs)
    try:
        yield
    finally:
        with _lock:
            _registry.clear()
            _registry.update(prev)


def clear() -> None:
    with _lock:
        _registry.clear()


def configure_from_env(env: Optional[str] = None) -> None:
    """Parse ``KLLMS_FAILPOINTS`` into the registry (process-wide activation
    for soak/chaos runs). Unknown sites fail loudly — a typo'd site name that
    silently never fires is worse than no injection."""
    raw = env if env is not None else os.getenv("KLLMS_FAILPOINTS", "")
    if not raw:
        return
    specs: Dict[str, FailSpec] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, rhs = part.partition("=")
        action, *args = rhs.split(":")
        if action in ("kill_samples", "nan"):
            kill = int(args[0]) if args else 1
            seed = int(args[1]) if len(args) > 1 else 0
            specs[site] = FailSpec(action=action, kill=kill, seed=seed)
        elif action == "leak":
            kill = int(args[0]) if args else 1
            specs[site] = FailSpec(action="leak", kill=kill)
        elif action == "sleep":
            delay = float(args[0]) if args else 0.1
            times = int(args[1]) if len(args) > 1 else None
            specs[site] = FailSpec(action="sleep", delay=delay, times=times)
        elif action == "hang":
            times = int(args[0]) if args else 1
            delay = float(args[1]) if len(args) > 1 else HANG_DELAY
            specs[site] = FailSpec(action="hang", times=times, delay=delay)
        elif action in ("oom", "corrupt", "disconnect", "fallback", "drop", "torn"):
            times = int(args[0]) if args else None
            specs[site] = FailSpec(action=action, times=times)
        elif action == "crash":
            # Unbounded crash specs are rebuild storms, not drills: default 1.
            times = int(args[0]) if args else 1
            specs[site] = FailSpec(action="crash", times=times)
        elif action in ("down", "fail", "exhaust"):
            member = args[0] if args and args[0] else None
            times = int(args[1]) if len(args) > 1 else None
            specs[site] = FailSpec(action=action, member=member, times=times)
        else:
            times = int(args[0]) if args else None
            specs[site] = FailSpec(action="raise", times=times)
    unknown = [s for s in specs if s not in SITES]
    if unknown:
        raise ValueError(f"KLLMS_FAILPOINTS names unknown site(s) {unknown}")
    with _lock:
        _registry.update(specs)


configure_from_env()
