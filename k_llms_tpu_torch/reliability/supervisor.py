"""Self-healing engine supervision: hung-launch watchdog + rebuild/replay.

Deadlines, retries and breakers harden the *request* path (deadlines, retries, breakers, bounded
admission); the engine itself remained a single point of failure. A wedged
XLA launch never returns — no exception, no timeout — so the scheduler worker
blocks forever and every queued request hangs behind it. This module closes
that gap with the supervision pattern production engines use:

- **Watchdog**: every device launch runs on a disposable daemon thread under
  a wall-clock budget derived from the batch's token budget and a measured
  per-token latency EWMA (:class:`LaunchBudgetModel`). An overdue launch is
  declared hung; the supervisor detaches from it and keeps control of the
  caller's futures.
- **Epoch fencing**: the supervisor bumps a replay epoch the moment a launch
  is declared hung. The abandoned thread checks the epoch when (if ever) it
  completes and discards its result instead of racing the replay — the
  idempotency half of replay semantics.
- **Rebuild + replay**: a hung (or poison-escalated) engine is torn down and
  rebuilt through a caller-supplied ``rebuild_fn`` (recompile + param reload
  through the existing loader), then the SAME launch closure is re-invoked.
  Sampling seeds are pinned at submission time (see
  ``TpuBackend._generate_batched``), so a replay on identical weights is
  byte-identical to an uninterrupted run — the determinism half.
- **Bounded escalation**: consecutive rebuilds without a successful launch
  are bounded; exhaustion (or a corrupt checkpoint on reload) is terminal —
  the scheduler is moved to STOPPED and callers get typed 503s.

The supervisor runs entirely on the scheduler worker thread (the launch
thread is the only thing it spawns), so no new synchronization is imposed on
the engine: at most one launch/rebuild is ever active.

On a CUDA card the watchdog heals host-side hangs: the ``hang`` failpoint, a
stuck host thread, a deadlock. A kernel truly wedged on the card cannot be
killed from the process: the abandoned launch thread keeps the old engine
(and its weights on the card) until the kernel returns, and the replay
queues behind it on the same stream, so ``max_rebuilds`` then ends in
STOPPED and typed 503s. Launch threads issue their work on the card's
legacy default stream, as the scheduler's worker does, which keeps the
split-reduction kernels' arrival semaphores in stream order.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from ..utils.locks import make_lock
from ..types.wire import CheckpointCorruptError, EngineHungError
from ..utils.observability import RECOVERY_EVENTS

logger = logging.getLogger(__name__)


class LaunchBudgetModel:
    """Wall-clock budget for one device launch.

    ``budget = clamp(base + multiplier * max_new_tokens * per_token_ewma)``

    ``per_token_ewma`` is learned from completed launches (elapsed divided by
    the batch's max_new_tokens — decode steps dominate, and step latency is
    nearly row-count independent at serving widths, so tokens are the right
    unit). The generous ``min_budget`` floor absorbs first-launch compile
    time, which the EWMA then decays away from; ``multiplier`` is the slack
    between "slow" and "hung".
    """

    def __init__(
        self,
        base_s: float = 10.0,
        per_token_s: float = 0.5,
        multiplier: float = 8.0,
        min_budget_s: float = 60.0,
        max_budget_s: float = 900.0,
        ewma_alpha: float = 0.3,
    ) -> None:
        self.base_s = base_s
        self.multiplier = multiplier
        self.min_budget_s = min_budget_s
        self.max_budget_s = max_budget_s
        self.ewma_alpha = ewma_alpha
        self._lock = make_lock("reliability.launch_budget")
        self._per_token_s = per_token_s
        self._observed = 0

    def budget(self, rows: int, max_new_tokens: int) -> float:
        with self._lock:
            per_token = self._per_token_s
        raw = self.base_s + self.multiplier * max(1, max_new_tokens) * per_token
        return min(self.max_budget_s, max(self.min_budget_s, raw))

    def observe(self, rows: int, max_new_tokens: int, elapsed_s: float) -> None:
        sample = elapsed_s / max(1, max_new_tokens)
        with self._lock:
            if self._observed == 0:
                self._per_token_s = sample
            else:
                a = self.ewma_alpha
                self._per_token_s = a * sample + (1.0 - a) * self._per_token_s
            self._observed += 1

    # -- per-step budget (continuous decode loop) --------------------------
    #
    # The continuous loop's unit of dispatch is one STEP — a single token
    # across every active slot row — so its watchdog budget is the
    # max_new_tokens=1 specialization of the launch budget: the same EWMA,
    # the same clamp, learned one step at a time. The floor still absorbs
    # first-step compile (a new batch shape recompiles mid-loop).

    def step_budget(self) -> float:
        return self.budget(1, 1)

    def observe_step(self, elapsed_s: float) -> None:
        self.observe(1, 1, elapsed_s)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "per_token_s": round(self._per_token_s, 6),
                "observed_launches": self._observed,
            }


class EngineSupervisor:
    """Runs device launches under a watchdog and heals the engine when one
    hangs or numeric poison crosses the escalation threshold.

    ``rebuild_fn`` tears down and reconstructs the engine (the launch closure
    must re-resolve the engine at call time so a replay lands on the rebuilt
    one). The ``on_recovering``/``on_rebuilt``/``on_rebuild_failed`` hooks are
    the scheduler's RECOVERING / READY / STOPPED transitions.
    """

    def __init__(
        self,
        rebuild_fn: Callable[[], None],
        budget_model: Optional[LaunchBudgetModel] = None,
        max_rebuilds: int = 2,
        poison_threshold: float = 0.5,
        poison_window: int = 8,
        on_recovering: Optional[Callable[[int, str], None]] = None,
        on_rebuilt: Optional[Callable[[], None]] = None,
        on_rebuild_failed: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        self.rebuild_fn = rebuild_fn
        self.budget_model = budget_model or LaunchBudgetModel()
        self.max_rebuilds = max_rebuilds
        self.poison_threshold = poison_threshold
        self.on_recovering = on_recovering
        self.on_rebuilt = on_rebuilt
        self.on_rebuild_failed = on_rebuild_failed
        self._lock = make_lock("reliability.supervisor")
        self._epoch = 0
        self._consecutive_rebuilds = 0
        self._total_rebuilds = 0
        self._hung_launches = 0
        self._replayed = 0
        self._rebuild_wanted: Optional[str] = None
        self._terminal_error: Optional[BaseException] = None
        self._last_rebuild_reason: Optional[str] = None
        # (poisoned, total) per recent launch; escalation looks at the
        # aggregate fraction so one bad launch among many clean ones
        # doesn't trigger a rebuild.
        self._poison_history: Deque[Tuple[int, int]] = deque(maxlen=max(1, poison_window))

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- numeric-integrity escalation -------------------------------------

    def note_poison(self, poisoned: int, total: int) -> None:
        """Record one launch's quarantine outcome (poisoned rows out of
        total). Called from the engine's ``on_quarantine`` hook — including
        with ``poisoned=0`` for clean launches, so the window decays."""
        if total <= 0:
            return
        with self._lock:
            self._poison_history.append((int(poisoned), int(total)))
            bad = sum(p for p, _ in self._poison_history)
            seen = sum(t for _, t in self._poison_history)
            if seen > 0 and bad / seen >= self.poison_threshold and bad > 0:
                if self._rebuild_wanted is None:
                    logger.warning(
                        "poison rate %.2f over last %d launches >= %.2f: "
                        "escalating to engine rebuild",
                        bad / seen,
                        len(self._poison_history),
                        self.poison_threshold,
                    )
                self._rebuild_wanted = "poison_rate"

    # -- supervised launch --------------------------------------------------

    def supervised_launch(
        self,
        launch_fn: Callable[[], Any],
        rows: int = 1,
        max_new_tokens: int = 1,
    ) -> Any:
        """Run ``launch_fn`` under the watchdog; heal and replay on hang.

        Returns the launch's result (possibly from a replay on a rebuilt
        engine) or re-raises its exception. Raises :class:`EngineHungError`
        (or :class:`CheckpointCorruptError` from the reload) only when
        recovery is exhausted — that is the terminal path."""
        with self._lock:
            if self._terminal_error is not None:
                raise EngineHungError(
                    "engine supervisor is stopped after exhausting rebuild "
                    f"attempts: {self._terminal_error}"
                )
        replay = False
        while True:
            wanted = self._take_rebuild_wanted()
            if wanted is not None:
                self._rebuild(reason=wanted)
            budget = self.budget_model.budget(rows, max_new_tokens)
            start_epoch = self.epoch
            done = threading.Event()
            box: Dict[str, Any] = {}

            def _run(_epoch: int = start_epoch, _box: Dict[str, Any] = box, _done: threading.Event = done) -> None:
                try:
                    _box["result"] = launch_fn()
                except BaseException as exc:  # delivered to the caller below
                    _box["error"] = exc
                finally:
                    with self._lock:
                        stale = self._epoch != _epoch
                    if stale:
                        # The watchdog already declared this launch hung and
                        # moved on; its late result must not race the replay.
                        RECOVERY_EVENTS.record("supervisor.stale_results_discarded")
                        logger.warning(
                            "discarding stale result from hung launch (epoch %d < %d)",
                            _epoch,
                            self.epoch,
                        )
                    _done.set()

            started = time.monotonic()
            thread = threading.Thread(
                target=_run, name="kllms-supervised-launch", daemon=True
            )
            thread.start()
            if done.wait(budget):
                elapsed = time.monotonic() - started
                if "error" in box:
                    raise box["error"]
                self.budget_model.observe(rows, max_new_tokens, elapsed)
                with self._lock:
                    self._consecutive_rebuilds = 0
                if replay:
                    with self._lock:
                        self._replayed += rows
                    RECOVERY_EVENTS.record("supervisor.replayed", rows)
                return box["result"]
            # Hung: fence the epoch FIRST so the abandoned thread's eventual
            # result is discarded, then heal and replay.
            with self._lock:
                self._epoch += 1
                self._hung_launches += 1
            RECOVERY_EVENTS.record("supervisor.hung_launches")
            logger.error(
                "device launch exceeded its %.1fs watchdog budget "
                "(rows=%d, max_new_tokens=%d): declaring hung and rebuilding",
                budget,
                rows,
                max_new_tokens,
            )
            self._rebuild(reason="hung_launch")
            replay = True

    # -- rebuild ------------------------------------------------------------

    def _take_rebuild_wanted(self) -> Optional[str]:
        with self._lock:
            wanted, self._rebuild_wanted = self._rebuild_wanted, None
            return wanted

    def _rebuild(self, reason: str) -> None:
        with self._lock:
            self._consecutive_rebuilds += 1
            self._total_rebuilds += 1
            attempt = self._consecutive_rebuilds
            self._last_rebuild_reason = reason
            self._poison_history.clear()
            self._rebuild_wanted = None
        if attempt > self.max_rebuilds:
            self._terminal(
                EngineHungError(
                    f"engine did not recover after {self.max_rebuilds} rebuild "
                    f"attempt(s) (last reason: {reason})"
                )
            )
        if self.on_recovering is not None:
            self.on_recovering(attempt, reason)
        RECOVERY_EVENTS.record("supervisor.rebuilds")
        logger.warning("rebuilding engine (attempt %d/%d, reason=%s)", attempt, self.max_rebuilds, reason)
        try:
            self.rebuild_fn()
        except BaseException as exc:
            RECOVERY_EVENTS.record("supervisor.rebuild_failures")
            # A corrupt checkpoint can never be healed by retrying the
            # rebuild — fail fast with the precise error.
            if isinstance(exc, CheckpointCorruptError):
                self._terminal(exc)
            self._terminal(
                EngineHungError(f"engine rebuild failed (reason: {reason}): {exc}")
            )
        if self.on_rebuilt is not None:
            self.on_rebuilt()

    def _terminal(self, error: BaseException) -> None:
        with self._lock:
            self._terminal_error = error
        if self.on_rebuild_failed is not None:
            self.on_rebuild_failed(error)
        raise error

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "epoch": self._epoch,
                "hung_launches": self._hung_launches,
                "rebuilds": self._total_rebuilds,
                "consecutive_rebuilds": self._consecutive_rebuilds,
                "max_rebuilds": self.max_rebuilds,
                "replayed": self._replayed,
                "last_rebuild_reason": self._last_rebuild_reason,
                "stopped": self._terminal_error is not None,
                "launch_budget": self.budget_model.stats(),
            }
