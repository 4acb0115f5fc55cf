"""Continuous (in-flight) batching: a persistent decode loop with slot admission.

Counterpart of ``k_llms_tpu/engine/continuous.py``. The coalescing scheduler
(scheduler.py) batches requests that arrive inside an admission window and
decodes the group to completion; this loop is the Orca/vLLM-style
alternative: a fixed-width decode batch of W slots that steps forever, where
a request's n sample rows JOIN the batch the step after admission and LEAVE
the moment they finish, freeing their slots for queued work.

Design, as in the JAX loop:

- Device state follows the engine's KV layout. Dense: a per-slot prompt
  prefix ``[L, W, P, kvh, d]`` plus a per-slot generation cache ``[L, W, G,
  kvh, d]``, and one step (``models.llama.verify_step`` at Sq=1, per-row
  write offsets) advances all W slots. Paged: each slot holds a block table
  of pool page ids (prompt pages shared by a request's n rows, refcounted,
  copied on the first divergent write; generation pages reserved at
  admission), and the step is ``paged_verify_step`` (the paged-decode kernel
  on a card, one table row per slot) plus the fresh column's write into the
  pool. The engine's pool is sized once (``LocalEngine._ensure_kv_pool``,
  for the loop's worst case when the loop builds it first) and never
  replaced, as in the JAX engine.
- Sampling is per ROW (``_sample_rows``: temperature[W],
  top_p[W], greedy at temperature 0, untempered logprobs). Row r draws from
  ``fold_in(fold_in(key(seed_r), gen_len_r + 1), sample_idx_r)`` (the first
  token at step 0, at admission): the per-row entry of the threefry kernel,
  one launch per loop step and one per admission, so a request's tokens do
  not depend on what it shares the batch with.
- Prompts longer than ``prefill_chunk_tokens`` are ingested chunk by chunk
  (``prefill_chunk_step``: the flash kernel in its ``q_offset`` mode), one
  chunk between decode steps; the final chunk's logits feed the same
  admission tail, so chunked and whole-prompt admission sample alike.
- Grammar-constrained requests ride the loop under one resident
  ``CompiledGrammar`` (its tables padded to a power of two of states);
  steps with no constrained row run no mask; a request under a different
  schema raises ValueError at submit and the backend coalesces it.
- The host drives the loop: eos / max_new retirement, budget aborts
  (``engine.decode_abort``), WFQ admission, token sinks.
- Reliability: each step and chunk runs on a disposable dispatch thread
  under a watchdog budget; a hung one is abandoned behind an epoch fence,
  the engine rebuilt and the journal replayed; a page-accounting fault
  quarantines the pool; any other worker fault fails the in-flight requests
  typed and restarts the loop.

Threads and streams: the worker and the dispatch threads enter the engine's
card (``torch.cuda.device``) and issue on its legacy default stream, as the
scheduler's worker does, so every kernel stays in stream order (the split
kernels' arrival semaphores, ``ops/_ext.py``). The JAX loop donates its
caches and discards an abandoned step's result; here tensors are written in
place, so each dispatch works on the tensors snapshotted under the loop lock
(a recovery allocates new dense caches; the paged column write and the
chunk's scatter are fenced by the epoch), and an abandoned thread writes
only into tensors the recovered loop no longer uses.

Lock order: the loop's Condition, then the engine's launch lock (which
stands in for the JAX engine's ``_paged_mutex``: admission, page allocation
and the prefix cache take it), then the pool's lock. No path takes the loop
lock while holding either of the others. The step's dispatch thread takes
only the pool lock, which a coalesced paged launch holds across its decode,
so a loop step waits for such a launch, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import queue as _queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from concurrent.futures import Future

from ..models.llama import (
    KVCache,
    init_cache,
    paged_verify_step,
    prefill_chunk_step,
    prefill_chunk_step_paged,
    verify_step,
)
from ..ops.random import threefry_uniform_rows
from ..ops.sampling import sanitize_logits
from ..reliability import failpoints as _failpoints
from ..reliability.deadline import RequestBudget
from ..types.wire import (
    BackendUnavailableError,
    CheckpointCorruptError,
    EngineHungError,
    ServerDrainingError,
)
from ..analysis.lockcheck import make_condition, note_device_dispatch, race_exempt
from ..utils.observability import (
    FAILURE_EVENTS,
    GRAMMAR_EVENTS,
    LATENCY,
    RECOVERY_EVENTS,
    current_trace,
)
from .engine import (
    GenerationResult,
    _poisoned_logits,
    _quarantine_error,
    is_resource_exhausted,
)
from .paging import (
    TRASH_PAGE,
    PageAccountingError,
    PagePoolExhausted,
    flat_slots,
    pages_for,
)

logger = logging.getLogger(__name__)


@dataclass
class _SlotRequest:
    """Host-side record of one admitted request and its slot rows.

    The journal fields (``ids`` / ``seed`` / ``temperature`` / ``top_p``,
    plus ``grammar``) are everything recovery needs to re-admit the request
    after an engine rebuild: row keys derive only from (seed, step,
    sample_idx), so replaying from the original prompt regenerates the same
    token stream — ``delivered_watermark`` then suppresses the
    already-delivered prefix so streaming sinks see contiguous tokens exactly
    once."""

    future: Future
    prompt_len: int
    n: int
    max_new: int
    budget: Optional[RequestBudget]
    token_sink: Optional[Callable[[int, np.ndarray], None]]
    # Replay journal: the canonical prompt tokens and admission-pinned
    # sampling parameters, recorded at submit before any device work.
    ids: List[int]
    seed: int
    temperature: float
    top_p: float
    seq: int
    # CompiledGrammar when the request decodes under a schema mask; the loop
    # holds ONE resident grammar's tables on device, so a different-digest
    # request is rejected at submit (the backend reroutes it to coalescing).
    grammar: Optional[Any] = None
    slots: List[int] = field(default_factory=list)
    # Per-sample accumulators, index-aligned with ``slots``.
    tokens: List[List[int]] = field(default_factory=list)
    logprobs: List[List[float]] = field(default_factory=list)
    done: List[bool] = field(default_factory=list)
    finish: List[str] = field(default_factory=list)
    sample_errors: List[Optional[Dict[str, Any]]] = field(default_factory=list)
    steps_delivered: int = 0
    # Sink steps already delivered before the last fault: replayed steps
    # below this watermark are regenerated (the device needs them) but NOT
    # re-delivered.
    delivered_watermark: int = 0
    replays: int = 0
    # Chunked-prefill cursor: how many prompt tokens the PREFILLING phase
    # has ingested so far. Replay after a rebuild resets it to 0 and
    # re-prefills from scratch.
    chunk_cursor: int = 0
    # Request trace captured on the SUBMITTING thread, plus the enqueue
    # timestamp for the queue-wait histogram.
    trace: Optional[Any] = None
    enqueued_at: float = 0.0
    # Resolved TenantContext (or None for the implicit default tenant):
    # drives WFQ slot selection and per-tenant queue-wait attribution.
    tenant: Optional[Any] = None


class _Prefilling:
    """The loop's single PREFILLING admission: a request whose prompt is
    being ingested chunk by chunk between decode steps. Owns its slot rows
    (popped from ``_free`` but NOT in ``_active``), the 1-row staging KV the
    chunks extend, and, in paged mode, the prompt page run (n row
    references) plus each row's pre-reserved generation pages. Guarded by
    the loop lock; the dispatch closure only reads snapshots taken under
    it."""

    __slots__ = ("req", "rows", "ids", "cache", "cursor", "plen", "bucket",
                 "run_pages", "reserved")

    def __init__(self, req: "_SlotRequest", rows: List[int], ids: List[int],
                 cache: Any, plen: int, bucket: int,
                 run_pages: Optional[List[int]],
                 reserved: List[List[int]]) -> None:
        self.req = req
        self.rows = rows
        self.ids = ids
        self.cache = cache
        self.cursor = 0
        self.plen = plen
        self.bucket = bucket
        self.run_pages = run_pages
        self.reserved = reserved


def _req_tenant_name(req: "_SlotRequest") -> str:
    return req.tenant.name if req.tenant is not None else "default"


def _req_interactive(req: "_SlotRequest") -> bool:
    return req.tenant is None or req.tenant.interactive


def _req_tenant_weight(req: "_SlotRequest") -> float:
    return max(req.tenant.weight, 1e-9) if req.tenant is not None else 1.0


def _sample_rows(logits: torch.Tensor, uniforms: torch.Tensor, temps: torch.Tensor,
                 top_ps: torch.Tensor):
    """The loop's per-row sampler (the JAX loop's ``_sample_rows``): each
    row has its own temperature and top-p. logits [B, V] f32, uniforms
    [B, V] (the row's draws), temps / top_ps [B] f32.

    The poison verdict is taken on the raw logits, then they are sanitised
    as in ``ops.sampling.sample_logits``. The nucleus is the JAX loop's
    sort-based one, not the batch sampler's bisection: the kept tokens are
    those at or above the smallest sorted value whose preceding mass
    ``cum - p`` is below top-p. A row at temperature <= 0 is greedy.
    Logprobs are the untempered model distribution's. Returns (tokens [B]
    int64, logprobs [B] f32, bad [B] bool)."""
    bad = _poisoned_logits(logits)
    logits = sanitize_logits(logits)
    model_lps = torch.log_softmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    sort_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sort_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    thresh = torch.where(keep, sort_desc, torch.full_like(sort_desc, float("inf"))).amin(dim=-1)
    masked = torch.where(scaled >= thresh[:, None], scaled, torch.full_like(scaled, -float("inf")))
    tiny = torch.finfo(uniforms.dtype).tiny
    sampled = torch.argmax(masked - torch.log(-torch.log(uniforms.clamp_min(tiny))), dim=-1)
    greedy = torch.argmax(scaled, dim=-1)
    tok = torch.where(temps <= 0.0, greedy, sampled)
    lp = torch.gather(model_lps, 1, tok[:, None])[:, 0]
    return tok, lp, bad


class _StepHung(RuntimeError):
    """Internal: a step dispatch overran its watchdog budget."""


class _StaleStep(RuntimeError):
    """Internal: an abandoned step thread woke into a newer loop epoch."""


class _PoolFault(RuntimeError):
    """Internal: page accounting failed; the pool must be quarantined."""


class _AdoptEngine(Exception):
    """Internal: an externally rebuilt engine is waiting to be adopted."""

    def __init__(self, engine: Any) -> None:
        super().__init__("adopt rebuilt engine")
        self.engine = engine


class _StepDispatcher:
    """Persistent dispatch thread the loop worker hands each device step to.

    The worker waits on the step's completion event under the watchdog
    budget; an overdue step is ABANDONED — its ticket is fenced, the inbox
    and thread are retired, and a fresh pair serves subsequent steps — so a
    wedged dispatch blocks one disposable thread, never the loop."""

    def __init__(self) -> None:
        self._inbox: "_queue_mod.Queue" = _queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None

    def _ensure(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._serve,
                args=(self._inbox,),
                name="kllms-continuous-step",
                daemon=True,
            )
            self._thread.start()

    @staticmethod
    def _serve(inbox: "_queue_mod.Queue") -> None:
        while True:
            item = inbox.get()
            if item is None:
                return
            fn, ticket = item
            try:
                ticket["result"] = fn()
            except BaseException as exc:
                ticket["error"] = exc
            finally:
                if ticket["abandoned"]:
                    RECOVERY_EVENTS.record("continuous.stale_steps_discarded")
                    logger.warning(
                        "discarding stale result from an abandoned "
                        "continuous step"
                    )
                ticket["done"].set()

    def run(self, fn: Callable[[], Any], budget_s: float) -> Any:
        """Run ``fn`` on the dispatch thread under a wall-clock budget.
        Returns its result, re-raises its error, or raises :class:`_StepHung`
        after abandoning the thread."""
        self._ensure()
        ticket: Dict[str, Any] = {
            "done": threading.Event(),
            "result": None,
            "error": None,
            "abandoned": False,
        }
        self._inbox.put((fn, ticket))
        if ticket["done"].wait(budget_s):
            if ticket["error"] is not None:
                raise ticket["error"]
            return ticket["result"]
        ticket["abandoned"] = True
        # Retire the inbox+thread pair: the sentinel makes the stale thread
        # exit once the hung dispatch finally returns, and the fresh pair
        # serves the rebuilt loop.
        self._inbox.put(None)
        self._inbox = _queue_mod.Queue()
        self._thread = None
        raise _StepHung(f"continuous step exceeded its {budget_s:.2f}s budget")

    def close(self) -> None:
        self._inbox.put(None)


class ContinuousDecodeLoop:
    """Persistent W-slot decode loop over one :class:`LocalEngine`.

    ``width`` is the slot count (the memory-aware cap is the caller's job —
    the backend clamps it through its memory model); ``max_prompt`` /
    ``max_new`` bound the per-slot prefix and generation KV (requests beyond
    either bound don't qualify and take the coalescing path).
    """

    def __init__(
        self,
        engine: Any,
        width: int,
        max_prompt: int,
        max_new: int,
        eos_ids: Optional[List[int]] = None,
        admission_gate: Optional[Callable[[], Optional[BaseException]]] = None,
        budget_model: Optional[Any] = None,
        rebuild_fn: Optional[Callable[[], Any]] = None,
        max_rebuilds: int = 2,
        on_recovering: Optional[Callable[[int, str], None]] = None,
        on_rebuilt: Optional[Callable[[], None]] = None,
        on_rebuild_failed: Optional[Callable[[BaseException], None]] = None,
        prefill_chunk_tokens: int = 0,
    ) -> None:
        # Only the worker swaps in an epoch-fenced replacement during
        # recovery; readers tolerate either generation, and admission
        # revalidates capacity under the loop lock before placement.
        # kllms: unguarded — single-writer epoch-fenced engine swap
        self.engine = engine
        # Runtime twin of the annotations in this __init__ plus the
        # qualifies() inline suppression: the lockset sanitizer skips what the
        # static rule skips. The device-state family (_prefix/_gen, the paged
        # pool and the resolved _paged_attn_impl) is handed to the disposable
        # dispatch thread under the epoch fence rather than the loop lock.
        race_exempt(
            self, "engine", "_pool_pages_planned", "_loop_epoch", "_prefix",
            "_gen", "_paged_attn_impl", "_pool",
        )
        self.width = int(width)
        self.max_prompt = int(max_prompt)
        self.max_new = int(max_new)
        # Chunked prefill: prompts longer than this many tokens are ingested
        # chunk by chunk between decode steps. 0 = off. Normalized DOWN to a
        # power of two >= 32: the prompt bucket is a power of two >= any
        # prompt that chunks (plen > C), so a pow2 C always divides it and
        # the paged chunk's fixed-width KV-column slice (cursor + C <=
        # bucket) never runs out of range.
        c = max(0, int(prefill_chunk_tokens))
        if 0 < c < 32:
            c = 32
        elif c > 32:
            c = 1 << (c.bit_length() - 1)
        self.prefill_chunk_tokens = c
        # The single in-flight chunked admission.
        self._prefilling: Optional[_Prefilling] = None
        self.eos_ids = list(eos_ids or [engine.config.eos_token_id])
        self._admission_gate = admission_gate
        # Self-healing wiring (all optional — a bare loop without a budget
        # model dispatches steps inline with no watchdog). ``budget_model``
        # is the loop's OWN LaunchBudgetModel: its per-step EWMA must not
        # pollute the coalesced path's per-launch timings. ``rebuild_fn``
        # rebuilds and returns a fresh engine after a hung step or a
        # quarantined page pool.
        self.budget_model = budget_model
        self.rebuild_fn = rebuild_fn
        self.max_rebuilds = int(max_rebuilds)
        self.on_recovering = on_recovering
        self.on_rebuilt = on_rebuilt
        self.on_rebuild_failed = on_rebuild_failed
        self._dispatcher = _StepDispatcher()
        # Epoch fence: bumped on every recovery; an abandoned step thread
        # waking into a newer epoch discards its work instead of writing
        # device state that belongs to the recovered loop.
        # kllms: unguarded — monotonic fence value; stale reads abort via _StaleStep
        self._loop_epoch = 0
        self._consecutive_faults = 0
        self._last_recovery_reason: Optional[str] = None
        self._terminal_error: Optional[BaseException] = None
        self._pool_fault: Optional[str] = None
        self._adopted_engine: Optional[Any] = None
        self._seq = 0
        # The loop Condition is held across admission prefill on purpose:
        # slot state must mutate atomically with the tensors it indexes.
        self._lock = make_condition("engine.continuous", allow_dispatch=True)
        self._queue: "deque[_SlotRequest]" = deque()
        # WFQ slot admission: loop-local per-tenant virtual time and its
        # floor, guarded by the loop lock.
        self._vtimes: Dict[str, float] = {}
        self._vfloor = 0.0
        self._active: List[Optional[_SlotRequest]] = [None] * self.width
        self._free: List[int] = list(range(self.width))
        self._closing = False
        self._stopped = False
        # Host mirrors of per-slot device state.
        self._cur = np.full((self.width,), engine.config.pad_token_id, np.int64)
        self._gen_lens = np.zeros((self.width,), np.int32)
        self._prompt_lens = np.ones((self.width,), np.int32)
        self._seeds = np.zeros((self.width,), np.uint32)
        self._sample_idx = np.zeros((self.width,), np.int32)
        self._temps = np.ones((self.width,), np.float32)
        self._top_ps = np.ones((self.width,), np.float32)
        self._active_mask = np.zeros((self.width,), bool)
        # Grammar-constrained rows: per-slot automaton state + flag mirrors
        # and the resident CompiledGrammar's device tables.
        self._g_states = np.zeros((self.width,), np.int64)
        self._g_flags = np.zeros((self.width,), bool)
        self._grammar: Optional[Any] = None
        self._dgrammar: Optional[Any] = None
        # Device KV state, built lazily on first admission. The worker thread
        # mutates these between steps; the disposable dispatch thread reads
        # them mid-step with no lock held — the epoch fence, not the loop
        # lock, keeps abandoned threads from clobbering a rebuilt loop.
        # kllms: unguarded — epoch-fenced handoff to the step dispatch thread
        self._prefix: Optional[KVCache] = None
        # kllms: unguarded — epoch-fenced handoff to the step dispatch thread
        self._gen: Optional[KVCache] = None
        self._built = False
        # PAGED slot state: the loop follows the engine's KV layout.
        self.paged = getattr(engine, "kv_layout", "dense") == "paged"
        self._pool = None
        self._tables: List[List[int]] = [[] for _ in range(self.width)]
        self._reserved: List[List[int]] = [[] for _ in range(self.width)]
        self._prefix_idx = np.zeros((self.width, self.max_prompt), np.int64)
        self._gen_idx = np.zeros((self.width, self.max_new), np.int64)
        self._paged_attn_impl = "xla"
        if self.paged:
            pool = getattr(engine, "_kv_pool", None)
            self._pool_pages_planned = (
                pool.allocator.total_pages
                if pool is not None
                else int(engine.kv_pool_pages or self._default_pool_pages())
            )
        else:
            self._pool_pages_planned = 0
        # Stats (reported via backend health()).
        self._stats: Dict[str, Any] = {
            "steps": 0,
            "row_steps": 0,
            "admitted": 0,
            "joined_in_flight": 0,
            "completed": 0,
            "aborted": 0,
            "max_active_rows": 0,
            "restarts": 0,
            "replayed_rows": 0,
            "quarantined_rows": 0,
            # Chunked prefill: total chunks run, and how many of them ran
            # with decode rows in flight (the interleaving the feature buys).
            "prefill_chunks": 0,
            "prefill_interleaved": 0,
        }
        self._thread: Optional[threading.Thread] = None

    def _default_pool_pages(self) -> int:
        """Pool sizing when neither the engine nor the backend pinned one:
        every slot decoding a DISTINCT max-shape prompt (the no-sharing worst
        case), plus one reserve page per slot for CoW, a couple of prompt-size
        runs of prefix-cache slack, and the trash page."""
        ps = self.engine.kv_page_size
        per_slot = pages_for(self.max_prompt + self.max_new, ps) + 1
        return self.width * per_slot + 2 * pages_for(self.max_prompt, ps) + 1

    def _on_card(self):
        """The engine's card as the calling thread's device (a no-op off a
        card): work lands there, on its default stream."""
        device = self.engine.device
        return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    @property
    def stats(self) -> Dict[str, Any]:
        """Loop counters — and, in paged mode, the page-pool snapshot behind a
        conservation check (:meth:`PageAllocator.check`): a failed check
        QUARANTINES the pool (flagged for the worker, which rebuilds the
        engine and replays the journal) and is reported as data."""
        with self._lock:
            out = dict(self._stats)
            out["width"] = self.width
            out["free_slots"] = len(self._free)
            active_rows = int(self._active_mask.sum())
            out["active_rows"] = active_rows
            out["occupancy"] = active_rows / self.width if self.width else 0.0
            out["queue_depth"] = len(self._queue)
            out["last_recovery_reason"] = self._last_recovery_reason
            if self.paged and self._pool is not None:
                if self._pool_fault is None:
                    fault = self._pool.allocator.check()
                    if fault is None:
                        held = sum(len(t) for t in self._tables) + sum(
                            len(r) for r in self._reserved
                        )
                        out["pages"] = {
                            **self._pool.allocator.snapshot(),
                            "loop_refs": held,
                        }
                    else:
                        self._quarantine_pool_locked(fault)
                if self._pool_fault is not None:
                    out["pages"] = {
                        "quarantined": True,
                        "error": self._pool_fault,
                    }
        return out

    def _quarantine_pool_locked(self, fault: str) -> None:
        """Flag a page-accounting fault for the worker (lock held)."""
        if self._pool_fault is not None:
            return
        self._pool_fault = fault
        RECOVERY_EVENTS.record("continuous.pool_quarantined")
        logger.error("continuous loop page pool quarantined: %s", fault)
        if not self._stopped:
            self._ensure_worker()
        self._lock.notify_all()

    # -- public API --------------------------------------------------------

    def qualifies(self, prompt_len: int, n: int, max_new: int) -> bool:
        """Can this request shape run in the shared loop at all?"""
        ok = (
            n <= self.width
            and prompt_len <= self.max_prompt
            and max_new <= self.max_new
        )
        if ok and self.paged:
            # Peak page demand for this request alone must fit the pool even
            # with the prefix cache fully evicted: one shared prompt run plus
            # n private generation reserves (minus the trash page).
            ps = self.engine.kv_page_size
            reserve = (prompt_len + max_new - 1) // ps - prompt_len // ps + 1
            need = pages_for(prompt_len, ps) + max(1, n) * reserve
            # Admission revalidates page supply under the loop lock before
            # placement, so a stale planned-pages read only skews this hint.
            # kllms: ignore[guarded-by] — lock-free capacity pre-check hint
            ok = need <= self._pool_pages_planned - 1
        return ok

    def submit(
        self,
        prompt_ids: List[int],
        *,
        n: int,
        max_new: int,
        temperature: float,
        top_p: Optional[float],
        seed: int,
        budget: Optional[RequestBudget] = None,
        token_sink: Optional[Callable[[int, np.ndarray], None]] = None,
        grammar: Optional[Any] = None,
        tenant: Optional[Any] = None,
    ) -> Future:
        """Queue one request for slot admission; returns a Future resolving to
        a :class:`GenerationResult` (or raising the typed lifecycle error).
        ``tenant`` is an already-resolved TenantContext; ``grammar`` an
        optional CompiledGrammar (a different schema than the resident one
        while constrained work is queued or in flight raises ValueError, and
        the backend coalesces the request instead)."""
        if self._admission_gate is not None:
            err = self._admission_gate()
            if err is not None:
                raise err
        with self._lock:
            if self._terminal_error is not None:
                raise self._terminal_error
            if self._closing or self._stopped:
                raise ServerDrainingError(
                    "continuous decode loop is draining; retry against "
                    "another replica"
                )
        if budget is not None:
            budget.check("continuous admission")
        try:
            _failpoints.fire("engine.launch")
        except Exception as e:
            if is_resource_exhausted(e):
                # Fixed-width loop: there is nothing to split, so device OOM
                # at admission is a typed unavailability, not a requeue.
                raise BackendUnavailableError(
                    f"continuous decode loop cannot admit request: {e}"
                ) from e
            raise
        ids, prompt_len, _bkt = self.engine._prep_prompt(prompt_ids)
        if not self.qualifies(prompt_len, n, max_new):
            raise ValueError(
                f"request (prompt_len={prompt_len}, n={n}, max_new={max_new}) "
                f"exceeds loop bounds (W={self.width}, P={self.max_prompt}, "
                f"G={self.max_new})"
            )
        with self._lock:
            if grammar is not None and self._grammar_busy_locked(grammar):
                raise ValueError(
                    "continuous loop is decoding under a different grammar; "
                    "take the per-constraint coalescing path"
                )
            req = _SlotRequest(
                future=Future(),
                prompt_len=prompt_len,
                n=max(1, n),
                max_new=max_new,
                budget=budget,
                token_sink=token_sink,
                ids=list(ids),
                seed=int(seed),
                temperature=float(temperature),
                top_p=1.0 if top_p is None else float(top_p),
                seq=self._seq,
                grammar=grammar,
                trace=current_trace(),
                enqueued_at=time.monotonic(),
                tenant=tenant,
            )
            self._seq += 1
            self._queue.append(req)
            self._ensure_worker()
            self._lock.notify_all()
        return req.future

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, finish queued + in-flight rows. True on quiesce."""
        deadline = time.monotonic() + timeout
        with self._lock:
            self._closing = True
            self._lock.notify_all()
            while (
                self._queue
                or self._prefilling is not None
                or any(r is not None for r in self._active)
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(timeout=min(0.1, remaining))
        return True

    def stop(self) -> None:
        """Hard stop: fail queued work, kill the worker."""
        with self._lock:
            self._closing = True
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            if self._prefilling is not None:
                pending.append(self._prefilling.req)
                self._prefilling = None
            self._lock.notify_all()
        self._dispatcher.close()
        for req in pending:
            if not req.future.done():
                req.future.set_exception(
                    BackendUnavailableError("continuous decode loop stopped")
                )

    # -- device state and the step's math -----------------------------------

    def _build_device_state(self) -> None:
        engine = self.engine
        config = engine.config
        W, P, G = self.width, self.max_prompt, self.max_new
        if self.paged:
            # One flat KV pool instead of dense per-slot caches; the engine
            # owns it, sized once, so prefix-cache page runs and loop rows
            # share pages.
            from ..ops.paged_attention import launch_paged_attention_impl

            self._pool = engine._ensure_kv_pool(min_pages=self._pool_pages_planned)
            self._pool_pages_planned = self._pool.allocator.total_pages
            # Resolved once per loop build (failpoint-aware, counted): never
            # per step.
            self._paged_attn_impl = launch_paged_attention_impl(
                engine.paged_attention_impl, device=engine.device
            )
        else:
            self._prefix = init_cache(config, W, P, engine.device)
            self._gen = init_cache(config, W, G, engine.device)
        self._built = True

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """pad stays unsampleable on live rows unless the tokenizer maps pad
        onto eos (then it IS the stop token), as in the batch decode loop."""
        pad_id = self.engine.config.pad_token_id
        if pad_id not in self.eos_ids:
            logits[:, pad_id] = -float("inf")
        return logits

    def _sample(self, logits, seeds, steps, sample_idx, temps, top_ps):
        """Per-row keys ``fold_in(fold_in(key(seed), step), sample_idx)``,
        their uniforms (one draw launch) and the per-row sampler."""
        keys = torch.stack([torch.zeros_like(seeds), seeds], dim=1)
        uniforms = threefry_uniform_rows(keys, steps, sample_idx, logits.shape[-1])
        return _sample_rows(logits, uniforms, temps, top_ps)

    def _grammar_busy_locked(self, grammar: Any) -> bool:
        """Is constrained work under a *different* schema queued or active?
        (Same digest shares the resident tables.) Lock held by the caller."""
        for r in self._active:
            if r is not None and r.grammar is not None \
                    and r.grammar.digest != grammar.digest:
                return True
        pf = self._prefilling
        if pf is not None and pf.req.grammar is not None \
                and pf.req.grammar.digest != grammar.digest:
            return True
        return any(
            r.grammar is not None and r.grammar.digest != grammar.digest
            for r in self._queue
        )

    def _install_grammar(self, grammar: Any) -> None:
        """Make ``grammar`` the resident constraint: upload its tables with
        the state axis padded to a power of two."""
        if self._grammar is not None and self._grammar.digest == grammar.digest:
            return
        from .grammar import device_grammar

        self._grammar = grammar
        self._dgrammar = device_grammar(grammar, pad_states=64, device=self.engine.device)

    def _grammar_mask(self, dg, logits, g_states, g_flags, eos_arr):
        from .grammar import grammar_mask_logits

        masked = grammar_mask_logits(dg, logits, g_states, eos_arr)
        return torch.where(g_flags[:, None], masked, logits)

    @staticmethod
    def _grammar_advance(dg, tok, g_states, g_flags):
        from .grammar import grammar_advance

        return torch.where(g_flags, grammar_advance(dg, tok, g_states), g_states)

    # -- worker ------------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="kllms-continuous", daemon=True
            )
            self._thread.start()

    def _worker(self) -> None:
        """Crash-contained worker: every fault class maps to a recovery
        domain. A hung step (watchdog) or a quarantined page pool tears the
        engine down and replays the journal; any OTHER exception fails every
        queued and in-flight future with a typed error, restarts the loop,
        and leaves the engine alone. All domains share the ``max_rebuilds``
        bound before the loop goes terminal."""
        while True:
            try:
                self._worker_loop()
                return
            except _AdoptEngine as swap:
                if not self._recover("adopt_engine", new_engine=swap.engine):
                    return
            except _StepHung:
                if not self._recover("hung_step"):
                    return
            except (_PoolFault, PageAccountingError):
                if not self._recover("page_accounting"):
                    return
            except Exception:
                logger.exception("continuous decode worker crashed")
                RECOVERY_EVENTS.record("continuous.worker_crashes")
                if not self._recover("worker_crash"):
                    return

    def _worker_loop(self) -> None:
        while True:
            # Crash-injection point for the worker itself: OUTSIDE the
            # step-level fault domains.
            _failpoints.fire("continuous.worker")
            with self._lock:
                if self._stopped:
                    return
                if self._adopted_engine is not None:
                    eng, self._adopted_engine = self._adopted_engine, None
                    raise _AdoptEngine(eng)
                if self._pool_fault is not None:
                    raise _PoolFault(self._pool_fault)
                with self._on_card():
                    self._admit_locked()
                has_decode = bool(self._active_mask.any())
                prefilling = self._prefilling is not None
                if not has_decode and not prefilling:
                    if self._closing and not self._queue:
                        self._lock.notify_all()
                        return
                    self._lock.wait(timeout=0.05)
                    self._shed_expired_locked()
                    continue
            # The interleave: one decode step for the active batch, then one
            # prompt chunk for the (at most one) PREFILLING admission.
            if has_decode:
                self._step_once()
            if prefilling:
                self._prefill_chunk_once()

    # -- recovery ----------------------------------------------------------

    def _recover(self, reason: str, new_engine: Any = None) -> bool:
        """Heal the loop after a fault; True when the worker should keep
        running. ``hung_step`` / ``page_accounting``: journal the in-flight
        rows, rebuild the engine via ``rebuild_fn``, re-queue the survivors
        for replay. ``worker_crash``: fail everything typed and restart the
        loop empty. ``adopt_engine``: an external supervisor already rebuilt
        the engine; journal + swap + replay without spending a fault
        credit."""
        counts = reason != "adopt_engine"
        with self._lock:
            self._loop_epoch += 1
            self._last_recovery_reason = reason
            self._stats["restarts"] += 1
            if counts:
                self._consecutive_faults += 1
            attempt = self._consecutive_faults
        RECOVERY_EVENTS.record("continuous.restarts")
        if counts and attempt > self.max_rebuilds:
            return self._terminal(EngineHungError(
                f"continuous decode loop did not recover after "
                f"{self.max_rebuilds} restart attempt(s); last fault: {reason}"
            ))
        if counts and self.on_recovering is not None:
            self.on_recovering(attempt, f"continuous_{reason}")
        if reason == "worker_crash":
            self._fail_all(BackendUnavailableError(
                "continuous decode worker crashed; in-flight requests were "
                "failed and the loop restarted"
            ))
        else:
            if new_engine is None and self.rebuild_fn is None:
                return self._terminal(EngineHungError(
                    f"continuous decode loop fault '{reason}' is "
                    "unrecoverable without an engine rebuild path"
                ))
            with self._lock:
                survivors = self._journal_survivors_locked()
                self._reset_device_state_locked()
            if new_engine is not None:
                self.engine = new_engine
            else:
                try:
                    eng = self.rebuild_fn()
                except BaseException as exc:
                    RECOVERY_EVENTS.record("supervisor.rebuild_failures")
                    err = exc if isinstance(exc, CheckpointCorruptError) else (
                        EngineHungError(
                            f"continuous loop engine rebuild failed: {exc!r}"
                        )
                    )
                    for req in survivors:
                        if not req.future.done():
                            req.future.set_exception(err)
                    return self._terminal(err)
                if eng is not None:
                    self.engine = eng
            if survivors:
                with self._lock:
                    self._queue.extendleft(reversed(survivors))
                    self._lock.notify_all()
        if counts and self.on_rebuilt is not None:
            self.on_rebuilt()
        return True

    def _terminal(self, err: BaseException) -> bool:
        """The loop is beyond self-healing: pin the terminal error (submit
        re-raises it), fail every remaining future, and stop for good."""
        logger.error("continuous decode loop is terminal: %s", err)
        with self._lock:
            self._terminal_error = err
            self._closing = True
            self._stopped = True
        self._fail_all(err)
        if self.on_rebuild_failed is not None:
            self.on_rebuild_failed(err)
        return False

    def _journal_survivors_locked(self) -> List[_SlotRequest]:
        """Snapshot the in-flight requests for replay (lock held): reset
        their accumulators and advance the sink watermark so re-admission
        regenerates from step 0 while already-delivered steps are
        suppressed. A half-prefilled admission survives too: replay
        re-prefills it from cursor 0."""
        seen: Dict[int, _SlotRequest] = {}
        for r in self._active:
            if r is not None and id(r) not in seen and not r.future.done():
                seen[id(r)] = r
        pf = self._prefilling
        if pf is not None and id(pf.req) not in seen and not pf.req.future.done():
            seen[id(pf.req)] = pf.req
        survivors = sorted(seen.values(), key=lambda r: r.seq)
        for req in survivors:
            req.delivered_watermark = max(
                req.delivered_watermark, req.steps_delivered
            )
            req.steps_delivered = 0
            req.replays += 1
            req.slots = []
            req.tokens = []
            req.logprobs = []
            req.done = []
            req.finish = []
            req.sample_errors = []
            req.chunk_cursor = 0
        return survivors

    def _reset_device_state_locked(self) -> None:
        """Forget every device handle and slot mirror (lock held). The next
        build allocates new dense caches, so a stale dispatch thread writes
        only into tensors nobody reads. Old pool page references are dropped
        WITHOUT decref: the pool dies with the torn-down engine."""
        pad = self.engine.config.pad_token_id
        self._active = [None] * self.width
        self._free = list(range(self.width))
        self._active_mask[:] = False
        self._cur[:] = pad
        self._gen_lens[:] = 0
        self._prompt_lens[:] = 1
        self._seeds[:] = 0
        self._sample_idx[:] = 0
        self._temps[:] = 1.0
        self._top_ps[:] = 1.0
        self._g_states[:] = 0
        self._g_flags[:] = False
        self._grammar = None
        self._dgrammar = None
        self._prefix = None
        self._gen = None
        self._pool = None
        self._tables = [[] for _ in range(self.width)]
        self._reserved = [[] for _ in range(self.width)]
        self._prefix_idx[:] = 0
        self._gen_idx[:] = 0
        self._pool_fault = None
        self._prefilling = None
        self._built = False

    def adopt_engine(self, new_engine: Any) -> None:
        """Swap in an externally rebuilt engine (the supervisor's coalesced
        rebuild path). With work in flight the worker journals, swaps, and
        replays on its own thread; an idle loop swaps inline."""
        with self._lock:
            has_work = (
                bool(self._queue)
                or self._prefilling is not None
                or any(r is not None for r in self._active)
            )
            if not has_work:
                self._loop_epoch += 1
                self.engine = new_engine
                self._reset_device_state_locked()
                return
            self._adopted_engine = new_engine
            if not self._stopped:
                self._ensure_worker()
            self._lock.notify_all()

    def _shed_expired_locked(self) -> None:
        kept: "deque[_SlotRequest]" = deque()
        for req in self._queue:
            if req.budget is not None and req.budget.should_abort():
                FAILURE_EVENTS.record("scheduler.shed")
                req.future.set_exception(req.budget.error("continuous queue"))
            else:
                kept.append(req)
        self._queue = kept

    def _select_locked(self) -> Optional[int]:
        """WFQ selection over the queued requests: index of the EARLIEST
        request of the tenant with the smallest (slo_class, vtime) key."""
        best_idx: Optional[int] = None
        best_key = None
        seen: set = set()
        for idx, req in enumerate(self._queue):
            name = _req_tenant_name(req)
            if name in seen:
                continue
            seen.add(name)
            key = (
                0 if _req_interactive(req) else 1,
                self._vtimes.get(name, 0.0),
                idx,
            )
            if best_key is None or key < best_key:
                best_idx, best_key = idx, key
        return best_idx

    def _admit_locked(self) -> None:
        """WFQ head-of-line admission: the selected tenant's earliest request
        joins when all n of its slots are free (no skipping past it). Called
        with the lock held; does the admitted request's prefill."""
        while self._queue:
            idx = self._select_locked()
            if idx is None or len(self._free) < self._queue[idx].n:
                break
            req = self._queue[idx]
            chunked = self._chunk_eligible(req)
            if chunked and self._prefilling is not None:
                # One chunked admission at a time: the head waits.
                break
            del self._queue[idx]
            if req.budget is not None and req.budget.should_abort():
                FAILURE_EVENTS.record("scheduler.shed")
                req.future.set_exception(req.budget.error("continuous queue"))
                continue
            if req.enqueued_at and not req.replays:
                wait_s = max(0.0, time.monotonic() - req.enqueued_at)
                LATENCY.observe("scheduler.queue_wait", wait_s)
                if req.tenant is not None:
                    LATENCY.observe(
                        f"scheduler.queue_wait.{_req_tenant_name(req)}", wait_s
                    )
                if req.trace is not None:
                    req.trace.add_phase("queue_wait", wait_s)
            if not self._built:
                self._build_device_state()
            in_flight = self._active_mask.any()
            rows = [self._free.pop(0) for _ in range(req.n)]
            req.slots = rows
            try:
                _admit_t0 = time.perf_counter()
                if chunked:
                    self._begin_prefilling_locked(req, rows)
                else:
                    self._admit_device(req, rows)
                    if req.trace is not None:
                        req.trace.add_phase(
                            "prefill", time.perf_counter() - _admit_t0
                        )
            except PagePoolExhausted as e:
                # Pages are a transient resource: in-flight rows free theirs
                # as they retire, so park the head request and retry after the
                # next step; with nothing in flight, fail it.
                for r in rows:
                    self._free.append(r)
                req.slots = []
                if in_flight:
                    self._queue.appendleft(req)
                    break
                req.future.set_exception(BackendUnavailableError(
                    f"paged KV pool cannot fit request: {e}"
                ))
                continue
            except Exception as e:
                for r in rows:
                    self._free.append(r)
                req.future.set_exception(e)
                continue
            if req.replays:
                self._stats["replayed_rows"] += req.n
                RECOVERY_EVENTS.record("continuous.replayed_rows", req.n)
                if req.trace is not None:
                    # The same trace survives the rebuild, annotated rather
                    # than duplicated.
                    req.trace.annotate("replayed")
                    req.trace.bump("replayed_rows", req.n)
            else:
                self._stats["admitted"] += 1
                if in_flight:
                    self._stats["joined_in_flight"] += 1
                # WFQ pass charge from the floor (an idle tenant re-enters at
                # the current floor, not at zero).
                name = _req_tenant_name(req)
                start = max(self._vtimes.get(name, 0.0), self._vfloor)
                self._vfloor = start
                self._vtimes[name] = start + req.n / _req_tenant_weight(req)

    @torch.inference_mode()
    def _admit_device(self, req, rows) -> None:
        engine = self.engine
        _ids, _plen, bucket = engine._prep_prompt(req.ids)
        if self.paged:
            first_logits = self._admit_paged_kv(req, rows, _ids, _plen, bucket)
        else:
            first_logits, prefix = engine._prefill_routed(_ids, _plen, bucket)
            self._write_prefix_rows(rows, prefix)
        self._admit_rows(req, rows, first_logits)

    def _write_prefix_rows(self, rows: List[int], prefix: KVCache) -> None:
        """Replicate one request's prefill KV [L, 1, bucket, KVH, D] into its
        n slots of the dense per-slot prefix. Positions past the bucket keep
        an earlier occupant's values; the prompt-length mask hides them."""
        rows_t = torch.as_tensor(rows, dtype=torch.int64, device=self.engine.device)
        width = min(prefix.k.shape[2], self.max_prompt)
        self._prefix.k[:, rows_t, :width] = prefix.k[:, :, :width]
        self._prefix.v[:, rows_t, :width] = prefix.v[:, :, :width]

    @torch.inference_mode()
    def _admit_rows(self, req, rows, first_logits) -> None:
        """The layout-independent admission tail, shared by whole-prompt
        admission and the chunked-prefill finish: sample each row's first
        token from the prefill logits with the submission-pinned seed at
        step 0, install the slot mirrors, and run first-step
        retirement/delivery."""
        prompt_len = req.prompt_len
        seed, temperature, top_p = req.seed, req.temperature, req.top_p
        n = len(rows)
        device = self.engine.device
        V = first_logits.shape[-1]
        fl = self._mask_pad(first_logits[0:1].expand(n, V).clone())
        seeds = torch.full((n,), seed & 0xFFFFFFFF, dtype=torch.int64, device=device)
        sidx = torch.arange(n, dtype=torch.int32, device=device)
        steps = torch.zeros((n,), dtype=torch.int32, device=device)
        temps = torch.full((n,), temperature, dtype=torch.float32, device=device)
        tps = torch.full((n,), top_p, dtype=torch.float32, device=device)
        if req.grammar is not None:
            # Constrained admission: mask the first sample from the start
            # state and advance each row's automaton on device; the states
            # ride the same readback as tok0/lp0.
            self._install_grammar(req.grammar)
            dg = self._dgrammar
            g_states = torch.full((n,), dg.start, dtype=torch.int64, device=device)
            g_flags = torch.ones((n,), dtype=torch.bool, device=device)
            eos_arr = torch.as_tensor(self.eos_ids, dtype=torch.int64, device=device)
            fl = self._grammar_mask(dg, fl, g_states, g_flags, eos_arr)
            tok, lp, bad = self._sample(fl, seeds, steps, sidx, temps, tps)
            st = self._grammar_advance(dg, tok, g_states, g_flags)
            tok0, lp0, bad0, st0 = (t.cpu().numpy() for t in (tok, lp, bad, st))
            GRAMMAR_EVENTS.record("grammar.masked_steps", n)
        else:
            tok, lp, bad = self._sample(fl, seeds, steps, sidx, temps, tps)
            tok0, lp0, bad0 = (t.cpu().numpy() for t in (tok, lp, bad))
            st0 = np.zeros((n,), np.int64)

        quarantined = 0
        for j, slot in enumerate(rows):
            self._active[slot] = req
            self._active_mask[slot] = True
            self._cur[slot] = tok0[j]
            self._gen_lens[slot] = 0  # KV written so far; tok0's comes next step
            self._prompt_lens[slot] = prompt_len
            self._seeds[slot] = np.uint32(seed & 0xFFFFFFFF)
            self._sample_idx[slot] = j
            self._temps[slot] = temperature
            self._top_ps[slot] = top_p
            self._g_flags[slot] = req.grammar is not None
            self._g_states[slot] = st0[j]
            req.tokens.append([int(tok0[j])])
            req.logprobs.append([float(lp0[j])])
            req.sample_errors.append(None)
            if bad0[j]:
                # Poisoned prefill logits: freeze the row before it ever
                # decodes; siblings proceed and consensus drops this member.
                self._quarantine_row(req, j)
                quarantined += 1
                continue
            done0 = int(tok0[j]) in self.eos_ids
            req.done.append(done0 or req.max_new <= 1)
            req.finish.append("stop" if done0 else "length")
        if quarantined:
            note = getattr(self.engine, "_note_quarantine", None)
            if note is not None:
                note(quarantined, n)
        self._deliver_sink(req)
        self._retire_finished_rows(req)
        self._resolve_if_done(req)

    def _quarantine_row(self, req: _SlotRequest, j: int) -> None:
        """Freeze sample ``j``: typed ``numeric_poison`` member error, row
        done (the caller retires it and frees the slot)."""
        if len(req.done) <= j:
            req.done.append(True)
        else:
            req.done[j] = True
        if len(req.finish) <= j:
            req.finish.append("stop")
        else:
            req.finish[j] = "stop"
        req.sample_errors[j] = _quarantine_error()
        self._stats["quarantined_rows"] += 1
        if req.trace is not None:
            req.trace.bump("quarantined_rows")

    # -- chunked prefill -----------------------------------------------------

    def _chunk_eligible(self, req: _SlotRequest) -> bool:
        """Should this admission take the PREFILLING path? Only prompts
        longer than one chunk, and only when the prefix cache cannot supply
        the prompt anyway."""
        C = self.prefill_chunk_tokens
        if C <= 0 or req.prompt_len <= C:
            return False
        probe = getattr(self.engine, "prefix_cached_len", None)
        return probe is None or probe(req.ids) == 0

    def _begin_prefilling_locked(self, req: _SlotRequest, rows: List[int]) -> None:
        """Enter the PREFILLING state: allocate the prompt's page run and
        every row's generation reserve UP FRONT, build the 1-row staging KV
        the chunks extend, and hand the request to the worker's chunk phase.
        Raises :class:`PagePoolExhausted` with everything rolled back."""
        engine = self.engine
        _ids, _plen, bucket = engine._prep_prompt(req.ids)
        run_pages: Optional[List[int]] = None
        reserved: List[List[int]] = []
        if self.paged:
            alloc = self._pool.allocator
            ps = self._pool.page_size
            reserve = (_plen + req.max_new - 1) // ps - _plen // ps + 1
            with engine._launch_lock:
                run_pages = engine._alloc_pages_with_evict(pages_for(_plen, ps))
                extra_refs = 0
                try:
                    # One prompt-run reference per row (the n-way fan-out
                    # shares one copy).
                    for _ in range(len(rows) - 1):
                        alloc.incref(run_pages)
                        extra_refs += 1
                    for _ in rows:
                        reserved.append(engine._alloc_pages_with_evict(reserve))
                except BaseException:
                    for lst in reserved:
                        alloc.decref(lst)
                    for _ in range(extra_refs + 1):
                        alloc.decref(run_pages)
                    raise
        cache = init_cache(engine.config, 1, bucket, engine.device)
        req.chunk_cursor = 0
        self._prefilling = _Prefilling(
            req, list(rows), list(_ids), cache, _plen, bucket,
            run_pages, reserved,
        )

    def _prefill_chunk_once(self) -> None:
        """Run ONE prompt chunk for the PREFILLING admission, under the same
        watchdog/epoch-fence discipline as a decode step. The final chunk's
        logits feed the shared first-token admission tail."""
        with self._lock:
            pf = self._prefilling
            if pf is None:
                return
            req = pf.req
            if req.budget is not None and req.budget.should_abort():
                self._retire_prefilling_locked(
                    req.budget.error("engine prefill"), abort=True
                )
                return
            epoch = self._loop_epoch
            C = self.prefill_chunk_tokens
            start = pf.cursor
            end = min(start + C, pf.plen)
            valid = end - start
            final = end >= pf.plen
            pad_id = self.engine.config.pad_token_id
            chunk = np.full((1, C), pad_id, np.int64)
            chunk[0, :valid] = pf.ids[start:end]
            cache = pf.cache
            engine = self.engine
            pool = slot_idx = None
            if self.paged:
                pool = self._pool
                ps = pool.page_size
                # The chunk's KV columns land in the row's reserved page run
                # at its current offset; pad positions retarget to trash.
                slot_idx = flat_slots(pf.run_pages, start + np.arange(C), ps)
                trash = (np.arange(C) % ps + TRASH_PAGE * ps).astype(np.int32)
                slot_idx[valid:] = trash[valid:]

        @torch.inference_mode()
        def _dispatch():
            # Hang-injection point for the chunk itself (``continuous.prefill``).
            _failpoints.fire("continuous.prefill")
            if self._loop_epoch != epoch:
                raise _StaleStep("prefill chunk fenced before dispatch")
            note_device_dispatch("continuous prefill chunk")
            with self._on_card():
                tokens = torch.as_tensor(chunk, device=engine.device)
                if self.paged:
                    logits, new_cache, k_cols, v_cols = prefill_chunk_step_paged(
                        engine.config, engine.params, tokens, cache, start, valid
                    )
                    if self._loop_epoch != epoch:
                        raise _StaleStep("prefill chunk fenced post-dispatch")
                    pool.scatter_tokens(k_cols, v_cols, slot_idx)
                else:
                    logits, new_cache = prefill_chunk_step(
                        engine.config, engine.params, tokens, cache, start, valid
                    )
                    if self._loop_epoch != epoch:
                        raise _StaleStep("prefill chunk fenced post-dispatch")
                # Synchronize on the (tiny) logits readback so the watchdog
                # budget covers the device work, like the step's readback.
                # kllms: ignore[host-sync-hot-path] — the per-chunk completion sync; the cache stays on device
                logits.cpu()
            return logits, new_cache

        _chunk_t0 = time.perf_counter()
        if self.budget_model is not None:
            try:
                first_logits, new_cache = self._dispatcher.run(
                    _dispatch, self.budget_model.step_budget()
                )
            except _StepHung:
                with self._lock:
                    self._loop_epoch += 1
                RECOVERY_EVENTS.record("continuous.step_hangs")
                logger.error(
                    "continuous prefill chunk overran its watchdog budget; "
                    "abandoning the dispatch thread and rebuilding"
                )
                raise
            # Not fed to observe_step: a C-token chunk would pollute the
            # decode loop's per-step EWMA.
        else:
            first_logits, new_cache = _dispatch()
        chunk_s = time.perf_counter() - _chunk_t0
        LATENCY.observe("continuous.prefill_chunk", chunk_s)
        with self._lock:
            if self._loop_epoch != epoch or self._prefilling is not pf:
                return
            pf.cache = new_cache
            pf.cursor = end
            req.chunk_cursor = end
            self._stats["prefill_chunks"] += 1
            if self._active_mask.any():
                self._stats["prefill_interleaved"] += 1
            # A completed chunk is proof of life, like a completed step.
            self._consecutive_faults = 0
            if req.trace is not None:
                req.trace.add_phase("prefill", chunk_s)
            if final:
                self._prefilling = None
                with self._on_card():
                    self._finish_prefilling_locked(pf, first_logits)
                self._lock.notify_all()

    def _finish_prefilling_locked(self, pf: _Prefilling, first_logits) -> None:
        """Transition PREFILLING -> DECODING (lock held): install the fully
        ingested prompt KV as the rows' prefix (block tables in paged mode,
        the dense per-slot prefix otherwise), populate the prefix cache, then
        run the shared admission tail."""
        engine = self.engine
        req, rows = pf.req, pf.rows
        if self.paged:
            for j, slot in enumerate(rows):
                self._tables[slot] = list(pf.run_pages)
                self._reserved[slot] = pf.reserved[j]
                self._refresh_row_idx(slot, pf.plen)
            if getattr(engine, "prefix_cache_size", 0) > 0:
                from .paging import PagedPrefixRun

                # One extra reference transfers to the cache entry; the
                # run is already scattered, so the store is pure accounting.
                self._pool.allocator.incref(pf.run_pages)
                engine._prefix_store_paged_run(
                    pf.ids, first_logits,
                    PagedPrefixRun(self._pool, list(pf.run_pages),
                                   pf.plen, pf.bucket),
                )
        else:
            self._write_prefix_rows(rows, pf.cache)
            if getattr(engine, "prefix_cache_size", 0) > 0:
                engine._prefix_store(pf.ids, first_logits, pf.cache)
        self._admit_rows(req, rows, first_logits)

    def _retire_prefilling_locked(
        self, exc: BaseException, abort: bool = False
    ) -> None:
        """Retire the PREFILLING admission before it ever decoded (lock
        held): return its slots, release its pages, and fail the future."""
        pf = self._prefilling
        if pf is None:
            return
        self._prefilling = None
        req = pf.req
        if self.paged and self._pool is not None and pf.run_pages is not None:
            alloc = self._pool.allocator
            try:
                for _ in pf.rows:
                    alloc.decref(pf.run_pages)
                for lst in pf.reserved:
                    alloc.decref(lst)
            except PageAccountingError:
                logger.exception(
                    "page release failed retiring a PREFILLING admission"
                )
        for slot in pf.rows:
            self._free.append(slot)
        req.slots = []
        if abort:
            FAILURE_EVENTS.record("engine.decode_abort")
            self._stats["aborted"] += 1
        if not req.future.done():
            req.future.set_exception(exc)
        self._lock.notify_all()

    # -- paged slot management --------------------------------------------

    def _admit_paged_kv(self, req, rows, _ids, _plen, bucket):
        """Install one request's prompt KV as shared, refcounted pool pages:
        the prefill's page run is incref'd once per row, and each row
        pre-reserves its private generation pages. Raises
        :class:`PagePoolExhausted` with everything rolled back."""
        engine = self.engine
        alloc = self._pool.allocator
        ps = self._pool.page_size
        first_logits, run, transient = engine.paged_admit_prefix(
            _ids, _plen, bucket
        )
        # Pages the row's writes can touch: the prompt's partial page (CoW
        # target) when plen % ps != 0, fresh otherwise — the +1 covers both.
        reserve = (_plen + req.max_new - 1) // ps - _plen // ps + 1
        new_reserved: List[List[int]] = []
        try:
            with engine._launch_lock:
                for _ in rows:
                    alloc.incref(run.pages)
                try:
                    for _ in rows:
                        new_reserved.append(
                            engine._alloc_pages_with_evict(reserve)
                        )
                except BaseException:
                    for lst in new_reserved:
                        alloc.decref(lst)
                    for _ in rows:
                        alloc.decref(run.pages)
                    raise
        finally:
            if transient:
                # Uncached prefill: the rows' increfs now keep the pages.
                run.release()
        for j, slot in enumerate(rows):
            self._tables[slot] = list(run.pages)
            self._reserved[slot] = new_reserved[j]
            self._refresh_row_idx(slot, _plen)
        return first_logits

    def _refresh_row_idx(self, slot: int, plen: Optional[int] = None) -> None:
        """Rebuild one slot's flat gather indices from its block table. Must
        run after ANY table change (admit, extension, CoW, release)."""
        ps = self._pool.page_size
        table = self._tables[slot]
        P, G = self.max_prompt, self.max_new
        if plen is None:
            plen = int(self._prompt_lens[slot])
        pidx = flat_slots(table, np.arange(P), ps)
        # Positions at/after the prompt end read through gen_idx instead;
        # point them into the trash page (masked, but must stay in bounds).
        pidx[plen:] = (np.arange(P - plen) % ps).astype(np.int32)
        self._prefix_idx[slot] = pidx
        self._gen_idx[slot] = flat_slots(table, plen + np.arange(G), ps)

    def _prepare_step_pages(self) -> np.ndarray:
        """Resolve each row's write slot for the upcoming step: append a
        reserved page when the write crosses a page boundary, copy-on-write
        when the target page is still shared. Returns the [W] flat write
        indices (inactive rows write into the trash page). Lock held; never
        allocates — admission reserved every page this can pop."""
        pool = self._pool
        ps = pool.page_size
        alloc = pool.allocator
        W = self.width
        write_idx = np.empty((W,), np.int64)
        cow_src: List[int] = []
        cow_dst: List[int] = []
        for slot in range(W):
            if not self._active_mask[slot]:
                write_idx[slot] = TRASH_PAGE * ps + slot % ps
                continue
            pos = int(self._prompt_lens[slot]) + int(self._gen_lens[slot])
            page_i = pos // ps
            table = self._tables[slot]
            if page_i == len(table):
                table.append(self._reserved[slot].pop())
                self._refresh_row_idx(slot)
            elif alloc.refcount(table[page_i]) > 1:
                # First divergent write into the shared partial prompt page:
                # give this row a private copy, then retarget its table.
                new_page = self._reserved[slot].pop()
                cow_src.append(table[page_i])
                cow_dst.append(new_page)
                table[page_i] = new_page
                alloc.note_cow()
                self._refresh_row_idx(slot)
            write_idx[slot] = table[page_i] * ps + pos % ps
        if cow_src:
            pool.copy_pages(cow_src, cow_dst)
            # Our reference on each source page must outlive the copy that
            # reads it — decref only after the copy is enqueued.
            alloc.decref(cow_src)
        return write_idx

    def _release_slot_pages(self, slot: int) -> None:
        """Drop a retired slot's page references (shared prompt pages survive
        while the prefix cache or sibling rows still hold them)."""
        if not self.paged or self._pool is None:
            return
        spec = _failpoints.fire("engine.pages")
        if spec is not None and spec.action == "leak":
            self._pool.allocator.leak(max(1, int(spec.kill)))
        alloc = self._pool.allocator
        table, self._tables[slot] = self._tables[slot], []
        reserved, self._reserved[slot] = self._reserved[slot], []
        if table:
            alloc.decref(table)
        if reserved:
            alloc.decref(reserved)
        self._refresh_row_idx(slot, 0)

    def _step_once(self) -> None:
        with self._lock:
            epoch = self._loop_epoch
            engine = self.engine
            device = engine.device
            live_rows = np.flatnonzero(self._active_mask)
            # Host mirrors snapshotted under the lock; the dispatch thread
            # uploads them.
            host = {
                "cur": self._cur.copy(),
                "gen_lens": self._gen_lens.copy(),
                "prompt_lens": self._prompt_lens.copy(),
                "active": self._active_mask.copy(),
                "seeds": self._seeds.astype(np.int64),
                "sidx": self._sample_idx.copy(),
                "temps": self._temps.copy(),
                "tps": self._top_ps.copy(),
            }
            # The grammar mask runs only when a constrained row is live.
            # kllms: ignore[host-sync-hot-path] — _g_flags and _active_mask are numpy host mirrors (already host memory); pure host bookkeeping, not a device readback
            n_masked = int((self._g_flags & self._active_mask).sum())
            dg = None
            if n_masked:
                dg = self._dgrammar
                host["g_states"] = self._g_states.copy()
                host["g_flags"] = self._g_flags.copy()
            prefix, gen, pool = self._prefix, self._gen, self._pool
            if self.paged:
                with self._on_card():
                    host["write_idx"] = self._prepare_step_pages()
                host["pidx"] = self._prefix_idx.copy()
                host["gidx"] = self._gen_idx.copy()
        # None in production; with an active ``engine.logits`` nan failpoint,
        # a seeded subset of the LIVE rows is poisoned.
        # kllms: ignore[host-sync-hot-path] — live_rows is np.flatnonzero output (already host memory); this tolist is pure host bookkeeping, not a device readback
        poison = engine._poison0_array(self.width, live_rows=live_rows.tolist())
        pad_id = engine.config.pad_token_id
        attn_impl = self._paged_attn_impl

        @torch.inference_mode()
        def _dispatch():
            # Hang-injection point for the step itself (``continuous.step``).
            _failpoints.fire("continuous.step")
            if self._loop_epoch != epoch:
                raise _StaleStep("continuous step fenced before dispatch")
            with self._on_card():
                t = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
                gen_lens = t["gen_lens"]
                if self.paged:
                    with pool.lock:
                        note_device_dispatch("continuous paged step")
                        logits, k_cols, v_cols = paged_verify_step(
                            engine.config, engine.params, t["cur"][:, None], gen_lens,
                            t["prompt_lens"], pool.k, pool.v, t["pidx"], t["gidx"],
                            attn_impl=attn_impl, page_size=pool.page_size,
                        )
                        if self._loop_epoch != epoch:
                            raise _StaleStep("continuous step fenced post-dispatch")
                        pool.k[:, t["write_idx"]] = k_cols
                        pool.v[:, t["write_idx"]] = v_cols
                else:
                    note_device_dispatch("continuous dense step")
                    logits, _ = verify_step(
                        engine.config, engine.params, t["cur"][:, None], gen_lens,
                        t["prompt_lens"], gen, prefix,
                    )
                logits = logits[:, 0]
                eos_arr = None
                if dg is None:
                    logits = self._mask_pad(logits)
                    if poison is not None:
                        logits = torch.where(poison[:, None], float("nan"), logits)
                else:
                    # Poison is injected BEFORE the grammar mask: NaNs survive
                    # the mask's allowed positions.
                    if poison is not None:
                        logits = torch.where(poison[:, None], float("nan"), logits)
                    eos_arr = torch.as_tensor(self.eos_ids, dtype=torch.int64, device=device)
                    logits = self._grammar_mask(
                        dg, self._mask_pad(logits), t["g_states"], t["g_flags"], eos_arr
                    )
                tok, lp, bad = self._sample(
                    logits, t["seeds"], gen_lens + 1, t["sidx"], t["temps"], t["tps"]
                )
                active = t["active"]
                tok = torch.where(active, tok, pad_id)
                lp = torch.where(active, lp, 0.0)
                outs = [tok, lp, bad & active]
                if dg is not None:
                    outs.append(self._grammar_advance(dg, tok, t["g_states"], t["g_flags"]))
                # The one by-design sync per step: slot bookkeeping needs the
                # sampled ids on the host.
                # kllms: ignore[host-sync-hot-path] — the per-step result readback; everything after it is host-side bookkeeping
                return [o.cpu().numpy() for o in outs]

        _step_t0 = time.perf_counter()
        if self.budget_model is not None:
            t0 = time.monotonic()
            try:
                fetched = self._dispatcher.run(
                    _dispatch, self.budget_model.step_budget()
                )
            except _StepHung:
                with self._lock:
                    self._loop_epoch += 1
                RECOVERY_EVENTS.record("continuous.step_hangs")
                logger.error(
                    "continuous step overran its watchdog budget; abandoning "
                    "the dispatch thread and rebuilding"
                )
                raise
            self.budget_model.observe_step(time.monotonic() - t0)
        else:
            fetched = _dispatch()
        step_s = time.perf_counter() - _step_t0
        LATENCY.observe("continuous.step", step_s)
        tok_np, lp_np, bad_np = fetched[0], fetched[1], fetched[2]
        quarantined = 0
        with self._lock:
            if n_masked:
                self._g_states = fetched[3].copy()
                GRAMMAR_EVENTS.record("grammar.masked_steps", n_masked)
            self._stats["steps"] += 1
            # _active_mask is a numpy host mirror: these sums are host
            # bookkeeping, not device readbacks.
            # kllms: ignore[host-sync-hot-path] — numpy host mirror (already host memory); not a device readback
            self._stats["row_steps"] += int(self._active_mask.sum())
            # kllms: ignore[host-sync-hot-path] — numpy host mirror (already host memory); not a device readback
            active_rows = int(self._active_mask.sum())
            self._stats["max_active_rows"] = max(self._stats["max_active_rows"], active_rows)
            # A completed step is proof of life: recovery credits refill.
            self._consecutive_faults = 0
            touched = set()
            for slot in range(self.width):
                req = self._active[slot]
                if req is None:
                    continue
                j = req.slots.index(slot)
                if req.done[j]:
                    continue
                self._gen_lens[slot] += 1  # cur's KV is now written
                if bad_np[slot]:
                    # Numeric poison: freeze + retire this row only.
                    self._quarantine_row(req, j)
                    quarantined += 1
                    touched.add(id(req))
                    continue
                tk = int(tok_np[slot])
                self._cur[slot] = tk
                req.tokens[j].append(tk)
                req.logprobs[j].append(float(lp_np[slot]))
                if tk in self.eos_ids:
                    req.done[j] = True
                    req.finish[j] = "stop"
                elif len(req.tokens[j]) >= req.max_new:
                    req.done[j] = True
                    req.finish[j] = "length"
                touched.add(id(req))
            for rid in touched:
                req = next(
                    r for r in self._active if r is not None and id(r) == rid
                )
                if req.trace is not None:
                    req.trace.add_phase("decode", step_s)
                if req.budget is not None and req.budget.should_abort():
                    self._abort_request(req)
                    continue
                self._deliver_sink(req)
                self._retire_finished_rows(req)
                self._resolve_if_done(req)
            self._lock.notify_all()
        # Quarantine accounting + supervisor hook OUTSIDE the loop lock;
        # clean steps report 0 so the escalation window decays.
        note = getattr(self.engine, "_note_quarantine", None)
        if note is not None:
            note(quarantined, int(live_rows.size))

    # -- retirement --------------------------------------------------------

    def _deliver_sink(self, req: _SlotRequest) -> None:
        if req.token_sink is None:
            return
        step = req.steps_delivered
        req.steps_delivered += 1
        # Replay de-duplication: steps below the watermark were already
        # delivered before the fault.
        if step < req.delivered_watermark:
            return
        pad = self.engine.config.pad_token_id
        row = np.array(
            [
                s[step] if step < len(s) else pad
                for s in req.tokens
            ],
            np.int32,
        )
        try:
            req.token_sink(step, row)
        except Exception:
            logger.exception("continuous token sink failed; dropping tap")
            req.token_sink = None

    def _retire_finished_rows(self, req: _SlotRequest) -> None:
        for j, slot in enumerate(list(req.slots)):
            if req.done[j] and self._active[slot] is req and self._active_mask[slot]:
                self._active_mask[slot] = False
                self._cur[slot] = self.engine.config.pad_token_id
                self._active[slot] = None
                self._g_flags[slot] = False
                self._g_states[slot] = 0
                self._release_slot_pages(slot)
                self._free.append(slot)

    def _resolve_if_done(self, req: _SlotRequest) -> None:
        if not all(req.done):
            return
        # Flush any trailing sink steps (rows finish at different lengths).
        if req.token_sink is not None:
            longest = max(len(s) for s in req.tokens)
            while req.steps_delivered < longest:
                self._deliver_sink(req)
        pad = self.engine.config.pad_token_id
        toks = np.full((req.n, req.max_new), pad, np.int32)
        lps = np.zeros((req.n, req.max_new), np.float32)
        lengths = np.zeros((req.n,), np.int32)
        errs = list(req.sample_errors)
        while len(errs) < req.n:
            errs.append(None)
        for j in range(req.n):
            if errs[j] is not None:
                # Quarantined member: wiped (tokens→pad, logprobs→0,
                # length→0) so survivor consensus drops it from the vote.
                continue
            L = len(req.tokens[j])
            toks[j, :L] = req.tokens[j]
            lps[j, :L] = req.logprobs[j]
            lengths[j] = L
        result = GenerationResult(
            tokens=toks,
            logprobs=lps,
            lengths=lengths,
            finish_reasons=list(req.finish),
            prompt_len=req.prompt_len,
            sample_errors=errs if any(e is not None for e in errs) else None,
        )
        self._stats["completed"] += 1
        if not req.future.done():
            req.future.set_result(result)

    def _abort_request(self, req: _SlotRequest) -> None:
        FAILURE_EVENTS.record("engine.decode_abort")
        for j in range(req.n):
            req.done[j] = True
        self._retire_finished_rows(req)
        self._stats["aborted"] += 1
        if not req.future.done():
            req.future.set_exception(req.budget.error("engine decode"))

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            reqs = {id(r): r for r in self._active if r is not None}
            for req in reqs.values():
                for j in range(len(req.done)):
                    req.done[j] = True
                try:
                    self._retire_finished_rows(req)
                except PageAccountingError:
                    # Containment must complete even over a corrupt
                    # allocator: drop the slots without decref.
                    logger.exception(
                        "page release failed during fail-all; dropping slots"
                    )
                    for slot in list(req.slots):
                        if self._active[slot] is req:
                            self._active[slot] = None
                            self._active_mask[slot] = False
                            self._tables[slot] = []
                            self._reserved[slot] = []
                            self._free.append(slot)
                if not req.future.done():
                    req.future.set_exception(exc)
            if self._prefilling is not None:
                self._retire_prefilling_locked(exc)
            for req in self._queue:
                if not req.future.done():
                    req.future.set_exception(exc)
            self._queue.clear()
            self._lock.notify_all()
