"""Offline batch lane: durable OpenAI-Batch-shaped jobs over idle slots.

``BatchLane`` ties the crash-safe :class:`~k_llms_tpu_torch.reliability.jobstore.JobStore`
to the live serving stack: a ``POST /v1/batches`` body is a JSONL file of
chat-completion requests (either bare request bodies or OpenAI batch lines
with ``custom_id``/``method``/``url``/``body``); each line becomes one durable
item whose seed is pinned at submission — so a crash-interrupted item
re-executes byte-identically — and whose output record id is derived from the
item content, not the process, so an uninterrupted run and a kill-and-recover
run produce byte-identical output files.

Execution: a small pool of ``BatchLaneWorker`` threads (bounded in-flight)
feeds items into the EXISTING scheduler under the owning tenant's quota and
the ``batch`` SLO class (``TenancyConfig.batch_lane`` — shared token buckets,
strictly-lower WFQ priority), so offline work fills idle decode slots and
interactive traffic always dequeues first. A poisoned or shed item fails
alone: its typed error is captured into the output file as an error record
and the job completes ``completed_with_errors``.

Crash containment mirrors the continuous loop: the ``batch.worker=crash``
failpoint (or a host bug) kills a worker thread; the dequeued item is
checkpointed back to pending (memory + journal), the crash is counted, and a
replacement worker spawns (bounded). ``drain()`` stops dispatch, waits
bounded for in-flight commits, and requeues the stragglers durably;
``recover()`` re-admits every unfinished job from the journal after restart.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from hashlib import md5
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from ..utils.locks import make_condition
from ..reliability import failpoints as _failpoints
from ..reliability.jobstore import JobStore, JobState
from ..types.wire import InvalidRequestError, KLLMsError, RateLimitError
from ..utils.observability import BATCH_EVENTS, LATENCY

logger = logging.getLogger(__name__)

__all__ = ["BatchLane", "BatchLaneWorker", "MAX_ITEMS_PER_JOB"]

#: Per-job item cap: a 32 MiB body bound already limits bytes at the server;
#: this bounds the journal and the in-memory dispatch deque.
MAX_ITEMS_PER_JOB = 10_000

#: Request-body keys forwarded to Completions.create per item — mirrors the
#: interactive route's whitelist (serving/app.py imports stay acyclic: the
#: app imports this module lazily).
from .app import _CREATE_KEYS  # noqa: E402

#: Total replacement workers a lane may spawn after crashes — a crash on
#: every iteration is a drill gone wrong, not a workload to keep feeding.
_MAX_RESPAWNS = 16


def _pin_seed(body: Dict[str, Any]) -> None:
    # Submission-pinned seeds: decided once at ingest,
    # persisted in input.jsonl, so crash re-execution samples identically.
    if body.get("seed") is None:
        import os

        body["seed"] = int.from_bytes(os.urandom(4), "little")


def _parse_jsonl(raw: bytes) -> List[Dict[str, Any]]:
    """JSONL body → normalized item dicts ({custom_id, rid, body})."""
    import json

    items: List[Dict[str, Any]] = []
    for lineno, line in enumerate(raw.splitlines(), start=1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError as e:
            raise InvalidRequestError(
                f"batch line {lineno}: invalid JSON ({e})", param="body"
            )
        if not isinstance(obj, dict):
            raise InvalidRequestError(
                f"batch line {lineno}: each line must be a JSON object",
                param="body",
            )
        if "body" in obj:
            method = str(obj.get("method", "POST")).upper()
            url = obj.get("url", "/v1/chat/completions")
            if method != "POST" or url != "/v1/chat/completions":
                raise InvalidRequestError(
                    f"batch line {lineno}: only POST /v1/chat/completions "
                    f"items are supported, got {method} {url}",
                    param="url",
                )
            body = obj["body"]
            custom_id = str(obj.get("custom_id") or f"item-{len(items)}")
        else:
            body = obj
            custom_id = f"item-{len(items)}"
        if not isinstance(body, dict) or not isinstance(
            body.get("messages"), list
        ) or not body["messages"]:
            raise InvalidRequestError(
                f"batch line {lineno}: 'messages' must be a non-empty list",
                param="messages",
            )
        body = {k: body[k] for k in _CREATE_KEYS if body.get(k) is not None}
        _pin_seed(body)
        # Deterministic output-record id: a function of the item CONTENT
        # (index, custom_id, pinned body), never the process or job — the
        # exactly-once differential compares ids across runs byte-for-byte.
        digest = md5(
            f"{len(items)}|{custom_id}|"
            f"{json.dumps(body, sort_keys=True, separators=(',', ':'))}".encode()
        ).hexdigest()[:24]
        items.append(
            {"custom_id": custom_id, "rid": f"batch_req_{digest}", "body": body}
        )
    if not items:
        raise InvalidRequestError(
            "batch body must contain at least one JSONL request line",
            param="body",
        )
    if len(items) > MAX_ITEMS_PER_JOB:
        raise InvalidRequestError(
            f"batch exceeds {MAX_ITEMS_PER_JOB} items ({len(items)})",
            param="body",
        )
    return items


class BatchLane:
    """Durable batch jobs executed at batch-SLO priority over one client."""

    def __init__(
        self,
        client: Any,
        store: JobStore,
        *,
        max_in_flight: int = 4,
        item_retries: int = 1,
        autostart: bool = True,
    ) -> None:
        self.client = client
        self.store = store
        self.max_in_flight = max(1, int(max_in_flight))
        self.item_retries = max(0, int(item_retries))
        self._autostart = autostart
        self._cv = make_condition("serving.batch_lane")
        self._pending: Deque[Tuple[str, int]] = deque()
        self._in_flight: Set[Tuple[str, int]] = set()
        self._workers: List["BatchLaneWorker"] = []
        self._respawns = 0
        self._stop = False
        self._draining = False

    # -- submission / recovery --------------------------------------------
    def submit(self, raw: bytes, tenant: str) -> Dict[str, Any]:
        """Parse, pin, persist, and enqueue one job. Returns the wire dict.

        The job is durable (journal fsynced) BEFORE this returns: a kill
        after the 200 can never lose the submission."""
        items = _parse_jsonl(raw)
        job = self.store.create_job(items, tenant=tenant)
        BATCH_EVENTS.record("batch.job_created")
        logger.info(
            "batch job %s: %d items for tenant %r", job.id, job.n_items, tenant
        )
        self._enqueue(job.id, range(job.n_items))
        return self.job_wire(job.id)

    def recover(self) -> int:
        """Re-admit every unfinished journaled job (restart recovery)."""
        recovered = 0
        for job in self.store.unfinished_jobs():
            pending = [
                i for i, s in enumerate(job.items) if s in ("pending", "started")
            ]
            # All-terminal jobs were finalized by the store's own
            # reconciliation; anything left here has real work.
            BATCH_EVENTS.record("batch.job_recovered")
            recovered += 1
            logger.info(
                "batch job %s: recovered with %d/%d items pending",
                job.id, len(pending), job.n_items,
            )
            self._enqueue(job.id, pending)
        return recovered

    def _enqueue(self, job_id: str, idxs: Any) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError("batch lane is stopped")
            for idx in idxs:
                key = (job_id, idx)
                if key not in self._in_flight and key not in self._pending:
                    self._pending.append(key)
            if self._autostart:
                self._ensure_workers_locked()
            self._cv.notify_all()

    def start(self) -> None:
        """Spawn the worker pool (no-op when already running)."""
        with self._cv:
            self._ensure_workers_locked()

    def _ensure_workers_locked(self) -> None:
        if self._stop or self._draining:
            return
        self._workers = [w for w in self._workers if w.is_alive()]
        while len(self._workers) < self.max_in_flight:
            worker = BatchLaneWorker(self, len(self._workers))
            self._workers.append(worker)
            worker.start()

    # -- cancel / drain ----------------------------------------------------
    def cancel(self, job_id: str) -> Optional[Dict[str, Any]]:
        """Cancel a job: queued items never run; in-flight items finish and
        their records stay in the (partial) output file."""
        if self.store.job(job_id) is None:
            return None
        with self._cv:
            self._pending = deque(
                key for key in self._pending if key[0] != job_id
            )
        self.store.cancel_job(job_id)
        BATCH_EVENTS.record("batch.job_cancelled")
        return self.job_wire(job_id)

    def drain(self, timeout: float = 30.0) -> None:
        """Stop dispatch, wait bounded for in-flight commits, checkpoint the
        rest back to ``pending`` durably. Jobs resume via :meth:`recover`
        (same process: build a fresh lane over the same store)."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            self._draining = True
            self._stop = True
            self._cv.notify_all()
            while self._in_flight and time.monotonic() < deadline:
                self._cv.wait(timeout=min(0.25, max(0.01, timeout)))
            stranded = list(self._in_flight) + list(self._pending)
            self._pending.clear()
            workers = list(self._workers)
        for job_id, idx in stranded:
            # In-flight past the deadline: the journal checkpoint makes the
            # item re-execute after restart; if the straggler thread still
            # commits, the segment rename wins and recovery sees it done —
            # either way exactly one output record.
            if self.store.requeue_item(job_id, idx):
                BATCH_EVENTS.record("batch.item_requeued")
        for worker in workers:
            worker.join(timeout=max(0.1, deadline - time.monotonic()))

    # -- execution (called from BatchLaneWorker) ---------------------------
    def _next_item(self) -> Optional[Tuple[str, int]]:
        with self._cv:
            while not self._pending and not self._stop:
                self._cv.wait(timeout=0.5)
            if self._stop:
                return None
            key = self._pending.popleft()
            self._in_flight.add(key)
            return key

    def _item_done(self, key: Tuple[str, int]) -> None:
        with self._cv:
            self._in_flight.discard(key)
            self._cv.notify_all()

    def _on_worker_crash(self, key: Tuple[str, int]) -> None:
        """Crash containment: count it, checkpoint the dequeued item back to
        pending (memory + journal), spawn a bounded replacement."""
        BATCH_EVENTS.record("batch.worker_crashes")
        replacement: Optional[BatchLaneWorker] = None
        with self._cv:
            self._in_flight.discard(key)
            if not self._stop:
                self._pending.appendleft(key)
            if not self._stop and self._respawns < _MAX_RESPAWNS:
                self._respawns += 1
                replacement = BatchLaneWorker(
                    self, self._respawns + self.max_in_flight
                )
                self._workers.append(replacement)
            self._cv.notify_all()
        self.store.requeue_item(*key)
        if replacement is not None:
            replacement.start()

    def _lane_tenant(self, owner: str) -> str:
        backend = getattr(self.client, "backend", None)
        tenancy = getattr(backend, "tenancy", None)
        if tenancy is None:
            return owner
        return tenancy.batch_lane(owner).name

    def _run_item(self, job_id: str, idx: int) -> None:
        job = self.store.job(job_id)
        if job is None or job.cancelled or job.items[idx] != "pending":
            return
        item = self.store.load_items(job_id)[idx]
        self.store.note_item_started(job_id, idx)
        t0 = time.monotonic()
        params = dict(item["body"])
        params["tenant"] = self._lane_tenant(job.tenant)
        try:
            completion = self._dispatch(params)
            record = {
                "id": item["rid"],
                "custom_id": item["custom_id"],
                "response": {
                    "status_code": 200,
                    "body": completion.model_dump(mode="json"),
                },
                "error": None,
            }
            self.store.commit_item(job_id, idx, record)
            BATCH_EVENTS.record("batch.item_completed")
        except KLLMsError as e:
            self._commit_error(
                job_id, idx, item, e.status_code, e.as_wire()["error"]
            )
        except Exception as e:  # host bug: the item fails alone, typed
            logger.exception("batch item %s[%d] failed", job_id, idx)
            self._commit_error(
                job_id, idx, item, 500,
                {
                    "message": str(e) or "internal server error",
                    "type": "server_error", "param": None, "code": None,
                },
            )
        LATENCY.observe("batch.item", time.monotonic() - t0)
        self._maybe_finish(job_id)

    def _dispatch(self, params: Dict[str, Any]) -> Any:
        """One item through the client, with bounded 429 re-dispatch: a
        quota-shed batch item waits out its own tenant's refill horizon
        instead of instantly burning its error budget."""
        attempts = self.item_retries + 1
        for attempt in range(attempts):
            try:
                return self.client.chat.completions.create(**params)
            except RateLimitError as e:
                if attempt + 1 >= attempts:
                    raise
                time.sleep(min(float(e.retry_after or 0.05), 2.0))

    def _commit_error(
        self, job_id: str, idx: int, item: Dict[str, Any],
        status_code: int, wire_error: Dict[str, Any],
    ) -> None:
        record = {
            "id": item["rid"],
            "custom_id": item["custom_id"],
            "response": None,
            "error": {"status_code": status_code, **wire_error},
        }
        self.store.commit_item(job_id, idx, record, error=True)
        BATCH_EVENTS.record("batch.item_failed")

    def _maybe_finish(self, job_id: str) -> None:
        status = self.store.finish_job(job_id)
        if status in ("completed", "completed_with_errors"):
            job = self.store.job(job_id)
            if job is not None:
                LATENCY.observe(
                    "batch.job_e2e", max(0.0, time.time() - job.created_at)
                )
            if status == "completed":
                BATCH_EVENTS.record("batch.job_completed")
            else:
                BATCH_EVENTS.record("batch.job_completed_with_errors")
            logger.info("batch job %s: %s", job_id, status)

    # -- reads -------------------------------------------------------------
    def job_wire(self, job_id: str) -> Optional[Dict[str, Any]]:
        job = self.store.job(job_id)
        if job is None:
            return None
        return _job_wire(job)

    def output_bytes(self, job_id: str) -> Optional[bytes]:
        return self.store.read_output(job_id)

    def health(self) -> Dict[str, Any]:
        with self._cv:
            snap: Dict[str, Any] = {
                "pending_items": len(self._pending),
                "in_flight_items": len(self._in_flight),
                "workers": sum(1 for w in self._workers if w.is_alive()),
                "worker_respawns": self._respawns,
                "draining": self._draining,
            }
        snap["jobs"] = {
            jid: {"status": job.status, **job.counts()}
            for jid, job in sorted(self.store.jobs().items())
        }
        return snap

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Test/bench helper: True once no pending or in-flight items."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self._in_flight:
                if time.monotonic() >= deadline:
                    return False
                self._cv.wait(timeout=0.1)
            return True

    def close(self) -> None:
        with self._cv:
            self._stop = True
            workers = list(self._workers)
            self._cv.notify_all()
        for worker in workers:
            worker.join(timeout=5.0)
        self.store.close()


class BatchLaneWorker(threading.Thread):
    """One dequeue-execute-commit loop; dies on an injected crash."""

    def __init__(self, lane: BatchLane, serial: int) -> None:
        super().__init__(daemon=True, name=f"kllms-batch-{serial}")
        self._lane = lane

    def run(self) -> None:
        lane = self._lane
        while True:
            key = lane._next_item()
            if key is None:
                return
            # The crash drill fires OUTSIDE the per-item error guard —
            # mirroring continuous.worker — so it kills the worker thread
            # itself rather than being captured as an item error.
            try:
                _failpoints.fire("batch.worker")
            except Exception:
                logger.warning(
                    "batch worker %s crashed (contained); item %s requeued",
                    self.name, key,
                )
                lane._on_worker_crash(key)
                return
            try:
                lane._run_item(*key)
            finally:
                lane._item_done(key)


def _job_wire(job: JobState) -> Dict[str, Any]:
    # The store only journals terminal status transitions; "in_progress" is
    # derived (any item past pending) so it needs no fsync of its own.
    status = job.status
    if status == "queued" and any(s != "pending" for s in job.items):
        status = "in_progress"
    return {
        "id": job.id,
        "object": "batch",
        "endpoint": "/v1/chat/completions",
        "status": status,
        "created_at": int(job.created_at),
        "tenant": job.tenant,
        "request_counts": job.counts(),
        "output_available": job.status in
        ("completed", "completed_with_errors", "cancelled"),
    }
