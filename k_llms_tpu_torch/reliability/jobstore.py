"""Crash-safe write-ahead job store for the offline batch lane.

Durability model — the batch lane's exactly-once contract rests on three
mechanisms, each independently recoverable:

1. **Append-only journal** (``journal.log``): every job/item state transition
   is a CRC-framed record (``<len u32><crc32 u32><json payload>``). Commit-
   critical records (job creation, item done/error, requeue checkpoints,
   terminal status) are fsynced before the call returns; cheap advisory
   records (item started) are not — recovery treats a non-committed item as
   pending anyway. A torn tail (partial frame, bad CRC — a kill mid-append)
   is truncated on open and counted (``batch.store_torn_tail``); everything
   before it is intact.

2. **Atomic output segments** (``jobs/<id>/out/<idx>.json``): an item's
   output record is written to a temp file, fsynced, then ``os.replace``d
   into place (+ directory fsync). The rename IS the commit point: a kill at
   any instant leaves either no segment (item re-executes — byte-identical,
   its seed was pinned at submission) or exactly one complete segment. The
   segment is authoritative over the journal: recovery classifies an item by
   its segment when the ``done`` record was lost with the tail.

3. **Assembled output** (``jobs/<id>/output.jsonl``): concatenation of the
   segments in item order, written with the same tmp+fsync+rename dance once
   the job reaches a terminal status. Re-assembly is idempotent.

A duplicate execution (a drain checkpointed an in-flight item back to
``pending`` while its original thread later committed anyway) converges to
one record: both writers target the same segment path with byte-identical
content, so the output file can never hold two records for one item.

The ``batch.store`` failpoint's ``torn`` action fires inside ``_append``:
a prefix of the frame reaches the file, then the append raises — exactly the
disk state a kill mid-write leaves behind, exercisable without a kill.

Retention: with ``ttl_s`` set, open runs a one-shot sweep that
GC's terminal jobs older than the TTL — a durable ``gc`` journal record (so
the job can never resurrect from its earlier records), then directory
removal, counted in ``batch.job_swept`` — plus an orphan pass for dirs with
no journal row. Unfinished jobs never expire.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..utils.locks import make_lock
from ..utils.observability import BATCH_EVENTS
from . import failpoints as _failpoints

logger = logging.getLogger(__name__)

__all__ = ["JobStore", "JobState", "TERMINAL_STATUSES", "ITEM_STATES"]

#: Job statuses a job can never leave; output.jsonl exists once reached.
TERMINAL_STATUSES = ("completed", "completed_with_errors", "cancelled")

#: Per-item lifecycle. ``started`` is advisory (un-fsynced): recovery demotes
#: it back to ``pending`` unless a committed segment proves completion.
ITEM_STATES = ("pending", "started", "done", "error")

_FRAME = struct.Struct("<II")  # (payload length, crc32(payload))


def _fsync_dir(path: Path) -> None:
    # Durable rename: the directory entry itself must reach the platter.
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: Path, data: bytes, fsync: bool = True) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path.parent)


@dataclass
class JobState:
    """In-memory job row, rebuilt from the journal + segments on open."""

    id: str
    tenant: str
    n_items: int
    created_at: float
    status: str = "queued"  # queued | in_progress | <TERMINAL_STATUSES>
    cancelled: bool = False
    items: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.items:
            self.items = ["pending"] * self.n_items

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    def counts(self) -> Dict[str, int]:
        return {
            "total": self.n_items,
            "completed": sum(1 for s in self.items if s == "done"),
            "failed": sum(1 for s in self.items if s == "error"),
        }

    def snapshot(self) -> "JobState":
        return JobState(
            id=self.id, tenant=self.tenant, n_items=self.n_items,
            created_at=self.created_at, status=self.status,
            cancelled=self.cancelled, items=list(self.items),
        )


class JobStore:
    """One directory of durable batch jobs behind one leaf lock.

    Layout::

        <root>/journal.log              CRC-framed state transitions
        <root>/jobs/<id>/input.jsonl    normalized items (seeds pinned)
        <root>/jobs/<id>/out/00007.json committed output segment for item 7
        <root>/jobs/<id>/output.jsonl   assembled once the job is terminal
    """

    def __init__(
        self, root: Any, *, fsync: bool = True, ttl_s: Optional[float] = None
    ) -> None:
        self.root = Path(root)
        self._fsync_enabled = fsync
        self.ttl_s = float(ttl_s) if ttl_s else 0.0
        # Leaf lock: guards the job table and journal appends; never held
        # across a model call (the lane executes items outside it).
        self._lock = make_lock("reliability.jobstore")
        self._jobs: Dict[str, JobState] = {}
        self._jobs_dir = self.root / "jobs"
        self._jobs_dir.mkdir(parents=True, exist_ok=True)
        self._journal_path = self.root / "journal.log"
        self._recover()
        self._fh = open(self._journal_path, "ab")
        if self.ttl_s > 0:
            with self._lock:
                self._sweep_expired_locked()

    # -- journal framing ---------------------------------------------------
    def _append(self, payload: Dict[str, Any], sync: bool) -> None:
        data = json.dumps(payload, separators=(",", ":")).encode()
        frame = _FRAME.pack(len(data), zlib.crc32(data)) + data
        spec = _failpoints.fire("batch.store")
        if spec is not None and getattr(spec, "action", None) == "torn":
            # Simulated kill mid-append: a prefix of the frame reaches the
            # file, the writer is gone. Recovery must truncate this tail.
            self._fh.write(frame[: max(1, len(frame) // 2)])
            self._fh.flush()
            raise RuntimeError(
                "injected torn journal append (failpoint): batch.store "
                "record truncated mid-write"
            )
        self._fh.write(frame)
        self._fh.flush()
        if sync and self._fsync_enabled:
            os.fsync(self._fh.fileno())

    def _read_journal(self) -> List[Dict[str, Any]]:
        """Replay every intact record; truncate a torn tail in place."""
        records: List[Dict[str, Any]] = []
        if not self._journal_path.exists():
            return records
        raw = self._journal_path.read_bytes()
        offset = 0
        good = 0
        while offset + _FRAME.size <= len(raw):
            length, crc = _FRAME.unpack_from(raw, offset)
            start = offset + _FRAME.size
            end = start + length
            if end > len(raw):
                break  # partial payload: torn tail
            payload = raw[start:end]
            if zlib.crc32(payload) != crc:
                break  # corrupt frame: everything after is untrusted
            try:
                records.append(json.loads(payload))
            except ValueError:
                break
            offset = end
            good = end
        if good < len(raw):
            BATCH_EVENTS.record("batch.store_torn_tail")
            logger.warning(
                "jobstore: truncating torn journal tail (%d of %d bytes kept)",
                good, len(raw),
            )
            with open(self._journal_path, "ab") as fh:
                fh.truncate(good)
        return records

    # -- recovery ----------------------------------------------------------
    def _recover(self) -> None:
        # Only ever called from __init__ (no concurrent readers yet); the
        # lock is held anyway so the guarded-by invariant on _jobs is total.
        with self._lock:
            self._recover_locked()

    def _recover_locked(self) -> None:
        for rec in self._read_journal():
            kind = rec.get("t")
            if kind == "job":
                self._jobs[rec["id"]] = JobState(
                    id=rec["id"], tenant=rec.get("tenant", "default"),
                    n_items=int(rec["n"]),
                    created_at=float(rec.get("created_at", 0.0)),
                )
            elif kind == "item":
                job = self._jobs.get(rec.get("id"))
                idx = int(rec.get("idx", -1))
                if job is not None and 0 <= idx < job.n_items:
                    job.items[idx] = rec.get("s", "pending")
                    if job.status == "queued" and rec.get("s") == "started":
                        job.status = "in_progress"
            elif kind == "status":
                job = self._jobs.get(rec.get("id"))
                if job is not None:
                    job.status = rec.get("s", job.status)
                    if job.status == "cancelled":
                        job.cancelled = True
            elif kind == "gc":
                # Swept by a TTL pass: the job must NOT resurrect — without
                # this record, replaying its "job" record against a deleted
                # directory would revive it as a cancelled ghost (_reconcile
                # sees no input.jsonl).
                self._jobs.pop(rec.get("id"), None)
        for job in self._jobs.values():
            self._reconcile(job)

    def _reconcile(self, job: JobState) -> None:
        """Disk is authoritative: segments decide done/error; ``started``
        without a segment rolls back to ``pending``; ``*.tmp`` leftovers
        (a kill between write and rename) are discarded."""
        jobdir = self._jobs_dir / job.id
        outdir = jobdir / "out"
        for stray in glob.glob(str(outdir / "*.tmp")):
            os.unlink(stray)
        committed: Dict[int, bool] = {}
        for seg in glob.glob(str(outdir / "*.json")):
            try:
                idx = int(Path(seg).stem)
                record = json.loads(Path(seg).read_bytes())
                committed[idx] = record.get("error") is not None
            except (ValueError, OSError):
                # Can't happen under the fsync-before-rename model; if the
                # platter lied, re-execution is the safe direction.
                os.unlink(seg)
        for idx in range(job.n_items):
            if idx in committed:
                job.items[idx] = "error" if committed[idx] else "done"
            elif job.items[idx] == "started":
                job.items[idx] = "pending"
                BATCH_EVENTS.record("batch.item_requeued")
        if not (jobdir / "input.jsonl").exists():
            logger.warning(
                "jobstore: job %s has no input.jsonl (killed mid-create); "
                "marking cancelled", job.id,
            )
            job.status = "cancelled"
            job.cancelled = True
            return
        if not job.terminal and all(s in ("done", "error") for s in job.items):
            job.status = (
                "completed_with_errors"
                if any(s == "error" for s in job.items) else "completed"
            )
        if job.terminal and not (jobdir / "output.jsonl").exists():
            self._assemble(job)

    # -- TTL sweep ----------------------------------------------
    def _sweep_expired_locked(self) -> None:
        """GC terminal jobs older than ``ttl_s`` (age from submission — the
        only timestamp the journal carries). Runs once per open, before any
        concurrent writers exist. Order per job: durable ``gc`` journal
        record first, then directory removal — a kill between the two leaves
        a dir the orphan pass below deletes on the next open. Non-terminal
        jobs never expire (the lane still owes them execution)."""
        import shutil

        now = time.time()
        for jid in list(self._jobs):
            job = self._jobs[jid]
            if not job.terminal or now - job.created_at <= self.ttl_s:
                continue
            self._append({"t": "gc", "id": jid}, sync=True)
            del self._jobs[jid]
            shutil.rmtree(self._jobs_dir / jid, ignore_errors=True)
            BATCH_EVENTS.record("batch.job_swept")
            logger.info(
                "jobstore: swept expired job %s (age %.0fs > ttl %.0fs)",
                jid, now - job.created_at, self.ttl_s,
            )
        # Orphan pass: directories with no live job row — an interrupted
        # rmtree above, or a create killed before its journal record.
        for path in self._jobs_dir.iterdir():
            if path.is_dir() and path.name not in self._jobs:
                shutil.rmtree(path, ignore_errors=True)

    # -- job lifecycle -----------------------------------------------------
    def create_job(
        self,
        items: List[Dict[str, Any]],
        tenant: str,
        job_id: Optional[str] = None,
    ) -> JobState:
        jid = job_id or "batch_" + os.urandom(12).hex()
        jobdir = self._jobs_dir / jid
        (jobdir / "out").mkdir(parents=True, exist_ok=True)
        lines = b"".join(
            json.dumps(item, separators=(",", ":")).encode() + b"\n"
            for item in items
        )
        # Input before journal: a journal job record always has its items.
        _write_atomic(jobdir / "input.jsonl", lines, fsync=self._fsync_enabled)
        job = JobState(
            id=jid, tenant=tenant, n_items=len(items), created_at=time.time()
        )
        with self._lock:
            self._append(
                {
                    "t": "job", "id": jid, "tenant": tenant,
                    "n": job.n_items, "created_at": job.created_at,
                },
                sync=True,
            )
            self._jobs[jid] = job
        return job.snapshot()

    def load_items(self, job_id: str) -> List[Dict[str, Any]]:
        path = self._jobs_dir / job_id / "input.jsonl"
        return [
            json.loads(line)
            for line in path.read_bytes().splitlines() if line.strip()
        ]

    def note_item_started(self, job_id: str, idx: int) -> bool:
        """Advisory (un-fsynced): marks intent, never durability."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.cancelled or job.items[idx] != "pending":
                return False
            job.items[idx] = "started"
            if job.status == "queued":
                job.status = "in_progress"
            self._append(
                {"t": "item", "id": job_id, "idx": idx, "s": "started"},
                sync=False,
            )
            return True

    def commit_item(
        self, job_id: str, idx: int, record: Dict[str, Any],
        error: bool = False,
    ) -> bool:
        """The exactly-once commit: segment rename, then a durable journal
        record. Idempotent — a duplicate execution rewrites the same segment
        with the same bytes."""
        outdir = self._jobs_dir / job_id / "out"
        line = json.dumps(record, separators=(",", ":")).encode() + b"\n"
        _write_atomic(
            outdir / f"{idx:05d}.json", line, fsync=self._fsync_enabled
        )
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return False
            state = "error" if error else "done"
            already = job.items[idx] == state
            job.items[idx] = state
            if not already:
                self._append(
                    {"t": "item", "id": job_id, "idx": idx, "s": state},
                    sync=True,
                )
            return True

    def requeue_item(self, job_id: str, idx: int) -> bool:
        """Checkpoint an in-flight item back to pending (drain/crash). A
        durable record: after restart the item re-executes from scratch."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.items[idx] != "started":
                return False
            job.items[idx] = "pending"
            self._append(
                {"t": "item", "id": job_id, "idx": idx, "s": "pending"},
                sync=True,
            )
            return True

    def finish_job(self, job_id: str) -> Optional[str]:
        """Terminalize once every item is done/error; assembles the output."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.terminal:
                return job.status if job else None
            if not all(s in ("done", "error") for s in job.items):
                return None
            job.status = (
                "completed_with_errors"
                if any(s == "error" for s in job.items) else "completed"
            )
            self._append(
                {"t": "status", "id": job_id, "s": job.status}, sync=True
            )
            self._assemble(job)
            return job.status

    def cancel_job(self, job_id: str) -> Optional[str]:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job.terminal:
                return job.status
            job.cancelled = True
            job.status = "cancelled"
            self._append(
                {"t": "status", "id": job_id, "s": "cancelled"}, sync=True
            )
            self._assemble(job)
            return job.status

    def _assemble(self, job: JobState) -> None:
        """Concatenate committed segments (item order) into output.jsonl."""
        jobdir = self._jobs_dir / job.id
        chunks: List[bytes] = []
        for idx in range(job.n_items):
            seg = jobdir / "out" / f"{idx:05d}.json"
            if seg.exists():
                chunks.append(seg.read_bytes())
        _write_atomic(
            jobdir / "output.jsonl", b"".join(chunks),
            fsync=self._fsync_enabled,
        )

    # -- reads -------------------------------------------------------------
    def job(self, job_id: str) -> Optional[JobState]:
        with self._lock:
            job = self._jobs.get(job_id)
            return job.snapshot() if job is not None else None

    def jobs(self) -> Dict[str, JobState]:
        with self._lock:
            return {jid: job.snapshot() for jid, job in self._jobs.items()}

    def unfinished_jobs(self) -> List[JobState]:
        with self._lock:
            return [
                job.snapshot()
                for job in self._jobs.values() if not job.terminal
            ]

    def read_output(self, job_id: str) -> Optional[bytes]:
        """Assembled output bytes for a terminal job; None otherwise."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or not job.terminal:
                return None
        path = self._jobs_dir / job_id / "output.jsonl"
        if not path.exists():
            with self._lock:
                self._assemble(self._jobs[job_id])
        return path.read_bytes()

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # pragma: no cover
            pass
