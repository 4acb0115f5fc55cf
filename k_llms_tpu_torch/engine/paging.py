"""Paged KV cache: a fixed pool of fixed-size KV pages with refcounted
sharing and copy-on-write (the vLLM PagedAttention memory model, Kwon et al.
2023, §4), grown onto this engine's shared-prefix serving stack.

Counterpart of ``k_llms_tpu/engine/paging.py``: the host-side accounting
(``PageAllocator``, ``pages_for``, ``flat_slots``, ``TRASH_PAGE``) is carried
over as it is; ``PagedKVPool`` holds torch tensors on the engine's device and
moves KV with in-place index writes and gathers, and ``PagedPrefixRun``
carries the prefix cache's page runs (materialised, or gathered as a
continuation's seed).

Why pages. The consensus workload decodes ``n`` continuations of ONE prompt;
dense per-row KV charges every row the full ``seq_len * kv_bytes_per_token``,
so HBM caps the admitted width long before compute does (ROADMAP open item 2).
With pages, the n rows of a fan-out hold *references* to one physical copy of
the prompt's pages; only the generated tail — tens of tokens against hundreds
— is private per row. Admitted width then scales ~n× on the shared-prefix
portion of the sequence at the same HBM budget.

Layout. The device pool is one flat pair of tensors ``[L, pages * page_size,
kv_heads, head_dim]``. A *block table* is a host-side list of page ids per
logical row; attention consumes it as flat slot indices
``page_id * page_size + offset`` (the reference gathers them; the decode
kernel reads the pages through page tables). Gathered garbage in masked slots
is inert: masked scores are set to ``finfo.min`` before the softmax max,
``exp(min - m)`` underflows to exactly 0.0, and ``0 * finite_v == 0`` in the
values einsum.

Sharing discipline. Pages are shared ONLY between rows whose values are
provably bit-identical: (a) the n-way fork of one prefill at admission, and
(b) a prefix-cache entry extending another entry — the continuation prefill
literally copies the matched prefix's values, so the store shares the matched
run's full pages instead of re-materializing them. There is deliberately no
content-addressed dedup across independent prefills: different bucket sizes
compile different XLA programs whose results can differ in the last ulp, and
sharing those would silently break the dense≡paged bit-equality contract.

Copy-on-write. A row that appends its first divergent token into a partially
filled shared page (``prompt_len % page_size != 0``) gets a fresh page with
the shared page's contents copied on device first; full prompt pages stay
shared for the row's whole lifetime. Writers therefore always own their page
exclusively (refcount 1), which is the invariant that keeps cache entries and
sibling rows immutable.

Known sharp edge: the trash page (page 0) absorbs writes from inactive loop
rows and reads from masked slots. Its contents are arbitrary but finite under
healthy operation; a NaN-poisoned launch could park NaNs there, but such a
launch is already a numeric-quarantine event on the dense path too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..analysis.lockcheck import make_rlock, note_device_dispatch

#: Page id 0 is the TRASH page: never allocated, never in a block table.
#: Masked gather slots and inactive-row writes point into it, so every flat
#: index the device ever sees is in-bounds without data-dependent control flow.
TRASH_PAGE = 0


class PageAccountingError(RuntimeError):
    """A page-pool invariant was violated (leak, double free, negative
    refcount). Raised by :meth:`PageAllocator.verify` — wired into
    ``ContinuousDecodeLoop.stats`` so serving health checks fail fast instead
    of decoding against a corrupted pool."""


class PagePoolExhausted(RuntimeError):
    """Allocation could not be satisfied even after eviction."""


class PageAllocator:
    """Host-side page accounting: free stack + per-page refcounts.

    Thread-safe (the continuous-loop worker, the scheduler's coalesced path,
    and test threads all touch one pool). All refcount state is host-only —
    the device pool itself carries no metadata.
    """

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 2:
            raise ValueError("page pool needs >= 2 pages (one is the trash page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        self._lock = make_rlock("engine.page_allocator")
        # LIFO free stack: recently freed pages are re-used first (their HBM
        # is warm and their contents are already overwritten by the next
        # owner's scatter before any unmasked read).
        self._free: List[int] = list(range(self.total_pages - 1, 0, -1))
        self._ref = np.zeros(self.total_pages, np.int64)
        self._ref[TRASH_PAGE] = 1  # permanently owned by the pool itself
        self._leaked = 0  # failpoint-injected leaks (engine.pages=leak:N)
        self.stats: Dict[str, int] = {
            "allocs": 0,
            "frees": 0,
            "cow_copies": 0,
            "peak_in_use": 1,
        }

    # -- queries -----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use_pages(self) -> int:
        """Pages with a live reference (trash page included)."""
        with self._lock:
            return int((self._ref > 0).sum())

    @property
    def usable_pages(self) -> int:
        """Capacity available to block tables (everything but trash)."""
        return self.total_pages - 1

    @property
    def shared_pages(self) -> int:
        """Pages referenced by more than one owner (the physical prefix
        sharing the bench reports; trash excluded)."""
        with self._lock:
            shared = int((self._ref > 1).sum())
            return shared - (1 if self._ref[TRASH_PAGE] > 1 else 0)

    def refcount(self, page: int) -> int:
        with self._lock:
            return int(self._ref[page])

    # -- mutation ----------------------------------------------------------

    def alloc(self, count: int) -> List[int]:
        """Allocate ``count`` pages with refcount 1 each. All-or-nothing:
        raises :class:`PagePoolExhausted` without side effects when the free
        stack is short."""
        if count <= 0:
            return []
        with self._lock:
            if len(self._free) < count:
                raise PagePoolExhausted(
                    f"need {count} pages, {len(self._free)} free "
                    f"(pool={self.total_pages}, page_size={self.page_size})"
                )
            pages = [self._free.pop() for _ in range(count)]
            for p in pages:
                self._ref[p] = 1
            self.stats["allocs"] += count
            self.stats["peak_in_use"] = max(
                self.stats["peak_in_use"], self.in_use_pages
            )
            return pages

    def incref(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE or self._ref[p] <= 0:
                    raise PageAccountingError(
                        f"incref on unowned page {p} (ref={int(self._ref[p])})"
                    )
                self._ref[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages that reached
        refcount 0 and went back on the free stack."""
        freed: List[int] = []
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE or self._ref[p] <= 0:
                    raise PageAccountingError(
                        f"decref on unowned page {p} (ref={int(self._ref[p])})"
                    )
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
                    freed.append(p)
            self.stats["frees"] += len(freed)
        return freed

    def note_cow(self, count: int = 1) -> None:
        with self._lock:
            self.stats["cow_copies"] += count

    def leak(self, count: int) -> None:
        """Failpoint hook (``engine.pages=leak:N``): drop N pages from the
        free stack without accounting for them anywhere, simulating a lost
        decref so :meth:`verify` must trip."""
        with self._lock:
            n = min(count, len(self._free))
            for _ in range(n):
                self._free.pop()
            self._leaked += n

    # -- invariants --------------------------------------------------------

    def verify(self) -> None:
        """Assert the pool's conservation laws; raises
        :class:`PageAccountingError` on any violation:

        - no negative refcounts,
        - free + referenced == total (no page both free and owned, none lost),
        - the trash page is never on the free stack and never table-owned.
        """
        with self._lock:
            if (self._ref < 0).any():
                bad = np.flatnonzero(self._ref < 0).tolist()
                raise PageAccountingError(f"negative refcount on pages {bad}")
            free_set = set(self._free)
            if len(free_set) != len(self._free):
                raise PageAccountingError("duplicate pages on the free stack")
            if TRASH_PAGE in free_set:
                raise PageAccountingError("trash page on the free stack")
            owned = int((self._ref > 0).sum())
            if owned + len(self._free) != self.total_pages:
                raise PageAccountingError(
                    f"page leak: {owned} referenced + {len(self._free)} free "
                    f"!= {self.total_pages} total"
                    + (f" ({self._leaked} failpoint-leaked)" if self._leaked else "")
                )
            for p in free_set:
                if self._ref[p] != 0:
                    raise PageAccountingError(
                        f"page {p} is free but has refcount {int(self._ref[p])}"
                    )

    def check(self) -> Optional[str]:
        """Non-raising :meth:`verify`: the violation message, or None when
        the conservation laws hold. For callers that treat a corrupt pool as
        DATA — the continuous loop's stats quarantine reports the fault and
        flags the worker for rebuild instead of letting an accounting raise
        poison every subsequent health poll."""
        try:
            self.verify()
        except PageAccountingError as e:
            return str(e)
        return None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "total_pages": self.total_pages,
                "page_size": self.page_size,
                "free": len(self._free),
                "in_use": self.in_use_pages - 1,  # trash excluded
                "shared": self.shared_pages,
                "cow_copies": self.stats["cow_copies"],
                "peak_in_use": self.stats["peak_in_use"] - 1,
                "allocs": self.stats["allocs"],
                "frees": self.stats["frees"],
            }


def pages_for(tokens: int, page_size: int) -> int:
    return -(-int(tokens) // int(page_size)) if tokens > 0 else 0


def flat_slots(pages: Sequence[int], positions: np.ndarray, page_size: int) -> np.ndarray:
    """Map logical token positions to flat pool slot indices through a block
    table. Positions past the table map into the trash page (they are masked
    by the consumer; this keeps every index in-bounds)."""
    positions = np.asarray(positions, np.int64)
    offs = positions % page_size
    table = np.asarray(pages, np.int64)
    if len(table) == 0:
        return (np.full_like(positions, TRASH_PAGE) * page_size + offs).astype(np.int32)
    page_i = positions // page_size
    in_range = page_i < len(table)
    page_ids = np.where(in_range, table[np.minimum(page_i, len(table) - 1)], TRASH_PAGE)
    return (page_ids * page_size + offs).astype(np.int32)


class PagedKVPool:
    """The device-side page pool: ``k`` / ``v`` tensors of shape
    ``[L, total_pages * page_size, kv_heads, head_dim]`` on ``device``,
    updated in place under ``self.lock``. The pool is built by whichever
    path first needs it (a coalesced launch under ``torch.inference_mode``
    or the continuous loop outside it), so the in-place movers run under
    inference mode themselves: an inference tensor takes in-place writes
    only there."""

    def __init__(self, config, total_pages: int, page_size: int, device, dtype=None):
        import torch

        self.config = config
        self.page_size = int(page_size)
        self.allocator = PageAllocator(total_pages, page_size)
        # Held across the scatter/gather/copy and every paged decode step on
        # purpose: the in-place writes into k/v must not interleave.
        self.lock = make_rlock("engine.kv_pool", allow_dispatch=True)
        flat = int(total_pages) * int(page_size)
        shape = (config.num_layers, flat, config.num_kv_heads, config.head_dim)
        dtype = dtype or config.torch_dtype
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        # Immutable: the index uploads read it without the lock.
        self.device = self.k.device

    @property
    def flat_size(self) -> int:
        return self.allocator.total_pages * self.page_size

    def pool_bytes(self) -> int:
        with self.lock:
            return 2 * self.k.numel() * self.k.element_size()

    def _index(self, slot_idx):
        import torch

        return torch.as_tensor(np.asarray(slot_idx, np.int64), device=self.device)

    def scatter_tokens(self, k_src, v_src, slot_idx: np.ndarray) -> None:
        """Write token KV rows into flat pool slots. k_src/v_src:
        [L, n, KVH, D]; slot_idx: host int [n]."""
        import torch

        idx = self._index(slot_idx)
        with self.lock, torch.inference_mode():
            note_device_dispatch("paged kv scatter")
            self.k[:, idx] = k_src.to(self.k.dtype)
            self.v[:, idx] = v_src.to(self.v.dtype)

    def gather_tokens(self, slot_idx: np.ndarray):
        """Dense ``KVCache`` (k, v each [L, 1, n, KVH, D]) of the given flat
        slots: the layout every engine consumer of a prefix (the decode
        prefix, a continuation's seed) expects."""
        from ..models.llama import KVCache

        idx = self._index(slot_idx)
        with self.lock:
            note_device_dispatch("paged kv gather")
            return KVCache(k=self.k[:, idx][:, None], v=self.v[:, idx][:, None])

    def copy_pages(self, src_pages: Sequence[int], dst_pages: Sequence[int]) -> None:
        """Device copy of whole pages (the copy-on-write mover)."""
        import torch

        assert len(src_pages) == len(dst_pages)
        if not src_pages:
            return
        ps = self.page_size
        src = np.concatenate([np.arange(p * ps, (p + 1) * ps) for p in src_pages])
        dst = np.concatenate([np.arange(p * ps, (p + 1) * ps) for p in dst_pages])
        src_i, dst_i = self._index(src), self._index(dst)
        with self.lock, torch.inference_mode():
            note_device_dispatch("paged kv page copy")
            self.k[:, dst_i] = self.k[:, src_i]
            self.v[:, dst_i] = self.v[:, src_i]


class PagedPrefixRun:
    """A prompt prefix stored as a run of pool pages (the paged form of a
    prefix-cache entry's KV). Owns one reference per page; ``release()`` is
    idempotent. ``bucket`` records the dense bucket the prefill produced, so
    materialization reproduces the exact array shape the dense path
    stores."""

    __slots__ = ("pool", "pages", "plen", "bucket", "_released")

    def __init__(self, pool: PagedKVPool, pages: List[int], plen: int, bucket: int):
        self.pool = pool
        self.pages = list(pages)
        self.plen = int(plen)
        self.bucket = int(bucket)
        self._released = False

    def retain(self) -> None:
        self.pool.allocator.incref(self.pages)

    def release(self) -> int:
        """Drop the run's own reference (one-shot); returns how many pages
        actually hit the free stack — pages still pinned by rows or by a
        younger run sharing this prefix stay allocated."""
        if self._released:
            return 0
        self._released = True
        return len(self.pool.allocator.decref(self.pages))

    def _slots(self, length: int) -> np.ndarray:
        return flat_slots(self.pages, np.arange(length), self.pool.page_size)

    def materialize(self):
        """Dense ``KVCache`` [L, 1, bucket, KVH, D], equal to the dense
        entry at every unmasked position (masked slots gather the trash
        page, which the consumers' masking zeroes)."""
        return self.pool.gather_tokens(self._slots(self.bucket))

    def gather_prefix_padded(self, p: int, out_len: int):
        """Dense ``KVCache`` [L, 1, out_len, KVH, D] seeded with positions
        [0, p): the paged twin of padding ``matched_kv.k[:, :, :p]`` on the
        dense path. Positions >= p gather the trash page; the continuation
        prefill overwrites or masks all of them before any unmasked read."""
        idx = self._slots(out_len)
        idx[p:] = (np.arange(out_len - p) % self.pool.page_size).astype(np.int32)
        return self.pool.gather_tokens(idx)
