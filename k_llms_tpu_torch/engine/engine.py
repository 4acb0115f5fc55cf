"""Local inference engine: n-way consensus sampling as one batched decode.

Counterpart of ``k_llms_tpu/engine/engine.py``, on the paged path: each
request's prompt is prefilled once at batch=1 (the flash kernel), its KV is
copied into pool pages, and the n samples of every request decode together
as one batch against shared block tables (the paged-decode kernel), rows
request-major (``B = r_pad * n_per``). Padding rows and dead rows point their
gen slots at the trash page. The decode loop is a host loop of steps that
ends when every row is done: EOS and stop sequences, pad after done,
per-token logprobs, frequency/presence penalties and logit bias, optional
top logprobs, and quarantine of rows whose logits go non-finite.

Not ported yet: the dense-cache decode path, the prefix cache, meshes,
sequence-parallel and ring prefill, speculative decoding, grammar
constraints, the continuous loop, device-OOM splitting, the abort poller and
the streaming token tap.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig, get_config
from ..models.llama import check_supported, encode, init_params, paged_verify_step, prefill
from ..ops.paged_attention import resolve_paged_attention_impl
from ..ops.sampling import draw_noise, model_top_logprobs, sample_logits
from ..reliability.deadline import RequestBudget
from .paging import TRASH_PAGE, PagedKVPool, PagedPrefixRun, flat_slots, pages_for

logger = logging.getLogger(__name__)

MAX_EOS_IDS = 4
MAX_STOP_SEQS = 4
MAX_STOP_LEN = 8


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another. There
    is no silent fall back to the CPU: without a card, pass
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "k_llms_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def stop_window_match(window: torch.Tensor, stops: torch.Tensor) -> torch.Tensor:
    """[B, L] rolling token window vs [S, L] right-aligned -1-padded stop
    sequences: -1 padding positions auto-match, and a stop only counts if it
    has at least one real token. Returns [B] bool."""
    pad_pos = stops < 0
    eq = window[:, None, :] == stops[None, :, :]
    row_hit = (eq | pad_pos[None]).all(dim=-1)  # [B, S]
    live = (~pad_pos).any(dim=-1)  # [S]
    return (row_hit & live[None]).any(dim=-1)


def _poisoned_logits(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B] bool: rows with any NaN or +Inf, or every column -Inf."""
    bad_val = (torch.isnan(logits) | (logits == float("inf"))).any(dim=-1)
    degenerate = logits.amax(dim=-1) == -float("inf")
    return bad_val | degenerate


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _quarantine_error() -> Dict[str, Any]:
    return {
        "type": "server_error",
        "code": "numeric_poison",
        "message": "sample quarantined: non-finite or degenerate logits detected mid-decode",
    }


class GenerationResult(NamedTuple):
    tokens: np.ndarray  # [n, max_new] int32, pad_id after finish
    logprobs: np.ndarray  # [n, max_new] f32, 0.0 after finish
    lengths: np.ndarray  # [n] generated token counts (including the stop token)
    finish_reasons: List[str]  # "stop" | "length" per sample
    prompt_len: int
    top_tokens: Optional[np.ndarray] = None  # [n, max_new, k] int32
    top_logprobs: Optional[np.ndarray] = None  # [n, max_new, k] f32
    sample_errors: Optional[List[Optional[Dict[str, Any]]]] = None


class GenRequestSpec(NamedTuple):
    """One request's slice of a coalesced decode batch."""

    prompt_ids: List[int]
    n: int = 1
    seed: Optional[int] = None
    budget: Optional[RequestBudget] = None


class LocalEngine:
    """Owns the parameters on one device, the page pool, and the decode."""

    def __init__(
        self,
        config: ModelConfig | str,
        params: Optional[Dict[str, Any]] = None,
        param_seed: int = 0,
        device=None,
        kv_page_size: int = 64,
        paged_attention_impl: str = "auto",
    ):
        self.config = get_config(config) if isinstance(config, str) else config
        check_supported(self.config)
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(param_seed))
            params = init_params(self.config, gen, self.device)
        self.params = params
        self.kv_page_size = int(kv_page_size)
        self.paged_attention_impl = resolve_paged_attention_impl(
            paged_attention_impl, device=self.device
        )
        self._kv_pool: Optional[PagedKVPool] = None
        self.quarantine_stats: Dict[str, int] = {"samples": 0, "launches": 0}
        # Host-clock phase times of the last generate_many launch (seconds),
        # fenced by a device synchronise at each phase end.
        self.last_launch_stats: Dict[str, Any] = {}

    def param_footprint_bytes(self) -> int:
        total = 0
        for t in [self.params["embed"], self.params["final_norm"], self.params["lm_head"]]:
            total += t.numel() * t.element_size()
        for t in self.params["layers"].values():
            total += t.numel() * t.element_size()
        return total

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- prompt prep and prefill ------------------------------------------
    def _prep_prompt(self, prompt_ids: Sequence[int]) -> Tuple[List[int], int, int]:
        """BOS fallback, left-truncate to max_seq_len, power-of-two bucket.
        Returns (ids, prompt_len, bucket)."""
        config = self.config
        ids = list(prompt_ids)
        if not ids:
            ids = [config.bos_token_id]
        if len(ids) > config.max_seq_len:
            logger.warning(
                "prompt of %d tokens exceeds max_seq_len=%d; left-truncating",
                len(ids), config.max_seq_len,
            )
            ids = ids[-config.max_seq_len:]
        prompt_len = len(ids)
        bucket = min(_bucket(prompt_len, minimum=32), config.max_seq_len)
        return ids, prompt_len, bucket

    @torch.inference_mode()
    def _prefill_full(self, prompt_ids: List[int], prompt_len: int, bucket: int):
        tokens = torch.tensor(
            [prompt_ids + [self.config.pad_token_id] * (bucket - prompt_len)],
            dtype=torch.int64, device=self.device,
        )
        return prefill(self.config, self.params, tokens, prompt_len)

    # -- paged KV pool -----------------------------------------------------
    def _ensure_kv_pool(self, min_pages: int = 0) -> PagedKVPool:
        """The engine's page pool, at least ``min_pages`` pages. Nothing
        outlives a launch in the pool (there is no prefix cache yet), so a
        pool too small for a launch is replaced by a larger one between
        launches."""
        need = max(int(min_pages), 8)
        pool = self._kv_pool
        if pool is None or pool.allocator.total_pages < need:
            self._kv_pool = None  # free the old pool before allocating
            pool = PagedKVPool(self.config, need, self.kv_page_size, self.device)
            self._kv_pool = pool
        return pool

    def _run_from_dense(self, prefix, plen: int, bucket: int) -> PagedPrefixRun:
        """Copy a dense prefill result ((k, v) [L, 1, bucket, KVH, D]) into
        freshly allocated pages; positions past the prompt go to the trash
        page."""
        pool = self._ensure_kv_pool()
        ps = pool.page_size
        pages = pool.allocator.alloc(pages_for(plen, ps))
        idx = flat_slots(pages, np.arange(bucket), ps)
        idx[plen:] = (np.arange(bucket) % ps + TRASH_PAGE * ps)[plen:]
        pool.scatter_tokens(prefix[0][:, 0], prefix[1][:, 0], idx)
        return PagedPrefixRun(pool, pages, plen, bucket)

    def paged_admit_prefix(self, prompt_ids: List[int], prompt_len: int, bucket: int):
        """Prefill the prompt and copy its KV into a page run. Returns
        ``(first_logits [1, V], run, transient)``; with no prefix cache the
        run is always transient (the caller releases it after pinning)."""
        first_logits, prefix = self._prefill_full(prompt_ids, prompt_len, bucket)
        run = self._run_from_dense(prefix, prompt_len, bucket)
        return first_logits, run, True

    # -- host-side arrays ---------------------------------------------------
    def _stop_array(self, stop_sequences) -> Tuple[torch.Tensor, bool]:
        requested = [list(map(int, s)) for s in (stop_sequences or [])]
        seqs = [s for s in requested if 0 < len(s) <= MAX_STOP_LEN][:MAX_STOP_SEQS]
        if len(seqs) < len([s for s in requested if s]):
            logger.warning(
                "%d stop sequence(s) dropped (device matching supports up to %d "
                "sequences of <= %d tokens)",
                len([s for s in requested if s]) - len(seqs), MAX_STOP_SEQS, MAX_STOP_LEN,
            )
        arr = np.full((MAX_STOP_SEQS, MAX_STOP_LEN), -1, np.int64)
        for i, s in enumerate(seqs):
            arr[i, MAX_STOP_LEN - len(s):] = s
        return torch.as_tensor(arr, device=self.device), bool(seqs)

    def _bias_array(self, logit_bias: Optional[Dict[int, float]]) -> torch.Tensor:
        v = np.zeros((self.config.vocab_size,), np.float32)
        for tok, bias in (logit_bias or {}).items():
            t = int(tok)
            if not 0 <= t < self.config.vocab_size:
                raise ValueError(
                    f"logit_bias token id {t} outside vocab (0..{self.config.vocab_size - 1})"
                )
            v[t] = float(bias)
        return torch.as_tensor(v, device=self.device)

    # -- public API ---------------------------------------------------------
    def generate(self, prompt_ids: Sequence[int], n: int = 1, seed: Optional[int] = None,
                 **kwargs) -> GenerationResult:
        """One request: :meth:`generate_many` with a single item."""
        out = self.generate_many([GenRequestSpec(list(prompt_ids), n, seed)], **kwargs)[0]
        if isinstance(out, BaseException):
            raise out
        return out

    @torch.inference_mode()
    def generate_many(
        self,
        items: Sequence[GenRequestSpec],
        *,
        max_new_tokens: int = 128,
        temperature: float = 1.0,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        eos_ids: Optional[Sequence[int]] = None,
        top_logprobs: Optional[int] = None,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        logit_bias: Optional[Dict[int, float]] = None,
        stop_sequences: Optional[Sequence[Sequence[int]]] = None,
    ) -> List[Any]:
        """Decode several same-config requests as one batch against the page
        pool. Returns one GenerationResult per item (or the exception a
        member's spent budget raised)."""
        if not items:
            return []
        config = self.config
        device = self.device
        t_start = time.perf_counter()
        for it in items:
            if it.budget is not None:
                it.budget.check("engine prefill")
        eos = list(eos_ids or [config.eos_token_id])[:MAX_EOS_IDS]
        eos_t = torch.as_tensor(eos, device=device)
        preps = [self._prep_prompt(it.prompt_ids) for it in items]
        n_per = max(max(1, it.n) for it in items)
        r_pad = _bucket(len(items), minimum=1)
        extra = r_pad - len(items)
        B = r_pad * n_per
        bucket_max = max(bucket for _, _, bucket in preps)
        live = [i for j, it in enumerate(items) for i in range(j * n_per, j * n_per + max(1, it.n))]
        gp = pages_for(max_new_tokens, self.kv_page_size)
        pool = self._ensure_kv_pool(
            min_pages=sum(pages_for(p, self.kv_page_size) for _, p, _ in preps)
            + len(live) * gp + 1
        )
        ps = pool.page_size

        pinned: List[PagedPrefixRun] = []
        gen_pages_rows: List[Optional[List[int]]] = [None] * B
        try:
            first_list = []
            for ids, prompt_len, bucket in preps:
                fl, run, transient = self.paged_admit_prefix(ids, prompt_len, bucket)
                run.retain()
                if transient:
                    run.release()
                pinned.append(run)
                first_list.append(fl)
            self._sync()
            t_prefill = time.perf_counter()
            for row in live:
                gen_pages_rows[row] = pool.allocator.alloc(gp)

            # Block tables: prefix_idx is request-level [r_pad, P]; positions
            # past each prompt, and every dead row's gen slots, point into the
            # trash page.
            trash = (np.arange(bucket_max) % ps + TRASH_PAGE * ps).astype(np.int64)
            prefix_np = np.empty((r_pad, bucket_max), np.int64)
            for j, run in enumerate(pinned):
                row_idx = flat_slots(run.pages, np.arange(bucket_max), ps)
                row_idx[run.plen:] = trash[run.plen:]
                prefix_np[j] = row_idx
            if extra:
                prefix_np[len(items):] = prefix_np[len(items) - 1]
            trash_gen = (np.arange(max_new_tokens) % ps + TRASH_PAGE * ps).astype(np.int64)
            gen_np = np.empty((B, max_new_tokens), np.int64)
            for row in range(B):
                pgs = gen_pages_rows[row]
                gen_np[row] = flat_slots(pgs, np.arange(max_new_tokens), ps) if pgs else trash_gen
            first_list += [first_list[-1]] * extra
            first_logits = torch.cat(first_list, dim=0)  # [r_pad, V]
            lens = [p for _, p, _ in preps] + [preps[-1][1]] * extra
            seeds = [
                it.seed if it.seed is not None else int.from_bytes(os.urandom(4), "little")
                for it in items
            ]
            generators = None
            if temperature != 0.0:
                generators = [
                    torch.Generator(device=device).manual_seed(int(s)) for s in seeds
                ] + [None] * extra
            stops, use_stops = self._stop_array(stop_sequences)
            with pool.lock:
                out = self._decode(
                    pool, torch.as_tensor(prefix_np, device=device),
                    torch.as_tensor(gen_np, device=device),
                    torch.as_tensor(lens, device=device), first_logits, n_per, r_pad,
                    [max(1, it.n) for it in items] + [0] * extra, generators,
                    max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                    top_k=top_k, eos_t=eos_t, top_logprobs=top_logprobs,
                    frequency_penalty=frequency_penalty, presence_penalty=presence_penalty,
                    bias=self._bias_array(logit_bias) if logit_bias else None,
                    stops=stops if use_stops else None,
                )
        finally:
            for run in pinned:
                pool.allocator.decref(run.pages)
            for pgs in gen_pages_rows:
                if pgs is not None:
                    pool.allocator.decref(pgs)
        toks_np, lps_np, done_np, tt_np, tl_np, pois_np, steps = out
        t_end = time.perf_counter()
        self.last_launch_stats = {
            "prefill_s": t_prefill - t_start,
            "decode_s": t_end - t_prefill,
            "decode_steps": steps,
            "rows": B,
            "live_rows": len(live),
        }

        results: List[Any] = []
        for j, (it, (_, prompt_len, _)) in enumerate(zip(items, preps)):
            lo, n_j = j * n_per, max(1, it.n)
            t = toks_np[lo: lo + n_j]
            res = GenerationResult(
                tokens=t,
                logprobs=lps_np[lo: lo + n_j],
                lengths=(t != config.pad_token_id).sum(axis=1).astype(np.int32),
                finish_reasons=["stop" if d else "length" for d in done_np[lo: lo + n_j]],
                prompt_len=prompt_len,
                top_tokens=tt_np[lo: lo + n_j] if top_logprobs else None,
                top_logprobs=tl_np[lo: lo + n_j] if top_logprobs else None,
            )
            res = self._quarantine_result(res, pois_np[lo: lo + n_j])
            if it.budget is not None and it.budget.should_abort():
                results.append(it.budget.error("engine decode"))
            else:
                results.append(res)
        poisoned = int(pois_np[np.asarray(live, np.int64)].sum())
        if poisoned:
            self.quarantine_stats["samples"] += poisoned
            self.quarantine_stats["launches"] += 1
            logger.warning("numeric poison: %d/%d decode row(s) quarantined", poisoned, len(live))
        return results

    def _quarantine_result(self, result: GenerationResult, pois_rows: np.ndarray) -> GenerationResult:
        killed = np.flatnonzero(pois_rows[: result.tokens.shape[0]])
        if killed.size == 0:
            return result
        toks, lps, lengths = result.tokens.copy(), result.logprobs.copy(), result.lengths.copy()
        errs = list(result.sample_errors) if result.sample_errors else [None] * toks.shape[0]
        for i in killed:
            toks[i, :] = self.config.pad_token_id
            lps[i, :] = 0.0
            lengths[i] = 0
            errs[i] = _quarantine_error()
        return result._replace(tokens=toks, logprobs=lps, lengths=lengths, sample_errors=errs)

    def _decode(
        self, pool, prefix_idx, gen_idx, prompt_lens, first_logits, n_per, r_pad, rows,
        generators, *, max_new_tokens, temperature, top_p, top_k, eos_t, top_logprobs,
        frequency_penalty, presence_penalty, bias, stops,
    ):
        """The decode loop over ``B = r_pad * n_per`` rows. Returns numpy
        (tokens, logprobs, done, top ids, top logprobs, poisoned, steps)."""
        config = self.config
        device = self.device
        pad_id = config.pad_token_id
        B = r_pad * n_per
        V = first_logits.shape[-1]
        impl = self.paged_attention_impl
        # pad_id must never be sampled on a live row, unless it doubles as eos.
        pad_col = 0.0 if bool((eos_t == pad_id).any()) else -float("inf")
        penalized = frequency_penalty != 0.0 or presence_penalty != 0.0
        K = top_logprobs or 0

        def sample(logits, counts):
            pen = None
            if penalized:
                pen = frequency_penalty * counts + presence_penalty * (counts > 0).float()
            if bias is not None:
                pen = -bias[None, :] if pen is None else pen - bias[None, :]
            noise = None
            if generators is not None:
                noise = draw_noise(generators, rows, n_per, V, device)
            return sample_logits(
                logits, temperature=temperature, top_p=top_p, top_k=top_k,
                noise=noise, penalty=pen,
            )

        def prepare(logits, done):
            logits = logits.clone()
            logits[:, pad_id] += pad_col
            bad = _poisoned_logits(logits) & ~done
            logits = torch.where(bad[:, None], torch.zeros_like(logits), logits)
            return logits, bad

        counts = torch.zeros((B, V if penalized else 0), dtype=torch.float32, device=device)
        logits0 = first_logits.repeat_interleave(n_per, dim=0)  # [B, V]
        done = torch.zeros(B, dtype=torch.bool, device=device)
        logits0, bad = prepare(logits0, done)
        tok, lp = sample(logits0, counts)
        tok = torch.where(bad, torch.full_like(tok, pad_id), tok)
        lp = torch.where(bad, torch.zeros_like(lp), lp)
        done = torch.isin(tok, eos_t) | bad
        pois = bad.clone()
        tok_steps, lp_steps, tt_steps, tl_steps = [tok], [lp], [], []
        if K:
            ids, vals = model_top_logprobs(logits0, K)
            tt_steps.append(ids)
            tl_steps.append(vals)
        if penalized:
            counts[torch.arange(B, device=device), tok] += 1.0
        if stops is not None:
            recent = torch.full((B, MAX_STOP_LEN), -1, dtype=torch.int64, device=device)
            recent[:, -1] = tok
            done = done | stop_window_match(recent, stops)

        step = 0
        while step < max_new_tokens - 1 and not bool(done.all()):
            logits, k_cols, v_cols = paged_verify_step(
                config, self.params, tok[:, None],
                torch.full((B,), step, dtype=torch.int64, device=device),
                prompt_lens, pool.k, pool.v, prefix_idx, gen_idx,
                attn_impl=impl, page_size=pool.page_size,
            )
            # This step's column goes into the pool after the step, at gen
            # slot ``step`` of every row (dead rows write the trash page).
            slots = gen_idx[:, step]
            pool.k[:, slots] = k_cols
            pool.v[:, slots] = v_cols
            logits, bad = prepare(logits[:, 0], done)
            frozen = done | bad
            nxt, lp = sample(logits, counts)
            nxt = torch.where(frozen, torch.full_like(nxt, pad_id), nxt)
            lp = torch.where(frozen, torch.zeros_like(lp), lp)
            tok_steps.append(nxt)
            lp_steps.append(lp)
            if K:
                ids, vals = model_top_logprobs(logits, K)
                tt_steps.append(ids)
                tl_steps.append(vals)
            if penalized:
                counts[torch.arange(B, device=device), nxt] += (~frozen).float()
            done = frozen | torch.isin(nxt, eos_t)
            pois = pois | bad
            if stops is not None:
                recent = torch.cat([recent[:, 1:], nxt[:, None]], dim=1)
                done = done | stop_window_match(recent, stops)
            tok = nxt
            step += 1

        n_steps = len(tok_steps)
        toks = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32, device=device)
        lps = torch.zeros((B, max_new_tokens), dtype=torch.float32, device=device)
        toks[:, :n_steps] = torch.stack(tok_steps, dim=1).to(torch.int32)
        lps[:, :n_steps] = torch.stack(lp_steps, dim=1)
        tt = tl = None
        if K:
            tt = torch.zeros((B, max_new_tokens, K), dtype=torch.int32, device=device)
            tl = torch.zeros((B, max_new_tokens, K), dtype=torch.float32, device=device)
            tt[:, :n_steps] = torch.stack(tt_steps, dim=1).to(torch.int32)
            tl[:, :n_steps] = torch.stack(tl_steps, dim=1)
        self._sync()

        def host(t):
            return None if t is None else t.cpu().numpy()

        return (
            host(toks), host(lps), host(done), host(tt), host(tl), host(pois), n_steps - 1,
        )

    # -- embeddings (similarity side-channel) -----------------------------
    @torch.inference_mode()
    def embed_tokens(self, token_lists: List[List[int]], max_tokens: int = 512) -> np.ndarray:
        """Mean-pooled final hidden states."""
        config = self.config
        token_lists = [ids[:max_tokens] or [config.bos_token_id] for ids in token_lists]
        longest = max(len(ids) for ids in token_lists)
        bucket = _bucket(longest, minimum=32)
        batch = _bucket(len(token_lists), minimum=8)
        tokens = np.full((batch, bucket), config.pad_token_id, np.int64)
        mask = np.zeros((batch, bucket), np.int64)
        for i, ids in enumerate(token_lists):
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        tokens_t = torch.as_tensor(tokens, device=self.device)
        mask_t = torch.as_tensor(mask, device=self.device)
        hidden = encode(config, self.params, tokens_t, mask_t)
        m = mask_t[:, :, None].float()
        pooled = (hidden.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return pooled[: len(token_lists)].cpu().numpy()
