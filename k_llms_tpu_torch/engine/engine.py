"""Local inference engine: n-way consensus sampling as one batched decode.

Counterpart of ``k_llms_tpu/engine/engine.py``. Each request's prompt is
prefilled once at batch=1 (the flash kernel), and the n samples of every
request decode together as one batch, rows request-major
(``B = r_pad * n_per``), in one of two KV layouts:

- ``kv_layout="paged"`` (this engine's default): the prompt's KV is copied
  into pool pages and rows decode against shared block tables (the
  paged-decode kernel). Padding rows and dead rows point their gen slots at
  the trash page.
- ``kv_layout="dense"`` (the JAX engine's default): the prompts' KV are
  padded to one bucket and stacked into a shared ``[L, R, P, KVH, D]``
  prefix, each row keeps a dense cache of its generated tokens, and
  ``models.llama.decode_step`` attends both (with
  ``decode_attention_impl="flash"``, the decode-prefix kernel).

Both run the same host loop of steps (``_decode``, parameterized by a step
function) that ends when every row is done: EOS and stop sequences, pad
after done, per-token logprobs, frequency/presence penalties and logit bias,
optional top logprobs, quarantine of rows whose logits go non-finite,
grammar constraints (``constraint=``: the JSON automaton, a schema DFA, a
token table or a compiled grammar, masked and advanced on the device every
step, as ``_constraint_ops`` sets out), and seeded draws equal to the JAX
engine's (``ops/random.py``; the threefry kernel on a card).
Weights may be quantized (``quantize="int8"|"int4"``; int4 matmuls run the
w4a16 kernel).

With ``prefix_cache_size > 0`` each prompt's prefill goes through the
prompt-prefix cache (an LRU over full prompts, the JAX engine's): an exact
hit costs no device work, a partial hit past ``prefix_cache_min_reuse``
prefills only the suffix (``models.llama.prefill_continue``), and a miss
prefills in full; the prompt's KV is then stored back, as a run of pool
pages on the paged layout (siblings extending one prefix share its full
pages) or as a dense prefix. The page pool is then sized once, as in the JAX
engine, and never replaced while an entry may hold its pages: under
pressure LRU paged entries are evicted, and a paged launch that still finds
the pool short falls back to the dense body.

Launches (``generate_many``, ``embed_tokens``) run one at a time under the
engine's launch lock, and under ``torch.cuda.device(engine.device)``, so a
launch from a scheduler or watchdog thread lands on the engine's card. The
backend's scheduler already serialises its launches on one worker; the lock
keeps direct callers, such as ``AsyncKLLMs`` requests gathered together
outside a backend, waiting their turn, and a paged launch keeps the pool it
picked until its last page is freed. The same lock stands in for the JAX
engine's ``_paged_mutex``: every prefix-cache read and write, and every page
allocation, happens under it.

The JAX engine's fault handling is carried over: ``generate_many`` splits a
group that runs out of device memory in half and retries each half
(``MAX_OOM_SPLITS``, ``oom_stats``, the ``on_oom``/``on_launch_ok`` hooks),
a member's failure is an element of the returned list, every decode step
polls the members' budgets on the host and freezes the rows of a member
that was cancelled or ran out of time (the abort poller), and the
``engine.launch``, ``engine.decode`` (``kill_samples``) and ``engine.logits``
(``nan``) failpoints fire where they do in JAX; ``on_quarantine(poisoned,
total)`` is called after every launch.

A member's ``token_sink`` (the streaming tap) receives its rows' tokens of
every decode step, in step order, exactly once; the copy to the host is
made only when some member of the launch streams.

The continuous decode loop (``engine/continuous.py``) drives this engine's
prefill, its prefix cache and its page pool between its own steps; it pins
the pool once it is built.

With ``speculative="prompt_lookup"`` a launch decodes by prompt-lookup
speculation instead (``_spec_decode``, the JAX engine's spec loop): each
row drafts ``spec_lookahead`` tokens from its own request's prompt and its
generated text, one verify forward scores them, and the longest confirmed
run is emitted, with the same composition with grammar, penalties, logit
bias, stops, top logprobs, the quarantine and the abort poller. Such
launches decode dense whatever the engine's layout, as in JAX, and have no
token tap (a streamed request gets each sample's text at the end). Solo
results carry ``spec_stats`` with drafted/accepted counts; coalesced ones
their iterations and rate, with the launch's totals in ``engine.spec_stats``.

On a mesh (``parallel/``) the engine is one rank of an SPMD program:
every rank builds the same engine and makes the same calls in the same
order. ``torch.distributed`` started with a world larger than 1 gives the
engine ``auto_mesh(model_parallel)``, as more than one device gives the JAX
engine its mesh; a world of one builds none, and the mesh fields then
change nothing. Each rank holds its shard of the weights
(``parallel.shard_params``; the Megatron layout, int4 leaves marked for
``w4_matmul_tp``) and of the KV (KVH/TP heads, in the page pool too), and
keeps the decode rows whole; n is padded to a multiple of the data axis, as
the JAX engine pads it, so the draws' rows line up. Prompts of at least
``sp_prefill_min_tokens`` prefill sequence-parallel over the data axis
(``engine/long_context.py``, ring or Ulysses attention); with
``sp_decode`` a solo request keeps that KV sequence-sharded and decodes
against it by ring attention (the ``sp_resident`` route), its prefix-cache
entries labelled as such and never cross-matched with replicated ones.
Every host decision must come out the same on every rank; with
``rank_check`` (``KLLMS_RANK_CHECK=1``) each step's tokens are compared
across ranks and a divergence raises.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import random as _pyrandom
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.lockcheck import make_rlock, note_device_dispatch, race_exempt
from ..models.config import ModelConfig, get_config
from ..models.llama import (
    KVCache,
    check_supported,
    decode_step,
    encode,
    init_cache,
    init_params,
    paged_verify_step,
    prefill,
    prefill_continue,
    verify_step,
)
from ..models.quant import (
    init_params_quantized,
    int4_mesh_compatible,
    int4_off_kernel_shards,
    mark_int4_partitioning,
    quantize_params,
    stored_quant_layout,
    tree_has_q4,
)
from ..ops.paged_attention import launch_paged_attention_impl, resolve_paged_attention_impl
from ..ops.random import request_keys, threefry_uniform_verify
from ..ops.sampling import draw_noise, model_top_logprobs, sample_logits
from ..ops.speculative import accept_drafts, propose_prompt_lookup, scatter_rows, scatter_rows_k
from ..ops.w4matmul import Q4Tensor
from ..parallel.collectives import assert_ranks_agree
from ..parallel.distributed import world_size
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, auto_mesh
from ..parallel.sharding import param_specs, shard_node, shard_params
from ..reliability import failpoints as _failpoints
from ..reliability.deadline import RequestBudget
from ..types.wire import BackendUnavailableError, KLLMsError
from ..utils.observability import FAILURE_EVENTS, QUARANTINE_EVENTS
from .long_context import SeqShardedKV, forward_sp_continuation, gather_sequence, sp_prefill
from .paging import (
    TRASH_PAGE,
    PagedKVPool,
    PagedPrefixRun,
    PagePoolExhausted,
    flat_slots,
    pages_for,
)

logger = logging.getLogger(__name__)

MAX_EOS_IDS = 4
MAX_STOP_SEQS = 4
MAX_STOP_LEN = 8
# Device-OOM recovery: a coalesced launch that runs out of device memory is
# split in half and retried, recursively, at most this many levels deep.
MAX_OOM_SPLITS = 5

#: The allocator's out-of-memory exception (``torch.OutOfMemoryError`` is
#: its alias where the installed torch has one).
_TORCH_OOM = (
    torch.cuda.OutOfMemoryError,
    getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError),
)


def is_resource_exhausted(e: BaseException) -> bool:
    """Is this the device's out-of-memory signal? The caching allocator
    raises ``torch.cuda.OutOfMemoryError``; the ``oom`` failpoint raises the
    JAX package's ``RESOURCE_EXHAUSTED`` message, matched on its marker.
    Typed lifecycle errors are never OOM even if a message embeds the
    marker."""
    if isinstance(e, KLLMsError):
        return False
    if isinstance(e, _TORCH_OOM):
        return True
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg


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


def _constraint_ops(constraint, device):
    """Uniform grammar-automaton interface for the decode loop: returns
    ``(tables, initial_state, mask_logits, advance)`` with the tables on
    ``device``, where state is always a tuple (splat into mask/advance), or
    None when unconstrained."""
    if constraint is None:
        return None
    from .token_constraint import TokenConstraint

    if constraint == "json":
        from .json_constraint import advance, device_tables, initial_state, mask_logits

        return (
            device_tables(device),
            lambda n: initial_state(n, device=device),
            mask_logits,
            advance,
        )
    if isinstance(constraint, TokenConstraint):
        from .token_constraint import (
            device_token_table,
            token_advance,
            token_initial_state,
            token_mask_logits,
        )

        jt = device_token_table(constraint, device=device)
        return (
            jt,
            lambda n: (token_initial_state(jt, n),),
            token_mask_logits,
            lambda t, tok, state: (token_advance(t, tok, state),),
        )
    from .grammar import CompiledGrammar

    if isinstance(constraint, CompiledGrammar):
        from .grammar import (
            device_grammar,
            grammar_advance,
            grammar_initial_state,
            grammar_mask_logits,
        )

        jt = device_grammar(constraint, device=device)
        return (
            jt,
            lambda n: (grammar_initial_state(jt, n),),
            grammar_mask_logits,
            lambda t, tok, state: (grammar_advance(t, tok, state),),
        )
    from .schema_constraint import (
        device_dfa,
        dfa_advance,
        dfa_initial_state,
        dfa_mask_logits,
    )

    jt = device_dfa(constraint, device=device)
    return (
        jt,
        lambda n: (dfa_initial_state(jt, n),),
        dfa_mask_logits,
        lambda t, tok, state: (dfa_advance(t, tok, state),),
    )


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _kill_sample_errors(n: int, fp: "_failpoints.FailSpec") -> List[Optional[Dict[str, Any]]]:
    """Seeded selection of which of a request's n samples an injected
    ``engine.decode`` kill_samples failpoint loses."""
    rng = _pyrandom.Random(fp.seed)
    idx = rng.sample(range(n), min(fp.kill, n))
    errs: List[Optional[Dict[str, Any]]] = [None] * n
    for i in idx:
        errs[i] = {
            "type": "server_error",
            "code": "decode_fault",
            "message": "sample lost mid-decode (injected failpoint engine.decode)",
        }
    return errs


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
    # This request's speculative-decoding stats, captured at generation time
    # ({} for a launch without speculation; engine.spec_stats mirrors the
    # latest launch, but a concurrent trace must read this field).
    spec_stats: Optional[Dict[str, Any]] = None


def _spec_acceptance_stats(
    count_np: np.ndarray, iters_np: np.ndarray, lookahead: int = 0
) -> Dict[str, Any]:
    """Acceptance over a slice of rows: tokens each row emitted per verify
    it entered (1.0 = no draft ever accepted). The first token comes from
    the prefill's logits, not a verify (hence ``count - 1``). One source for
    the solo launch, the coalesced per-request slices and the engine's
    mirror. With ``lookahead`` (K, drafts proposed per verify) the dict also
    carries ``drafted`` (K per verify entered) and ``accepted`` (emitted
    tokens beyond the one each verify yields for free)."""
    rates = (count_np - 1.0) / np.maximum(iters_np, 1)
    ran = iters_np > 0
    emitted = np.maximum(count_np - 1, 0)
    stats: Dict[str, Any] = {
        "verify_iterations": int(iters_np.max(initial=0)),
        "tokens_per_iteration": (
            round(float(rates[ran].mean()), 3) if ran.any() else None
        ),
    }
    if lookahead:
        stats["drafted"] = int(iters_np.sum()) * int(lookahead)
        stats["accepted"] = int(np.maximum(emitted - iters_np, 0).sum())
    return stats


class GenRequestSpec(NamedTuple):
    """One request's slice of a coalesced decode batch."""

    prompt_ids: List[int]
    n: int = 1
    seed: Optional[int] = None
    # Lifecycle budget (deadline + cancel token); not part of the scheduler's
    # batch key: each member's rows abort on their own.
    budget: Optional[RequestBudget] = None
    # Streaming tap: called as ``sink(step, token_ids[n_per])`` for each
    # decode step of this request's rows, in step order, exactly once. Like
    # budget, not part of the batch key: streaming and non-streaming
    # requests coalesce into one launch.
    token_sink: Optional[Callable[[int, np.ndarray], None]] = None


def _one_launch_at_a_time(method):
    """Run an engine method under the engine's launch lock, with the
    engine's card as the calling thread's current device (a scheduler or
    watchdog thread starts on card 0). Work is issued on that card's default
    stream, the one stream the kernels' arrival semaphores assume
    (``ops/_ext.py``)."""

    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        on_card = (
            torch.cuda.device(self.device)
            if self.device.type == "cuda"
            else contextlib.nullcontext()
        )
        with self._launch_lock, on_card:
            return method(self, *args, **kwargs)

    return locked


KV_LAYOUTS = ("dense", "paged")
QUANTIZATIONS = (None, "int8", "int4")


class LocalEngine:
    """Owns the parameters on one device, the page pool, and the decode."""

    def __init__(
        self,
        config: ModelConfig | str,
        params: Optional[Dict[str, Any]] = None,
        param_seed: int = 0,
        device=None,
        quantize: "bool | str | None" = None,
        kv_layout: str = "paged",
        kv_page_size: int = 64,
        paged_attention_impl: str = "auto",
        prefix_cache_size: int = 0,
        prefix_cache_min_reuse: int = 32,
        kv_pool_pages: Optional[int] = None,
        speculative: Optional[str] = None,
        spec_lookahead: int = 4,
        mesh: Optional[Mesh] = None,
        model_parallel: Optional[int] = None,
        use_mesh: bool = True,
        sp_prefill_min_tokens: Optional[int] = None,
        sp_attention: str = "ring",
        sp_decode: bool = False,
    ):
        self.config = get_config(config) if isinstance(config, str) else config
        check_supported(self.config)
        self.device = resolve_device(device)
        # Validated eagerly: a typo must fail at construction, not on the
        # first long prompt.
        if sp_attention not in ("ring", "ulysses"):
            raise ValueError(
                f"Unknown sp_attention {sp_attention!r}; use 'ring' or 'ulysses'"
            )
        if mesh is None and use_mesh and world_size() > 1:
            mesh = auto_mesh(model_parallel=model_parallel)
        self.mesh = mesh
        if quantize is True:
            quantize = "int8"
        quantize = quantize or None
        if quantize not in QUANTIZATIONS:
            raise ValueError(f"Unknown quantize {quantize!r}; use 'int8' or 'int4'")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"Unknown kv_layout {kv_layout!r}; use 'dense' or 'paged'")
        if params is not None:
            # A pre-quantized tree keeps its stored layout whatever was asked.
            quantize = stored_quant_layout(params) or quantize
        tp = mesh.shape[MODEL_AXIS] if mesh is not None else 1
        if mesh is not None and quantize:
            # The JAX engine's int4 mesh check, before any shard is cut.
            stored_q4 = params is not None and tree_has_q4(params)
            int4_ok = True
            if quantize == "int4" or stored_q4:
                int4_ok = int4_mesh_compatible(self.config, tp)
            if stored_q4 and not int4_ok:
                raise ValueError(
                    f"checkpoint stores int4 weights whose quantization groups "
                    f"cannot shard over model parallel={tp} for {self.config.name}; "
                    "re-quantize to int8 or change the mesh"
                )
            if quantize == "int4" and not stored_q4 and not int4_ok:
                logger.warning(
                    "int4 shards don't align with model parallel=%s for %s; using int8",
                    tp, self.config.name,
                )
                quantize = "int8"
        # K4 takes no shard that misses its blocking, and the port has no
        # dequantize fallback: on a card such a weight stays int8.
        int8_keys = frozenset()
        if quantize == "int4" and self.device.type == "cuda":
            off = int4_off_kernel_shards(self.config, tp)
            stored = [k for k in off if params is not None and isinstance(
                params[k] if k == "lm_head" else params["layers"][k], Q4Tensor)]
            if stored:
                raise ValueError(
                    f"checkpoint stores int4 weights {stored} whose model parallel={tp} "
                    f"shards {[off[k] for k in stored]} miss the w4a16 kernel's blocking "
                    "(K % 256, N % 128); re-quantize to int8 or change the mesh"
                )
            if off:
                logger.warning(
                    "int4 on model parallel=%d for %s: local shards %s miss the w4a16 "
                    "kernel's blocking (K %% 256, N %% 128); keeping them int8",
                    tp, self.config.name, off,
                )
            int8_keys = frozenset(off)
        bits = 4 if quantize == "int4" else 8
        shard = None
        if mesh is not None:
            self._check_mesh_divides(tp)
            specs = param_specs(self.config)
            flat = {**specs["layers"], **{k: v for k, v in specs.items() if k != "layers"}}

            def shard(key, leaf):
                return shard_node(leaf, flat[key], mesh)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(param_seed))
            if quantize:
                # Built directly: an 8B bf16 tree never exists beside its copy.
                params = init_params_quantized(self.config, gen, self.device, bits=bits,
                                               shard=shard, int8_keys=int8_keys)
            else:
                params = init_params(self.config, gen, self.device, shard=shard)
            if mesh is not None:
                params["mesh"] = mesh
        else:
            if quantize and stored_quant_layout(params) is None:
                params = quantize_params(params, bits=bits, int8_keys=int8_keys)
            if mesh is not None:
                params = shard_params(params, mesh, self.config)
        if tp > 1 and tree_has_q4(params):
            # A model axis of one has nothing to sum: K4 runs unmarked.
            params = mark_int4_partitioning(params, mesh)
        self.params = params
        self.quantized = quantize
        # The KV this rank holds: KVH/TP heads (and QH/TP query heads).
        self.kv_config = self.config.with_(
            num_heads=self.config.num_heads // tp, num_kv_heads=self.config.num_kv_heads // tp
        )
        # Sequence-parallel prefill: prompts of at least this many tokens
        # prefill over the data axis (None disables); "ring" or "ulysses"
        # attention; sp_decode keeps a solo request's KV sequence-sharded and
        # decodes against it by ring attention.
        self.sp_prefill_min_tokens = sp_prefill_min_tokens
        self.sp_attention = sp_attention
        self.sp_decode = bool(sp_decode)
        # The cross-rank token check (tests and the card smoke turn it on).
        self.rank_check = os.environ.get("KLLMS_RANK_CHECK", "") not in ("", "0")
        self.kv_layout = kv_layout
        self.kv_page_size = int(kv_page_size)
        self.paged_attention_impl = resolve_paged_attention_impl(
            paged_attention_impl, device=self.device, config=self.config
        )
        self.kv_pool_pages = kv_pool_pages
        # Published once under the launch lock by _ensure_kv_pool and never
        # replaced (a rebuild swaps the whole engine); unsynchronized readers
        # (health(), loop sizing) tolerate the pre-publish None via getattr.
        # kllms: unguarded — publish-once under the launch lock; readers tolerate None
        self._kv_pool: Optional[PagedKVPool] = None
        # Speculative decoding: "prompt_lookup" drafts the next
        # spec_lookahead tokens from the prompt's own text (and the row's
        # generated text) and verifies them in one forward
        # (ops/speculative.py). Opt-in; the sampling distribution is exact
        # at any temperature (sample-and-match acceptance).
        if speculative not in (None, "prompt_lookup"):
            raise ValueError(
                f"Unknown speculative mode {speculative!r}; use 'prompt_lookup'"
            )
        self.speculative = speculative
        self.spec_lookahead = max(1, int(spec_lookahead))
        # The latest launch's acceptance stats ({} after a launch without
        # speculation), and the backend's hook, called with them after every
        # speculative launch. Published whole-object after each launch,
        # snapshot via dict().
        # kllms: unguarded — best-effort counters; losses skew stats only
        self.spec_stats: Dict[str, Any] = {}
        self.on_spec_stats: Optional[Any] = None
        # Prompt-prefix KV cache (LRU over full prompts). 0 disables. Value:
        # (first_logits, prefix KVCache or PagedPrefixRun, prompt_len,
        # np.int32 token ids).
        self.prefix_cache_size = int(prefix_cache_size)
        self.prefix_cache_min_reuse = int(prefix_cache_min_reuse)
        self._prefix_entries: "OrderedDict[Tuple[int, ...], Tuple[Any, Any, int, np.ndarray]]" = (
            OrderedDict()
        )
        # Best-effort cache counters: a lost increment under concurrent
        # routes skews stats, never correctness; readers snapshot via dict().
        # kllms: unguarded — best-effort counters; losses skew stats only
        self.prefix_cache_stats = {"hits": 0, "partial_hits": 0, "misses": 0}
        # Held by every launch: a paged launch picks the page pool, fills it
        # and frees its pages under it, so no other launch replaces the pool
        # in between. It also stands in for the JAX engine's _paged_mutex
        # (and carries its lockcheck id): every prefix-cache read and write
        # and every page allocation runs under it (reentrant, so the cache
        # helpers take it inside a launch). allow_dispatch: the launch's
        # prefill and decode run under it on purpose.
        self._launch_lock = make_rlock("engine.paged_mutex", allow_dispatch=True)
        self.quarantine_stats: Dict[str, int] = {"samples": 0, "launches": 0}
        # Device-OOM recovery accounting and the backend's hooks: on_oom per
        # caught OOM, on_launch_ok after a clean launch, on_quarantine
        # (poisoned, total) after every launch.
        self.oom_stats: Dict[str, int] = {"splits": 0, "unrecovered": 0}
        self.on_oom: Optional[Any] = None
        self.on_launch_ok: Optional[Any] = None
        self.on_quarantine: Optional[Any] = None
        # Host-clock phase times of the last generate_many launch (seconds),
        # fenced by a device synchronise at each phase end.
        self.last_launch_stats: Dict[str, Any] = {}
        # The running launch's token sinks (one per member, None where a
        # member does not stream) and the tap's next step; published and
        # retracted per launch by the launching thread under the launch lock.
        # kllms: unguarded — single-writer publish; one launch in flight
        self._active_token_sinks: Optional[List[Any]] = None
        self._reset_tap_state()
        # Runtime twin of the annotations above: the lockset sanitizer
        # (KLLMS_RACECHECK=1) skips exactly the fields the static rule skips.
        race_exempt(
            self,
            "prefix_cache_stats",
            "spec_stats",
            "_active_token_sinks",
            "_tap_next",
            "_kv_pool",
        )

    def _check_mesh_divides(self, tp: int) -> None:
        """The port cuts exact shards (GSPMD would pad): the heads, the MLP
        width, the experts and the vocabulary must divide by the model
        axis."""
        c = self.config
        sizes = {"num_heads": c.num_heads, "num_kv_heads": c.num_kv_heads,
                 "intermediate_size": c.intermediate_size, "vocab_size": c.vocab_size}
        if c.num_experts > 0:
            sizes["num_experts"] = c.num_experts
        bad = {k: v for k, v in sizes.items() if v % tp}
        if bad:
            raise ValueError(f"{c.name}: {bad} do not divide over model parallel={tp}")

    @property
    def data_parallel_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

    def _check_ranks(self, tokens: torch.Tensor, what: str) -> None:
        """With ``rank_check`` on a mesh, raise unless every rank holds the
        same ``tokens``."""
        if self.rank_check and self.mesh is not None:
            assert_ranks_agree(tokens, self.mesh, what)

    def param_footprint_bytes(self) -> int:
        """Bytes of the resident parameters, quantized payloads and scales
        included."""

        def size(t) -> int:
            if hasattr(t, "nbytes") and callable(t.nbytes):
                return t.nbytes()
            return t.numel() * t.element_size()

        leaves = [self.params["embed"], self.params["final_norm"], self.params["lm_head"]]
        return sum(size(t) for t in leaves + list(self.params["layers"].values()))

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
        """One full-prompt prefill: (first logits [1, V], KVCache [L, 1,
        bucket, KVH, D]), dense or, when the prompt qualifies,
        sequence-parallel (the single dispatch point, as in JAX): its KV is
        then this rank's :class:`SeqShardedKV` chunk with ``sp_decode``, else
        gathered into the replicated layout."""
        tokens = torch.tensor(
            [prompt_ids + [self.config.pad_token_id] * (bucket - prompt_len)],
            dtype=torch.int64, device=self.device,
        )
        if self._use_sp_prefill(prompt_len, bucket):
            first_logits, kv = sp_prefill(
                self.config, self.params, tokens, prompt_len, self.mesh,
                seq_axis=DATA_AXIS, attention=self.sp_attention,
            )
            return first_logits, kv if self.sp_decode else gather_sequence(kv, self.mesh)
        first_logits, (k, v) = prefill(self.config, self.params, tokens, prompt_len)
        return first_logits, KVCache(k=k, v=v)

    def _use_sp_prefill(self, prompt_len: int, bucket: int) -> bool:
        config = self.config
        return (
            self.mesh is not None
            and self.sp_prefill_min_tokens is not None
            and prompt_len >= self.sp_prefill_min_tokens
            and self.mesh.shape[DATA_AXIS] > 1
            # The sequence-parallel forward needs S % ring == 0.
            and bucket % self.mesh.shape[DATA_AXIS] == 0
            and config.attn_softcap is None
            and config.sliding_window is None
        )

    def _replicated(self, kv):
        """A prefix KV in the replicated decode layout (a sequence-sharded
        one gathered: the reshard of the JAX ``generate_many``)."""
        if isinstance(kv, SeqShardedKV):
            return gather_sequence(kv, self.mesh)
        return kv

    def _prefill_routed(self, prompt_ids: List[int], prompt_len: int, bucket: int,
                        allow_seq_sharded: bool = False):
        """The prefill through the prefix cache when it is on. Its KV is in
        the replicated layout unless ``allow_seq_sharded``."""
        if self.prefix_cache_size > 0:
            fl, kv = self._prefill_with_cache(prompt_ids, prompt_len, bucket,
                                              allow_seq_sharded=allow_seq_sharded)
        else:
            fl, kv = self._prefill_full(prompt_ids, prompt_len, bucket)
        return fl, (kv if allow_seq_sharded else self._replicated(kv))

    @staticmethod
    def _kv_seq_sharded(kv) -> bool:
        """Whether a prefix KV is stored sequence-sharded, read from its
        type (the JAX engine reads the array's sharding): the label never
        desyncs from the layout it describes."""
        return isinstance(kv, SeqShardedKV)

    def _sp_prefill_routed(self, prompt_ids: List[int], prompt_len: int, bucket: int):
        """The sp_resident prefill through the prefix cache: an exact hit on
        a sequence-sharded entry costs no device work (a replicated entry
        for the same prompt is a miss, which the full SP prefill
        overwrites); a partial hit past the reuse threshold on a
        sequence-sharded entry continues in the ring layout
        (``forward_sp_continuation``); else the full SP prefill. The result
        is stored as a sequence-sharded entry."""
        config = self.config
        if not self.prefix_cache_size:
            return self._prefill_full(prompt_ids, prompt_len, bucket)
        key = tuple(prompt_ids)
        with self._launch_lock:
            hit = self._prefix_entries.get(key)
            if hit is not None and self._kv_seq_sharded(hit[1]):
                self._prefix_entries.move_to_end(key)
                self.prefix_cache_stats["hits"] += 1
                return hit[0], hit[1]
            matched_kv, p = self._sp_prefix_match(prompt_ids)
            if matched_kv is not None and p >= self.prefix_cache_min_reuse:
                s_bucket = _bucket(max(1, prompt_len - p), minimum=32)
                ring = self.mesh.shape[DATA_AXIS]
                in_bucket = int(matched_kv.k.shape[2]) * ring
                out_bucket = max(bucket, in_bucket)
                # The suffix self-attention holds an f32 score tensor [QH,
                # Ssuf, Ssuf] a layer; past the cap the full SP prefill is
                # the better program.
                continuation_ok = (
                    p + s_bucket <= config.max_seq_len
                    and out_bucket % ring == 0
                    and config.num_heads * s_bucket * s_bucket * 4 <= self.MAX_CONT_SCORE_BYTES
                )
                if continuation_ok:
                    self.prefix_cache_stats["partial_hits"] += 1
                    suffix = prompt_ids[p:]
                    suffix_tokens = torch.tensor(
                        [suffix + [config.pad_token_id] * (s_bucket - len(suffix))],
                        dtype=torch.int64, device=self.device,
                    )
                    first_logits, prefix = forward_sp_continuation(
                        config, self.params, suffix_tokens, matched_kv, self.mesh,
                        p, prompt_len, out_bucket, seq_axis=DATA_AXIS,
                    )
                    self._prefix_store(prompt_ids, first_logits, prefix)
                    return first_logits, prefix
            self.prefix_cache_stats["misses"] += 1
            first_logits, prefix = self._prefill_full(prompt_ids, prompt_len, bucket)
            self._prefix_store(prompt_ids, first_logits, prefix)
            return first_logits, prefix

    # -- prefix cache --------------------------------------------------------
    def prefix_cached_len(self, prompt_ids: List[int]) -> int:
        """How many leading tokens of ``prompt_ids`` the prefix cache can
        supply without device work: the full length on an exact hit, the
        common-prefix length on a partial hit past the reuse threshold, else
        0. A pure probe: no LRU bump, no stats, no device work."""
        if self.prefix_cache_size <= 0:
            return 0
        with self._launch_lock:
            if tuple(prompt_ids) in self._prefix_entries:
                return len(prompt_ids)
            _, p = self._prefix_match(list(prompt_ids))
        return p if p >= self.prefix_cache_min_reuse else 0

    def _prefix_store_paged_run(self, ids: List[int], first_logits, run: PagedPrefixRun) -> None:
        """Insert an already-scattered page run as a cache entry; the caller
        transfers one reference to the cache (released at once when the
        cache is off)."""
        with self._launch_lock:
            if self.prefix_cache_size <= 0:
                run.release()
                return
            self._prefix_insert(ids, first_logits, run)

    def _prefix_insert(self, ids: List[int], first_logits, stored) -> None:
        """Put an entry in the LRU (replacing one for the same prompt) and
        drop the oldest past ``prefix_cache_size``, releasing the page runs
        it lets go. Caller holds the launch lock."""
        key = tuple(ids)
        old = self._prefix_entries.get(key)
        if old is not None and isinstance(old[1], PagedPrefixRun):
            old[1].release()
        self._prefix_entries[key] = (first_logits, stored, len(ids), np.asarray(ids, np.int32))
        self._prefix_entries.move_to_end(key)
        while len(self._prefix_entries) > self.prefix_cache_size:
            _, evicted = self._prefix_entries.popitem(last=False)
            if isinstance(evicted[1], PagedPrefixRun):
                evicted[1].release()

    def _prefix_store(self, ids: List[int], first_logits, prefix: KVCache,
                      base_run: Optional[PagedPrefixRun] = None, base_len: int = 0) -> None:
        """Store a prefill's KV as the entry for ``ids``: on the paged layout
        a page run (sharing ``base_run``'s full pages below ``base_len``),
        falling back to the dense prefix when the pool is short, so
        correctness never depends on pages being available."""
        with self._launch_lock:
            stored = prefix
            if self.kv_layout == "paged" and not self._kv_seq_sharded(prefix):
                try:
                    stored = self._run_from_dense(
                        prefix, len(ids), int(prefix.k.shape[2]),
                        base_run=base_run, base_len=base_len,
                    )
                except PagePoolExhausted:
                    stored = prefix
            self._prefix_insert(ids, first_logits, stored)

    def _prefix_match(self, ids: List[int]) -> Tuple[Any, int]:
        """Longest common token prefix across cached prompts: the matched
        entry's KV and the usable common length, capped below the new
        prompt's length so there is always at least one suffix token to
        prefill. Sequence-sharded entries are skipped: the replicated
        continuation would gather the whole prefix (they continue in their
        own layout, :meth:`_sp_prefix_match`)."""
        return self._match_prefix_entries(ids, want_seq_sharded=False)

    def _sp_prefix_match(self, ids: List[int]) -> Tuple[Any, int]:
        """:meth:`_prefix_match` over the sequence-sharded entries only: the
        two layouts never cross-match."""
        return self._match_prefix_entries(ids, want_seq_sharded=True)

    def _match_prefix_entries(self, ids: List[int], want_seq_sharded: bool) -> Tuple[Any, int]:
        ids_np = np.asarray(ids, np.int32)
        best_kv, best_p = None, 0
        with self._launch_lock:
            for _, kv, plen, arr in self._prefix_entries.values():
                if self._kv_seq_sharded(kv) != want_seq_sharded:
                    continue
                limit = min(len(ids) - 1, plen)
                neq = np.flatnonzero(arr[:limit] != ids_np[:limit])
                p = int(neq[0]) if neq.size else limit
                if p > best_p:
                    best_p, best_kv = p, kv
        return best_kv, best_p

    def _entry_prefix_kv(self, entry) -> KVCache:
        """An entry's KV as dense tensors (materializing a page run)."""
        kv = entry[1]
        if isinstance(kv, PagedPrefixRun):
            return kv.materialize()
        return kv

    # With attention_impl="xla", continuation prefill materializes a
    # per-layer f32 score tensor [num_heads, s_bucket, cont_bucket]; cap it
    # at ~1 GB and fall back to FULL prefill beyond. attention_impl="flash"
    # runs the suffix through the flash kernel's q_offset mode (no score
    # tensor), so the cap, and the fallback, do not apply.
    MAX_CONT_SCORE_BYTES = 1 << 30

    def _prefill_with_cache(self, prompt_ids: List[int], prompt_len: int, bucket: int,
                            allow_seq_sharded: bool = False):
        """Prefill through the prompt-prefix cache: exact hit -> no device
        work; partial hit past the reuse threshold -> suffix-only prefill;
        miss -> full prefill. Stores the full prompt's KV back into the
        LRU. Returns (first logits [1, V], KVCache). An exact hit on a
        sequence-sharded entry counts only when the caller takes that
        layout (``allow_seq_sharded``); otherwise it is a miss."""
        with self._launch_lock:
            key = tuple(prompt_ids)
            hit = self._prefix_entries.get(key)
            if hit is not None and (allow_seq_sharded or not self._kv_seq_sharded(hit[1])):
                self._prefix_entries.move_to_end(key)
                self.prefix_cache_stats["hits"] += 1
                return hit[0], self._entry_prefix_kv(hit)
            matched_kv, p = self._prefix_match(prompt_ids)
            matched_run = matched_kv if isinstance(matched_kv, PagedPrefixRun) else None
            if matched_run is not None:
                # Pinned while the continuation reads it: a store's eviction
                # must not free its pages before the new entry increfs the
                # shared ones.
                matched_run.retain()
            try:
                return self._prefill_with_cache_matched(
                    prompt_ids, prompt_len, bucket, matched_kv, matched_run, p
                )
            finally:
                if matched_run is not None:
                    matched_run.pool.allocator.decref(matched_run.pages)

    def _prefill_with_cache_matched(self, prompt_ids, prompt_len, bucket, matched_kv,
                                    matched_run, p):
        config = self.config
        s_bucket = _bucket(max(1, prompt_len - p), minimum=32)
        # Power-of-two rounding capped at max_seq_len; p + s_bucket <=
        # max_seq_len is checked below, so the capped size fits the write.
        cont_bucket = max(bucket, min(_bucket(p + s_bucket, minimum=32), config.max_seq_len))
        continuation_ok = (
            matched_kv is not None
            and p >= self.prefix_cache_min_reuse
            and p + s_bucket <= config.max_seq_len
            and (
                config.attention_impl == "flash"
                or config.num_heads * s_bucket * cont_bucket * 4 <= self.MAX_CONT_SCORE_BYTES
            )
        )
        base_run, base_len = None, 0
        if continuation_ok:
            self.prefix_cache_stats["partial_hits"] += 1
            suffix = prompt_ids[p:]
            suffix_tokens = torch.tensor(
                [suffix + [config.pad_token_id] * (s_bucket - len(suffix))],
                dtype=torch.int64, device=self.device,
            )
            # The seed: the reused prefix rows [0, p), padded to
            # cont_bucket; the continuation writes the suffix KV into it in
            # place.
            if matched_run is not None:
                cache0 = matched_run.gather_prefix_padded(p, cont_bucket)
                base_run, base_len = matched_run, p
            else:
                pad = (0, 0, 0, 0, 0, cont_bucket - p)
                cache0 = KVCache(
                    k=torch.nn.functional.pad(matched_kv.k[:, :, :p], pad),
                    v=torch.nn.functional.pad(matched_kv.v[:, :, :p], pad),
                )
            first_logits, prefix = prefill_continue(
                config, self.params, suffix_tokens, cache0, p, prompt_len
            )
            if cont_bucket != bucket:
                prefix = KVCache(
                    k=prefix.k[:, :, :bucket].contiguous(), v=prefix.v[:, :, :bucket].contiguous()
                )
        else:
            self.prefix_cache_stats["misses"] += 1
            first_logits, prefix = self._prefill_full(prompt_ids, prompt_len, bucket)
        self._prefix_store(prompt_ids, first_logits, prefix, base_run=base_run, base_len=base_len)
        return first_logits, prefix

    # -- paged KV pool -----------------------------------------------------
    def _ensure_kv_pool(self, min_pages: int = 0) -> PagedKVPool:
        """Build (or return) the engine's page pool, as the JAX engine does:
        a fixed allocation for the engine's lifetime, sized when first
        built. An explicit ``kv_pool_pages`` wins; else the caller's
        ``min_pages`` (the first paged launch's need, or the continuous
        loop's worst case), or, with a prefix cache, one 2048-token run per
        entry plus one in flight, and at least 8 pages. A later launch that
        does not fit raises :class:`PagePoolExhausted` at allocation and
        decodes dense; a rebuild replaces the whole engine, pool included."""
        with self._launch_lock:
            if self._kv_pool is None:
                cache_pages = 0
                if self.prefix_cache_size:
                    cache_pages = (self.prefix_cache_size + 1) * pages_for(
                        min(self.config.max_seq_len, 2048), self.kv_page_size
                    )
                total = max(int(self.kv_pool_pages or 0), int(min_pages), cache_pages, 8)
                self._kv_pool = PagedKVPool(self.kv_config, total, self.kv_page_size, self.device)
            return self._kv_pool

    def _alloc_pages_with_evict(self, count: int) -> List[int]:
        """Allocate pages, evicting LRU paged cache entries under pressure.
        Raises PagePoolExhausted only when the pool is short even with every
        evictable entry gone."""
        with self._launch_lock:
            alloc = self._kv_pool.allocator
            try:
                return alloc.alloc(count)
            except PagePoolExhausted:
                self._evict_paged_entries(need_pages=count - alloc.free_pages)
                return alloc.alloc(count)

    def _evict_paged_entries(self, need_pages: int) -> int:
        """Evict paged cache entries LRU-first until ``need_pages`` pages
        have returned to the free stack. Pages still referenced by in-flight
        rows (or by a younger entry extending this one) survive: only the
        entry's own reference drops, and the last reader's release frees
        them."""
        freed = 0
        with self._launch_lock:
            for key in list(self._prefix_entries.keys()):
                if freed >= need_pages:
                    break
                run = self._prefix_entries[key][1]
                if isinstance(run, PagedPrefixRun):
                    del self._prefix_entries[key]
                    freed += run.release()
        return freed

    def _run_from_dense(self, prefix: KVCache, plen: int, bucket: int,
                        base_run: Optional[PagedPrefixRun] = None,
                        base_len: int = 0) -> PagedPrefixRun:
        """Copy a dense prefill result (KVCache [L, 1, bucket, KVH, D]) into
        pages of the engine's pool; positions past the prompt go to the
        trash page. When ``base_run`` is the entry this prefill continued
        from, its full pages below ``base_len`` are shared (incref, no copy):
        the continuation seeded its cache from those exact values."""
        with self._launch_lock:
            pool = self._ensure_kv_pool()
            ps = pool.page_size
            npages = pages_for(plen, ps)
            shared = 0
            if base_run is not None:
                shared = min(min(base_len, plen) // ps, npages)
                if shared:
                    pool.allocator.incref(base_run.pages[:shared])
            pages = list(base_run.pages[:shared] if shared else [])
            try:
                pages += self._alloc_pages_with_evict(npages - shared)
                idx = flat_slots(pages, np.arange(bucket), ps)
                trash = (np.arange(bucket) % ps + TRASH_PAGE * ps).astype(np.int32)
                if shared:
                    idx[: shared * ps] = trash[: shared * ps]
                idx[plen:] = trash[plen:]
                pool.scatter_tokens(prefix.k[:, 0], prefix.v[:, 0], idx)
            except Exception:
                # Pool exhausted, or the device ran out of memory mid-copy:
                # every reference taken here goes back.
                if pages:
                    pool.allocator.decref(pages)
                raise
            return PagedPrefixRun(pool, pages, plen, bucket)

    def paged_admit_prefix(self, prompt_ids: List[int], prompt_len: int, bucket: int):
        """A prompt's KV as a page run of the engine's pool: ``(first_logits
        [1, V], run, transient)``. A cached paged entry's run is returned
        directly (no device work, pages shared); otherwise the routed
        prefill runs and its result is either the just-stored cache run or,
        with the cache off, a transient run the caller releases after
        pinning. May raise :class:`PagePoolExhausted`."""
        key = tuple(prompt_ids)
        with self._launch_lock:
            if self.prefix_cache_size > 0:
                hit = self._prefix_entries.get(key)
                if hit is not None and isinstance(hit[1], PagedPrefixRun):
                    self._prefix_entries.move_to_end(key)
                    self.prefix_cache_stats["hits"] += 1
                    return hit[0], hit[1], False
            first_logits, prefix = self._prefill_routed(prompt_ids, prompt_len, bucket)
            if self.prefix_cache_size > 0:
                hit = self._prefix_entries.get(key)
                if hit is not None and isinstance(hit[1], PagedPrefixRun):
                    return first_logits, hit[1], False
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

    def _validate_constraint(self, constraint, eos: List[int]) -> None:
        """Reject malformed constraint/eos combinations before any device work."""
        if constraint is None:
            return
        from .grammar import CompiledGrammar
        from .schema_constraint import SchemaDFA
        from .token_constraint import TokenConstraint

        config = self.config
        if constraint != "json" and not isinstance(
            constraint, (SchemaDFA, TokenConstraint, CompiledGrammar)
        ):
            raise ValueError(
                f"Unknown constraint {constraint!r}; supported: 'json', a compiled "
                "SchemaDFA, a compiled TokenConstraint, or a CompiledGrammar"
            )
        if isinstance(constraint, (TokenConstraint, CompiledGrammar)):
            # Token-level masks carry their own vocabulary; the model head must
            # cover it, and eos must be a special (len-0) or out-of-vocab id so
            # opening its column cannot alias a grammar token.
            if config.vocab_size < constraint.vocab_size:
                raise ValueError(
                    f"model vocab {config.vocab_size} < constraint vocab "
                    f"{constraint.vocab_size}"
                )
            if any(
                0 <= e < constraint.vocab_size and constraint.token_len[e] > 0
                for e in eos
            ):
                raise ValueError(
                    "eos ids must be special tokens under a token-level constraint"
                )
        else:
            # The byte masks treat token ids 0..255 AS bytes — the caller must
            # use a byte-level tokenizer. Specials (eos/pad) must live above
            # the byte range, or the eos column would alias onto a byte and
            # corrupt the automaton.
            if config.vocab_size <= 256 or any(e < 256 for e in eos):
                raise ValueError(
                    "grammar constraints need byte-level token semantics: vocab > 256 "
                    "with eos/pad ids outside the 0..255 byte range"
                )

    # -- public API ---------------------------------------------------------
    def generate(self, prompt_ids: Sequence[int], n: int = 1, seed: Optional[int] = None,
                 token_sink: Optional[Callable[[int, np.ndarray], None]] = None,
                 **kwargs) -> GenerationResult:
        """One request: :meth:`generate_many` with a single item."""
        spec = GenRequestSpec(list(prompt_ids), n, seed, token_sink=token_sink)
        out = self.generate_many([spec], **kwargs)[0]
        if isinstance(out, BaseException):
            raise out
        return out

    def generate_many(
        self,
        items: Sequence[GenRequestSpec],
        *,
        _oom_splits_left: int = MAX_OOM_SPLITS,
        **kwargs,
    ) -> List[Any]:
        """Decode several same-config requests as one batch, with device-OOM
        recovery: a launch that runs out of device memory splits the group
        in half and retries each half (recursively, bounded by
        ``MAX_OOM_SPLITS``) instead of failing every member. Every page
        reference the failed attempt took is released and the allocator's
        cached blocks go back to the card before the retry; nothing moves
        to the CPU or to a plain version. A solo request that still runs
        out gets a typed 503 member error. Splits are counted in
        ``FAILURE_EVENTS`` and ``oom_stats``; ``on_oom``/``on_launch_ok``
        tell the scheduler to back its coalescing width off and up again.
        See :meth:`_generate_many_attempt` for the decode semantics."""
        if not items:
            return []
        try:
            results = self._generate_many_attempt(items, **kwargs)
        except Exception as e:
            if not is_resource_exhausted(e):
                raise
            message = str(e)
        else:
            if self.on_launch_ok is not None:
                self.on_launch_ok()
            return results
        # Outside the handler: the exception's frames, and the device tensors
        # they hold, are gone; the cached blocks go back to the card. The
        # page pool stays, as in the JAX engine.
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        FAILURE_EVENTS.record("engine.oom")
        self.oom_stats["splits"] += 1
        if self.on_oom is not None:
            self.on_oom()
        if len(items) == 1 or _oom_splits_left <= 0:
            self.oom_stats["unrecovered"] += len(items)
            FAILURE_EVENTS.record("engine.oom_unrecovered", len(items))
            logger.error(
                "device OOM not recoverable by splitting (%d member(s)): %s",
                len(items), message,
            )
            return [
                BackendUnavailableError(
                    f"device out of memory decoding this request "
                    f"(n={it.n}, prompt_len={len(it.prompt_ids)}); "
                    "reduce n or max_tokens"
                )
                for it in items
            ]
        mid = (len(items) + 1) // 2
        logger.warning(
            "device OOM on a %d-request coalesced launch; splitting %d/%d and "
            "retrying (%d split(s) left)",
            len(items), mid, len(items) - mid, _oom_splits_left - 1,
        )
        FAILURE_EVENTS.record("engine.oom_split")
        return self.generate_many(
            items[:mid], _oom_splits_left=_oom_splits_left - 1, **kwargs
        ) + self.generate_many(
            items[mid:], _oom_splits_left=_oom_splits_left - 1, **kwargs
        )

    def _generate_many_attempt(self, items: Sequence[GenRequestSpec], **kwargs) -> List[Any]:
        """One launch of ``items``. A solo launch returns its member's
        failure as the list's element (as a coalesced launch does per
        member), except device OOM, which the guard in :meth:`generate_many`
        must see."""
        if len(items) > 1:
            return self._launch(items, **kwargs)
        try:
            return self._launch(items, **kwargs)
        except Exception as e:
            if is_resource_exhausted(e):
                raise
            return [e]

    @_one_launch_at_a_time
    @torch.inference_mode()
    def _launch(
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
        constraint: Any = None,
    ) -> List[Any]:
        """Decode several same-config requests as one batch, in the engine's
        KV layout. ``constraint`` masks every row's logits with a grammar
        automaton (see :func:`_constraint_ops`). Returns one
        GenerationResult per item, or, for a member whose budget was spent
        (its rows froze at the step the abort poller saw it) or whose
        samples an injected fault killed, that member's exception."""
        _failpoints.fire("engine.launch")
        note_device_dispatch("engine batched launch")
        config = self.config
        device = self.device
        t_start = time.perf_counter()
        # Stats describe this launch only: a launch without speculation must
        # not leave an earlier one's numbers visible.
        self.spec_stats = {}
        if len(items) == 1 and items[0].budget is not None:
            # A solo request fails before any device work; a coalesced
            # member's spent budget is seen by the abort poller at the first
            # step and fails that member alone, as in the JAX engine.
            items[0].budget.check("engine prefill")
        eos = list(eos_ids or [config.eos_token_id])[:MAX_EOS_IDS]
        self._validate_constraint(constraint, eos)
        preps = [self._prep_prompt(it.prompt_ids) for it in items]
        # One row count for every request, rounded so the data axis divides
        # the batch (the JAX engine's padding; its draws' rows line up).
        dp = self.data_parallel_size
        n_per = -(-max(max(1, it.n) for it in items) // dp) * dp
        r_pad = _bucket(len(items), minimum=1)
        extra = r_pad - len(items)
        B = r_pad * n_per
        live = [i for j, it in enumerate(items) for i in range(j * n_per, j * n_per + max(1, it.n))]
        seeds = [
            it.seed if it.seed is not None else int.from_bytes(os.urandom(4), "little")
            for it in items
        ]
        # The JAX engine's request keys: key(seed) per request, key(0) for
        # the padding requests.
        req_keys = request_keys(seeds + [0] * extra, device) if temperature != 0.0 else None
        stops, use_stops = self._stop_array(stop_sequences)
        eos_t = torch.as_tensor(eos + [-1] * (MAX_EOS_IDS - len(eos)), device=device)

        budgets = [it.budget for it in items]
        poison0 = self._poison0_array(B, live)

        sinks = [it.token_sink for it in items]

        def run_loop(step_fn, first_logits):
            self._active_token_sinks = sinks if any(sinks) else None
            self._reset_tap_state()
            try:
                return self._decode(
                    step_fn, first_logits, n_per, r_pad, req_keys,
                    _constraint_ops(constraint, device), budgets, poison0,
                    max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                    top_k=top_k, eos_t=eos_t,
                    top_logprobs=top_logprobs, frequency_penalty=frequency_penalty,
                    presence_penalty=presence_penalty,
                    bias=self._bias_array(logit_bias) if logit_bias else None,
                    stops=stops if use_stops else None,
                )
            finally:
                self._active_token_sinks = None

        # The ring-decode route: a solo prompt that takes the SP prefill keeps
        # its KV sequence-sharded and decodes against it in place.
        ring_mesh = self.mesh if (
            len(items) == 1 and self.sp_decode and self._use_sp_prefill(*preps[0][1:])
        ) else None
        spec_np = None
        if self.speculative == "prompt_lookup":
            # Speculative launches decode dense whatever the engine's layout,
            # as the JAX engine routes them (its paged arm excludes them).
            layout = "dense"

            def run_spec(first_logits, prefix, prompt_tokens, prompt_lens):
                return self._spec_decode(
                    first_logits, prefix, prompt_tokens, prompt_lens, n_per, r_pad, req_keys,
                    ring_mesh,
                    _constraint_ops(constraint, device), budgets, poison0,
                    max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                    top_k=top_k, eos_t=eos_t,
                    top_logprobs=top_logprobs, frequency_penalty=frequency_penalty,
                    presence_penalty=presence_penalty,
                    bias=self._bias_array(logit_bias) if logit_bias else None,
                    stops=stops if use_stops else None,
                )

            (*out, count_np, iters_np), t_prefill = self._generate_speculative(
                preps, r_pad, run_spec, ring_mesh
            )
            spec_np = (count_np, iters_np)
        else:
            # A sequence-parallel decode keeps the dense layouts, as in JAX.
            layout = "dense" if (self.sp_decode and self.mesh is not None) else self.kv_layout
            if layout == "paged":
                try:
                    out, t_prefill = self._generate_paged(
                        preps, n_per, r_pad, live, max_new_tokens, run_loop
                    )
                except PagePoolExhausted:
                    # The JAX engine's rule: correctness never depends on
                    # pages being available.
                    logger.debug(
                        "paged launch exhausted the page pool; falling back to dense decode"
                    )
                    layout = "dense"
            if layout == "dense":
                out, t_prefill = self._generate_dense(
                    preps, n_per, r_pad, max_new_tokens, run_loop, ring_mesh
                )
        toks_np, lps_np, done_np, tt_np, tl_np, pois_np, steps, aborted = out
        t_end = time.perf_counter()
        spec_launch = spec_np is not None
        self.last_launch_stats = {
            "prefill_s": t_prefill - t_start,
            "decode_s": t_end - t_prefill,
            # Decode steps, or verify iterations on a speculative launch.
            "decode_steps": steps,
            "rows": B,
            "n_per": n_per,
            "live_rows": len(live),
            "kv_layout": layout,
            # member -> (decode step, host time) at which the abort poller
            # froze its rows.
            "aborted": aborted,
        }

        def member_spec_stats(lo: int, n_j: int) -> Dict[str, Any]:
            """The JAX engine's two shapes: a solo launch's result carries
            drafted/accepted, a coalesced member's only its iterations and
            rate."""
            if not spec_launch:
                return {}
            count_np, iters_np = spec_np
            return _spec_acceptance_stats(
                count_np[lo: lo + n_j], iters_np[lo: lo + n_j],
                lookahead=self.spec_lookahead if len(items) == 1 else 0,
            )

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
                spec_stats=member_spec_stats(lo, n_j),
            )
            res = self._quarantine_result(res, pois_np[lo: lo + n_j])
            # A member's lifecycle or injected fault replaces its result
            # only: the scheduler delivers it to that member's caller.
            try:
                results.append(self._apply_decode_faults(res, it.budget))
            except Exception as e:
                results.append(e)
        self._note_quarantine(int(pois_np[np.asarray(live, np.int64)].sum()), len(live))
        if spec_launch:
            count_np, iters_np = spec_np
            if len(items) == 1:
                self.spec_stats = member_spec_stats(0, len(live))
            else:
                # The mirror summarises the whole coalesced launch over its
                # real rows (row and request padding excluded).
                idx = np.asarray(live, np.int64)
                self.spec_stats = {
                    "coalesced_requests": len(items),
                    **_spec_acceptance_stats(
                        count_np[idx], iters_np[idx], lookahead=self.spec_lookahead
                    ),
                }
            self.last_launch_stats["spec"] = dict(self.spec_stats)
            if self.on_spec_stats is not None:
                self.on_spec_stats(self.spec_stats)
        return results

    def _apply_decode_faults(
        self, result: GenerationResult, budget: Optional[RequestBudget]
    ) -> GenerationResult:
        """Post-decode fault surfacing for ONE request: a spent budget raises
        its typed lifecycle error (the decode loop already froze its rows);
        an active ``engine.decode`` kill_samples failpoint marks a seeded
        subset of samples lost (tokens cleared, ``sample_errors`` filled)."""
        if budget is not None and budget.should_abort():
            FAILURE_EVENTS.record("engine.decode_abort")
            raise budget.error("engine decode")
        fp = _failpoints.fire("engine.decode")
        if fp is None or fp.action != "kill_samples" or fp.kill <= 0:
            return result
        n = result.tokens.shape[0]
        errs = _kill_sample_errors(n, fp)
        killed = [i for i, e in enumerate(errs) if e is not None]
        if not killed:
            return result
        FAILURE_EVENTS.record("engine.samples_killed", len(killed))
        if result.sample_errors:
            # Compose with earlier per-sample faults (quarantine): a kill
            # overwrites, everything else survives.
            errs = [e if e is not None else prev for e, prev in zip(errs, result.sample_errors)]
        toks = result.tokens.copy()
        lps = result.logprobs.copy()
        lengths = result.lengths.copy()
        for i in killed:
            toks[i, :] = self.config.pad_token_id
            lps[i, :] = 0.0
            lengths[i] = 0
        return result._replace(tokens=toks, logprobs=lps, lengths=lengths, sample_errors=errs)

    # -- streaming tap ----------------------------------------------------
    def _reset_tap_state(self) -> None:
        """Per-launch delivery state for the streaming token tap. One launch
        runs at a time (the launch lock), so one tap stream is live."""
        # kllms: unguarded — one launch in flight; serialized by the launch lock
        self._tap_next = 0

    def _deliver_tap_step(self, step: int, toks: np.ndarray) -> None:
        """Deliver one step's tokens ``[r_pad, n_per]`` to the active sinks,
        member ``r`` getting row group ``toks[r]``. The decode loop is a host
        loop that delivers in step order, so sinks observe steps 0, 1, 2, ...
        exactly once (a step other than the next is dropped). A sink that
        raises is logged and dropped; it never fails the decode."""
        sinks = self._active_token_sinks
        if not sinks or step != self._tap_next:
            return
        for r, sink in enumerate(sinks):
            if sink is None:
                continue
            try:
                sink(step, toks[r])
            except Exception:  # a broken sink must not poison decode
                logger.exception("token sink failed; dropping stream tap")
                sinks[r] = None
        self._tap_next += 1

    # -- numeric-integrity quarantine --------------------------------------
    def _poison0_array(self, n_rows: int, live_rows: Sequence[int]) -> Optional[torch.Tensor]:
        """First-step poison-injection mask [n_rows] bool, or None (nothing
        to inject, the production path): with an active ``engine.logits``
        nan failpoint, a seeded subset of the live rows (padding rows
        excluded, their poison would be invisible)."""
        fp = _failpoints.fire("engine.logits")
        if fp is None or fp.action != "nan" or fp.kill <= 0:
            return None
        rows = list(live_rows)
        chosen = _pyrandom.Random(fp.seed).sample(rows, min(fp.kill, len(rows)))
        mask = np.zeros((n_rows,), np.bool_)
        mask[chosen] = True
        return torch.as_tensor(mask, device=self.device)

    def _note_quarantine(self, poisoned: int, total: int) -> None:
        """Per-launch quarantine accounting and the supervisor's hook, called
        for every launch (clean ones report poisoned=0) so a rate window
        decays."""
        if poisoned:
            self.quarantine_stats["samples"] += poisoned
            self.quarantine_stats["launches"] += 1
            QUARANTINE_EVENTS.record("quarantine.samples", poisoned)
            QUARANTINE_EVENTS.record("quarantine.launches")
            logger.warning("numeric poison: %d/%d decode row(s) quarantined", poisoned, total)
        if self.on_quarantine is not None:
            self.on_quarantine(poisoned, total)

    def _generate_paged(self, preps, n_per, r_pad, live, max_new_tokens, run_loop):
        """The paged body: prompts admitted as pool page runs (through the
        prefix cache when it is on), rows decode through block tables.
        Returns (loop output, prefill end time). Raises PagePoolExhausted
        (after releasing every reference it took) when admission or the gen
        pages cannot be had even with eviction."""
        config = self.config
        device = self.device
        extra = r_pad - len(preps)
        B = r_pad * n_per
        bucket_max = max(bucket for _, _, bucket in preps)
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
                gen_pages_rows[row] = self._alloc_pages_with_evict(gp)
            # Resolved and counted per launch once its pages are held, where
            # the JAX engine resolves it: a launch the pool cannot hold
            # decodes dense and counts no paged dispatch. The ops.paged_attn
            # drill sends a CPU launch to the plain version and fails a card
            # launch (the finally returns its pages).
            attn_impl = launch_paged_attention_impl(self.paged_attention_impl, device=device)

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
                prefix_np[len(preps):] = prefix_np[len(preps) - 1]
            trash_gen = (np.arange(max_new_tokens) % ps + TRASH_PAGE * ps).astype(np.int64)
            gen_np = np.empty((B, max_new_tokens), np.int64)
            for row in range(B):
                pgs = gen_pages_rows[row]
                gen_np[row] = flat_slots(pgs, np.arange(max_new_tokens), ps) if pgs else trash_gen
            first_list += [first_list[-1]] * extra
            first_logits = torch.cat(first_list, dim=0)  # [r_pad, V]
            prompt_lens = torch.as_tensor(
                [p for _, p, _ in preps] + [preps[-1][1]] * extra, device=device
            )
            prefix_idx = torch.as_tensor(prefix_np, device=device)
            gen_idx = torch.as_tensor(gen_np, device=device)

            def step_fn(tok, step):
                # Reentrant: run_loop already holds the pool lock for the
                # whole decode; taken here too, so the step's in-place pool
                # writes visibly happen under it.
                with pool.lock:
                    logits, k_cols, v_cols = paged_verify_step(
                        config, self.params, tok[:, None],
                        torch.full((B,), step, dtype=torch.int64, device=device),
                        prompt_lens, pool.k, pool.v, prefix_idx, gen_idx,
                        attn_impl=attn_impl, page_size=ps,
                    )
                    # This step's column goes into the pool after the step,
                    # at gen slot ``step`` of every row (dead rows write the
                    # trash page).
                    slots = gen_idx[:, step]
                    pool.k[:, slots] = k_cols
                    pool.v[:, slots] = v_cols
                return logits[:, 0]

            with pool.lock:
                out = run_loop(step_fn, first_logits)
        finally:
            for run in pinned:
                pool.allocator.decref(run.pages)
            for pgs in gen_pages_rows:
                if pgs is not None:
                    pool.allocator.decref(pgs)
        return out, t_prefill

    def _generate_dense(self, preps, n_per, r_pad, max_new_tokens, run_loop, ring_mesh=None):
        """The dense body (the JAX engine's ``generate_many`` without the
        speculative arm): the stacked prefix of :meth:`_dense_prefix`, or
        with ``ring_mesh`` the solo request's sequence-sharded prefix (the
        ``sp_resident`` route, decoded by ring attention); every row's
        generated KV in a dense ``[L, B, max_new, KVH, D]`` cache. Returns
        (loop output, prefill end time)."""
        config = self.config
        first_logits, prefix, prompt_lens = self._dense_prefix(preps, r_pad, ring_mesh)
        gen_cache = init_cache(self.kv_config, r_pad * n_per, max_new_tokens, self.device)
        self._sync()
        t_prefill = time.perf_counter()

        def step_fn(tok, step):
            return decode_step(config, self.params, tok, step, prompt_lens, gen_cache, prefix,
                               ring_mesh=ring_mesh)[0]

        return run_loop(step_fn, first_logits), t_prefill

    def _generate_speculative(self, preps, r_pad, run_spec, ring_mesh=None):
        """The speculative body: the stacked dense prefix of
        :meth:`_dense_prefix` (speculative launches decode dense, as in the
        JAX engine) and each request's prompt table ``[r_pad, P]`` for the
        drafter, padding requests repeating the last one's. Returns (loop
        output, prefill end time)."""
        first_logits, prefix, prompt_lens = self._dense_prefix(preps, r_pad, ring_mesh)
        bucket_max = max(bucket for _, _, bucket in preps)
        table = np.full((r_pad, bucket_max), self.config.pad_token_id, np.int64)
        for j, (ids, prompt_len, _) in enumerate(preps):
            table[j, :prompt_len] = ids
        table[len(preps):] = table[len(preps) - 1]
        prompt_tokens = torch.as_tensor(table, device=self.device)
        self._sync()
        t_prefill = time.perf_counter()
        return run_spec(first_logits, prefix, prompt_tokens, prompt_lens), t_prefill

    def _dense_prefix(self, preps, r_pad, ring_mesh=None):
        """Each prompt's KV (through the prefix cache when it is on),
        zero-padded to the largest bucket and stacked into one shared
        ``[L, r_pad, P, KVH, D]`` prefix, padding requests repeating the
        last one's. With ``ring_mesh`` (one request) the prefix is its
        sequence-sharded chunk instead. A coalesced launch with
        ``sp_decode`` takes sequence-sharded prefill results and cache hits
        and gathers them (the JAX ``generate_many``'s reshard). Returns
        (first logits [r_pad, V], the prefix, prompt lengths [r_pad])."""
        if ring_mesh is not None:
            (ids, prompt_len, bucket), = preps
            fl, kv = self._sp_prefill_routed(ids, prompt_len, bucket)
            return fl, kv, torch.as_tensor([prompt_len], device=self.device)
        extra = r_pad - len(preps)
        bucket_max = max(bucket for _, _, bucket in preps)
        reshard = self.sp_decode and self.mesh is not None
        first_list, k_list, v_list = [], [], []
        for ids, prompt_len, bucket in preps:
            fl, kv = self._prefill_routed(ids, prompt_len, bucket, allow_seq_sharded=reshard)
            k, v = self._replicated(kv)
            if bucket < bucket_max:
                pad = (0, 0, 0, 0, 0, bucket_max - bucket)  # masked by prompt_len
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
            first_list.append(fl)
            k_list.append(k)
            v_list.append(v)
        k_list += [k_list[-1]] * extra
        v_list += [v_list[-1]] * extra
        first_list += [first_list[-1]] * extra
        prefix = KVCache(k=torch.cat(k_list, dim=1), v=torch.cat(v_list, dim=1))
        del k_list, v_list
        first_logits = torch.cat(first_list, dim=0)  # [r_pad, V]
        prompt_lens = torch.as_tensor(
            [p for _, p, _ in preps] + [preps[-1][1]] * extra, device=self.device
        )
        return first_logits, prefix, prompt_lens

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
        self, step_fn, first_logits, n_per, r_pad, req_keys, cops, budgets, poison0, *,
        max_new_tokens, temperature, top_p, top_k, eos_t, top_logprobs, frequency_penalty,
        presence_penalty, bias, stops,
    ):
        """The decode loop over ``B = r_pad * n_per`` rows, the JAX engine's
        ``_run_loop``: ``step_fn(tokens [B], step) -> logits [B, V]`` runs one
        model step in the caller's KV layout. ``req_keys`` [r_pad, 2] are the
        requests' key words (None at temperature 0); the first token samples
        at draw step 0 and model step k at draw step k + 1, as in JAX.
        ``cops`` is :func:`_constraint_ops`'s tuple or None. Each step runs,
        in the JAX order: grammar mask, the pad column, the poison check,
        sample (top logprobs from the masked logits), freeze, advance.
        ``budgets`` are the members' budgets (None entries never abort):
        the abort poller reads them on the host after every step, and a
        member whose budget has just been spent has its rows folded into
        ``done``, as the JAX loop's ``abort_poll`` does; a step where no
        flag changed adds no device work and no sync. ``poison0`` [B] bool
        (or None) forces rows' first-step logits to NaN (the
        ``engine.logits`` drill).
        Returns numpy (tokens, logprobs, done, top ids, top logprobs,
        poisoned), the step count and the poller's aborts."""
        config = self.config
        device = self.device
        pad_id = config.pad_token_id
        B = r_pad * n_per
        V = first_logits.shape[-1]
        # pad_id must never be sampled on a live row, unless it doubles as eos.
        # kllms: ignore[host-sync-hot-path] — port-only: the pad column's value, read once per launch before the loop (JAX decides it on the device); ROADMAP Queue 2 item 2
        pad_col = 0.0 if bool((eos_t == pad_id).any()) else -float("inf")
        penalized = frequency_penalty != 0.0 or presence_penalty != 0.0
        K = top_logprobs or 0

        # The draw step lives on the device, so no host value enters a draw.
        draw_step = torch.zeros((), dtype=torch.int32, device=device)
        jstate = None
        if cops is not None:
            jt, initial_state, mask_logits, advance = cops
            jstate = initial_state(B)

        def sample(logits, counts):
            pen = None
            if penalized:
                pen = frequency_penalty * counts + presence_penalty * (counts > 0).float()
            if bias is not None:
                pen = -bias[None, :] if pen is None else pen - bias[None, :]
            noise = None
            if req_keys is not None:
                noise = draw_noise(req_keys, draw_step, n_per, V)
            return sample_logits(
                logits, temperature=temperature, top_p=top_p, top_k=top_k,
                noise=noise, penalty=pen,
            )

        def prepare(logits, done, poison=None):
            if jstate is not None:
                logits = mask_logits(jt, logits, *jstate, eos_t)
            else:
                logits = logits.clone()
            logits[:, pad_id] += pad_col
            if poison is not None:
                logits = torch.where(poison[:, None], float("nan"), logits)
            bad = _poisoned_logits(logits) & ~done
            logits = torch.where(bad[:, None], torch.zeros_like(logits), logits)
            return logits, bad

        counts = torch.zeros((B, V if penalized else 0), dtype=torch.float32, device=device)
        logits0 = first_logits.repeat_interleave(n_per, dim=0)  # [B, V]
        done = torch.zeros(B, dtype=torch.bool, device=device)
        logits0, bad = prepare(logits0, done, poison0)
        tok, lp = sample(logits0, counts)
        tok = torch.where(bad, torch.full_like(tok, pad_id), tok)
        lp = torch.where(bad, torch.zeros_like(lp), lp)
        self._check_ranks(tok, "first tokens")
        if jstate is not None:
            jstate = advance(jt, tok, *jstate)
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

        # The abort poller: member -> (step, host time) at which its rows
        # were folded into done.
        polled = [b for b in budgets if b is not None]
        aborted: Dict[int, Tuple[int, float]] = {}

        # The streaming tap: each step's tokens go to the host in one
        # non-blocking copy, which the next ``bool(done.all())`` sync
        # completes; they are delivered after the following step's work is
        # queued, so the card computes while the sinks run. A launch without
        # sinks copies nothing and syncs no more than before.
        tapped = self._active_token_sinks is not None
        pending = (0, tok.to("cpu", non_blocking=True)) if tapped else None

        step = 0
        # kllms: ignore[host-sync-hot-path] — port-only: the host loop's exit test, one sync a step (JAX's while_loop tests on the device); ROADMAP Queue 2 item 2
        while step < max_new_tokens - 1 and not bool(done.all()):
            logits, bad = prepare(step_fn(tok, step), done)
            frozen = done | bad
            draw_step += 1
            nxt, lp = sample(logits, counts)
            nxt = torch.where(frozen, torch.full_like(nxt, pad_id), nxt)
            lp = torch.where(frozen, torch.zeros_like(lp), lp)
            self._check_ranks(nxt, f"step {step} tokens")
            if jstate is not None:
                jstate = advance(jt, nxt, *jstate)  # pad/eos freeze the row
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
            if polled:
                flipped = [
                    j for j, b in enumerate(budgets)
                    if b is not None and j not in aborted and b.should_abort()
                ]
                if flipped:
                    # Token-granularity cancellation: the member's row group
                    # (rows are request-major) freezes like eos rows.
                    seen = time.perf_counter()
                    for j in flipped:
                        aborted[j] = (step, seen)
                    rows = torch.zeros(B, dtype=torch.bool)
                    for j in flipped:
                        rows[j * n_per: (j + 1) * n_per] = True
                    done = done | rows.to(device)
            if tapped:
                # kllms: ignore[host-sync-hot-path] — port-only: a view of the tap's non-blocking host copy, completed by the step's done.all() sync; no readback of its own (ROADMAP Queue 2 item 2)
                self._deliver_tap_step(pending[0], pending[1].numpy().reshape(r_pad, n_per))
                pending = (step + 1, nxt.to("cpu", non_blocking=True))
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
        if tapped:
            # kllms: ignore[host-sync-hot-path] — port-only: a view of the tap's last host copy, completed by the launch's final synchronize; no readback of its own (ROADMAP Queue 2 item 2)
            self._deliver_tap_step(pending[0], pending[1].numpy().reshape(r_pad, n_per))

        def host(t):
            return None if t is None else t.cpu().numpy()

        return (
            host(toks), host(lps), host(done), host(tt), host(tl), host(pois), n_steps - 1,
            aborted,
        )

    def _spec_decode(
        self, first_logits, prefix, prompt_tokens, prompt_lens, n_per, r_pad, req_keys, ring_mesh,
        cops,
        budgets, poison0, *, max_new_tokens, temperature, top_p, top_k, eos_t, top_logprobs,
        frequency_penalty, presence_penalty, bias, stops,
    ):
        """The prompt-lookup speculative loop over ``B = r_pad * n_per``
        rows, the JAX engine's ``_get_spec_decode_loop`` step for step. Each
        row keeps its own count of emitted tokens; an iteration drafts K =
        ``spec_lookahead`` tokens per row from its own request's prompt
        table ``prompt_tokens`` [r_pad, P] (and from its generated text),
        verifies the row's last token and its drafts in one
        :func:`models.llama.verify_step` at per-row offsets, samples every
        position from its own conditional in one flattened call over
        ``B * (K + 1)`` rows, and emits the longest confirmed run
        (:func:`ops.speculative.accept_drafts`): 1 to K + 1 tokens a row.

        It composes with the rest as the JAX loop does: position j's logits
        are masked by the grammar state advanced through ``drafts[:j]``
        (the state then re-anchors at the last emitted token); the pad
        column; the quarantine, which gives a row whose verify logits go
        non-finite a zero budget and freezes it; penalty counts at position
        j are the emitted counts plus the drafts before j, with the logit
        bias folded into the same penalty; stop sequences are matched at
        every emitted position and the run truncated at the first match;
        top logprobs come from the logits sampling sees. Draws: the first
        token at step 0 as in :meth:`_decode`, iteration ``it`` (from 1)
        through :func:`ops.random.threefry_uniform_verify`, one launch an
        iteration. The abort poller reads the budgets on the host after each
        iteration (block-granular, as in JAX). The gen cache holds
        ``max_new + K + 1`` slots and so do the token buffers: a row's count
        never passes ``max_new``, so no write needs JAX's clamp.

        Returns numpy (tokens, logprobs, finish flags, top ids, top
        logprobs, poisoned), the iteration count, the poller's aborts, and
        numpy (emitted counts, verify iterations entered) per row."""
        config = self.config
        device = self.device
        pad_id = config.pad_token_id
        K = self.spec_lookahead
        K1 = K + 1
        B = r_pad * n_per
        max_new = max_new_tokens
        BUF = max_new + K1
        V = first_logits.shape[-1]
        # kllms: ignore[host-sync-hot-path] — port-only: the pad column's value, read once per launch before the loop (JAX decides it on the device); ROADMAP Queue 2 item 2
        pad_col = 0.0 if bool((eos_t == pad_id).any()) else -float("inf")
        penalized = frequency_penalty != 0.0 or presence_penalty != 0.0
        KT = top_logprobs or 0
        rows = torch.arange(B, device=device)
        jstate = None
        if cops is not None:
            jt, initial_state, mask_logits, advance = cops
            jstate = initial_state(B)

        def sample(logits, noise, pen):
            return sample_logits(
                logits, temperature=temperature, top_p=top_p, top_k=top_k,
                noise=noise, penalty=pen,
            )

        def select(cond, a, b):
            return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)

        prompt_row = prompt_tokens.repeat_interleave(n_per, dim=0)  # [B, P]
        plen_row = prompt_lens.to(torch.int64).repeat_interleave(n_per)  # [B]

        # Step 0: the first token from the prefill's logits.
        logits0 = first_logits.repeat_interleave(n_per, dim=0)  # [B, V]
        if jstate is not None:
            logits0 = mask_logits(jt, logits0, *jstate, eos_t)
        else:
            logits0 = logits0.clone()
        logits0[:, pad_id] += pad_col
        if poison0 is not None:
            logits0 = torch.where(poison0[:, None], float("nan"), logits0)
        bad0 = _poisoned_logits(logits0)
        logits0 = torch.where(bad0[:, None], torch.zeros_like(logits0), logits0)
        noise0 = None
        if req_keys is not None:
            noise0 = draw_noise(req_keys, torch.zeros((), dtype=torch.int32, device=device),
                                n_per, V)
        tok0, lp0 = sample(logits0, noise0, -bias[None, :] if bias is not None else None)
        tok0 = torch.where(bad0, torch.full_like(tok0, pad_id), tok0)
        lp0 = torch.where(bad0, torch.zeros_like(lp0), lp0)
        if jstate is not None:
            jstate = advance(jt, tok0, *jstate)
        toks = torch.full((B, BUF), pad_id, dtype=torch.int64, device=device)
        toks[:, 0] = tok0
        lps = torch.zeros((B, BUF), dtype=torch.float32, device=device)
        lps[:, 0] = lp0
        tt = tlb = None
        if KT:
            ti0, tl0 = model_top_logprobs(logits0, KT)
            tt = torch.zeros((B, BUF, KT), dtype=torch.int64, device=device)
            tlb = torch.zeros((B, BUF, KT), dtype=torch.float32, device=device)
            tt[:, 0] = ti0
            tlb[:, 0] = tl0
        vcounts = None
        if penalized:
            vcounts = torch.zeros((B, V), dtype=torch.float32, device=device)
            vcounts[rows, tok0] += 1.0
        count = torch.ones((B,), dtype=torch.int64, device=device)
        eos0 = torch.isin(tok0, eos_t)
        recent = None
        if stops is not None:
            recent = torch.full((B, MAX_STOP_LEN), -1, dtype=torch.int64, device=device)
            recent[:, -1] = tok0
            eos0 = eos0 | stop_window_match(recent, stops)
        done = eos0 | bad0 | (count >= max_new)
        hit_eos_any = eos0
        pois = bad0
        row_iters = torch.zeros((B,), dtype=torch.int64, device=device)
        gen_cache = init_cache(self.kv_config, B, BUF, device)

        polled = [b for b in budgets if b is not None]
        aborted: Dict[int, Tuple[int, float]] = {}
        # The iteration number lives on the device too, so no host value
        # enters a draw.
        it_dev = torch.ones((), dtype=torch.int32, device=device)
        it = 1
        # kllms: ignore[host-sync-hot-path] — port-only: the host loop's exit test, one sync an iteration (JAX's while_loop tests on the device); ROADMAP Queue 2 item 2
        while it < max_new and not bool(done.all()):
            row_iters += (~done).to(torch.int64)
            cur = toks.gather(1, (count - 1)[:, None])[:, 0]
            prev = torch.where(
                count >= 2,
                toks.gather(1, (count - 2).clamp_min(0)[:, None])[:, 0],
                prompt_row.gather(1, (plen_row - 1)[:, None])[:, 0],
            )
            drafts = propose_prompt_lookup(
                prompt_row, plen_row, prev, cur, K, gen=toks, gen_len=count
            ).to(torch.int64)  # [B, K]
            block = torch.cat([cur[:, None], drafts], dim=1)  # [B, K+1]
            self._check_ranks(block, "speculative block")
            logits, _ = verify_step(
                config, self.params, block, count - 1, prompt_lens, gen_cache, prefix,
                ring_mesh=ring_mesh,
            )
            # Position j is masked by the state after the emitted prefix
            # advanced through drafts[:j], the only prefix under which its
            # draw can be emitted.
            sts = None
            if jstate is not None:
                sts = [jstate]
                for j in range(K):
                    sts.append(advance(jt, drafts[:, j], *sts[-1]))
                logits = torch.stack(
                    [mask_logits(jt, logits[:, j], *sts[j], eos_t) for j in range(K1)], dim=1
                )
            flat = logits.reshape(B * K1, V)
            flat[:, pad_id] += pad_col
            # Quarantine: a live row whose verify logits went non-finite at
            # any position emits nothing and freezes; sanitised so the one
            # flattened sampling call stays well defined.
            badrow = _poisoned_logits(flat).reshape(B, K1).any(dim=1) & ~done
            flat = torch.where(
                badrow.repeat_interleave(K1)[:, None], torch.zeros_like(flat), flat
            )
            pen = None
            if penalized:
                # Position j's counts: the emitted counts plus drafts[:j].
                inc = torch.zeros((B, K, V), dtype=torch.float32, device=device)
                inc.scatter_(2, drafts[:, :, None], 1.0)
                inc = inc.cumsum(dim=1)
                cnts = torch.cat([vcounts[:, None, :], vcounts[:, None, :] + inc], dim=1)
                pen = frequency_penalty * cnts + presence_penalty * (cnts > 0).float()
                if bias is not None:
                    pen = pen - bias[None, None, :]
                pen = pen.reshape(B * K1, V)
            elif bias is not None:
                pen = (-bias)[None, :].expand(B * K1, V)
            noise = None
            if req_keys is not None:
                noise = threefry_uniform_verify(req_keys, it_dev, n_per, K1, V)
            t_flat, lp_flat = sample(flat, noise, pen)
            sampled = t_flat.reshape(B, K1)
            lp_arr = lp_flat.reshape(B, K1)

            budget = torch.where(done | badrow, torch.zeros_like(count), max_new - count)
            emit, counts_new, hit_eos = accept_drafts(sampled, drafts, eos_t, budget)
            stop_hit = torch.zeros((B,), dtype=torch.bool, device=device)
            if stops is not None:
                # A stop can complete mid-run: match the window ending at
                # every emitted position and cut the run at the first match
                # (the matched position itself still emits).
                buf2 = torch.cat([recent, sampled], dim=1)  # [B, L + K + 1]
                hits = torch.stack(
                    [stop_window_match(buf2[:, j + 1: j + 1 + MAX_STOP_LEN], stops)
                     for j in range(K1)], dim=1,
                ) & emit
                stop_hit = hits.any(dim=1)
                keep = torch.where(
                    stop_hit, hits.to(torch.int32).argmax(dim=1), torch.full_like(count, K1)
                )
                emit = emit & (torch.arange(K1, device=device)[None, :] <= keep[:, None])
                counts_new = emit.sum(dim=1).to(torch.int32)
                hit_eos = (emit & torch.isin(sampled, eos_t)).any(dim=1)
                # The window after emission: the L tokens ending at the new
                # count (an empty run leaves it as it was).
                recent = buf2.gather(
                    1,
                    counts_new.to(torch.int64)[:, None]
                    + torch.arange(MAX_STOP_LEN, device=device)[None, :],
                )
            scatter_rows(toks, torch.where(emit, sampled, torch.full_like(sampled, pad_id)),
                         count, max_offset=max_new)
            scatter_rows(lps, torch.where(emit, lp_arr, torch.zeros_like(lp_arr)), count,
                         max_offset=max_new)
            if KT:
                ti, tl_ = model_top_logprobs(flat, KT)
                scatter_rows_k(tt, ti.reshape(B, K1, KT), count, max_offset=max_new)
                scatter_rows_k(tlb, tl_.reshape(B, K1, KT), count, max_offset=max_new)
            if penalized:
                vcounts.scatter_add_(1, sampled, emit.float())
            if jstate is not None:
                # Re-anchor the automaton at the last emitted token: the
                # state before it (counts_new - 1 drafts deep), advanced
                # through the token emitted there.
                c_idx = (counts_new.to(torch.int64) - 1).clamp_min(0)
                s_last = tuple(
                    torch.stack([st[q] for st in sts])[c_idx, rows] for q in range(len(jstate))
                )
                last_tok = sampled.gather(1, c_idx[:, None])[:, 0]
                moved = counts_new > 0
                jstate = tuple(
                    select(moved, nw, old)
                    for nw, old in zip(advance(jt, last_tok, *s_last), jstate)
                )
            count = count + counts_new
            hit_eos_any = hit_eos_any | hit_eos | stop_hit
            done = done | hit_eos | stop_hit | badrow | (count >= max_new)
            pois = pois | badrow
            if polled:
                flipped = [
                    j for j, b in enumerate(budgets)
                    if b is not None and j not in aborted and b.should_abort()
                ]
                if flipped:
                    seen = time.perf_counter()
                    frozen = torch.zeros(B, dtype=torch.bool)
                    for j in flipped:
                        aborted[j] = (it, seen)
                        frozen[j * n_per: (j + 1) * n_per] = True
                    done = done | frozen.to(device)
            it += 1
            it_dev += 1

        self._sync()

        def host(t):
            return None if t is None else t.cpu().numpy()

        toks_np = host(toks[:, :max_new]).astype(np.int32)
        tt_np = None if tt is None else host(tt[:, :max_new]).astype(np.int32)
        return (
            toks_np, host(lps[:, :max_new]), host(hit_eos_any), tt_np,
            None if tlb is None else host(tlb[:, :max_new]), host(pois), it - 1, aborted,
            host(count), host(row_iters),
        )

    # -- embeddings (similarity side-channel) -----------------------------
    @_one_launch_at_a_time
    @torch.inference_mode()
    def embed_tokens(self, token_lists: List[List[int]], max_tokens: int = 512) -> np.ndarray:
        """Mean-pooled final hidden states."""
        config = self.config
        token_lists = [ids[:max_tokens] or [config.bos_token_id] for ids in token_lists]
        longest = max(len(ids) for ids in token_lists)
        bucket = _bucket(longest, minimum=32)
        batch = _bucket(len(token_lists), minimum=8)
        dp = self.data_parallel_size
        batch = -(-batch // dp) * dp
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
