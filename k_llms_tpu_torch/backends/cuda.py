"""CUDA backend: KLLMs(backend="cuda") — the local PyTorch engine.

Counterpart of ``k_llms_tpu/backends/tpu.py``: the chat template, stop
strings, per-sample logprobs and usage of ``chat_completion`` are carried
over, and so is the serving chain every ``create()``/``parse()`` and
``embeddings()`` call follows:

1. the seed is pinned at submission (so a replay samples what the first
   attempt would have), the tenant's quota is charged, and the request's
   row cap comes from the device memory model (:class:`HbmMemoryModel`);
2. the request goes through ``EngineScheduler.call_batched``: its single
   worker coalesces same-key requests that arrive inside the batch window
   into one launch (``LocalEngine.generate_many`` of R requests × n rows);
3. the launch runs under ``EngineSupervisor.supervised_launch``, the
   watchdog that rebuilds the engine (``_rebuild_engine``) and replays the
   launch when it hangs or poison escalates;
4. ``generate_many`` splits a group in half on device OOM.

The scheduler's worker and the supervisor's launch threads issue their work
on the card's legacy default stream, like every other caller, so launches
stay in stream order and the arrival semaphores of the split-reduction
kernels (``ops/_ext.py``) stay sound: neither a rebuilt engine nor a launch
thread gets a stream of its own. The kernels are built when a backend is
constructed on a card, outside any watched launch.

The model overrides (dtype, max_seq_len, attention impls), weight
quantization, the KV-layout knobs, the prompt-prefix cache, checkpoint
loading, grammar-constrained decoding, the scheduler, memory-model,
watchdog, poison and tenancy knobs of the JAX package's ``BackendConfig``
are carried over under the same names and defaults: ``checkpoint_path``
loads a native or an HF safetensors checkpoint (``models/loader.py``,
integrity-verified; its summary is ``param_summary``), and a ``model`` name
that is not registered takes its config from the checkpoint's
``config.json``. A ``response_format`` compiles (once per schema and
vocabulary, through the process-wide grammar cache) into a token-mask
automaton that the engine applies inside decode
(``constrained_decoding=True``, the default). With
``continuous_batching=True`` qualifying requests (no logit bias, penalties
or top logprobs) join the continuous decode loop (``engine/continuous.py``,
chunked prefill included) instead of the coalescing scheduler, and with
``device_consensus=True`` (the default) consolidation scores its pairs and
votes on the engine's device (``consensus/device.py``). With
``chat_completion_stream`` (``create(stream=True)``, the SSE front door) the
engine's token tap or the loop's sink feeds :class:`_IncrementalDetok`,
which turns each step's tokens into per-sample text deltas; the serving
app's keep-alive, debug-surface and batch-lane settings are carried too. A
keyword that names one of the JAX package's other ``BackendConfig`` fields
raises ``NotImplementedError`` rather than being dropped.

A plain process builds its host's world itself, as JAX's one process drives
every local chip: where no process group runs, ``LOCAL_RANK`` is unset and
the host counts more than one rank (one a card, or ``KLLMS_LOCAL_RANKS``;
``parallel/distributed.py``), the constructor starts the other ranks as
fresh interpreters (``parallel/launcher.py``) before it builds the engine,
raising JAX's ``auto_mesh`` error first when ``model_parallel`` does not
divide the rank count. After JAX's multi-process start
(``initialize_multihost()`` with the ``KLLMS_*`` variables, which starts
each host's followers into one world across the hosts) the constructor
hands the host's followers their task instead. Every follower builds this
backend from this ``BackendConfig`` and resolved ``ModelConfig``, on its
own shard of the same weights. A caller passing ``engine=`` or ``mesh=``
starts nothing.

In a ``torch.distributed`` world larger than one, the backend takes its role
from its rank (``parallel/controller.py``): on each host's first rank it is
the controller and builds all of the above, announcing every launch and
embeddings forward to the host's other ranks; on those it is a follower,
whose constructor replays the controller's plans and returns after the
controller's ``close()``. ``is_controller`` tells the two apart. With
``continuous_batching`` the controller's loop is sized as in JAX, from the
memory model's ``tp``/``dp`` terms, and each follower builds a replica of it
from the controller's first loop plan: every admission, prefill chunk and
decode step of the loop is announced and replayed on every rank, each data
rank decoding every slot's whole rows, as JAX's loop does on its mesh. A
fault that needs an engine rebuild (the supervisor's hung launch or poison
escalation, the loop's hung step or chunk or corrupt pool) rebuilds the
engine on every rank, on the first engine's mesh
(:meth:`HostController.rebuild`; a follower's part is
:meth:`CudaBackend._follow_rebuild`), and the request is replayed. A fault
that stops a hand-started world (a follower's own, or an announced
operation that never ends) stops it for good (the typed 503), and so does
one of several processes, on every host (:meth:`_stop_world`, as a JAX job
stops with a lost process). A world of one host this backend started is
started again instead (:meth:`_restart_world`): the request in flight gets
the typed 503, as a JAX caller gets a launch's error, and the next is
served on new followers, a new mesh and a new engine on every rank;
``max_rebuilds`` restarts without a good launch in between end in
``STOPPED``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import logging
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from pydantic import BaseModel

from ..consensus.prompts import SYSTEM_PROMPT_STRING_CONSENSUS_LLM
from ..engine.engine import (
    MAX_STOP_LEN,
    MAX_STOP_SEQS,
    GenRequestSpec,
    LocalEngine,
    resolve_device,
)
from ..engine.scheduler import EngineScheduler
from ..engine.tokenizer import get_tokenizer
from ..models import loader
from ..models.config import get_config
from ..parallel.controller import EngineRetiredError, FollowerFaultError, HostController
from ..reliability.supervisor import EngineSupervisor, LaunchBudgetModel
from ..reliability.tenancy import TenancyConfig
from ..types import ChatCompletion
from ..types.wire import BackendUnavailableError
from ..utils.observability import LATENCY, current_trace
from .base import Backend, ChatRequest

logger = logging.getLogger(__name__)

# Embedding inputs crop at the same token cap as the reference client.
MAX_EMBEDDING_TOKENS = 8191


def _visible_token_count(tok, ids: List[int], pos: int, text: str) -> int:
    """Shortest token prefix whose decode reproduces the visible text
    ``text[:pos]`` (``text`` = the full decode of ``ids``)."""
    visible = text[:pos]
    for k in range(len(ids) + 1):
        prefix = tok.decode(ids[:k])
        if len(prefix) >= pos and prefix[:pos] == visible:
            return k
    return len(ids)


class BackendConfig(BaseModel):
    """The part of the JAX package's BackendConfig this backend serves, with
    its names and defaults."""

    model: str = "tiny"
    # A native or HF safetensors checkpoint directory (models/loader.py);
    # None = seeded random weights (param_seed).
    checkpoint_path: Optional[str] = None
    tokenizer_path: Optional[str] = None
    max_new_tokens: int = 256
    param_seed: int = 0
    # Model-config overrides.
    dtype: Optional[str] = None  # e.g. "bfloat16" | "float32"
    max_seq_len: Optional[int] = None
    attention_impl: Optional[str] = None  # prefill: "xla" | "flash"
    decode_attention_impl: Optional[str] = None  # dense decode: "xla" | "flash"
    # Weight quantization: None (model dtype), "int8" (per-channel) or
    # "int4" (group-wise, the w4a16 kernel).
    quantization: Optional[str] = None
    # The mesh (parallel/): the tensor-parallel degree (the "model" axis)
    # of the mesh an engine builds when torch.distributed runs a world
    # larger than one (every rank builds the same backend); in a world of
    # one these change nothing, as the JAX fields on one device.
    model_parallel: Optional[int] = None
    # Prompts at least this long prefill sequence-parallel over the data
    # axis. None disables; needs a data axis larger than one.
    sp_prefill_min_tokens: Optional[int] = None
    # Context-parallel attention of that prefill: "ring" | "ulysses".
    sp_attention: str = "ring"
    # Ring decode against the sequence-sharded prefix of a solo request.
    sp_decode: bool = False
    # KV layout: paged (pool pages, block tables) or dense (a stacked shared
    # prefix plus per-row generated caches).
    paged_kv: bool = True
    kv_page_size: int = 64
    paged_attention_impl: str = "auto"  # "auto" | "cuda" (or "pallas") | "xla"
    paged_generate_many: bool = True
    # Prompt-prefix KV cache: keep the last N prompts' KV and reuse the
    # longest common token prefix (>= prefix_cache_min_reuse tokens) of a
    # new prompt, prefilling only its suffix. 0 disables.
    prefix_cache_size: int = 0
    prefix_cache_min_reuse: int = 32
    # Page pool size; None sizes it from the first paged launch (and, with a
    # prefix cache, from the cache's size).
    kv_pool_pages: Optional[int] = None
    # Prompt-lookup speculative decoding (engine/engine.py ``_spec_decode``):
    # None or "prompt_lookup"; spec_lookahead drafts are verified per forward.
    # Speculative launches decode dense, and the continuous loop keeps
    # serving its requests without speculation, as in the JAX package.
    speculative: Optional[str] = None
    spec_lookahead: int = 4
    # Compile response_format JSON schemas into token-level grammar masks
    # (engine/grammar.py) applied in-decode. Unsupported schema features
    # degrade to the generic JSON mask, compile errors to unconstrained
    # decode; parse()'s post-hoc validation stays authoritative either way.
    # False = decode unconstrained and validate after the fact.
    constrained_decoding: bool = True
    # -- scheduler (engine/scheduler.py) ---------------------------------
    # Decode-admission window (seconds): after dequeuing a request the
    # scheduler holds the batch open this long for same-key arrivals to
    # coalesce. 0.0 = burst coalescing from queue backlog alone.
    batch_window: float = 0.005
    # Bounded admission: total queued weight (rows, i.e. n per request)
    # above which new work is shed with a typed 429. None = unbounded.
    max_queue_weight: Optional[int] = None
    # Hard cap on the coalesced device batch (rows). None = the scheduler's
    # default (64), further tightened per request by the memory model.
    max_batch_rows: Optional[int] = None
    # Device memory for the memory model. None = the card's total
    # (torch.cuda.mem_get_info) times the process's memory fraction; 16 GiB
    # on the CPU, where the model then caps nothing at test sizes.
    hbm_bytes: Optional[int] = None
    # Fraction of device memory the memory model may plan against.
    hbm_headroom: float = 0.85
    # Default timeout for drain()/close() graceful shutdown.
    drain_timeout: float = 30.0
    # SSE keep-alive: the serving layer emits a ``: ping`` comment frame on
    # streaming responses whenever this many seconds pass without a data
    # event (admission queue wait, long prefill), so idle-timeout proxies
    # don't sever the connection before the first token. 0 disables.
    sse_ping_interval_s: float = 15.0
    # Debug surfaces (GET /debug/requests flight recorder, POST /debug/profile
    # torch.profiler capture): off by default; they expose request metadata
    # and write profile dumps.
    debug_endpoints: bool = False
    # -- supervision (reliability/supervisor.py) -------------------------
    # Hung-launch watchdog budget: clamp(base + multiplier * max_new_tokens
    # * per-token EWMA) seconds per launch.
    watchdog_base_s: float = 10.0
    watchdog_per_token_s: float = 0.5
    watchdog_multiplier: float = 8.0
    watchdog_min_budget_s: float = 60.0
    watchdog_max_budget_s: float = 900.0
    # Consecutive engine rebuilds without a successful launch before the
    # backend goes STOPPED (typed 503s from then on).
    max_rebuilds: int = 2
    # Poisoned-sample fraction over the last poison_window launches at
    # which the supervisor rebuilds the engine.
    poison_threshold: float = 0.5
    poison_window: int = 8
    # -- tenancy (reliability/tenancy.py) --------------------------------
    # Per-tenant token-bucket quotas, WFQ weights and SLO classes; ``tenants``
    # maps a tenant name to TenantSpec overrides, ``tenant_api_keys`` an API
    # key to a tenant name. None rates = unlimited.
    tenant_default_weight: float = 1.0
    tenant_default_slo: str = "interactive"
    tenant_default_requests_per_s: Optional[float] = None
    tenant_default_rows_per_s: Optional[float] = None
    tenants: Optional[Dict[str, Dict[str, Any]]] = None
    tenant_api_keys: Optional[Dict[str, str]] = None
    # Queued-weight fraction of max_queue_weight at which batch-class
    # admissions are shed (brownout).
    brownout_high_water: float = 0.9
    # -- offline batch lane (serving/batch.py) ---------------------------
    # Durable root for the batch job store (journal + output segments);
    # None: the serving app falls back to KLLMS_BATCH_DIR or an ephemeral
    # tempdir (no restart recovery).
    batch_store_dir: Optional[str] = None
    # Bound on concurrently executing batch items.
    batch_max_in_flight: int = 4
    # Re-dispatches after a quota 429 before the item fails into the output.
    batch_item_retries: int = 1
    # TTL for terminal batch jobs, swept when the store opens; None/0 keeps
    # them forever.
    jobstore_ttl_s: Optional[float] = None
    # -- continuous in-flight batching (engine/continuous.py) -------------
    # Persistent decode loop with slot admission: requests join/leave a
    # fixed-width decode batch mid-flight instead of waiting for coalesced
    # groups to finish. Requests needing top_logprobs, penalties or
    # logit_bias still take the coalescing scheduler.
    continuous_batching: bool = False
    # Slot count (decode batch width). Clamped by the memory model's row
    # cap at (continuous_max_prompt + continuous_max_new) KV per slot.
    continuous_width: int = 8
    # Per-slot KV bounds; longer prompts / larger max_tokens take the
    # coalescing path.
    continuous_max_prompt: int = 512
    continuous_max_new: int = 256
    # Chunked prefill: prompts longer than this many tokens are ingested
    # into the loop chunk by chunk, one chunk between decode steps. None =
    # auto (HbmMemoryModel.prefill_chunk_tokens); 0 = off (whole-prompt
    # admission). Normalized down to a power of two >= 32 by the loop.
    prefill_chunk_tokens: Optional[int] = None
    # -- on-device consensus (consensus/device.py) ------------------------
    # Score consolidation's pairwise similarities and majority votes in
    # batches on the engine's device (the Levenshtein kernel, torch ops),
    # with a counted per-consolidation host fallback (failpoint, busy
    # device, error). False = always the host Python path.
    device_consensus: bool = True
    # Where the engine runs: None = the CUDA card (raises without one);
    # "cpu" runs the kernels' plain PyTorch versions.
    device: Optional[str] = None


#: Fields of the JAX package's BackendConfig that this backend has not
#: ported (none left). A keyword naming one raises NotImplementedError.
UNPORTED_FIELDS: frozenset = frozenset()

_MODEL_OVERRIDES = ("dtype", "max_seq_len", "attention_impl", "decode_attention_impl")


def _detect_hbm_bytes(device: torch.device) -> Optional[int]:
    """The card's memory this process may use: its total times the
    per-process memory fraction; None off a card."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    total = torch.cuda.mem_get_info(index)[1]
    fraction = getattr(torch.cuda, "get_per_process_memory_fraction", lambda i: 1.0)(index)
    return int(total * fraction)


class _IncrementalDetok:
    """Turns per-step token taps into per-sample TEXT deltas for SSE.

    Byte/BPE decodes are not prefix-stable token by token: a cut inside a
    multi-byte UTF-8 character decodes to U+FFFD, and HF-style decode cleanup
    can rewrite earlier characters when a token is appended. So each feed
    re-decodes the sample's full accumulated ids, holds back any replacement-
    character tail, and emits only a grown prefix extension — a step whose
    decode shrank or diverged emits nothing and later steps recover. Stop
    strings truncate here too (nothing past the earliest occurrence reaches
    the wire), mirroring chat_completion's authoritative host-side scan.

    ``flush_final`` reconciles against the finished choices: samples that
    never produced a delta (speculative decode and SP-prefix paths have no
    token tap) get their full text as one delta — the wire contract is at
    least one delta per live sample before the final consensus event.
    """

    def __init__(self, tok, n: int, pad_id: int, stop_strings: List[str],
                 emit) -> None:
        self.tok = tok
        self.n = n
        self.pad_id = pad_id
        self.stop_strings = stop_strings
        self.emit = emit
        self.ids: List[List[int]] = [[] for _ in range(n)]
        self.sent: List[str] = ["" for _ in range(n)]
        self.stopped = [False] * n

    def feed(self, step: int, toks: np.ndarray) -> None:
        for i in range(min(self.n, len(toks))):
            t = int(toks[i])
            if t == self.pad_id or self.stopped[i]:
                continue
            self.ids[i].append(t)
            text = self.tok.decode(self.ids[i])
            while text.endswith("�"):
                # Incomplete UTF-8 tail — hold it back until the next token
                # completes the character.
                text = text[:-1]
            cuts = [
                pos for s in self.stop_strings if (pos := text.find(s)) != -1
            ]
            if cuts:
                text = text[: min(cuts)]
                self.stopped[i] = True
            if len(text) > len(self.sent[i]) and text.startswith(self.sent[i]):
                delta = text[len(self.sent[i]):]
                self.sent[i] = text
                self.emit(i, delta)

    def flush_final(self, final_texts: List[Optional[str]]) -> None:
        for i, final in enumerate(final_texts):
            if final is None:
                continue
            sent = self.sent[i]
            if not sent:
                self.emit(i, final)
            elif final.startswith(sent):
                rest = final[len(sent):]
                if rest:
                    self.emit(i, rest)
            elif final != sent:
                # Streamed text diverged from the authoritative decode (decode
                # cleanup rewrote earlier characters). The final consensus
                # event carries the correct text; don't compound the drift.
                logger.debug(
                    "streamed text diverged from final decode for sample %d", i
                )


class HbmMemoryModel:
    """Static device-memory accounting for the coalesced decode: how many
    rows (samples) fit beside the resident parameters? The JAX package's
    model, per card of a (data, model) mesh of ``dp`` x ``tp`` ranks:

        params / tp                               (weights, sharded over TP)
      + (R / dp) * S * kv_bytes_per_token / tp    (KV: heads over TP, rows
                                                   over DP)
      + (R / dp) * row_margin                     (f32 logits, sampling)

    ``param_bytes`` is the whole tree's (the JAX engine's measure;
    ``LocalEngine.param_footprint_bytes(whole_tree=True)`` on a rank of a
    mesh). Inverting for R against ``hbm * headroom`` gives the row cap the
    scheduler may coalesce to for a request shape. Conservative and static:
    it keeps the first launch inside the card; the engine's OOM guard
    (split and retry) catches what it underestimates."""

    def __init__(self, config, param_bytes: int, hbm_bytes: Optional[int] = None,
                 headroom: float = 0.85, device: Optional[torch.device] = None,
                 tp: int = 1, dp: int = 1):
        self.config = config
        self.param_bytes = int(param_bytes)
        self.tp = max(1, int(tp))
        self.dp = max(1, int(dp))
        detected = hbm_bytes if hbm_bytes is not None else _detect_hbm_bytes(
            torch.device(device or "cpu")
        )
        # 16 GiB fallback (the JAX package's): on the CPU, test models are
        # then effectively uncapped.
        self.hbm_bytes = int(detected) if detected else 16 * (1 << 30)
        self.headroom = float(headroom)
        # K and V, every layer, kv_dim features per token.
        self.kv_bytes_per_token = 2 * config.num_layers * config.kv_dim * config.torch_dtype.itemsize
        # Per-row non-KV working set: f32 logits and sampling buffers.
        self.row_margin_bytes = 4 * config.vocab_size + (64 << 10)

    def budget_bytes(self) -> int:
        """Bytes available for per-row state after the parameters, per
        card."""
        return int(self.hbm_bytes * self.headroom) - self.param_bytes // self.tp

    def max_rows(self, seq_len: int) -> int:
        """Row cap for a dense decode whose rows each hold ``seq_len``
        tokens of KV. Always >= 1: a row that does not fit is the OOM
        guard's problem, not admission's."""
        per_row = max(1, int(seq_len)) * self.kv_bytes_per_token // self.tp + self.row_margin_bytes
        return max(1, self.dp * max(0, self.budget_bytes()) // max(1, per_row))

    def paged_max_rows(self, prompt_len: int, max_new: int, page_size: int,
                       fanout: int = 1) -> int:
        """Row cap when rows hold paged KV and every ``fanout`` rows share
        one prompt's pages: a row's private generation reserve plus
        ``1/fanout`` of the prompt pages."""
        ps = max(1, int(page_size))
        fanout = max(1, int(fanout))
        prompt_len = max(1, int(prompt_len))
        max_new = max(1, int(max_new))
        page_bytes = ps * self.kv_bytes_per_token // self.tp
        prompt_pages = -(-prompt_len // ps)
        reserve = (prompt_len + max_new - 1) // ps - prompt_len // ps + 1
        per_row = (
            reserve * page_bytes + -(-prompt_pages * page_bytes // fanout) + self.row_margin_bytes
        )
        return max(1, self.dp * max(0, self.budget_bytes()) // max(1, per_row))

    def prefill_chunk_tokens(self, width: int, max_prompt: int) -> int:
        """Auto chunk size for interleaved prefill. A decode step computes
        one token-row per active slot (<= ``width``); a C-token chunk costs
        ~C token-rows of the same per-layer work, so C ~= 4*width keeps a
        chunk within a small multiple of a decode step. Power of two,
        floored at 32, capped at max_prompt // 2 so chunking splits any
        prompt it engages on; 0 (off) when the prompt bound is too small for
        chunking to ever help."""
        if max_prompt < 64:
            return 0
        target = min(max(32, 4 * max(1, int(width))), max_prompt // 2)
        c = 32
        while c * 2 <= target:
            c *= 2
        return c

    def describe(self) -> Dict[str, Any]:
        return {
            "hbm_bytes": self.hbm_bytes,
            "headroom": self.headroom,
            "param_bytes": self.param_bytes,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "tp": self.tp,
            "dp": self.dp,
            "max_rows_at_max_seq": self.max_rows(self.config.max_seq_len),
        }


class CudaBackend(Backend):
    def __init__(
        self,
        model: Optional[str] = None,
        config: Optional[BackendConfig] = None,
        engine: Optional[LocalEngine] = None,
        mesh=None,
        model_config=None,
        **kwargs: Any,
    ):
        unported = sorted(UNPORTED_FIELDS.intersection(kwargs))
        if unported:
            raise NotImplementedError(
                f"BackendConfig field(s) {unported} of the JAX package are not ported "
                "to k_llms_tpu_torch yet"
            )
        unknown = sorted(set(kwargs) - set(BackendConfig.model_fields))
        if unknown:
            raise TypeError(f"CudaBackend got unknown keyword argument(s) {unknown}")
        if config is not None and model is not None and model != config.model:
            raise ValueError(
                f"model={model!r} conflicts with config.model={config.model!r}; "
                "pass one or make them agree"
            )
        cfg = config or BackendConfig(model=model or "tiny", **kwargs)
        self.backend_config = cfg
        self.model_name = cfg.model
        if model_config is None:
            model_config = self._resolve_model_config(cfg)
        if cfg.quantization not in (None, "int8", "int4"):
            raise ValueError(
                f"Unsupported quantization {cfg.quantization!r}; use 'int8' or 'int4'"
            )
        if cfg.sp_attention not in ("ring", "ulysses"):
            raise ValueError(
                f"Unknown sp_attention {cfg.sp_attention!r}; use 'ring' or 'ulysses'"
            )
        self.tokenizer = get_tokenizer(cfg.tokenizer_path)
        self._model_config = model_config
        self._mesh = mesh
        self.param_summary: Optional[Dict[str, Any]] = None
        # The world whose followers serve this backend (one this backend
        # started, of its process alone, or the one initialize_multihost
        # started), or None.
        self.world = None
        self._owns_world = False
        # kllms: unguarded — restarts since the last good launch; written by the watcher and the launch thread
        self._world_restarts = 0
        if engine is None and mesh is None:
            from ..parallel.distributed import spawns_world
            from ..parallel.launcher import host_world

            world = host_world()
            if world is not None:
                # initialize_multihost started this host's followers into
                # the world of every process: they build this backend.
                self._start_world(world.size, world)
            else:
                followers = spawns_world(cfg.device)
                if followers:
                    self._start_world(followers + 1)
        self._schemas: Dict[str, Any] = {}
        try:
            self.engine = engine if engine is not None else self._build_engine()
            # A rebuild lands on this engine's mesh and its groups, as JAX's
            # rebuild keeps its mesh: a new auto mesh would be a collective
            # over the whole world.
            self._mesh = self.engine.mesh
            # Every rank of a world larger than one: the host's first rank
            # controls, the others follow (a follower's constructor serves
            # the controller's plans until its close() and owns nothing
            # else).
            self.controller = self._control(HostController.for_world(self.engine))
        except BaseException as e:
            if self.world is not None:
                # No follower outlives a constructor that failed (in a world
                # of several processes, none does on any host).
                self.world.fail(e)
                if self._owns_world:
                    self.world.close()
            raise
        self.is_controller = self.controller is None or self.controller.is_controller
        if not self.is_controller:
            if self.engine.device.type == "cuda":
                from ..ops import _ext

                _ext.build_all()
            self.default_max_new_tokens = cfg.max_new_tokens
            self._closed = True
            # A rebuild plan drops the follower's engine: no frame here may
            # keep it.
            engine = None
            self.controller.serve()
            return
        if self.engine.device.type == "cuda":
            # Every kernel is built here, so no nvcc build ever runs inside
            # a watched launch (a cold build of the five sources takes tens
            # of seconds).
            from ..ops import _ext

            _ext.build_all()
        self.default_max_new_tokens = cfg.max_new_tokens
        # Row cap per request shape: prompt + max_new KV per row, paged or
        # dense, against the card's memory.
        # On a mesh: TP = the model axis, DP = the data axis (JAX's wiring),
        # over the whole tree's bytes, which the model divides by TP once.
        mesh = self.engine.mesh
        self.memory_model = HbmMemoryModel(
            self.engine.config,
            param_bytes=self.engine.param_footprint_bytes(whole_tree=True),
            hbm_bytes=cfg.hbm_bytes,
            headroom=cfg.hbm_headroom,
            device=self.engine.device,
            tp=1 if mesh is None else mesh.shape["model"],
            dp=self.engine.data_parallel_size,
        )
        self.tenancy = TenancyConfig.from_options(
            default_weight=cfg.tenant_default_weight,
            default_slo=cfg.tenant_default_slo,
            default_requests_per_s=cfg.tenant_default_requests_per_s,
            default_rows_per_s=cfg.tenant_default_rows_per_s,
            tenants=cfg.tenants,
            api_keys=cfg.tenant_api_keys,
        )
        # Every launch funnels through one scheduler: its single worker
        # coalesces concurrent same-key requests into one launch.
        scheduler_kwargs: Dict[str, Any] = {}
        if cfg.max_batch_rows is not None:
            scheduler_kwargs["max_rows"] = cfg.max_batch_rows
        self.scheduler = EngineScheduler(
            name=self.model_name,
            batch_window=cfg.batch_window,
            max_queue_weight=cfg.max_queue_weight,
            tenancy=self.tenancy,
            brownout_high_water=cfg.brownout_high_water,
            **scheduler_kwargs,
        )
        # Every launch runs under the watchdog; a hung or poison-escalated
        # engine is rebuilt through _rebuild_engine and the launch replayed.
        # The hooks are the scheduler's RECOVERING / READY / STOPPED
        # transitions.
        self.supervisor = EngineSupervisor(
            rebuild_fn=self._rebuild_engine,
            budget_model=LaunchBudgetModel(
                base_s=cfg.watchdog_base_s,
                per_token_s=cfg.watchdog_per_token_s,
                multiplier=cfg.watchdog_multiplier,
                min_budget_s=cfg.watchdog_min_budget_s,
                max_budget_s=cfg.watchdog_max_budget_s,
            ),
            max_rebuilds=cfg.max_rebuilds,
            poison_threshold=cfg.poison_threshold,
            poison_window=cfg.poison_window,
            on_recovering=self.scheduler.note_recovering,
            on_rebuilt=self.scheduler.note_rebuilt,
            on_rebuild_failed=self.scheduler.note_rebuild_failed,
        )
        # The thread of the latest supervised launch: a rebuild waits for a
        # hung one to end before it gives the old engine's memory back.
        self._launch_thread: Optional[threading.Thread] = None
        # The latest launch's watchdog budget: how long a rebuild across the
        # host waits for an announced operation to end.
        self._launch_budget_s = self.supervisor.budget_model.budget(1, cfg.max_new_tokens)
        self._wire_engine_hooks()
        # Consensus cache and dispatch stats ride along scheduler health().
        self.scheduler.consensus_stats_provider = self._consensus_stats
        self._closed = False
        # Continuous in-flight batching: a persistent slot-admission decode
        # loop beside the coalescing scheduler. Its admission follows the
        # scheduler's DRAINING/STOPPED lifecycle, so drain() quiesces both.
        self._continuous = None
        if cfg.continuous_batching:
            self._continuous = self._build_continuous_loop()
            if self.controller is not None:
                # Every follower builds the replica its plans drive, of this
                # loop's geometry.
                self.controller.loop = self._continuous
                self.controller.announce_loop("init", self._continuous.geometry())
        if self.world is not None:
            self.world.watch()

    @staticmethod
    def _resolve_model_config(cfg: "BackendConfig"):
        """The registered model of ``cfg.model`` (or a checkpoint's
        ``config.json``) with the config's overrides."""
        try:
            model_config = get_config(cfg.model)
        except KeyError:
            # Not a registered architecture name: a local HF checkpoint
            # directory carries its own config.json.
            model_config = (
                loader.config_from_hf(cfg.checkpoint_path) if cfg.checkpoint_path else None
            )
            if model_config is None:
                raise
        overrides = {k: getattr(cfg, k) for k in _MODEL_OVERRIDES if getattr(cfg, k) is not None}
        return model_config.with_(**overrides) if overrides else model_config

    # -- the world this backend started ----------------------------------------
    def _start_world(self, size: int, world=None) -> None:
        """Hand the host's other ``size - 1`` ranks this backend, before the
        engine is built: a world of this process alone is started here (and
        ends with this client); ``world``, one that
        :func:`.parallel.distributed.initialize_multihost` started across
        several processes (and that outlives its clients), is handed its
        task. JAX's ``auto_mesh`` error is raised before any follower
        builds; on a card every kernel is built first, so the followers find
        the build."""
        from ..parallel.distributed import local_device
        from ..parallel.launcher import SpawnedWorld, local_place

        cfg = self.backend_config
        mp = cfg.model_parallel or 1
        owned = world is None
        ranks = size if owned else world.host.world
        if ranks % mp != 0:
            raise ValueError(f"model_parallel={mp} does not divide device count {ranks}")
        device = resolve_device(cfg.device)
        if device.type == "cuda":
            from ..ops import _ext

            _ext.build_all()
        if owned:
            world = SpawnedWorld(size, local_device(0, device.type),
                                 local_place(size, device.type), self._restart_world,
                                 restartable=True)
            world.start()
        elif world.terminal is not None:
            raise world.terminal
        world.serve_backend({"config": cfg, "model_config": self._model_config})
        if not owned:
            world.on_lost = self._stop_world
        self.world, self._owns_world = world, owned

    def _control(self, controller):
        """Wire ``controller`` (None in a world of one) to this backend: the
        constraint codec, a follower's rebuild, and the world's owner."""
        if controller is not None:
            controller.encode_constraint = self._encode_constraint
            controller.decode_constraint = self._decode_constraint
            controller.on_rebuild = self._follow_rebuild
            if self.world is not None:
                controller.owner = self.world
                controller.generation = self.world.generation
        return controller

    def _restart_world(self, reason: str) -> None:
        """The world's watcher lost a rank (``reason``): start the world
        again. The lost world announces nothing more (its engine retired)
        and the operation in flight, which fails at once, leaves the launch
        lock; then the surviving followers and the process group end, and a
        new store, new followers, a new controller and mesh and a new engine
        on every rank take their place (the continuous loop restarts on it
        from a fresh ``("loop", "init")`` plan). Launches wait meanwhile.
        The scheduler sees RECOVERING, then READY; ``max_rebuilds`` restarts
        without a good launch in between give the world up: STOPPED and
        typed 503s."""
        world, cfg, loop = self.world, self.backend_config, self._continuous
        world.pause()
        old_engine = self.engine
        self.controller.lose(reason)
        lock = old_engine._launch_lock
        if lock.acquire(timeout=self._launch_budget_s):
            lock.release()
        while True:
            self._world_restarts += 1
            attempt = self._world_restarts
            if attempt > cfg.max_rebuilds:
                err = FollowerFaultError(
                    f"the host's world did not recover after {cfg.max_rebuilds} restart(s) "
                    f"without a good launch; last: {reason}")
                logger.error("%s", err)
                world.fail(err)
                world.close()
                if loop is not None:
                    loop.adopt_world(None, err)
                self.scheduler.note_rebuild_failed(err)
                return
            self.scheduler.note_recovering(attempt, "follower_lost")
            t0 = time.perf_counter()
            try:
                world.restart()
                self._mesh = None
                engine = self._build_engine()
                controller = self._control(HostController.for_world(engine))
            except Exception as e:
                logger.exception("starting the host's world again failed")
                reason = f"the restart failed: {type(e).__name__}: {e}"
                continue
            self._mesh = engine.mesh
            self.controller, self.engine = controller, engine
            self._wire_engine_hooks()
            if loop is not None:
                loop.adopt_world(engine)
            world.resume()
            self.scheduler.note_rebuilt()
            logger.warning("the host's world serves again (restart %d, %.1f s)",
                           world.restarts, time.perf_counter() - t0)
            break
        if old_engine.device.type == "cuda":
            old = weakref.ref(old_engine)
            del old_engine
            self._release_after(None, old)

    def _stop_world(self, reason: str) -> None:
        """A world of several processes lost a rank (``reason``: here, or
        the stop mark of another process): as a JAX job cannot survive a
        lost process, it stops on every host. The engine retires, this
        host's followers end, and the launch in flight and every later
        request get the typed 503; the scheduler is ``STOPPED``."""
        err = FollowerFaultError(f"a rank of the world was lost; the world is stopped: {reason}")
        controller = getattr(self, "controller", None)
        if controller is not None:
            controller.lose(reason)
        scheduler = getattr(self, "scheduler", None)
        if scheduler is not None:
            scheduler.note_rebuild_failed(err)
        loop = getattr(self, "_continuous", None)
        if loop is not None:
            loop.adopt_world(None, err)
        self.world.fail(err)

    def _serving_engine(self):
        """The current engine, once the world this backend started serves
        (a restart in progress is waited for; a world given up raises its
        typed error)."""
        if self.world is not None:
            self.world.wait_serving()
        return self.engine

    def _build_continuous_loop(self):
        from ..engine.continuous import ContinuousDecodeLoop

        cfg = self.backend_config
        if self.engine.kv_layout == "paged":
            if "continuous_width" not in cfg.model_fields_set:
                # No explicit width: size the loop from the no-sharing paged
                # cap, bounded at 32 slots.
                width = min(
                    self.memory_model.paged_max_rows(
                        cfg.continuous_max_prompt, cfg.continuous_max_new,
                        self.engine.kv_page_size, fanout=1,
                    ),
                    32,
                )
            else:
                # Paged rows share prompt pages across a fan-out; clamp
                # against the amortized cost at the loop's own width.
                width = min(
                    cfg.continuous_width,
                    self.memory_model.paged_max_rows(
                        cfg.continuous_max_prompt, cfg.continuous_max_new,
                        self.engine.kv_page_size, fanout=cfg.continuous_width,
                    ),
                )
        else:
            width = min(
                cfg.continuous_width,
                self.memory_model.max_rows(cfg.continuous_max_prompt + cfg.continuous_max_new),
            )
        chunk = cfg.prefill_chunk_tokens
        if chunk is None:
            chunk = self.memory_model.prefill_chunk_tokens(max(1, width), cfg.continuous_max_prompt)
        # The loop gets its OWN budget model: per-step latency must not mix
        # with the supervisor's per-launch EWMA, and vice versa.
        return ContinuousDecodeLoop(
            self.engine,
            width=max(1, width),
            max_prompt=cfg.continuous_max_prompt,
            max_new=cfg.continuous_max_new,
            eos_ids=self.tokenizer.stop_ids,
            admission_gate=self.scheduler.admission_error,
            budget_model=LaunchBudgetModel(
                base_s=cfg.watchdog_base_s,
                per_token_s=cfg.watchdog_per_token_s,
                multiplier=cfg.watchdog_multiplier,
                min_budget_s=cfg.watchdog_min_budget_s,
                max_budget_s=cfg.watchdog_max_budget_s,
            ),
            rebuild_fn=self._rebuild_loop_engine,
            max_rebuilds=cfg.max_rebuilds,
            on_recovering=self.scheduler.note_recovering,
            on_rebuilt=self.scheduler.note_rebuilt,
            on_rebuild_failed=self.scheduler.note_rebuild_failed,
            prefill_chunk_tokens=max(0, int(chunk)),
        )

    # -- engine lifecycle ----------------------------------------------------
    def _build_engine(self) -> LocalEngine:
        """The engine, on weights from ``checkpoint_path`` (loaded onto the
        engine's device and integrity-verified: a corrupt checkpoint raises
        CheckpointCorruptError) or seeded from ``param_seed``. Shared by
        construction and the supervisor's rebuild, so a recovery lands on
        the weights a cold start would load."""
        cfg = self.backend_config
        model_config = self._model_config
        params = None
        self.param_summary = None
        if cfg.checkpoint_path:
            params = loader.load_checkpoint(
                cfg.checkpoint_path, model_config, device=resolve_device(cfg.device)
            )
            self.param_summary = loader.last_load_summary
        return LocalEngine(
            model_config,
            params=params,
            param_seed=cfg.param_seed,
            device=cfg.device,
            quantize=cfg.quantization,
            # The engine has one layout: paged_generate_many=False gives
            # generate_many the dense body, as the JAX engine does, and the
            # continuous loop then runs dense too (the JAX loop would stay
            # paged).
            kv_layout="paged" if cfg.paged_kv and cfg.paged_generate_many else "dense",
            kv_page_size=cfg.kv_page_size,
            paged_attention_impl=cfg.paged_attention_impl,
            prefix_cache_size=cfg.prefix_cache_size,
            prefix_cache_min_reuse=cfg.prefix_cache_min_reuse,
            kv_pool_pages=cfg.kv_pool_pages,
            speculative=cfg.speculative,
            spec_lookahead=cfg.spec_lookahead,
            mesh=self._mesh,
            model_parallel=cfg.model_parallel,
            sp_prefill_min_tokens=cfg.sp_prefill_min_tokens,
            sp_attention=cfg.sp_attention,
            sp_decode=cfg.sp_decode,
        )

    def _wire_engine_hooks(self) -> None:
        """Device-OOM feedback (each caught OOM halves the scheduler's
        coalescing width, clean launches step it back up), the quarantine
        feed and the speculative launches' drafted/accepted accounting.
        Re-run after every rebuild so the hooks follow the new engine."""
        self.engine.on_oom = self.scheduler.note_oom
        self.engine.on_launch_ok = self.scheduler.note_recovered
        self.engine.on_quarantine = self._on_quarantine
        self.engine.on_spec_stats = self.scheduler.note_spec_stats

    def _on_quarantine(self, poisoned: int, total: int) -> None:
        # Fires after every launch (poisoned=0 when clean) so the
        # supervisor's escalation window decays under healthy traffic.
        self.scheduler.note_quarantine(poisoned)
        self.supervisor.note_poison(poisoned, total)

    def _rebuild_engine(self) -> None:
        """Supervisor rebuild_fn: stand up a fresh engine and drop the old,
        then give the old one's memory back to the card. A launch declared
        hung keeps its thread, and with it the old engine, until the hang
        ends (a kernel wedged on the card cannot be killed from the
        process): its memory goes back once that thread has ended, and
        until then the card holds both engines' weights. In a world the
        loop is held between operations while the engine is replaced across
        the host, so it announces nothing of the old one after the rebuild
        plan."""
        old = weakref.ref(self.engine)
        launch = self._launch_thread
        loop = self._continuous
        held = (loop.paused() if loop is not None and self.controller is not None
                else contextlib.nullcontext())
        with held:
            self._replace_engine()
            if loop is not None:
                # The loop holds device KV tied to the old engine: it
                # journals its in-flight rows, re-prefills on the new engine
                # and replays each survivor (pinned seeds, self-deterministic
                # row keys).
                loop.adopt_engine(self.engine)
        if self.engine.device.type != "cuda":
            return
        if launch is not None and launch.is_alive():
            threading.Thread(
                target=self._release_after, args=(launch, old),
                name="kllms-engine-release", daemon=True,
            ).start()
        else:
            self._release_after(None, old)

    def _rebuild_loop_engine(self) -> LocalEngine:
        """Continuous-loop rebuild_fn: the same reload as the supervisor's
        path, driven by the loop (which holds its own journal), returning
        the engine for the loop to adopt."""
        self._replace_engine()
        return self.engine

    def _replace_engine(self) -> None:
        """A new engine for the backend, built here, or in a world on every
        rank of the host through the rebuild plan (waiting at most the
        latest launch's budget for an announced operation to end)."""
        if self.controller is None:
            self.engine = self._build_engine()
        else:
            old = self.engine
            try:
                self.engine = self.controller.rebuild(self._build_engine, self._launch_budget_s)
            except BackendUnavailableError:
                if self.world is None:
                    raise
                # The rebuild stopped a world this backend started (an
                # operation hung after its plan): its restart builds the
                # new engine on every rank.
                self._await_restart(old)
                return
        self._wire_engine_hooks()

    def _await_restart(self, old) -> None:
        """Wait until the world's restart has replaced ``old`` and serves
        (its typed error once it is given up)."""
        while self.engine is old and self.world.terminal is None:
            time.sleep(0.01)
        self.world.wait_serving()

    def _follow_rebuild(self) -> None:
        """A follower's part of the controller's rebuild plan: the replica
        loop empties, the old engine is dropped and its memory given back
        (a follower runs no hung thread), then the new engine is built on
        the same mesh and adopted."""
        ctl = self.controller
        if ctl.loop is not None:
            ctl.loop.reset_replica(None)
        old, device = weakref.ref(self.engine), self.engine.device
        self.engine = ctl.engine = None
        if device.type == "cuda":
            self._release_after(None, old)
        self.engine = self._build_engine()
        ctl.adopt(self.engine)
        if ctl.loop is not None:
            ctl.loop.reset_replica(self.engine)

    @staticmethod
    def _release_after(thread: Optional[threading.Thread], engine_ref) -> None:
        if thread is not None:
            thread.join()
        if engine_ref() is not None:
            gc.collect()
        torch.cuda.empty_cache()

    def _supervised(self, launch, rows: int, max_new_tokens: int):
        """``launch(engine)`` under the watchdog, always on the current
        engine: a replay after a rebuild lands on the new one."""

        def run():
            self._launch_thread = threading.current_thread()
            epoch = self.supervisor.epoch
            engine = self.engine
            while True:
                try:
                    out = launch(engine)
                    if not (isinstance(out, list)
                            and any(isinstance(r, BaseException) for r in out)):
                        self._world_restarts = 0
                    return out
                except EngineRetiredError:
                    # The loop rebuilt the engine across the host, or the
                    # world was started again, before this launch was
                    # announced: nothing ran, so it runs on the new one (a
                    # launch the watchdog gave up on does not).
                    if self.supervisor.epoch != epoch or self._serving_engine() is engine:
                        raise
                    engine = self.engine

        self._launch_budget_s = self.supervisor.budget_model.budget(rows, max_new_tokens)
        # A restart of the world in progress is waited for outside the
        # watchdog's budget.
        self._serving_engine()
        if self.world is not None and not self.world.restartable:
            # A world of several processes: the caller gets the stop's 503
            # even while the launch waits on another host's rank.
            return self.world.until_stopped(self.supervisor.supervised_launch, run,
                                            rows=rows, max_new_tokens=max_new_tokens)
        return self.supervisor.supervised_launch(run, rows=rows, max_new_tokens=max_new_tokens)

    # -- chat -------------------------------------------------------------
    supports_streaming = True

    def chat_completion_stream(self, request: ChatRequest, emit) -> ChatCompletion:
        """Streaming wire contract: per-token text deltas via ``emit(i, text)``
        while the decode runs, then the full ChatCompletion for consolidation.
        Same generation as chat_completion; only the tap differs."""
        return self.chat_completion(request, _token_emit=emit)

    def chat_completion(self, request: ChatRequest, _token_emit=None) -> ChatCompletion:
        tok = self.tokenizer
        prompt_ids = tok.apply_chat_template(request.messages, add_generation_prompt=True)
        n = max(1, request.n)
        temperature = 1.0 if request.temperature is None else float(request.temperature)
        max_new = request.max_tokens or self.default_max_new_tokens
        # Structured-output requests decode under a grammar mask: a pydantic
        # response_format compiles to a CompiledGrammar over this tokenizer's
        # byte strings; anything the schema compiler cannot express degrades
        # to the valid-JSON mask, and compile errors or
        # constrained_decoding=False to unconstrained decode.
        _req_trace = current_trace()
        if _req_trace is not None:
            with _req_trace.phase("grammar_mask"):
                constraint = self._constraint_for(request.response_format)
        else:
            constraint = self._constraint_for(request.response_format)
        top_lp = request.top_logprobs if request.logprobs else None
        logit_bias = None
        if request.logit_bias:
            V = self.engine.config.vocab_size
            logit_bias = {}
            for tok_id, bias in request.logit_bias.items():
                t = int(tok_id)
                if not 0 <= t < V:
                    raise ValueError(f"logit_bias token id {t} outside vocab (0..{V-1})")
                logit_bias[t] = float(bias)
        stop_strings: List[str] = []
        if isinstance(request.stop, str):
            stop_strings = [request.stop]
        elif isinstance(request.stop, list):
            stop_strings = [s for s in request.stop if s]
        # Tokenized stops halt rows in the decode loop; the text scan below
        # stays authoritative for over-long stops and re-tokenization cases.
        stop_seqs = [
            ids_s
            for ids_s in (tok.encode(s) for s in stop_strings)
            if 0 < len(ids_s) <= MAX_STOP_LEN
        ][:MAX_STOP_SEQS] or None

        detok = None
        if _token_emit is not None:
            detok = _IncrementalDetok(
                tok, n, self.engine.config.pad_token_id, stop_strings, _token_emit,
            )

        result = self._generate_batched(
            prompt_ids,
            n=n,
            max_new=max_new,
            temperature=temperature,
            top_p=request.top_p,
            seed=request.seed,
            constraint=constraint,
            top_logprobs=top_lp,
            frequency_penalty=float(request.frequency_penalty or 0.0),
            presence_penalty=float(request.presence_penalty or 0.0),
            logit_bias=logit_bias,
            stop_sequences=stop_seqs,
            budget=request.budget,
            token_sink=detok.feed if detok is not None else None,
            tenant=request.tenant,
        )

        choices: List[Dict[str, Any]] = []
        final_texts: List[Optional[str]] = []
        completion_tokens = 0
        for i in range(n):
            err = result.sample_errors[i] if result.sample_errors else None
            if err is not None:
                choices.append(
                    {
                        "finish_reason": "stop",
                        "index": i,
                        "message": {"role": "assistant", "content": ""},
                        "logprobs": None,
                        "sample_logprob": 0.0,
                        "sample_error": dict(err),
                    }
                )
                final_texts.append("")
                continue
            length = int(result.lengths[i])
            ids = [int(t) for t in result.tokens[i][:length]]
            text = tok.decode(ids)
            finish = result.finish_reasons[i]
            cuts = [pos for s in stop_strings if (pos := text.find(s)) != -1]
            if cuts:
                pos = min(cuts)
                finish = "stop"
                length = _visible_token_count(tok, ids, pos, text)
                text = text[:pos]
            completion_tokens += length
            logprobs_payload = None
            if request.logprobs:
                _tok_bytes = getattr(
                    tok, "token_bytes", lambda t: tok.decode([t]).encode("utf-8")
                )

                def _top_entries(step: int):
                    if result.top_tokens is None:
                        return []
                    return [
                        {
                            "token": tok.decode([int(tid)]),
                            "logprob": float(tlp),
                            "bytes": list(_tok_bytes(int(tid))),
                        }
                        for tid, tlp in zip(
                            result.top_tokens[i][step].tolist(),
                            result.top_logprobs[i][step].tolist(),
                        )
                    ]

                logprobs_payload = {
                    "content": [
                        {
                            "token": tok.decode([t]),
                            "logprob": float(lp),
                            "bytes": list(_tok_bytes(int(t))),
                            "top_logprobs": _top_entries(j),
                        }
                        for j, (t, lp) in enumerate(
                            zip(ids, result.logprobs[i][:length].tolist())
                        )
                    ]
                }
            choices.append(
                {
                    "finish_reason": finish,
                    "index": i,
                    "message": {"role": "assistant", "content": text},
                    "logprobs": logprobs_payload,
                    # Sequence-level sample log-likelihood (extension field);
                    # feeds likelihood-weighted consensus.
                    "sample_logprob": float(np.sum(result.logprobs[i][:length])),
                }
            )
            final_texts.append(text)

        if detok is not None:
            # Reconcile the streamed deltas against the authoritative texts.
            detok.flush_final(final_texts)

        digest = hashlib.md5(repr((request.messages, request.seed)).encode()).hexdigest()[:12]
        payload: Dict[str, Any] = {
            "id": f"chatcmpl-cuda-{digest}",
            "choices": choices,
            "created": int(time.time()),
            "model": request.model or self.model_name,
            "object": "chat.completion",
            "system_fingerprint": f"k-llms-tpu-torch/{self.model_name}",
            "usage": {
                "prompt_tokens": result.prompt_len,
                "completion_tokens": completion_tokens,
                "total_tokens": result.prompt_len + completion_tokens,
            },
        }
        if os.getenv("KLLMS_TRACE") == "1":
            # Serving stats captured at generation time for this request
            # (result.spec_stats rides the GenerationResult, so a concurrent
            # request cannot overwrite it before tracing reads it); cache and
            # scheduler counters are cumulative snapshots.
            payload["engine_stats"] = {
                "spec": dict(result.spec_stats or {}),
                "prefix_cache": dict(self.engine.prefix_cache_stats),
                "scheduler": dict(self.scheduler.stats),
            }
        return ChatCompletion.model_validate(payload)

    def _generate_batched(
        self,
        prompt_ids: List[int],
        *,
        n: int,
        max_new: int,
        temperature: float,
        top_p: Optional[float],
        seed: Optional[int],
        constraint: Any,
        top_logprobs: Optional[int] = None,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        logit_bias: Optional[Dict[int, float]] = None,
        stop_sequences: Optional[List[List[int]]] = None,
        budget=None,
        token_sink=None,
        tenant=None,
    ):
        """Submit one generation through the coalescing scheduler: concurrent
        requests with the same sampling config decode as one launch of
        ``LocalEngine.generate_many``; a lone request runs solo. ``budget``
        rides both the scheduler item (admission, window bound, queue
        shedding) and the GenRequestSpec (the decode loop's abort poller);
        it is not part of the batch key. ``tenant`` bills this request's rows
        to that tenant's buckets and keys its fair-queue; an over-quota
        request gets a typed 429 here."""
        ckey = None
        if constraint is not None:
            ckey = (
                "json" if constraint == "json" else (type(constraint).__name__, constraint.digest)
            )
        eos_ids = self.tokenizer.stop_ids
        # Coalesced rows share one bias vector and one stop matrix, so only
        # identical ones may fuse.
        bias_key = tuple(sorted(logit_bias.items())) if logit_bias else None
        stop_key = tuple(map(tuple, stop_sequences)) if stop_sequences else None
        batch_key = (
            max_new, temperature, top_p, ckey, tuple(eos_ids), top_logprobs,
            frequency_penalty, presence_penalty, bias_key, stop_key,
        )
        # Pin the sampling seed at submission: with seed=None the engine
        # would draw fresh entropy per launch, and a watchdog replay would
        # sample other tokens than the abandoned attempt.
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        rows = max(1, n)
        # Charged once, before routing: a loop rejection that falls back to
        # coalescing must not bill the request twice.
        tenant_ctx = self.scheduler.charge_tenant_quota(tenant, rows=rows)

        # Continuous in-flight batching: qualifying requests join the slot
        # loop. top_logprobs, penalties and logit bias stay on the
        # coalescing path; CompiledGrammar constraints qualify (a schema
        # other than the loop's resident one raises ValueError below and
        # coalesces); stop sequences qualify, since the text scan is
        # authoritative (the loop decodes to eos/max_new).
        from ..engine.grammar import CompiledGrammar

        loop_grammar = constraint if isinstance(constraint, CompiledGrammar) else None
        if (
            self._continuous is not None
            and (constraint is None or loop_grammar is not None)
            and top_logprobs is None
            and frequency_penalty == 0.0
            and presence_penalty == 0.0
            and logit_bias is None
            and self._continuous.qualifies(len(prompt_ids), rows, max_new)
        ):
            try:
                out = self._continuous.submit(
                    list(prompt_ids),
                    n=rows,
                    max_new=max_new,
                    temperature=temperature,
                    top_p=top_p,
                    seed=seed,
                    budget=budget,
                    token_sink=token_sink,
                    grammar=loop_grammar,
                    tenant=tenant_ctx,
                ).result()
                self._world_restarts = 0
                return out
            except ValueError:
                # The prompt outgrew the loop's bounds, or the loop is busy
                # under a different grammar: coalescing path.
                pass

        def run(specs):
            t0 = time.perf_counter()
            out = self._supervised(
                lambda engine: engine.generate_many(
                    specs,
                    max_new_tokens=max_new,
                    temperature=temperature,
                    top_p=top_p,
                    eos_ids=eos_ids,
                    constraint=constraint,
                    top_logprobs=top_logprobs,
                    frequency_penalty=frequency_penalty,
                    presence_penalty=presence_penalty,
                    logit_bias=logit_bias,
                    stop_sequences=stop_sequences,
                ),
                rows=sum(max(1, s.n) for s in specs),
                max_new_tokens=max_new,
            )
            LATENCY.observe("engine.decode_launch", time.perf_counter() - t0)
            return out

        # The memory model's row cap for this request's KV: any group it
        # joins is clipped to the tightest member's cap. Paged rows share
        # their prompt's pages, so the cap is the paged per-group reserve;
        # speculative launches decode dense, so theirs is the dense cap.
        if self.engine.kv_layout == "paged" and self.backend_config.speculative is None:
            max_rows = self.memory_model.paged_max_rows(
                len(prompt_ids), max_new, self.engine.kv_page_size, fanout=rows
            )
        else:
            max_rows = self.memory_model.max_rows(len(prompt_ids) + max_new)
        return self.scheduler.call_batched(
            batch_key,
            GenRequestSpec(list(prompt_ids), n, seed, budget, token_sink),
            run,
            weight=rows,
            budget=budget,
            max_rows=max_rows,
            tenant=tenant_ctx,
        )

    def _constraint_for(self, response_format: Any):
        if response_format is None:
            return None
        schema = None
        wants_json = False
        if isinstance(response_format, type) and hasattr(response_format, "model_json_schema"):
            schema = response_format.model_json_schema()
        elif isinstance(response_format, dict):
            kind = response_format.get("type")
            if kind == "json_object":
                wants_json = True
            elif kind == "json_schema":
                # OpenAI wire form: {"type": "json_schema", "json_schema": {"schema": ...}}
                schema = (response_format.get("json_schema") or {}).get("schema")
                wants_json = True  # schema-less json_schema payload degrades to JSON mask
        if schema is None and not wants_json:
            # {"type": "text"} and unrecognized forms are unconstrained — only
            # an explicit JSON request earns the grammar mask.
            return None
        if not self.backend_config.constrained_decoding:
            # Post-hoc-only posture: decode unconstrained, parse() validates
            # after the fact (byte-identical to no response_format).
            return None
        # Compile-or-fetch through the process-wide grammar cache, keyed by
        # (schema digest, vocab digest). Never raises; None = unconstrained
        # + post-hoc validation (a compile error, counted in GRAMMAR_EVENTS).
        from ..engine.grammar import grammar_for_schema

        vocab, vocab_digest = self._grammar_vocab()
        compiled = grammar_for_schema(schema, vocab, vocab_digest=vocab_digest)
        if compiled is not None and getattr(self, "controller", None) is not None:
            self._schemas[compiled.digest] = schema
        return compiled

    def _grammar_vocab(self):
        """(per-token byte strings, digest) for this backend's tokenizer —
        computed once; the digest is the grammar cache key's vocabulary half."""
        if getattr(self, "_grammar_vocab_cache", None) is None:
            from ..engine.grammar import grammar_vocab
            from ..engine.token_constraint import _vocab_digest

            vocab = grammar_vocab(self.tokenizer)
            self._grammar_vocab_cache = (vocab, _vocab_digest(vocab))
        return self._grammar_vocab_cache

    # -- embeddings -------------------------------------------------------
    def embeddings(self, texts: List[str]) -> List[List[float]]:
        token_lists = [self.tokenizer.encode(t)[:MAX_EMBEDDING_TOKENS] for t in texts]

        def run(payloads):
            # Concurrent embedding batches coalesce into one forward,
            # supervised as a 1-token launch.
            flat = [tl for p in payloads for tl in p]
            pooled = self._supervised(
                lambda engine: engine.embed_tokens(flat), rows=max(1, len(flat)), max_new_tokens=1
            )
            out, i = [], 0
            for p in payloads:
                out.append(pooled[i: i + len(p)])
                i += len(p)
            return out

        # window=0: opportunistic coalescing only; a forward takes a few ms.
        pooled = self.scheduler.call_batched(
            ("embed",), token_lists, run, weight=max(1, len(token_lists)),
            window=0.0, trace_phase="embed",
        )
        return [[float(x) for x in row] for row in pooled]

    def crop_texts(
        self, texts: List[str], max_tokens: int, model: Optional[str] = None
    ) -> List[str]:
        tok = self.tokenizer
        return [
            t
            if len(t.encode("utf-8")) < max_tokens
            else tok.decode(tok.encode(t)[:max_tokens])
            for t in texts
        ]

    # -- llm-consensus ----------------------------------------------------
    def llm_consensus(self, values: List[str]) -> str:
        assert len(values) > 0, "Cannot build consensus string from empty list"
        messages = [
            {"role": "system", "content": SYSTEM_PROMPT_STRING_CONSENSUS_LLM},
            {"role": "user", "content": f"Input: {[json.dumps(v) for v in values]}\nOutput:"},
        ]
        ids = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        # Batched like user requests: concurrent consolidations' calls
        # coalesce into one greedy decode.
        result = self._generate_batched(
            ids, n=1, max_new=128, temperature=0.0, top_p=None, seed=None, constraint=None
        )
        text = self.tokenizer.decode(
            [int(t) for t in result.tokens[0][: int(result.lengths[0])]]
        ).strip()
        return text if text else values[0]

    # -- lifecycle -----------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Serving-health snapshot: the scheduler's lifecycle state and
        queue and shed counters, the breaker, the engine's OOM and
        quarantine stats, the supervisor, the memory model's planning view
        and the page pool. No device work."""
        snap = self.scheduler.health()
        snap["breaker"] = self.circuit_breaker.state
        snap["engine_oom"] = dict(self.engine.oom_stats)
        snap["memory_model"] = self.memory_model.describe()
        snap["supervisor"] = self.supervisor.stats()
        snap["quarantine"] = dict(self.engine.quarantine_stats)
        snap["params"] = self.param_summary
        if self._continuous is not None:
            snap["continuous"] = dict(self._continuous.stats)
        if self.world is not None:
            snap["world"] = self.world.stats()
        hbm: Dict[str, Any] = {
            "param_bytes": self.memory_model.param_bytes,
            "kv_bytes_per_token": self.memory_model.kv_bytes_per_token,
            "budget_bytes": self.memory_model.budget_bytes(),
            "paged": self.engine.kv_layout == "paged",
            "page_size": self.engine.kv_page_size,
        }
        pool = self.engine._kv_pool
        if pool is not None:
            hbm["page_pool"] = pool.allocator.snapshot()
        snap["hbm"] = hbm
        snap["consensus"] = self._consensus_stats()
        from ..engine.grammar import grammar_cache_stats

        grammar = snap.setdefault("grammar", {})
        grammar["enabled"] = bool(self.backend_config.constrained_decoding)
        grammar["cache"] = grammar_cache_stats()
        return snap

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: close admission (new requests get a typed 503),
        finish queued and in-flight groups, join the scheduler's worker.
        True when everything completed within ``timeout`` (default
        ``BackendConfig.drain_timeout``). Idempotent."""
        self._closed = True
        t = self.backend_config.drain_timeout if timeout is None else timeout
        ok = True
        if self._continuous is not None:
            # Quiesce the slot loop first: its in-flight rows finish on its
            # own worker, not the scheduler's.
            ok = self._continuous.drain(timeout=t)
        return self.scheduler.drain(timeout=t) and ok

    def close(self) -> None:
        if not self.is_controller:
            return  # a follower's world ended with its controller's close()
        if not (self._closed and self.scheduler.state.value == "stopped"):
            self.drain()
            if self._continuous is not None:
                self._continuous.stop()
        world = self.world
        if world is not None and self._owns_world:
            # A restart in progress ends first; the children's exits from
            # here on are the close's.
            world.closing()
        if self.controller is not None:
            self.controller.close()
        if world is not None:
            # Each follower's constructor returns on the close plan. A world
            # this client started ends with it (every child exits 0 before
            # close() returns); one of several processes waits for the next
            # client.
            if self._owns_world:
                world.close()
            else:
                world.release_backend()

    # -- the controller's constraint codec ----------------------------------
    def _encode_constraint(self, constraint):
        """A launch's constraint for the followers: a grammar this backend
        compiled from a schema travels as that schema."""
        digest = getattr(constraint, "digest", None)
        if digest is not None and digest in self._schemas:
            return ("schema", self._schemas[digest], digest)
        return ("object", constraint)

    def _decode_constraint(self, encoded):
        if encoded[0] != "schema":
            return encoded[1]
        from ..engine.grammar import grammar_for_schema

        _, schema, digest = encoded
        vocab, vocab_digest = self._grammar_vocab()
        compiled = grammar_for_schema(schema, vocab, vocab_digest=vocab_digest)
        if compiled is None or compiled.digest != digest:
            raise RuntimeError(
                f"follower compiled schema grammar {getattr(compiled, 'digest', None)} "
                f"where the controller has {digest}"
            )
        return compiled

    # -- on-device consensus ----------------------------------------------
    def similarity_scorer(self, method: str):
        """Per-method scorer registry, like the base, but constructing the
        device scorer on the engine's device when ``device_consensus`` is on
        (the plain host scorer when that device is unusable; run-time
        fallback is per consolidation, inside the device scorer)."""
        if not self.backend_config.device_consensus:
            return super().similarity_scorer(method)
        from ..consensus.device import DeviceConsensusUnavailable, DeviceSimilarityScorer
        from ..consensus.similarity import SimilarityScorer
        from ..utils.observability import CONSENSUS_EVENTS

        with Backend._scorer_registry_lock:
            registry = self.__dict__.setdefault("_similarity_scorers", {})
            scorer = registry.get(method)
            if scorer is None:
                try:
                    scorer = DeviceSimilarityScorer(
                        method=method, embed_fn=self.embeddings, device=self.engine.device
                    )
                except DeviceConsensusUnavailable:
                    CONSENSUS_EVENTS.record("consensus.fallback_unavailable")
                    scorer = SimilarityScorer(method=method, embed_fn=self.embeddings)
                registry[method] = scorer
            return scorer

    def _consensus_stats(self) -> Dict[str, Any]:
        """Cache totals, the per-scorer breakdown and the dispatch counters,
        surfaced in scheduler health and ``health()``."""
        from ..utils.observability import CONSENSUS_EVENTS

        agg = {"hits": 0, "misses": 0, "entries": 0, "evictions": 0}
        caches: Dict[str, Any] = {}
        with Backend._scorer_registry_lock:
            scorers = dict(self.__dict__.get("_similarity_scorers") or {})
        for method, scorer in scorers.items():
            stats = scorer.cache_stats()
            caches[method] = stats
            for st in stats.values():
                for k in agg:
                    agg[k] += st.get(k, 0)
        return {
            "device_consensus": bool(self.backend_config.device_consensus),
            "cache": agg,
            "caches": caches,
            "events": {
                k: v for k, v in CONSENSUS_EVENTS.snapshot().items() if k.startswith("consensus.")
            },
        }
