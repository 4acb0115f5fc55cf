#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (k_llms_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from ``k_llms_tpu_torch/csrc``, holds each one
against its plain PyTorch version at the shapes the main paths give it (with
mutants of the plain version that each limit must catch), drives ``tiny`` in
fp32 through the kernels and through the plain paths (paged, dense with the
decode-prefix kernel, and an int4-eligible small config), then serves
Llama-3-8B at full published width (seeded random weights, the byte
tokenizer) through ``KLLMs(backend="cuda").chat.completions.create`` twice:
bf16 weights on the paged path (``8b``: K2, K1), and int4 weights on the
dense path with flash decode (``8b_int4``: K2, K3, K4). Between the two,
``ckpt`` writes the ``8b`` phase's seeded tree to disk as an HF Llama
checkpoint (sharded safetensors, ``config.json``; about 16 GB under
``_smoke_tmp/`` of the checkout, removed at the end of the phase), loads it
back through ``KLLMs(model=<dir>, checkpoint_path=<dir>)`` in bf16 on the
paged path (the same tokens and logprobs as ``8b``) and quantized to int4 at
load on the dense flash path, and on both clients drives the prompt-prefix
cache through a miss, a partial hit (K2 in its ``q_offset`` mode inside the
model) and an exact hit (no prefill). Every kernel launch counter is reset
just before each of those paths and read just after. Every request runs
through the backend's scheduler and supervisor; ``sched`` drives them on
purpose: on both 8B clients four requests queued behind the parked
scheduler worker and served by one launch (its launch counts asserted,
each member bit-equal to a direct launch of the same specs), on the bf16
client the abort poller, the device-OOM split (the ``oom`` failpoint, then
a real OOM under a memory fraction between a solo launch's peak and the
group's) and a poison-escalated rebuild, and at ``tiny`` the watchdog's
hang, rebuild and replay, rebuild exhaustion, failover and hedging.
Consolidation runs on the card (``device_consensus=True``, the default):
every counted window also asserts the Levenshtein kernel's launches as the
device consensus planned them and no host fallback. ``consensus`` holds
that kernel (``csrc/levenshtein.cu``) to its plain version and the native
code at every length bucket, with two mutants of its source, times it, and
on the 8B client consolidates a ``parse()`` at n = 8 and a ``create()`` at
n = 32 again on the host and on the card (equal answers, both timed).
``loop`` serves the continuous decode loop: on a bf16 paged 8B client (32
slots, chunked prefill of 128 tokens) four requests joining mid-flight,
one of them the 1490-token prompt in 12 chunks and one a grammar-
constrained ``parse()``, with a logit-bias request coalescing while the
loop decodes; on an int4 dense 8B client two of them; at ``tiny`` a hung
step and a hung chunk rebuilt and replayed. ``gemma9b``, ``mistral7b`` and
``mixtral_int4`` serve the other model families at their full published
widths (Mixtral at half its depth; seeded weights, the byte tokenizer's
special ids) through
``KLLMs(backend="cuda", model=..., attention_impl="flash")``: Gemma-2-9B and
Mistral-7B in bf16 on the paged path (K2 with softcap, the 4096-key window
and head dim 256 in prefill, a prompt longer than the window; the paged
decode on the reference attention, which the JAX routing gives softcapped
and windowed models: K1 asserted at 0, the reference's dispatches counted),
Mixtral-8x7B quantized to int4 (attention and head on K4, the experts int8)
on the paged path with K1; each with its launch counts asserted, its peak
memory and the plain decode attention's cost per step. ``serve`` puts the
``8b`` client behind the OpenAI-wire HTTP front door
(``ServerThread(create_app(client))`` on loopback, talked to with
``http.client``): a JSON request equal to ``create()``; a stream whose
every sample gets a delta before the final event, whose deltas equal the
final texts and whose final event equals a non-streamed call (time to
first delta and chunk gaps logged); the token tap's decode cost per step,
streamed against not, in alternating runs; two streams and a JSON request
fused into one launch, equal to the same group without streams; a client
that hangs up after its first delta (the launch aborts, its pages return,
the next request is served); ``/healthz``, ``/metrics`` and
``/debug/requests``; a 4-line batch job. ``loop`` adds a grammar-
constrained stream through the continuous loop. ``sanitize`` arms the
lock-order and lockset sanitizers (``KLLMS_LOCKCHECK=1``,
``KLLMS_RACECHECK=1``) over a continuous-batching backend on the ``8b``
weights behind loopback HTTP: mixed traffic unarmed and armed in turns
(both timed), then armed with two hangs healed by the watchdog and a
poisoned launch, every request resolved, the plain requests equal to their
unarmed solo runs, the pool conserved, READY, no violation; then a K1
launch under a lock made without ``allow_dispatch`` and a two-thread lock
inversion must each be caught once, and the lint
(``python -m k_llms_tpu_torch.analysis --check``) runs once. ``parity``
(on the ``8b`` client after ``sanitize``, or on a client of its own)
embeds the texts of ``tests/test_embedding_signal.py`` in one forward
through K2 (one launch a layer, nothing else), records their cosines and
orderings, asserts the majority medoid election over a cluster and an
outlier under the card's embeddings and under Levenshtein, and serves one
seeded sampled request twice: tokens, logprobs, choices and likelihoods
byte-identical, every launch counted. ``mesh``
(last) serves Llama-3-8B's widths (at 8 of its 32 layers, the TP loop at
16, the multi-process job at 32: ``MESH_LAYERS``)
on meshes of ranks on the one card (NCCL refuses two ranks on one
device, so the ranks talk over gloo, staging each collective's bytes
through host memory), each rank building the same ``KLLMs`` with the mesh
fields and cutting its shard of the same seeded tree: JAX's multi-process
start (``mesh_hosts``: two host processes, each with the three
``KLLMS_*`` variables on loopback and ``KLLMS_LOCAL_RANKS=2``, call
``initialize_multihost()``, which starts each host's follower into one
world of four ranks, and build ``8b_int4``'s client with
``model_parallel=2``: a (2, 2) mesh, the model axis inside a host and
``data`` across the hosts; K2 and K3 at 16/4 heads a rank on its data
rank's rows, K4 through ``w4_matmul_tp``) on requests 0 and 2, both hosts'
responses equal, and its fault drill (``mesh_hosts_fault``, tiny: a
follower killed on one host during a streamed launch fails that launch on
both hosts and stops the world within ``HOSTS_STOP_LIMIT_S``, typed 503s;
each host's world, which outlives its clients, closed after its job);
tensor-parallel (1, 2) int4
(``mesh_spawned``: the same client built as a plain ``KLLMs(...,
model_parallel=2)`` in this process with ``KLLMS_LOCAL_RANKS=2``, which
starts its follower itself, ``parallel/launcher.py``) on the same
requests; then, in ranks started by hand
(``torch.multiprocessing``), tensor-parallel bf16 paged (K2, K1
at 4 kv heads a rank) on request 0, and sequence-parallel (2, 1) bf16 on
request 2 (a ring prefill and ring decode, the prompt again as an exact
prefix-cache hit, then a Ulysses client whose prefill runs K2 on each
rank's 16/4 heads). Both ranks' texts, logits and counts agree, the first
tokens equal the unsharded clients' (served here first), the prefill
logits lie within ``MESH_LOGITS_REL_L2`` of theirs, every launch and
collective count holds its formula and the ranks' peaks sum under 80 GB;
then K4 at every TP = 2 shard shape against its plain version (timed),
``w4_matmul_tp`` against two mutants across the ranks (a dropped partial,
a column shard at the other rank's offset), the gloo ``psum``'s host time,
and an nccl world of one on device tensors. ``mesh_spawned_restart`` (a
plain process of its own, tiny on two ranks it started) kills a follower
while idle and one from the first streamed token's sink: the next
requests equal the first, the killed launch's request gets the typed 503
within ``FAULT_LIMIT_S``, and ``close()`` ends every child with exit code 0. ``train`` (last) drives the
causal-LM train step (``engine/training.py``): tiny fp32, three steps on the
card against the same steps on the CPU; Llama-3-8B's widths at 8 of its 32
layers in bf16 with the reference attention, five AdamW steps on one
seeded batch (losses, step time, peak memory), that trained tree then
served on the paged path through K2 and K1 (counts asserted) with the same
greedy tokens as the tree carried through ``params_to_numpy`` and back; 2
layers in f32, the card's loss and gradient norms against the CPU's; the
flash config refused before any allocation; and two ranks on the one card
over gloo, tensor-parallel (1, 2) in bf16, their losses equal, within the
unsharded card step's and every step's collectives by formula.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card
and exits non-zero, printing no result, without one. ``--phases`` runs a
subset (for quick checks, e.g. ``--phases build,k3,k4,tiny``); the default
runs every phase of the contract. ``--phases 8b,profile`` adds device-time
breakdowns of a short and the long 8B request; ``flex`` beside ``k2`` times
``flex_attention`` (compiled) as the softcapped K2 cases' library yardstick.

Timed kernel cases report ``ms`` (CUDA events around back-to-back wrapper
calls: at decode shapes mostly the host's enqueue) and, at decode shapes,
``device_ms``: the device time of one call, from a CUDA-graph replay of many
calls timed with CUDA events (no host in it), each call on its own copy of
the weights or KV pools, with enough copies that their rotation exceeds the
card's 50 MB L2, as a model's layers do. Bounds are stated against
``device_ms`` where it is measured.

Output: one line per phase, then a ``{"kernels": [...]}`` line, the card's
name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Literal

from pydantic import BaseModel, Field

PHASES = ("build", "draws", "consensus", "k2", "k1", "k4", "k3", "tiny", "8b", "parity", "serve",
          "ckpt", "loop", "8b_int4", "sched", "spec", "sanitize", "gemma9b", "mistral7b",
          "mixtral_int4", "mesh", "train")
# The model-family phases, in the order they run, and the cut of a
# family's depth (layers // divisor; widths as published): Mixtral, the
# longest phase and one with no grammar-constrained request, runs at half
# depth so that the full smoke stays near half its time limit. Gemma-2 and
# Mistral stay whole: at half depth the seeded samples of their parse
# request write counts so large that the consensus' count is a float beyond
# pydantic's integer range, so ``parsed`` is None, as the JAX package's
# consensus gives on those samples (tests/test_torch_gemma_parse.py).
FAMILY_PHASES = ("gemma9b", "mistral7b", "mixtral_int4")
FAMILY_DEPTH_DIVISOR = {"mixtral_int4": 2}
# Opt-in: torch.profiler breakdowns of a short and the long 8B request
# (needs "8b" or "8b_int4"); flex_attention, compiled, as the library
# yardstick of the softcapped K2 cases (needs "k2").
EXTRA_PHASES = ("profile", "flex")

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate,
# f32 rate outside the tensor cores, and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# int32 operations per second: 64 INT32 lanes per SM (NVIDIA H100 Tensor Core
# GPU architecture whitepaper, the SM's description) x 132 SMs x the 1.98 GHz
# boost clock of the SXM part. The data sheet states no integer rate outside
# the tensor cores.
PEAK_INT32_OPS = 64 * 132 * 1.98e9
# Integer operations one Levenshtein DP cell needs (the bound's count).
LEV_OPS_PER_CELL = 5
# jax.random's answers (jax 0.9.0, jax_threefry_partitionable on), which the
# card's machine has no JAX to compute: (seed, step, row) -> the key words of
# fold_in(fold_in(key(seed), step), row) and the float32 bits of the first
# four of jax.random.uniform(that key, (V,), minval=tiny, maxval=1).
JAX_DRAWS = {
    (0, 0, 0): ([4165894930, 804218099], [0x3E90C0AC, 0x3F49C0BE, 0x3ECB9010, 0x3F6C7292]),
    (0, 5, 3): ([535502902, 4114034487], [0x3F39455A, 0x3F46E5FE, 0x3F250914, 0x3EE9ED38]),
    (7, 0, 0): ([2737751932, 2099591257], [0x3E416598, 0x3F414586, 0x3E4B0DF8, 0x3EB2EC9C]),
    (7, 5, 3): ([1400128608, 1700204917], [0x3F31744A, 0x3E704638, 0x3E9077BC, 0x3F0FA9D2]),
    (3000000000, 0, 0): ([2840396633, 2397775790],
                         [0x3F18B78A, 0x3E661A78, 0x3EE77FF4, 0x3F7168FC]),
    (3000000000, 5, 3): ([1396230939, 1990630791],
                         [0x3EBDA3B4, 0x3B3E1400, 0x3F2DDCFE, 0x3C340180]),
}

# Llama-3-8B's published config.json (its architecture values), with the
# special-token ids of the byte tokenizer the smoke serves the checkpoint
# with: the published ids (bos 128000, eos 128001) name Llama-3's BPE
# tokenizer, which the smoke does not load.
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 8192, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 8,
    "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 128256, "bos_token_id": 256, "eos_token_id": 257, "pad_token_id": 258,
}

# Bytes a device-time rotation spans at least: 2.5 times the H100's 50 MB L2,
# so that every call reads its inputs from HBM.
COLD_ROTATION_BYTES = 128e6


# The response formats of the grammar-constrained runs. They live at module
# level: a model class defined inside main() keeps main()'s locals (CUDA
# streams, generators, graphs) for the resolution of its annotations until
# the interpreter's last collection, which frees them after the profiler's
# teardown, and that ended the process with SIGSEGV at exit.
class Record(BaseModel):
    name: str
    count: int


class InvoiceStatus(BaseModel):
    # Bounded: the schema's DFA allows no whitespace and at most 16
    # characters of note, so a sample ends within about 70 bytes and the
    # terminal state leaves EOS as the only choice.
    status: Literal["paid", "unpaid", "overdue"]
    paid_in_full: bool
    note: str = Field(max_length=16)


#: The script's start, for each record's elapsed seconds (``t_s``).
T0 = time.perf_counter()


def log(obj) -> None:
    print(json.dumps(dict(obj, t_s=round(time.perf_counter() - T0, 3))), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sass_check() -> dict:
    """The build_sass record: the HMMA/HGMMA instructions of each
    tensor-core kernel in its library's SASS and the kernels' registers and
    local memory, read with one ``cuobjdump`` per library and mode, all
    started together. Raises where a tensor-core kernel has no tensor-core
    instruction or the K3 kernel spills."""
    from k_llms_tpu_torch.ops import _ext

    cuobjdump = os.path.join(os.path.dirname(_ext.nvcc_path()), "cuobjdump")
    libs = ("flash_attention", "w4_matmul", "paged_decode", "decode_prefix")
    procs = {(lib, mode): subprocess.Popen([cuobjdump, mode, _ext.library_path(lib)],
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)
             for lib in libs for mode in ("-sass", "-res-usage")}
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"cuobjdump {key}: exit {proc.returncode}: {stderr[-2000:]}")
        out[key] = stdout
    mma_counts = {}
    for lib, kernel in (("flash_attention", "flash_attention_tc"), ("w4_matmul", "w4_gemm_tc"),
                        ("w4_matmul", "w4_decode_tc"), ("paged_decode", "paged_decode_tc"),
                        ("decode_prefix", "decode_prefix_tc")):
        fn = None
        for line in out[(lib, "-sass")].splitlines():
            if "Function : " in line:
                fn = line.split("Function : ")[1].strip()
            elif fn and kernel in fn and ("HMMA" in line or "HGMMA" in line):
                mma_counts[fn] = mma_counts.get(fn, 0) + 1
        if not any(kernel in fn for fn in mma_counts):
            raise AssertionError(f"{kernel}: no HMMA/HGMMA instruction in the SASS of {lib}")
    # Registers and local memory (spills) of each tensor-core kernel.
    resources = {}
    for lib in libs:
        fn = None
        for line in out[(lib, "-res-usage")].splitlines():
            if "Function " in line:
                fn = line.split("Function ")[1].strip().rstrip(":")
            elif fn and fn in mma_counts and "REG:" in line:
                fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
                resources[fn] = {"registers": int(fields.get("REG", -1)),
                                 "stack_bytes": int(fields.get("STACK", -1)),
                                 "local_bytes": int(fields.get("LOCAL", -1)),
                                 "shared_bytes": int(fields.get("SHARED", -1))}
                fn = None
    k3_tc = {fn: r for fn, r in resources.items() if "decode_prefix_tc" in fn}
    if not k3_tc or any(r["local_bytes"] != 0 or r["stack_bytes"] != 0 for r in k3_tc.values()):
        raise AssertionError(f"decode_prefix_tc: missing or spilling: {k3_tc}")
    return {"phase": "build_sass", "tensor_core_instructions": mma_counts,
            "resource_usage": resources}


def bound_ms(flops: float, nbytes: float, dtype_peak: float):
    t_ops = flops / dtype_peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- the sched phase: the scheduler and supervisor on the card ------------------
#
# Module-level so that they read without main()'s closures; each takes the
# client it drives and the phase's logger.


def plain_paged_launches() -> int:
    """Paged launches that ran the plain version, drilled or not: on the
    card none may, so a counted window holds this number fixed."""
    from k_llms_tpu_torch.utils.observability import KERNEL_EVENTS

    return (KERNEL_EVENTS.get("kernel.paged_attn_xla_dispatch")
            + KERNEL_EVENTS.get("kernel.paged_attn_fallback.failpoint"))


#: The device consensus's Levenshtein launches, as it plans them
#: (``consensus.device.levenshtein_batches`` of each scored pair list), since
#: the last :func:`reset_counts`; and the consensus events at that reset.
LEV_PLANNED = {"launches": 0, "pairs": 0}
CONSENSUS_AT_RESET = {}


def watch_levenshtein() -> None:
    """Count the launches the device consensus plans: every call of
    ``batched_levenshtein`` adds one per length bucket and pair chunk, the
    exact number of kernel launches it must make."""
    from k_llms_tpu_torch.consensus import device as dc

    import threading

    batched = dc.batched_levenshtein
    lock = threading.Lock()  # concurrent consolidations plan at once

    def planned(pairs, device="cpu"):
        with lock:
            LEV_PLANNED["launches"] += len(dc.levenshtein_batches(pairs))
            LEV_PLANNED["pairs"] += len(pairs)
        return batched(pairs, device)

    dc.batched_levenshtein = planned


def reset_counts() -> None:
    """Every kernel launch counter to 0, the planned Levenshtein launches
    to 0, and the consensus events noted: the start of a counted window."""
    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.utils.observability import CONSENSUS_EVENTS

    _ext.reset_launch_counts()
    LEV_PLANNED.update(launches=0, pairs=0)
    CONSENSUS_AT_RESET.clear()
    CONSENSUS_AT_RESET.update(CONSENSUS_EVENTS.snapshot())


def consensus_fallbacks() -> dict:
    """Consolidations (or pair batches) that took the host path since the
    last reset: failpoint, error, unavailable device, busy device lock."""
    from k_llms_tpu_torch.utils.observability import CONSENSUS_EVENTS

    now = CONSENSUS_EVENTS.snapshot()
    return {k: now[k] - CONSENSUS_AT_RESET.get(k, 0) for k in now
            if (k.startswith("consensus.fallback_") or k == "consensus.device_busy")
            and now[k] != CONSENSUS_AT_RESET.get(k, 0)}


def check_consensus_window(label) -> None:
    """A counted window's consensus ran on the card: no host fallback."""
    fallbacks = consensus_fallbacks()
    if fallbacks:
        raise AssertionError(f"{label}: consensus fell back to the host: {fallbacks}")


def join_all(threads, timeout=600):
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise AssertionError("a queued request did not return")


def polled_budget(after):
    """A request budget that counts its polls and sets ``reached`` at the
    ``after``-th: a thread waiting on it cancels the request a known number
    of decode steps in, from outside the launch."""
    import threading

    from k_llms_tpu_torch.reliability.deadline import RequestBudget

    class PolledBudget(RequestBudget):
        def __init__(self):
            super().__init__()
            self.polls = 0
            self.reached = threading.Event()

        def should_abort(self):
            self.polls += 1
            if self.polls >= after:
                self.reached.set()
            return super().should_abort()

    return PolledBudget()


def same_result(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(a.tokens, b.tokens) and np.array_equal(a.logprobs, b.logprobs))


def sched_coalesce(label, client, requests, expected_fn, log):
    """Four same-config create() requests queued from threads behind the
    parked worker, then released: one launch serves them. Returns the
    counted window's launch counts and what the caller's formula needs;
    holds every member bit-equal to a direct generate_many of the four
    specs, and logs the solo agreement, the fused and sequential walls and
    decode ms per step at 4 x n rows against n."""
    import numpy as np

    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.reliability.drills import park_worker, queue_in_order

    backend, engine = client.backend, client.backend.engine
    sched = backend.scheduler
    launches, embeds, seen = [], [], []
    generate_many, embed_tokens = engine.generate_many, engine.embed_tokens

    def counted_generate_many(items, **kw):
        out = generate_many(items, **kw)
        st = dict(engine.last_launch_stats)
        launches.append((len(items), st["n_per"], st["decode_steps"], kw["temperature"]))
        seen.append((list(items), kw, st, out))
        return out

    def counted_embed_tokens(token_lists, *a, **kw):
        embeds.append([len(t) for t in token_lists])
        return embed_tokens(token_lists, *a, **kw)

    gate = park_worker(sched)
    before = dict(sched.stats)
    plain = plain_paged_launches()
    engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
    reset_counts()
    t0 = time.perf_counter()
    threads, resps = queue_in_order(
        sched, [lambda r=r: client.chat.completions.create(**r) for r in requests])
    gate.set()
    join_all(threads)
    wall = time.perf_counter() - t0
    counts = dict(_ext.LAUNCH_COUNTS)
    del engine.generate_many, engine.embed_tokens
    after = dict(sched.stats)
    bad = {i: repr(r) for i, r in resps.items() if isinstance(r, BaseException)}
    if bad or len(launches) != 1 or launches[0][0] != len(requests):
        raise AssertionError(f"{label} coalescing: launches {launches}, failed {bad}")
    batches = after["batches"] - before["batches"]
    if batches != 1 + len(embeds) or after["coalesced"] - before["coalesced"] < len(requests) - 1:
        raise AssertionError(f"{label} coalescing: scheduler {before} -> {after}, embeds {embeds}")
    if plain_paged_launches() != plain:
        raise AssertionError(f"{label} coalescing: a paged launch ran the plain version")
    items, kw, fused_st, fused = seen[0]
    expected = expected_fn(launches, embeds)
    log({"phase": f"{label}_sched_coalesced", "requests": len(requests),
         "prompt_tokens": [len(it.prompt_ids) for it in items], "rows": fused_st["rows"],
         "decode_steps": fused_st["decode_steps"], "wall_s": wall,
         "scheduler_batches": batches, "scheduler_coalesced": after["coalesced"] - before["coalesced"],
         "embeddings_forwards": embeds, "launches": counts, "expected": expected,
         "consensus": [r.choices[0].message.content for r in resps.values()]})
    if counts != expected:
        raise AssertionError(f"{label} coalesced launch counts {counts} != expected {expected}")
    check_consensus_window(f"{label} coalesced")
    # Outside the counted window: the same group launched directly, then
    # each member alone, timed on the host around launches that end in a
    # device-to-host copy.
    t0 = time.perf_counter()
    direct = engine.generate_many(items, **kw)
    direct_wall = time.perf_counter() - t0
    direct_st = dict(engine.last_launch_stats)
    equal = [same_result(a, b) for a, b in zip(fused, direct)]
    solo_walls, solo_steps_ms, agree = [], [], []
    for it, res in zip(items, fused):
        t0 = time.perf_counter()
        solo = engine.generate_many([it], **kw)[0]
        solo_walls.append(time.perf_counter() - t0)
        st = engine.last_launch_stats
        solo_steps_ms.append(st["decode_s"] * 1e3 / max(1, st["decode_steps"]))
        agree.append([int(np.sum(res.tokens == solo.tokens)), int(res.tokens.size)])
    log({"phase": f"{label}_sched_coalesced_check", "bit_equal_to_direct_launch": equal,
         "solo_tokens_agreeing": agree, "fused_wall_s": direct_wall,
         "sequential_wall_s": sum(solo_walls), "solo_wall_s": solo_walls,
         "decode_ms_per_step_fused": direct_st["decode_s"] * 1e3 / max(1, direct_st["decode_steps"]),
         "fused_rows": direct_st["rows"], "decode_ms_per_step_solo": solo_steps_ms,
         "solo_rows": direct_st["n_per"]})
    if not all(equal):
        raise AssertionError(f"{label}: coalesced members differ from a direct launch: {equal}")
    return counts


def sched_cancel(label, client, contents, log, polls=4):
    """The abort poller through the backend: one member of a two-request
    group cancelled from another thread ``polls`` decode steps in (logged:
    the steps from the cancel to the poll that saw it; the survivor must
    equal the group launched without the cancel), then both (the launch
    must end early; logged: the steps from the last cancel to the requests'
    return)."""
    import threading

    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.reliability.drills import park_worker, queue_in_order
    from k_llms_tpu_torch.types.wire import RequestCancelledError

    backend, engine = client.backend, client.backend.engine
    tok, sched = backend.tokenizer, backend.scheduler
    ids = [tok.apply_chat_template([{"role": "user", "content": c}], add_generation_prompt=True)
           for c in contents]
    kw = dict(max_new=32, temperature=0.8, top_p=None, constraint=None)
    # The scheduler polls a budget twice (admission, dequeue) before decode.
    seeds = (41, 42)

    def run_group(budgets):
        cancel_at = {}

        def canceller(j, b):
            b.reached.wait(600)
            cancel_at[j] = time.perf_counter()
            b.cancel()

        for j, b in budgets.items():
            threading.Thread(target=canceller, args=(j, b), daemon=True).start()
        gate = park_worker(sched)
        threads, got = queue_in_order(sched, [
            lambda j=j: backend._generate_batched(ids[j], n=8, seed=seeds[j],
                                                  budget=budgets.get(j), **kw)
            for j in range(2)])
        gate.set()
        join_all(threads)
        return got, dict(engine.last_launch_stats), cancel_at, time.perf_counter()

    got, st, cancel_at, _ = run_group({1: polled_budget(2 + polls)})
    direct = engine.generate_many([GenRequestSpec(ids[j], 8, seeds[j]) for j in range(2)],
                                  max_new_tokens=32, temperature=0.8, eos_ids=tok.stop_ids)
    ms_per_step = st["decode_s"] * 1e3 / max(1, st["decode_steps"])
    seen_step, seen_at = st["aborted"].get(1, (None, None))
    log({"phase": f"{label}_sched_cancel_one", "cancelled_error": repr(got[1]),
         "survivor_bit_equal": same_result(got[0], direct[0]),
         "cancel_after_decode_polls": polls, "seen_at_step": seen_step,
         "cancel_to_poll_steps": None if seen_at is None
         else (seen_at - cancel_at[1]) * 1e3 / ms_per_step,
         "launch_decode_steps": st["decode_steps"], "decode_ms_per_step": ms_per_step})
    if not isinstance(got[1], RequestCancelledError) or not same_result(got[0], direct[0]):
        raise AssertionError(f"{label} cancel one: {got}")
    got, st, cancel_at, returned_at = run_group(
        {0: polled_budget(2 + polls), 1: polled_budget(2 + polls)})
    ms_per_step = st["decode_s"] * 1e3 / max(1, st["decode_steps"])
    log({"phase": f"{label}_sched_cancel_all", "errors": [repr(got[j]) for j in range(2)],
         "launch_decode_steps": st["decode_steps"], "max_tokens": kw["max_new"],
         "aborted": {j: s for j, (s, _) in st["aborted"].items()},
         "cancel_to_return_steps": (returned_at - max(cancel_at.values())) * 1e3 / ms_per_step})
    if (not all(isinstance(got[j], RequestCancelledError) for j in range(2))
            or st["decode_steps"] >= kw["max_new"] - 1):
        raise AssertionError(f"{label} cancel all: {got}, {st['decode_steps']} steps")


def sched_oom(label, client, contents, log):
    """Device OOM through the backend on a two-request group: the ``oom``
    failpoint (one split), then a real one with the process's memory
    fraction set between a solo launch's reserved peak and the group's
    allocated peak (``reliability/drills.py``; the size is chosen so that
    the two stand apart, and the phase fails where they do not). Each
    member must equal its solo launch (the sub-group it ends in)."""
    import torch

    from k_llms_tpu_torch.engine.engine import GenRequestSpec
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.drills import (
        launch_peaks, memory_fraction, oom_memory_fraction, park_worker, queue_in_order,
        reset_launch_memory)
    from k_llms_tpu_torch.reliability.failpoints import FailSpec

    backend, engine = client.backend, client.backend.engine
    tok, sched = backend.tokenizer, backend.scheduler
    ids = [tok.apply_chat_template([{"role": "user", "content": c}], add_generation_prompt=True)
           for c in contents]
    seeds = (51, 52)

    def specs_and_kw(n, max_new):
        return ([GenRequestSpec(ids[j], n, seeds[j]) for j in range(2)],
                dict(max_new_tokens=max_new, temperature=0.0, eos_ids=tok.stop_ids))

    def serve_group(n, max_new):
        gate = park_worker(sched, hold=600)
        threads, got = queue_in_order(sched, [
            lambda j=j: backend._generate_batched(ids[j], n=n, max_new=max_new, temperature=0.0,
                                                  top_p=None, seed=seeds[j], constraint=None)
            for j in range(2)])
        gate.set()
        join_all(threads)
        return [got[j] for j in range(2)]

    # The failpoint: n = 8 rows of 16 tokens a request.
    specs, kw = specs_and_kw(8, 16)
    solos = [engine.generate_many([spec], **kw)[0] for spec in specs]
    splits = engine.oom_stats["splits"]
    with fp.failpoints({"engine.launch": FailSpec(action="oom", times=1)}):
        got = serve_group(8, 16)
    equal = [not isinstance(g, BaseException) and same_result(g, s) for g, s in zip(got, solos)]
    log({"phase": f"{label}_sched_oom_failpoint", "splits": engine.oom_stats["splits"] - splits,
         "members_equal_solo": equal})
    if engine.oom_stats["splits"] - splits != 1 or not all(equal):
        raise AssertionError(f"{label} oom failpoint: {engine.oom_stats}, {got}")

    # The real OOM: n = 32 rows of 128 tokens a request. The engine's page
    # pool, sized once, holds a solo launch but not the group, which decodes
    # dense (as the JAX engine's would): the group's dense KV (two prompt
    # buckets, 64 rows' generation caches) sets its peak apart from a
    # solo's by more than a launch's reserved slack. The three measured
    # launches also step the scheduler's width back up from the failpoint's
    # backoff, so the group coalesces.
    n, max_new = 32, 128
    specs, kw = specs_and_kw(n, max_new)
    device = engine.device
    solos, solo_peaks, allocated_peaks, solo_layouts = [], [], [], []
    for spec in specs:
        reset_launch_memory(engine)
        solos.append(engine.generate_many([spec], **kw)[0])
        solo_layouts.append(engine.last_launch_stats["kv_layout"])
        reserved, allocated = launch_peaks(device)
        solo_peaks.append(reserved)
        allocated_peaks.append(allocated)
    reset_launch_memory(engine)
    engine.generate_many(specs, **kw)
    group_layout = engine.last_launch_stats["kv_layout"]
    group_peak, group_allocated = launch_peaks(device)
    record = {"phase": f"{label}_sched_oom_real", "solo_reserved_peak_bytes": solo_peaks,
              "group_reserved_peak_bytes": group_peak, "solo_allocated_peak_bytes": allocated_peaks,
              "group_allocated_peak_bytes": group_allocated,
              "gap_bytes": group_allocated - max(solo_peaks), "solo_kv_layouts": solo_layouts,
              "group_kv_layout": group_layout,
              "pool_pages": None if engine._kv_pool is None else engine._kv_pool.allocator.total_pages}
    log(record)
    if solo_layouts != ["paged", "paged"] or group_layout != "dense":
        raise AssertionError(f"{label} real oom: the pool must hold each solo and not the group: "
                             f"{record}")
    fraction = oom_memory_fraction(max(solo_peaks), group_allocated, device)
    total = torch.cuda.get_device_properties(device).total_memory
    splits = engine.oom_stats["splits"]
    batches = sched.stats["batches"]
    launched = []
    generate_many = engine.generate_many

    def counted_generate_many(items, **kw):
        launched.append(len(items))
        return generate_many(items, **kw)

    engine.generate_many = counted_generate_many
    reset_launch_memory(engine)
    try:
        with memory_fraction(fraction, device):
            got = serve_group(n, max_new)
    finally:
        del engine.generate_many
    drill_peaks = launch_peaks(device)
    pool = engine._kv_pool
    in_use = None if pool is None else pool.allocator.snapshot()["in_use"]
    equal = [not isinstance(g, BaseException) and same_result(g, s) for g, s in zip(got, solos)]
    log({"phase": f"{label}_sched_oom_drill", "memory_fraction": fraction,
         "limit_bytes": fraction * total,
         "scheduler_batches": sched.stats["batches"] - batches, "launch_sizes": launched,
         "drill_reserved_peak_bytes": drill_peaks[0], "drill_allocated_peak_bytes": drill_peaks[1],
         "splits": engine.oom_stats["splits"] - splits, "members_equal_solo": equal,
         "pool_pages_in_use_after": in_use})
    if engine.oom_stats["splits"] - splits != 1 or not all(equal) or in_use not in (0, None):
        raise AssertionError(f"{label} real oom: {engine.oom_stats}, {got}")


def sched_rebuild(label, client, content, log):
    """A poison-escalated rebuild of the client's engine: launches whose
    rows are all poisoned (the ``engine.logits`` drill) until the poisoned
    share of the supervisor's window crosses its threshold, then a clean
    request, which rebuilds the engine before it launches. Logs the
    rebuild's seconds and the peak device memory across it (both engines'
    weights are resident while the new one is built)."""
    import torch

    from k_llms_tpu_torch.backends.base import ChatRequest
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec

    backend = client.backend
    req = ChatRequest(messages=[{"role": "user", "content": content}], model=backend.model_name,
                      n=8, temperature=0.0, max_tokens=8, seed=61)
    build = backend._build_engine
    build_s = []

    def timed_build():
        t0 = time.perf_counter()
        engine = build()
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        return engine

    backend._build_engine = timed_build
    rebuilds = backend.supervisor.stats()["rebuilds"]
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    poisoned = 0
    try:
        # All of a poisoned launch's rows freeze at the first token, so
        # each is one prefill.
        with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=8, seed=0)}):
            while backend.supervisor._rebuild_wanted is None:
                out = backend.chat_completion(req)
                poisoned += sum(1 for c in out.choices if getattr(c, "sample_error", None))
        clean = backend.chat_completion(req)
    finally:
        del backend._build_engine
    peak = torch.cuda.max_memory_allocated()
    sup = backend.supervisor.stats()
    rec = {"phase": f"{label}_sched_poison_rebuild", "poisoned_samples": poisoned,
           "rebuilds": sup["rebuilds"] - rebuilds, "reason": sup["last_rebuild_reason"],
           "build_s": build_s, "state": backend.health()["state"],
           "allocated_before_bytes": allocated_before, "peak_bytes": peak,
           "allocated_after_bytes": torch.cuda.memory_allocated(),
           "param_bytes": backend.engine.param_footprint_bytes(),
           "clean_samples": sum(1 for c in clean.choices if not getattr(c, "sample_error", None))}
    log(rec)
    if (rec["rebuilds"] != 1 or sup["last_rebuild_reason"] != "poison_rate" or len(build_s) != 1
            or rec["clean_samples"] != 8):
        raise AssertionError(f"{label} poison rebuild: {rec}")


# -- the serve phase: the OpenAI wire over HTTP on the card ---------------------
#
# A stdlib client (the card machine need not have httpx): one request per
# connection, as the server closes each after its response.

#: Fields of a chat.completion that differ between two runs of one request:
#: the creation second, and the id (kept deterministic by the backend, but
#: normalised so that the comparison does not depend on it).
NORMALISED_FIELDS = ("id", "created")


def normalised(completion: dict) -> dict:
    return {k: (None if k in NORMALISED_FIELDS else v) for k, v in completion.items()}


def http_call(port, method, path, body=None, headers=None, timeout=900):
    """One request to the loopback server: (status, headers, body bytes);
    ``body`` is JSON-encoded unless it is bytes."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def http_stream(port, body, headers=None, disconnect_after_first_delta=False, timeout=900):
    """POST ``body`` with ``stream: true`` and read the SSE frames as they
    arrive. Returns (status, frames, ttfd_s, arrivals): each frame is a
    parsed ``data:`` payload or the string ``"[DONE]"``; ttfd_s is the host
    time from sending to the first content delta, arrivals the host times
    of the content deltas. With ``disconnect_after_first_delta`` the socket
    is shut down right after the first content delta (a client hanging up)."""
    import http.client
    import socket

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    frames, arrivals, ttfd = [], [], None
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(dict(body, stream=True)).encode(),
                     headers={"content-type": "application/json", **(headers or {})})
        sock = conn.sock
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, [json.loads(resp.read())], None, []
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.rstrip(b"\r\n")
            if not line.startswith(b"data: "):
                continue  # the blank frame separator or a ": ping" comment
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                frames.append("[DONE]")
                break
            frame = json.loads(payload)
            frames.append(frame)
            if (frame.get("object") == "chat.completion.chunk"
                    and frame["choices"][0]["delta"].get("content")):
                now = time.perf_counter()
                arrivals.append(now - t0)
                if ttfd is None:
                    ttfd = now - t0
                if disconnect_after_first_delta:
                    sock.shutdown(socket.SHUT_RDWR)
                    resp.close()
                    break
        return 200, frames, ttfd, arrivals
    finally:
        conn.close()


def stream_texts(frames, n):
    """Per-sample text of the content deltas (wire choice index 1..n), the
    samples with a delta before the final event, and the final event."""
    texts, seen, final = [""] * n, set(), None
    for f in frames:
        if f == "[DONE]":
            continue
        if f["object"] == "chat.completion":
            final = f
        elif final is None:
            c = f["choices"][0]
            if c["delta"].get("content"):
                texts[c["index"] - 1] += c["delta"]["content"]
                seen.add(c["index"])
    return texts, seen, final


def metric_value(text, name):
    """A sample's value from a Prometheus exposition (None when absent)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def serve_http(client, req_a, req_b, contents, expected_fn, log):
    """The serve phase: an 8B client behind the OpenAI-wire HTTP
    front door (``ServerThread(create_app(client))`` on loopback), talked
    to with the standard library. Each check runs in its own counted
    window (every launch count reset just before and read just after,
    K2, K1 and the draws by formula, ``levenshtein`` as the device
    consensus planned it, no host fallback). ``req_a`` is a greedy
    request, ``req_b`` a sampled one; ``contents`` gives four prompts;
    ``expected_fn(launches, embeds)`` is the path's launch-count formula."""
    import threading

    import numpy as np

    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.reliability.drills import park_worker, queue_in_order
    from k_llms_tpu_torch.serving import ServerThread, create_app
    from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS

    backend = client.backend
    engine, scheduler = backend.engine, backend.scheduler
    launches, embeds, streamed = [], [], []
    generate_many, embed_tokens = engine.generate_many, engine.embed_tokens
    lock = threading.Lock()

    def counted_generate_many(items, **kw):
        out = generate_many(items, **kw)
        st = engine.last_launch_stats
        with lock:
            launches.append((len(items), st["n_per"], st["decode_steps"], kw["temperature"]))
            streamed.append(sum(it.token_sink is not None for it in items))
        return out

    def counted_embed_tokens(token_lists, *a, **kw):
        with lock:
            embeds.append([len(t) for t in token_lists])
        return embed_tokens(token_lists, *a, **kw)

    def window(name, fn):
        launches.clear()
        embeds.clear()
        streamed.clear()
        plain = plain_paged_launches()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        counts = dict(_ext.LAUNCH_COUNTS)
        expected = expected_fn(launches, embeds)
        log({"phase": f"serve_{name}_window", "wall_s": wall, "launches": counts,
             "expected": expected, "engine_launches": list(launches),
             "streaming_members": list(streamed), "embeddings_forwards": len(embeds)})
        if counts != expected or plain_paged_launches() != plain:
            raise AssertionError(f"serve {name}: launch counts {counts} != {expected}")
        check_consensus_window(f"serve {name}")
        return out

    def post_json(body, headers=None):
        status, _, raw = http_call(port, "POST", "/v1/chat/completions", body, headers)
        if status != 200:
            raise AssertionError(f"serve: POST answered {status}: {raw[:300]!r}")
        return json.loads(raw)

    def direct(body):
        return client.chat.completions.create(**body).model_dump(mode="json")

    engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
    srv = ServerThread(create_app(client)).start()
    port = srv.port
    try:
        status, _, raw = http_call(port, "GET", "/metrics")
        metrics0 = raw.decode()

        # a. Non-streamed: the wire JSON is create()'s model_dump.
        def check_a():
            got, want = post_json(req_a), direct(req_a)
            if normalised(got) != normalised(want):
                raise AssertionError("serve a: the wire JSON differs from create()")
            return got

        resp_a = window("a_nonstream", check_a)

        # b. Streamed, with a traceparent to find its flight record.
        trace_id = os.urandom(16).hex()
        headers_b = {"traceparent": f"00-{trace_id}-{os.urandom(8).hex()}-01"}

        def check_b():
            status, frames, ttfd, arrivals = http_stream(port, req_b, headers_b)
            texts, seen, final = stream_texts(frames, req_b["n"])
            want = direct(req_b)
            return status, frames, ttfd, arrivals, texts, seen, final, want

        status, frames, ttfd, arrivals, texts, seen, final, want = window("b_stream", check_b)
        finals = [f for f in frames if f != "[DONE]" and f["object"] == "chat.completion"]
        gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
        log({"phase": "serve_b_stream", "status": status, "frames": len(frames),
             "content_deltas": len(arrivals), "samples_with_delta": sorted(seen),
             "time_to_first_delta_s": ttfd,
             "chunk_gap_s": {"median": float(np.median(gaps)) if gaps else None,
                             "p90": float(np.percentile(gaps, 90)) if gaps else None,
                             "max": max(gaps) if gaps else None},
             "stream_wall_s": arrivals[-1] if arrivals else None})
        problems = []
        if status != 200 or frames[-1] != "[DONE]" or len(finals) != 1 or frames[-2] is not final:
            problems.append("event order")
        if seen != set(range(1, req_b["n"] + 1)):
            problems.append(f"samples with a delta {sorted(seen)}")
        if final is not None and texts != [c["message"]["content"] for c in final["choices"][1:]]:
            problems.append("deltas differ from the final texts")
        if final is None or normalised(final) != normalised(want):
            problems.append("the final event differs from a non-streamed create()")
        if problems:
            raise AssertionError(f"serve b: {problems}")

        # The tap's cost: decode ms per step of request b, streamed and
        # not, in alternating runs (no limit).
        def tap_cost():
            runs = []
            for stream in (False, True, True, False):
                if stream:
                    list(client.chat.completions.create(stream=True, **req_b))
                else:
                    client.chat.completions.create(**req_b)
                st = engine.last_launch_stats
                runs.append({"streamed": stream, "decode_steps": st["decode_steps"],
                             "decode_ms_per_step": st["decode_s"] * 1e3
                             / max(st["decode_steps"], 1)})
            return runs

        runs = window("tap_cost", tap_cost)
        log({"phase": "serve_tap_cost", "runs": runs,
             "median_ms_per_step": {
                 k: float(np.median([r["decode_ms_per_step"] for r in runs
                                     if r["streamed"] == (k == "streamed")]))
                 for k in ("streamed", "not_streamed")}})

        # c. Two streams and one non-stream sent together: one launch,
        # each member equal to the same group served without streams.
        group = [dict(req_a, messages=[{"role": "user", "content": c}])
                 for c in contents[:3]]

        def fused(calls):
            """The calls queued behind the parked worker, then released:
            their results, the engine launches they took and the requests
            the scheduler coalesced into another's launch."""
            gate = park_worker(scheduler)
            n0, coalesced = len(launches), scheduler.stats["coalesced"]
            threads, got = queue_in_order(scheduler, calls)
            gate.set()
            join_all(threads)
            return ([got[i] for i in range(len(calls))], launches[n0:],
                    scheduler.stats["coalesced"] - coalesced)

        def check_c():
            mixed = fused([lambda b=group[0]: http_stream(port, b),
                           lambda b=group[1]: http_stream(port, b),
                           lambda b=group[2]: post_json(b)])
            plain = fused([lambda b=b: direct(b) for b in group])
            return mixed, plain

        (mixed, m_launches, m_coalesced), (plain, p_launches, p_coalesced) = window(
            "c_mixed_group", check_c)
        problems = []
        for i, out in enumerate(mixed):
            if isinstance(out, BaseException):
                raise AssertionError(f"serve c: member {i} failed: {out!r}")
        outs = []
        for i, out in enumerate(mixed[:2]):
            status, frames, _, _ = out
            texts, seen, final = stream_texts(frames, group[i]["n"])
            if status != 200 or final is None or frames[-1] != "[DONE]":
                problems.append(f"stream {i} did not finish")
                continue
            if texts != [c["message"]["content"] for c in final["choices"][1:]]:
                problems.append(f"stream {i}: deltas differ from the final texts")
            outs.append(final)
        outs.append(mixed[2])
        equal = [normalised(o) == normalised(p) for o, p in zip(outs, plain)]
        solo = [normalised(o) == normalised(direct(b)) for o, b in zip(outs, group)]
        log({"phase": "serve_c_mixed_group", "launches_mixed": m_launches,
             "scheduler_coalesced_mixed": m_coalesced,
             "launches_without_streams": p_launches,
             "scheduler_coalesced_without_streams": p_coalesced,
             "equal_to_the_group_without_streams": equal, "equal_to_solo_runs": solo})
        if ([x[0] for x in m_launches] != [3] or [x[0] for x in p_launches] != [3]
                or (m_coalesced, p_coalesced) != (2, 2) or not all(equal) or len(outs) != 3):
            problems.append(f"fused launches {m_launches} / {p_launches}, equal {equal}")
        if problems:
            raise AssertionError(f"serve c: {problems}")

        # d. The client hangs up after the first delta of a 256-token
        # stream: the launch aborts, its pages return, the next request
        # is served.
        body_d = dict(req_b, max_tokens=256, seed=17)

        def check_d():
            aborts = FAILURE_EVENTS.get("engine.decode_abort")
            in_use = engine._kv_pool.allocator.in_use_pages
            n_launches = len(launches)
            status, frames, ttfd, _ = http_stream(port, body_d,
                                                  disconnect_after_first_delta=True)
            deadline = time.monotonic() + 120
            while (len(launches) == n_launches
                   or FAILURE_EVENTS.get("engine.decode_abort") == aborts):
                if time.monotonic() > deadline:
                    raise AssertionError("serve d: the disconnect did not abort the launch")
                time.sleep(0.01)
            st = dict(engine.last_launch_stats)
            after = {"aborts": FAILURE_EVENTS.get("engine.decode_abort") - aborts,
                     "pages_in_use_before": in_use,
                     "pages_in_use_after": engine._kv_pool.allocator.in_use_pages,
                     "decode_steps": st["decode_steps"], "aborted": st["aborted"],
                     "time_to_first_delta_s": ttfd, "frames_read": len(frames)}
            nxt = post_json(req_a)
            after["next_equal_to_a"] = normalised(nxt) == normalised(resp_a)
            return after

        d = window("d_disconnect", check_d)
        log({"phase": "serve_d_disconnect", **{k: v for k, v in d.items() if k != "aborted"},
             "aborted_members": {str(k): v[0] for k, v in d["aborted"].items()}})
        if (d["aborts"] != 1 or d["decode_steps"] >= 255 or not d["aborted"]
                or d["pages_in_use_after"] != d["pages_in_use_before"]
                or not d["next_equal_to_a"]):
            raise AssertionError(f"serve d: {d}")

        # e. The metadata routes.
        def check_e():
            out = {p: http_call(port, "GET", p)
                   for p in ("/healthz", "/metrics", "/debug/requests")}
            backend.backend_config.debug_endpoints = True
            try:
                out["debug_on"] = http_call(port, "GET", "/debug/requests")
            finally:
                backend.backend_config.debug_endpoints = False
            return out

        e = window("e_routes", check_e)
        metrics = e["/metrics"][2].decode()
        families = sorted({line.split()[2] for line in metrics.splitlines()
                           if line.startswith("# TYPE kllms_") and line.endswith(" histogram")})
        e2e = [metric_value(t, "kllms_request_e2e_seconds_count") or 0.0
               for t in (metrics0, metrics)]
        ttft = [metric_value(t, "kllms_request_ttft_seconds_count") or 0.0
                for t in (metrics0, metrics)]
        records = json.loads(e["debug_on"][2])["requests"] if e["debug_on"][0] == 200 else []
        rec_b = next((r for r in records if r["trace_id"] == trace_id), None)
        phases = rec_b["phases"] if rec_b else {}
        log({"phase": "serve_e_routes", "healthz": e["/healthz"][0],
             "metrics": e["/metrics"][0], "histogram_families": families,
             "request_e2e_count": e2e, "request_ttft_count": ttft,
             "debug_requests_default": e["/debug/requests"][0],
             "debug_requests_enabled": e["debug_on"][0], "record_b": rec_b})
        problems = []
        if e["/healthz"][0] != 200 or e["/metrics"][0] != 200:
            problems.append("healthz/metrics status")
        # Chat requests served since the first scrape: a (wire + direct),
        # b (wire + direct), 4 tap runs, c (3 + 3 + 3 solo), d (the
        # disconnect + the next request).
        if e2e[1] - e2e[0] < 2 + 2 + 4 + 9 + 2 or ttft[1] - ttft[0] < 1 + 2 + 2 + 1:
            problems.append("latency histograms did not count the requests")
        if e["/debug/requests"][0] != 404 or e["debug_on"][0] != 200 or rec_b is None:
            problems.append("debug routes")
        elif (phases.get("sample", 0.0) + phases.get("consolidate", 0.0) > rec_b["duration_s"]
              or phases.get("queue_wait", 0.0) + phases.get("decode", 0.0)
              > phases.get("sample", 0.0) or "decode" not in phases):
            problems.append(f"b's phases {phases} against {rec_b['duration_s']} s")
        if problems:
            raise AssertionError(f"serve e: {problems}")

        # f. A 4-line JSONL batch job; the lines' max_tokens differ, so
        # no two items coalesce and each equals its solo create().
        lines = [dict(req_a, max_tokens=12 + i, seed=51 + i,
                      messages=[{"role": "user", "content": c}])
                 for i, c in enumerate(contents)]

        def check_f():
            t0 = time.perf_counter()
            jsonl = b"\n".join(json.dumps(b).encode() for b in lines)
            status, _, raw = http_call(port, "POST", "/v1/batches", jsonl)
            if status != 200:
                raise AssertionError(f"serve f: submit answered {status}: {raw[:300]!r}")
            job = json.loads(raw)
            deadline = time.monotonic() + 600
            while job["status"] not in ("completed", "failed", "cancelled",
                                        "completed_with_errors"):
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve f: the job did not finish: {job}")
                time.sleep(0.05)
                job = json.loads(http_call(port, "GET", f"/v1/batches/{job['id']}")[2])
            wall = time.perf_counter() - t0
            status, _, out = http_call(port, "GET", f"/v1/batches/{job['id']}/output")
            records = [json.loads(x) for x in out.splitlines() if x.strip()]
            want = [direct(b) for b in lines]
            return job, wall, status, records, want

        job, wall, status, records, want = window("f_batch", check_f)
        equal = [r["response"] is not None and normalised(r["response"]["body"]) == normalised(w)
                 for r, w in zip(records, want)]
        log({"phase": "serve_f_batch", "status": job["status"], "job_wall_s": wall,
             "request_counts": job.get("request_counts"), "output_status": status,
             "custom_ids": [r["custom_id"] for r in records], "equal_to_create": equal})
        if (job["status"] != "completed" or status != 200 or len(records) != 4
                or [r["custom_id"] for r in records] != [f"item-{i}" for i in range(4)]
                or not all(equal)):
            raise AssertionError(f"serve f: {job['status']}, {len(records)} records, {equal}")
    finally:
        srv.stop(drain=False)
        del engine.generate_many, engine.embed_tokens


def loop_stream(client, req, window_resp, log):
    """The serve phase's check g: ``req`` streamed through the loop
    (``create(stream=True)``) in its own counted window; each sample's
    deltas equal its final text. The loop takes no logit bias, and its
    unbiased samples on random weights decode to no text, so ``req`` is
    the loop phase's grammar-constrained request D, whose samples are
    JSON; ``window_resp`` is D's response from the loop's main window."""
    import numpy as np

    from k_llms_tpu_torch.ops import _ext

    backend = client.backend
    engine, loop = backend.engine, backend._continuous
    L = engine.config.num_layers
    embeds, launches = [], []
    generate_many, embed_tokens = engine.generate_many, engine.embed_tokens

    def counted_generate_many(items, **kw):
        launches.append(len(items))
        return generate_many(items, **kw)

    def counted_embed_tokens(token_lists, *a, **kw):
        embeds.append([len(t) for t in token_lists])
        return embed_tokens(token_lists, *a, **kw)

    engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
    before = dict(loop.stats)
    plain = plain_paged_launches()
    reset_counts()
    t0 = time.perf_counter()
    try:
        events, arrivals = [], []
        for ev in client.chat.completions.create(stream=True, **req):
            events.append(ev)
            if ev["object"] == "chat.completion.chunk" and ev["choices"][0]["delta"].get("content"):
                arrivals.append(time.perf_counter() - t0)
        counts = dict(_ext.LAUNCH_COUNTS)
    finally:
        del engine.generate_many, engine.embed_tokens
    d = {k: loop.stats[k] - before[k] for k in ("steps", "admitted", "prefill_chunks")}
    expected = {
        # A whole-prompt admission or its chunks (D's 86 tokens take one
        # whole prefill on the 8B loop's 128-token chunks).
        "flash_attention": L * (d["admitted"] - bool(d["prefill_chunks"]) + d["prefill_chunks"]
                                + len(embeds)),
        "paged_decode_attention": L * d["steps"],
        "decode_prefix_attention": 0, "w4_matmul": 0,
        "threefry_uniform_rows": d["steps"] + d["admitted"],
        "levenshtein": LEV_PLANNED["launches"],
    }
    texts, seen, final = stream_texts(events, req["n"])
    final_texts = [c["message"]["content"] for c in final["choices"][1:]] if final else None
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
    log({"phase": "loop_8b_stream", "wall_s": time.perf_counter() - t0, "stats": d,
         "launches": counts, "expected": expected, "coalesced_launches": launches,
         "content_deltas": len(arrivals), "samples_with_delta": sorted(seen),
         "time_to_first_delta_s": arrivals[0] if arrivals else None,
         "chunk_gap_median_s": float(np.median(gaps)) if gaps else None,
         "final_equal_to_the_window_run": final_texts
         == [c.message.content for c in window_resp.choices[1:]]})
    with_text = {i for i in range(1, req["n"] + 1) if final and final_texts[i - 1]}
    if (counts != expected or launches or d["admitted"] != 1 or final is None
            or events[-1] is not final or not seen or seen != with_text
            or texts != final_texts or plain_paged_launches() != plain):
        raise AssertionError(f"loop 8b stream: counts {counts} != {expected}, "
                             f"samples {sorted(seen)}, deltas equal {texts == final_texts}")
    check_consensus_window("loop_8b_stream")


def sched_tiny(log):
    """The watchdog and the replica set at ``tiny`` (fp32) through the
    kernels: a hung launch rebuilt and replayed, rebuilds exhausted into
    STOPPED and a typed 503, a poison-escalated rebuild, failover from a
    down member and a hedged request's loser cancelled mid-decode."""
    import torch

    from k_llms_tpu_torch.backends.base import ChatRequest
    from k_llms_tpu_torch.backends.cuda import CudaBackend
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec
    from k_llms_tpu_torch.reliability.replicas import ReplicaSet
    from k_llms_tpu_torch.types.wire import BackendUnavailableError, EngineHungError
    from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS, HEDGE_EVENTS

    knobs = dict(model="tiny", attention_impl="flash", paged_attention_impl="cuda")

    def req(seed=123, n=2, max_tokens=16, temperature=1.0, content="determinism"):
        return ChatRequest(messages=[{"role": "user", "content": content}], model="tiny", n=n,
                           temperature=temperature, seed=seed, max_tokens=max_tokens)

    def texts(out):
        return [c.message.content for c in out.choices]

    baseline_backend = CudaBackend(**knobs)
    baseline_backend.chat_completion(req())
    t0 = time.perf_counter()
    baseline = baseline_backend.chat_completion(req())
    warm_s = time.perf_counter() - t0
    baseline_backend.close()
    budget = max(2.0, 10.0 * warm_s)
    watched = dict(knobs, watchdog_min_budget_s=budget, watchdog_max_budget_s=budget)

    # A hung launch: detected, rebuilt, replayed. The hang outlasts the run.
    b = CudaBackend(**watched)
    build = b._build_engine
    build_s = []

    def timed_build():
        t0 = time.perf_counter()
        engine = build()
        build_s.append(time.perf_counter() - t0)
        return engine

    b._build_engine = timed_build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    with fp.failpoints({"engine.launch": FailSpec(action="hang", times=1, delay=3600.0)}):
        t0 = time.perf_counter()
        out = b.chat_completion(req())
        wall = time.perf_counter() - t0
    h = b.health()
    sup = h["supervisor"]
    rec = {"phase": "sched_tiny_hang", "watchdog_budget_s": budget, "warm_launch_s": warm_s,
           "request_wall_s": wall, "rebuild_build_s": build_s, "state": h["state"],
           "hung_launches": sup["hung_launches"], "rebuilds": sup["rebuilds"],
           "replayed": sup["replayed"], "text_equal": texts(out) == texts(baseline),
           "allocated_before_bytes": allocated,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(rec)
    if (h["state"] != "ready" or (sup["hung_launches"], sup["rebuilds"]) != (1, 1)
            or sup["replayed"] < 1 or texts(out) != texts(baseline)):
        raise AssertionError(f"tiny hang drill: {rec}")
    b.close()

    # Every launch hangs and one rebuild is allowed: STOPPED, then 503s.
    b = CudaBackend(**dict(watched, max_rebuilds=1))
    with fp.failpoints({"engine.launch": FailSpec(action="hang", delay=3600.0)}):
        try:
            b.chat_completion(req(n=1, max_tokens=4))
            first = "served"
        except EngineHungError as e:
            first = repr(e)
    try:
        b.chat_completion(req(n=1, max_tokens=4))
        second = None
    except BackendUnavailableError as e:
        second = e
    rec = {"phase": "sched_tiny_rebuilds_exhausted", "first": first, "state": b.health()["state"],
           "second_status": getattr(second, "status_code", None), "second": repr(second)}
    log(rec)
    if rec["state"] != "stopped" or rec["second_status"] != 503 or first == "served":
        raise AssertionError(f"tiny rebuild exhaustion: {rec}")

    # Poison above the threshold: the next launch rebuilds first.
    b = CudaBackend(**dict(knobs, poison_threshold=0.5))
    with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=0)}):
        b.chat_completion(req(seed=1))
    out = b.chat_completion(req())
    sup = b.supervisor.stats()
    rec = {"phase": "sched_tiny_poison", "rebuilds": sup["rebuilds"],
           "reason": sup["last_rebuild_reason"], "text_equal": texts(out) == texts(baseline)}
    log(rec)
    if sup["rebuilds"] != 1 or sup["last_rebuild_reason"] != "poison_rate" or not rec["text_equal"]:
        raise AssertionError(f"tiny poison escalation: {rec}")
    b.close()

    # Replicas: failover from a down member, then a hedge whose loser (a
    # primary slowed at every decode step) is cancelled through its poller.
    b0, b1 = CudaBackend(**knobs), CudaBackend(**knobs)
    rs = ReplicaSet(members=[b0, b1], model="tiny", hedge=False, route_policy="round_robin")
    with fp.failpoints({"replica.dispatch": FailSpec(action="down", member="r0", times=1),
                        "replica.probe": FailSpec(action="fail", member="r0")}):
        out = rs.dispatch_chat_completion(req())
        health = rs.health()
    rec = {"phase": "sched_tiny_failover", "text_equal": texts(out) == texts(baseline),
           "healthy_members": health["healthy_members"],
           "r0_in_rotation": health["replicas"]["r0"]["in_rotation"],
           "probe_rejoins": rs.probe("r0")}
    log(rec)
    if not rec["text_equal"] or rec["healthy_members"] != 1 or not rec["probe_rejoins"]:
        raise AssertionError(f"tiny failover: {rec}")
    rs.close()

    b0, b1 = CudaBackend(**knobs), CudaBackend(**knobs)
    decode = b0.engine._decode

    def slowed(step_fn, *args, **kwargs):
        def step(tok, i):
            time.sleep(0.02)
            return step_fn(tok, i)
        return decode(step, *args, **kwargs)

    b0.engine._decode = slowed
    rs = ReplicaSet(members=[b0, b1], model="tiny", hedge=True, hedge_delay_s=0.05,
                    route_policy="round_robin")
    aborts = FAILURE_EVENTS.get("engine.decode_abort")
    won = HEDGE_EVENTS.get("hedge.won_hedge")
    out = rs.dispatch_chat_completion(req(max_tokens=200))
    deadline = time.monotonic() + 30
    while FAILURE_EVENTS.get("engine.decode_abort") == aborts and time.monotonic() < deadline:
        time.sleep(0.02)
    st = b0.engine.last_launch_stats
    rec = {"phase": "sched_tiny_hedge", "hedge_won": HEDGE_EVENTS.get("hedge.won_hedge") - won,
           "loser_aborted": FAILURE_EVENTS.get("engine.decode_abort") - aborts,
           "loser_decode_steps": st.get("decode_steps"), "loser_aborted_at": st.get("aborted"),
           "breakers": [b0.circuit_breaker.state, b1.circuit_breaker.state]}
    log(rec)
    if (rec["hedge_won"] != 1 or rec["loser_aborted"] != 1 or st["decode_steps"] >= 199
            or rec["breakers"] != ["closed", "closed"]):
        raise AssertionError(f"tiny hedge: {rec}")
    rs.close()


def loop_tiny(log):
    """The continuous loop's recovery at ``tiny`` (fp32) through the
    kernels: a hung step (``continuous.step``) and a hung chunk mid-prompt
    (``continuous.prefill``) are each abandoned behind the epoch fence, the
    engine rebuilt and the journal replayed, with the same text as an
    uninterrupted run."""
    import torch

    from k_llms_tpu_torch.backends.base import ChatRequest
    from k_llms_tpu_torch.backends.cuda import CudaBackend
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec

    knobs = dict(model="tiny", attention_impl="flash", paged_attention_impl="cuda",
                 continuous_batching=True, continuous_width=4, continuous_max_prompt=256,
                 continuous_max_new=32, prefill_chunk_tokens=32)

    def req(content, seed=123):
        return ChatRequest(messages=[{"role": "user", "content": content}], model="tiny", n=2,
                           temperature=0.8, seed=seed, max_tokens=16)

    def texts(out):
        return [c.message.content for c in out.choices]

    short, long = "determinism", "chunked determinism " * 6
    base = CudaBackend(**knobs)
    base.chat_completion(req(short))
    t0 = time.perf_counter()
    baseline = {c: base.chat_completion(req(c)) for c in (short, long)}
    warm_s = (time.perf_counter() - t0) / 2
    base.close()
    budget = max(2.0, 10.0 * warm_s)
    for site, content in (("continuous.step", short), ("continuous.prefill", long)):
        b = CudaBackend(**dict(knobs, watchdog_min_budget_s=budget, watchdog_max_budget_s=budget))
        engine0 = b.engine
        with fp.failpoints({site: FailSpec(action="hang", times=1, delay=3600.0)}):
            t0 = time.perf_counter()
            out = b.chat_completion(req(content))
            wall = time.perf_counter() - t0
        st = b.health()["continuous"]
        rec = {"phase": "loop_tiny_hang", "site": site, "watchdog_budget_s": budget,
               "request_wall_s": wall, "restarts": st["restarts"],
               "last_recovery_reason": st["last_recovery_reason"],
               "replayed_rows": st["replayed_rows"], "prefill_chunks": st["prefill_chunks"],
               "engine_rebuilt": b.engine is not engine0,
               "text_equal": texts(out) == texts(baseline[content])}
        log(rec)
        if (st["restarts"] != 1 or st["last_recovery_reason"] != "hung_step"
                or not rec["engine_rebuilt"] or not rec["text_equal"]
                or (site == "continuous.prefill" and st["prefill_chunks"] == 0)):
            raise AssertionError(f"tiny loop hang drill: {rec}")
        b.close()
    torch.cuda.synchronize()


def sanitize_8b(client, plain_requests, long_text, log):
    """The sanitize phase: both runtime sanitizers armed over the full
    serving stack at Llama-3-8B width on the card. A continuous-batching
    backend over the ``8b`` client's weight tensors (no copy: bf16, paged,
    K1, K2 and the draws, device consensus) behind
    ``ServerThread(create_app(client))`` on loopback serves, all at once:
    two plain ``create()`` requests through the scheduler's coalesced path
    (a logit bias keeps them out of the loop), a JSON request, a ``parse()``
    under the grammar, an SSE stream whose prompt is chunked and a stream
    whose client hangs up, through the loop, and a two-item batch job. The
    set runs unarmed, then armed, both timed; then armed again with one
    ``continuous.step`` hang and one ``continuous.prefill`` hang (healed by
    the watchdog, whose budget comes from warm armed steps and launches, on
    a backend built with it) and, once the plain requests have returned, one
    ``engine.logits`` poison. Asserted:
    every request resolves (success or a typed error), the plain requests'
    texts equal their solo runs on the unarmed ``8b`` client, the page pool
    ends conserved, the backend READY, no violation, and a lock-order graph
    naming the launch lock, the pool, the loop and the scheduler. Then two
    mutants, each of which must add exactly one violation: a K1 launch
    through its wrapper under a checked lock made without
    ``allow_dispatch``, and two threads taking two checked locks in opposite
    orders. The lint (``python -m k_llms_tpu_torch.analysis --check``) runs
    once on this machine, in a process of its own beside the faulted set,
    and must exit 0. Returns the armed window's launch counts."""
    import threading

    import torch

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.analysis import lockcheck
    from k_llms_tpu_torch.backends.cuda import CudaBackend
    from k_llms_tpu_torch.engine.engine import LocalEngine
    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.ops import paged_attention as pa
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec
    from k_llms_tpu_torch.serving import ServerThread, create_app
    from k_llms_tpu_torch.types.wire import KLLMsError
    from k_llms_tpu_torch.utils.observability import QUARANTINE_EVENTS, RECOVERY_EVENTS

    t_phase = time.perf_counter()
    base = client.backend
    eng8 = base.engine
    knobs = dict(continuous_batching=True, continuous_width=16, continuous_max_prompt=512,
                 continuous_max_new=32, prefill_chunk_tokens=128, kv_pool_pages=128)

    def engine_over_8b_weights():
        return LocalEngine(eng8.config, params=eng8.params, device=eng8.device,
                           kv_layout="paged", kv_page_size=eng8.kv_page_size,
                           paged_attention_impl=base.backend_config.paged_attention_impl,
                           kv_pool_pages=knobs["kv_pool_pages"])

    def build(**watchdog):
        backend = CudaBackend(config=base.backend_config.model_copy(update=dict(knobs, **watchdog)),
                              engine=engine_over_8b_weights())
        # A rebuild (the loop's watchdog heals a hang with one) stands up a
        # new engine over the same weight tensors: the seeded weights a cold
        # start would build, without a second 16 GB copy on the card.
        backend._build_engine = engine_over_8b_weights
        return KLLMs(backend=backend), backend

    # The plain requests: the 8b phase's first two, at 16 tokens.
    plain = {f"plain{i}": dict(req, max_tokens=16) for i, req in enumerate(plain_requests)}

    def texts(resp):
        return [c.message.content for c in resp.choices]

    solo = {name: texts(client.chat.completions.create(**req)) for name, req in plain.items()}
    chunked_prompt = long_text[:420] + "\nWhat is the total?"
    loop_body = dict(n=8, temperature=0.8, max_tokens=16)

    def run_set(san_client, port, faults=None):
        """The request set, all at once; with ``faults`` the hangs are armed
        for the whole set and the poison once the plain requests return.
        Returns ({name: (kind, status, payload)}, wall seconds)."""
        results, lock = {}, threading.Lock()

        def keep(name, value):
            with lock:
                results[name] = value

        def plain_req(name, req=None):
            try:
                resp = san_client.chat.completions.create(**(req or plain[name]))
                keep(name, ("ok", 200, texts(resp)))
            except KLLMsError as e:
                keep(name, ("typed", e.status_code, str(e)))

        def json_req(name, seed):
            status, _, raw = http_call(port, "POST", "/v1/chat/completions", dict(
                loop_body, messages=[{"role": "user", "content": "What is the capital of France?"}],
                seed=seed))
            keep(name, ("ok" if status == 200 else "typed", status, json.loads(raw)))

        def parse_req():
            try:
                pc = san_client.chat.completions.parse(
                    messages=[{"role": "user", "content": "Invoice 2024-0117 lists 12 widgets "
                                                          "from Acme. Extract the record."}],
                    response_format=Record, seed=17, **loop_body)
                keep("parse", ("ok", 200, str(pc.choices[0].message.parsed)))
            except KLLMsError as e:
                keep("parse", ("typed", e.status_code, str(e)))

        def stream_req():
            status, frames, _, _ = http_stream(port, dict(
                loop_body, messages=[{"role": "user", "content": chunked_prompt}], seed=21))
            done = status == 200 and frames and frames[-1] == "[DONE]"
            keep("stream", ("ok" if done else "typed", status, len(frames)))

        def hangup_req():
            status, frames, _, _ = http_stream(port, dict(
                loop_body, messages=[{"role": "user", "content": "Name three prime numbers."}],
                seed=22), disconnect_after_first_delta=True)
            keep("hangup", ("ok" if status == 200 else "typed", status, len(frames)))

        def batch_req():
            lines = "\n".join(json.dumps({
                "custom_id": f"c{i}", "method": "POST", "url": "/v1/chat/completions",
                "body": {"messages": [{"role": "user", "content": f"Offline question {i}."}],
                         "n": 2, "seed": 40 + i, "max_tokens": 8}}) for i in range(2))
            status, _, raw = http_call(port, "POST", "/v1/batches", lines.encode())
            job = json.loads(raw)
            wire = job
            deadline = time.monotonic() + 300
            while status == 200 and time.monotonic() < deadline:
                status, _, raw = http_call(port, "GET", f"/v1/batches/{job['id']}")
                wire = json.loads(raw)
                if wire["status"] in ("completed", "completed_with_errors", "cancelled"):
                    break
                time.sleep(0.05)
            keep("batch", ("ok" if wire.get("status") == "completed" else "typed", status,
                           wire.get("status")))

        workers = [threading.Thread(target=plain_req, args=(name,)) for name in plain]
        loop_workers = [threading.Thread(target=f, args=a) for f, a in (
            (json_req, ("json", 11)), (parse_req, ()), (stream_req, ()), (hangup_req, ()),
            (batch_req, ()))]
        t0 = time.perf_counter()
        with fp.failpoints(faults or {}):
            for t in workers + loop_workers:
                t.start()
            join_all(workers, timeout=600)
            if faults:
                # Mid-traffic, once no plain request can take it: a poison
                # window around one more coalesced request, so that its
                # launch takes a NaN row (and so do the loop steps that run
                # meanwhile).
                with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=13,
                                                              times=1000)}):
                    poisoned = threading.Thread(target=plain_req, args=(
                        "poisoned", dict(plain["plain0"], seed=99, max_tokens=8)))
                    poisoned.start()
                    join_all([poisoned], timeout=600)
            join_all(loop_workers, timeout=600)
        return results, time.perf_counter() - t0

    def check_resolved(label, results, names):
        if sorted(results) != sorted(names):
            raise AssertionError(f"sanitize {label}: requests {sorted(results)} != {sorted(names)}")
        for name, (kind, status, payload) in results.items():
            if kind != "ok" and status not in (408, 429, 500, 503):
                raise AssertionError(f"sanitize {label}: {name} answered {status}: {payload}")
        for name in plain:  # the poisoned request is not a plain one
            if results[name][0] != "ok" or results[name][2] != solo[name]:
                raise AssertionError(f"sanitize {label}: {name}'s text differs from its solo run")

    names = list(plain) + ["json", "parse", "stream", "hangup", "batch"]

    def serve(san_client):
        return ServerThread(create_app(san_client)).start()

    def shut(srv, san_client):
        srv.stop(drain=False)
        san_client.close()

    def arm(on):
        for var in ("KLLMS_LOCKCHECK", "KLLMS_RACECHECK"):
            if on:
                os.environ[var] = "1"
            else:
                os.environ.pop(var, None)

    # The same requests unarmed and armed, in turns (unarmed, armed, armed,
    # unarmed: host clocks drift within a call): an unarmed backend, then an
    # armed one built after the variables are set (a lock reads them when
    # it is made), each warmed once first.
    walls = {"unarmed": [], "armed": []}
    san_u, backend_u = build()
    srv_u = serve(san_u)
    run_set(san_u, srv_u.port)
    res, wall = run_set(san_u, srv_u.port)
    check_resolved("unarmed", res, names)
    walls["unarmed"].append(wall)
    try:
        arm(True)
        lockcheck.reset_state()
        san_a, backend_a = build()
        if not (type(backend_a.engine)._kllms_is_tracked
                and isinstance(backend_a.engine._launch_lock, lockcheck._CheckedBase)):
            raise AssertionError("sanitize: the engine's locks are not armed")
        srv_a = serve(san_a)
        run_set(san_a, srv_a.port)
        for _ in range(2):
            res, wall = run_set(san_a, srv_a.port)
            check_resolved("armed", res, names)
            walls["armed"].append(wall)
        arm(False)  # the unarmed backend's per-request objects stay plain
        res, wall = run_set(san_u, srv_u.port)
        check_resolved("unarmed", res, names)
        walls["unarmed"].append(wall)
        shut(srv_u, san_u)
        del san_u, backend_u
        arm(True)
        # The watchdog's budget from warm armed work (the budget models'
        # EWMAs): 20 loop steps or 10 coalesced launches of 16 tokens, at
        # least 10 s. A hang must trip it, no armed step or launch may.
        step_s = backend_a._continuous.budget_model.stats()["per_token_s"]
        launch_s = 16 * backend_a.supervisor.budget_model.stats()["per_token_s"]
        budget = max(10.0, 20.0 * step_s, 10.0 * launch_s)
        shut(srv_a, san_a)
        del san_a, backend_a
        gc.collect()
        torch.cuda.empty_cache()
        san_client, backend = build(watchdog_min_budget_s=budget, watchdog_max_budget_s=budget,
                                    max_rebuilds=4)
        loop = backend._continuous
        srv = serve(san_client)
        hangs = RECOVERY_EVENTS.get("continuous.step_hangs")
        restarts = loop.stats["restarts"]
        chunks = loop.stats["prefill_chunks"]
        poisoned = QUARANTINE_EVENTS.get("quarantine.samples")
        loop_poisoned = loop.stats["quarantined_rows"]
        stale = RECOVERY_EVENTS.get("continuous.stale_steps_discarded")
        # The lint, once on this machine (its Python may differ from the
        # CPU machine's), in a process of its own (unarmed) while the hangs
        # are waited out (after the timed walls).
        lint = subprocess.Popen([sys.executable, "-m", "k_llms_tpu_torch.analysis", "--check"],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                env={k: v for k, v in os.environ.items()
                                     if k not in ("KLLMS_LOCKCHECK", "KLLMS_RACECHECK")},
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda: lint.poll() is None and lint.kill())
        reset_counts()
        faulted, faulted_wall = run_set(san_client, srv.port, faults={
            "continuous.step": FailSpec(action="hang", times=1, delay=budget + 5.0),
            "continuous.prefill": FailSpec(action="hang", times=1, delay=budget + 5.0),
        })
        counts = dict(_ext.LAUNCH_COUNTS)
        # The two abandoned dispatch threads end (and let their engines go)
        # once their hangs do: the phase leaves no thread behind.
        deadline = time.monotonic() + budget + 60
        while RECOVERY_EVENTS.get("continuous.stale_steps_discarded") < stale + 2:
            if time.monotonic() > deadline:
                raise AssertionError("sanitize: an abandoned dispatch thread never ended")
            time.sleep(0.1)
        check_resolved("faulted", faulted, names + ["poisoned"])
        check_consensus_window("sanitize")
        st = loop.stats
        deadline = time.monotonic() + 60
        while loop.stats.get("pages", {}).get("loop_refs") != 0:
            if time.monotonic() > deadline:
                raise AssertionError(f"sanitize: loop pages not returned: {loop.stats}")
            time.sleep(0.05)
        allocator = backend.engine._kv_pool.allocator
        allocator.verify()
        pages = allocator.snapshot()
        state = backend.health()["state"]
        shut(srv, san_client)
        edges = lockcheck.graph()
        found = lockcheck.violations()
        named = sorted({name for edge in edges for name in edge})
        cfg = eng8.config
        unarmed_s, armed_s = sum(walls["unarmed"]) / 2, sum(walls["armed"]) / 2
        rec = {"phase": "sanitize", "model": cfg.name, "layers": cfg.num_layers,
               "hidden": cfg.hidden_size, "dtype": str(cfg.torch_dtype).replace("torch.", ""),
               "kv": "paged", "front_door": "http loopback", "requests": names + ["poisoned"],
               "unarmed_walls_s": walls["unarmed"], "armed_walls_s": walls["armed"],
               "armed_over_unarmed": armed_s / unarmed_s, "faulted_wall_s": faulted_wall,
               "watchdog_budget_s": {"loop_step": budget, "supervisor_launch": budget},
               "warm_armed_step_s": step_s, "warm_armed_launch_s": launch_s,
               "step_hangs": RECOVERY_EVENTS.get("continuous.step_hangs") - hangs,
               "restarts": st["restarts"] - restarts,
               "prefill_chunks": st["prefill_chunks"] - chunks,
               "quarantined_samples": QUARANTINE_EVENTS.get("quarantine.samples") - poisoned,
               "loop_quarantined_rows": st["quarantined_rows"] - loop_poisoned,
               "all_resolved": True, "resolved": {k: v[:2] for k, v in faulted.items()},
               "plain_equal_solo": {name: faulted[name][2] == solo[name] for name in plain},
               "pool_conserved": {"verify": "clean", "loop_refs": 0, **pages},
               "state": state, "launches": counts, "edges": len(edges),
               "locks_in_graph": named, "violations": found}
        log(rec)
        problems = []
        if rec["step_hangs"] != 2 or rec["restarts"] != 2 or rec["prefill_chunks"] < 1:
            problems.append("hangs")
        if rec["quarantined_samples"] < 1:
            problems.append("poison")
        if state != "ready":
            problems.append("state")
        if found:
            problems.append("violations")
        if not all(n in named for n in ("engine.paged_mutex", "engine.kv_pool",
                                         "engine.continuous", "engine.scheduler")):
            problems.append("graph")
        if min(counts[k] for k in ("flash_attention", "paged_decode_attention",
                                   "threefry_uniform_rows")) == 0:
            problems.append("kernels")
        if problems:
            raise AssertionError(f"sanitize: {problems}")

        # Mutant 1: a K1 launch through its wrapper under a checked lock made
        # without allow_dispatch (held against its plain version).
        dev = eng8.device
        g = torch.Generator(device=dev).manual_seed(5)
        B, QH, KVH, D, ps = 8, 32, 8, 128, 64
        pool_k = torch.randn(12 * ps, KVH, D, generator=g, device=dev).to(torch.bfloat16)
        pool_v = torch.randn(12 * ps, KVH, D, generator=g, device=dev).to(torch.bfloat16)
        k1_args = (torch.randn(B, QH, D, generator=g, device=dev).to(torch.bfloat16), pool_k, pool_v,
                   torch.tensor([[1, 2]], dtype=torch.int32, device=dev),
                   torch.arange(3, 3 + B, dtype=torch.int32, device=dev)[:, None].contiguous(),
                   torch.full((B,), 100 % ps, dtype=torch.int32, device=dev),
                   torch.randn(B, KVH, D, generator=g, device=dev).to(torch.bfloat16),
                   torch.randn(B, KVH, D, generator=g, device=dev).to(torch.bfloat16),
                   torch.full((B,), 100, dtype=torch.int32, device=dev),
                   torch.full((B,), 4, dtype=torch.int32, device=dev))
        k1_kw = dict(page_size=ps, sm_scale=1.0 / math.sqrt(D))
        before = len(lockcheck.violations())
        guard = lockcheck.make_lock("smoke.mutant_guard")
        with guard:
            out = pa.paged_decode_attention(*k1_args, **k1_kw)
        torch.cuda.synchronize()
        k1_err = (out - pa.paged_decode_attention_plain(*k1_args, **k1_kw)).abs().max().item()
        dispatch_found = lockcheck.violations()[before:]

        # Mutant 2: two threads take two checked locks in opposite orders.
        a, b = lockcheck.make_lock("smoke.mutant_a"), lockcheck.make_lock("smoke.mutant_b")

        def nested(first, second):
            with first:
                with second:
                    pass

        before = len(lockcheck.violations())
        for first, second in ((a, b), (b, a)):
            t = threading.Thread(target=nested, args=(first, second))
            t.start()
            t.join(30)
        cycle_found = lockcheck.violations()[before:]
        log({"phase": "sanitize_mutants",
             "caught": {"dispatch_under_lock": len(dispatch_found) == 1,
                        "lock_order_inversion": len(cycle_found) == 1},
             "dispatch_violations": dispatch_found, "k1_max_abs_err": k1_err,
             "order_violations": cycle_found})
        if (len(dispatch_found) != 1 or "kernel paged_decode_attention" not in dispatch_found[0]
                or "smoke.mutant_guard" not in dispatch_found[0] or not k1_err <= 1e-5):
            raise AssertionError(f"sanitize: the dispatch mutant was not caught once: {dispatch_found}")
        if len(cycle_found) != 1 or "lock-order cycle" not in cycle_found[0]:
            raise AssertionError(f"sanitize: the lock-order mutant was not caught once: {cycle_found}")
    finally:
        arm(False)
        lockcheck.reset_state()
    del san_client, backend, loop
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    stdout, _ = lint.communicate(timeout=300)
    log({"phase": "sanitize_lint", "exit_code": lint.returncode, "python": sys.version.split()[0],
         "waited_s": time.perf_counter() - t0, "tail": stdout.strip().splitlines()[-1:]})
    if lint.returncode != 0:
        raise AssertionError(f"sanitize: the lint exited {lint.returncode}:\n{stdout[-2000:]}")
    log({"phase": "sanitize_done", "seconds": time.perf_counter() - t_phase})
    return counts


# -- the mesh phase: ranks that share the one card -----------------------------
#
# Module-level so that spawned ranks can import them (``torch.multiprocessing``
# with the spawn start method runs each rank from this file, main() guarded).
# Every rank serves the same calls in the same order, as every rank of the
# port's SPMD program must.

# The relative L2 error allowed between a rank's last-position prefill
# logits and the unsharded client's, fixed before the phase first ran
# (PERF.md derives it): the sharded forward rounds each
# row-parallel partial (and, on the ring, the attention) to bf16 once more
# than the unsharded one, about 2^-9 of a sublayer's output at 64 points of
# the residual stream, ~1.6% at most; K4's limit adds its 2^-6 bound per
# matmul only where an output is near zero.
MESH_LOGITS_REL_L2 = 0.05
#: Seconds within which a follower's fault must reach the controller's
#: request as the typed 503 (the follower ends its process, so every
#: collective waiting on it fails at once; fixed before the first run).
FAULT_LIMIT_S = 60.0
#: The mesh_rebuild job's watchdog budget for a launch and a loop step,
#: fixed after its uninterrupted runs (an 8B int4 launch of 8 rows and 16
#: tokens on two ranks takes a few seconds; fixed before the first run).
REBUILD_BUDGET_S = 8.0
#: Llama-3-8B's depth in each mesh job and in its unsharded reference
#: (widths as published): 8 of its 32 layers, to keep the smoke near half
#: its time limit (at 16 and 32 layers the mesh phase took 250-350 s of the
#: 1200). A job whose first tokens turn on a near tie at one depth (its
#: check compares them with the unsharded client's) takes another: the TP
#: loop's sampled request B flips at 8 layers and holds at 16. The TP int4
#: job of JAX's multi-process start (``hosts``: two host processes of two
#: ranks each) runs the full 32; the world the smoke's own process starts
#: (``spawned``) runs 8, as the hand-started jobs do.
MESH_LAYERS = {"hosts": 32, "spawned": 8, "tp2_bf16": 8, "sp2": 8, "dp2": 8, "dp2_int4": 8,
               "dp2_spec": 8, "dp2_loop": 8, "tp2_loop": 16, "rebuild": 8}
#: JAX's multi-process start on the one card (``mesh_hosts``): host
#: processes, each with ``HOST_RANKS`` ranks over gloo.
HOSTS, HOST_RANKS = 2, 2
#: Seconds within which a follower lost on one host stops the world on
#: every host (``mesh_hosts_fault``).
HOSTS_STOP_LIMIT_S = 10.0
#: The train phase's two-rank TP step (2 layers at Llama-3-8B's widths,
#: bf16, two steps); it runs in the mesh phase's world when both run.
TRAIN_TP2_JOB = dict(layers=2, steps=2, B=2, S=256, valid_last=200)


def mesh_depth(job: str) -> str:
    """The model name of ``job``'s depth."""
    layers = MESH_LAYERS[job]
    return "llama-3-8b" if layers == 32 else f"llama-3-8b-{layers}l"


def mesh_model(name: str) -> str:
    """``name``, registered first where it is a cut of Llama-3-8B's depth,
    ``llama-3-8b-<layers>l`` (each process that builds it, the spawned
    ranks included, registers it)."""
    base = "llama-3-8b"
    if name.startswith(base + "-") and name.endswith("l"):
        from k_llms_tpu_torch.models.config import get_config, register_config

        full = get_config(base)
        register_config(full.with_(name=name, num_layers=int(name[len(base) + 1:-1])))
    return name


def mesh_host_memory() -> dict:
    """This process's resident bytes and the machine's available memory
    (read from /proc; empty where there is none)."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * 1024
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("MemAvailable:", "MemTotal:")):
                    out[line.split(":")[0]] = int(line.split()[1]) * 1024
    except OSError:
        pass
    return out


def mesh_rank_main(rank, world, store, transport, jobs, outq, go) -> None:
    """One rank: join the world, wait for ``go``, run ``jobs`` in order,
    put each result."""
    import traceback
    from datetime import timedelta

    os.environ["KLLMS_RANK_CHECK"] = "1"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(transport, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=600))
    try:
        if not go.wait(timeout=1800):
            raise RuntimeError("the parent never started the jobs")
        for job in jobs:
            t0 = time.perf_counter()
            res = MESH_JOBS[job["kind"]](**job.get("args", {}))
            res["job_s"] = time.perf_counter() - t0
            res["host"] = mesh_host_memory()
            outq.put((rank, job["name"], True, res))
    except BaseException:
        outq.put((rank, "error", False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, transport, jobs, store_dir):
    """Spawn ``world`` ranks on the card that join their world and wait;
    :func:`collect_ranks` starts ``jobs`` in each (the ranks' start-up
    overlaps the parent's work in between). Returns the handle."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outq, go = ctx.Queue(), ctx.Event()
    store = os.path.join(store_dir, f"mesh_store_{transport}_{world}_{time.time_ns()}")
    procs = [ctx.Process(target=mesh_rank_main, args=(r, world, store, transport, jobs, outq, go))
             for r in range(world)]
    for p in procs:
        p.start()
    return {"procs": procs, "outq": outq, "go": go, "store": store, "jobs": jobs,
            "world": world}


def stop_ranks(handle) -> None:
    """Join every rank of ``handle`` (at once, killed, where its jobs never
    started; else within a minute or killed) and remove its store."""
    for p in handle["procs"]:
        p.join(timeout=60 if handle["go"].is_set() else 0)
        if p.is_alive():
            p.kill()
            p.join()
    if os.path.exists(handle["store"]):
        os.remove(handle["store"])


def collect_ranks(handle, timeout=900):
    """Start the jobs of the ranks of ``handle`` and return {job name:
    [result per rank]}. Every rank is joined (or killed) before this
    returns; a failed rank raises with its traceback."""
    import queue

    procs, outq, world, jobs = handle["procs"], handle["outq"], handle["world"], handle["jobs"]
    handle["go"].set()
    results = {job["name"]: [None] * world for job in jobs}
    pending = world * len(jobs)
    deadline = time.perf_counter() + timeout
    try:
        while pending:
            try:
                rank, name, ok, payload = outq.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise RuntimeError(f"mesh ranks {dead} died or timed out") from None
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} failed:\n{payload}")
            results[name][rank] = payload
            pending -= 1
    finally:
        stop_ranks(handle)
    results["_exitcodes"] = [p.exitcode for p in procs]
    return results


def run_ranks(world, transport, jobs, store_dir, timeout=900):
    """Spawn ``world`` ranks on the card, run ``jobs`` in each, and return
    {job name: [result per rank]} (:func:`collect_ranks`)."""
    return collect_ranks(spawn_ranks(world, transport, jobs, store_dir), timeout)


#: What each rank's mesh hooks recorded (each rank is a process of its own).
MESH_STATE: dict = {}

# The hooks every rank runs on its engine in the controller's plan order
# (``HostController.hook``). Module-level, so that the followers of a world
# the smoke's own process started import them from this script.


def hook_reset(engine):
    """The counting window's start: every launch and collective count 0."""
    import torch

    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.parallel import collectives as C

    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    C.reset_collective_counts()


def hook_read(engine):
    """The counting window's end: this rank's counts."""
    import torch

    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.parallel import collectives as C

    torch.cuda.synchronize()
    MESH_STATE["counts"] = dict(_ext.LAUNCH_COUNTS)
    MESH_STATE["collectives"] = dict(C.COLLECTIVE_COUNTS)


def hook_logits(engine, prompts):
    """This rank's last-position prefill logits of ``prompts``."""
    import torch

    out = []
    with torch.inference_mode():
        for ids in prompts:
            ids, plen, bucket = engine._prep_prompt(ids)
            fl, _ = engine._prefill_full(ids, plen, bucket)
            out.append(fl[0].float().cpu().numpy())
    MESH_STATE["logits"] = out


def hook_snapshot(engine):
    """The last launch's stats on this rank."""
    st = engine.last_launch_stats
    MESH_STATE.setdefault("snapshots", []).append(
        {"decode_steps": st["decode_steps"], "rows": st["rows"],
         "rank_rows": st["rank_rows"],
         "aborted": {int(k): v[0] for k, v in st["aborted"].items()}})


def rank_loop(engine):
    """This rank's continuous loop: the controller's own or a follower's
    replica (the parent's, a world of one, from MESH_STATE)."""
    hc = engine.host_controller
    return hc.loop if hc is not None else MESH_STATE["loop"]


def hook_loop_timer(engine):
    """Time each of this rank's loop steps (wall ms, the plan's broadcast
    and rank check included) by its active rows."""
    loop = rank_loop(engine)
    inner, steps = loop._step_once, []
    MESH_STATE["steps"] = steps

    def timed(plan=None):
        rows = int(loop._active_mask.sum())
        t0 = time.perf_counter()
        inner(plan)
        steps.append((rows, (time.perf_counter() - t0) * 1e3))

    loop._step_once = timed


def hook_loop_read(engine):
    loop = rank_loop(engine)
    del loop._step_once
    st = loop.stats
    MESH_STATE["loop_stats"] = {k: st[k] for k in (
        "steps", "row_steps", "admitted", "joined_in_flight", "prefill_chunks",
        "completed", "aborted", "restarts")}
    pool = engine._kv_pool
    MESH_STATE["pool"] = None if pool is None else {
        "pages": pool.allocator.total_pages, "bytes": pool.pool_bytes(),
        "digest": pool.allocator.digest()}


def hook_peak(engine, label):
    """This rank's peak allocated bytes since the last peak hook (or the
    job's start), then the peak counter reset."""
    import torch

    torch.cuda.synchronize()
    MESH_STATE.setdefault("peaks", {})[label] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()


def hook_gather(engine):
    """Every rank's record of the serve job, gathered on each rank over the
    host's plan group (a world the smoke's process started: its followers
    return nothing else to the smoke)."""
    import torch

    hc = engine.host_controller
    mine = {"role": "controller" if hc.is_controller else "follower",
            "counts": MESH_STATE.get("counts"), "collectives": MESH_STATE.get("collectives"),
            "logits": MESH_STATE.get("logits"), "snapshots": MESH_STATE.get("snapshots", []),
            # Plans run, this one included (the controller counts it sent).
            "plans": hc.plans + (0 if hc.is_controller else 1),
            "param_bytes": engine.param_footprint_bytes(),
            "peak_bytes": torch.cuda.max_memory_allocated(), "allocated_before_bytes": None,
            "host": mesh_host_memory(), "pid": os.getpid(), "job_s": None}
    return hc.gather(mine)


def mesh_register_hooks() -> None:
    """Register the mesh hooks by name (every hand-started rank runs this
    script, so each registers its own)."""
    from k_llms_tpu_torch.parallel.controller import register_hook

    for name, fn in (("reset", hook_reset), ("read", hook_read), ("logits", hook_logits),
                     ("snapshot", hook_snapshot), ("loop_timer", hook_loop_timer),
                     ("loop_read", hook_loop_read), ("peak", hook_peak),
                     ("gather", hook_gather)):
        register_hook(name, fn)


def mesh_serve(client_kw, reqs, repeat_last=False, concurrent=False, parse_req=None,
               http=None, model="llama-3-8b", client=None):
    """Build ``KLLMs(model=model, **client_kw)`` (or take ``client``, built
    already) and serve ``reqs``.

    In a world of ranks every rank builds it and the controller (rank 0)
    alone serves: the followers' constructors replay its plans and return
    after its ``close()``. Every launch and collective count is reset just
    before the requests and read just after (the ``reset``/``read`` hooks,
    on every rank in plan order); then, outside the counted window, the
    last-position prefill logits of the launches' prompts (the ``logits``
    hook: each rank's own). ``concurrent`` sends ``reqs`` from one thread
    each at once (the scheduler fuses them), else in turn, the last once
    more with ``repeat_last`` (a prefix-cache exact hit); ``parse_req`` adds
    one parse(); ``http`` (a request body) then runs :func:`mesh_http` on
    the controller. In
    the parent process (a world of one) the same calls run unsharded.
    Returns numpy-free values and arrays; a follower returns its own
    counts, logits, snapshots and plan count. In a world the client's own
    process started, the followers' records come back through the
    ``gather`` hook (``followers``), and ``world_close`` holds each child's
    exit code after ``close()`` and the pids still alive."""
    import threading

    import numpy as np
    import torch

    import gc

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.parallel.controller import HOOKS

    mesh_register_hooks()
    MESH_STATE.clear()
    # An earlier call's client is freed only by a collection (its engine
    # sits in reference cycles): free it before this client's peak counts.
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if client is None:
        client = KLLMs(backend="cuda", model=mesh_model(model), **client_kw)
    backend = client.backend
    engine = backend.engine
    mesh = engine.mesh
    common = {"mesh": None if mesh is None else dict(mesh.shape),
              "transport": None if mesh is None else mesh.transport,
              "param_bytes": engine.param_footprint_bytes(),
              "allocated_before_bytes": allocated_before, "L": engine.config.num_layers}
    if not backend.is_controller:
        res = dict(common, role="follower", counts=MESH_STATE["counts"],
                   collectives=MESH_STATE["collectives"], logits=MESH_STATE["logits"],
                   snapshots=MESH_STATE.get("snapshots", []), plans=backend.controller.plans,
                   session_s=time.perf_counter() - t0, init_s=None, serve_s=None,
                   peak_bytes=torch.cuda.max_memory_allocated())
        del client, backend, engine
        gc.collect()
        torch.cuda.empty_cache()
        return res
    ctl = backend.controller

    def hook(name, *args):
        return ctl.hook(name, *args) if ctl is not None else HOOKS[name](engine, *args)

    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches, embeds = [], []
    generate_many, embed_tokens = engine.generate_many, engine.embed_tokens

    def counted_generate_many(items, **kw):
        out = generate_many(items, **kw)
        st = engine.last_launch_stats
        launches.append({"requests": len(items), "n_per": st["n_per"], "steps": st["decode_steps"],
                         "rows": st["rows"], "rank_rows": st["rank_rows"],
                         "temperature": kw["temperature"], "layout": st["kv_layout"],
                         "ids": [list(it.prompt_ids) for it in items],
                         "tokens": [np.asarray(r.tokens) for r in out],
                         "prefill_s": st["prefill_s"], "decode_s": st["decode_s"]})
        return out

    def counted_embed_tokens(token_lists, *a, **kw):
        embeds.append(len(token_lists))
        return embed_tokens(token_lists, *a, **kw)

    engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
    hook("reset")
    outs = []
    t0 = time.perf_counter()

    def create(req):
        t1 = time.perf_counter()
        resp = client.chat.completions.create(**req)
        return {"texts": [c.message.content for c in resp.choices],
                "likelihoods": resp.likelihoods, "wall_s": time.perf_counter() - t1}

    if concurrent:
        outs = [None] * len(reqs)

        def go(i):
            outs[i] = create(reqs[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for req in list(reqs) + ([reqs[-1]] if repeat_last else []):
            outs.append(create(req))
    if parse_req is not None:
        t1 = time.perf_counter()
        parsed = client.chat.completions.parse(**parse_req)
        outs.append({"texts": [c.message.content for c in parsed.choices],
                     "parsed": parsed.choices[0].message.parsed is not None,
                     "wall_s": time.perf_counter() - t1})
    hook("read")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    del engine.generate_many, engine.embed_tokens, generate_many, embed_tokens
    cache_stats = dict(engine.prefix_cache_stats)
    scope = launches if concurrent else launches[: len(reqs)]
    hook("logits", [ids for ln in scope for ids in ln["ids"]])
    world = backend.world
    followers = hook("gather")[1:] if world is not None else None
    res = dict(common, role="controller", outs=outs, launches=launches, embeds=embeds,
               counts=MESH_STATE["counts"], collectives=MESH_STATE["collectives"],
               logits=MESH_STATE["logits"], cache_stats=cache_stats, init_s=init_s,
               serve_s=serve_s, plans=None if ctl is None else ctl.plans,
               peak_bytes=torch.cuda.max_memory_allocated())
    if followers is not None:
        res["followers"] = followers
    if http is not None:
        res["http"] = mesh_http(client, hook, http)
        res["plans"] = ctl.plans
    client.close()
    if world is not None:
        res["world_close"] = {"exit_codes": [p.returncode for p in world.procs],
                              "alive": [e[2] for e in world.ended if pid_alive(e[2])],
                              "ended": [list(e) for e in world.ended]}
    del client, backend, engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def steps_by_rows(steps):
    """Step wall ms by active rows: {rows: {steps, median_ms}}."""
    import numpy as np

    by = {}
    for rows, ms in steps:
        by.setdefault(rows, []).append(ms)
    return {str(r): {"steps": len(v), "median_ms": float(np.median(v))}
            for r, v in sorted(by.items())}


def mesh_loop(client_kw, reqs, bias_req, biased_at, model="llama-3-8b"):
    """Build ``KLLMs(model=model, **client_kw)`` with the continuous
    loop and drive the loop phase's traffic through it: each of ``reqs``
    (label, request, after this many loop steps, via parse()) from a thread
    of its own, and ``bias_req`` (a logit-bias request: the coalescing path,
    between loop steps) after ``biased_at`` steps. Every rank's launch and
    collective counts are reset just before and read just after, and every
    rank times its loop's steps (the hooks, in the controller's plan order);
    then, outside the window, the last-position prefill logits of the loop's
    prompts. In a world of ranks the controller alone drives and each
    follower's replica replays its loop; in the parent (a world of one) the
    same calls run unsharded. Returns numpy-free values and arrays."""
    import gc
    import threading

    import numpy as np
    import torch

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.parallel.controller import HOOKS

    mesh_register_hooks()
    MESH_STATE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = KLLMs(backend="cuda", model=mesh_model(model), **client_kw)
    backend = client.backend
    engine = backend.engine
    mesh = engine.mesh

    def record(role, **kw):
        return dict(kw, role=role, mesh=None if mesh is None else dict(mesh.shape),
                    L=engine.config.num_layers, counts=MESH_STATE["counts"],
                    collectives=MESH_STATE["collectives"], logits=MESH_STATE["logits"],
                    steps_ms=steps_by_rows(MESH_STATE["steps"]),
                    loop_stats=MESH_STATE["loop_stats"], pool=MESH_STATE["pool"],
                    param_bytes=engine.param_footprint_bytes(),
                    peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                    peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                    session_s=time.perf_counter() - t0)

    if not backend.is_controller:
        res = record("follower", plans=backend.controller.plans)
        del client, backend, engine
        gc.collect()
        torch.cuda.empty_cache()
        return res
    ctl = backend.controller
    loop = backend._continuous
    MESH_STATE["loop"] = loop

    def hook(name, *args):
        return ctl.hook(name, *args) if ctl is not None else HOOKS[name](engine, *args)

    client.chat.completions.create(messages=[{"role": "user", "content": "warm up"}], n=2,
                                   max_tokens=4, temperature=0.0, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = dict(loop.stats)
    subs, launches, embeds, resps, errors = {}, [], [], {}, {}
    submit, generate_many, embed_tokens = loop.submit, engine.generate_many, engine.embed_tokens
    current = threading.local()

    def recording_submit(ids, **kw):
        fut = submit(ids, **kw)
        subs[current.label] = (list(ids), fut)
        return fut

    def counted_generate_many(items, **kw):
        out = generate_many(items, **kw)
        st = engine.last_launch_stats
        launches.append({"requests": len(items), "steps": st["decode_steps"], "rows": st["rows"],
                         "rank_rows": st["rank_rows"], "temperature": kw["temperature"],
                         "tokens": [np.asarray(r.tokens) for r in out]})
        return out

    def counted_embed_tokens(token_lists, *a, **kw):
        embeds.append(len(token_lists))
        return embed_tokens(token_lists, *a, **kw)

    def run(name, req, parse):
        current.label = name
        try:
            fn = client.chat.completions.parse if parse else client.chat.completions.create
            resps[name] = fn(**req)
        except BaseException as e:  # reported below
            errors[name] = repr(e)

    loop.submit = recording_submit
    engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
    hook("reset")
    hook("loop_timer")
    t1 = time.perf_counter()
    threads = []
    pending = sorted(list(reqs) + [("bias", bias_req, biased_at, False)], key=lambda r: r[2])
    for name, req, after, parse in pending:
        while loop._stats["steps"] < after:
            time.sleep(0.0005)
        th = threading.Thread(target=run, args=(name, req, parse))
        th.start()
        threads.append(th)
        if after == 0:  # queued in order before the next one
            while name != "bias" and name not in subs and th.is_alive():
                time.sleep(0.0005)
    join_all(threads)
    wall = time.perf_counter() - t1
    hook("read")
    hook("loop_read")
    del loop.submit, engine.generate_many, engine.embed_tokens
    if errors:
        raise AssertionError(f"mesh loop: requests failed: {errors}")
    st = loop.stats
    delta = {k: st[k] - before[k] for k in ("steps", "admitted", "joined_in_flight", "completed",
                                             "prefill_chunks", "prefill_interleaved", "restarts")}
    labels = sorted(subs)
    hook("logits", [subs[n][0] for n in labels])
    mm = backend.memory_model
    cfg = backend.backend_config
    res = record(
        "controller", plans=None if ctl is None else ctl.plans, init_s=init_s, wall_s=wall,
        delta=delta, launches=launches, embeds=embeds, labels=labels,
        prompt_tokens={n: len(subs[n][0]) for n in labels},
        tokens={n: np.asarray(subs[n][1].result().tokens) for n in labels},
        consensus={n: str(r.choices[0].message.content)[:80] for n, r in resps.items()},
        width=loop.width, prefill_chunk_tokens=loop.prefill_chunk_tokens,
        memory_model={"tp": mm.tp, "dp": mm.dp, "width_cap_fanout1": mm.paged_max_rows(
            cfg.continuous_max_prompt, cfg.continuous_max_new, engine.kv_page_size, fanout=1)})
    client.close()
    MESH_STATE.pop("loop")  # it holds the engine: the parent's memory back
    del client, backend, engine, loop
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_rebuild(client_kw, coalesced_req, loop_req, budget_s, model="llama-3-8b"):
    """The supervisor's and the loop's rebuilds across the world of ranks at
    Llama-3-8B's width: ``KLLMs(model=model, **client_kw)`` with the
    continuous loop, driven by the controller alone. Uninterrupted runs
    first (``coalesced_req``, a logit-bias request, takes the coalescing
    path; ``loop_req`` is submitted to the loop), then with every watchdog
    budget fixed at ``budget_s``: a coalesced launch hung before its plan
    (``engine.launch``), a poison escalation (every row of a launch
    poisoned, then the request again, which rebuilds first), and a loop step
    hung before its plan (``continuous.step``); each hang lasts ``budget_s +
    2`` s, so its thread outlives the rebuild. Each drill's request must
    resolve with the uninterrupted run's tokens, byte for byte (the same
    shapes, seeds and seeded weights). The ``peak`` hook records every
    rank's peak allocated bytes per drill (the controller holds two engines
    while a hung thread keeps the old one; a follower drops its engine
    before it builds the next). Returns numpy-free values."""
    import gc

    import numpy as np
    import torch

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.reliability import failpoints as fp

    mesh_register_hooks()
    MESH_STATE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = KLLMs(backend="cuda", model=mesh_model(model), **client_kw)
    backend = client.backend
    ctl = backend.controller
    if not backend.is_controller:
        res = {"role": "follower", "plans": ctl.plans, "rebuilds": ctl.rebuilds,
               "peaks": MESH_STATE.get("peaks", {}), "counts": MESH_STATE.get("counts"),
               "session_s": time.perf_counter() - t0}
        del client, backend, ctl
        gc.collect()
        torch.cuda.empty_cache()
        return res
    sup, loop = backend.supervisor, backend._continuous

    def coalesced():
        """create(coalesced_req): its launches' tokens (every launch that
        returned, replays included) and its texts, or its error."""
        got = []
        supervised = backend._supervised

        def recording(launch, rows, max_new_tokens):
            out = supervised(launch, rows, max_new_tokens)
            if isinstance(out, list):
                got.extend(np.asarray(r.tokens) for r in out if not isinstance(r, BaseException))
            return out

        backend._supervised = recording
        try:
            resp = client.chat.completions.create(**coalesced_req)
            return got, [c.message.content for c in resp.choices], None
        except Exception as e:
            return got, None, repr(e)
        finally:
            del backend._supervised

    ids = backend.tokenizer.apply_chat_template(loop_req["messages"], add_generation_prompt=True)
    loop_kw = {k: loop_req[k] for k in ("n", "max_new", "temperature", "top_p", "seed")}

    def looped():
        return np.asarray(loop.submit(list(ids), **loop_kw).result(timeout=300).tokens)

    clean_tokens, clean_texts, err = coalesced()
    if err is not None:
        raise AssertionError(f"mesh_rebuild: the uninterrupted request failed: {err}")
    clean_loop = looped()
    init_s = time.perf_counter() - t0
    for model in (sup.budget_model, loop.budget_model):
        model.min_budget_s = model.max_budget_s = budget_s
    ctl.hook("peak", "uninterrupted")
    ctl.hook("reset")
    hang = budget_s + 2.0
    drills = []

    def drill(name, run, equal, t1):
        st, lst = sup.stats(), loop.stats
        drills.append({"drill": name, "seconds": time.perf_counter() - t1, "tokens_equal": equal,
                       "hung_launches": st["hung_launches"], "rebuilds": st["rebuilds"],
                       "last_rebuild_reason": st["last_rebuild_reason"],
                       "loop_restarts": lst["restarts"],
                       "loop_last_recovery_reason": lst["last_recovery_reason"],
                       "world_rebuilds": ctl.rebuilds, "state": backend.health()["state"],
                       **run})
        ctl.hook("peak", name)

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    t1 = time.perf_counter()
    with fp.failpoints({"engine.launch": fp.FailSpec(action="hang", times=1, delay=hang)}):
        toks, texts, err = coalesced()
    drill("hung_launch", {"error": err, "texts_equal": texts == clean_texts},
          same(toks, clean_tokens), t1)
    t1 = time.perf_counter()
    with fp.failpoints({"engine.logits": fp.FailSpec(action="nan", kill=64, seed=0)}):
        _, _, poisoned = coalesced()
    toks, texts, err = coalesced()
    drill("poison_escalation", {"error": err, "poisoned_request": poisoned,
                                "texts_equal": texts == clean_texts},
          same(toks, clean_tokens), t1)
    t1 = time.perf_counter()
    with fp.failpoints({"continuous.step": fp.FailSpec(action="hang", times=1, delay=hang)}):
        replayed = looped()
    drill("loop_hung_step", {"error": None}, bool(np.array_equal(replayed, clean_loop)), t1)
    # The last hung thread wakes on its retired engine and ends.
    time.sleep(max(0.0, t1 + hang + 1.0 - time.perf_counter()))
    ctl.hook("read")
    res = {"role": "controller", "plans": ctl.plans, "rebuilds": ctl.rebuilds, "drills": drills,
           "supervisor": sup.stats(), "loop_stats": {k: loop.stats[k] for k in (
               "steps", "admitted", "completed", "restarts", "replayed_rows")},
           "peaks": MESH_STATE.get("peaks", {}), "counts": MESH_STATE.get("counts"),
           "collectives": MESH_STATE.get("collectives"), "init_s": init_s,
           "param_bytes": backend.engine.param_footprint_bytes(),
           "session_s": time.perf_counter() - t0, "stopped": None if ctl.stopped is None
           else repr(ctl.stopped)}
    client.close()
    del client, backend, ctl, sup, loop
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_http(client, hook, body):
    """The controller's OpenAI-wire front door over a world of ranks, with
    ``body`` (a sampled request): two concurrent requests (one non-streamed,
    one streamed); a 256-token stream whose client hangs up after its first
    delta (the launch aborts; the ``snapshot`` hook shows its rows stopped
    at the same step on every rank); then the next request. Returns the
    observations."""
    import threading

    from k_llms_tpu_torch.serving import ServerThread, create_app
    from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS

    engine = client.backend.engine
    srv = ServerThread(create_app(client)).start()
    port = srv.port
    out = {}
    try:
        got = {}

        def plain():
            got["plain"] = http_call(port, "POST", "/v1/chat/completions", body)[0]

        def streamed():
            status, frames, ttfd, _ = http_stream(port, dict(body, seed=42))
            got["stream"] = (status, frames[-1] == "[DONE]", ttfd)

        threads = [threading.Thread(target=plain), threading.Thread(target=streamed)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["concurrent"] = {"plain_status": got["plain"], "stream_status": got["stream"][0],
                             "stream_done": got["stream"][1], "ttfd_s": got["stream"][2]}
        aborts = FAILURE_EVENTS.get("engine.decode_abort")
        before = engine.last_launch_stats
        t0 = time.perf_counter()
        status, frames, ttfd, _ = http_stream(port, dict(body, seed=43, max_tokens=256),
                                              disconnect_after_first_delta=True)
        deadline = time.monotonic() + 120
        while FAILURE_EVENTS.get("engine.decode_abort") == aborts:
            if time.monotonic() > deadline or engine.last_launch_stats is not before:
                time.sleep(0.5)  # the abort is recorded after the launch's stats
                if FAILURE_EVENTS.get("engine.decode_abort") != aborts:
                    break
                raise AssertionError(
                    "mesh_dp2_serve: the disconnect did not abort the launch: "
                    f"{ {k: v for k, v in engine.last_launch_stats.items() if k != 'aborted'} }")
            time.sleep(0.01)
        out["abort"] = {"status": status, "ttfd_s": ttfd, "abort_s": time.perf_counter() - t0,
                        "decode_steps": engine.last_launch_stats["decode_steps"],
                        "aborted": {int(k): v[0] for k, v in
                                    engine.last_launch_stats["aborted"].items()}}
        hook("snapshot")
        out["next_status"] = http_call(port, "POST", "/v1/chat/completions",
                                       dict(body, seed=44, max_tokens=8))[0]
    finally:
        srv.stop(drain=False)
    return out


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` runs (an exited process not yet reaped counts as
    ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def spawned_client(client_kw, model, ranks=2):
    """A plain ``KLLMs(backend="cuda", ...)`` in this process with the
    forced local rank count at ``ranks``: the backend starts its host's
    other ranks itself (``k_llms_tpu_torch/parallel/launcher.py``), each on
    the one card over gloo, and returns once every rank has built its
    shard."""
    from k_llms_tpu_torch import KLLMs

    mesh_register_hooks()
    os.environ["KLLMS_LOCAL_RANKS"] = str(ranks)
    try:
        return KLLMs(backend="cuda", model=mesh_model(model), **client_kw)
    finally:
        del os.environ["KLLMS_LOCAL_RANKS"]


def run_spawned_job(client_kw, reqs, model):
    """mesh_spawned: :func:`spawned_client`, then :func:`mesh_serve` on it;
    the controller's record with the client's build seconds, the job's and
    the host's memory."""
    t0 = time.perf_counter()
    client = spawned_client(client_kw, model)
    init_s = time.perf_counter() - t0
    res = mesh_serve(client_kw, reqs, model=model, client=client)
    del client
    res.update(init_s=init_s, job_s=time.perf_counter() - t0, host=mesh_host_memory())
    return res


def spawned_restart_main(outq) -> None:
    """The restart drill (``mesh_spawned_restart``) as a plain process: tiny
    on two ranks (1, 2) it started itself; a follower SIGKILLed while idle,
    then one killed from the first streamed token's sink, each followed by
    the next request; then ``close()``. Puts its record or a traceback."""
    import signal
    import traceback

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torch

        torch.cuda.set_device(0)
        req = dict(messages=[{"role": "user", "content": "Count to twenty."}], n=4, seed=3,
                   temperature=0.8, max_tokens=24)

        def texts(resp):
            return [c.message.content for c in resp.choices]

        def allocated():
            """This process's allocated device bytes (a released engine's
            memory given back)."""
            gc.collect()
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()

        def wait_restarts(world, k, timeout=300):
            deadline = time.monotonic() + timeout
            while world.restarts < k:
                if world.terminal is not None or time.monotonic() > deadline:
                    raise RuntimeError(f"the world did not restart: {world.stats()}")
                time.sleep(0.01)

        t0 = time.perf_counter()
        client = spawned_client(dict(max_new_tokens=24, model_parallel=2), "tiny")
        world = client.backend.world
        out = {"init_s": time.perf_counter() - t0, "mesh": dict(client.backend.engine.mesh.shape),
               "transport": client.backend.engine.mesh.transport}
        first = texts(client.chat.completions.create(**req))
        out["allocated_bytes"] = [allocated()]
        # Killed while idle: the next request costs nothing but the restart.
        t0 = time.perf_counter()
        os.kill(world.pids[0], signal.SIGKILL)
        wait_restarts(world, 1)
        out["idle_restart_s"] = time.perf_counter() - t0
        idle = texts(client.chat.completions.create(**req))
        out["idle_kill_to_served_s"] = time.perf_counter() - t0
        out["idle_equal"] = idle == first
        out["allocated_bytes"].append(allocated())
        # Killed during a launch, from the first streamed token's sink.
        pid, t_kill, err = world.pids[0], None, None
        try:
            for _ in client.chat.completions.create(stream=True, **req):
                if t_kill is None:
                    t_kill = time.perf_counter()
                    os.kill(pid, signal.SIGKILL)
        except Exception as e:
            err = {"type": type(e).__name__, "status": getattr(e, "status_code", None),
                   "seconds": time.perf_counter() - t_kill, "message": str(e)[:300]}
        out["launch_error"] = err
        wait_restarts(world, 2)
        after = texts(client.chat.completions.create(**req))
        out["launch_kill_to_served_s"] = time.perf_counter() - t_kill
        out["after_equal"] = after == first
        out["allocated_bytes"].append(allocated())
        out["state"] = client.backend.scheduler.state.value
        out["world"] = world.stats()
        client.close()
        out["close"] = {"exit_codes": [p.returncode for p in world.procs],
                        "alive": [e[2] for e in world.ended if pid_alive(e[2])],
                        "ended": [list(e) for e in world.ended]}
        outq.put(("ok", out))
    except BaseException:
        outq.put(("error", traceback.format_exc()))


def run_spawned_restart_drill(timeout=600):
    """Run :func:`spawned_restart_main` in a fresh process; returns its
    record (raises with its traceback, or when it does not answer)."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    proc = ctx.Process(target=spawned_restart_main, args=(outq,))
    proc.start()
    try:
        kind, payload = outq.get(timeout=timeout)
    except queue.Empty:
        kind, payload = "error", "the restart drill did not answer"
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if kind != "ok":
        raise RuntimeError(f"mesh_spawned_restart failed:\n{payload}")
    payload["exit_code"] = proc.exitcode
    return payload


def hosts_fault(pid: int) -> dict:
    """``mesh_hosts_fault`` on one host: tiny on the (2, 2) world; after a
    first request every host streams the same request, and host 0 (the
    data axis's first rank, which delivers every data rank's streamed
    tokens) kills the last host's follower from its first streamed token's
    sink: each host's launch in flight gets the typed 503, its scheduler
    stops, and the next request gets the typed 503 too."""
    import signal

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.types.wire import BackendUnavailableError

    req = dict(messages=[{"role": "user", "content": "Count to twenty."}], n=4, seed=3,
               temperature=0.8, max_tokens=48)
    client = KLLMs(backend="cuda", model="tiny", max_new_tokens=48, model_parallel=2)
    backend = client.backend
    world = backend.world
    store = world.host.store
    first = [c.message.content for c in client.chat.completions.create(**req).choices]
    if pid == HOSTS - 1:
        store.set("smoke/victim", str(world.pids[0]))
    victim = int(store.get("smoke/victim"))

    def error_of(fn):
        try:
            fn()
        except Exception as e:
            return {"type": type(e).__name__, "status": getattr(e, "status_code", None),
                    "typed": isinstance(e, BackendUnavailableError), "at": time.time(),
                    "message": str(e)[:300]}
        return None

    killed = {}

    def stream():
        for _ in client.chat.completions.create(stream=True, **req):
            if pid == 0 and not killed:
                killed["at"] = time.time()
                os.kill(victim, signal.SIGKILL)

    error = error_of(stream)
    deadline = time.monotonic() + 4 * HOSTS_STOP_LIMIT_S
    while backend.health()["state"] != "stopped" and time.monotonic() < deadline:
        time.sleep(0.01)
    stopped_at = time.time()
    t0 = time.perf_counter()
    after = error_of(lambda: client.chat.completions.create(**req))
    after_s = time.perf_counter() - t0
    state = backend.health()["state"]
    client.close()
    return {"first": first, "killed_at": killed.get("at"), "stopped_at": stopped_at,
            "error": error, "after": after, "after_s": after_s, "state": state}


def host_main(pid, port, job, outq) -> None:
    """One host of JAX's multi-process start (``mesh_hosts`` and its fault
    drill): the three ``KLLMS_*`` variables on a loopback coordinator and
    ``KLLMS_LOCAL_RANKS``, then ``initialize_multihost()``, which starts
    this host's follower into the world of every process (host-major
    ranks), then ``job``: ``serve`` (:func:`mesh_serve` of a client built
    here: it hands the follower its configuration) or ``fault``
    (:func:`hosts_fault`). Puts (pid, "ok", record) or (pid, "error",
    traceback)."""
    import traceback

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torch
        import torch.distributed as dist

        os.environ.update(KLLMS_COORDINATOR=f"127.0.0.1:{port}", KLLMS_NUM_PROCESSES=str(HOSTS),
                          KLLMS_PROCESS_ID=str(pid), KLLMS_LOCAL_RANKS=str(HOST_RANKS))
        torch.cuda.set_device(0)
        from k_llms_tpu_torch.parallel.distributed import host_ranks, initialize_multihost

        mesh_register_hooks()
        t0 = time.perf_counter()
        initialize_multihost()
        place = {"world": dist.get_world_size(), "rank": dist.get_rank(),
                 "host_ranks": host_ranks().ranks, "transport": dist.get_backend(),
                 "start_s": time.perf_counter() - t0}
        if job["kind"] == "serve":
            res = mesh_serve(job["client_kw"], job["reqs"], model=job["model"])
        else:
            res = hosts_fault(pid)
        # The world outlives its clients, as JAX's distributed runtime does;
        # closed here (the process's exit would close it) to read each
        # follower's exit.
        from k_llms_tpu_torch.parallel.launcher import host_world

        world = host_world()
        world.close()
        res["world_close"] = {"exit_codes": [p.returncode for p in world.procs],
                              "alive": [e[2] for e in world.ended if pid_alive(e[2])],
                              "ended": [list(e) for e in world.ended]}
        res.update(place=place, job_s=time.perf_counter() - t0, host=mesh_host_memory())
        outq.put((pid, "ok", res))
    except BaseException:
        outq.put((pid, "error", traceback.format_exc()))


def run_hosts(job, timeout=900):
    """:func:`host_main` on ``HOSTS`` fresh processes (one a host); returns
    their records in process order, each with its exit code (raises with a
    host's traceback, or when one does not answer)."""
    import queue
    import socket

    import torch.multiprocessing as mp

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    procs = [ctx.Process(target=host_main, args=(p, port, job, outq)) for p in range(HOSTS)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < HOSTS:
            try:
                pid, kind, payload = outq.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"hosts {sorted(set(range(HOSTS)) - set(got))} did not "
                                   f"answer {job['kind']} in {timeout} s") from None
            if kind != "ok":
                raise RuntimeError(f"host {pid} failed {job['kind']}:\n{payload}")
            got[pid] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for pid, p in enumerate(procs):
        got[pid]["exit_code"] = p.exitcode
    return [got[p] for p in range(HOSTS)]


def mesh_fault_rank(rank, world, store, outq) -> None:
    """One rank of the follower-fault drill at ``tiny`` on the card: rank
    1's first launch raises a kernel error (the ``engine.launch`` failpoint
    armed in its process only), which ends it; rank 0, the controller,
    reports the typed 503 it got and how long it took, twice."""
    import traceback
    from datetime import timedelta

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import contextlib

    import torch
    import torch.distributed as dist

    from k_llms_tpu_torch import KLLMs
    from k_llms_tpu_torch.ops.paged_attention import KernelUnavailableError
    from k_llms_tpu_torch.reliability.failpoints import FailSpec, failpoints

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=300))
        armed = failpoints({"engine.launch": FailSpec(
            error_factory=lambda: KernelUnavailableError("drilled kernel fault on a follower"),
            times=1)}) if rank == 1 else contextlib.nullcontext()
        with armed:
            client = KLLMs(backend="cuda", model="tiny", max_new_tokens=8)
        errors = []
        for _ in range(2):
            t0 = time.perf_counter()
            try:
                client.chat.completions.create(messages=[{"role": "user", "content": "hi"}],
                                               n=2, seed=1)
                errors.append(None)
            except Exception as e:
                errors.append({"type": type(e).__name__, "status": getattr(e, "status_code", None),
                               "seconds": time.perf_counter() - t0, "message": str(e)})
        client.close()
        outq.put((rank, errors))
    except BaseException:
        outq.put((rank, traceback.format_exc()))


def run_fault_drill(store_dir, timeout=300):
    """Spawn the two ranks of :func:`mesh_fault_rank`; returns (rank 0's
    errors, each rank's exit code)."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    store = os.path.join(store_dir, f"fault_store_{time.time_ns()}")
    procs = [ctx.Process(target=mesh_fault_rank, args=(r, 2, store, outq)) for r in range(2)]
    for p in procs:
        p.start()
    answer = None
    try:
        try:
            rank, answer = outq.get(timeout=timeout)
        except queue.Empty:
            answer = "no answer from the controller"
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.remove(store)
    return answer, [p.exitcode for p in procs]


def mesh_w4_tp_check(shapes, rows_list, seed=0):
    """w4_matmul_tp over the world's (1, world) mesh on each full (K, N)
    problem, split ``col`` and ``row``: the whole result (the column blocks
    gathered) against the unsharded plain product, beside two mutants of the
    function that must be caught (the row split with one partial dropped;
    the column shard cut at the other rank's offset). The limit: K4's, plus
    two bf16 roundings of the row split's partials."""
    import torch

    from k_llms_tpu_torch.ops import w4matmul as w4
    from k_llms_tpu_torch.parallel.collectives import all_gather, psum
    from k_llms_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from k_llms_tpu_torch.parallel.sharding import P, shard_leaf

    import torch.distributed as dist

    world = dist.get_world_size()
    mesh = make_mesh(1, world)
    me = mesh.axis_index(MODEL_AXIS)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for K, N in shapes:
        q = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5) / (4.61 * math.sqrt(K))
        full = w4.Q4Tensor(q, scale)
        deq = w4.unpack_int4(full)
        for rows in rows_list:
            x = (torch.randn((rows, K), generator=gen, device=dev) * 1.0).to(torch.bfloat16)
            ref = w4.w4_matmul_plain(x, full).float()
            terms = x.float().abs() @ deq.abs()
            for part in ("col", "row"):
                wspec = P(None, MODEL_AXIS) if part == "col" else P(MODEL_AXIS, None)
                xs = x if part == "col" else shard_leaf(x, P(None, MODEL_AXIS), mesh)
                w = w4.Q4Tensor(shard_leaf(q, wspec, mesh), shard_leaf(scale, wspec, mesh),
                                part=part, mesh=mesh)

                def whole(out):
                    return (all_gather(out, MODEL_AXIS, mesh, dim=1) if part == "col" else out).float()

                out = whole(w4.w4_matmul_tp(xs, w))
                torch.cuda.synchronize()
                if part == "row":
                    partial = w4.w4_matmul_plain(xs, w).float()
                    partial_abs = psum(partial.abs(), MODEL_AXIS, mesh)
                    mutant = whole(w4.w4_matmul(xs, w))  # one rank's partial: the others dropped
                else:
                    partial_abs = torch.zeros_like(ref)
                    other = (me + 1) % world
                    blk = N // world
                    wrong = w4.Q4Tensor(q[:, other * blk:(other + 1) * blk].contiguous(),
                                        scale[:, other * blk:(other + 1) * blk].contiguous())
                    mutant = whole(w4.w4_matmul(xs, wrong))
                limit = 2.0 ** -6 * ref.abs() + 1e-5 * terms + 2.0 ** -8 * partial_abs + 1e-30

                def over(o):
                    return ((o - ref).abs() / limit).max().item()

                cases.append({"K": K, "N": N, "rows": rows, "part": part,
                              "err_over_limit": over(out), "max_abs_err": (out - ref).abs().max().item(),
                              "mutant_err_over_limit": over(mutant),
                              "mutant": "partial dropped" if part == "row" else "wrong column offset"})
    return {"cases": cases}


def mesh_psum_times(shapes, iters=20):
    """Host time of one ``psum`` over the world's model axis of a bf16
    [rows, N] device tensor (the row split's), per shape, under the
    world's transport; the bytes it stages through the host."""
    import torch

    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh

    import torch.distributed as dist

    mesh = make_mesh(1, dist.get_world_size())
    out = []
    for rows, N in shapes:
        x = torch.ones((rows, N), dtype=torch.bfloat16, device="cuda")
        y = C.psum(x, MODEL_AXIS, mesh)  # warm
        torch.cuda.synchronize()
        if not bool((y == dist.get_world_size()).all()):
            raise AssertionError("psum of ones is not the world size")
        C.reset_collective_counts()
        t0 = time.perf_counter()
        for _ in range(iters):
            C.psum(x, MODEL_AXIS, mesh)
        torch.cuda.synchronize()
        out.append({"rows": rows, "N": N, "host_ms": (time.perf_counter() - t0) * 1e3 / iters,
                    "staged_bytes_per_call": C.COLLECTIVE_COUNTS["host_staged_bytes"] // iters,
                    "transport": mesh.transport})
    return {"psum": out}


def mesh_nccl_one(shapes, rows_list):
    """A world of one over nccl on device tensors: the five collectives are
    the identity, and w4_matmul_tp at TP = 1 equals w4_matmul bit for bit."""
    import torch

    from k_llms_tpu_torch.ops import w4matmul as w4
    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

    mesh = make_mesh(1, 1)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((4, 8, 16), generator=gen, device=dev).to(torch.bfloat16)
    ident = {}
    for axis in (DATA_AXIS, MODEL_AXIS):
        ident[axis] = {
            "psum": bool(torch.equal(C.psum(x, axis, mesh), x)),
            "pmax": bool(torch.equal(C.pmax(x, axis, mesh), x)),
            "all_gather": bool(torch.equal(C.all_gather(x, axis, mesh, dim=1), x)),
            "ppermute": bool(torch.equal(C.ppermute(x, axis, mesh), x)),
            "all_to_all": bool(torch.equal(C.all_to_all(x, axis, mesh, split_dim=1, concat_dim=2), x)),
        }
    torch.cuda.synchronize()
    tp = []
    for K, N in shapes:
        q = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5) / (4.61 * math.sqrt(K))
        for rows in rows_list:
            xs = torch.randn((rows, K), generator=gen, device=dev).to(torch.bfloat16)
            base = w4.w4_matmul(xs, w4.Q4Tensor(q, scale))
            for part in ("col", "row"):
                got = w4.w4_matmul_tp(xs, w4.Q4Tensor(q, scale, part=part, mesh=mesh))
                tp.append({"K": K, "N": N, "rows": rows, "part": part,
                           "bit_equal": bool(torch.equal(got, base))})
    y = torch.ones((2048, 4096), dtype=torch.bfloat16, device=dev)
    C.psum(y, MODEL_AXIS, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        C.psum(y, MODEL_AXIS, mesh)
    torch.cuda.synchronize()
    return {"identity": ident, "w4_tp": tp, "transport": mesh.transport,
            "psum_2048x4096_host_ms": (time.perf_counter() - t0) * 1e3 / 20,
            "staged_bytes": C.COLLECTIVE_COUNTS["host_staged_bytes"]}


# -- the train phase: the causal-LM train step on the card --------------------
#
# Limits, fixed before the phase first ran. fp32 card against fp32 CPU
# (parts a and c): the loss to
# 1e-5 relative and the parameters after three AdamW steps to 5e-5 absolute
# (the CPU twins' limits against JAX: Adam moves an element with a
# near-zero gradient by up to the learning rate whatever sign its float
# noise has); each leaf's gradient norm to 1e-4 relative. bf16 (parts e and
# the card-only test): the loss to 1e-2 relative, since the sharded forward
# rounds each row-parallel partial to bf16 once more than the unsharded one
# (about 2^-9 of a sublayer's output) and the card's and the CPU's bf16
# matmuls round at other points.
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_PARAM_ATOL = 5e-5
TRAIN_F32_GRAD_NORM_RTOL = 1e-4
TRAIN_BF16_LOSS_RTOL = 1e-2


def train_config(layers: int, dtype: str):
    """Llama-3-8B at its published widths with the reference attention
    (the flash kernel has no backward), cut to ``layers``."""
    from k_llms_tpu_torch.models.config import get_config

    return get_config("llama-3-8b").with_(attention_impl="xla", num_layers=layers, dtype=dtype)


def train_batch(config, B: int, S: int, valid_last: int, seed: int):
    """Seeded byte tokens [B, S] (int64, CPU) whose last row holds
    ``valid_last`` real tokens and pads the rest, and its mask."""
    import numpy as np
    import torch

    tokens = np.random.default_rng(seed).integers(0, 256, (B, S))
    mask = np.ones_like(tokens)
    mask[-1, valid_last:] = 0
    tokens[mask == 0] = config.pad_token_id
    return torch.from_numpy(tokens), torch.from_numpy(mask)


def tree_to(tree: dict, device) -> dict:
    """A copy of a plain (unsharded, unquantized) tree on ``device``."""
    return {"embed": tree["embed"].to(device, copy=True),
            "layers": {k: v.to(device, copy=True) for k, v in tree["layers"].items()},
            "final_norm": tree["final_norm"].to(device, copy=True),
            "lm_head": tree["lm_head"].to(device, copy=True)}


def loss_and_grad_norms(config, tree, tokens, mask):
    """The port's loss on ``tree``'s device and each leaf's gradient norm
    (f64), with the tree left as it was."""
    import torch

    from k_llms_tpu_torch.engine.training import _leaves, causal_lm_loss

    leaves = dict(_leaves(tree))
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        dev = tree["embed"].device
        loss = causal_lm_loss(config, tree, tokens.to(dev), mask.to(dev))
        loss.backward()
    finally:
        for p in leaves.values():
            p.requires_grad_(False)
    norms = {path: p.grad.double().norm().item() for path, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    return loss.item(), norms


def mesh_train(layers, B, S, valid_last, steps, seed):
    """``steps`` train steps of the seeded Llama-3-8B-width tree (bf16,
    ``layers`` deep) on the world's (1, world) mesh, each rank drawing the
    whole tree leaf by leaf and keeping its shard (the unsharded draws);
    each step's loss, collective counts and host seconds."""
    import torch
    import torch.distributed as dist

    from k_llms_tpu_torch.engine.training import make_train_step
    from k_llms_tpu_torch.models.llama import init_params
    from k_llms_tpu_torch.parallel import collectives as C
    from k_llms_tpu_torch.parallel.mesh import make_mesh
    from k_llms_tpu_torch.parallel.sharding import param_specs, shard_node

    mesh = make_mesh(1, dist.get_world_size())
    cfg = train_config(layers, "bfloat16")
    specs = param_specs(cfg)
    flat = {**specs["layers"], **{k: v for k, v in specs.items() if k != "layers"}}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    tree = init_params(cfg, gen, "cuda", shard=lambda key, leaf: shard_node(leaf, flat[key], mesh))
    tree["mesh"] = mesh
    tokens, mask = train_batch(cfg, B, S, valid_last, seed)
    init_state, step = make_train_step(cfg, mesh=mesh)
    opt = init_state(tree)
    out = []
    for _ in range(steps):
        C.reset_collective_counts()
        t0 = time.perf_counter()
        tree, opt, loss = step(tree, opt, tokens, mask)
        loss = loss.item()
        out.append({"loss": loss, "step_s": time.perf_counter() - t0,
                    "collectives": dict(C.COLLECTIVE_COUNTS)})
    res = {"steps": out, "L": cfg.num_layers, "peak_bytes": torch.cuda.max_memory_allocated(),
           "mesh": dict(mesh.shape), "transport": mesh.transport}
    del tree, opt
    torch.cuda.empty_cache()
    return res


MESH_JOBS = {"serve": mesh_serve, "loop": mesh_loop, "w4_tp": mesh_w4_tp_check,
             "psum": mesh_psum_times, "nccl_one": mesh_nccl_one, "train": mesh_train,
             "rebuild": mesh_rebuild}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES) - set(EXTRA_PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known {PHASES}")
    if "ckpt" in phases and "8b" not in phases:
        raise SystemExit("the ckpt phase serves the 8b phase's tree: add 8b")
    if "sched" in phases and "8b" not in phases:
        raise SystemExit("the sched phase drives the 8b phase's client: add 8b")
    if "serve" in phases and "8b" not in phases:
        raise SystemExit("the serve phase serves the 8b phase's client over HTTP: add 8b")
    if "sanitize" in phases and "8b" not in phases:
        raise SystemExit("the sanitize phase serves the 8b phase's weights: add 8b")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor

    from k_llms_tpu_torch.ops import _ext

    # The kernels build (one nvcc per source) while the device comes up.
    background = ThreadPoolExecutor(max_workers=2)
    build_started = time.perf_counter()
    build_future = background.submit(_ext.build_all) if "build" in phases else None

    from k_llms_tpu_torch.ops import attention as att
    from k_llms_tpu_torch.ops import paged_attention as pa

    watch_levenshtein()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale
        return x.to(dtype)

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # One stream captures every timing graph: PyTorch keeps a cuBLAS
    # workspace for each stream it has run cuBLAS on, so a fresh stream per
    # timing would leave one behind each time.
    capture_stream = torch.cuda.Stream()

    def device_ms(calls, reps=3):
        """Device time of one call in ms: ``reps`` passes over ``calls``
        (each a call on its own inputs) captured in one CUDA graph, one
        replay timed with CUDA events, over the call count. The replay runs
        the kernels back to back without the host, so this is their time
        plus the launch gaps inside a graph."""
        capture_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(capture_stream):  # warm up: builds, workspaces, semaphores
            for c in calls:
                c()
        torch.cuda.current_stream().wait_stream(capture_stream)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture_stream):
            for _ in range(reps):
                for c in calls:
                    c()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * len(calls))

    def copies_for(nbytes):
        """How many input copies a cold rotation needs."""
        return max(2, min(64, math.ceil(COLD_ROTATION_BYTES / nbytes)))

    # 1. device
    log({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
         "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    kernels = {}

    # 2. build
    sass_future = None
    if "build" in phases:
        per = build_future.result()
        for name in _ext.KERNELS:
            _ext.load(name)
        log({"phase": "build", "seconds": time.perf_counter() - build_started,
             "per_source_s": per})
        # The tensor-core kernels must compile to tensor-core instructions:
        # read from the libraries in the background (one cuobjdump each, all
        # started together) and checked after the K2 phase.
        sass_future = background.submit(sass_check)

    # 3. The draw kernel: a decode step's uniforms, bit-equal to the plain
    # version and to jax.random's own answers. A coalesced step
    # (threefry_uniform) and the loop's step (threefry_uniform_rows) launch
    # the same per-row kernel.
    if "draws" in phases:
        from k_llms_tpu_torch.ops import random as rnd

        def bits_of(t):
            return t.view(torch.int32)

        def swapped_fold(keys, step, n_per, V):
            # Mutant: the row folded in before the step.
            rows = torch.arange(n_per, dtype=torch.int64, device=keys.device)
            row_first = rnd.fold_in(keys[:, None, :], rows[None, :])
            return rnd.uniform_tiny(rnd.fold_in(row_first, step.to(torch.int64)).reshape(-1, 2), V)

        def coalesced_plain(keys, step, n_per, V):
            # A coalesced step's rows, request-major, from the plain threefry.
            return rnd.uniform_tiny(rnd.row_keys(keys, step.to(torch.int64), n_per), V)

        def wrong_rotation(keys, step, n_per, V):
            # Mutant: one rotation constant off by one.
            saved = rnd._ROTATIONS
            rnd._ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 25))
            try:
                return coalesced_plain(keys, step, n_per, V)
            finally:
                rnd._ROTATIONS = saved

        mutants = {"wrong_rotation": wrong_rotation, "step_row_swapped": swapped_fold}
        caught = {m: 0 for m in mutants}
        draw_cases = []
        for R, n_per in ((1, 8), (2, 8)):
            for V in (128256, 512):
                for step in (0, 1, 63):
                    keys = rnd.request_keys([3000000000, 7][:R], dev)
                    step_t = torch.tensor(step, dtype=torch.int32, device=dev)
                    got = rnd.threefry_uniform(keys, step_t, n_per, V)
                    torch.cuda.synchronize()
                    ref = coalesced_plain(keys, step_t, n_per, V)
                    equal = bool(torch.equal(bits_of(got), bits_of(ref)))
                    for m, fn in mutants.items():
                        caught[m] += int(not torch.equal(bits_of(got), bits_of(fn(keys, step_t, n_per, V))))
                    draw_cases.append({"B": R * n_per, "V": V, "step": step, "bit_equal": equal})
                    if not equal:
                        raise AssertionError(f"threefry_uniform B={R * n_per} V={V} step={step} "
                                             "differs from its plain version")
        known = {}
        for (seed, step, row), (words, first) in JAX_DRAWS.items():
            keys = rnd.request_keys([seed], dev)
            step_t = torch.tensor(step, dtype=torch.int32, device=dev)
            got = rnd.threefry_uniform(keys, step_t, 4, 512)
            key_words = rnd.row_keys(keys, step_t, 4)[row].tolist()
            got_bits = [b & 0xFFFFFFFF for b in bits_of(got[row, :4]).tolist()]
            known[f"{seed}/{step}/{row}"] = key_words == words and got_bits == first
        log({"phase": "draws", "cases": draw_cases, "jax_answers_equal": known,
             "mutants_caught": caught, "cases_run": len(draw_cases)})
        if not all(known.values()):
            raise AssertionError(f"threefry_uniform disagrees with jax.random's answers: {known}")
        if min(caught.values()) != len(draw_cases):
            raise AssertionError(f"a draw mutant kept bit equality: {caught}")
        # The continuous loop's per-row entry: each row its own key, step
        # and sample index. Held bit for bit to its plain version at the
        # loop's width (with a mutant: step and index swapped) and to
        # jax.random's answers, which are per-row keys already.
        rows_cases = []
        rows_caught = 0
        for V in (128256, 512):
            for trial in range(3):
                g = np.random.default_rng(100 * trial + V)
                keys = rnd.request_keys(g.integers(0, 2 ** 32, 32).tolist(), dev)
                steps_t = torch.tensor(g.integers(0, 97, 32), dtype=torch.int32, device=dev)
                index_t = torch.tensor(g.integers(0, 32, 32), dtype=torch.int32, device=dev)
                got = rnd.threefry_uniform_rows(keys, steps_t, index_t, V)
                ref = rnd.threefry_uniform_rows_plain(keys, steps_t, index_t, V)
                equal = bool(torch.equal(bits_of(got), bits_of(ref)))
                rows_caught += int(not torch.equal(bits_of(got), bits_of(
                    rnd.threefry_uniform_rows_plain(keys, index_t, steps_t, V))))
                rows_cases.append({"B": 32, "V": V, "trial": trial, "bit_equal": equal})
                if not equal:
                    raise AssertionError(f"threefry_uniform_rows V={V} differs from its plain version")
        triples = list(JAX_DRAWS)
        keys = rnd.request_keys([s for s, _, _ in triples], dev)
        got = rnd.threefry_uniform_rows(
            keys, torch.tensor([st for _, st, _ in triples], dtype=torch.int32, device=dev),
            torch.tensor([r for _, _, r in triples], dtype=torch.int32, device=dev), 512)
        rows_known = {f"{s}/{st}/{r}": [b & 0xFFFFFFFF for b in bits_of(got[i, :4]).tolist()]
                      == JAX_DRAWS[(s, st, r)][1] for i, (s, st, r) in enumerate(triples)}
        log({"phase": "draws_rows", "cases": rows_cases, "jax_answers_equal": rows_known,
             "mutant_caught": rows_caught})
        if not all(rows_known.values()) or rows_caught != len(rows_cases):
            raise AssertionError(f"threefry_uniform_rows: jax {rows_known}, mutant caught "
                                 f"{rows_caught} of {len(rows_cases)}")
        # Timed at the loop's step: 32 rows over the 128,256-column head.
        B, V = 32, 128256
        g = np.random.default_rng(1)
        keys = rnd.request_keys(g.integers(0, 2 ** 32, B).tolist(), dev)
        steps_t = torch.tensor(g.integers(0, 97, B), dtype=torch.int32, device=dev)
        index_t = torch.tensor(g.integers(0, 8, B), dtype=torch.int32, device=dev)
        out_bytes = B * V * 4
        outs = []
        ms = time_ms(lambda: rnd.threefry_uniform_rows(keys, steps_t, index_t, V), iters=50)
        plain_ms = time_ms(lambda: rnd.threefry_uniform_rows_plain(keys, steps_t, index_t, V),
                           iters=3, warmup=1)
        dev_ms = device_ms([lambda: outs.append(rnd.threefry_uniform_rows(keys, steps_t, index_t, V))]
                           * copies_for(out_bytes))
        del outs
        b_ms, b_by = bound_ms(0.0, out_bytes + B * (2 * 8 + 4 + 4), PEAK_F32_FLOPS)
        log({"phase": "draws_rows_timing", "B": B, "V": V, "ms": ms, "plain_ms": plain_ms,
             "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
             "device_over_bound": dev_ms / b_ms})
        kernels["threefry_uniform_rows"] = {
            "name": "threefry_uniform_rows", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/threefry.cu",
            # No Pallas kernel draws in the JAX package: its draws are XLA's
            # threefry ops, keyed per row in the engine's decode loop and in
            # the continuous loop.
            "replaces": "k_llms_tpu/engine/engine.py:1508, k_llms_tpu/engine/continuous.py:721",
            "launches": None, "held": True, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": dev_ms, "device_over_bound": dev_ms / b_ms,
            "timed_case": f"B={B}, V={V}",
        }
        # The coalesced 8B step's shape, one request of n = 8 rows: the
        # per-row vectors built on the device for each call (what a
        # coalesced step pays), against the kernel on prebuilt vectors.
        R, n_per, V = 1, 8, 128256
        keys = rnd.request_keys([3000000000], dev)
        step_t = torch.tensor(5, dtype=torch.int32, device=dev)
        row_keys_t = keys.expand(n_per, 2).contiguous()
        steps_t = step_t.reshape(1).expand(n_per).contiguous()
        index_t = torch.arange(n_per, dtype=torch.int32, device=dev)
        out_bytes = R * n_per * V * 4
        outs = []
        coalesced_ms = time_ms(lambda: rnd.threefry_uniform(keys, step_t, n_per, V), iters=50)
        rows_ms = time_ms(lambda: rnd.threefry_uniform_rows(row_keys_t, steps_t, index_t, V),
                          iters=50)
        coalesced_dev_ms = device_ms(
            [lambda: outs.append(rnd.threefry_uniform(keys, step_t, n_per, V))]
            * copies_for(out_bytes))
        outs.clear()
        rows_dev_ms = device_ms(
            [lambda: outs.append(rnd.threefry_uniform_rows(row_keys_t, steps_t, index_t, V))]
            * copies_for(out_bytes))
        del outs
        b_ms, b_by = bound_ms(0.0, out_bytes + n_per * (8 + 4 + 4), PEAK_F32_FLOPS)
        log({"phase": "draws_timing", "B": R * n_per, "V": V, "coalesced_ms": coalesced_ms,
             "rows_ms": rows_ms, "coalesced_device_ms": coalesced_dev_ms,
             "rows_device_ms": rows_dev_ms, "bound_ms": b_ms, "bound_by": b_by})

    # 3b. The Levenshtein kernel of the device consensus against its plain
    # version (the JAX package's row scan in torch) and the native code.
    if "consensus" in phases:
        from k_llms_tpu_torch.native import levenshtein_distance
        from k_llms_tpu_torch.ops import levenshtein as lev

        def code_pairs(g, P, L):
            """P seeded ASCII pairs of lengths 0..L over a small alphabet,
            with empty strings and the bucket's edge lengths."""
            alpha = np.frombuffer(b"abcde01", np.uint8)
            a = np.zeros((P, L), np.int32)
            b = np.zeros((P, L), np.int32)
            alen = g.integers(0, L + 1, P).astype(np.int32)
            blen = g.integers(0, L + 1, P).astype(np.int32)
            alen[:6], blen[:6] = [0, L, 0, L, L - 1, 1], [0, 0, L, L, L, L - 1]
            for i in range(P):
                a[i, : alen[i]] = g.choice(alpha, alen[i])
                b[i, : blen[i]] = g.choice(alpha, blen[i])
            return a, alen, b, blen

        # Two mutants of the kernel's source, each built by nvcc beside the
        # real library: the insertion chain without its +1, and the result
        # read one row position early. The check below must catch both.
        src_path = os.path.join(_ext.CSRC_DIR, "levenshtein.cu")
        with open(src_path) as f:
            lev_src = f.read()
        edits = {
            "insertion_chain_off_by_one": ("v = min(v, left + 1);  // insertion chain",
                                           "v = min(v, left);  // insertion chain"),
            "wrong_result_column": ("out[p] = row[alen * kThreads];  // result column",
                                    "out[p] = row[(alen > 0 ? alen - 1 : 0) * kThreads];"),
        }
        os.makedirs(_ext.BUILD_DIR, exist_ok=True)
        procs = {}
        for name, (old, new) in edits.items():
            if old not in lev_src:
                raise AssertionError(f"levenshtein mutant {name}: source line not found")
            mpath = os.path.join(_ext.BUILD_DIR, f"mutant_levenshtein_{name}.cu")
            with open(mpath, "w") as f:
                f.write(lev_src.replace(old, new))
            lib_path = mpath[:-3] + ".so"
            procs[name] = (subprocess.Popen([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", lib_path, mpath],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib_path)
        mutant_libs = {}
        import ctypes
        for name, (proc, lib_path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"mutant {name} failed to build: {out.decode()[-2000:]}")
            mlib = ctypes.CDLL(lib_path)
            mlib.kllms_levenshtein.argtypes = _ext.KERNELS["levenshtein"][1]["kllms_levenshtein"]
            mlib.kllms_levenshtein.restype = ctypes.c_int
            mutant_libs[name] = mlib

        def run_mutant(mlib, t):
            out = torch.empty((t[0].shape[0],), dtype=torch.int32, device=dev)
            status = mlib.kllms_levenshtein(
                t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(), t[3].data_ptr(), out.data_ptr(),
                t[0].shape[0], t[0].shape[1], torch.cuda.current_stream().cuda_stream)
            _ext.check_status("levenshtein mutant", status)
            return out

        lev_cases, caught = [], {m: 0 for m in mutant_libs}
        g = np.random.default_rng(args.seed)
        for L in (8, 16, 32, 64, 128):
            for P in (64, 1024):
                host = code_pairs(g, P, L)
                t = [torch.as_tensor(x, device=dev) for x in host]
                got = lev.levenshtein(*t)
                plain = lev.levenshtein_plain(*t)
                a, alen, b, blen = host
                native = [levenshtein_distance(a[i, : alen[i]].astype(np.uint8).tobytes().decode(),
                                               b[i, : blen[i]].astype(np.uint8).tobytes().decode())
                          for i in range(P)]
                equal = bool(torch.equal(got, plain)) and got.tolist() == native
                for m, mlib in mutant_libs.items():
                    caught[m] += int(not torch.equal(run_mutant(mlib, t), plain))
                lev_cases.append({"L": L, "P": P, "equal": equal})
                if not equal:
                    raise AssertionError(f"levenshtein L={L} P={P} differs from its plain "
                                         "version or the native code")
        log({"phase": "consensus_levenshtein", "cases": lev_cases, "mutants_caught": caught})
        if min(caught.values()) != len(lev_cases):
            raise AssertionError(f"a levenshtein mutant kept equality: {caught}")
        # Timed at the widest launch: 1024 pairs in the 128 bucket. The
        # bound: the cells this data fills (sum of alen * blen), 5 integer
        # operations each, what the recurrence
        # min(diag + (a != b), min(up, left) + 1) needs (a compare, two adds,
        # two minimums), over the card's int32 rate; or the codes read once
        # and the distances written once over HBM.
        host = code_pairs(np.random.default_rng(7), 1024, 128)
        t = [torch.as_tensor(x, device=dev) for x in host]
        ms = time_ms(lambda: lev.levenshtein(*t), iters=20)
        plain_ms = time_ms(lambda: lev.levenshtein_plain(*t), iters=3, warmup=1)
        in_bytes = sum(x.nbytes for x in host)
        copies = [[x.clone() for x in t] for _ in range(copies_for(in_bytes))]
        dev_ms = device_ms([lambda c=c: lev.levenshtein(*c) for c in copies])
        del copies
        cells = int((host[1].astype(np.int64) * host[3].astype(np.int64)).sum())
        t_ops = LEV_OPS_PER_CELL * cells / PEAK_INT32_OPS * 1e3
        t_bytes = (in_bytes + 1024 * 4) / PEAK_BYTES * 1e3
        b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        log({"phase": "consensus_levenshtein_timing", "P": 1024, "L": 128, "cells": cells,
             "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms, "bound_ms": b_ms,
             "bound_by": b_by, "int32_ops_per_s": PEAK_INT32_OPS,
             "ops_per_cell": LEV_OPS_PER_CELL,
             "device_over_bound": dev_ms / b_ms})
        kernels["levenshtein"] = {
            "name": "levenshtein", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/levenshtein.cu",
            # No Pallas kernel: the JAX package's jitted lax.scan.
            "replaces": "k_llms_tpu/consensus/device.py:148",
            "launches": None, "held": True, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": dev_ms, "device_over_bound": dev_ms / b_ms,
            "timed_case": "P=1024, L=128",
        }

    # 4. K2 flash attention against its plain version
    if "k2" in phases:
        # Both compute in f32 and round the output once, so in bf16 they
        # differ by at most one ulp of the output (<= 2**-7 |ref|). The limit
        # is two ulps per element, |out - ref| <= 2**-6 |ref|, plus an
        # absolute floor for the f32 accumulation order; f32 outputs are held
        # at the floor alone. The mutants below show the limit's reach.
        limits = {torch.bfloat16: (2.0 ** -6, 1e-5), torch.float32: (0.0, 1e-5)}

        def over_limit(out, ref, dtype):
            """Largest |out - ref| / (rtol |ref| + atol) over the elements."""
            rtol, atol = limits[dtype]
            ref = ref.float()
            return ((out.float() - ref).abs() / (rtol * ref.abs() + atol)).max().item()

        def masked_attention(q, k, v, keep, scale=None, softcap=None):
            """f32 attention of q over k, v under a [B, 1, Sq, Sk] mask (every
            row keeps at least one key): the mutants' reference."""
            G = q.shape[1] // k.shape[1]
            sc = q.float() @ k.float().repeat_interleave(G, dim=1).transpose(2, 3)
            sc = sc * (scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
            if softcap is not None:
                sc = softcap * torch.tanh(sc / softcap)
            sc = torch.where(keep, sc, torch.full_like(sc, att.NEG_INF))
            return torch.softmax(sc, dim=-1) @ v.float().repeat_interleave(G, dim=1)

        def flex_library(B, Sq, Sk, kl, qo, window, softcap, scale):
            """PyTorch's flex_attention computing a softcapped case's function
            (the tanh on the scaled scores as its score_mod, the case's mask
            as a block mask), compiled: a yardstick only, the port never
            calls it."""
            from torch.nn.attention.flex_attention import create_block_mask, flex_attention

            lens = kl if kl is not None else torch.full((B,), Sk, dtype=torch.int32, device=dev)
            w = att.NO_WINDOW if window is None else window

            def mask_mod(b, h, qi, kv):
                pos = qi + qo
                return (kv <= pos) & (kv > pos - w) & (kv < lens[b])

            def score_mod(score, b, h, qi, kv):
                return softcap * torch.tanh(score / softcap)

            block_mask = create_block_mask(mask_mod, B, None, Sq, Sk, device=dev)
            compiled = torch.compile(flex_attention)
            return lambda q_, k_, v_: compiled(q_, k_, v_, score_mod=score_mod,
                                               block_mask=block_mask, scale=scale)

        def k2_case(name, B, QH, KVH, Sq, Sk, D, dtype, *, key_lengths=None,
                    q_offset=None, window=None, softcap=None, timed=False, sm_scale=None,
                    variants=None):
            """One K2 case against its plain version. ``variants`` maps a
            mutant's name to keyword changes of the plain version (the
            softcap dropped, the other layer kind's window) that the limit
            must catch."""
            q = randn(B, QH, Sq, D, dtype=dtype)
            k = randn(B, KVH, Sk, D, dtype=dtype)
            v = randn(B, KVH, Sk, D, dtype=dtype)
            kl = None if key_lengths is None else torch.tensor(key_lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=True, key_lengths=kl, softcap=softcap, window=window, q_offset=q_offset,
                      sm_scale=sm_scale)
            out = att.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = att.flash_attention_plain(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ratio = over_limit(out, ref, dtype)
            ok = bool(torch.isfinite(out).all().item()) and ratio <= 1.0
            rtol, atol = limits[dtype]
            rec = {"phase": "k2", "case": name, "shape": [B, QH, KVH, Sq, Sk, D],
                   "dtype": str(dtype).replace("torch.", ""), "impl": att.flash_route(dtype, D),
                   "key_lengths": key_lengths, "window": window, "softcap": softcap, "max_abs_err": err,
                   "mean_abs_ref": ref.float().abs().mean().item(),
                   "limit": f"{rtol:g}*|ref| + {atol:g}", "max_err_over_limit": ratio, "ok": ok}
            qo = q_offset or 0
            lens = [Sk] * B if key_lengths is None else key_lengths
            valid = att._flash_valid(B, Sq, Sk, torch.full((B,), Sk, device=dev) if kl is None else kl,
                                     True, att.NO_WINDOW if window is None else window, qo, dev)
            if timed:
                rec["ms"] = time_ms(lambda: att.flash_attention(q, k, v, **kw))
                rec["plain_ms"] = time_ms(lambda: att.flash_attention_plain(q, k, v, **kw), iters=5)
                # Yardstick only (the port never calls it): PyTorch's fused
                # attention on the same inputs, kv heads expanded to QH.
                G = QH // KVH
                k_rep = k.repeat_interleave(G, dim=1)
                v_rep = v.repeat_interleave(G, dim=1)
                scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
                if ((key_lengths is None or min(key_lengths) == Sk) and qo == 0 and Sq == Sk
                        and window is None):
                    lib_kw = dict(is_causal=True, scale=scale)
                else:  # causal, window, q_offset and key lengths as one mask [B, 1, Sq, Sk]
                    lib_kw = dict(attn_mask=valid, scale=scale)

                def sdpa(q_, k_, v_):
                    return torch.nn.functional.scaled_dot_product_attention(q_, k_, v_, **lib_kw)

                library = sdpa
                rec["library_call"] = "scaled_dot_product_attention"
                if softcap is not None and "flex" not in phases:
                    # SDPA has no softcap; flex_attention's compile takes
                    # about 40 s of the smoke's clock: opt-in phase "flex".
                    rec["library_call"] = None
                    rec["library_note"] = "flex_attention is timed in the opt-in phase flex"
                    library = None
                elif softcap is not None:
                    # SDPA has no softcap: flex_attention with a tanh
                    # score_mod and the case's mask, compiled, where it builds.
                    rec["library_call"] = "flex_attention (tanh score_mod, block mask), compiled"
                    try:
                        library = flex_library(B, Sq, Sk, kl, qo, window, softcap, scale)
                        got = library(q, k_rep, v_rep)
                        torch.cuda.synchronize()
                        rec["library_max_abs_err"] = (got.float() - ref.float()).abs().max().item()
                    except Exception as e:  # noqa: BLE001 - recorded as the row's reason
                        rec["library_call"] = None
                        rec["library_note"] = f"flex_attention did not build: {type(e).__name__}: {e}"[:400]
                        library = None
                rec["library_ms"] = None if library is None else time_ms(
                    lambda: library(q, k_rep, v_rep))
                # Device time, cold: each call on its own q, k, v (and, for
                # SDPA, its own expanded k, v), a rotation past the L2.
                n_copies = copies_for((q.numel() + k.numel() + v.numel()) * q.element_size())
                sets = [(q, k, v)] + [(randn(*q.shape, dtype=dtype), randn(*k.shape, dtype=dtype),
                                       randn(*v.shape, dtype=dtype)) for _ in range(n_copies - 1)]
                rec["device_ms"] = device_ms(
                    [lambda s_=s_: att.flash_attention(*s_, **kw) for s_ in sets])
                rec["rotation"] = n_copies
                expanded = [(q_, k_.repeat_interleave(G, dim=1), v_.repeat_interleave(G, dim=1))
                            for q_, k_, v_ in sets]
                rec["library_device_ms"] = None if library is None else device_ms(
                    [lambda e_=e_: library(*e_) for e_ in expanded])
                del sets, expanded
                # What these inputs need: the valid (row, key) pairs (keys
                # inside the window only), and K/V up to each key length
                # read once.
                w = att.NO_WINDOW if window is None else window
                pairs = QH * sum(sum(max(0, min(r + qo + 1, n) - max(0, r + qo - w + 1))
                                     for r in range(Sq)) for n in lens)
                flops = 4.0 * D * pairs
                nbytes = (q.numel() + out.numel() + 2 * KVH * D * sum(lens)) * q.element_size()
                rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
            # The limit must catch a kernel that is wrong by one key or one
            # tile: each such variant of the plain version has to break it.
            mutants = {}
            if timed or qo:
                mutants["causal_edge_one_key_late"] = att.flash_attention_plain(
                    q, k, v, **dict(kw, q_offset=qo + 1))
            if timed or qo >= 64:
                # A block of 32 keys dropped: inside the cached prefix when
                # there is one, else mid-sequence.
                keep = valid.clone()
                lo = qo // 2 if qo else Sk // 2
                keep[..., lo: lo + 32] = False
                mutants["key_tile_dropped"] = masked_attention(q, k, v, keep, sm_scale,
                                                               softcap).to(dtype)
            if window is not None and Sq - 1 + qo >= window and qo - window < max(lens):
                # (Only where the window masks a key: a short prompt's window
                # does not, and the mutant would equal the reference.)
                mutants["window_edge_one_key_wider"] = att.flash_attention_plain(
                    q, k, v, **dict(kw, window=window + 1))
            for m, change in (variants or {}).items():
                mutants[m] = att.flash_attention_plain(q, k, v, **dict(kw, **change))
            if mutants:
                rec["mutant_err_over_limit"] = {m: over_limit(o, ref, dtype) for m, o in mutants.items()}
            log(rec)
            if not ok:
                raise AssertionError(f"flash_attention case {name}: error {ratio} x the limit")
            caught = [r > 1.0 for r in rec.get("mutant_err_over_limit", {}).values()]
            if not all(caught):
                raise AssertionError(f"flash_attention case {name}: the limit misses a mutant: {rec}")
            return rec, err

        S = 1500
        main_rec, e0 = k2_case("llama3_8b_prefill", 1, 32, 8, S, S, 128, torch.bfloat16,
                               key_lengths=[S], timed=True)
        errs = [e0]
        # What the main path gives K2 for the 1490-token prompt: its 2048
        # bucket with the key length (the padded query rows are computed
        # too), timed beside the 1500 case. Neither the key length 1490 nor
        # the q_offset cases' Sq (500, 1000) is a multiple of the query tile.
        bucket_rec, e1 = k2_case("llama3_8b_prefill_bucket", 1, 32, 8, 2048, 2048, 128,
                                 torch.bfloat16, key_lengths=[1490], timed=True)
        errs.append(e1)
        errs.append(k2_case("q_offset", 1, 32, 8, 500, S, 128, torch.bfloat16,
                            key_lengths=[S], q_offset=S - 500)[1])
        errs.append(k2_case("q_offset_1000", 1, 32, 8, 1000, S, 128, torch.bfloat16,
                            key_lengths=[S], q_offset=S - 1000)[1])
        # A prefix-cache continuation inside the model: a suffix bucket of
        # 32-128 rows (fewer than one 128-row query tile) at q_offset p over
        # the 2048-key continuation bucket, key length p plus the suffix's
        # valid rows, p a multiple of the tile or not. The timed case is the
        # ckpt phase's partial hit (its suffix bucket of 128 rows at p =
        # 1400, 1490 keys).
        cont_rec, e_c = k2_case("continuation_sq128_p1400", 1, 32, 8, 128, 2048, 128,
                                torch.bfloat16, key_lengths=[1490], q_offset=1400, timed=True)
        errs.append(e_c)
        for sq in (32, 64, 128):
            for p0 in (1408, 1401):
                errs.append(k2_case(f"continuation_sq{sq}_p{p0}", 1, 32, 8, sq, 2048, 128,
                                    torch.bfloat16, key_lengths=[p0 + sq - 7], q_offset=p0)[1])
        errs.append(k2_case("window", 1, 32, 8, S, S, 128, torch.bfloat16,
                            key_lengths=[S], window=256)[1])
        errs.append(k2_case("softcap", 1, 32, 8, S, S, 128, torch.bfloat16,
                            key_lengths=[S], softcap=50.0)[1])
        # The embeddings forward: 8 strings bucket-padded to 512 tokens, the
        # batch padded to 8 with empty rows.
        errs.append(k2_case("embeddings_encode", 8, 32, 8, 512, 512, 128, torch.bfloat16,
                            key_lengths=[512, 431, 300, 77, 1, 0, 0, 0])[1])
        errs.append(k2_case("head_dim_256", 1, 8, 4, 700, 700, 256, torch.bfloat16)[1])
        errs.append(k2_case("head_dim_64", 2, 14, 2, 1000, 1000, 64, torch.bfloat16,
                            key_lengths=[1000, 377], window=200, softcap=30.0)[1])
        errs.append(k2_case("head_dim_16_simt", 1, 4, 2, 77, 77, 16, torch.bfloat16,
                            key_lengths=[70])[1])
        errs.append(k2_case("all_masked_row", 2, 32, 8, 300, 300, 128, torch.bfloat16,
                            key_lengths=[300, 0])[1])
        errs.append(k2_case("tiny_f32", 1, 4, 2, 77, 77, 16, torch.float32,
                            key_lengths=[70])[1])
        errs.append(k2_case("head_dim_64_f32", 2, 14, 2, 100, 100, 64, torch.float32,
                            key_lengths=[100, 37])[1])
        # The family phases' prefill shapes (a 4608-token prompt, longer than
        # the 4096-key window): Gemma-2-9B's local (even) layers with softcap
        # and window, its global layers with the softcap alone, Mistral-7B's
        # windowed layers. Mutants: the softcap dropped, the other layer
        # kind's window (the wrong layer parity).
        gemma_scale = 256.0 ** -0.5
        family_recs = {}
        family_recs["gemma2_9b_local"], e = k2_case(
            "gemma2_9b_local_prefill", 1, 16, 8, 4608, 4608, 256, torch.bfloat16,
            key_lengths=[4608], softcap=50.0, window=4096, sm_scale=gemma_scale, timed=True,
            variants={"softcap_dropped": dict(softcap=None), "wrong_layer_parity": dict(window=None)})
        errs.append(e)
        family_recs["gemma2_9b_global"], e = k2_case(
            "gemma2_9b_global_prefill", 1, 16, 8, 4608, 4608, 256, torch.bfloat16,
            key_lengths=[4608], softcap=50.0, sm_scale=gemma_scale, timed=True,
            variants={"softcap_dropped": dict(softcap=None),
                      "wrong_layer_parity": dict(window=4096)})
        errs.append(e)
        family_recs["mistral_7b"], e = k2_case(
            "mistral_7b_prefill", 1, 32, 8, 4608, 4608, 128, torch.bfloat16,
            key_lengths=[4608], window=4096, timed=True,
            variants={"wrong_layer_parity": dict(window=None)})
        errs.append(e)
        # What the family phases' model path gives K2: the 4600-token
        # prompt padded to its 8192 bucket with the key length (the padded
        # query rows are computed too), timed for PERF.md; the short
        # prompts' 64 and 128 buckets; the embeddings forward's 8 x 64
        # bucket with ragged key lengths. Mixtral's prefill shapes are the
        # 8B ones (llama3_8b_prefill_bucket; the short prompts' 64 bucket
        # below, where Mistral's window masks no key).
        family_len = 4600
        gemma_local = dict(softcap=50.0, window=4096, sm_scale=gemma_scale)
        gemma_global = dict(softcap=50.0, sm_scale=gemma_scale)
        family_recs["gemma2_9b_local_bucket"], e = k2_case(
            "gemma2_9b_local_prefill_bucket", 1, 16, 8, 8192, 8192, 256, torch.bfloat16,
            key_lengths=[family_len], timed=True, **gemma_local,
            variants={"softcap_dropped": dict(softcap=None), "wrong_layer_parity": dict(window=None)})
        errs.append(e)
        family_recs["gemma2_9b_global_bucket"], e = k2_case(
            "gemma2_9b_global_prefill_bucket", 1, 16, 8, 8192, 8192, 256, torch.bfloat16,
            key_lengths=[family_len], timed=True, **gemma_global,
            variants={"softcap_dropped": dict(softcap=None),
                      "wrong_layer_parity": dict(window=4096)})
        errs.append(e)
        family_recs["mistral_7b_bucket"], e = k2_case(
            "mistral_7b_prefill_bucket", 1, 32, 8, 8192, 8192, 128, torch.bfloat16,
            key_lengths=[family_len], window=4096, timed=True,
            variants={"wrong_layer_parity": dict(window=None)})
        errs.append(e)
        for bucket, n_keys in ((64, 46), (128, 86)):
            errs.append(k2_case(f"gemma2_9b_short_prompt_{bucket}", 1, 16, 8, bucket, bucket, 256,
                                torch.bfloat16, key_lengths=[n_keys], **gemma_local,
                                variants={"softcap_dropped": dict(softcap=None)})[1])
        errs.append(k2_case("mistral_mixtral_short_prompt_64", 1, 32, 8, 64, 64, 128,
                            torch.bfloat16, key_lengths=[46], window=4096)[1])
        ragged = [64, 58, 41, 64, 23, 64, 7, 1]
        for layers, extra in (("local", gemma_local), ("global", gemma_global)):
            errs.append(k2_case(f"gemma2_9b_embeddings_{layers}", 8, 16, 8, 64, 64, 256,
                                torch.bfloat16, key_lengths=ragged, **extra,
                                variants={"softcap_dropped": dict(softcap=None)})[1])
        errs.append(k2_case("mistral_mixtral_embeddings", 8, 32, 8, 64, 64, 128, torch.bfloat16,
                            key_lengths=ragged, window=4096)[1])
        kernels["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/flash_attention.cu",
            "replaces": "k_llms_tpu/ops/attention.py:57",
            "launches": None, "held": True, "max_abs_err": max(errs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"], "impl": main_rec["impl"],
            "device_ms": main_rec["device_ms"], "library_device_ms": main_rec["library_device_ms"],
            "device_over_bound": main_rec["device_over_bound"],
            "timed_case": main_rec["case"],
            "bucket_case": {k: bucket_rec[k] for k in
                            ("case", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                             "library_ms", "library_device_ms", "device_over_bound")},
            "continuation_case": {k: cont_rec[k] for k in
                                  ("case", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_device_ms", "device_over_bound")},
            "family_cases": {k: {f: r.get(f) for f in
                                 ("case", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                  "library_call", "library_ms", "library_device_ms",
                                  "library_note", "device_over_bound")}
                             for k, r in family_recs.items()},
        }

    if sass_future is not None:
        log(sass_future.result())

    # 5. K1 paged decode against its plain version
    if "k1" in phases:
        def k1_case(name, R, n_per, QH, KVH, D, ps, plens, glen, dtype, tol, *,
                    phase_on=True, shared=True, bucket=None, timed=False, bad_page=False):
            B = R * n_per
            NP = -(-(bucket or max(plens)) // ps)
            max_new = glen + 24
            NG = -(-max_new // ps) + 1
            total = 1 + R * NP + B * NG
            pool_k = randn(total * ps, KVH, D, dtype=dtype)
            pool_v = randn(total * ps, KVH, D, dtype=dtype)
            perm = torch.randperm(total - 1, generator=gen, device=dev).to(torch.int32) + 1
            prefix = perm[: R * NP].reshape(R, NP).clone()
            for r, p in enumerate(plens):  # table tail past the prompt -> trash page
                prefix[r, -(-p // ps):] = 0
            gen_pages = perm[R * NP: R * NP + B * NG].reshape(B, NG).contiguous()
            if not shared:
                prefix = prefix.repeat_interleave(n_per, dim=0).contiguous()
            plen_row = torch.tensor(plens, dtype=torch.int32, device=dev).repeat_interleave(n_per)
            phase = (plen_row % ps) if phase_on else torch.zeros_like(plen_row)
            glens = torch.full((B,), glen, dtype=torch.int32, device=dev)
            q = randn(B, QH, D, dtype=dtype)
            nk = randn(B, KVH, D, dtype=dtype)
            nv = randn(B, KVH, D, dtype=dtype)
            args_ = (q, pool_k, pool_v, prefix, gen_pages, phase, nk, nv, plen_row, glens)
            kw = dict(page_size=ps, sm_scale=1.0 / math.sqrt(D))
            out = pa.paged_decode_attention(*args_, **kw)
            torch.cuda.synchronize()
            ref = pa.paged_decode_attention_plain(*args_, **kw)
            err = (out - ref).abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) and err <= tol
            rec = {"phase": "k1", "case": name, "R": R, "n_per": n_per, "heads": [QH, KVH, D],
                   "page_size": ps, "plens": plens, "gen_len": glen, "shared_table": shared,
                   "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol, "ok": ok}
            if timed:
                rec["ms"] = time_ms(lambda: pa.paged_decode_attention(*args_, **kw), iters=50)
                rec["plain_ms"] = time_ms(lambda: pa.paged_decode_attention_plain(*args_, **kw), iters=10)
                rec["library_ms"] = None
                # Device time, cold: each call on its own pair of pools.
                n_copies = copies_for(2 * pool_k.numel() * pool_k.element_size())
                pools = [(pool_k, pool_v)] + [(randn(*pool_k.shape, dtype=dtype), randn(*pool_v.shape, dtype=dtype))
                                              for _ in range(n_copies - 1)]
                calls = [lambda pk=pk, pv=pv: pa.paged_decode_attention(
                    q, pk, pv, prefix, gen_pages, phase, nk, nv, plen_row, glens, **kw) for pk, pv in pools]
                rec["device_ms"] = device_ms(calls)
                rec["rotation"] = n_copies
                del pools, calls
                esz = pool_k.element_size()
                keys_per_row = [p + glen for p in plens for _ in range(n_per)]
                flops = 4.0 * D * (QH // KVH) * KVH * (sum(keys_per_row) + B)
                # Each input byte once: every request's prompt KV once, each
                # row's generated KV, q, the fresh columns; the f32 output.
                kv_tokens = sum(plens) + B * glen
                nbytes = (2 * kv_tokens * KVH * D + q.numel() + nk.numel() + nv.numel()) * esz \
                    + out.numel() * 4
                rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
                route, rpc, splits = pa.paged_split_plan(B, prefix.shape[0], QH, KVH, D,
                                                          prefix.shape[1], dtype)
                rec["plan"] = {"route": route, "rows_per_cta": rpc, "splits": splits,
                               "ctas": prefix.shape[0] * -(-n_per // rpc) * KVH * (splits + rpc)}
                # The limit must catch a split that is dropped from the merge
                # or whose boundary is one page off: variants of the kernel's
                # decomposition, each of which has to break it.
                def dropped(n, k):
                    ranges = pa.split_page_ranges(n, k)
                    return [rg for i, rg in enumerate(ranges) if i != len(ranges) // 2]

                def off_by_one(n, k):
                    ranges = pa.split_page_ranges(n, k)
                    i = next(i for i in range(len(ranges) - 1) if ranges[i][1] - ranges[i][0] > 1)
                    ranges[i] = (ranges[i][0], ranges[i][1] - 1)
                    return ranges

                model = pa.paged_decode_attention_split(*args_, **kw)
                rec["split_model_max_abs_err"] = (model - ref).abs().max().item()
                ok = ok and rec["split_model_max_abs_err"] <= tol
                rec["mutant_err_over_limit"] = {
                    name: (pa.paged_decode_attention_split(*args_, **kw, page_ranges=f) - ref)
                    .abs().max().item() / tol
                    for name, f in (("merge_drops_one_split", dropped),
                                    ("split_boundary_one_page_off", off_by_one))}
            if bad_page:
                # A gen page id past the pool's end in row 1: the kernel reads
                # nothing there and poisons that row alone with NaN. (The plain
                # version is not run on this table: it would index past the
                # pool.)
                bad = gen_pages.clone()
                bad[1, 0] = total + 5
                out_bad = pa.paged_decode_attention(q, pool_k, pool_v, prefix, bad, phase, nk, nv,
                                                    plen_row, glens, **kw)
                others = torch.arange(B, device=dev) != 1
                rec["bad_page_row_all_nan"] = bool(torch.isnan(out_bad[1]).all().item())
                rec["other_rows_max_abs_err"] = (out_bad[others] - ref[others]).abs().max().item()
                ok = ok and rec["bad_page_row_all_nan"] and rec["other_rows_max_abs_err"] <= tol
            log(rec)
            if not ok:
                raise AssertionError(f"paged_decode_attention case {name} failed: {rec}")
            if not all(r > 1.0 for r in rec.get("mutant_err_over_limit", {}).values()):
                raise AssertionError(f"paged_decode_attention case {name}: the limit misses a mutant: {rec}")
            return rec, err

        main_rec, e0 = k1_case("llama3_8b_decode", 2, 8, 32, 8, 128, 64, [1500, 1437], 40,
                               torch.bfloat16, 1e-5, bucket=2048, timed=True)
        # The main path's own shape: one request of n = 8 rows, the 1490-token
        # prompt in its 2048 bucket, 16 tokens generated.
        shape_rec, e1 = k1_case("llama3_8b_main_shape", 1, 8, 32, 8, 128, 64, [1490], 16,
                                torch.bfloat16, 1e-5, bucket=2048, timed=True, bad_page=True)
        errs = [e0, e1]
        errs.append(k1_case("per_row_table_phase0", 2, 8, 32, 8, 128, 64, [1500, 1437], 40,
                            torch.bfloat16, 1e-5, phase_on=False, shared=False)[1])
        errs.append(k1_case("tiny_f32_ps16", 3, 4, 4, 2, 16, 16, [45, 20, 33], 11,
                            torch.float32, 1e-5, bad_page=True)[1])
        errs.append(k1_case("head_dim_256_ps8", 1, 4, 8, 4, 256, 8, [29], 5,
                            torch.bfloat16, 1e-5)[1])
        kernels["paged_decode_attention"] = {
            "name": "paged_decode_attention", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/paged_decode.cu",
            "replaces": "k_llms_tpu/ops/paged_attention.py:251",
            "launches": None, "held": True, "max_abs_err": max(errs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": None, "device_ms": main_rec["device_ms"],
            "device_over_bound": main_rec["device_over_bound"], "impl": main_rec["plan"]["route"],
            "timed_case": main_rec["case"],
            "main_shape_case": {k: shape_rec[k] for k in
                                ("case", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                 "device_over_bound", "plan")},
        }

    # 6. K4 w4a16 matmul against its plain version
    if "k4" in phases:
        from k_llms_tpu_torch.ops import w4matmul as w4

        # The ragged column edge's mutant of K4's source, built by nvcc in
        # the background while the cases below run: every route's store
        # mask one 16-column chunk short, so the last valid columns of a
        # ragged last tile are never written.
        with open(os.path.join(_ext.CSRC_DIR, "w4_matmul.cu")) as f:
            k4_src = f.read()
        edge_old = "if (col >= N) continue;"
        if k4_src.count(edge_old) != 3:
            raise AssertionError(f"k4 edge mutant: {k4_src.count(edge_old)} masked stores, not 3")
        os.makedirs(_ext.BUILD_DIR, exist_ok=True)
        edge_path = os.path.join(_ext.BUILD_DIR, "mutant_w4_matmul_edge.cu")
        with open(edge_path, "w") as f:
            f.write(k4_src.replace(edge_old, "if (col + 16 >= N) continue;"))
        edge_build = subprocess.Popen(
            [_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-I", _ext.CSRC_DIR, "-o", edge_path[:-3] + ".so",
             edge_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        def group_sums(x, w, *, scale=None, swap_halves=False, absolute=False):
            """Plain w4 arithmetic with knobs for the limit and the mutants:
            sum_g (x_g . ints_g) * scale_g, optionally on |x| and |ints| (the
            scale of the f32 summation error) or with the nibble halves
            swapped."""
            scale = w.scale if scale is None else scale
            x32 = x.float().abs() if absolute else x.float()
            acc = torch.zeros((x.shape[0], w.q.shape[1]), dtype=torch.float32, device=dev)
            for g in range(x.shape[1] // w4.GROUP):
                ints = w4._unpack_ints(w.q[g * 64: (g + 1) * 64])[0].float()
                if swap_halves:
                    ints = torch.cat([ints[64:], ints[:64]])
                if absolute:
                    ints = ints.abs()
                acc += (x32[:, g * 128: (g + 1) * 128] @ ints) * scale[g]
            return acc

        def k4_case(name, rows, K, N, dtype, *, timed=False, mutants=False):
            # Random packed bytes (every nibble value, -8 included, as the
            # random int4 init makes them) and per-group scales around the
            # init's 1 / (4.61 sqrt(K)).
            q = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8)
            scale = (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5) / (4.61 * math.sqrt(K))
            w = w4.Q4Tensor(q, scale)
            x = randn(rows, K, dtype=dtype)
            out = w4.w4_matmul(x, w)
            torch.cuda.synchronize()
            ref = w4.w4_matmul_plain(x, w)
            # f32 sums taken in another order differ by far less than 1e-5 of
            # the sum of |terms| (|x| @ |W|); a bf16 output adds its rounding,
            # at most two ulps of |ref|.
            rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 0.0
            abs_terms = group_sums(x, w, absolute=True)

            def over(o):
                return ((o.float() - ref.float()).abs()
                        / (rtol * ref.float().abs() + 1e-5 * abs_terms + 1e-30)).max().item()

            err = (out.float() - ref.float()).abs().max().item()
            ratio = over(out)
            ok = bool(torch.isfinite(out).all().item()) and ratio <= 1.0 and out.dtype == dtype
            route = w4.w4_route(rows, K, N, dtype)
            rec = {"phase": "k4", "case": name, "rows": rows, "K": K, "N": N,
                   "dtype": str(dtype).replace("torch.", ""), "route": route,
                   "impl": "simt" if route in ("gemv", "tiled") else "tc",
                   "ksplit": w4.split_k(rows, K, N, dtype), "max_abs_err": err,
                   "mean_abs_ref": ref.float().abs().mean().item(),
                   "limit": f"{rtol:g}*|ref| + 1e-5*(|x| @ |W|)", "max_err_over_limit": ratio,
                   "ok": ok}
            if mutants:
                dropped = scale.clone()
                dropped[0] = 0.0
                rec["mutant_err_over_limit"] = {
                    "one_group_scale_dropped": over(group_sums(x, w, scale=dropped).to(dtype)),
                    "nibble_halves_swapped": over(group_sums(x, w, swap_halves=True).to(dtype)),
                }
            if timed:
                rec["ms"] = time_ms(lambda: w4.w4_matmul(x, w), iters=20)
                rec["plain_ms"] = time_ms(lambda: w4.w4_matmul_plain(x, w), iters=3, warmup=1)
                # Yardstick only (the port never calls it): cuBLAS on bf16
                # activations and a bf16 copy of the dequantized weight.
                w_bf16 = w4.unpack_int4(w).to(torch.bfloat16)
                x_bf16 = x.to(torch.bfloat16)
                rec["library_ms"] = time_ms(lambda: torch.matmul(x_bf16, w_bf16), iters=20)
                del w_bf16
                flops = 2.0 * rows * K * N
                nbytes = (x.numel() * x.element_size() + q.numel() + scale.numel() * 4
                          + out.numel() * out.element_size())
                peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, peak)
                if dtype == torch.bfloat16 and rows <= w4._DECODE_MAX_ROWS:
                    # Decode rows: every bf16 route that takes them, each held
                    # to the same limit, and each route's device time on cold
                    # weights (a rotation of copies), beside cuBLAS's on cold
                    # bf16 weights.
                    others = [r for r in ("decode", "tc") if r != route]
                    rec["other_route_err_over_limit"] = {}
                    for other in others:
                        o = w4.w4_matmul(x, w, route=other)
                        torch.cuda.synchronize()
                        rec["other_route_err_over_limit"][other] = over(o)
                    ok = rec["ok"] = ok and max(rec["other_route_err_over_limit"].values()) <= 1.0
                    cold = rotations(K, N)
                    rec["route_device_ms"] = {
                        r: device_ms([lambda wc=wc, r=r: w4.w4_matmul(x, wc, route=r)
                                      for wc in cold["w4"]])
                        for r in (route, *others)}
                    rec["device_ms"] = rec["route_device_ms"][route]
                    rec["library_device_ms"] = device_ms(
                        [lambda wb=wb: torch.matmul(x_bf16, wb) for wb in cold["bf16"]])
                    rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
                    rec["rotation"] = {k: len(v) for k, v in cold.items()}
                elif dtype == torch.bfloat16 and rows == 2048:
                    # The long prefill's row count: the kernel's and cuBLAS's
                    # device time on cold weights, as at decode rows.
                    cold = rotations(K, N)
                    rec["device_ms"] = device_ms([lambda wc=wc: w4.w4_matmul(x, wc)
                                                  for wc in cold["w4"]])
                    rec["library_device_ms"] = device_ms(
                        [lambda wb=wb: torch.matmul(x_bf16, wb) for wb in cold["bf16"]])
                    rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
                    rec["rotation"] = {k: len(v) for k, v in cold.items()}
            log(rec)
            if not ok:
                raise AssertionError(f"w4_matmul case {name}: error {ratio} x the limit")
            if not all(r > 1.0 for r in rec.get("mutant_err_over_limit", {}).values()):
                raise AssertionError(f"w4_matmul case {name}: the limit misses a mutant: {rec}")
            return rec, err

        # The Llama-3-8B weights at every row count the main path gives
        # them: last-token logits (1), the warm-up's and decode at n=2 and
        # n=8 (2, 8), the short prompts' 64-token prefill bucket (64), the
        # embeddings forward of 8 samples x 64 tokens (512) and the long
        # prompt's 2048-token bucket; 4, 16 and 32 rows place the crossover
        # between the GEMV and the tensor-core routes. Both mutants run at
        # 8 and 64 rows and on both sides of the crossover.
        shapes = {"w_gate_up": (4096, 14336), "w_down": (14336, 4096), "wq_wo": (4096, 4096),
                  "wk_wv": (4096, 1024), "lm_head": (4096, 128256)}
        cold_copies = {}

        def rotations(K, N):
            """Copies of a K x N weight, packed int4 and bf16, enough of each
            that a pass over them exceeds the L2 (made once per shape; their
            values do not matter to the time)."""
            if (K, N) not in cold_copies:
                cold_copies.clear()
                n4 = copies_for(K * N // 2 + K // 128 * N * 4)
                nb = copies_for(K * N * 2)
                cold_copies[(K, N)] = {
                    "w4": [w4.Q4Tensor(
                        torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8),
                        (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5) / (4.61 * math.sqrt(K)))
                        for _ in range(n4)],
                    "bf16": [randn(K, N, scale=0.02) for _ in range(nb)],
                }
            return cold_copies[(K, N)]

        cross = w4.TC_CROSSOVER_ROWS
        mutant_rows = {8, 64, max(cross, 1), cross + 1}
        timed_rows = (1, 2, 4, 8, 16, 32, 64, 512, 2048)
        recs, errs = {}, []
        for sname, (K, N) in shapes.items():
            for rows in timed_rows:
                rec, e = k4_case(f"{sname}_rows{rows}", rows, K, N, torch.bfloat16, timed=True,
                                 mutants=rows in mutant_rows)
                recs[(sname, rows)] = rec
                errs.append(e)
        # Row counts whose last 64- or 128-row tile is ragged, on a weight
        # split over CTAs (wk_wv) and one that is not (w_gate_up), and the
        # crossover's rows that are not timed above.
        for sname in ("w_gate_up", "wk_wv"):
            for rows in sorted({17, 33, 65, 127, 128, 129} | (mutant_rows - set(timed_rows))):
                errs.append(k4_case(f"{sname}_rows{rows}", rows, *shapes[sname], torch.bfloat16,
                                    mutants=rows in mutant_rows or rows == 129)[1])
        errs.append(k4_case("f32_rows40", 40, 1024, 768, torch.float32, mutants=True)[1])
        errs.append(k4_case("f32_rows300", 300, 512, 384, torch.float32, mutants=True)[1])
        # Mixtral-8x7B's int4 head (N = 32000; its attention matmuls have
        # the 8B shapes above): each prefill's last token (1 row), decode at
        # n = 8, and 64 and 2048 rows on the tensor-core route at its width.
        mixtral_head = {}
        for rows in (1, 8, 64, 2048):
            mixtral_head[rows], e = k4_case(f"mixtral_lm_head_rows{rows}", rows, 4096, 32000,
                                            torch.bfloat16, timed=True, mutants=rows in (8, 64))
            errs.append(e)
        # Llama-3-8B's lm_head shards at TP = 4 and 8 end inside K4's last
        # column tile ([4096, 32064] is 64 columns into its 251st, [4096,
        # 16032] 32 into its 126th): the masked tile on the decode route (8
        # rows; at N = 16032 split over two CTAs, so the last CTA's sum is
        # masked too) and the tensor-core route (2048 rows), held to K4's
        # limit and timed; then the edge mutant on the same inputs, its
        # output pre-filled with NaN, must miss the limit.
        ragged = {}
        for tp, (K, N) in ((4, (4096, 32064)), (8, (4096, 16032))):
            for rows in (8, 2048):
                ragged[(tp, rows)], e = k4_case(f"lm_head_tp{tp}_rows{rows}", rows, K, N,
                                                torch.bfloat16, timed=True, mutants=True)
                errs.append(e)
        out_b, _ = edge_build.communicate()
        if edge_build.returncode != 0:
            raise AssertionError(f"k4 edge mutant failed to build: {out_b.decode()[-2000:]}")
        import ctypes
        edge_lib = ctypes.CDLL(edge_path[:-3] + ".so")
        edge_lib.kllms_w4_matmul.argtypes = _ext.KERNELS["w4_matmul"][1]["kllms_w4_matmul"]
        edge_lib.kllms_w4_matmul.restype = ctypes.c_int
        edge_cases = []
        for tp, (K, N) in ((4, (4096, 32064)), (8, (4096, 16032))):
            for rows in (8, 2048):
                q = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8)
                scale = (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5) / (4.61 * math.sqrt(K))
                w = w4.Q4Tensor(q, scale)
                x = randn(rows, K)
                route = w4.w4_route(rows, K, N, torch.bfloat16)
                ksplit = w4.split_k(rows, K, N)
                out = torch.full((rows, N), float("nan"), dtype=torch.bfloat16, device=dev)
                partial = torch.empty((ksplit, rows, N), dtype=torch.float32, device=dev)
                sem = torch.zeros((-(-N // 128),), dtype=torch.int32, device=dev)
                status = edge_lib.kllms_w4_matmul(
                    x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), partial.data_ptr(),
                    sem.data_ptr(), rows, K, N, 1, w4.ROUTES[route], ksplit,
                    torch.cuda.current_stream().cuda_stream)
                _ext.check_status("w4_matmul edge mutant", status)
                torch.cuda.synchronize()
                ref = w4.w4_matmul_plain(x, w).float()
                room = 2.0 ** -6 * ref.abs() + 1e-5 * group_sums(x, w, absolute=True)
                real = w4.w4_matmul(x, w).float()
                torch.cuda.synchronize()
                edge_cases.append({
                    "tp": tp, "rows": rows, "N": N, "route": route, "ksplit": ksplit,
                    "kernel_within_limit": bool(((real - ref).abs() <= room).all().item()),
                    "mutant_caught": not bool(((out.float() - ref).abs() <= room).all().item()),
                    "mutant_columns_unwritten": int(torch.isnan(out.float()).any(0).sum().item())})
                del q, scale, w, x, out, partial
        log({"phase": "k4_ragged_edge_mutant", "cases": edge_cases})
        if not all(c["kernel_within_limit"] and c["mutant_caught"] for c in edge_cases):
            raise AssertionError(f"k4 ragged edge: {edge_cases}")
        cold_copies.clear()
        # Crossover, in device time on cold weights: the largest row count at
        # which the decode route is faster than the prefill tensor-core route
        # over one layer's seven block matmuls, and for lm_head alone.
        layer = {"w_gate_up": 2, "w_down": 1, "wq_wo": 2, "wk_wv": 2}
        per_rows, head_rows = {}, {}
        for rows in (1, 2, 4, 8, 16, 32):
            per_rows[rows] = {r: sum(c * recs[(sn, rows)]["route_device_ms"][r] for sn, c in layer.items())
                              for r in ("decode", "tc")}
            per_rows[rows]["cublas"] = sum(c * recs[(sn, rows)]["library_device_ms"] for sn, c in layer.items())
            head_rows[rows] = dict(recs[("lm_head", rows)]["route_device_ms"],
                                   cublas=recs[("lm_head", rows)]["library_device_ms"])
        measured = max([r for r, t in per_rows.items() if t["decode"] < t["tc"]], default=0)
        log({"phase": "k4_crossover", "layer_device_ms_by_rows": per_rows,
             "lm_head_device_ms_by_rows": head_rows,
             "crossover_rows_measured": measured, "crossover_rows_in_code": cross})
        main_rec = recs[("w_gate_up", 8)]
        kernels["w4_matmul"] = {
            "name": "w4_matmul", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "k_llms_tpu/ops/w4matmul.py:136",
            "launches": None, "held": True, "max_abs_err": max(errs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"], "timed_case": "w_gate_up_rows8",
            "impl": main_rec["impl"], "device_ms": main_rec["device_ms"],
            "library_device_ms": main_rec["library_device_ms"],
            "device_over_bound": main_rec["device_over_bound"],
            "decode_cases": [{k: recs[(sn, rows)][k] for k in
                              ("case", "impl", "ms", "device_ms", "library_device_ms", "bound_ms",
                               "device_over_bound")}
                             for sn in shapes for rows in (1, 8)],
            "prefill_cases": [{k: recs[(sn, rows)].get(k) for k in
                               ("case", "impl", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "library_device_ms")}
                              for sn in ("w_gate_up", "w_down") for rows in (64, 2048)],
            "mixtral_head_cases": [{k: r.get(k) for k in
                                    ("case", "impl", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "device_ms", "library_device_ms",
                                     "device_over_bound")}
                                   for r in mixtral_head.values()],
            "ragged_shard_cases": [{k: r.get(k) for k in
                                    ("case", "impl", "route", "ksplit", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "device_ms", "library_device_ms",
                                     "device_over_bound", "max_err_over_limit")}
                                   for r in ragged.values()],
            "ragged_edge_mutant": edge_cases,
        }

    # 7. K3 decode-prefix attention against its plain version
    if "k3" in phases:
        # Both compute in f32 from the same inputs and differ only in the
        # order of their sums (and, on the tensor cores, in P carried as two
        # bf16 pieces, 2**-17 of itself): out, m and l are each held per
        # element at 2e-5 |ref| + 2e-5 (the JAX test's bound, made relative
        # for l, which grows with the key count).
        def k3_over(o, r):
            return ((o - r).abs() / (2e-5 * r.abs() + 2e-5)).max().item()

        def k3_over3(got, ref):
            return max(k3_over(o, r) for o, r in zip(got, ref))

        def dropped_split(n, k):
            ranges = att.split_key_blocks(n, k)
            return [rg for i, rg in enumerate(ranges) if i != len(ranges) // 2]

        def boundary_one_block_off(n, k):
            ranges = att.split_key_blocks(n, k)
            i = next((i for i in range(len(ranges) - 1) if ranges[i][1] - ranges[i][0] > 1), None)
            if i is not None:
                ranges[i] = (ranges[i][0], ranges[i][1] - 1)
            return ranges

        def k3_case(name, R, n_per, QH, KVH, D, P, plens, dtype, *, timed=False, mutants=True):
            B = R * n_per
            q = randn(B, QH, D, dtype=dtype)
            pk = randn(R, P, KVH, D, dtype=dtype)
            pv = randn(R, P, KVH, D, dtype=dtype)
            lens = torch.tensor(plens, dtype=torch.int32, device=dev)
            sc = 1.0 / math.sqrt(D)
            got = att.decode_prefix_attention(q, pk, pv, lens, sm_scale=sc)
            torch.cuda.synchronize()
            ref = att.decode_prefix_attention_plain(q, pk, pv, lens, sm_scale=sc)
            ratios = {k: k3_over(o, r) for k, o, r in zip(("out", "m", "l"), got, ref)}
            err = max((o - r).abs().max().item() for o, r in zip(got, ref))
            ok = all(bool(torch.isfinite(o).all().item()) for o in got) and max(ratios.values()) <= 1.0
            route, tiles, splits = att.decode_prefix_split_plan(B, R, QH, KVH, D, P, dtype)
            rec = {"phase": "k3", "case": name, "R": R, "n_per": n_per, "heads": [QH, KVH, D],
                   "P": P, "plens": plens, "dtype": str(dtype).replace("torch.", ""),
                   "impl": route, "plan": {"tiles": tiles, "splits": splits,
                                           "ctas": R * tiles * KVH * splits},
                   "max_abs_err": err, "err_over_limit": ratios, "ok": ok}
            if mutants:
                # One key past the prompt admitted; the max taken before the
                # mask (then l is the denominator at that max); and the
                # kernel's decomposition with one split dropped from the
                # merge or a split boundary one key block off.
                late = att.decode_prefix_attention_plain(q, pk, pv, lens + 1, sm_scale=sc)
                qg = q.float().reshape(R, n_per, KVH, QH // KVH, D)
                s_all = torch.einsum("rnhgd,rkhd->rnhgk", qg, pk.float()) * sc
                valid = torch.arange(P, device=dev)[None, :] < lens.long()[:, None]
                m_early = s_all.amax(-1)
                p = torch.exp(torch.where(valid[:, None, None, None], s_all,
                                          torch.full_like(s_all, att.NEG_INF)) - m_early[..., None])
                l_early = p.sum(-1).reshape(B, QH)
                model = att.decode_prefix_attention_split(q, pk, pv, lens, sm_scale=sc)
                rec["split_model_err_over_limit"] = k3_over3(model, ref)
                ok = rec["ok"] = ok and rec["split_model_err_over_limit"] <= 1.0
                rec["mutant_err_over_limit"] = {
                    "key_past_prompt_len_admitted": k3_over3(late, ref),
                    "max_before_masking": max(k3_over(m_early.reshape(B, QH), ref[1]),
                                              k3_over(l_early, ref[2])),
                    "merge_drops_one_split": k3_over3(att.decode_prefix_attention_split(
                        q, pk, pv, lens, sm_scale=sc, block_ranges=dropped_split), ref),
                    "split_boundary_one_block_off": k3_over3(att.decode_prefix_attention_split(
                        q, pk, pv, lens, sm_scale=sc, block_ranges=boundary_one_block_off), ref),
                }
            if timed:
                call = lambda: att.decode_prefix_attention(q, pk, pv, lens, sm_scale=sc)  # noqa: E731
                rec["ms"] = time_ms(call, iters=50)
                rec["plain_ms"] = time_ms(
                    lambda: att.decode_prefix_attention_plain(q, pk, pv, lens, sm_scale=sc), iters=10)
                # Device time, cold: each call on its own prefix K/V.
                n_copies = copies_for(2 * pk.numel() * pk.element_size())
                prefixes = [(pk, pv)] + [(randn(*pk.shape, dtype=dtype), randn(*pv.shape, dtype=dtype))
                                         for _ in range(n_copies - 1)]
                rec["device_ms"] = device_ms(
                    [lambda k_=k_, v_=v_: att.decode_prefix_attention(q, k_, v_, lens, sm_scale=sc)
                     for k_, v_ in prefixes])
                rec["rotation"] = n_copies
                # Yardstick only (the port never calls it): PyTorch's
                # memory-efficient attention, the request's n rows as the
                # query sequence, kv heads expanded, on the valid keys; it
                # returns out and logsumexp = m + log l.
                G = QH // KVH
                if R == 1:
                    plen = plens[0]
                    q_sd = q.reshape(1, n_per, QH, D).transpose(1, 2).contiguous()

                    def expand(t):
                        return t[:, :plen].transpose(1, 2).repeat_interleave(G, dim=1).contiguous()

                    def sdpa(k_, v_):
                        return torch.ops.aten._scaled_dot_product_efficient_attention(
                            q_sd, k_, v_, None, True, scale=sc)

                    ek, ev = expand(pk), expand(pv)
                    lib_out, lse = sdpa(ek, ev)[:2]
                    lse_ref = (ref[1] + torch.log(ref[2])).reshape(n_per, QH).T
                    rec["library_max_abs_diff"] = {
                        "out": (lib_out[0].transpose(0, 1).float().reshape(B, QH, D) - ref[0])
                        .abs().max().item(),
                        "logsumexp": (lse[0, :, :n_per] - lse_ref).abs().max().item()}
                    rec["library_ms"] = time_ms(lambda: sdpa(ek, ev), iters=50)
                    n_lib = copies_for(2 * ek.numel() * ek.element_size())
                    expanded = [(ek, ev)] + [(expand(k_), expand(v_)) for k_, v_ in prefixes[1:n_lib]]
                    rec["library_device_ms"] = device_ms(
                        [lambda k_=k_, v_=v_: sdpa(k_, v_) for k_, v_ in expanded])
                    del expanded
                else:
                    rec["library_ms"] = rec["library_device_ms"] = None
                del prefixes
                # The valid keys of each request read once, q read once, out,
                # m and l written once.
                keys = sum(plens)
                flops = 4.0 * D * QH * n_per * keys
                esz = pk.element_size()
                nbytes = 2 * keys * KVH * D * esz + q.numel() * esz + (B * QH * (D + 2)) * 4
                rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
            log(rec)
            if not ok:
                raise AssertionError(f"decode_prefix_attention case {name} failed: {rec}")
            for mname, r in rec.get("mutant_err_over_limit", {}).items():
                caught[mname] = max(caught.get(mname, 0.0), r)
            return rec, err

        # Each mutant must be caught by some case (a case whose masked keys
        # never hold a row's largest score cannot show the max-before-mask
        # mutant; a case of one split has no boundary to move).
        caught = {}

        main_rec, e0 = k3_case("llama3_8b_long_prompt", 1, 8, 32, 8, 128, 2048, [1490],
                               torch.bfloat16, timed=True)
        errs = [e0]
        errs.append(k3_case("llama3_8b_short_prompt", 1, 8, 32, 8, 128, 64, [51], torch.bfloat16)[1])
        errs.append(k3_case("two_requests_ragged", 2, 8, 32, 8, 128, 2048, [1500, 437],
                            torch.bfloat16)[1])
        errs.append(k3_case("P_not_key_block_multiple", 1, 8, 32, 8, 128, 1001, [1000],
                            torch.bfloat16)[1])
        errs.append(k3_case("plen_equals_P", 1, 8, 32, 8, 128, 1001, [1001], torch.bfloat16)[1])
        errs.append(k3_case("plen_shorter_than_one_split", 1, 8, 32, 8, 128, 2048, [40],
                            torch.bfloat16)[1])
        errs.append(k3_case("n16_two_row_tiles", 1, 16, 32, 8, 128, 512, [300], torch.bfloat16)[1])
        errs.append(k3_case("tiny_f32", 3, 4, 4, 2, 16, 96, [45, 20, 95], torch.float32)[1])
        errs.append(k3_case("head_dim_64_f32", 2, 8, 4, 2, 64, 128, [77, 127], torch.float32)[1])
        errs.append(k3_case("f32_main_heads", 1, 8, 32, 8, 128, 2048, [1490], torch.float32)[1])
        errs.append(k3_case("head_dim_64", 2, 8, 8, 2, 64, 512, [511, 64], torch.bfloat16)[1])
        errs.append(k3_case("head_dim_256", 1, 8, 8, 4, 256, 200, [129], torch.bfloat16)[1])
        errs.append(k3_case("head_dim_16_bf16_simt", 1, 8, 4, 2, 16, 96, [70], torch.bfloat16)[1])
        log({"phase": "k3", "mutants_caught_max_err_over_limit": caught})
        if len(caught) != 4 or min(caught.values()) <= 1.0:
            raise AssertionError(f"decode_prefix_attention: the limit misses a mutant: {caught}")
        if main_rec["impl"] != "tc" or main_rec["plan"]["ctas"] < 132:
            raise AssertionError(f"decode_prefix_attention main shape plan: {main_rec['plan']}")
        kernels["decode_prefix_attention"] = {
            "name": "decode_prefix_attention", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/decode_prefix.cu",
            "replaces": "k_llms_tpu/ops/attention.py:145",
            "launches": None, "held": True, "max_abs_err": max(errs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"], "device_ms": main_rec["device_ms"],
            "library_device_ms": main_rec["library_device_ms"],
            "device_over_bound": main_rec["device_over_bound"], "impl": main_rec["impl"],
            "plan": main_rec["plan"], "timed_case": main_rec["case"],
        }

    from k_llms_tpu_torch.engine.engine import LocalEngine
    from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
    from k_llms_tpu_torch.models.config import get_config
    from k_llms_tpu_torch.models.llama import init_params

    # 8. tiny fp32: tokens through the kernels == through the plain paths
    # (greedy three ways; sampled under a grammar on the paged path)
    if "tiny" in phases:
        from k_llms_tpu_torch.engine.grammar import (
            grammar_for_schema,
            grammar_vocab,
            validate_grammar_tokens,
        )
        from k_llms_tpu_torch.models.quant import quantize_params

        tiny = get_config("tiny")
        tok = ByteTokenizer()
        prompt = tok.apply_chat_template(
            [{"role": "user", "content": "Extract the invoice total from: total due 41.20 EUR"}])
        flash = dict(attention_impl="flash", decode_attention_impl="flash")
        # An int4-eligible small config (every matmul K % 256 == 0, N % 128 == 0).
        eligible = tiny.with_(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                              head_dim=64, vocab_size=384, max_seq_len=128)
        gen_tiny = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(tiny, gen_tiny, dev)
        q4_params = quantize_params(init_params(eligible, gen_tiny, dev), bits=4)
        cpu_q4 = {k: ({kk: vv.to("cpu") for kk, vv in v.items()} if isinstance(v, dict)
                      else v.to("cpu")) for k, v in q4_params.items()}
        cpu_params = {k: ({kk: vv.to("cpu") for kk, vv in v.items()} if isinstance(v, dict)
                          else v.to("cpu")) for k, v in params.items()}
        greedy = dict(temperature=0.0)
        record = grammar_for_schema(Record.model_json_schema(), grammar_vocab(tok))
        # (label, kernel-path engine, plain-path engine, kernels that must run,
        # generate keywords)
        cases = [
            ("paged",
             dict(config=tiny.with_(attention_impl="flash"), params=params, device="cuda",
                  paged_attention_impl="cuda"),
             dict(config=tiny, params=params, device="cuda", paged_attention_impl="xla"),
             ("flash_attention", "paged_decode_attention"), greedy),
            ("dense_flash_decode",
             dict(config=tiny.with_(**flash), params=params, device="cuda", kv_layout="dense"),
             dict(config=tiny, params=params, device="cuda", kv_layout="dense"),
             ("flash_attention", "decode_prefix_attention"), greedy),
            # The plain versions of K2, K3 and K4 run where the wrappers send
            # CPU tensors.
            ("int4_dense_flash_decode",
             dict(config=eligible.with_(**flash), params=q4_params, device="cuda",
                  kv_layout="dense"),
             dict(config=eligible.with_(**flash), params=cpu_q4, device="cpu", kv_layout="dense"),
             ("flash_attention", "decode_prefix_attention", "w4_matmul"), greedy),
            # Sampled under the Record grammar: the draw kernel on the card,
            # the plain versions (draws included) on the CPU.
            ("paged_constrained_sampled",
             dict(config=tiny.with_(attention_impl="flash"), params=params, device="cuda",
                  paged_attention_impl="cuda"),
             dict(config=tiny, params=cpu_params, device="cpu", paged_attention_impl="xla"),
             ("flash_attention", "paged_decode_attention", "threefry_uniform_rows"),
             dict(temperature=1.0, constraint=record)),
        ]
        for label, kernel_kw, plain_kw, needed, gen_kw in cases:
            runs = {}
            for run, kw in (("kernels", kernel_kw), ("plain", plain_kw)):
                eng = LocalEngine(kw.pop("config"), kv_page_size=16, **kw)
                reset_counts()
                res = eng.generate(prompt, n=4, seed=1, max_new_tokens=32, eos_ids=tok.stop_ids,
                                   **gen_kw)
                runs[run] = (res, dict(_ext.LAUNCH_COUNTS), eng.quantized)
            res = runs["kernels"][0]
            same = bool((res.tokens == runs["plain"][0].tokens).all())
            lp_err = float(abs(res.logprobs - runs["plain"][0].logprobs).max())
            counts = runs["kernels"][1]
            legal = True
            if "constraint" in gen_kw:
                legal = all(validate_grammar_tokens(
                    record, [int(t) for t in res.tokens[i][: int(res.lengths[i])] if t < 256])[0]
                    for i in range(res.tokens.shape[0]))
            log({"phase": "tiny_fp32", "case": label, "quantized": runs["kernels"][2],
                 "temperature": gen_kw["temperature"], "tokens_equal": same,
                 "mask_legal": legal, "logprob_max_abs_diff": lp_err,
                 "kernel_launches": counts, "plain_launches": runs["plain"][1]})
            unused = [k for k in counts if k not in needed]
            if (not same or not legal or min(counts[k] for k in needed) == 0
                    or any(counts[k] for k in unused) or max(runs["plain"][1].values()) != 0):
                raise AssertionError(f"tiny fp32 {label}: kernel path disagrees with the plain path")

    # 9. Llama-3-8B at full width, seeded random weights, through KLLMs:
    # bf16 weights on the paged path, then int4 weights on the dense path
    # with flash decode. Random weights spread their mass over the whole 128k
    # vocabulary, which the byte tokenizer decodes to nothing; a logit bias
    # on the printable bytes gives consensus text to vote on.
    printable = {str(t): 10.0 for t in range(32, 127)}
    long_text = ("Invoice 2024-0117 from Acme GmbH, Berlin. Line items: 12 widgets at "
                 "3.40 EUR, 4 gadgets at 17.95 EUR, shipping 9.00 EUR. ") * 12
    long_text = long_text[:1450]
    requests = [
        dict(messages=[{"role": "user", "content": "What is the capital of France?"}],
             n=8, temperature=0.0, max_tokens=32, seed=1, logit_bias=printable),
        # Answers over 50 characters take the consensus's embeddings
        # similarity: one encoder forward (K2, and K4 on int4 weights) over
        # the distinct samples.
        dict(messages=[{"role": "user", "content": "Name three prime numbers."}],
             n=8, temperature=0.8, top_p=0.95, seed=3, max_tokens=64, logit_bias=printable),
        dict(messages=[{"role": "user", "content": long_text + "\nWhat is the total?"}],
             n=8, temperature=0.0, max_tokens=32, seed=5, logit_bias=printable),
    ]

    from k_llms_tpu_torch.engine.grammar import validate_grammar_tokens

    parse_request = dict(
        messages=[{"role": "user", "content": "Invoice 2024-0117 is 12 days past due and "
                                              "nothing was paid. Extract its status."}],
        response_format=InvoiceStatus, n=8, temperature=0.8, seed=11, max_tokens=96,
        logit_bias=printable)

    # The sched phase's group: four same-config requests of about 51, 46,
    # 300 and 1490 prompt tokens; its abort poller's two requests; its OOM
    # drill's two requests of about 2900 tokens each (another document
    # apiece), whose dense KV sets the group's peak apart from a solo's.
    sched_contents = ["What is the capital of France?", "Name three prime numbers.",
                      long_text[:279], long_text + "\nWhat is the total?"]
    sched_requests = [dict(messages=[{"role": "user", "content": c}], n=8, temperature=0.8,
                           max_tokens=32, seed=31 + i, logit_bias=printable)
                      for i, c in enumerate(sched_contents)]
    oom_contents = [long_text * 2, long_text[725:] + long_text[:725] + long_text]

    def serve_8b(label, client, reqs=requests, parse_req=parse_request,
                 parse_model=InvoiceStatus):
        """Warm up, then the create requests and the parse request with every
        launch count reset just before and read just after. Returns (counts,
        engine launches [(requests, rows per request, decode steps,
        temperature)], embeddings forwards, each launch's (tokens, logprobs)
        per request, each launch's ``last_launch_stats``, the paged launches
        that ran the plain (reference) attention)."""
        engine = client.backend.engine
        client.chat.completions.create(messages=[{"role": "user", "content": "warm up"}],
                                       n=2, max_tokens=4, temperature=0.0, seed=0,
                                       logit_bias=printable)
        launches, embed_batches, outputs, stats = [], [], [], []
        generate_many, embed_tokens = engine.generate_many, engine.embed_tokens

        constrained = []

        def counted_generate_many(items, **kw):
            out = generate_many(items, **kw)
            st = engine.last_launch_stats
            launches.append((len(items), st["n_per"], st["decode_steps"], kw["temperature"]))
            stats.append(dict(st))
            outputs.append([(r.tokens.copy(), r.logprobs.copy()) for r in out])
            if kw.get("constraint") is not None:
                constrained.append((kw["constraint"], out[0], dict(st)))
            return out

        def counted_embed_tokens(token_lists, *a, **kw):
            embed_batches.append([len(t) for t in token_lists])
            return embed_tokens(token_lists, *a, **kw)

        engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
        plain = plain_paged_launches()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        allocated_before = torch.cuda.memory_allocated()
        for i, req in enumerate(reqs):
            t0 = time.perf_counter()
            n_embeds = len(embed_batches)
            resp = client.chat.completions.create(**req)
            wall = time.perf_counter() - t0
            st = dict(engine.last_launch_stats)
            n = req["n"]
            if len(resp.choices) != n + 1 or resp.likelihoods is None:
                raise AssertionError(f"{label} request {i}: {len(resp.choices)} choices, "
                                     f"likelihoods={resp.likelihoods}")
            lps = [c.sample_logprob for c in resp.choices[1:]]
            if not all(math.isfinite(x) for x in lps):
                raise AssertionError(f"{label} request {i}: non-finite sample logprobs {lps}")
            gen_tokens = resp.usage.completion_tokens
            log({"phase": f"{label}_request", "index": i, "n": n, "temperature": req["temperature"],
                 "prompt_tokens": resp.usage.prompt_tokens, "completion_tokens": gen_tokens,
                 "prefill_ms": st["prefill_s"] * 1e3,
                 "decode_ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
                 "decode_steps": st["decode_steps"], "kv_layout": st["kv_layout"], "wall_s": wall,
                 "tokens_per_s": gen_tokens / wall, "choices": len(resp.choices),
                 "embeddings_forwards": embed_batches[n_embeds:],
                 "consensus": resp.choices[0].message.content, "likelihoods": resp.likelihoods})
        if parse_req is None:
            return finish_serving(label, engine, launches, embed_batches, outputs, stats, plain,
                                  allocated_before)
        # The parse request: grammar-constrained and sampled.
        t0 = time.perf_counter()
        n_launches = len(launches)
        resp = client.chat.completions.parse(**parse_req)
        wall = time.perf_counter() - t0
        if len(constrained) != 1:
            raise AssertionError(f"{label} parse: {len(constrained)} constrained launches")
        grammar, res, st = constrained[0]
        legal, finished, validated = [], 0, 0
        for i in range(res.tokens.shape[0]):
            body = [int(t) for t in res.tokens[i][: int(res.lengths[i])] if t < 256]
            ok, terminal = validate_grammar_tokens(grammar, body)
            legal.append(ok)
            if res.finish_reasons[i] == "stop":
                finished += 1
                parse_model.model_validate_json(bytes(body))  # raises if invalid
                validated += int(terminal)
        consensus = resp.choices[0].message.parsed
        log({"phase": f"{label}_parse_request", "n": parse_req["n"],
             "temperature": parse_req["temperature"], "prompt_tokens": resp.usage.prompt_tokens,
             "completion_tokens": resp.usage.completion_tokens,
             "prefill_ms": st["prefill_s"] * 1e3,
             "decode_ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
             "decode_steps": st["decode_steps"], "kv_layout": st["kv_layout"], "wall_s": wall,
             "grammar_states": int(grammar.trans.shape[0]), "mask_legal": legal,
             "finished": finished, "finished_and_validated": validated,
             "engine_launches": launches[n_launches:],
             "samples": [c.message.content for c in resp.choices[1:]],
             "consensus": None if consensus is None else consensus.model_dump()})
        if (len(resp.choices) != parse_req["n"] + 1 or not all(legal)
                or validated != finished or not isinstance(consensus, parse_model)):
            raise AssertionError(f"{label} parse request: legal={legal}, finished={finished}, "
                                 f"validated={validated}, consensus={consensus!r}")
        return finish_serving(label, engine, launches, embed_batches, outputs, stats, plain,
                              allocated_before)

    def finish_serving(label, engine, launches, embed_batches, outputs, stats, plain,
                       allocated_before):
        """The end of serve_8b's counted window: the counts read, no paged
        launch on the plain version (unless the model's paged decode is the
        reference, as for softcapped and windowed models), the peak."""
        del engine.generate_many, engine.embed_tokens
        counts = dict(_ext.LAUNCH_COUNTS)
        plain_dispatches = plain_paged_launches() - plain
        if plain_dispatches and engine.paged_attention_impl != "xla":
            raise AssertionError(f"{label}: a paged launch ran the plain version in the counted window")
        log({"phase": f"{label}_main_path", "launches": counts, "engine_launches": launches,
             "embeddings_forwards": len(embed_batches),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "allocated_before_requests_bytes": allocated_before})
        return counts, launches, embed_batches, outputs, stats, plain_dispatches

    def expected_bf16_paged(launches, embeds, L):
        """The paged bf16 path's launch counts: K2 once a layer per prefill
        and per embeddings forward, K1 once a layer per decode step, a draw
        per sampled step."""
        steps = sum(s for _, _, s, _ in launches)
        prefills = sum(r for r, _, _, _ in launches)
        return {"flash_attention": L * (prefills + len(embeds)),
                "paged_decode_attention": L * steps,
                "decode_prefix_attention": 0, "w4_matmul": 0,
                "threefry_uniform_rows": sampled_draws(launches),
                "levenshtein": LEV_PLANNED["launches"]}

    def expected_int4_dense(launches, embeds, L, G):
        """The int4 dense flash path's launch counts: K2 as on the paged
        path; K3 where its gate holds (at least 8 query rows per request and
        kv head, n * G >= 8); seven block matmuls a layer, plus lm_head for
        each prefill's last token and each decode step (the embeddings
        forward skips lm_head); a draw per sampled step."""
        steps = sum(s for _, _, s, _ in launches)
        prefills = sum(r for r, _, _, _ in launches)
        gated_steps = sum(s for _, n_per, s, _ in launches if n_per * G >= 8)
        return {
            "flash_attention": L * (prefills + len(embeds)),
            "paged_decode_attention": 0,
            "decode_prefix_attention": L * gated_steps,
            "w4_matmul": (7 * L + 1) * (prefills + steps) + 7 * L * len(embeds),
            "threefry_uniform_rows": sampled_draws(launches),
            "levenshtein": LEV_PLANNED["launches"],
        }

    def sampled_draws(launches):
        """Draw-kernel launches of sampled engine launches: one for the
        first token and one per decode step."""
        return sum(s + 1 for _, _, s, temperature in launches if temperature != 0.0)

    def profile_one(label, client, index):
        from torch.profiler import ProfilerActivity, profile

        engine = client.backend.engine
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            client.chat.completions.create(**requests[index])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = dict(engine.last_launch_stats)
        # Kernel events only: an operator's entry repeats the device time of
        # the kernels it launched.
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        port = ("paged_decode", "flash_attention", "decode_prefix", "w4_")
        log({"phase": f"{label}_profile", "request": index, "wall_s": wall,
             "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
             "decode_steps": st["decode_steps"], "device_busy_s": busy_us / 1e6,
             "device_idle_share": 1.0 - busy_us / 1e6 / wall,
             "top_device_time": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                                 for us, k, c in rows[:12]],
             "port_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                              for us, k, c in rows if any(n in k for n in port)]})

    def profile_masked(label, client):
        """The grammar mask's added device time per decode step: one step's
        mask and advance at the parse request's shape (8 rows over the whole
        vocabulary, its grammar) captured in a CUDA graph and replayed, each
        call on its own logits past the L2 (the capture also shows that
        neither syncs with the host). Beside it, that request's decode ms per step
        with and without the grammar (host clock, same seed and draws, 32
        tokens: too few to finish the document, so both run every step;
        runs in turns u/m/m/u). And the same step at a BPE vocabulary's
        width (random tables of the same state count over all V tokens, up
        to 32 bytes a token: ``grammar_advance`` walks 32 byte columns),
        which no request here can reach without a BPE tokenizer."""
        from k_llms_tpu_torch.engine.engine import MAX_EOS_IDS, GenRequestSpec, _constraint_ops
        from k_llms_tpu_torch.engine.grammar import (
            DeviceGrammar,
            grammar_advance,
            grammar_mask_logits,
        )

        engine, backend = client.backend.engine, client.backend
        tok = backend.tokenizer
        grammar = backend._constraint_for(InvoiceStatus)
        jt, initial_state, mask_logits, advance = _constraint_ops(grammar, dev)
        n_rows, V = parse_request["n"], engine.config.vocab_size
        state = initial_state(n_rows)
        eos = torch.tensor(tok.stop_ids + [-1] * (MAX_EOS_IDS - len(tok.stop_ids)), device=dev)
        tokens = torch.full((n_rows,), ord("{"), dtype=torch.int64, device=dev)
        logits = [randn(n_rows, V, dtype=torch.float32) for _ in range(copies_for(n_rows * V * 4))]
        mask_ms = device_ms([lambda x=x: (mask_logits(jt, x, *state, eos), advance(jt, tokens, *state))
                             for x in logits])
        mask_host_ms = time_ms(lambda: (mask_logits(jt, logits[0], *state, eos),
                                        advance(jt, tokens, *state)))
        S = int(grammar.trans.shape[0])
        bpe = DeviceGrammar(
            masks=torch.randint(-2 ** 31, 2 ** 31 - 1, (S, (V + 31) // 32), dtype=torch.int32,
                                device=dev, generator=gen),
            trans=torch.randint(-1, S, (S, 256), dtype=torch.int64, device=dev, generator=gen),
            terminal=torch.zeros(S, dtype=torch.bool, device=dev),
            token_bytes=torch.randint(0, 256, (V, 32), dtype=torch.uint8, device=dev, generator=gen),
            token_len=torch.randint(1, 33, (V,), dtype=torch.int64, device=dev, generator=gen),
            start=0, vocab_size=V)
        bpe_state = torch.zeros(n_rows, dtype=torch.int64, device=dev)
        bpe_tokens = torch.randint(0, V, (n_rows,), dtype=torch.int64, device=dev, generator=gen)

        def bpe_step(x):
            return (grammar_mask_logits(bpe, x, bpe_state, eos),
                    grammar_advance(bpe, bpe_tokens, bpe_state))

        bpe_ms = device_ms([lambda x=x: bpe_step(x) for x in logits])
        bpe_host_ms = time_ms(lambda: bpe_step(logits[0]))
        del logits, bpe
        ids = tok.apply_chat_template(parse_request["messages"], add_generation_prompt=True)
        bias = {int(t): b for t, b in printable.items()}
        per_step = {"unmasked": [], "masked": []}
        for name in ("unmasked", "masked", "masked", "unmasked"):
            engine.generate_many([GenRequestSpec(ids, n_rows, 11)], max_new_tokens=32,
                                 temperature=0.8, eos_ids=tok.stop_ids, logit_bias=bias,
                                 constraint=grammar if name == "masked" else None)
            st = engine.last_launch_stats
            per_step[name].append(st["decode_s"] * 1e3 / st["decode_steps"])
        log({"phase": f"{label}_profile_mask", "grammar_states": S,
             "mask_and_advance_device_ms": mask_ms, "mask_and_advance_host_ms": mask_host_ms,
             "bpe_width32_device_ms": bpe_ms, "bpe_width32_host_ms": bpe_host_ms,
             "decode_ms_per_step": per_step})

    from k_llms_tpu_torch import KLLMs

    # The prefix-cache sequence of the ckpt phase: a 1490-token prompt A
    # (another document than request 2's, so it is not cached by then), B =
    # A's first 1400 tokens and a 90-token tail of its own (the 8 header
    # tokens of the chat template, 1392 characters of A's text, 77 of the
    # tail, 13 footer tokens), then A again. Greedy answers of at most 16
    # bytes take no embeddings forward, so every K2 launch of a request is
    # its prefill's.
    doc = ("Purchase order PO-88231 from Borealis Oy, Turku. Items: 40 valves at 12.10 EUR, "
           "6 pumps at 310.00 EUR, freight 45.50 EUR. ") * 14
    content_a = doc[:1450] + "\nWhat is the total?"
    tail = ("\nWhich items were shipped to which address, and by which carrier? Answer in a line.")
    content_b = content_a[:1392] + tail[:77]
    cache_requests = [("miss", content_a), ("partial_hit", content_b), ("exact_hit", content_a)]

    def cache_sequence(label, client):
        """A (miss), B (partial hit through prefill_continue: K2 in its
        q_offset mode inside the model), A again (exact hit: no prefill).
        Asserts the cache's counts and each request's K2 launches exactly,
        and B's continuation (the suffix KV rows it wrote, layer by layer,
        and its first-token logits) against B's full prefill on the same
        engine."""
        engine, tok = client.backend.engine, client.backend.tokenizer
        L = engine.config.num_layers
        ids = {name: tok.apply_chat_template([{"role": "user", "content": c}],
                                             add_generation_prompt=True)
               for name, c in cache_requests}
        p = next(i for i, (x, y) in enumerate(zip(ids["miss"], ids["partial_hit"])) if x != y)
        if (len(ids["miss"]), len(ids["partial_hit"]), p) != (1490, 1490, 1400):
            raise AssertionError(f"{label} cache prompts: lengths {len(ids['miss'])}, "
                                 f"{len(ids['partial_hit'])}, common prefix {p}")
        recs = []
        for name, content in cache_requests:
            before = dict(engine.prefix_cache_stats)
            reset_counts()
            t0 = time.perf_counter()
            resp = client.chat.completions.create(
                messages=[{"role": "user", "content": content}], n=8, temperature=0.0,
                max_tokens=16, seed=5, logit_bias=printable)
            wall = time.perf_counter() - t0
            st = dict(engine.last_launch_stats)
            stats = {k: engine.prefix_cache_stats[k] - before[k] for k in before}
            counts = dict(_ext.LAUNCH_COUNTS)
            recs.append({"request": name, "prompt_tokens": resp.usage.prompt_tokens,
                         "prefill_ms": st["prefill_s"] * 1e3, "kv_layout": st["kv_layout"],
                         "wall_s": wall, "cache_stats_delta": stats, "launches": counts})
            want = {"misses": int(name == "miss"), "partial_hits": int(name == "partial_hit"),
                    "hits": int(name == "exact_hit")}
            want_k2 = 0 if name == "exact_hit" else L
            if stats != want or counts["flash_attention"] != want_k2 or len(resp.choices) != 9:
                raise AssertionError(f"{label} {name}: cache {stats} (want {want}), K2 "
                                     f"{counts['flash_attention']} (want {want_k2}): {recs[-1]}")
            if counts["levenshtein"] != LEV_PLANNED["launches"]:
                raise AssertionError(f"{label} {name}: levenshtein {counts['levenshtein']} "
                                     f"!= planned {LEV_PLANNED['launches']}")
            check_consensus_window(f"{label} {name}")
        # B's continuation against B's full prefill on this engine: the
        # suffix KV rows [p, 1490) that it wrote, layer by layer, and its
        # first-token logits, each as a relative L2 difference. The two run
        # B's 90 suffix rows through matmuls of other shapes (128 rows
        # against 2048), so their bf16 roundings differ: layer l's K and V
        # rows carry the 2l rounded sublayer outputs of the residual
        # stream below them and their own rounding, the logits all 64 and
        # theirs. Each rounding is an independent relative error of at
        # most 2**-9, so n of them add in quadrature to at most
        # sqrt(n) * 2**-9 (the logits read 0.0144 against sqrt(65) *
        # 2**-9 = 0.0157); the limit is 4 times that. A suffix at the
        # wrong positions turns every K row through RoPE (a one-position
        # shift moves Llama-3's K rows by ~0.2), and a wrong prefix or
        # another prompt moves K and V past layer 0, so three mutants,
        # each read on the same rows, must exceed the limit at some layer:
        # the continuation one prefix key short (every suffix position
        # one early), one whose cached prefix is zeroed, and A's rows
        # (another prompt's suffix).
        from k_llms_tpu_torch.models.llama import KVCache, prefill_continue

        total = len(ids["partial_hit"])
        suffix = ids["partial_hit"][p:]
        entry = engine._prefix_entries[tuple(ids["partial_hit"])]
        cont, cont_kv = entry[0].float(), engine._entry_prefix_kv(entry)
        full, full_kv = engine._prefill_full(*engine._prep_prompt(ids["partial_hit"]))
        full = full.float()

        def limit(n):
            return 4 * math.sqrt(n) * 2.0 ** -9

        @torch.inference_mode()
        def continued(q_off, lose_prefix=False):
            kv = engine._entry_prefix_kv(engine._prefix_entries[tuple(ids["miss"])])
            pad = (0, 0, 0, 0, 0, 2048 - q_off)
            seed = KVCache(k=torch.nn.functional.pad(kv.k[:, :, :q_off], pad),
                           v=torch.nn.functional.pad(kv.v[:, :, :q_off], pad))
            if lose_prefix:
                seed.k.zero_()
                seed.v.zero_()
            tokens = torch.tensor([suffix + [engine.config.pad_token_id] * (128 - len(suffix))],
                                  device=dev)
            logits, kv = prefill_continue(engine.config, engine.params, tokens, seed, q_off,
                                          q_off + len(suffix))
            return logits.float(), kv

        def rel_l2(x, ref):
            x, ref = x.float(), ref.float()
            return ((x - ref).norm() / ref.norm()).item()

        def kv_rows(kv, start):
            """Per layer, the rel L2 of K and V rows [start, start + 90)
            against the full prefill's rows [p, total), and the largest
            ratio of a reading to its layer's limit."""
            n = len(suffix)
            k = [rel_l2(kv.k[i, :, start:start + n], full_kv.k[i, :, p:total]) for i in range(L)]
            v = [rel_l2(kv.v[i, :, start:start + n], full_kv.v[i, :, p:total]) for i in range(L)]
            worst = max(max(k[i], v[i]) / limit(2 * i + 1) for i in range(L))
            return {"k": k, "v": v, "max_over_limit": worst}

        sound = kv_rows(cont_kv, p)
        recomputed, _ = continued(p)
        one_short_logits, one_short_kv = continued(p - 1)
        lost_logits, lost_kv = continued(p, lose_prefix=True)
        other_kv = engine._entry_prefix_kv(engine._prefix_entries[tuple(ids["miss"])])
        mutants = {"one_prefix_key_short": kv_rows(one_short_kv, p - 1),
                   "prefix_lost": kv_rows(lost_kv, p),
                   "another_prompt": kv_rows(other_kv, p)}
        del one_short_kv, lost_kv, other_kv
        mutant_logits = {"one_prefix_key_short": rel_l2(one_short_logits, full),
                         "prefix_lost": rel_l2(lost_logits, full)}
        rel, logits_limit = rel_l2(cont, full), limit(2 * L + 1)
        argmax_equal = bool((cont.argmax(-1) == full.argmax(-1)).all())
        stored_equal = bool(torch.equal(recomputed, cont))
        log({"phase": f"{label}_prefix_cache", "common_prefix_tokens": p,
             "suffix_tokens": len(suffix), "suffix_bucket": 128, "requests": recs,
             "kv_limit_by_layer": [limit(2 * i + 1) for i in range(L)],
             "kv_rows_rel_l2": sound,
             "kv_rows_mutant_max_over_limit": {k: m["max_over_limit"] for k, m in mutants.items()},
             "kv_rows_mutant_rel_l2": mutants,
             "continuation_vs_full_prefill_rel_l2": rel, "logits_limit_rel_l2": logits_limit,
             "continuation_vs_full_prefill_max_abs": (cont - full).abs().max().item(),
             "logits_mutant_rel_l2": mutant_logits,
             "recomputed_continuation_equals_stored": stored_equal,
             "argmax_equal": argmax_equal,
             "prefix_cache_stats": dict(engine.prefix_cache_stats)})
        if not (torch.isfinite(cont).all() and rel <= logits_limit and argmax_equal
                and stored_equal and sound["max_over_limit"] <= 1.0):
            raise AssertionError(f"{label}: continuation off: KV rows at {sound['max_over_limit']} "
                                 f"of the limit, logits {rel} (limit {logits_limit}), argmax "
                                 f"equal {argmax_equal}, recomputed equal {stored_equal}")
        missed = [k for k, m in mutants.items() if m["max_over_limit"] <= 1.0]
        if missed:
            raise AssertionError(f"{label}: the KV-row limit misses the mutants {missed}")
        return recs

    def host_memory(key):
        """A /proc/self/status entry in bytes (VmRSS: resident now; VmHWM:
        its peak), or None where the kernel does not report it."""
        with open("/proc/self/status") as f:
            return next((int(line.split()[1]) * 1024 for line in f
                         if line.startswith(key + ":")), None)

    def reset_host_peak():
        """Set VmHWM, this process's peak resident memory, back to VmRSS.
        Returns since when ``host_peak`` then reads: "load" (called just
        before one), or where the kernel reports no VmHWM or refuses the
        reset, "process start"."""
        if host_memory("VmHWM") is None:
            return "process start"
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
        except OSError:
            return "process start"
        return "load"

    def host_peak():
        """VmHWM in bytes, or where the kernel reports none, getrusage's
        lifetime peak."""
        import resource

        peak = host_memory("VmHWM")
        return peak if peak is not None else resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024

    def export_hf_llama(params, config, directory, shard_bytes=5 * 10 ** 9):
        """Write a bf16 Llama tree as an HF checkpoint directory (the test
        fixture of the ckpt phase; the package has no exporter, as the JAX
        package has none): ``model-0000k-of-0000m.safetensors`` shards of at
        most ``shard_bytes`` under HF names in [out, in] layout, with
        ``model.safetensors.index.json`` and ``config.json``. Returns the
        bytes written."""
        from k_llms_tpu_torch.models.safetensors_io import save_file

        layers = params["layers"]
        entries = [("model.embed_tokens.weight", params["embed"])]
        for i in range(config.num_layers):
            pre = f"model.layers.{i}."
            entries.append((pre + "input_layernorm.weight", layers["attn_norm"][i]))
            for ours, hf in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                             ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")):
                entries.append((pre + hf + ".weight", layers[ours][i].t()))
            entries.append((pre + "post_attention_layernorm.weight", layers["mlp_norm"][i]))
            for ours, hf in (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                             ("w_down", "mlp.down_proj")):
                entries.append((pre + hf + ".weight", layers[ours][i].t()))
        entries += [("model.norm.weight", params["final_norm"]),
                    ("lm_head.weight", params["lm_head"].t())]
        shards, size = [[]], 0
        for key, t in entries:
            nbytes = t.numel() * t.element_size()
            if shards[-1] and size + nbytes > shard_bytes:
                shards.append([])
                size = 0
            shards[-1].append((key, t))
            size += nbytes
        weight_map, written, total = {}, 0, 0
        for k, shard in enumerate(shards, 1):
            name = f"model-{k:05d}-of-{len(shards):05d}.safetensors"
            written += save_file(dict(shard), os.path.join(directory, name),
                                 metadata={"format": "pt"})
            for key, t in shard:
                weight_map[key] = name
                total += t.numel() * t.element_size()
        with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(LLAMA3_8B_CONFIG, f, indent=2)
        return written, len(shards)

    def load_client(label, directory, **kw):
        """KLLMs on the checkpoint directory, with the load's phases timed
        (file to device; the finite scan and checksum), its peak device
        memory and the host's peak resident memory."""
        from k_llms_tpu_torch.models import loader

        timings = {}

        def timed(name, fn):
            """``fn`` timed, with the process's VmRSS when it ends."""
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    timings[name + "_s"] = time.perf_counter() - t0
                    timings[name + "_end_vmrss_bytes"] = host_memory("VmRSS")
            return run

        load_sf, verify = loader.load_safetensors, loader.verify_param_integrity
        loader.load_safetensors = timed("read_to_device", load_sf)
        loader.verify_param_integrity = timed("verify", verify)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rss_on_entry, peak_since = host_memory("VmRSS"), reset_host_peak()
        try:
            t0 = time.perf_counter()
            client = KLLMs(backend="cuda", model=directory, checkpoint_path=directory,
                           attention_impl="flash", prefix_cache_size=4, **kw)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
        finally:
            loader.load_safetensors, loader.verify_param_integrity = load_sf, verify
        engine = client.backend.engine
        file_bytes = sum(os.path.getsize(os.path.join(directory, f))
                         for f in os.listdir(directory) if f.endswith(".safetensors"))
        rec = {"phase": f"{label}_load", "init_s": init_s, **timings,
               "read_GB_per_s": file_bytes / timings["read_to_device_s"] / 1e9,
               "checkpoint_bytes": file_bytes, "param_bytes": engine.param_footprint_bytes(),
               "device_peak_during_load_bytes": torch.cuda.max_memory_allocated() - base,
               "host_rss_bytes_on_entry": rss_on_entry, "host_rss_peak_bytes": host_peak(),
               "host_peak_since": peak_since,
               "quantized": engine.quantized, "kv_layout": engine.kv_layout,
               "param_summary": client.backend.param_summary}
        return client, rec

    def ckpt_phase(seeded):
        import shutil
        import tempfile

        from k_llms_tpu_torch.models import loader
        from k_llms_tpu_torch.models.quant import quantize_params

        engine = seeded["client"].backend.engine
        cfg = engine.config
        L, G = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
        t0 = time.perf_counter()
        seeded_summary = loader.param_summary(engine.params)
        summary_s = time.perf_counter() - t0
        seeded_q4_summary = loader.param_summary(quantize_params(engine.params, bits=4))
        torch.cuda.empty_cache()
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_tmp")
        os.makedirs(root, exist_ok=True)
        directory = tempfile.mkdtemp(prefix="llama-3-8b-hf-", dir=root)
        try:
            need = engine.param_footprint_bytes() + (1 << 30)
            free = shutil.disk_usage(directory).free
            log({"phase": "ckpt_disk", "directory": directory, "free_bytes": free,
                 "needed_bytes": need, "seeded_summary": seeded_summary,
                 "seeded_summary_s": summary_s, "seeded_int4_summary": seeded_q4_summary})
            if free < need:
                raise AssertionError(f"ckpt: {free} bytes free under {root}, {need} needed")
            t0 = time.perf_counter()
            written, n_shards = export_hf_llama(engine.params, cfg, directory)
            export_s = time.perf_counter() - t0
            log({"phase": "ckpt_export", "bytes_written": written, "shards": n_shards,
                 "seconds": export_s, "GB_per_s": written / export_s / 1e9,
                 "files": sorted(os.listdir(directory))})
            del engine
            seeded.pop("client").close()
            gc.collect()
            torch.cuda.empty_cache()
            from k_llms_tpu_torch.models.loader import config_from_hf

            loaded_cfg = config_from_hf(directory)
            if loaded_cfg.with_(name=cfg.name, attention_impl=cfg.attention_impl) != cfg:
                raise AssertionError(f"config.json gives {loaded_cfg}, not {cfg}")

            # bf16, paged: the same tokens and logprobs as the seeded tree.
            client, rec = load_client("ckpt_bf16", directory)
            log(rec)
            if client.backend.param_summary != seeded_summary:
                raise AssertionError(f"loaded summary {client.backend.param_summary} != "
                                     f"seeded {seeded_summary}")
            counts, launches, embeds, outputs, *_ = serve_8b("ckpt_bf16", client)
            expected = expected_bf16_paged(launches, embeds, L)
            same = [[bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
                     for a, b in zip(x, y)] for x, y in zip(outputs, seeded["outputs"])]
            log({"phase": "ckpt_bf16_vs_8b", "launches_equal": launches == seeded["launches"],
                 "tokens_and_logprobs_equal": same, "counts": counts, "expected": expected,
                 "prefix_cache_stats": dict(client.backend.engine.prefix_cache_stats)})
            if launches != seeded["launches"] or not all(all(x) for x in same):
                raise AssertionError("ckpt_bf16: the loaded checkpoint's outputs differ from the "
                                     "seeded tree's")
            if counts != expected or counts != seeded["counts"]:
                raise AssertionError(f"ckpt_bf16 launch counts {counts} != expected {expected}")
            check_consensus_window("ckpt_bf16")
            cache_sequence("ckpt_bf16", client)
            client.close()
            del client
            gc.collect()
            torch.cuda.empty_cache()

            # int4 weights quantized at load, dense layout, flash decode.
            client, rec = load_client("ckpt_int4", directory, quantization="int4",
                                      paged_kv=False, decode_attention_impl="flash")
            t0 = time.perf_counter()
            rec["int4_summary"] = loader.param_summary(client.backend.engine.params)
            rec["int4_summary_s"] = time.perf_counter() - t0
            log(rec)
            if client.backend.param_summary != seeded_summary:
                raise AssertionError("ckpt_int4: the loaded bf16 tree differs from the seeded one")
            if rec["int4_summary"] != seeded_q4_summary:
                raise AssertionError(f"ckpt_int4: quantized at load {rec['int4_summary']} != "
                                     f"quantize_params of the seeded tree {seeded_q4_summary}")
            counts, launches, embeds, *_ = serve_8b("ckpt_int4", client)
            expected = expected_int4_dense(launches, embeds, L, G)
            log({"phase": "ckpt_int4_expected_launches", "expected": expected, "counts": counts,
                 "prefix_cache_stats": dict(client.backend.engine.prefix_cache_stats)})
            if not embeds or expected["decode_prefix_attention"] == 0 or counts != expected:
                raise AssertionError(f"ckpt_int4 launch counts {counts} != expected {expected}")
            check_consensus_window("ckpt_int4")
            cache_sequence("ckpt_int4", client)
            client.close()
            del client
        finally:
            shutil.rmtree(directory, ignore_errors=True)
            log({"phase": "ckpt_cleanup", "directory_removed": not os.path.exists(directory)})

    # -- the consensus phase's 8B part and the loop phase -----------------------

    def consensus_8b(client):
        """The parse() request at n = 8 and one sampled create() at n = 32
        on the 8B client, each consolidation done again on the host scorer
        and on a fresh device scorer: choices[0] and likelihoods equal, the
        consolidate ms of both, the Levenshtein launches as planned."""
        from k_llms_tpu_torch.consensus.consolidation import (
            consolidate_chat_completions,
            consolidate_parsed_chat_completions,
        )
        from k_llms_tpu_torch.consensus.device import DeviceSimilarityScorer
        from k_llms_tpu_torch.consensus.settings import ConsensusSettings
        from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

        backend = client.backend
        captured = []
        dispatch = backend.dispatch_chat_completion

        def capturing(request):
            out = dispatch(request)
            captured.append(out)
            return out

        backend.dispatch_chat_completion = capturing
        wide = dict(messages=[{"role": "user", "content": "List a code for each of the items."}],
                    n=32, temperature=0.8, top_p=0.95, seed=13, max_tokens=40,
                    logit_bias=printable)
        reset_counts()
        recs = []
        for label, req in (("parse_n8", parse_request), ("create_n32", wide)):
            if label.startswith("parse"):
                resp = client.chat.completions.parse(**req)
            else:
                resp = client.chat.completions.create(**req)
            completion = captured[-1]
            rec = {"request": label, "n": req["n"]}
            for method in ("embeddings", "levenshtein"):
                outs = {}
                for way in ("host", "device"):
                    if way == "host":
                        scorer = SimilarityScorer(method=method, embed_fn=backend.embeddings)
                    else:
                        scorer = DeviceSimilarityScorer(method=method, embed_fn=backend.embeddings,
                                                        device=dev)
                    settings = ConsensusSettings(string_similarity_method=method)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if label.startswith("parse"):
                        out = consolidate_parsed_chat_completions(
                            completion, scorer, consensus_settings=settings,
                            response_format=InvoiceStatus)
                    else:
                        out = consolidate_chat_completions(completion, scorer,
                                                           consensus_settings=settings)
                    outs[way] = (out, (time.perf_counter() - t0) * 1e3)
                host, device = outs["host"][0], outs["device"][0]
                same = (host.choices[0].message.content == device.choices[0].message.content
                        and host.likelihoods == device.likelihoods)
                rec[method] = {"host_ms": outs["host"][1], "device_ms": outs["device"][1],
                               "equal": same}
                if method == "embeddings":  # the client's own consolidation
                    same = same and resp.choices[0].message.content == device.choices[0].message.content \
                        and resp.likelihoods == device.likelihoods
                    rec["client_equal"] = same
                if not same:
                    raise AssertionError(f"consensus {label} {method}: device and host differ: "
                                         f"{device.choices[0].message.content!r} vs "
                                         f"{host.choices[0].message.content!r}")
            recs.append(rec)
        del backend.dispatch_chat_completion
        counts = dict(_ext.LAUNCH_COUNTS)
        log({"phase": "consensus_8b", "requests": recs, "levenshtein_launches": counts["levenshtein"],
             "planned": dict(LEV_PLANNED), "fallbacks": consensus_fallbacks()})
        if counts["levenshtein"] != LEV_PLANNED["launches"] or LEV_PLANNED["launches"] == 0:
            raise AssertionError(f"consensus 8b: levenshtein launches {counts['levenshtein']}, "
                                 f"planned {LEV_PLANNED}")
        check_consensus_window("consensus 8b")

    loop_knobs = dict(continuous_batching=True, continuous_width=32, continuous_max_prompt=2048,
                      continuous_max_new=96)
    loop_parse = dict(messages=[{"role": "user", "content": "Invoice 2024-0117 lists 12 widgets "
                                                           "from Acme. Extract the record."}],
                      response_format=Record, n=8, temperature=0.8, seed=17, max_tokens=96)
    # (label, request, send after this many loop steps, via parse())
    loop_requests = [
        ("A", dict(messages=[{"role": "user", "content": "What is the capital of France?"}],
                   n=8, temperature=0.0, max_tokens=64, seed=1), 0, False),
        ("D", loop_parse, 0, True),
        ("B", dict(messages=[{"role": "user", "content": "Name three prime numbers."}],
                   n=8, temperature=0.8, top_p=0.95, max_tokens=48, seed=3), 8, False),
        ("C", dict(messages=[{"role": "user", "content": long_text + "\nWhat is the total?"}],
                   n=8, temperature=0.0, max_tokens=32, seed=5), 16, False),
    ]

    def drive_loop(label, client, reqs, biased_at=None):
        """Send ``reqs`` through the client from threads, each after its
        loop step, with every launch count reset just before and read just
        after (and, at ``biased_at`` steps, a logit-bias request that takes
        the coalescing path while the loop decodes). Returns the window's
        counts, the loop's stats, per-request submissions, the coalesced
        launches, the embeddings forwards and the per-step record."""
        import threading

        backend = client.backend
        engine, loop = backend.engine, backend._continuous
        subs, steps_log, launches, embeds = {}, [], [], []
        submit, step_once = loop.submit, loop._step_once
        generate_many, embed_tokens = engine.generate_many, engine.embed_tokens
        current = threading.local()

        def recording_submit(ids, **kw):
            fut = submit(ids, **kw)
            subs[getattr(current, "label", "?")] = (list(ids), dict(kw), fut)
            return fut

        def timed_step():
            rows = int(loop._active_mask.sum())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_once()
            steps_log.append((rows, (time.perf_counter() - t0) * 1e3))

        def counted_generate_many(items, **kw):
            out = generate_many(items, **kw)
            st = engine.last_launch_stats
            launches.append((len(items), st["n_per"], st["decode_steps"], kw["temperature"]))
            return out

        def counted_embed_tokens(token_lists, *a, **kw):
            embeds.append([len(t) for t in token_lists])
            return embed_tokens(token_lists, *a, **kw)

        loop.submit, loop._step_once = recording_submit, timed_step
        engine.generate_many, engine.embed_tokens = counted_generate_many, counted_embed_tokens
        resps, errors = {}, {}

        def run(name, req, parse):
            current.label = name
            try:
                fn = client.chat.completions.parse if parse else client.chat.completions.create
                resps[name] = fn(**req)
            except BaseException as e:  # reported below
                errors[name] = e

        plain = plain_paged_launches()
        reset_counts()
        t0 = time.perf_counter()
        threads = []
        pending = list(reqs)
        if biased_at is not None:
            pending.append(("bias", dict(messages=[{"role": "user", "content": "Spell a word."}],
                                         n=8, temperature=0.0, max_tokens=32, seed=7,
                                         logit_bias=printable), biased_at, False))
        pending.sort(key=lambda r: r[2])
        for name, req, after, parse in pending:
            while loop._stats["steps"] < after:
                time.sleep(0.0005)
            th = threading.Thread(target=run, args=(name, req, parse))
            th.start()
            threads.append(th)
            if after == 0:  # queued in order before the next one
                while name != "bias" and name not in subs and th.is_alive():
                    time.sleep(0.0005)
        join_all(threads)
        wall = time.perf_counter() - t0
        counts = dict(_ext.LAUNCH_COUNTS)
        del loop.submit, loop._step_once, engine.generate_many, engine.embed_tokens
        if errors:
            raise AssertionError(f"{label}: requests failed: {errors}")
        if plain_paged_launches() != plain:
            raise AssertionError(f"{label}: a paged launch ran the plain version")
        check_consensus_window(label)
        return counts, loop.stats, subs, resps, launches, embeds, steps_log, wall

    def per_rows_ms(steps_log):
        by = {}
        for rows, ms in steps_log:
            by.setdefault(rows, []).append(ms)
        return {str(r): {"steps": len(v), "median_ms": float(np.median(v))}
                for r, v in sorted(by.items())}

    def agreement(a, b):
        return [int(np.sum(a.tokens == b.tokens)), int(a.tokens.size)]

    def loop_bf16():
        """The 8B bf16 paged client with the continuous loop: A and the
        Record parse() D together, B after A's 8th step, the 1490-token C
        after its 16th (12 chunks of 128), a logit-bias request through the
        coalescing path while the loop decodes; then each request alone
        through the loop, A through a coalesced launch, C's chunked KV
        against its whole-prompt prefill, and a profiled solo run."""
        t0 = time.perf_counter()
        client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed, **loop_knobs)
        backend = client.backend
        engine, loop = backend.engine, backend._continuous
        tok = backend.tokenizer
        L = engine.config.num_layers
        log({"phase": "loop_8b_init", "seconds": time.perf_counter() - t0, "width": loop.width,
             "prefill_chunk_tokens": loop.prefill_chunk_tokens, "paged": loop.paged,
             "planned_pool_pages": loop._pool_pages_planned})
        if (loop.width, loop.prefill_chunk_tokens, loop.paged) != (32, 128, True):
            raise AssertionError(f"loop 8b: width {loop.width}, chunk {loop.prefill_chunk_tokens}")
        client.chat.completions.create(messages=[{"role": "user", "content": "warm up"}], n=2,
                                       max_tokens=4, temperature=0.0, seed=0)
        pool = engine._kv_pool
        pool_tensors = (pool.k, pool.v)
        prompt_lens = {name: len(tok.apply_chat_template(r["messages"], add_generation_prompt=True))
                       for name, r, _, _ in loop_requests}
        before = dict(loop.stats)
        counts, st, subs, resps, launches, embeds, steps_log, wall = drive_loop(
            "loop_8b", client, loop_requests, biased_at=24)
        delta = {k: st[k] - before[k] for k in ("steps", "admitted", "joined_in_flight",
                                                 "completed", "prefill_chunks",
                                                 "prefill_interleaved", "replayed_rows")}
        chunked = sum(1 for n in prompt_lens.values() if n > loop.prefill_chunk_tokens)
        whole = delta["admitted"] - chunked
        co_steps = sum(s for _, _, s, _ in launches)
        expected = {
            "flash_attention": L * (whole + delta["prefill_chunks"] + len(embeds)
                                    + sum(r for r, _, _, _ in launches)),
            "paged_decode_attention": L * (delta["steps"] + co_steps),
            "decode_prefix_attention": 0, "w4_matmul": 0,
            "threefry_uniform_rows": (sampled_draws(launches) + delta["steps"]
                                      + delta["admitted"]),
            "levenshtein": LEV_PLANNED["launches"],
        }
        pool_same = engine._kv_pool is pool and (pool.k, pool.v) == pool_tensors
        page_bytes = pool.pool_bytes() // pool.allocator.total_pages
        log({"phase": "loop_8b", "wall_s": wall, "prompt_tokens": prompt_lens, "stats": delta,
             "max_active_rows": st["max_active_rows"], "coalesced_launches": launches,
             "embeddings_forwards": embeds, "launches": counts, "expected": expected,
             "decode_ms_per_step_by_active_rows": per_rows_ms(steps_log),
             "pool_pages": pool.allocator.total_pages, "page_bytes": page_bytes,
             "pool_bytes": pool.pool_bytes(), "param_bytes": engine.param_footprint_bytes(),
             "pool_tensors_same": pool_same,
             "consensus": {n: r.choices[0].message.content if not hasattr(r.choices[0].message, "parsed")
                           else str(r.choices[0].message.parsed) for n, r in resps.items()}})
        problems = []
        if delta["admitted"] != 4 or delta["joined_in_flight"] < 2:
            problems.append("admissions")
        if delta["prefill_chunks"] != 12 or delta["prefill_interleaved"] < 1:
            problems.append("chunks")
        if st["max_active_rows"] < 24:
            problems.append("max_active_rows")
        if counts != expected:
            problems.append("launch counts")
        if len(launches) != 1 or not pool_same:
            problems.append("coalesced request / pool")
        if pool.allocator.total_pages != 1185 or page_bytes != 8 << 20:
            problems.append("pool size")
        if problems:
            raise AssertionError(f"loop 8b: {problems}")
        kernels_rows = counts["threefry_uniform_rows"]
        loop_stream(client, loop_parse, resps["D"], log)
        # Outside the counted window: each request alone through the loop.
        results = {n: f.result() for n, (_, _, f) in subs.items()}
        solo_agree = {}
        from torch.profiler import ProfilerActivity, profile

        for name, (ids, kw, _) in subs.items():
            solo_agree[name] = agreement(results[name], loop.submit(ids, **kw).result())
        # The device's idle share over a short solo window: A's first 16
        # tokens alone (the trace of a whole request takes the profiler
        # tens of seconds to sum).
        ids_a, kw_a, _ = subs["A"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop.submit(ids_a, **dict(kw_a, max_new=16)).result()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy_us = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy_us += getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0))
        idle = {"tokens": 16, "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
                "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall}
        coalesced = engine.generate(ids_a, n=kw_a["n"], seed=kw_a["seed"],
                                    max_new_tokens=kw_a["max_new"], temperature=0.0,
                                    eos_ids=tok.stop_ids)
        ids_c, kw_c, _ = subs["C"]
        coalesced_c = engine.generate(ids_c, n=kw_c["n"], seed=kw_c["seed"],
                                      max_new_tokens=kw_c["max_new"], temperature=0.0,
                                      eos_ids=tok.stop_ids)
        # C's chunked KV (12 chunks of 128, K2 in its q_offset mode) against
        # its whole-prompt prefill, per layer, held to the continuation
        # bound of the ckpt phase: 4 sqrt(2l + 1) 2**-9.
        from k_llms_tpu_torch.models.llama import init_cache, prefill_chunk_step

        with torch.inference_mode():
            cids, plen, bucket = engine._prep_prompt(ids_c)
            _, full_kv = engine._prefill_full(cids, plen, bucket)
            cache = init_cache(engine.config, 1, bucket, dev)
            C = loop.prefill_chunk_tokens
            for start in range(0, plen, C):
                valid = min(C, plen - start)
                chunk = torch.full((1, C), engine.config.pad_token_id, dtype=torch.int64, device=dev)
                chunk[0, :valid] = torch.tensor(cids[start:start + valid], device=dev)
                _, cache = prefill_chunk_step(engine.config, engine.params, chunk, cache, start, valid)

        def rel_l2(x, ref):
            x, ref = x.float(), ref.float()
            return ((x - ref).norm() / ref.norm()).item()

        kv_k = [rel_l2(cache.k[i, :, :plen], full_kv.k[i, :, :plen]) for i in range(L)]
        kv_v = [rel_l2(cache.v[i, :, :plen], full_kv.v[i, :, :plen]) for i in range(L)]
        worst = max(max(kv_k[i], kv_v[i]) / (4 * math.sqrt(2 * i + 1) * 2.0 ** -9) for i in range(L))
        log({"phase": "loop_8b_check", "solo_tokens_agreeing": solo_agree,
             "A_vs_coalesced_tokens_agreeing": agreement(results["A"], coalesced),
             "C_vs_coalesced_whole_prefill_tokens_agreeing": agreement(results["C"], coalesced_c),
             "C_chunked_kv_rel_l2": {"k": kv_k, "v": kv_v, "max_over_limit": worst},
             "profiled_solo_A_16_tokens": idle})
        if worst > 1.0:
            raise AssertionError(f"loop 8b: C's chunked KV past the bound ({worst})")
        client.close()
        del client, backend, engine, loop, pool, pool_tensors
        gc.collect()
        torch.cuda.empty_cache()
        return kernels_rows

    def loop_int4():
        """The int4 client on the dense loop (K2, K4; plain decode
        attention, since a loop row is its own prefix): A, then C after A's
        16th step; counts asserted, A equal to its solo run."""
        t0 = time.perf_counter()
        client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed,
                       quantization="int4", paged_kv=False, decode_attention_impl="flash",
                       **loop_knobs)
        backend = client.backend
        engine, loop = backend.engine, backend._continuous
        L = engine.config.num_layers
        log({"phase": "loop_8b_int4_init", "seconds": time.perf_counter() - t0,
             "width": loop.width, "paged": loop.paged, "quantized": engine.quantized})
        client.chat.completions.create(messages=[{"role": "user", "content": "warm up"}], n=2,
                                       max_tokens=4, temperature=0.0, seed=0)
        before = dict(loop.stats)
        reqs = [r for r in loop_requests if r[0] in ("A", "C")]
        counts, st, subs, resps, launches, embeds, steps_log, wall = drive_loop(
            "loop_8b_int4", client, reqs)
        delta = {k: st[k] - before[k] for k in ("steps", "admitted", "prefill_chunks",
                                                 "prefill_interleaved", "joined_in_flight")}
        whole = delta["admitted"] - 1
        calls = whole + delta["prefill_chunks"] + delta["steps"]
        expected = {
            "flash_attention": L * (whole + delta["prefill_chunks"] + len(embeds)),
            "paged_decode_attention": 0, "decode_prefix_attention": 0,
            "w4_matmul": (7 * L + 1) * calls + 7 * L * len(embeds),
            "threefry_uniform_rows": delta["steps"] + delta["admitted"],
            "levenshtein": LEV_PLANNED["launches"],
        }
        ids_a, kw_a, fut_a = subs["A"]
        solo = loop.submit(ids_a, **kw_a).result()
        equal = bool(np.array_equal(fut_a.result().tokens, solo.tokens))
        log({"phase": "loop_8b_int4", "wall_s": wall, "stats": delta, "launches": counts,
             "expected": expected, "embeddings_forwards": embeds,
             "decode_ms_per_step_by_active_rows": per_rows_ms(steps_log),
             "A_equal_to_solo": equal})
        if (counts != expected or delta["admitted"] != 2 or delta["prefill_chunks"] != 12
                or not equal or launches):
            raise AssertionError(f"loop 8b_int4: counts {counts} vs {expected}, {delta}, "
                                 f"A equal to solo {equal}")
        client.close()
        del client, backend, engine, loop
        gc.collect()
        torch.cuda.empty_cache()

    # The family phases' requests: a greedy request whose prompt (about
    # 4600 tokens) is longer than the 4096-key window, so that the window
    # masks keys in prefill and in decode; a sampled short one; a parse()
    # under the Record grammar. Mixtral takes the 8b phase's three requests.
    window_text = (long_text * 4)[:4560] + "\nWhat is the total?"
    family_requests = [
        dict(messages=[{"role": "user", "content": window_text}], n=8, temperature=0.0,
             max_tokens=32, seed=5, logit_bias=printable),
        dict(messages=[{"role": "user", "content": "Name three prime numbers."}],
             n=8, temperature=0.8, top_p=0.95, seed=3, max_tokens=64, logit_bias=printable),
    ]
    family_parse = dict(messages=[{"role": "user", "content": "Invoice 2024-0117 lists 12 widgets "
                                                             "from Acme. Extract the record."}],
                        response_format=Record, n=8, temperature=0.8, seed=17, max_tokens=64,
                        logit_bias=printable)
    # (registry name, client keywords, create requests, parse request)
    families = {
        "gemma9b": ("gemma-2-9b", {}, family_requests, family_parse),
        "mistral7b": ("mistral-7b", {}, family_requests, family_parse),
        "mixtral_int4": ("mixtral-8x7b", dict(quantization="int4"), requests, None),
    }

    def plain_decode_ms(engine, launch_stats):
        """Device time of the plain paged decode attention one step runs on
        the longest launch's shape (n rows over the prompt's bucket of
        prefix slots and the generation slots), per layer and per step; and
        the paged kernel's (K1) on the same shape without the window and the
        softcap it does not serve: what a kernel step would cost."""
        cfg = engine.config
        st = max(launch_stats, key=lambda s: s["rows"])
        B, G = st["n_per"], 32
        P = 8192 if cfg.sliding_window else 2048
        ps = engine.kv_page_size
        QH, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        npages = 1 + P // ps + B * (G // ps + 1)
        pool_k = randn(npages * ps, KVH, D)
        pool_v = randn(npages * ps, KVH, D)
        plen = P - 3592 if cfg.sliding_window else 1490  # the window's prompt: 4600 tokens
        prefix_idx = torch.arange(P, device=dev)[None] + ps
        gen_idx = (1 + P // ps) * ps + torch.arange(B * G, device=dev).reshape(B, G)
        q = randn(B, 1, QH, D)
        nk, nv = randn(B, 1, KVH, D), randn(B, 1, KVH, D)
        step = 16
        lengths = torch.full((B,), step, device=dev)
        window = cfg.sliding_window or att.NO_WINDOW
        key_mask = (torch.arange(G, device=dev)[None, None] <= step) & (
            torch.arange(G, device=dev)[None, None] > step - window)
        key_mask = key_mask.expand(B, 1, G)
        pos = plen + step
        prefix_mask = (torch.arange(P, device=dev)[None, None] < plen) & (
            torch.arange(P, device=dev)[None, None] > pos - window)
        prefix_mask = prefix_mask.expand(B, 1, P)
        scale = cfg.query_scale or 1.0 / math.sqrt(D)

        def plain():
            return pa.paged_decode_attention_xla(
                q, pool_k, pool_v, prefix_idx, gen_idx, nk, nv, lengths, key_mask, prefix_mask,
                sm_scale=scale, softcap=cfg.attn_softcap)

        tables = pa.paged_attention_page_tables(prefix_idx, gen_idx, ps)
        plen_row = torch.full((B,), plen, dtype=torch.int32, device=dev)
        glen = torch.full((B,), step, dtype=torch.int32, device=dev)

        def kernel():
            return pa.paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v, *tables,
                                             nk[:, 0].contiguous(), nv[:, 0].contiguous(),
                                             plen_row, glen, page_size=ps, sm_scale=scale)

        plain_layer = time_ms(plain, iters=10)
        kernel_layer = time_ms(kernel, iters=10)
        return {"rows": B, "prefix_slots": P, "prompt_len": plen, "layers": cfg.num_layers,
                "plain_ms_per_layer": plain_layer, "plain_ms_per_step": plain_layer * cfg.num_layers,
                "plain_device_ms_per_layer": device_ms([plain]),
                "k1_unwindowed_ms_per_layer": kernel_layer,
                "k1_unwindowed_device_ms_per_layer": device_ms([kernel])}

    def serve_family(label):
        """One family at its published width (Mixtral at half its depth):
        the client built with K2 on
        prefill and paged decode, its requests served with every launch
        counted (K2 per layer per prefill and embeddings forward; the paged
        kernel per layer per step, or none where the reference attention
        decodes; K4 on Mixtral's attention and head), the xla dispatches
        counted, the window's prompt longer than the window, the peak."""
        from k_llms_tpu_torch.models.config import get_config, register_config

        name, client_kw, reqs, parse_req = families[label]
        gc.collect()  # an earlier phase's client, so the peak is this model's
        torch.cuda.empty_cache()
        # The byte tokenizer's special ids (as LLAMA3_8B_CONFIG has them),
        # and the family's depth cut (every width as published).
        full = get_config(name)
        register_config(full.with_(bos_token_id=256, eos_token_id=257, pad_token_id=258,
                                   num_layers=full.num_layers
                                   // FAMILY_DEPTH_DIVISOR.get(label, 1)))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        client = KLLMs(backend="cuda", model=name, param_seed=args.seed, attention_impl="flash",
                       kv_pool_pages=160, **client_kw)
        torch.cuda.synchronize()
        engine = client.backend.engine
        cfg = engine.config
        L = cfg.num_layers
        log({"phase": f"{label}_init", "seconds": time.perf_counter() - t0,
             "param_bytes": engine.param_footprint_bytes(), "quantized": engine.quantized,
             "health_hbm": client.backend.health()["hbm"],
             "kv_layout": engine.kv_layout, "paged_attention_impl": engine.paged_attention_impl,
             "attention_impl": cfg.attention_impl, "head_dim": cfg.head_dim,
             "sliding_window": cfg.sliding_window, "window_layers": cfg.sliding_window_layers,
             "attn_softcap": cfg.attn_softcap, "experts": cfg.num_experts,
             "init_peak_memory_bytes": torch.cuda.max_memory_allocated()})
        counts, launches, embeds, _, stats, xla = serve_8b(label, client, reqs, parse_req, Record)
        steps = sum(s for _, _, s, _ in launches)
        prefills = sum(r for r, _, _, _ in launches)
        kernel_decode = engine.paged_attention_impl == "cuda"
        expected = {
            "flash_attention": L * (prefills + len(embeds)),
            "paged_decode_attention": L * steps if kernel_decode else 0,
            "decode_prefix_attention": 0,
            "w4_matmul": ((4 * L + 1) * (prefills + steps) + 4 * L * len(embeds)
                          if engine.quantized == "int4" else 0),
            "threefry_uniform_rows": sampled_draws(launches),
            "levenshtein": LEV_PLANNED["launches"],
        }
        expected_xla = 0 if kernel_decode else len(launches)
        prompt_lens = [len(client.backend.tokenizer.apply_chat_template(r["messages"],
                                                                       add_generation_prompt=True))
                       for r in reqs]
        longest = max(prompt_lens)
        layouts = [s["kv_layout"] for s in stats]
        rec = {"phase": f"{label}_expected_launches", "expected": expected, "counts": counts,
               "paged_attn_xla_dispatch": xla, "expected_xla_dispatch": expected_xla,
               "layouts": layouts, "longest_prompt": longest,
               "prefill_ms": [s["prefill_s"] * 1e3 for s in stats],
               "decode_ms_per_step": [s["decode_s"] * 1e3 / max(s["decode_steps"], 1)
                                      for s in stats],
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if cfg.sliding_window is not None or cfg.attn_softcap is not None:
            rec["plain_decode_attention"] = plain_decode_ms(engine, stats)
        log(rec)
        if counts != expected or xla != expected_xla or set(layouts) != {"paged"}:
            raise AssertionError(f"{label} launch counts {counts} != expected {expected}, "
                                 f"xla dispatches {xla} != {expected_xla}, layouts {layouts}")
        if cfg.sliding_window is not None and longest <= cfg.sliding_window:
            raise AssertionError(f"{label}: the longest prompt ({longest}) is inside the window")
        check_consensus_window(label)
        client.close()
        del client, engine

    # -- the parity phase: the embedding signal and seeded reproducibility --
    # The texts of tests/test_embedding_signal.py.
    parity_paraphrases = [
        "The shipment of industrial widgets departed the Rotterdam warehouse on "
        "Tuesday morning and is expected at the Hamburg depot within three days.",
        "The shipment of industrial widgets left the Rotterdam warehouse on "
        "Tuesday morning and should reach the Hamburg depot within three days.",
    ]
    parity_unrelated = [
        "Payment terms are net thirty days from the invoice issue date, with a "
        "two percent discount applied for settlement within ten calendar days.",
        "All customer support inquiries should be directed to the billing "
        "department via email and will be answered within two business days.",
    ]

    def parity_8b(client):
        """Llama-3-8B's embeddings as a similarity signal, through K2: the
        cosines of the paraphrase, corruption, identical and unrelated pairs
        (recorded: seeded weights need not order them as the tiny model
        does, which the CPU twin asserts), the six texts' one forward with
        K2 once a layer and nothing else, and the majority medoid election over a
        cluster and an outlier under the card's embeddings and under
        Levenshtein (asserted). Then two seeded sampled requests: their
        choices and likelihoods byte-identical, every launch counted."""
        from k_llms_tpu_torch.consensus.similarity import SimilarityScorer, cosine_similarity

        t_phase = time.perf_counter()
        backend = client.backend
        L = backend.engine.config.num_layers
        reset_counts()
        base = parity_paraphrases[0]
        corrupted = base.replace("Tuesday", "Tuesdya").replace("widgets", "widgtes")
        texts = parity_paraphrases + parity_unrelated + [corrupted, base]
        t0 = time.perf_counter()
        vecs = backend.embeddings(texts)
        embed_s = time.perf_counter() - t0
        # One forward over the six texts: K2 once a layer, nothing else.
        counts = dict(_ext.LAUNCH_COUNTS)
        expected = dict.fromkeys(counts, 0)
        expected["flash_attention"] = L
        if counts != expected:
            raise AssertionError(f"parity embeddings: counts {counts} != {expected}")
        if "flash_attention" in kernels:
            kernels["flash_attention"]["parity_launches"] = counts["flash_attention"]
        vec = dict(zip(["p0", "p1", "u0", "u1", "corrupted", "p0_again"], vecs))
        cos = {pair: cosine_similarity(vec[pair.split("/")[0]], vec[pair.split("/")[1]])
               for pair in ("p0/p1", "p0/u0", "p0/u1", "p0/corrupted", "p0/p0_again")}
        orderings = {
            "paraphrases_outscore_unrelated": cos["p0/p1"] > max(cos["p0/u0"], cos["p0/u1"]),
            "small_corruptions_stay_close": cos["p0/corrupted"] > cos["p0/u0"],
            "identical_near_one": cos["p0/p0_again"] > 0.999,
        }
        # The medoid election: a majority cluster of three and an outlier.
        cluster = [base, base.replace("Tuesday", "Wednesday"),
                   base.replace("three days", "four days")]
        variants = cluster + [parity_unrelated[0]]

        def row_means(scorer):
            sims = np.array([[scorer.generic(a, b) for b in variants] for a in variants],
                            np.float64)
            return sims.mean(axis=1)

        emb_means = row_means(SimilarityScorer(method="embeddings",
                                               embed_fn=backend.embeddings))
        lev_means = row_means(SimilarityScorer(method="levenshtein"))
        medoids = {"embeddings": variants[int(emb_means.argmax())],
                   "levenshtein": variants[int(lev_means.argmax())]}
        log({"phase": "parity_embeddings", "texts": len(texts),
             "token_lengths": [len(backend.tokenizer.encode(t)) for t in texts],
             "embed_s": embed_s, "dim": len(vecs[0]), "launches": counts, "cosines": cos,
             "orderings": orderings,
             "embedding_row_means": emb_means.tolist(),
             "levenshtein_row_means": lev_means.tolist(),
             "medoid_in_cluster": {k: v in cluster for k, v in medoids.items()},
             "outlier_lowest_under_embeddings":
                 int(emb_means.argmin()) == len(variants) - 1})
        if (any(m not in cluster for m in medoids.values())
                or int(emb_means.argmin()) != len(variants) - 1):
            raise AssertionError(f"parity medoid election: {medoids}, row means "
                                 f"{emb_means.tolist()}")

        # Seeded reproducibility: the same sampled request twice.
        req = dict(messages=[{"role": "user", "content": "Name three prime numbers."}],
                   n=8, temperature=0.8, top_p=0.95, seed=23, max_tokens=32,
                   logit_bias=printable)
        counts, launches, embeds, outputs, *_ = serve_8b("parity_seeded", client, [req, req],
                                                         None)
        expected = expected_bf16_paged(launches, embeds, L)
        if counts != expected:
            raise AssertionError(f"parity seeded launch counts {counts} != {expected}")
        check_consensus_window("parity_seeded")
        responses = [client.chat.completions.create(**req) for _ in range(2)]
        dumps = [json.dumps({"choices": [c.model_dump() for c in r.choices],
                             "likelihoods": r.likelihoods, "usage": r.usage.model_dump()},
                            sort_keys=True) for r in responses]
        (tokens_a, logprobs_a), (tokens_b, logprobs_b) = outputs[0][0], outputs[1][0]
        same_launches = (np.array_equal(tokens_a, tokens_b)
                         and np.array_equal(logprobs_a, logprobs_b))
        log({"phase": "parity_seeded", "same_tokens_and_logprobs": same_launches,
             "same_responses": dumps[0] == dumps[1], "response_bytes": len(dumps[0]),
             "phase_s": time.perf_counter() - t_phase})
        if not same_launches or dumps[0] != dumps[1]:
            raise AssertionError("parity: two seeded requests differ")

    # -- the spec phase: prompt-lookup speculative decoding ------------------
    # Drafts verified per forward, as the JAX package's default.
    SPEC_K = 4
    #: Kernel launches summed over the spec phase's counted windows.
    spec_launch_counts = {}

    def note_spec_counts(counts):
        for name, v in counts.items():
            spec_launch_counts[name] = spec_launch_counts.get(name, 0) + v

    def expected_spec(launches, embeds, L, int4):
        """A speculative client's launch counts: K2 once a layer per prefill
        and per embeddings forward; no K1 and no K3 (spec launches decode
        dense, and the verify's K + 1 queries a row take the plain attention,
        as in JAX); on int4 weights K4 per int4 matmul per prefill and per
        verify iteration (seven block matmuls a layer and lm_head; the
        embeddings forward skips lm_head); a draw per sampled verify
        iteration plus the first token's (``decode_steps`` of a spec launch
        counts its verify iterations)."""
        its = sum(s for _, _, s, _ in launches)
        prefills = sum(r for r, _, _, _ in launches)
        return {"flash_attention": L * (prefills + len(embeds)),
                "paged_decode_attention": 0, "decode_prefix_attention": 0,
                "w4_matmul": ((7 * L + 1) * (prefills + its) + 7 * L * len(embeds)) if int4 else 0,
                "threefry_uniform_rows": sampled_draws(launches),
                "levenshtein": LEV_PLANNED["launches"]}

    def spec_client_beside(client):
        """A speculative client on another client's weights (the same
        tensors, no copy), dense, as the JAX engine routes spec launches."""
        from k_llms_tpu_torch.backends.cuda import CudaBackend

        base = client.backend
        eng = base.engine
        spec_engine = LocalEngine(eng.config, params=eng.params, device=eng.device,
                                  kv_layout="dense", speculative="prompt_lookup",
                                  spec_lookahead=SPEC_K)
        cfg = base.backend_config.model_copy(update=dict(
            speculative="prompt_lookup", spec_lookahead=SPEC_K, paged_kv=False))
        return KLLMs(backend=CudaBackend(config=cfg, engine=spec_engine))

    def spec_alternating(label, case, normal_engine, spec_engine, ids, expect_normal,
                         expect_spec, **kw):
        """One request through the normal and the speculative engine in
        alternating runs (normal, spec, spec, normal: host clocks move by up
        to 2x between calls), each launch's counts held to its formula.
        Per run: decode ms per step (per verify iteration on spec runs) and
        per emitted token (decode time over the tokens a row emitted after
        its first, averaged over rows). Returns (runs, first result of each
        kind)."""
        runs, results = [], {}
        for which in ("normal", "spec", "spec", "normal"):
            eng = spec_engine if which == "spec" else normal_engine
            reset_counts()
            res = eng.generate(ids, **kw)
            counts = dict(_ext.LAUNCH_COUNTS)
            st = dict(eng.last_launch_stats)
            launch = [(1, st["n_per"], st["decode_steps"], kw["temperature"])]
            expected = (expect_spec if which == "spec" else expect_normal)(launch)
            if counts != expected:
                raise AssertionError(f"{label} {case} {which} launch counts {counts} != {expected}")
            if which == "spec":
                note_spec_counts(counts)
            emitted = float(np.mean(res.lengths.astype(np.float64) - 1.0))
            runs.append({"run": which, "prefill_ms": st["prefill_s"] * 1e3,
                         "decode_ms": st["decode_s"] * 1e3, "steps": st["decode_steps"],
                         "ms_per_step": st["decode_s"] * 1e3 / max(1, st["decode_steps"]),
                         "emitted_per_row": emitted,
                         "ms_per_emitted_token": st["decode_s"] * 1e3 / max(emitted, 1.0),
                         "kv_layout": st["kv_layout"], "spec": st.get("spec")})
            results.setdefault(which, res)
        a, b = results["normal"], results["spec"]
        summary = {kind: {m: [r[m] for r in runs if r["run"] == kind]
                          for m in ("ms_per_step", "ms_per_emitted_token")}
                   for kind in ("normal", "spec")}
        log({"phase": f"{label}_spec_timing", "case": case, "n": kw["n"],
             "max_new_tokens": kw["max_new_tokens"], "temperature": kw["temperature"],
             "prompt_tokens": len(ids), "runs": runs, "summary": summary,
             "verify_over_step": (np.mean(summary["spec"]["ms_per_step"])
                                  / np.mean(summary["normal"]["ms_per_step"])),
             "per_token_speedup": (np.mean(summary["normal"]["ms_per_emitted_token"])
                                   / np.mean(summary["spec"]["ms_per_emitted_token"])),
             "tokens_agreeing": [int(np.sum(a.tokens == b.tokens)), int(a.tokens.size)],
             "rows_equal": int(sum(np.array_equal(x, y) for x, y in zip(a.tokens, b.tokens)))})
        return runs, results

    def spec_copy_case(label, normal_engine, spec_engine, expect_normal, expect_spec, L, int4):
        """The copy case, asserted: a prompt of one repeated printable byte
        with a +100 logit bias on it, greedy, 64 tokens at n = 8: every
        token is that byte and a verify emits more than two tokens a row.
        On int4 weights a further counted spec run records K4's routes: the
        verify's n (K + 1) = 40 rows take the tensor-core tile."""
        from k_llms_tpu_torch.ops import w4matmul as w4

        byte = ord("x")
        ids = [byte] * 300
        kw = dict(n=8, max_new_tokens=64, temperature=0.0, seed=1, logit_bias={byte: 100.0},
                  eos_ids=ByteTokenizer().stop_ids)
        runs, results = spec_alternating(label, "copy", normal_engine, spec_engine, ids,
                                         expect_normal, expect_spec, **kw)
        res = results["spec"]
        stats = [r["spec"] for r in runs if r["run"] == "spec"]
        tpi = [s["tokens_per_iteration"] for s in stats]
        routes = None
        if int4:
            seen = {}
            original = w4.w4_route

            def recording(rows, K, N, dtype):
                route = original(rows, K, N, dtype)
                seen[(rows, route)] = seen.get((rows, route), 0) + 1
                return route

            reset_counts()
            w4.w4_route = recording
            try:
                spec_engine.generate(ids, **kw)
            finally:
                w4.w4_route = original
            counts = dict(_ext.LAUNCH_COUNTS)
            st = dict(spec_engine.last_launch_stats)
            its = st["decode_steps"]
            note_spec_counts(counts)
            expected = expect_spec([(1, st["n_per"], its, 0.0)])
            verify_rows = kw["n"] * (SPEC_K + 1)
            routes = {f"{rows}:{route}": c for (rows, route), c in sorted(seen.items())}
            log({"phase": f"{label}_spec_copy_routes", "k4_calls_by_rows_and_route": routes,
                 "verify_rows": verify_rows, "verify_iterations": its, "launches": counts})
            if (counts != expected or seen.get((verify_rows, "tc"), 0) != (7 * L + 1) * its
                    or any(rows == verify_rows and route != "tc" for rows, route in seen)):
                raise AssertionError(f"{label} copy case K4 routes {routes}, counts {counts} "
                                     f"!= {expected}")
        log({"phase": f"{label}_spec_copy", "all_tokens_the_byte": bool((res.tokens == byte).all()),
             "tokens_per_iteration": tpi, "spec_stats": stats})
        if not (res.tokens == byte).all() or min(tpi) <= 2.0:
            raise AssertionError(f"{label} copy case: tokens_per_iteration {tpi}, tokens "
                                 f"{res.tokens[:, :8].tolist()}")
        return runs

    def spec_8b(label, client, normal_outputs=None):
        """The spec phase on an 8B client's weights. On bf16 (``8b``): the
        ``8b`` phase's three requests and its ``parse()`` through a
        speculative client (counted, by formula), their acceptance and
        their agreement with the normal client (reported, not asserted:
        bf16 shapes differ); request 0 timed against the normal path in
        alternating runs; a two-request group fused through the scheduler,
        equal to its rerun, its mirror and ``SPEC_EVENTS`` held together.
        On both: the copy case."""
        from k_llms_tpu_torch.utils.observability import SPEC_EVENTS

        engine = client.backend.engine
        int4 = engine.quantized == "int4"
        cfg8 = engine.config
        L, G = cfg8.num_layers, cfg8.num_heads // cfg8.num_kv_heads
        spec_client = spec_client_beside(client)
        spec_engine = spec_client.backend.engine

        def expect_spec(launches, embeds=()):
            return expected_spec(launches, list(embeds), L, int4)

        def expect_normal(launches):
            if int4:
                return expected_int4_dense(launches, [], L, G)
            return expected_bf16_paged(launches, [], L)

        log({"phase": f"{label}_spec_init", "kv_layout": spec_engine.kv_layout,
             "spec_lookahead": spec_engine.spec_lookahead, "quantized": spec_engine.quantized,
             "shares_weights": spec_engine.params is engine.params})
        if not int4:
            counts, launches, embeds, outputs, stats, _ = serve_8b(f"{label}_spec", spec_client)
            expected = expect_spec(launches, embeds)
            agreement = None
            if normal_outputs is not None:
                agreement = [
                    {"tokens_agreeing": [int(np.sum(s[0][0] == n_[0][0])), int(s[0][0].size)],
                     "rows_equal": int(sum(np.array_equal(x, y)
                                           for x, y in zip(s[0][0], n_[0][0])))}
                    for s, n_ in zip(outputs, normal_outputs)]
            log({"phase": f"{label}_spec_main_path", "launches": counts, "expected": expected,
                 "engine_launches": launches, "spec_stats": [s.get("spec") for s in stats],
                 "agreement_with_normal": agreement})
            if counts != expected or any(s["kv_layout"] != "dense" for s in stats):
                raise AssertionError(f"{label} spec launch counts {counts} != expected {expected}")
            check_consensus_window(f"{label}_spec")
            note_spec_counts(counts)
            tok = ByteTokenizer()
            ids0 = tok.apply_chat_template(requests[0]["messages"], add_generation_prompt=True)
            spec_alternating(label, "request0", engine, spec_engine, ids0, expect_normal,
                             expect_spec, n=8, max_new_tokens=32, temperature=0.0, seed=1,
                             logit_bias={int(t): b for t, b in printable.items()},
                             eos_ids=tok.stop_ids)
            # The fused group: the hook's calls recorded, SPEC_EVENTS moved
            # by exactly their numbers.
            recorded = []
            hook = spec_engine.on_spec_stats

            def recording_hook(st):
                recorded.append(dict(st))
                hook(st)

            spec_engine.on_spec_stats = recording_hook
            events0 = SPEC_EVENTS.snapshot()
            try:
                group_counts = sched_coalesce(
                    f"{label}_spec", spec_client, sched_requests[:2],
                    lambda launches, embeds: expect_spec(launches, embeds), log)
            finally:
                spec_engine.on_spec_stats = hook
            events1 = SPEC_EVENTS.snapshot()
            note_spec_counts(group_counts)
            moved = {k: events1.get(k, 0) - events0.get(k, 0)
                     for k in ("spec.launches", "spec.drafted", "spec.accepted")}
            want = {"spec.launches": len(recorded),
                    "spec.drafted": sum(r.get("drafted", 0) for r in recorded),
                    "spec.accepted": sum(r.get("accepted", 0) for r in recorded)}
            log({"phase": f"{label}_spec_fused", "fused_mirror": recorded[0] if recorded else None,
                 "spec_events_moved": moved, "mirrors_sum": want, "launch_mirrors": recorded})
            if not recorded or recorded[0].get("coalesced_requests") != 2 or moved != want:
                raise AssertionError(f"{label} fused spec group: mirrors {recorded}, events {moved}")
        spec_copy_case(label, engine, spec_engine, expect_normal, expect_spec, L, int4)
        spec_client.close()
        del spec_client, spec_engine
        gc.collect()
        torch.cuda.empty_cache()

    def spec_kernels():
        """K4 at the verify's rows (n = 8, K = 4: 40 rows) on each 8B weight:
        the wrapper's route (the tensor-core tile), the decode kernel forced
        over 32-row chunks (32 + 8: it takes at most 32 rows), cuBLAS on a
        bf16 copy, the plain version, the bound; each route held to K4's
        limit; device times on cold weights. And one verify iteration's
        draws at 40 rows against the plain chain, bit for bit, timed."""
        from k_llms_tpu_torch.ops import random as rnd
        from k_llms_tpu_torch.ops import w4matmul as w4

        rows = 8 * (SPEC_K + 1)
        shapes = {"w_gate_up": (4096, 14336), "w_down": (14336, 4096), "wq_wo": (4096, 4096),
                  "wk_wv": (4096, 1024), "lm_head": (4096, 128256)}
        cases = []
        for sname, (K, N) in shapes.items():
            def make_w4():
                return w4.Q4Tensor(
                    torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev,
                                  dtype=torch.int8),
                    (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5)
                    / (4.61 * math.sqrt(K)))
            w = make_w4()
            x = randn(rows, K)
            chunks = [x[i:i + 32].contiguous() for i in range(0, rows, 32)]

            def decode_forced(wc, chunks=chunks):
                return torch.cat([w4.w4_matmul(c, wc, route="decode") for c in chunks])

            ref = w4.w4_matmul_plain(x, w).float()
            acc = torch.zeros((rows, N), dtype=torch.float32, device=dev)
            for g in range(K // 128):
                ints = w4._unpack_ints(w.q[g * 64:(g + 1) * 64])[0].float().abs()
                acc += (x.float().abs()[:, g * 128:(g + 1) * 128] @ ints) * w.scale[g]
            room = 2.0 ** -6 * ref.abs() + 1e-5 * acc
            outs = {"tc": w4.w4_matmul(x, w), "decode": decode_forced(w)}
            torch.cuda.synchronize()
            over = {r: ((o.float() - ref).abs() / room).max().item() for r, o in outs.items()}
            err = max((o.float() - ref).abs().max().item() for o in outs.values())
            w_bf16 = w4.unpack_int4(w).to(torch.bfloat16)
            rec = {"phase": "spec_k4_verify_rows", "case": sname, "rows": rows, "K": K, "N": N,
                   "route": w4.w4_route(rows, K, N, torch.bfloat16), "err_over_limit": over,
                   "max_abs_err": err,
                   "ms": time_ms(lambda: w4.w4_matmul(x, w)),
                   "decode_forced_ms": time_ms(lambda: decode_forced(w)),
                   "plain_ms": time_ms(lambda: w4.w4_matmul_plain(x, w), iters=3, warmup=1),
                   "library_ms": time_ms(lambda: torch.matmul(x, w_bf16))}
            del w_bf16
            flops = 2.0 * rows * K * N
            nbytes = x.numel() * 2 + K // 2 * N + K // 128 * N * 4 + rows * N * 2
            rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            cold = [make_w4() for _ in range(copies_for(K * N // 2 + K // 128 * N * 4))]
            rec["device_ms"] = device_ms([lambda wc=wc: w4.w4_matmul(x, wc) for wc in cold])
            rec["decode_forced_device_ms"] = device_ms(
                [lambda wc=wc: decode_forced(wc) for wc in cold])
            del cold
            cold_bf16 = [randn(K, N, scale=0.02) for _ in range(copies_for(K * N * 2))]
            rec["library_device_ms"] = device_ms(
                [lambda wb=wb: torch.matmul(x, wb) for wb in cold_bf16])
            del cold_bf16
            rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
            log(rec)
            if max(over.values()) > 1.0 or rec["route"] != "tc":
                raise AssertionError(f"w4_matmul at the verify's {rows} rows ({sname}): {rec}")
            cases.append(rec)
        torch.cuda.empty_cache()
        # The draws of one verify iteration: one request's key folded with
        # the iteration, position j as the step, row i as the index.
        n_per, V = 8, 128256
        keys = rnd.request_keys([3000000000], dev)
        it = torch.tensor(5, dtype=torch.int32, device=dev)
        got = rnd.threefry_uniform_verify(keys, it, n_per, SPEC_K + 1, V)
        it_keys = rnd.fold_in(keys, 5)[:, None, None, :]
        i = torch.arange(n_per, device=dev)[None, :, None]
        j = torch.arange(SPEC_K + 1, device=dev)[None, None, :]

        def plain_draw():
            return rnd.uniform_tiny(rnd.fold_in(rnd.fold_in(it_keys, j), i).reshape(-1, 2), V)

        equal = bool(torch.equal(got.view(torch.int32), plain_draw().view(torch.int32)))
        swapped = rnd.uniform_tiny(rnd.fold_in(rnd.fold_in(it_keys, i), j).reshape(-1, 2), V)
        mutant_caught = not torch.equal(got.view(torch.int32), swapped.view(torch.int32))
        out_bytes = rows * V * 4
        outs = []
        draw = {"phase": "spec_draws_verify_rows", "rows": rows, "V": V, "bit_equal": equal,
                "mutant_caught": mutant_caught,
                "ms": time_ms(lambda: rnd.threefry_uniform_verify(keys, it, n_per, SPEC_K + 1, V),
                              iters=50),
                "plain_ms": time_ms(plain_draw, iters=3, warmup=1),
                "device_ms": device_ms(
                    [lambda: outs.append(rnd.threefry_uniform_verify(keys, it, n_per, SPEC_K + 1,
                                                                     V))]
                    * copies_for(out_bytes))}
        # The kernel alone on the per-row vectors the call builds.
        row_keys = rnd.fold_in(keys, 5).expand(rows, 2).contiguous()
        steps_t = j.expand(1, n_per, SPEC_K + 1).reshape(-1).to(torch.int32).contiguous()
        index_t = i.expand(1, n_per, SPEC_K + 1).reshape(-1).to(torch.int32).contiguous()
        outs.clear()
        draw["kernel_only_device_ms"] = device_ms(
            [lambda: outs.append(rnd.threefry_uniform_rows(row_keys, steps_t, index_t, V))]
            * copies_for(out_bytes))
        del outs
        draw["bound_ms"], draw["bound_by"] = bound_ms(0.0, out_bytes + rows * (16 + 4 + 4),
                                                      PEAK_F32_FLOPS)
        draw["device_over_bound"] = draw["device_ms"] / draw["bound_ms"]
        log(draw)
        if not equal or not mutant_caught:
            raise AssertionError(f"verify draws at {rows} rows: {draw}")
        return cases, draw

    def spec_tiny():
        """tiny fp32 on the card: greedy speculation equals the normal dense
        greedy token for token (logprobs within 1e-4), on an ordinary prompt
        and on a copy prompt that accepts drafts; the int4-eligible small
        config with speculation, greedy and sampled, equals its plain
        versions on the CPU (K4 in its verify rows, the draws). Every spec
        launch's counts by formula."""
        from k_llms_tpu_torch.models.quant import quantize_params

        tiny = get_config("tiny").with_(attention_impl="flash")
        tok = ByteTokenizer()
        L = tiny.num_layers
        gen_tiny = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(tiny, gen_tiny, dev)
        eligible = get_config("tiny").with_(
            hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2, head_dim=64,
            vocab_size=384, max_seq_len=128, attention_impl="flash", decode_attention_impl="flash")
        q4 = quantize_params(init_params(eligible, gen_tiny, dev), bits=4)
        cpu_q4 = {k: ({kk: vv.to("cpu") for kk, vv in v.items()} if isinstance(v, dict)
                      else v.to("cpu")) for k, v in q4.items()}
        prompt = tok.apply_chat_template(
            [{"role": "user", "content": "Extract the invoice total from: total due 41.20 EUR"}])
        seven = ord("7")
        base = dict(n=4, seed=1, max_new_tokens=32, eos_ids=tok.stop_ids)
        for case, ids, extra in (("fp32_greedy", prompt, {}),
                                 ("fp32_copy", [seven] * 60, {"logit_bias": {seven: 100.0}})):
            kw = dict(base, temperature=0.0, **extra)
            normal = LocalEngine(tiny, params=params, device=dev, kv_layout="dense")
            spec_eng = LocalEngine(tiny, params=params, device=dev, kv_layout="dense",
                                   speculative="prompt_lookup", spec_lookahead=SPEC_K)
            rn = normal.generate(ids, **kw)
            reset_counts()
            rs = spec_eng.generate(ids, **kw)
            counts = dict(_ext.LAUNCH_COUNTS)
            st = dict(spec_eng.last_launch_stats)
            expected = expected_spec([(1, st["n_per"], st["decode_steps"], 0.0)], [], L, False)
            same = bool(np.array_equal(rn.tokens, rs.tokens))
            lp_err = float(np.abs(rn.logprobs - rs.logprobs).max())
            log({"phase": "spec_tiny", "case": case, "tokens_equal_normal": same,
                 "logprob_max_abs_diff": lp_err, "spec_stats": st["spec"], "launches": counts,
                 "expected": expected})
            if not same or lp_err > 1e-4 or counts != expected:
                raise AssertionError(f"spec tiny {case}: speculative greedy differs from normal")
            if case == "fp32_copy" and st["spec"]["tokens_per_iteration"] <= 2.0:
                raise AssertionError(f"spec tiny copy case accepted too little: {st['spec']}")
            note_spec_counts(counts)
        for temperature in (0.0, 1.0):
            kw = dict(base, temperature=temperature)
            runs = {}
            for where, p, d in (("card", q4, dev), ("plain", cpu_q4, "cpu")):
                eng = LocalEngine(eligible, params=p, device=d, kv_layout="dense",
                                  speculative="prompt_lookup", spec_lookahead=SPEC_K)
                reset_counts()
                res = eng.generate(prompt, **kw)
                runs[where] = (res, dict(_ext.LAUNCH_COUNTS), dict(eng.last_launch_stats))
            (rc, counts, st), (rp, plain_counts, pst) = runs["card"], runs["plain"]
            expected = expected_spec([(1, st["n_per"], st["decode_steps"], temperature)], [],
                                     eligible.num_layers, True)
            same = bool(np.array_equal(rc.tokens, rp.tokens))
            lp_err = float(np.abs(rc.logprobs - rp.logprobs).max())
            log({"phase": "spec_tiny", "case": f"int4_T{temperature}", "tokens_equal_plain": same,
                 "logprob_max_abs_diff": lp_err, "spec_stats": st["spec"],
                 "plain_spec_stats": pst["spec"], "launches": counts, "expected": expected,
                 "verify_rows": st["rows"] * (SPEC_K + 1)})
            if (not same or lp_err > 1e-4 or counts != expected or st["spec"] != pst["spec"]
                    or max(plain_counts.values()) != 0):
                raise AssertionError(f"spec tiny int4 T={temperature}: card differs from plain")
            note_spec_counts(counts)

    # 8b. Speculative decoding: K4 and the draws at the verify's rows, tiny
    # on the card, and the 8B clients' spec runs (beside the 8b and 8b_int4
    # phases' clients when those run, else on clients of their own).
    spec_kernel_cases = spec_draw = None
    if "spec" in phases:
        spec_kernel_cases, spec_draw = spec_kernels()
        spec_tiny()
        for label, kw in (("8b", dict(kv_pool_pages=128)),
                          ("8b_int4", dict(quantization="int4", paged_kv=False,
                                           decode_attention_impl="flash"))):
            if label not in phases:
                client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed, **kw)
                spec_8b(label, client)
                client.close()
                del client
                gc.collect()
                torch.cuda.empty_cache()

    # 9a. bf16 weights, paged decode: K2 and K1.
    if "8b" in phases:
        t0 = time.perf_counter()
        # The page pool is sized once, at its first build (as in the JAX
        # engine): 128 pages of 64 tokens hold every launch served here but
        # the real OOM drill's group (a solo of that drill takes 111: 46
        # prompt pages, 32 rows of two generation pages, the trash page), so
        # only that group decodes dense.
        client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed,
                       kv_pool_pages=128)
        torch.cuda.synchronize()
        engine = client.backend.engine
        log({"phase": "8b_init", "seconds": time.perf_counter() - t0,
             "param_bytes": engine.param_footprint_bytes(),
             "paged_attention_impl": engine.paged_attention_impl,
             "attention_impl": engine.config.attention_impl})
        counts, launches, embeds, outputs, *_ = serve_8b("8b", client)
        L = engine.config.num_layers
        del engine  # the rebuild below must be able to free the engine it replaces
        for name in ("flash_attention", "paged_decode_attention", "threefry_uniform_rows"):
            if name in kernels:
                kernels[name]["launches"] = counts[name]
        expected = expected_bf16_paged(launches, embeds, L)
        if not embeds or counts != expected:
            raise AssertionError(f"8b launch counts {counts} != expected {expected}")
        check_consensus_window("8b")
        if "levenshtein" in kernels:
            kernels["levenshtein"]["launches"] = counts["levenshtein"]
        if "consensus" in phases:
            consensus_8b(client)
        if "profile" in phases:
            for index in (0, 2):  # a short and the long prompt
                profile_one("8b", client, index)
            profile_masked("8b", client)
        if "serve" in phases:
            serve_http(client, requests[0], requests[1], sched_contents,
                       lambda launches, embeds: expected_bf16_paged(launches, embeds, L), log)
        if "spec" in phases:
            spec_8b("8b", client, outputs)
        if "sched" in phases:
            sched_coalesce("8b", client, sched_requests,
                           lambda launches, embeds: expected_bf16_paged(launches, embeds, L), log)
            sched_cancel("8b", client, [sched_contents[0], sched_contents[2]], log)
            sched_oom("8b", client, oom_contents, log)
            # Last: the rebuilt engine holds the same seeded weights, which
            # the ckpt phase exports and compares with this phase's outputs.
            sched_rebuild("8b", client, sched_contents[1], log)
        if "sanitize" in phases:
            # After sched: its real OOM drill's memory window is narrow,
            # and this phase's allocations move the allocator's slack.
            sanitize_counts = sanitize_8b(client, requests[:2], long_text, log)
            for name in ("flash_attention", "paged_decode_attention", "threefry_uniform_rows",
                         "levenshtein"):
                if name in kernels:
                    kernels[name]["sanitize_launches"] = sanitize_counts[name]
        if "parity" in phases:
            # After sched and sanitize, whose windows it must not move.
            parity_8b(client)
        if "ckpt" in phases:
            # 9c serves this tree again from a checkpoint on disk.
            seeded = {"client": client, "launches": launches, "embeds": embeds,
                      "outputs": outputs, "counts": counts}
        else:
            client.close()  # its scheduler's worker holds the backend until it exits
        del client
        gc.collect()
        torch.cuda.empty_cache()

    if "parity" in phases and "8b" not in phases:
        client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed,
                       kv_pool_pages=128)
        parity_8b(client)
        client.close()
        del client
        gc.collect()
        torch.cuda.empty_cache()

    # 9c. The seeded 8B tree as a checkpoint: exported to disk as an HF
    # Llama directory, loaded back (bf16, then int4), served, and the
    # prefix cache's miss, partial hit and exact hit on both clients.
    if "ckpt" in phases:
        ckpt_phase(seeded)
        del seeded
        gc.collect()
        torch.cuda.empty_cache()

    # 9d. The continuous loop on the 8B bf16 paged client (K2 per whole
    # prefill and per chunk, K1 per loop step, the per-row draws).
    if "loop" in phases:
        rows_launches = loop_bf16()
        if "threefry_uniform_rows" in kernels:
            kernels["threefry_uniform_rows"]["loop_launches"] = rows_launches

    # 9b. int4 weights, dense decode with the decode-prefix kernel: K2, K3
    # and K4 (no K1).
    if "8b_int4" in phases:
        t0 = time.perf_counter()
        client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed,
                       quantization="int4", paged_kv=False, decode_attention_impl="flash")
        torch.cuda.synchronize()
        engine = client.backend.engine
        log({"phase": "8b_int4_init", "seconds": time.perf_counter() - t0,
             "param_bytes": engine.param_footprint_bytes(), "quantized": engine.quantized,
             "kv_layout": engine.kv_layout,
             "decode_attention_impl": engine.config.decode_attention_impl,
             "attention_impl": engine.config.attention_impl})
        counts, launches, embeds, *_ = serve_8b("8b_int4", client)
        cfg8 = engine.config
        L = cfg8.num_layers
        G = cfg8.num_heads // cfg8.num_kv_heads
        for name in ("decode_prefix_attention", "w4_matmul"):
            if name in kernels:
                kernels[name]["launches"] = counts[name]
        draws = kernels.get("threefry_uniform_rows")
        if draws is not None and draws["launches"] is None:
            draws["launches"] = counts["threefry_uniform_rows"]
        expected = expected_int4_dense(launches, embeds, L, G)
        log({"phase": "8b_int4_expected_launches", "expected": expected, "counts": counts})
        if not embeds or expected["decode_prefix_attention"] == 0 or counts != expected:
            raise AssertionError(f"8b_int4 launch counts {counts} != expected {expected}")
        check_consensus_window("8b_int4")
        if "spec" in phases:
            spec_8b("8b_int4", client)
        if "profile" in phases:
            for index in (0, 2):
                profile_one("8b_int4", client, index)
            profile_masked("8b_int4", client)
        if "sched" in phases:
            sched_coalesce("8b_int4", client, sched_requests,
                           lambda launches, embeds: expected_int4_dense(launches, embeds, L, G), log)
        client.close()
        del client, engine
        gc.collect()
        torch.cuda.empty_cache()
        if "loop" in phases:
            loop_int4()

    # 11. The other model families at their published widths, Mixtral at
    # half its depth (seeded weights,
    # the byte tokenizer's special ids): Gemma-2-9B and Mistral-7B in bf16
    # on the paged path (K2 with softcap, window and head dim 256 in
    # prefill; the paged decode on the reference attention, which the JAX
    # package's routing gives softcapped and windowed models), Mixtral-8x7B
    # quantized (K2, K1, K4 on attention and the head; int8 experts).
    for label in FAMILY_PHASES:
        if label in phases:
            serve_family(label)
            gc.collect()
            torch.cuda.empty_cache()

    # 10. The watchdog and the replica set at tiny through the kernels
    # (after every counted window: a hung launch's thread outlives the run).
    if "sched" in phases:
        sched_tiny(log)
    if "loop" in phases:
        loop_tiny(log)

    # 12. The mesh (after sched and sanitize: a phase before sched moved
    # the real OOM drill's memory window). Ranks spawned on the one card
    # talk over the gloo transport (host-staged collectives); each serves
    # the unsharded clients' requests at Llama-3-8B's full width from its
    # shard of the same seeded tree. The unsharded references are computed
    # here first, each client closed before the ranks (started meanwhile)
    # serve.
    train_tp2_ranks = None
    if "mesh" in phases:
        from k_llms_tpu_torch.ops import w4matmul as w4

        t_mesh = time.perf_counter()
        store_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_tmp")
        os.makedirs(store_dir, exist_ok=True)
        int4_kw = dict(param_seed=args.seed, quantization="int4", paged_kv=False,
                       decode_attention_impl="flash")
        bf16_kw = dict(param_seed=args.seed, kv_pool_pages=128)
        sp_kw = dict(param_seed=args.seed, sp_prefill_min_tokens=1024, sp_decode=True,
                     prefix_cache_size=2)
        mesh_reqs = [requests[0], requests[2]]
        depth = {job: mesh_depth(job) for job in MESH_LAYERS}
        # The data axis's traffic: the sched phase's four same-config
        # requests (n = 8) sent at once, fused into one launch, then the
        # parse request; unsharded here, then on two data ranks.
        # A half-second batch window: the four threads fuse however they
        # are scheduled.
        dp2_kw, dp2_int4_kw = dict(bf16_kw, batch_window=0.5), dict(int4_kw, batch_window=0.5)
        # Speculation over the data axis: the spec phase's copy case (one
        # printable byte repeated, a +100 bias on it, greedy, 64 tokens) and
        # two sched requests fused into one sampled launch, sent at once
        # through a speculative int4 client (the copy case's bias keeps it a
        # launch of its own).
        dp2_spec_kw = dict(dp2_int4_kw, speculative="prompt_lookup", spec_lookahead=SPEC_K)
        copy_req = dict(messages=[{"role": "user", "content": "x" * 300}], n=8, temperature=0.0,
                        max_tokens=64, seed=1, logit_bias={str(ord("x")): 100.0})
        spec_reqs = [copy_req] + sched_requests[:2]
        # The continuous loop across the ranks: the loop phase's knobs and
        # traffic (A and the Record parse() D at once, B after 8 steps, the
        # chunked C after 16, a logit-bias request through the coalescing
        # path after 24), unsharded here; the chunk is pinned so that every
        # client runs the same shapes. The pool holds 256 pages (twice the
        # traffic's need): the loop's own worst-case pool (1185 pages at 32
        # layers, 9.3 GB) does not fit twice on the shared card beside two
        # ranks' weights and the parent's leftovers (first mesh call).
        mesh_loop_kw = dict(param_seed=args.seed, prefill_chunk_tokens=128, kv_pool_pages=256,
                            **loop_knobs)
        mesh_bias_req = dict(messages=[{"role": "user", "content": "Spell a word."}], n=8,
                             temperature=0.0, max_tokens=32, seed=7, logit_bias=printable)
        loop_job_args = {"client_kw": mesh_loop_kw, "reqs": loop_requests,
                         "bias_req": mesh_bias_req, "biased_at": 24}
        jobs = [
            {"name": "mesh_tp2_bf16", "kind": "serve",
             "args": {"client_kw": dict(bf16_kw, model_parallel=2), "reqs": mesh_reqs[:1],
                      "model": depth["tp2_bf16"]}},
            {"name": "mesh_sp2", "kind": "serve",
             "args": {"client_kw": sp_kw, "reqs": mesh_reqs[1:], "repeat_last": True,
                      "model": depth["sp2"]}},
            {"name": "mesh_sp2_ulysses", "kind": "serve",
             "args": {"client_kw": dict(sp_kw, sp_attention="ulysses"), "reqs": mesh_reqs[1:],
                      "model": depth["sp2"]}},
            {"name": "mesh_dp2", "kind": "serve",
             "args": {"client_kw": dp2_kw, "reqs": sched_requests, "concurrent": True,
                      "parse_req": parse_request, "model": depth["dp2"],
                      "http": dict(messages=[{"role": "user", "content": "Count to fifty."}],
                                   n=4, temperature=0.8, seed=41, max_tokens=24,
                                   logit_bias=printable)}},
            {"name": "mesh_dp2_int4", "kind": "serve",
             "args": {"client_kw": dp2_int4_kw, "reqs": sched_requests, "concurrent": True,
                      "parse_req": parse_request, "model": depth["dp2_int4"]}},
            {"name": "mesh_dp2_spec", "kind": "serve",
             "args": {"client_kw": dp2_spec_kw, "reqs": spec_reqs, "concurrent": True,
                      "model": depth["dp2_spec"]}},
            {"name": "mesh_dp2_loop", "kind": "loop",
             "args": dict(loop_job_args, model=depth["dp2_loop"])},
            {"name": "mesh_tp2_loop", "kind": "loop",
             "args": dict(loop_job_args, client_kw=dict(mesh_loop_kw, model_parallel=2),
                          model=depth["tp2_loop"])},
            {"name": "mesh_k4tp_mutants", "kind": "w4_tp",
             "args": {"shapes": [(4096, 4096), (14336, 4096)], "rows_list": [8, 2048]}},
            {"name": "mesh_psum_gloo", "kind": "psum",
             "args": {"shapes": [(8, 4096), (64, 4096), (2048, 4096)]}},
        ]
        if "train" in phases:
            # The train phase's two-rank step, in this world (one start-up
            # fewer); the train phase checks it.
            jobs.append({"name": "train_tp2", "kind": "train",
                         "args": dict(TRAIN_TP2_JOB, seed=args.seed)})
        # Last: its hung threads outlive each drill's rebuild.
        jobs.append(
            {"name": "mesh_rebuild", "kind": "rebuild",
             "args": {"client_kw": dict(int4_kw, continuous_batching=True, continuous_width=8,
                                        continuous_max_prompt=256, continuous_max_new=32,
                                        prefill_chunk_tokens=128, poison_threshold=0.5),
                      "coalesced_req": dict(sched_requests[0], max_tokens=16),
                      "loop_req": dict(messages=[{"role": "user", "content": "Count to ten."}],
                                       n=4, max_new=16, temperature=0.8, top_p=0.95, seed=9),
                      "budget_s": REBUILD_BUDGET_S, "model": depth["rebuild"]}})
        # The ranks start up (spawn, imports, the world's store) while the
        # unsharded references run here; they wait to serve until every
        # reference client is closed. The TP int4 job is a plain client of
        # this process, which starts its follower itself (mesh_spawned):
        # once the references are done (a process in a world builds no
        # unsharded client), its two ranks start, draw their shards and
        # serve while the hand-started ranks run their jobs, as the two host
        # processes of JAX's multi-process start (mesh_hosts, at 32 layers,
        # and its fault drill), the restart drill (a plain process of its
        # own, mesh_spawned_restart) and the fault drill do.
        handle = spawn_ranks(2, "gloo", jobs, store_dir)
        mesh_pool = ThreadPoolExecutor(max_workers=6)
        spawned_kw = dict(int4_kw, model_parallel=2)
        try:
            ref_hosts = mesh_serve(int4_kw, mesh_reqs, model=depth["hosts"])
            ref_int4 = mesh_serve(int4_kw, mesh_reqs, model=depth["spawned"])
            ref_bf16 = mesh_serve(bf16_kw, mesh_reqs[:1], model=depth["tp2_bf16"])
            ref_sp = mesh_serve(bf16_kw, mesh_reqs[1:], model=depth["sp2"])
            ref_dp2 = mesh_serve(dp2_kw, sched_requests, concurrent=True, parse_req=parse_request,
                                 model=depth["dp2"])
            ref_dp2_int4 = mesh_serve(dp2_int4_kw, sched_requests, concurrent=True,
                                      parse_req=parse_request, model=depth["dp2_int4"])
            ref_dp2_spec = mesh_serve(dp2_spec_kw, spec_reqs, concurrent=True,
                                      model=depth["dp2_spec"])
            ref_loop = mesh_loop(**loop_job_args, model=depth["dp2_loop"])
            ref_loop_tp = ref_loop if depth["tp2_loop"] == depth["dp2_loop"] else mesh_loop(
                **loop_job_args, model=depth["tp2_loop"])
            log({"phase": "mesh_references", "seconds": time.perf_counter() - t_mesh,
                 "layers": MESH_LAYERS,
                 "hosts_serve_s": ref_hosts["serve_s"],
                 "int4_serve_s": ref_int4["serve_s"], "bf16_serve_s": ref_bf16["serve_s"],
                 "sp_serve_s": ref_sp["serve_s"],
                 "dp2_bf16_serve_s": ref_dp2["serve_s"],
                 "dp2_int4_serve_s": ref_dp2_int4["serve_s"],
                 "dp2_spec_serve_s": ref_dp2_spec["serve_s"],
                 "loop_wall_s": ref_loop["wall_s"], "loop_stats": ref_loop["delta"],
                 "tp_loop_wall_s": ref_loop_tp["wall_s"],
                 "loop_steps_ms": ref_loop["steps_ms"],
                 "loop_peak_allocated_bytes": ref_loop["peak_allocated_bytes"],
                 "hosts_peak_bytes": ref_hosts["peak_bytes"],
                 "int4_peak_bytes": ref_int4["peak_bytes"],
                 "bf16_peak_bytes": ref_bf16["peak_bytes"],
                 "dp2_launches": [(ln["requests"], ln["rows"], ln["steps"])
                                  for ln in ref_dp2["launches"]]})
            gc.collect()
            torch.cuda.empty_cache()
            free_b, total_b = torch.cuda.mem_get_info()
            log({"phase": "mesh_before_ranks", "device_free_bytes": free_b,
                 "device_total_bytes": total_b, "allocated_bytes": torch.cuda.memory_allocated(),
                 "reserved_bytes": torch.cuda.memory_reserved(), "host": mesh_host_memory()})
            # A follower's fault (tiny, a world of its own) runs beside the
            # ranks' jobs; it is checked after them.
            fault_future = mesh_pool.submit(run_fault_drill, store_dir)
            # JAX's multi-process start: two host processes of two ranks
            # (the int4 TP job at 32 layers on a (2, 2) mesh), and its fault
            # drill at tiny.
            hosts_future = mesh_pool.submit(
                run_hosts, {"kind": "serve", "client_kw": spawned_kw, "reqs": mesh_reqs,
                            "model": depth["hosts"]})
            hosts_fault_future = mesh_pool.submit(run_hosts, {"kind": "fault"}, 300)
            restart_future = mesh_pool.submit(run_spawned_restart_drill)
            spawned_future = mesh_pool.submit(run_spawned_job, spawned_kw, mesh_reqs,
                                              depth["spawned"])
            t0 = time.perf_counter()
            ranks = collect_ranks(handle)
            ranks_s = time.perf_counter() - t0
            spawned = spawned_future.result(timeout=900)
            spawned_init_s = spawned["init_s"]
            ranks["mesh_spawned"] = [spawned] + spawned["followers"]
            hosts = hosts_future.result(timeout=900)
            for pid, host in enumerate(hosts):
                ranks[f"mesh_hosts_{pid}"] = [host] + host["followers"]
        finally:
            stop_ranks(handle)
            mesh_pool.shutdown(wait=False)
        train_tp2_ranks = ranks.pop("train_tp2", None)
        if ranks["_exitcodes"] != [0, 0]:
            raise AssertionError(f"mesh: the ranks ended with {ranks['_exitcodes']}")

        def rel_l2(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        def by_prompt(res, n_launches):
            """(launch, member, logits index) of each prompt in the first
            ``n_launches`` launches (the logits hook's order)."""
            out, k = {}, 0
            for j, ln in enumerate(res["launches"][:n_launches]):
                for m, ids in enumerate(ln["ids"]):
                    out[tuple(ids)] = (j, m, k)
                    k += 1
            return out

        # The serve, loop and rebuild jobs' failures, raised together once
        # the whole phase is checked.
        mesh_problems = []

        def check_serve(name, ref, n_launches, expected_fn):
            """The controller's first ``n_launches`` launches against the
            unsharded client's, member by member (matched by prompt: fused
            members may arrive in another order). Every rank's logits equal
            the controller's, and every rank's counts hold."""
            res = ranks[name]
            ctl = res[0]
            problems = []
            if ctl["role"] != "controller" or any(r["role"] != "follower" for r in res[1:]):
                problems.append(f"roles {[r['role'] for r in res]}")
            for r in res[1:]:
                if not all(np.array_equal(a, b) for a, b in zip(r["logits"], ctl["logits"])):
                    problems.append("ranks' logits differ")
                if r["plans"] != ctl["plans"]:
                    problems.append(f"follower ran {r['plans']} plans, controller sent {ctl['plans']}")
            per_req = []
            theirs_at = by_prompt(ref, len(ref["launches"]))
            for ids, (i, m, k) in by_prompt(ctl, n_launches).items():
                j, rm, rk = theirs_at[ids]
                mine = ctl["launches"][i]["tokens"][m]
                theirs = ref["launches"][j]["tokens"][rm]
                first_equal = bool(np.array_equal(mine[:, 0], theirs[:, 0]))
                err = rel_l2(ctl["logits"][k], ref["logits"][rk])
                per_req.append({"launch": i, "member": m, "prompt_tokens": len(ids),
                                "first_tokens_equal": first_equal,
                                "token_agreement": float((mine == theirs).mean()),
                                "logits_rel_l2": err})
                if not first_equal:
                    problems.append(f"launch {i} member {m}: first tokens differ from the "
                                    "unsharded client's")
                if not err <= MESH_LOGITS_REL_L2:
                    problems.append(f"launch {i} member {m}: logits rel L2 {err} > "
                                    f"{MESH_LOGITS_REL_L2}")
            expected = expected_fn(ctl)
            for r in res:
                got = {key: (r["counts"] | r["collectives"])[key] for key in expected}
                if got != expected:
                    problems.append(f"{r['role']} counts {got} != expected {expected}")
            peaks = [r["peak_bytes"] for r in res]
            rec = {"phase": name, "mesh": ctl["mesh"], "transport": ctl["transport"],
                   "layers": ctl["L"], "requests": per_req, "expected_counts": expected,
                   "counts": [r["counts"] for r in res], "collectives": [r["collectives"] for r in res],
                   "plans": [r["plans"] for r in res],
                   "cache_stats": ctl["cache_stats"], "rank_peak_bytes": peaks,
                   "rank_param_bytes": [r["param_bytes"] for r in res],
                   "rank_allocated_before_bytes": [r["allocated_before_bytes"] for r in res],
                   "rank_host": [r["host"] for r in res], "rank_job_s": [r["job_s"] for r in res],
                   "init_s": ctl["init_s"], "serve_s": ctl["serve_s"],
                   "launch_rows": [(ln["requests"], ln["rows"], ln["rank_rows"])
                                   for ln in ctl["launches"]],
                   "prefill_ms": [ln["prefill_s"] * 1e3 for ln in ctl["launches"]],
                   "decode_ms_per_step": [ln["decode_s"] * 1e3 / max(ln["steps"], 1)
                                          for ln in ctl["launches"]],
                   "unsharded_prefill_ms": [ln["prefill_s"] * 1e3 for ln in ref["launches"]],
                   "unsharded_decode_ms_per_step": [ln["decode_s"] * 1e3 / max(ln["steps"], 1)
                                                    for ln in ref["launches"]],
                   "consensus": [o["texts"][0] for o in ctl["outs"]]}
            if sum(peaks) >= 80e9:
                problems.append(f"summed rank peaks {sum(peaks)} >= 80 GB")
            rec["ok"] = not problems
            log(rec)
            if problems:  # raised once every job is checked
                mesh_problems.append(f"{name}: {problems}")
            return res

        def forwards(res):
            lns, E = res["launches"], len(res["embeds"])
            prefills = sum(ln["requests"] for ln in lns)
            steps = sum(ln["steps"] for ln in lns)
            return res["L"], lns, E, prefills, steps

        def loop_tests(ctl, res, name):
            """The decode loop's per-step max over the mesh (its loop test,
            which carries the aborts) on rank ``res``: one a step of the
            controller's launches, and one more where the rows finished
            before max_tokens; none on an axis of one."""
            lns = ctl["launches"]
            steps = sum(ln["steps"] for ln in lns)
            got = res["collectives"]["pmax"]
            if not steps <= got <= steps + len(lns):
                raise AssertionError(f"{name}: {got} loop tests for {steps} steps")
            return got

        def expected_tp_int4(res):
            L, lns, E, prefills, steps = forwards(res)
            gated = sum(ln["steps"] for ln in lns if ln["n_per"] * 4 >= 8)
            k4 = (7 * L + 1) * (prefills + steps) + 7 * L * E
            return {"flash_attention": L * (prefills + E), "decode_prefix_attention": L * gated,
                    "paged_decode_attention": 0, "w4_matmul": k4,
                    "psum": (2 * L + 1) * (prefills + steps + E),
                    "all_gather": prefills + steps, "ppermute": 0, "all_to_all": 0}

        def expected_tp_bf16(res):
            L, lns, E, prefills, steps = forwards(res)
            return {"flash_attention": L * (prefills + E), "paged_decode_attention": L * steps,
                    "decode_prefix_attention": 0, "w4_matmul": 0,
                    "psum": (2 * L + 1) * (prefills + steps + E),
                    "all_gather": prefills + steps, "ppermute": 0, "all_to_all": 0}

        def expected_sp(ulysses):
            def fn(res):
                L, lns, E, _, steps = forwards(res)
                sp_prefills = res["cache_stats"]["misses"]
                return {"flash_attention": L * (E + (sp_prefills if ulysses else 0)),
                        "paged_decode_attention": 0, "decode_prefix_attention": 0,
                        "w4_matmul": 0, "psum": sp_prefills,
                        "ppermute": L * (steps + (0 if ulysses else sp_prefills)),
                        "all_gather": len(lns), "all_to_all": 4 * L * sp_prefills if ulysses else 0}
            return fn

        def expected_dp2_spec(res):
            """Each data rank of a speculative int4 client, per launch: K2
            once a layer per prefill (replicated) and embeddings forward;
            K4 (7 a layer and the head) per prefill and per verify iteration
            on its B/2 rows (the route by its verify rows); no K1, no K3
            (K + 1 queries a row); a draw per sampled iteration and the first
            token's; one gather of the results and counts a launch."""
            L, lns, E, prefills, steps = forwards(res)
            return {"flash_attention": L * (prefills + E), "paged_decode_attention": 0,
                    "decode_prefix_attention": 0,
                    "w4_matmul": (7 * L + 1) * (prefills + steps) + 7 * L * E,
                    "threefry_uniform_rows": draws(lns), "all_gather": len(lns), "gather": 0,
                    "psum": 0, "ppermute": 0, "all_to_all": 0}

        def draws(lns):
            return sum(ln["steps"] + 1 for ln in lns if ln["temperature"] != 0.0)

        def expected_hosts(res):
            """Each rank of the (2, 2) world of two host processes: the TP
            int4 counts on its data rank's B/2 rows (K3 where the gate takes
            them), a draw per sampled step, and one result gather over
            ``data`` a launch beside the model axis's logits gathers."""
            L, lns, E, prefills, steps = forwards(res)
            out = expected_tp_int4(res)
            out.update(all_gather=prefills + steps + len(lns), threefry_uniform_rows=draws(lns))
            return out

        def expected_dp2(int4):
            """Each data rank, per launch of B rows: K2 once a layer per
            prefill (replicated) and per embeddings forward; on its B/2 rows
            K1 once a layer per step (bf16 paged) or K3 where n_per * G >= 8
            and K4 (7 a layer and the head) per step (int4 dense); a draw
            per sampled step; one gather of the results a launch."""
            def fn(res):
                L, lns, E, prefills, steps = forwards(res)
                out = {"flash_attention": L * (prefills + E), "threefry_uniform_rows": draws(lns),
                       "all_gather": len(lns), "gather": 0, "psum": 0, "ppermute": 0,
                       "all_to_all": 0}
                if int4:
                    gated = sum(ln["steps"] for ln in lns if ln["n_per"] * 4 >= 8)
                    out.update(paged_decode_attention=0, decode_prefix_attention=L * gated,
                               w4_matmul=(7 * L + 1) * (prefills + steps) + 7 * L * E)
                else:
                    out.update(paged_decode_attention=L * steps, decode_prefix_attention=0,
                               w4_matmul=0)
                return out
            return fn

        check_serve("mesh_spawned", ref_int4, 2, expected_tp_int4)
        spawned_close = spawned["world_close"]
        spawned_ok = (spawned["mesh"] == {"data": 1, "model": 2}
                      and spawned["transport"] == "gloo"
                      and spawned_close["exit_codes"] == [0] and spawned_close["alive"] == []
                      and spawned["followers"][0]["pid"] != os.getpid())
        log({"phase": "mesh_spawned_world", "init_s": spawned_init_s,
             "serve_s": spawned["serve_s"], "job_s": spawned["job_s"],
             "close": spawned_close, "ok": spawned_ok})
        if not spawned_ok:
            raise AssertionError(f"mesh_spawned: {spawned['mesh']} {spawned_close}")
        # JAX's multi-process start: each host's ranks by formula against
        # the unsharded 32-layer client, both hosts' responses equal, the
        # world host-major, every close exit 0.
        hosts_problems = []
        hosts_checked = []
        for pid, host in enumerate(hosts):
            res = check_serve(f"mesh_hosts_{pid}", ref_hosts, 2, expected_hosts)
            hosts_checked.append(res)
            lns = host["launches"]
            steps = sum(ln["steps"] for ln in lns)
            for r in res:
                # The loop test's pmax: one over each axis a step.
                if not 2 * steps <= r["collectives"]["pmax"] <= 2 * (steps + len(lns)):
                    hosts_problems.append(f"host {pid}: {r['collectives']['pmax']} pmax for "
                                          f"{steps} steps")
            place = host["place"]
            if (place["world"] != HOSTS * HOST_RANKS or place["rank"] != pid * HOST_RANKS
                    or place["host_ranks"] != list(range(pid * HOST_RANKS, (pid + 1) * HOST_RANKS))
                    or place["transport"] != "gloo" or host["mesh"] != {"data": 2, "model": 2}):
                hosts_problems.append(f"host {pid}: place {place}, mesh {host['mesh']}")
            if any(ln["rank_rows"] * 2 != ln["rows"] for ln in lns):
                hosts_problems.append(f"host {pid}: rows {[(ln['rows'], ln['rank_rows']) for ln in lns]}")
            close = host["world_close"]
            if close["exit_codes"] != [0] or close["alive"] or host["exit_code"] != 0:
                hosts_problems.append(f"host {pid}: close {close}, exit {host['exit_code']}")
        if [o["texts"] for o in hosts[0]["outs"]] != [o["texts"] for o in hosts[1]["outs"]]:
            hosts_problems.append("the hosts' responses differ")
        log({"phase": "mesh_hosts_world", "layers": hosts[0]["L"],
             "start_s": [h["place"]["start_s"] for h in hosts],
             "init_s": [h["init_s"] for h in hosts], "serve_s": [h["serve_s"] for h in hosts],
             "job_s": [h["job_s"] for h in hosts],
             "decode_ms_per_step": [[ln["decode_s"] * 1e3 / max(ln["steps"], 1)
                                     for ln in h["launches"]] for h in hosts],
             "unsharded_decode_ms_per_step": [ln["decode_s"] * 1e3 / max(ln["steps"], 1)
                                              for ln in ref_hosts["launches"]],
             "rank_peak_bytes": [[r["peak_bytes"] for r in [h] + h["followers"]] for h in hosts],
             "close": [h["world_close"] for h in hosts],
             "exit_codes": [h["exit_code"] for h in hosts], "ok": not hosts_problems})
        if hosts_problems:
            raise AssertionError(f"mesh_hosts: {hosts_problems}")
        hosts_fault_rec = hosts_fault_future.result(timeout=300)
        killed_at = hosts_fault_rec[0]["killed_at"]
        fault_ok = (killed_at is not None
                    and hosts_fault_rec[0]["first"] == hosts_fault_rec[1]["first"])
        for h in hosts_fault_rec:
            err, after = h["error"] or {}, h["after"] or {}
            h["error_s"] = err.get("at", float("inf")) - (killed_at or 0.0)
            h["stop_s"] = h["stopped_at"] - (killed_at or 0.0)
            fault_ok = fault_ok and (h["state"] == "stopped" and h["stop_s"] <= HOSTS_STOP_LIMIT_S
                                     and err.get("typed") and err.get("status") == 503
                                     and h["error_s"] <= HOSTS_STOP_LIMIT_S
                                     and after.get("typed") and after.get("status") == 503
                                     and h["world_close"]["alive"] == [] and h["exit_code"] == 0)
        log({"phase": "mesh_hosts_fault", "limit_s": HOSTS_STOP_LIMIT_S,
             "error_s": [h["error_s"] for h in hosts_fault_rec],
             "stop_s": [h["stop_s"] for h in hosts_fault_rec],
             "errors": [h["error"] for h in hosts_fault_rec],
             "after": [h["after"] for h in hosts_fault_rec],
             "after_s": [h["after_s"] for h in hosts_fault_rec],
             "states": [h["state"] for h in hosts_fault_rec],
             "close": [h["world_close"] for h in hosts_fault_rec],
             "exit_codes": [h["exit_code"] for h in hosts_fault_rec], "ok": fault_ok})
        if not fault_ok:
            raise AssertionError(f"mesh_hosts_fault: {hosts_fault_rec}")
        # A follower of a world the controller's process started, killed
        # while idle and during a launch: the world starts again.
        restart = restart_future.result()
        launch_error = restart["launch_error"] or {}
        restart_ok = (restart["idle_equal"] and restart["after_equal"]
                      and launch_error.get("type") == "FollowerFaultError"
                      and launch_error.get("status") == 503
                      and launch_error.get("seconds", FAULT_LIMIT_S + 1) <= FAULT_LIMIT_S
                      and restart["state"] == "ready" and restart["world"]["restarts"] == 2
                      and restart["close"]["exit_codes"] == [0] and restart["close"]["alive"] == []
                      and restart["exit_code"] == 0)
        log(dict(restart, phase="mesh_spawned_restart", limit_s=FAULT_LIMIT_S, ok=restart_ok))
        if not restart_ok:
            raise AssertionError(f"mesh_spawned_restart: {restart}")
        check_serve("mesh_tp2_bf16", ref_bf16, 1, expected_tp_bf16)
        sp = check_serve("mesh_sp2", ref_sp, 1, expected_sp(False))
        sp_outs = sp[0]["outs"]
        if sp[0]["cache_stats"] != {"hits": 1, "partial_hits": 0, "misses": 1} or \
                sp_outs[1]["texts"] != sp_outs[0]["texts"]:
            raise AssertionError(f"mesh_sp2: the exact hit {sp[0]['cache_stats']} or its texts")
        sp_u = check_serve("mesh_sp2_ulysses", ref_sp, 1, expected_sp(True))
        # The ring decode splits its rows over the ring's axis (JAX's q_spec).
        for name, res in (("mesh_sp2", sp), ("mesh_sp2_ulysses", sp_u)):
            lns = res[0]["launches"]
            tests = [loop_tests(res[0], r, name) for r in res]
            log({"phase": f"{name}_rows", "launch_rows": [(ln["rows"], ln["rank_rows"]) for ln in lns],
                 "loop_tests": tests})
            if any(ln["rank_rows"] * 2 != ln["rows"] for ln in lns):
                raise AssertionError(f"{name}: rows {[(ln['rows'], ln['rank_rows']) for ln in lns]}")
        dp_tests = {}
        for name, ref, int4 in (("mesh_dp2", ref_dp2, False), ("mesh_dp2_int4", ref_dp2_int4, True)):
            res = check_serve(name, ref, len(ref["launches"]), expected_dp2(int4))
            ctl = res[0]
            fused = [ln["requests"] for ln in ctl["launches"]]
            if fused != [4, 1] or any(ln["rank_rows"] * 2 != ln["rows"] for ln in ctl["launches"]):
                raise AssertionError(f"{name}: launches {fused}, rows "
                                     f"{[(ln['rows'], ln['rank_rows']) for ln in ctl['launches']]}")
            dp_tests[name] = [loop_tests(ctl, r, name) for r in res]
        spec = check_serve("mesh_dp2_spec", ref_dp2_spec, len(ref_dp2_spec["launches"]),
                           expected_dp2_spec)
        lns = spec[0]["launches"]
        spec_tests = [loop_tests(spec[0], r, "mesh_dp2_spec") for r in spec]
        log({"phase": "mesh_dp2_spec_rows",
             "launches": [(ln["requests"], ln["rows"], ln["rank_rows"], ln["steps"]) for ln in lns],
             "unsharded_launches": [(ln["requests"], ln["rows"], ln["steps"])
                                    for ln in ref_dp2_spec["launches"]],
             "loop_tests": spec_tests})
        if sorted(ln["requests"] for ln in lns) != [1, 2] or any(
                ln["rank_rows"] * 2 != ln["rows"] for ln in lns):
            raise AssertionError(f"mesh_dp2_spec: launches {[(ln['requests'], ln['rows'], ln['rank_rows']) for ln in lns]}")
        http = ranks["mesh_dp2"][0]["http"]
        fol_snap = ranks["mesh_dp2"][1]["snapshots"]
        serve_ok = (http["concurrent"]["plain_status"] == 200
                    and http["concurrent"]["stream_status"] == 200
                    and http["concurrent"]["stream_done"] and http["next_status"] == 200
                    and http["abort"]["aborted"] and http["abort"]["decode_steps"] < 255
                    and len(fol_snap) == 1 and fol_snap[0]["aborted"] == http["abort"]["aborted"]
                    and fol_snap[0]["decode_steps"] == http["abort"]["decode_steps"])
        log({"phase": "mesh_dp2_serve", "http": http, "follower_snapshot": fol_snap,
             "loop_tests": dp_tests, "follower_exit_code": ranks["_exitcodes"][1], "ok": serve_ok})
        if not serve_ok:
            raise AssertionError(f"mesh_dp2_serve: {http} / follower {fol_snap}")
        def loop_expected(ctl, tp):
            """Each rank's window counts, by formula from the controller's
            loop counters and coalesced launch: K2 a layer per whole
            admission, chunk, coalesced prefill and embeddings forward; K1 a
            layer per loop step and coalesced step (every slot's rows on
            every rank); a draw per loop step and admission and per sampled
            coalesced step; under TP the Megatron psums of every forward and
            one logits gather per forward with a head; over the data axis
            one gather of the coalesced results."""
            L, d, lns, E = ctl["L"], ctl["delta"], ctl["launches"], len(ctl["embeds"])
            chunked = sum(1 for n in ctl["prompt_tokens"].values()
                          if n > ctl["prefill_chunk_tokens"])
            whole = d["admitted"] - chunked
            co_req = sum(ln["requests"] for ln in lns)
            co_steps = sum(ln["steps"] for ln in lns)
            headed = whole + d["prefill_chunks"] + d["steps"] + co_req + co_steps
            return {"flash_attention": L * (whole + d["prefill_chunks"] + co_req + E),
                    "paged_decode_attention": L * (d["steps"] + co_steps),
                    "decode_prefix_attention": 0, "w4_matmul": 0,
                    "threefry_uniform_rows": d["steps"] + d["admitted"] + sum(
                        ln["steps"] + 1 for ln in lns if ln["temperature"] != 0.0),
                    "psum": (2 * L + 1) * (headed + E) if tp else 0,
                    "all_gather": headed if tp else len(lns),
                    "ppermute": 0, "all_to_all": 0}

        def check_loop(name, tp, ref_loop):
            """The loop across two ranks against the unsharded loop: on the
            data axis every loop request's tokens identical (each data rank
            decodes every slot); under TP first tokens equal and the
            prompts' last-position logits within MESH_LOGITS_REL_L2; the
            coalesced request's first tokens equal (its rows split over
            data: PR 18's rule); every rank's counts by formula, one pmax a
            loop step (and a coalesced loop test), the same plans and loop
            counters on both ranks, no restart."""
            res = ranks[name]
            ctl = res[0]
            problems = []
            if ctl["role"] != "controller" or any(r["role"] != "follower" for r in res[1:]):
                problems.append(f"roles {[r['role'] for r in res]}")
            for r in res[1:]:
                if r["plans"] != ctl["plans"]:
                    problems.append(f"follower ran {r['plans']} plans, controller sent {ctl['plans']}")
                if r["loop_stats"] != ctl["loop_stats"]:
                    problems.append(f"follower loop {r['loop_stats']} != {ctl['loop_stats']}")
                if r["pool"] != ctl["pool"]:
                    problems.append(f"follower pool {r['pool']} != {ctl['pool']}")
            if ctl["delta"]["restarts"] != 0 or ctl["loop_stats"]["restarts"] != 0:
                problems.append(f"restarts {ctl['delta']['restarts']}")
            if ctl["labels"] != ref_loop["labels"]:
                problems.append(f"requests {ctl['labels']} vs {ref_loop['labels']}")
            per_req = {}
            for k, label in enumerate(ctl["labels"]):
                mine, theirs = ctl["tokens"][label], ref_loop["tokens"][label]
                err = rel_l2(ctl["logits"][k], ref_loop["logits"][k])
                per_req[label] = {"identical": bool(np.array_equal(mine, theirs)),
                                  "first_tokens_equal": bool(np.array_equal(mine[:, 0], theirs[:, 0])),
                                  "token_agreement": float((mine == theirs).mean()),
                                  "logits_rel_l2": err}
                if not per_req[label]["first_tokens_equal"]:
                    problems.append(f"{label}: first tokens differ from the unsharded loop's")
                if not tp and not per_req[label]["identical"]:
                    problems.append(f"{label}: tokens differ from the unsharded loop's")
                if tp and not err <= MESH_LOGITS_REL_L2:
                    problems.append(f"{label}: logits rel L2 {err} > {MESH_LOGITS_REL_L2}")
            co = None
            if len(ctl["launches"]) != 1 or len(ref_loop["launches"]) != 1:
                problems.append(f"coalesced launches {len(ctl['launches'])}")
            else:
                mine, theirs = ctl["launches"][0]["tokens"][0], ref_loop["launches"][0]["tokens"][0]
                co = {"first_tokens_equal": bool(np.array_equal(mine[:, 0], theirs[:, 0])),
                      "token_agreement": float((mine == theirs).mean()),
                      "rows": ctl["launches"][0]["rows"], "rank_rows": ctl["launches"][0]["rank_rows"]}
                if not co["first_tokens_equal"]:
                    problems.append("the coalesced request's first tokens differ")
            expected = loop_expected(ctl, tp)
            lns = ctl["launches"]
            co_steps = sum(ln["steps"] for ln in lns)
            for r in res:
                got = {key: (r["counts"] | r["collectives"])[key] for key in expected}
                if got != expected:
                    problems.append(f"{r['role']} counts {got} != expected {expected}")
                pm = r["collectives"]["pmax"] - ctl["delta"]["steps"]
                if not co_steps <= pm <= co_steps + len(lns):
                    problems.append(f"{r['role']}: {r['collectives']['pmax']} pmax for "
                                    f"{ctl['delta']['steps']} loop steps")
            ref_expected = {k: v for k, v in loop_expected(ref_loop, False).items()
                            if k in ref_loop["counts"]}
            if {k: ref_loop["counts"][k] for k in ref_expected} != ref_expected:
                problems.append(f"unsharded counts {ref_loop['counts']} != {ref_expected}")
            peaks = [r["peak_allocated_bytes"] for r in res]
            rec = {"phase": name, "mesh": ctl["mesh"], "layers": ctl["L"], "requests": per_req,
                   "coalesced": co,
                   "stats": ctl["delta"], "unsharded_stats": ref_loop["delta"],
                   "width": ctl["width"], "prefill_chunk_tokens": ctl["prefill_chunk_tokens"],
                   "memory_model": ctl["memory_model"],
                   "unsharded_memory_model": ref_loop["memory_model"],
                   "expected_counts": expected, "counts": [r["counts"] for r in res],
                   "collectives": [r["collectives"] for r in res],
                   "plans": [r["plans"] for r in res],
                   "steps_ms_by_active_rows": [r["steps_ms"] for r in res],
                   "unsharded_steps_ms_by_active_rows": ref_loop["steps_ms"],
                   "pool": [r["pool"] for r in res],
                   "rank_peak_allocated_bytes": peaks,
                   "rank_peak_reserved_bytes": [r["peak_reserved_bytes"] for r in res],
                   "rank_param_bytes": [r["param_bytes"] for r in res],
                   "rank_job_s": [r["job_s"] for r in res], "init_s": ctl["init_s"],
                   "wall_s": ctl["wall_s"], "unsharded_wall_s": ref_loop["wall_s"],
                   "consensus": ctl["consensus"]}
            if sum(peaks) >= 80e9:
                problems.append(f"summed rank peaks {sum(peaks)} >= 80 GB")
            rec["ok"] = not problems
            log(rec)
            if problems:
                mesh_problems.append(f"{name}: {problems}")

        check_loop("mesh_dp2_loop", False, ref_loop)
        check_loop("mesh_tp2_loop", True, ref_loop_tp)
        # A follower's fault: tiny on two ranks of the card, the follower's
        # first launch raising a kernel error; the controller's request ends
        # as the typed 503 within FAULT_LIMIT_S, the world stays stopped.
        fault, codes = fault_future.result()
        from k_llms_tpu_torch.parallel.controller import FOLLOWER_FAULT_EXIT

        fault_ok = (isinstance(fault, list) and codes == [0, FOLLOWER_FAULT_EXIT]
                    and all(e is not None and e["type"] == "KernelUnavailableError"
                            and e["status"] == 503 and e["seconds"] <= FAULT_LIMIT_S
                            for e in fault))
        log({"phase": "mesh_dp2_fault", "errors": fault, "exit_codes": codes,
             "limit_s": FAULT_LIMIT_S, "ok": fault_ok})
        if not fault_ok:
            raise AssertionError(f"mesh_dp2_fault: {fault} exit codes {codes}")
        # The rebuilds across the two ranks: each drill's request resolves
        # with the uninterrupted run's tokens; the supervisor, the loop and
        # both ranks count every rebuild; both ranks ran every plan.
        rb_ctl, rb_fol = ranks["mesh_rebuild"]
        want = {"hung_launch": (1, 1, 0, "hung_launch", 1),
                "poison_escalation": (1, 2, 0, "poison_rate", 2),
                "loop_hung_step": (1, 2, 1, "poison_rate", 3)}
        problems = []
        for d in rb_ctl["drills"]:
            got = (d["hung_launches"], d["rebuilds"], d["loop_restarts"], d["last_rebuild_reason"],
                   d["world_rebuilds"])
            if got != want[d["drill"]] or not d["tokens_equal"] or d["error"] is not None \
                    or d["state"] != "ready" or d.get("texts_equal") is False:
                problems.append(f"{d['drill']}: {d}")
        if [d["drill"] for d in rb_ctl["drills"]] != list(want):
            problems.append(f"drills {[d['drill'] for d in rb_ctl['drills']]}")
        if rb_fol["plans"] != rb_ctl["plans"] or rb_fol["rebuilds"] != rb_ctl["rebuilds"] != 3:
            problems.append(f"plans {rb_fol['plans']}/{rb_ctl['plans']}, rebuilds "
                            f"{rb_fol['rebuilds']}/{rb_ctl['rebuilds']}")
        if rb_ctl["stopped"] is not None:
            problems.append(f"the world stopped: {rb_ctl['stopped']}")
        peaks = [r["peaks"] for r in (rb_ctl, rb_fol)]
        if any(set(p) != {"uninterrupted", *want} for p in peaks):
            problems.append(f"peaks {peaks}")
        log({"phase": "mesh_rebuild", "drills": rb_ctl["drills"], "plans": [rb_ctl["plans"],
             rb_fol["plans"]], "rebuilds": [rb_ctl["rebuilds"], rb_fol["rebuilds"]],
             "supervisor": rb_ctl["supervisor"], "loop_stats": rb_ctl["loop_stats"],
             "rank_peak_bytes": peaks, "param_bytes": rb_ctl["param_bytes"],
             "counts": [rb_ctl["counts"], rb_fol["counts"]], "init_s": rb_ctl["init_s"],
             "job_s": [rb_ctl["job_s"], rb_fol["job_s"]], "budget_s": REBUILD_BUDGET_S,
             "ok": not problems})
        if problems:
            mesh_problems.append(f"mesh_rebuild: {problems}")
        mut = ranks["mesh_k4tp_mutants"][0]["cases"]
        log({"phase": "mesh_k4tp_mutants", "cases": mut})
        if not all(c["err_over_limit"] <= 1.0 < c["mutant_err_over_limit"] for c in mut):
            raise AssertionError(f"mesh_k4tp_mutants: {mut}")
        psum_gloo = ranks["mesh_psum_gloo"][0]["psum"]
        log({"phase": "mesh_psum", "transport": "gloo (host time, staged through host memory)",
             "cases": psum_gloo})

        # A world of one over nccl on device tensors (the path of a machine
        # with a card per rank).
        nccl = run_ranks(1, "nccl", [{"name": "nccl_one", "kind": "nccl_one", "args": {
            "shapes": [(4096, 2048), (2048, 4096), (4096, 64128)], "rows_list": [8, 2048]}}],
            store_dir)["nccl_one"][0]
        log({"phase": "mesh_nccl1", **nccl})
        if not all(all(v.values()) for v in nccl["identity"].values()) or \
                not all(c["bit_equal"] for c in nccl["w4_tp"]):
            raise AssertionError(f"mesh_nccl1: {nccl}")

        # K4 at every Llama-3-8B shard shape of TP = 2, against its plain
        # version, timed as the k4 phase times K4.
        shard_shapes = {"wq": (4096, 2048), "wk_wv": (4096, 512), "w_gate_up": (4096, 7168),
                        "lm_head": (4096, 64128), "wo": (2048, 4096), "w_down": (7168, 4096)}
        k4tp_cases = []
        for sname, (K, N) in shard_shapes.items():
            q = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8)
            scale = (torch.rand((K // 128, N), generator=gen, device=dev) + 0.5) / (4.61 * math.sqrt(K))
            w = w4.Q4Tensor(q, scale)
            deq = w4.unpack_int4(w)
            w_bf16 = deq.to(torch.bfloat16)
            n4 = copies_for(K * N // 2 + K // 128 * N * 4)
            nb = copies_for(K * N * 2)
            cold4 = [w4.Q4Tensor(torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev,
                                               dtype=torch.int8), scale) for _ in range(n4)]
            coldb = [w_bf16.clone() for _ in range(nb)]
            for rows in (8, 2048):
                x = randn(rows, K)
                out = w4.w4_matmul(x, w)
                torch.cuda.synchronize()
                ref = w4.w4_matmul_plain(x, w).float()
                terms = x.float().abs() @ deq.abs()
                ratio = ((out.float() - ref).abs()
                         / (2.0 ** -6 * ref.abs() + 1e-5 * terms + 1e-30)).max().item()
                flops = 2.0 * rows * K * N
                nbytes = x.numel() * 2 + q.numel() + scale.numel() * 4 + out.numel() * 2
                b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                rec = {"shard": sname, "rows": rows, "K": K, "N": N,
                       "route": w4.w4_route(rows, K, N, torch.bfloat16),
                       "ksplit": w4.split_k(rows, K, N), "max_abs_err": (out.float() - ref).abs().max().item(),
                       "max_err_over_limit": ratio,
                       "ms": time_ms(lambda: w4.w4_matmul(x, w)),
                       "device_ms": device_ms([lambda wc=wc: w4.w4_matmul(x, wc) for wc in cold4]),
                       "plain_ms": time_ms(lambda: w4.w4_matmul_plain(x, w), iters=3, warmup=1),
                       "library_ms": time_ms(lambda: torch.matmul(x, w_bf16)),
                       "library_device_ms": device_ms([lambda wb=wb: torch.matmul(x, wb)
                                                       for wb in coldb]),
                       "bound_ms": b_ms, "bound_by": b_by, "rotation": {"w4": n4, "bf16": nb}}
                k4tp_cases.append(rec)
                log(dict(rec, phase="mesh_k4tp"))
                if not ratio <= 1.0:
                    raise AssertionError(f"mesh_k4tp {sname} rows={rows}: {ratio} x the limit")
            del w, deq, w_bf16, cold4, coldb
            torch.cuda.empty_cache()
        main_case = next(c for c in k4tp_cases if c["shard"] == "w_down" and c["rows"] == 8)
        kernels["w4_matmul_tp"] = {
            "name": "w4_matmul_tp", "route": "cuda", "source": "k_llms_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "k_llms_tpu/ops/w4matmul.py:223",
            # K4 a rank in the window of JAX's multi-process start.
            "launches": hosts_checked[0][0]["counts"]["w4_matmul"],
            "max_abs_err": max(c["max_abs_err"] for c in k4tp_cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "device_ms": main_case["device_ms"],
            "case": "w_down shard [7168, 4096] at 8 rows, K4 on the shard (the row split's psum "
                    "is timed apart)",
            "shard_cases": k4tp_cases,
            "psum_host_ms": {"gloo": psum_gloo, "nccl_world_of_one_2048x4096":
                             nccl["psum_2048x4096_host_ms"]}}
        if mesh_problems:
            raise AssertionError("mesh: " + "; ".join(mesh_problems))
        log({"phase": "mesh_done", "seconds": time.perf_counter() - t_mesh, "ranks_s": ranks_s})

    # 13. The causal-LM train step (last: it must not move an earlier
    # phase's memory). (a) tiny fp32 on the card against the CPU; (b) the
    # 8B widths at 8 layers in bf16, five steps; (f) that trained tree
    # served through the kernels; (c) 2 layers in f32, the card's loss and
    # gradient norms against the CPU's; (d) the flash config refused before
    # any allocation; (e) two ranks on the one card over gloo, TP (1, 2).
    if "train" in phases:
        from k_llms_tpu_torch.engine.engine import LocalEngine
        from k_llms_tpu_torch.engine.training import UntrainableError, make_train_step
        from k_llms_tpu_torch.models.config import get_config
        from k_llms_tpu_torch.models.llama import (init_params, params_from_numpy,
                                                   params_to_numpy)

        t_train = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()

        # (a) tiny fp32: three steps on the card and three on the CPU.
        t0 = time.perf_counter()
        tiny_cfg = get_config("tiny")
        host_tree = init_params(tiny_cfg, torch.Generator().manual_seed(args.seed), "cpu")
        card_tree = tree_to(host_tree, dev)
        tokens, mask = train_batch(tiny_cfg, 4, 32, 19, args.seed)
        init_state, step = make_train_step(tiny_cfg)
        opt_h, opt_c = init_state(host_tree), init_state(card_tree)
        losses = []
        for _ in range(3):
            _, _, lh = step(host_tree, opt_h, tokens, mask)
            _, _, lc = step(card_tree, opt_c, tokens, mask)
            losses.append((lc.item(), lh.item()))
        param_err = max((card_tree["layers"][k].cpu() - v).abs().max().item()
                        for k, v in host_tree["layers"].items())
        for key in ("embed", "final_norm", "lm_head"):
            param_err = max(param_err, (card_tree[key].cpu() - host_tree[key]).abs().max().item())
        loss_err = max(abs(c - h) / abs(h) for c, h in losses)
        log({"phase": "train_tiny", "losses_card_cpu": losses, "loss_rel_err": loss_err,
             "param_max_abs_err": param_err, "loss_limit": TRAIN_F32_LOSS_RTOL,
             "param_limit": TRAIN_F32_PARAM_ATOL, "card_device": str(lc.device),
             "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
        if not (loss_err <= TRAIN_F32_LOSS_RTOL and param_err <= TRAIN_F32_PARAM_ATOL
                and lc.device.type == "cuda"):
            raise AssertionError(f"train tiny: card against CPU {loss_err}, {param_err}")
        del host_tree, card_tree, opt_h, opt_c

        # (b) Llama-3-8B widths, 8 of 32 layers, bf16, five steps on one batch.
        t0 = time.perf_counter()
        cfg8 = train_config(8, "bfloat16")
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tree8 = init_params(cfg8, torch.Generator(device=dev).manual_seed(args.seed), dev)
        tokens, mask = train_batch(cfg8, 2, 512, 384, args.seed)
        init_state, step = make_train_step(cfg8)
        opt8 = init_state(tree8)
        wq0 = tree8["layers"]["wq"][0].clone()
        losses, step_s = [], []
        for _ in range(5):
            t1 = time.perf_counter()
            tree8, opt8, loss = step(tree8, opt8, tokens, mask)
            losses.append(loss.item())
            step_s.append(time.perf_counter() - t1)
        changed = int((tree8["layers"]["wq"][0] != wq0).sum().item())
        n_params = sum(p.numel() for g in opt8.param_groups for p in g["params"])
        rec = {"phase": "train_8b", "layers": cfg8.num_layers, "dtype": cfg8.dtype,
               "batch": [2, 512], "valid_tokens": int(mask.sum()), "params": n_params,
               "losses": losses, "step_s": step_s, "wq0_elements_changed": changed,
               "allocated_before_bytes": allocated_before,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
               "peak_above_before_bytes": torch.cuda.max_memory_allocated() - allocated_before,
               "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
        log(rec)
        if not all(math.isfinite(x) for x in losses) or changed == 0:
            raise AssertionError(f"train 8b: losses {losses}, {changed} elements of wq[0] changed")
        del opt8, wq0
        gc.collect()
        torch.cuda.empty_cache()

        # (f) The trained tree served on the paged path through the kernels
        # (K2 each prefill layer, K1 each decode step's layer), against the
        # same engine on the tree carried through params_to_numpy and back.
        t0 = time.perf_counter()
        serve_cfg = cfg8.with_(attention_impl="flash")
        prompt = list(range(32, 96)) * 2
        gen_kw = dict(n=4, max_new_tokens=16, temperature=0.0, seed=0)
        served = {}
        for label in ("trained", "round_trip"):
            params = tree8 if label == "trained" else params_from_numpy(
                params_to_numpy(tree8), serve_cfg, device=dev)
            eng = LocalEngine(serve_cfg, params=params, device=dev)
            torch.cuda.synchronize()
            reset_counts()
            res = eng.generate(prompt, **gen_kw)
            torch.cuda.synchronize()
            counts = dict(_ext.LAUNCH_COUNTS)
            st = dict(eng.last_launch_stats)
            expected = {name: 0 for name in counts}
            expected.update(flash_attention=serve_cfg.num_layers,
                            paged_decode_attention=serve_cfg.num_layers * st["decode_steps"])
            served[label] = (np.asarray(res.tokens), counts, expected, st["kv_layout"])
            del eng, params, res
            gc.collect()
            torch.cuda.empty_cache()
        (tok_t, counts_t, exp_t, layout_t), (tok_r, counts_r, exp_r, layout_r) = (
            served["trained"], served["round_trip"])
        same = bool(np.array_equal(tok_t, tok_r))
        log({"phase": "train_serve", "tokens_equal_round_trip": same, "launches": counts_t,
             "expected": exp_t, "round_trip_launches": counts_r, "kv_layout": layout_t,
             "tokens": tok_t[:, :8].tolist(), "seconds": time.perf_counter() - t0})
        if (not same or counts_t != exp_t or counts_r != exp_r or exp_t["flash_attention"] == 0
                or layout_t != "paged" or layout_r != "paged"):
            raise AssertionError(f"train_serve: tokens equal {same}, {counts_t} vs {exp_t}, "
                                 f"{counts_r} vs {exp_r}, layouts {layout_t} {layout_r}")
        del tree8
        gc.collect()
        torch.cuda.empty_cache()

        # (c) The same widths at 2 layers in f32: the card's loss and
        # per-leaf gradient norms against the port's CPU step on the tree.
        t0 = time.perf_counter()
        cfg2 = train_config(2, "float32")
        card_tree = init_params(cfg2, torch.Generator(device=dev).manual_seed(args.seed), dev)
        host_tree = tree_to(card_tree, "cpu")
        tokens, mask = train_batch(cfg2, 1, 128, 128, args.seed)
        t1 = time.perf_counter()
        card_loss, card_norms = loss_and_grad_norms(cfg2, card_tree, tokens, mask)
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        host_loss, host_norms = loss_and_grad_norms(cfg2, host_tree, tokens, mask)
        host_s = time.perf_counter() - t1
        loss_err = abs(card_loss - host_loss) / abs(host_loss)
        norm_err = {k: abs(card_norms[k] - v) / v for k, v in host_norms.items()}
        log({"phase": "train_f32_2l", "card_loss": card_loss, "cpu_loss": host_loss,
             "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
             "card_grad_norms": card_norms, "loss_limit": TRAIN_F32_LOSS_RTOL,
             "grad_norm_limit": TRAIN_F32_GRAD_NORM_RTOL, "card_s": card_s, "cpu_s": host_s,
             "seconds": time.perf_counter() - t0})
        if not (loss_err <= TRAIN_F32_LOSS_RTOL
                and max(norm_err.values()) <= TRAIN_F32_GRAD_NORM_RTOL):
            raise AssertionError(f"train f32 2 layers: loss {loss_err}, norms {norm_err}")
        del card_tree, host_tree
        gc.collect()
        torch.cuda.empty_cache()

        # (d) The 8B flash config: refused before any allocation.
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            make_train_step(get_config("llama-3-8b"))
            refused = None
        except UntrainableError as e:
            refused = str(e)
        after = torch.cuda.memory_allocated()
        log({"phase": "train_refuse_flash", "refused": refused, "allocated_delta": after - before})
        if refused is None or "attention_impl" not in refused or after != before:
            raise AssertionError(f"train refuse: {refused!r}, allocated {after - before} bytes")

        # (e) Two ranks on the one card over gloo (NCCL refuses two ranks on
        # one card): TP (1, 2) at 2 layers in bf16, two steps, against the
        # unsharded card step on the same seeded tree. A step's collectives:
        # forward, a psum of each row-parallel output (2L) and of the
        # embedding (1); backward, a psum of the gradient entering each
        # column-parallel input (attention, MLP: 2L; the head: 1); one
        # all_gather of the logits. No data axis: nothing else.
        t0 = time.perf_counter()
        batch_e = {k: TRAIN_TP2_JOB[k] for k in ("B", "S", "valid_last")}
        cfg_e = train_config(TRAIN_TP2_JOB["layers"], "bfloat16")
        ref_tree = init_params(cfg_e, torch.Generator(device=dev).manual_seed(args.seed), dev)
        tokens, mask = train_batch(cfg_e, batch_e["B"], batch_e["S"], batch_e["valid_last"],
                                   args.seed)
        init_state, step = make_train_step(cfg_e)
        opt_e = init_state(ref_tree)
        ref_losses = [step(ref_tree, opt_e, tokens, mask)[2].item()
                      for _ in range(TRAIN_TP2_JOB["steps"])]
        del ref_tree, opt_e
        gc.collect()
        torch.cuda.empty_cache()
        if train_tp2_ranks is not None:  # run in the mesh phase's world
            ranks = train_tp2_ranks
            ranks_s = max(r["job_s"] for r in ranks)
        else:
            store_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_tmp")
            os.makedirs(store_dir, exist_ok=True)
            t1 = time.perf_counter()
            ranks = run_ranks(2, "gloo", [{"name": "train_tp2", "kind": "train", "args": dict(
                TRAIN_TP2_JOB, seed=args.seed)}], store_dir)["train_tp2"]
            ranks_s = time.perf_counter() - t1
        L = cfg_e.num_layers
        expected = {"psum": 4 * L + 2, "pmax": 0, "all_gather": 1, "ppermute": 0,
                    "all_to_all": 0}
        problems = []
        rank_losses = [[s["loss"] for s in r["steps"]] for r in ranks]
        if rank_losses[1] != rank_losses[0]:
            problems.append(f"ranks' losses differ: {rank_losses}")
        errs = [abs(a - b) / abs(b) for a, b in zip(rank_losses[0], ref_losses)]
        if not max(errs) <= TRAIN_BF16_LOSS_RTOL:
            problems.append(f"loss against the unsharded step {errs} > {TRAIN_BF16_LOSS_RTOL}")
        for r in ranks:
            for s in r["steps"]:
                got = {k: s["collectives"][k] for k in expected}
                if got != expected:
                    problems.append(f"collectives {got} != {expected}")
        log({"phase": "train_tp2", "mesh": ranks[0]["mesh"], "transport": ranks[0]["transport"],
             "losses": rank_losses, "unsharded_losses": ref_losses, "loss_rel_err": errs,
             "loss_limit": TRAIN_BF16_LOSS_RTOL, "expected_collectives_per_step": expected,
             "collectives": [[s["collectives"] for s in r["steps"]] for r in ranks],
             "host_staged_bytes_per_step": [s["collectives"]["host_staged_bytes"]
                                            for s in ranks[0]["steps"]],
             "step_s": [[s["step_s"] for s in r["steps"]] for r in ranks],
             "rank_peak_bytes": [r["peak_bytes"] for r in ranks], "ranks_s": ranks_s,
             "seconds": time.perf_counter() - t0, "ok": not problems})
        if problems:
            raise AssertionError(f"train_tp2: {problems}")
        log({"phase": "train_done", "seconds": time.perf_counter() - t_train,
             "nvidia_smi": smi})

    if "spec" in phases:
        # The spec phase's counted windows, and K4 and the draws at the
        # verify's rows, beside each kernel's main-path record.
        for name in ("flash_attention", "w4_matmul", "threefry_uniform_rows"):
            if name in kernels:
                kernels[name]["spec_launches"] = spec_launch_counts.get(name, 0)
        if "w4_matmul" in kernels:
            kernels["w4_matmul"]["verify_rows_cases"] = [
                {k: c[k] for k in ("case", "rows", "route", "ms", "decode_forced_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by", "device_ms",
                                   "decode_forced_device_ms", "library_device_ms")}
                for c in spec_kernel_cases]
        if "threefry_uniform_rows" in kernels:
            kernels["threefry_uniform_rows"]["verify_case"] = {
                k: spec_draw[k] for k in ("rows", "V", "ms", "plain_ms", "device_ms", "bound_ms",
                                          "bound_by")}

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
