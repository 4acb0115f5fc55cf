#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (k_llms_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from ``k_llms_tpu_torch/csrc``, holds each one
against its plain PyTorch version at the shapes the main path gives it,
drives ``tiny`` in fp32 through the kernels and through the plain paths, then
serves Llama-3-8B at full published width (seeded random weights, the byte
tokenizer) through ``KLLMs(backend="cuda").chat.completions.create``, with
every kernel launch counter reset just before and read just after.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card
and exits non-zero, printing no result, without one. ``--phases`` runs a
subset (for quick checks); the default runs every phase of the contract.
``--phases 8b,profile`` adds a device-time breakdown of one 8B request.

Output: one line per phase, then a ``{"kernels": [...]}`` line, the card's
name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

PHASES = ("build", "k2", "k1", "tiny", "8b")
# Opt-in: a torch.profiler breakdown of one 8B request (needs "8b").
EXTRA_PHASES = ("profile",)

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, dtype_peak: float):
    t_ops = flops / dtype_peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES) - set(EXTRA_PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known {PHASES}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from k_llms_tpu_torch.ops import _ext
    from k_llms_tpu_torch.ops import attention as att
    from k_llms_tpu_torch.ops import paged_attention as pa

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

    # 1. device
    log({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
         "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    kernels = {}

    # 2. build
    if "build" in phases:
        t0 = time.perf_counter()
        per = _ext.build_all()
        for name in _ext.KERNELS:
            _ext.load(name)
        log({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": per})

    # 3. K2 flash attention against its plain version
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

        def k2_case(name, B, QH, KVH, Sq, Sk, D, dtype, *, key_lengths=None,
                    q_offset=None, window=None, softcap=None, timed=False):
            q = randn(B, QH, Sq, D, dtype=dtype)
            k = randn(B, KVH, Sk, D, dtype=dtype)
            v = randn(B, KVH, Sk, D, dtype=dtype)
            kl = None if key_lengths is None else torch.tensor(key_lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=True, key_lengths=kl, softcap=softcap, window=window, q_offset=q_offset)
            out = att.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = att.flash_attention_plain(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ratio = over_limit(out, ref, dtype)
            ok = bool(torch.isfinite(out).all().item()) and ratio <= 1.0
            rtol, atol = limits[dtype]
            rec = {"phase": "k2", "case": name, "shape": [B, QH, KVH, Sq, Sk, D],
                   "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                   "mean_abs_ref": ref.float().abs().mean().item(),
                   "limit": f"{rtol:g}*|ref| + {atol:g}", "max_err_over_limit": ratio, "ok": ok}
            if timed:
                rec["ms"] = time_ms(lambda: att.flash_attention(q, k, v, **kw))
                rec["plain_ms"] = time_ms(lambda: att.flash_attention_plain(q, k, v, **kw), iters=5)
                # Yardstick only (the port never calls it): PyTorch's fused
                # attention on the same inputs, kv heads expanded to QH.
                G = QH // KVH
                k_rep = k.repeat_interleave(G, dim=1)
                v_rep = v.repeat_interleave(G, dim=1)
                rec["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k_rep, v_rep, is_causal=True))
                pairs = B * QH * Sq * (Sq + 1) / 2  # causal, full key lengths
                flops = 4.0 * D * pairs
                nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
                rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            # The limit must catch a kernel that is wrong by one key or one
            # tile: each such variant of the plain version has to break it.
            mutants = {}
            if timed:
                keep = torch.ones(B, Sk, dtype=torch.bool, device=dev)
                keep[:, Sk // 2: Sk // 2 + 32] = False
                mutants["causal_edge_one_key_late"] = att.flash_attention_plain(
                    q, k, v, **dict(kw, q_offset=1))
                mutants["key_tile_dropped"] = att.attention_xla(q, k, v, key_mask=keep).to(dtype)
            if window is not None:
                mutants["window_edge_one_key_wider"] = att.flash_attention_plain(
                    q, k, v, **dict(kw, window=window + 1))
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
        errs.append(k2_case("q_offset", 1, 32, 8, 500, S, 128, torch.bfloat16,
                            key_lengths=[S], q_offset=S - 500)[1])
        errs.append(k2_case("window", 1, 32, 8, S, S, 128, torch.bfloat16,
                            key_lengths=[S], window=256)[1])
        errs.append(k2_case("softcap", 1, 32, 8, S, S, 128, torch.bfloat16,
                            key_lengths=[S], softcap=50.0)[1])
        # The embeddings forward: 8 strings bucket-padded to 512 tokens, the
        # batch padded to 8 with empty rows.
        errs.append(k2_case("embeddings_encode", 8, 32, 8, 512, 512, 128, torch.bfloat16,
                            key_lengths=[512, 431, 300, 77, 1, 0, 0, 0])[1])
        errs.append(k2_case("head_dim_256", 1, 8, 4, 700, 700, 256, torch.bfloat16)[1])
        errs.append(k2_case("all_masked_row", 2, 32, 8, 300, 300, 128, torch.bfloat16,
                            key_lengths=[300, 0])[1])
        errs.append(k2_case("tiny_f32", 1, 4, 2, 77, 77, 16, torch.float32,
                            key_lengths=[70])[1])
        errs.append(k2_case("head_dim_64_f32", 2, 14, 2, 100, 100, 64, torch.float32,
                            key_lengths=[100, 37])[1])
        kernels["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "k_llms_tpu_torch/csrc/flash_attention.cu",
            "replaces": "k_llms_tpu/ops/attention.py:57",
            "launches": None, "held": True, "max_abs_err": max(errs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
        }

    # 4. K1 paged decode against its plain version
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
                esz = pool_k.element_size()
                keys_per_row = [p + glen for p in plens for _ in range(n_per)]
                flops = 4.0 * D * (QH // KVH) * KVH * (sum(keys_per_row) + B)
                # Each input byte once: every request's prompt KV once, each
                # row's generated KV, q, the fresh columns; the f32 output.
                kv_tokens = sum(plens) + B * glen
                nbytes = (2 * kv_tokens * KVH * D + q.numel() + nk.numel() + nv.numel()) * esz \
                    + out.numel() * 4
                rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                per_row_bytes = (2 * (sum(keys_per_row)) * KVH * D) * esz
                rec["bytes_read_by_kernel_over_bound"] = per_row_bytes / max(nbytes, 1)
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
            return rec, err

        main_rec, e0 = k1_case("llama3_8b_decode", 2, 8, 32, 8, 128, 64, [1500, 1437], 40,
                               torch.bfloat16, 1e-5, bucket=2048, timed=True)
        errs = [e0]
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
            "library_ms": None,
        }

    from k_llms_tpu_torch.engine.engine import LocalEngine
    from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
    from k_llms_tpu_torch.models.config import get_config
    from k_llms_tpu_torch.models.llama import init_params

    # 5. tiny fp32: greedy tokens through the kernels == through the plain paths
    if "tiny" in phases:
        tiny = get_config("tiny")
        params = init_params(tiny, torch.Generator(device=dev).manual_seed(args.seed), dev)
        tok = ByteTokenizer()
        prompt = tok.apply_chat_template(
            [{"role": "user", "content": "Extract the invoice total from: total due 41.20 EUR"}])
        runs = {}
        for label, cfg, impl in (("kernels", tiny.with_(attention_impl="flash"), "cuda"),
                                 ("plain", tiny, "xla")):
            eng = LocalEngine(cfg, params=params, device="cuda", paged_attention_impl=impl,
                              kv_page_size=16)
            _ext.reset_launch_counts()
            res = eng.generate(prompt, n=4, seed=1, max_new_tokens=32, temperature=0.0,
                               eos_ids=tok.stop_ids)
            runs[label] = (res, dict(_ext.LAUNCH_COUNTS))
        same = bool((runs["kernels"][0].tokens == runs["plain"][0].tokens).all())
        lp_err = float(abs(runs["kernels"][0].logprobs - runs["plain"][0].logprobs).max())
        counts = runs["kernels"][1]
        log({"phase": "tiny_fp32", "greedy_tokens_equal": same, "logprob_max_abs_diff": lp_err,
             "kernel_launches": counts, "plain_launches": runs["plain"][1]})
        if not same or min(counts.values()) == 0 or max(runs["plain"][1].values()) != 0:
            raise AssertionError("tiny fp32: kernel path disagrees with the plain path")

    # 6. Llama-3-8B, bf16, full width, seeded random weights, through KLLMs
    if "8b" in phases:
        from k_llms_tpu_torch import KLLMs

        t0 = time.perf_counter()
        client = KLLMs(backend="cuda", model="llama-3-8b", param_seed=args.seed)
        torch.cuda.synchronize()
        engine = client.backend.engine
        log({"phase": "8b_init", "seconds": time.perf_counter() - t0,
             "param_bytes": engine.param_footprint_bytes(),
             "paged_attention_impl": engine.paged_attention_impl,
             "attention_impl": engine.config.attention_impl})
        # Random weights spread their mass over the whole 128k vocabulary,
        # which the byte tokenizer decodes to nothing; a logit bias on the
        # printable bytes gives consensus text to vote on.
        printable = {str(t): 10.0 for t in range(32, 127)}
        # Warm-up outside the counted window (library handles, allocator).
        client.chat.completions.create(messages=[{"role": "user", "content": "warm up"}],
                                       n=2, max_tokens=4, temperature=0.0, seed=0,
                                       logit_bias=printable)
        long_text = ("Invoice 2024-0117 from Acme GmbH, Berlin. Line items: 12 widgets at "
                     "3.40 EUR, 4 gadgets at 17.95 EUR, shipping 9.00 EUR. ") * 12
        long_text = long_text[:1450]
        requests = [
            dict(messages=[{"role": "user", "content": "What is the capital of France?"}],
                 n=8, temperature=0.0, max_tokens=32, seed=1, logit_bias=printable),
            # Answers over 50 characters take the consensus's embeddings
            # similarity: one encoder forward (K2 again) over the distinct
            # samples.
            dict(messages=[{"role": "user", "content": "Name three prime numbers."}],
                 n=8, temperature=0.8, top_p=0.95, seed=3, max_tokens=64, logit_bias=printable),
            dict(messages=[{"role": "user", "content": long_text + "\nWhat is the total?"}],
                 n=8, temperature=0.0, max_tokens=32, seed=5, logit_bias=printable),
        ]
        # Record the embeddings forwards the consensus asks for.
        embed_batches = []
        embed_tokens = engine.embed_tokens

        def counted_embed_tokens(token_lists, *a, **kw):
            embed_batches.append([len(t) for t in token_lists])
            return embed_tokens(token_lists, *a, **kw)

        engine.embed_tokens = counted_embed_tokens
        _ext.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        for i, req in enumerate(requests):
            t0 = time.perf_counter()
            n_embeds = len(embed_batches)
            resp = client.chat.completions.create(**req)
            wall = time.perf_counter() - t0
            st = dict(engine.last_launch_stats)
            n = req["n"]
            if len(resp.choices) != n + 1 or resp.likelihoods is None:
                raise AssertionError(f"8b request {i}: {len(resp.choices)} choices, "
                                     f"likelihoods={resp.likelihoods}")
            lps = [c.sample_logprob for c in resp.choices[1:]]
            if not all(math.isfinite(x) for x in lps):
                raise AssertionError(f"8b request {i}: non-finite sample logprobs {lps}")
            gen_tokens = resp.usage.completion_tokens
            log({"phase": "8b_request", "index": i, "n": n, "temperature": req["temperature"],
                 "prompt_tokens": resp.usage.prompt_tokens, "completion_tokens": gen_tokens,
                 "prefill_ms": st["prefill_s"] * 1e3,
                 "decode_ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
                 "decode_steps": st["decode_steps"], "wall_s": wall,
                 "tokens_per_s": gen_tokens / wall, "choices": len(resp.choices),
                 "embeddings_forwards": embed_batches[n_embeds:],
                 "consensus": resp.choices[0].message.content, "likelihoods": resp.likelihoods})
        engine.embed_tokens = embed_tokens
        counts = dict(_ext.LAUNCH_COUNTS)
        L = engine.config.num_layers
        log({"phase": "8b_main_path", "launches": counts, "embeddings_forwards": len(embed_batches),
             "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        for name, rec in kernels.items():
            rec["launches"] = counts[name]
        if min(counts.values()) == 0:
            raise AssertionError(f"a kernel of the main path was never launched: {counts}")
        if not embed_batches or counts["flash_attention"] != L * (len(requests) + len(embed_batches)):
            raise AssertionError(f"the embeddings forward did not run through K2: "
                                 f"{len(embed_batches)} forwards, launches {counts}")

        if "profile" in phases:
            from torch.profiler import ProfilerActivity, profile

            req = dict(requests[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                client.chat.completions.create(**req)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            st = dict(engine.last_launch_stats)
            # Kernel events only: an operator's entry repeats the device time
            # of the kernels it launched.
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
            log({"phase": "8b_profile", "request": 0, "wall_s": wall,
                 "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                 "decode_steps": st["decode_steps"], "device_busy_s": busy_us / 1e6,
                 "device_idle_share": 1.0 - busy_us / 1e6 / wall,
                 "top_device_time": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                                     for us, k, c in rows[:12]]})

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
