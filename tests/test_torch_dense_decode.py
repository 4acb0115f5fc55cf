"""The port's dense shared-prefix decode held against the JAX package on the
same carried-over weights (``params_from_numpy`` of the JAX tree), in f32.

Model level: per-request ``prefill``, the prefixes stacked into one
[L, R, P, KVH, D] cache, then 8 ``decode_step`` s: logits within atol 1e-5
and greedy tokens equal, with ``decode_attention_impl`` "xla" (one softmax
over prefix and tail) and "flash" (the decode-prefix kernel's plain version
on the prefix, merged with the tail by logsumexp; JAX runs its Pallas kernel
in interpret mode), for one request and for two of different prompt
lengths. Engine level: greedy ``generate_many`` tokens equal to the JAX
``LocalEngine(use_mesh=False)``, which is dense by default; the port's dense
and paged layouts emit the same tokens; the decode-prefix gate is taken
exactly where the JAX package takes it. An int4-eligible small config,
quantized by the JAX package and carried across, matches the JAX forward
and greedy generation through K4 and K3 (interpret mode there).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import shared_engine, shared_params
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import get_config as jax_get_config
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.models.config import get_config

ATOL = 1e-5
N_PER, BUCKET, STEPS = 4, 64, 8  # tiny: n * G = 4 * 2 = 8 rows per kv head, the gate
PROMPTS = [
    [256] + list(b"name two colours of the sea"),
    [256] + list(b"one two three four five six seven eight nine"),
]
ELIGIBLE = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                head_dim=64, vocab_size=384, max_seq_len=128)


@pytest.fixture(scope="module")
def weights():
    jax_params = shared_params(jax_get_config("tiny"), 0)
    return jax_params, llama.params_from_numpy(jax.device_get(jax_params), get_config("tiny"))


def _jax_decode(jax_params, impl, prompts):
    """JAX prefill of each prompt, stacked prefixes, then greedy decode
    steps. Returns the per-step logits."""
    jcfg = jax_get_config("tiny").with_(decode_attention_impl=impl)
    R, B = len(prompts), len(prompts) * N_PER
    prefill = jax.jit(partial(jax_llama.prefill, jcfg))
    firsts, ks, vs = [], [], []
    for p in prompts:
        toks = np.array([p + [jcfg.pad_token_id] * (BUCKET - len(p))], np.int32)
        fl, cache = prefill(jax_params, jnp.asarray(toks), jnp.int32(len(p)))
        firsts.append(np.asarray(fl))
        ks.append(cache.k)
        vs.append(cache.v)
    prefix = jax_llama.KVCache(k=jnp.concatenate(ks, axis=1), v=jnp.concatenate(vs, axis=1))
    gen = jax_llama.init_cache(jcfg, B, STEPS + 1)
    plens = jnp.asarray([len(p) for p in prompts], jnp.int32)
    step_fn = jax.jit(partial(jax_llama.decode_step, jcfg))
    tok = np.repeat(np.concatenate(firsts).argmax(-1), N_PER).astype(np.int32)
    out = []
    for step in range(STEPS):
        logits, gen = step_fn(jax_params, jnp.asarray(tok), jnp.int32(step), plens, gen, prefix)
        out.append(np.asarray(logits))
        tok = out[-1].argmax(-1).astype(np.int32)
    return np.concatenate(firsts), out


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("R", [1, 2])
def test_prefill_and_dense_decode_match_jax(weights, impl, R):
    jax_params, params = weights
    prompts = PROMPTS[:R]
    j_first, j_steps = _jax_decode(jax_params, impl, prompts)
    cfg = get_config("tiny").with_(decode_attention_impl=impl)
    firsts, ks, vs = [], [], []
    for p in prompts:
        toks = torch.tensor([p + [cfg.pad_token_id] * (BUCKET - len(p))])
        fl, (k, v) = llama.prefill(cfg, params, toks, len(p))
        firsts.append(fl)
        ks.append(k)
        vs.append(v)
    np.testing.assert_allclose(torch.cat(firsts).numpy(), j_first, atol=ATOL, rtol=0)
    prefix = llama.KVCache(k=torch.cat(ks, dim=1), v=torch.cat(vs, dim=1))
    gen = llama.init_cache(cfg, R * N_PER, STEPS + 1, "cpu")
    plens = torch.tensor([len(p) for p in prompts])
    tok = torch.cat(firsts).argmax(-1).repeat_interleave(N_PER)
    for step, jlog in enumerate(j_steps):
        logits, gen = llama.decode_step(cfg, params, tok, step, plens, gen, prefix)
        np.testing.assert_allclose(logits.numpy(), jlog, atol=ATOL, rtol=0)
        tok = logits.argmax(-1)
        assert (tok.numpy() == jlog.argmax(-1)).all()


COALESCED = dict(items=[(PROMPTS[0], 4, 7), (PROMPTS[1], 3, 9)], max_new_tokens=12, temperature=0.0)


def _port_engine(params, impl="xla", layout="dense", cfg=None, **kw):
    cfg = cfg or get_config("tiny").with_(decode_attention_impl=impl)
    return LocalEngine(cfg, params=params, device="cpu", kv_layout=layout, kv_page_size=8, **kw)


def _run(engine, spec_cls, items, **kw):
    return engine.generate_many([spec_cls(p, n, s) for p, n, s in items], **kw)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dense_engine_greedy_matches_jax_engine(weights, impl):
    """Two coalesced requests (n 4 and 3, different prompt lengths) through
    the JAX dense coalesced decode and the port's dense body: tokens,
    lengths and finish reasons equal, logprobs within 1e-5."""
    _, params = weights
    jeng = shared_engine(jax_get_config("tiny").with_(decode_attention_impl=impl))
    kw = {k: v for k, v in COALESCED.items() if k != "items"}
    jres = _run(jeng, JaxSpec, COALESCED["items"], **kw)
    teng = _port_engine(params, impl)
    tres = _run(teng, GenRequestSpec, COALESCED["items"], **kw)
    assert teng.last_launch_stats["kv_layout"] == "dense"
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(t.lengths, j.lengths)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=ATOL, rtol=0)
        assert t.finish_reasons == j.finish_reasons and t.prompt_len == j.prompt_len


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_dense_and_paged_layouts_emit_the_same_tokens(weights, temperature):
    _, params = weights
    kw = dict(max_new_tokens=10, temperature=temperature, frequency_penalty=0.3,
              stop_sequences=[[101, 32]])
    dense = _run(_port_engine(params, "flash"), GenRequestSpec, COALESCED["items"], **kw)
    paged = _run(_port_engine(params, "flash", "paged"), GenRequestSpec, COALESCED["items"], **kw)
    for d, p in zip(dense, paged):
        np.testing.assert_array_equal(d.tokens, p.tokens)
        np.testing.assert_allclose(d.logprobs, p.logprobs, atol=ATOL, rtol=0)
        assert d.finish_reasons == p.finish_reasons


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("n,taken", [(8, True), (2, False)])
def test_decode_prefix_gate(weights, monkeypatch, layout, n, taken):
    """The decode-prefix kernel runs where n * G >= 8 (tiny: G = 2): at n=8
    and not at n=2, on the dense step and on the paged reference step."""
    _, params = weights
    calls = []
    real = llama.decode_prefix_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(llama, "decode_prefix_attention", spy)
    eng = _port_engine(params, "flash", layout, paged_attention_impl="xla")
    eng.generate(PROMPTS[0], n=n, seed=0, max_new_tokens=3, temperature=0.0)
    assert bool(calls) == taken
    if taken:
        L = eng.config.num_layers
        assert len(calls) == 2 * L and calls[0] == (n, 4, 16)  # 2 decode steps x layers
    assert llama.flash_prefix_gate(eng.config, n, 1, 1) == taken


@pytest.fixture(scope="module")
def int4_weights():
    jcfg = jax_get_config("tiny").with_(decode_attention_impl="flash", **ELIGIBLE)
    jeng = shared_engine(jcfg, quantize="int4")
    cfg = get_config("tiny").with_(decode_attention_impl="flash", **ELIGIBLE)
    return jeng, cfg, llama.params_from_numpy(jax.device_get(jeng.params), cfg)


def test_int4_forward_matches_jax(int4_weights):
    """The carried-over int4 tree (packed bytes and scales unchanged) gives
    JAX's forward logits: both take each weight group's dot in f32 and
    scale it, so the two-layer forward agrees to atol 1e-4 (largest error
    measured 3.6e-6, at logits up to 4 in magnitude)."""
    jeng, cfg, params = int4_weights
    assert type(params["lm_head"]).__name__ == "Q4Tensor"
    assert type(params["layers"]["wk"]).__name__ == "Q4Tensor"
    np.testing.assert_array_equal(params["layers"]["w_up"].q.numpy(),
                                  np.asarray(jeng.params["layers"]["w_up"].q))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 300, size=(2, 24)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 17:] = 0
    ref, _ = jax_llama.forward(jeng.config, jeng.params, jnp.asarray(tokens), jnp.asarray(mask))
    got, _ = llama.forward(cfg, params, torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_int4_dense_flash_generate_matches_jax(int4_weights):
    """Greedy decode through K4 (every matmul) and K3 (the prefix at n=4):
    tokens equal to the JAX engine's, logprobs within 1e-4."""
    jeng, cfg, params = int4_weights
    items = [(PROMPTS[0], 4, 3)]
    kw = dict(max_new_tokens=6, temperature=0.0)
    jres = _run(jeng, JaxSpec, items, **kw)
    teng = LocalEngine(cfg, params=params, device="cpu", kv_layout="dense")
    assert teng.quantized == "int4"
    tres = _run(teng, GenRequestSpec, items, **kw)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4, rtol=0)
