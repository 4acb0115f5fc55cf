"""Prompt-lookup speculative decoding in the port, held against the JAX
package on the CPU (twins of ``tests/test_speculative.py``).

- ``ops/speculative.py``: drafts, acceptance and the per-row scatters
  integer-equal to the JAX functions over seeded cases (1-D and per-row
  prompts, with and without generated text, no match, the end clamp, eos,
  a zero budget); a write that would need JAX's start clamp raises.
- ``models.llama.verify_step`` at ``Sq = 5``: logits and the written cache
  within 1e-5 of the JAX function (fp32 ``tiny``, a windowed and an
  alternating config).
- The engine's spec loop: greedy and sampled tokens equal to the JAX spec
  engine's, solo and coalesced with distinct prompts, logprobs within 1e-5;
  the same with grammar, penalties, logit bias, top logprobs and stops;
  ``spec_stats`` equal to JAX's in both shapes; the copy case's acceptance.
- Through the backend: ``create()`` and ``parse()``, the scheduler's and
  ``SPEC_EVENTS``' spec counters, the NaN quarantine on the spec path, the
  per-request ``engine_stats["spec"]``, a streamed spec request equal to the
  JAX backend's stream, dense launches and the dense row cap.

The JAX tree is carried over by ``params_from_numpy``; JAX engines come from
``conftest.shared_engine`` so their compiled loops are shared.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fams
from _torch_serving import port_params
from conftest import shared_engine
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.models import llama as jax_llama
from k_llms_tpu.ops import speculative as jspec
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
from k_llms_tpu_torch.engine.engine import GenRequestSpec, LocalEngine
from k_llms_tpu_torch.engine.tokenizer import ByteTokenizer
from k_llms_tpu_torch.models import llama
from k_llms_tpu_torch.ops import speculative as spec

ATOL = 1e-5
K = 4
EOS = ByteTokenizer().stop_ids
PROMPT = [int(x) for x in np.random.default_rng(1).integers(5, 200, 40)]
PROMPT_2 = [int(x) for x in np.random.default_rng(12).integers(5, 200, 30)]


# -- ops/speculative.py ------------------------------------------------------


def _propose_case(case, rng):
    """Seeded inputs over a 6-token alphabet, so bigrams recur."""
    B, S, T = 6, 24, 12
    kw = {}
    one_d = case.startswith("1d") or case == "end_clamp"
    prompt = rng.integers(0, 6, S if one_d else (B, S)).astype(np.int32)
    plen = (np.int32(rng.integers(8, S + 1)) if one_d
            else rng.integers(2, S + 1, B).astype(np.int32))
    prev = rng.integers(0, 6, B).astype(np.int32)
    cur = rng.integers(0, 6, B).astype(np.int32)
    if case == "no_match":
        prev = prev + 100
    if case == "end_clamp":
        # A bigram found only three tokens before the prompt's end: two
        # drafts come from the prompt, the rest past its end (and past the
        # buffer's, where the gather clamps) repeat cur.
        plen = np.int32(S - 1)
        prompt[S - 5], prompt[S - 4] = 40, 41
        prev[:3], cur[:3] = 40, 41
    if case.endswith("gen"):
        kw["gen"] = rng.integers(0, 6, (B, T)).astype(np.int32)
        kw["gen_len"] = rng.integers(1, T + 1, B).astype(np.int32)
    return prompt, plen, prev, cur, kw


@pytest.mark.parametrize("case", ["1d", "2d", "1d_gen", "2d_gen", "no_match", "end_clamp"])
def test_propose_matches_jax(case):
    rng = np.random.default_rng(["1d", "2d", "1d_gen", "2d_gen", "no_match", "end_clamp"].index(case))
    for _ in range(4):
        prompt, plen, prev, cur, kw = _propose_case(case, rng)
        want = jspec.propose_prompt_lookup(
            jnp.asarray(prompt), jnp.asarray(plen), jnp.asarray(prev), jnp.asarray(cur), K,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = spec.propose_prompt_lookup(
            torch.from_numpy(prompt), torch.from_numpy(np.asarray(plen)), torch.from_numpy(prev),
            torch.from_numpy(cur), K, **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if case == "no_match":
            np.testing.assert_array_equal(got.numpy(), np.repeat(cur[:, None], K, axis=1))
        if case == "end_clamp":
            np.testing.assert_array_equal(got.numpy()[0], [prompt[-3], prompt[-2], 41, 41])


@pytest.mark.parametrize("case", ["random", "all_match", "eos", "budget"])
def test_accept_matches_jax(case):
    rng = np.random.default_rng(["random", "all_match", "eos", "budget"].index(case))
    B = 8
    eos = np.array([3, -1, -1, -1], np.int32)
    for _ in range(4):
        drafts = rng.integers(0, 5, (B, K)).astype(np.int32)
        sampled = rng.integers(0, 5, (B, K + 1)).astype(np.int32)
        if case in ("all_match", "eos", "budget"):
            sampled[:, :K] = drafts
        if case == "eos":
            sampled[np.arange(B), rng.integers(0, K + 1, B)] = 3
        budget = rng.integers(1, K + 2, B).astype(np.int32)
        if case == "budget":
            budget[::2] = 0
        want = jspec.accept_drafts(jnp.asarray(sampled), jnp.asarray(drafts), jnp.asarray(eos),
                                   jnp.asarray(budget))
        got = spec.accept_drafts(torch.from_numpy(sampled), torch.from_numpy(drafts),
                                 torch.from_numpy(eos), torch.from_numpy(budget))
        assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.bool]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if case == "budget":
            assert (got[1].numpy()[::2] == 0).all()


def test_scatter_rows_match_jax_and_refuse_a_clamped_write():
    """In range, both scatters equal JAX's vmapped dynamic_update_slice; a
    bound past ``T - W`` (where JAX would clamp the start) raises."""
    rng = np.random.default_rng(5)
    B, T, W, KT = 4, 10, 3, 2
    buf = rng.integers(0, 9, (B, T)).astype(np.int32)
    vals = rng.integers(10, 20, (B, W)).astype(np.int32)
    offsets = np.array([0, 7, 3, 5], np.int32)
    want = jspec.scatter_rows(jnp.asarray(buf), jnp.asarray(vals), jnp.asarray(offsets))
    got = spec.scatter_rows(torch.from_numpy(buf.copy()), torch.from_numpy(vals),
                            torch.from_numpy(offsets), max_offset=T - W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bufk = rng.normal(size=(B, T, KT)).astype(np.float32)
    valk = rng.normal(size=(B, W, KT)).astype(np.float32)
    want = jspec.scatter_rows_k(jnp.asarray(bufk), jnp.asarray(valk), jnp.asarray(offsets))
    got = spec.scatter_rows_k(torch.from_numpy(bufk.copy()), torch.from_numpy(valk),
                              torch.from_numpy(offsets), max_offset=T - W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="clamp"):
        spec.scatter_rows(torch.from_numpy(buf), torch.from_numpy(vals),
                          torch.from_numpy(offsets), max_offset=T - W + 1)


# -- verify_step at Sq > 1 ------------------------------------------------------

VERIFY_CONFIGS = {
    "plain": {},
    "window": dict(name="tiny-window", sliding_window=8),
    "alternating": dict(name="tiny-alternating", sliding_window=8,
                        sliding_window_layers="alternating", num_layers=2),
}


@pytest.mark.parametrize("name", list(VERIFY_CONFIGS))
def test_verify_step_at_five_tokens_matches_jax(name):
    """Five tokens per row at per-row offsets, prompts on both sides of the
    window: logits [B, 5, V] and the whole written cache within 1e-5."""
    fam = fams.Family(VERIFY_CONFIGS[name])
    rng = np.random.default_rng(7)
    B, P, G, Sq = 3, 32, 16, K + 1
    L, KVH, D = fam.cfg.num_layers, fam.cfg.num_kv_heads, fam.cfg.head_dim
    pk, pv = (rng.normal(size=(L, B, P, KVH, D)).astype(np.float32) for _ in range(2))
    gk, gv = (rng.normal(size=(L, B, G, KVH, D)).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, fam.cfg.vocab_size, (B, Sq)).astype(np.int32)
    lengths = np.array([0, 11, 4], np.int32)
    prompt_lens = np.array([32, 7, 19], np.int32)
    jlog, jgen = jax.jit(partial(jax_llama.verify_step, fam.jcfg))(
        fam.jparams, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(prompt_lens),
        fams._kv((gk, gv)), fams._kv((pk, pv)))
    gen = llama.KVCache(k=torch.tensor(gk), v=torch.tensor(gv))
    logits, gen = llama.verify_step(fam.port_cfg("xla"), fam.params, torch.tensor(tokens),
                                    torch.tensor(lengths), torch.tensor(prompt_lens), gen,
                                    llama.KVCache(k=torch.tensor(pk), v=torch.tensor(pv)))
    assert logits.shape == (B, Sq, fam.cfg.vocab_size) and logits.dtype == torch.float32
    fams._close(logits.numpy(), jlog)
    fams._close(gen.k.numpy(), jgen.k)
    fams._close(gen.v.numpy(), jgen.v)


# -- the engine's spec loop ------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """(JAX spec engine, port spec engine on the JAX weights, port normal
    engine). The port's spec engine is paged: its launches decode dense."""
    jeng = shared_engine("tiny", speculative="prompt_lookup", spec_lookahead=K)
    port = LocalEngine("tiny", params=port_params(), device="cpu", kv_layout="paged",
                       kv_page_size=8, speculative="prompt_lookup", spec_lookahead=K)
    normal = LocalEngine("tiny", params=port_params(), device="cpu", kv_layout="paged",
                         kv_page_size=8)
    return jeng, port, normal


def _same(got, want, top=False):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.finish_reasons == want.finish_reasons
    assert got.spec_stats == want.spec_stats
    if top:
        np.testing.assert_array_equal(got.top_tokens, want.top_tokens)
        np.testing.assert_allclose(got.top_logprobs, want.top_logprobs, atol=ATOL, rtol=0)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_solo_spec_matches_jax(engines, temperature):
    """One request: tokens, logprobs, finish reasons and the solo stats
    shape (drafted/accepted in the result and the mirror) equal JAX's; the
    launch decodes dense on the paged engine."""
    jeng, port, _ = engines
    kw = dict(n=3, max_new_tokens=12, temperature=temperature, seed=4, eos_ids=EOS)
    want = jeng.generate(PROMPT, **kw)
    got = port.generate(PROMPT, **kw)
    _same(got, want)
    assert set(got.spec_stats) == {"verify_iterations", "tokens_per_iteration", "drafted",
                                   "accepted"}
    assert port.spec_stats == jeng.spec_stats == got.spec_stats
    assert port.last_launch_stats["kv_layout"] == "dense"
    assert port.last_launch_stats["decode_steps"] == got.spec_stats["verify_iterations"]


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_coalesced_spec_matches_jax(engines, temperature):
    """Three requests with distinct prompts in one launch (each row drafts
    from its own request's prompt): every member equal to the JAX engine's
    ``generate_many``, member stats without drafted/accepted, the mirror
    with ``coalesced_requests`` and the launch's totals."""
    jeng, port, _ = engines
    specs = [(PROMPT, 2, 21), (PROMPT_2, 3, 22), (PROMPT[:17], 1, 8)]
    kw = dict(max_new_tokens=8, temperature=temperature, eos_ids=EOS)
    want = jeng.generate_many([JaxSpec(prompt_ids=p, n=n, seed=s) for p, n, s in specs], **kw)
    got = port.generate_many([GenRequestSpec(p, n, s) for p, n, s in specs], **kw)
    for g, w in zip(got, want):
        _same(g, w)
        assert set(g.spec_stats) == {"verify_iterations", "tokens_per_iteration"}
    assert port.spec_stats == jeng.spec_stats
    assert port.spec_stats["coalesced_requests"] == 3 and "drafted" in port.spec_stats


def test_coalesced_spec_composes_stops_bias_and_penalties_like_jax(engines):
    """Stops, a logit bias and a penalty under coalesced speculation: each
    member equal to the JAX spec engine's ``generate_many``."""
    jeng, port, _ = engines
    specs = [(PROMPT, 2, 4), (PROMPT[:22], 2, 6)]
    kw = dict(max_new_tokens=10, temperature=0.0, eos_ids=EOS, logit_bias={31: 4.0},
              stop_sequences=[[31, 31]], frequency_penalty=0.5)
    want = jeng.generate_many([JaxSpec(prompt_ids=p, n=n, seed=s) for p, n, s in specs], **kw)
    got = port.generate_many([GenRequestSpec(p, n, s) for p, n, s in specs], **kw)
    for g, w in zip(got, want):
        _same(g, w)
    assert port.spec_stats == jeng.spec_stats


def _pick_stop(normal):
    chain = normal.generate(PROMPT, n=1, max_new_tokens=6, temperature=0.0, seed=4, eos_ids=EOS)
    return [[int(chain.tokens[0, 2])]]


COMPOSED = {
    "penalties": dict(frequency_penalty=0.7, presence_penalty=0.3),
    "logit_bias": dict(logit_bias={PROMPT[0]: 4.0, PROMPT[1]: -6.0, 31: 2.5}),
    "top_logprobs": dict(top_logprobs=3),
    "stops": dict(stop_sequences="pick"),
    "json_greedy": dict(constraint="json"),
    "json_sampled": dict(constraint="json", temperature=0.9, seed=123),
}


@pytest.mark.parametrize("name", list(COMPOSED))
def test_spec_composes_like_jax(engines, name):
    """Each feature under speculation equals the JAX spec loop with it:
    grammar masks advanced through the drafts, closed-form penalty counts,
    the bias in the penalty, top logprobs per emitted position, and stops
    that complete inside an accepted run."""
    jeng, port, normal = engines
    kw = dict(n=2, max_new_tokens=12, temperature=0.0, seed=6, eos_ids=EOS)
    kw.update(COMPOSED[name])
    if kw.get("stop_sequences") == "pick":
        kw["stop_sequences"] = _pick_stop(normal)
    want = jeng.generate(PROMPT, **kw)
    got = port.generate(PROMPT, **kw)
    _same(got, want, top=name == "top_logprobs")
    if name == "stops":
        assert got.finish_reasons == ["stop", "stop"]


def test_spec_greedy_equals_normal_decode_and_copies_the_prompt(engines):
    """Greedy speculation reproduces the normal loop token for token; on a
    prompt ending in a run with its continuation forced by a logit bias,
    drafts are accepted (more than two tokens an iteration), as in JAX."""
    jeng, port, normal = engines
    kw = dict(n=2, max_new_tokens=10, temperature=0.0, seed=9, eos_ids=EOS)
    loop_prompt = [11, 12, 13, 14] * 12
    want = normal.generate(loop_prompt, **kw)
    got = port.generate(loop_prompt, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=ATOL, rtol=0)
    copy_prompt = [50, 51, 52] + [120] * 40
    ckw = dict(n=1, max_new_tokens=32, temperature=0.0, seed=0, logit_bias={120: 100.0})
    got = port.generate(copy_prompt, **ckw)
    want = jeng.generate(copy_prompt, **ckw)
    assert (got.tokens == 120).all()
    assert port.spec_stats == jeng.spec_stats
    assert port.spec_stats["accepted"] > 0 and port.spec_stats["tokens_per_iteration"] > 2.0


def test_spec_stats_zero_verify_edge(engines):
    """Every row stops on its first token: no verify, and the stats say so
    as JAX's do."""
    jeng, port, normal = engines
    first = int(normal.generate(PROMPT, n=1, max_new_tokens=1, temperature=0.0, seed=3,
                                eos_ids=EOS).tokens[0, 0])
    kw = dict(n=2, max_new_tokens=8, temperature=0.0, seed=3, eos_ids=[first])
    got = port.generate(PROMPT, **kw)
    want = jeng.generate(PROMPT, **kw)
    _same(got, want)
    assert got.spec_stats["verify_iterations"] == 0
    assert got.spec_stats["tokens_per_iteration"] is None


# -- through the backend -------------------------------------------------------


def _spec_backend(**config):
    engine = LocalEngine("tiny", params=port_params(), device="cpu", kv_layout="paged",
                         kv_page_size=8, speculative="prompt_lookup", spec_lookahead=K)
    config.setdefault("max_new_tokens", 12)
    return CudaBackend(config=BackendConfig(model="tiny", device="cpu", speculative="prompt_lookup",
                                            spec_lookahead=K, **config), engine=engine)


@pytest.fixture(scope="module")
def client():
    c = KLLMs(backend=_spec_backend(), model="tiny")
    yield c
    c.close()


def test_backend_serves_spec_and_feeds_the_spec_counters(client):
    """``create()`` and ``parse()`` serve under speculation; a copy-shaped
    request moves the scheduler's spec aggregates and ``SPEC_EVENTS`` by the
    engine's numbers; the launch decoded dense."""
    from pydantic import BaseModel

    from k_llms_tpu_torch.utils.observability import SPEC_EVENTS

    class Answer(BaseModel):
        ok: bool

    backend = client.backend
    r = client.chat.completions.create(messages=[{"role": "user", "content": "hi"}], n=2, seed=3)
    assert len(r.choices) == 3
    parsed = client.chat.completions.parse(messages=[{"role": "user", "content": "ok?"}],
                                           response_format=Answer, n=2, seed=3, max_tokens=24)
    assert len(parsed.choices) == 3
    before = SPEC_EVENTS.snapshot()
    stats0 = dict(backend.scheduler.stats)
    client.chat.completions.create(
        messages=[{"role": "user", "content": "x" * 40}], n=1, temperature=0.0, seed=1,
        logit_bias={"120": 100.0}, max_tokens=24)
    mirror = backend.engine.spec_stats
    stats = backend.scheduler.stats
    after = SPEC_EVENTS.snapshot()
    assert stats["spec_launches"] == stats0["spec_launches"] + 1
    assert stats["spec_drafted"] - stats0["spec_drafted"] == mirror["drafted"] > 0
    assert stats["spec_accepted"] - stats0["spec_accepted"] == mirror["accepted"] > 0
    assert stats["spec_tokens_per_iteration"] == mirror["tokens_per_iteration"] > 1.0
    assert after["spec.launches"] - before.get("spec.launches", 0) == 1
    assert after["spec.drafted"] - before.get("spec.drafted", 0) == mirror["drafted"]
    assert backend.engine.last_launch_stats["kv_layout"] == "dense"


def test_rebuilt_engine_keeps_speculation_and_its_hook():
    backend = _spec_backend()
    try:
        backend._rebuild_engine()
        assert backend.engine.speculative == "prompt_lookup"
        assert backend.engine.spec_lookahead == K
        assert backend.engine.on_spec_stats == backend.scheduler.note_spec_stats
    finally:
        backend.close()


def test_spec_launches_take_the_dense_row_cap(client, monkeypatch):
    """The paged per-group cap assumes rows share prompt pages; speculative
    launches decode dense, so the scheduler gets the dense cap."""
    backend = client.backend
    seen = []
    call_batched = backend.scheduler.call_batched

    def spy(*a, **kw):
        seen.append(kw["max_rows"])
        return call_batched(*a, **kw)

    monkeypatch.setattr(backend.scheduler, "call_batched", spy)
    client.chat.completions.create(messages=[{"role": "user", "content": "cap"}], n=2, seed=1,
                                   max_tokens=4)
    ids = backend.tokenizer.apply_chat_template([{"role": "user", "content": "cap"}],
                                                add_generation_prompt=True)
    assert seen == [backend.memory_model.max_rows(len(ids) + 4)]


def test_nan_quarantine_speculative_path(client):
    """The spec loop's quarantine (twin of test_supervision's): a poisoned
    row emits nothing, gets a typed sample error and leaves the vote."""
    from k_llms_tpu_torch.reliability import failpoints as fp
    from k_llms_tpu_torch.reliability.failpoints import FailSpec

    with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=0)}):
        resp = client.chat.completions.create(
            messages=[{"role": "user", "content": "echo echo echo"}], n=3, temperature=0.0,
            seed=2)
    quarantined = [c for c in resp.choices[1:] if getattr(c, "sample_error", None)]
    assert len(quarantined) == 1
    assert quarantined[0].sample_error["code"] == "numeric_poison"
    assert quarantined[0].message.content == ""
    assert resp.degraded["survived"] == 2


def test_engine_stats_captured_at_generation_time(client, monkeypatch):
    """A traced response carries the spec stats of its own request (from
    the GenerationResult): a later write to the engine's mirror does not
    change it (twin of test_observability's)."""
    monkeypatch.setenv("KLLMS_TRACE", "1")
    resp = client.chat.completions.create(
        messages=[{"role": "user", "content": "q q q q"}], n=2, seed=1, max_tokens=4)
    captured = dict(resp.engine_stats["spec"])
    assert "verify_iterations" in captured and "drafted" in captured, captured
    client.backend.engine.spec_stats = {"verify_iterations": 999}
    assert resp.engine_stats["spec"] == captured


def test_streamed_spec_request_equals_the_jax_stream(client):
    """No token tap on the spec path, in either package: each sample's text
    arrives as one delta at the end, and the stream equals the JAX
    backend's event for event (sample log-likelihoods, sums of per-token
    logprobs, and the likelihoods within 1e-4)."""
    from k_llms_tpu import KLLMs as JaxKLLMs
    from k_llms_tpu.backends.tpu import TpuBackend

    jclient = JaxKLLMs(backend=TpuBackend(
        model="tiny", max_new_tokens=12, speculative="prompt_lookup", spec_lookahead=K,
        engine=shared_engine("tiny", speculative="prompt_lookup", spec_lookahead=K)),
        model="tiny")
    req = dict(messages=[{"role": "user", "content": "stream this"}], model="tiny", n=3,
               seed=11, temperature=0.9, max_tokens=8)
    try:
        want = list(jclient.chat.completions.create(stream=True, **req))
    finally:
        jclient.close()
    got = list(client.chat.completions.create(stream=True, **req))

    def norm(e):
        e = {k: (None if k in ("id", "created", "system_fingerprint", "likelihoods") else v)
             for k, v in e.items()}
        e["choices"] = [{k: (None if k == "sample_logprob" else v) for k, v in c.items()}
                        for c in e["choices"]]
        return e

    def floats(e):
        lk = e.get("likelihoods")
        lk = sorted(lk.values()) if isinstance(lk, dict) else [lk or 0.0]
        return [c.get("sample_logprob") or 0.0 for c in e["choices"]] + lk

    assert [norm(e) for e in got] == [norm(e) for e in want]
    np.testing.assert_allclose(floats(got[-1]), floats(want[-1]), atol=1e-4, rtol=0)
    final = got[-1]
    deltas = [e for e in got if e["object"] == "chat.completion.chunk"
              and e["choices"][0]["delta"].get("content")]
    for i in range(1, 4):
        texts = [e["choices"][0]["delta"]["content"] for e in deltas
                 if e["choices"][0]["index"] == i]
        assert "".join(texts) == final["choices"][i]["message"]["content"]
        assert len(texts) <= 1


def test_continuous_loop_serves_without_speculation():
    """As in JAX, the continuous loop keeps taking qualifying requests with
    ``speculative`` set: they decode without speculation; a request the
    loop does not take (a logit bias) is a speculative launch."""
    backend = _spec_backend(continuous_batching=True, continuous_width=2,
                            continuous_max_prompt=64, continuous_max_new=16)
    c = KLLMs(backend=backend, model="tiny")
    try:
        c.chat.completions.create(messages=[{"role": "user", "content": "loop"}], n=2, seed=1,
                                  max_tokens=6)
        assert backend._continuous.stats["admitted"] == 1
        assert backend.scheduler.stats["spec_launches"] == 0
        c.chat.completions.create(messages=[{"role": "user", "content": "loop"}], n=2, seed=1,
                                  max_tokens=6, logit_bias={"65": 1.0})
        assert backend._continuous.stats["admitted"] == 1
        assert backend.scheduler.stats["spec_launches"] == 1
    finally:
        c.close()


def test_unknown_speculative_mode_raises():
    with pytest.raises(ValueError, match="prompt_lookup"):
        LocalEngine("tiny", params=port_params(), device="cpu", speculative="medusa")
