"""The port's reliability layer on the CPU: the failpoint registry (its
``KLLMS_FAILPOINTS`` syntax and every site the port restores), retry and
the circuit breaker through ``dispatch_chat_completion``, the engine's
device-OOM guard (split and retry, from the ``oom`` failpoint and from a
``torch.cuda.OutOfMemoryError`` raised mid-decode, with every page reference
given back), the abort poller (a cancelled member's rows freeze and the
survivors equal the JAX engine's), ``kill_samples``, the ``nan`` poison
drill and the consolidation failpoint. The weights are the JAX package's
seeded ``tiny`` tree wherever the JAX engine is the reference."""

import threading

import numpy as np
import pytest
import torch

from _torch_serving import port_backend, port_params, prompt
from conftest import shared_engine
from k_llms_tpu.engine.engine import GenRequestSpec as JaxSpec
from k_llms_tpu.reliability import failpoints as jfp
from k_llms_tpu_torch.backends.base import ChatRequest
from k_llms_tpu_torch.engine import engine as engine_mod
from k_llms_tpu_torch.engine.engine import (
    GenRequestSpec,
    LocalEngine,
    _kill_sample_errors,
    is_resource_exhausted,
)
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.deadline import RequestBudget
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.reliability.retry import RetryPolicy
from k_llms_tpu_torch.types.wire import (
    BackendUnavailableError,
    CheckpointCorruptError,
    RequestCancelledError,
)
from k_llms_tpu_torch.utils.observability import FAILURE_EVENTS, KERNEL_EVENTS

ATOL = 1e-5
KW = dict(max_new_tokens=8, temperature=0.0)


def _engine(paged=True, **kwargs):
    return LocalEngine("tiny", params=port_params(), device="cpu",
                       kv_layout="paged" if paged else "dense", kv_page_size=8, **kwargs)


def _assert_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.tokens), np.asarray(want.tokens))
    np.testing.assert_allclose(np.asarray(got.logprobs), np.asarray(want.logprobs),
                               atol=ATOL, rtol=0)


GROUP = [GenRequestSpec(prompt("first member"), 2, 3), GenRequestSpec(prompt("second"), 2, 4)]


# -- the registry ----------------------------------------------------------------


@pytest.mark.parametrize("env,site,fields", [
    ("backend.dispatch=raise:2", "backend.dispatch", {"action": "raise", "times": 2}),
    ("engine.decode=kill_samples:3:7", "engine.decode", {"action": "kill_samples", "kill": 3, "seed": 7}),
    ("engine.launch=oom:1", "engine.launch", {"action": "oom", "times": 1}),
    ("engine.launch=hang:1:30", "engine.launch", {"action": "hang", "times": 1, "delay": 30.0}),
    ("engine.logits=nan:2:7", "engine.logits", {"action": "nan", "kill": 2, "seed": 7}),
    ("loader.params=corrupt:1", "loader.params", {"action": "corrupt", "times": 1}),
    ("ops.paged_attn=fallback:2", "ops.paged_attn", {"action": "fallback", "times": 2}),
    ("replica.dispatch=down:r1:2", "replica.dispatch", {"action": "down", "member": "r1", "times": 2}),
])
def test_env_syntax_parses_like_the_jax_registry(env, site, fields):
    fp.configure_from_env(env)
    jfp.configure_from_env(env)
    try:
        spec, jspec = fp._registry[site], jfp._registry[site]
        for name, value in fields.items():
            assert getattr(spec, name) == value == getattr(jspec, name)
    finally:
        fp.clear()
        jfp.clear()
    with pytest.raises(ValueError, match="unknown site"):
        fp.configure_from_env("nonsense.site=raise")
    fp.clear()


def test_injected_oom_keeps_the_jax_message_and_the_guard_matches_torch_oom():
    with fp.failpoints({"engine.launch": FailSpec(action="oom", times=1)}):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as ei:
            fp.fire("engine.launch")
    assert is_resource_exhausted(ei.value)
    assert is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert not is_resource_exhausted(RuntimeError("some other fault"))
    assert not is_resource_exhausted(BackendUnavailableError("RESOURCE_EXHAUSTED downstream"))


# -- dispatch: retry and the breaker ---------------------------------------------


def _chat(n=2, **kw):
    return ChatRequest(messages=[{"role": "user", "content": "q"}], model="tiny", n=n, seed=5, **kw)


def test_dispatch_retries_transient_faults_then_opens_the_circuit():
    backend = port_backend(max_new_tokens=4)
    backend.retry_policy = RetryPolicy(max_attempts=3, base_delay=0.0, seed=1)
    with fp.failpoints({"backend.dispatch": FailSpec(action="raise", times=2)}):
        out = backend.dispatch_chat_completion(_chat())
    assert len(out.choices) == 2 and backend.circuit_breaker.state == "closed"

    backend.retry_policy = RetryPolicy(max_attempts=1)
    breaker = backend.circuit_breaker
    with fp.failpoints({"backend.dispatch": FailSpec(action="raise")}):
        for _ in range(breaker.failure_threshold):
            with pytest.raises(RuntimeError, match="injected failpoint fault"):
                backend.dispatch_chat_completion(_chat())
    assert breaker.state == "open"
    with pytest.raises(BackendUnavailableError, match="circuit open"):
        backend.dispatch_chat_completion(_chat())
    assert backend.health()["breaker"] == "open"
    backend.close()


def test_caller_cancel_does_not_trip_the_breaker():
    backend = port_backend(max_new_tokens=4)
    budget = RequestBudget()
    budget.cancel()
    with pytest.raises(RequestCancelledError):
        backend.dispatch_chat_completion(_chat(budget=budget))
    assert backend.circuit_breaker._failures == 0
    backend.close()


# -- the OOM guard -------------------------------------------------------------


def test_oom_failpoint_splits_the_group_and_serves_every_member():
    engine = _engine()
    want = [engine.generate_many([spec], **KW)[0] for spec in GROUP]
    notes = []
    engine.on_oom = lambda: notes.append("oom")
    engine.on_launch_ok = lambda: notes.append("ok")
    before = FAILURE_EVENTS.get("engine.oom_split")
    with fp.failpoints({"engine.launch": FailSpec(action="oom", times=1)}):
        got = engine.generate_many(GROUP, **KW)
    assert engine.oom_stats == {"splits": 1, "unrecovered": 0}
    assert FAILURE_EVENTS.get("engine.oom_split") == before + 1
    assert notes == ["oom", "ok", "ok"]
    for g, w in zip(got, want):
        _assert_equal(g, w)


@pytest.mark.parametrize("paged,pool_pages,group_step",
                         [(True, 64, "paged_verify_step"), (True, None, "decode_step"),
                          (False, None, "decode_step")],
                         ids=["paged-fixed-pool", "paged-first-launch-pool", "dense"])
def test_torch_oom_mid_decode_releases_pages_and_splits(monkeypatch, paged, pool_pages,
                                                        group_step):
    """A ``torch.cuda.OutOfMemoryError`` from the model step of the
    two-request launch: every page reference the launch took goes back (the
    pool's free count is what it was, and the pool stays, as in the JAX
    engine), the group splits, and each half equals a direct launch of its
    sub-group. Without ``kv_pool_pages`` the pool is sized by the first
    (solo) launch, so the group decodes dense, as the JAX engine's would,
    and its OOM comes from the dense step."""
    engine = _engine(paged, kv_pool_pages=pool_pages)
    want = [engine.generate_many([spec], **KW)[0] for spec in GROUP]
    solo_pages = engine._kv_pool.allocator.total_pages if paged else None
    free_before = engine._kv_pool.allocator.free_pages if paged else None

    raised_in = []

    def oom_at_four_rows(name, step):
        def run(config, params, tok, *args, **kwargs):
            if tok.shape[0] == 4:  # the coalesced launch: 2 requests x n 2
                raised_in.append(name)
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
            return step(config, params, tok, *args, **kwargs)
        return run

    for name in ("paged_verify_step", "decode_step"):
        monkeypatch.setattr(engine_mod, name, oom_at_four_rows(name, getattr(engine_mod, name)))
    got = engine.generate_many(GROUP, **KW)
    assert engine.oom_stats["splits"] == 1
    # The group's layout: paged where the pool holds it, else dense.
    assert raised_in == [group_step]
    if paged:
        assert engine._kv_pool.allocator.free_pages == free_before
        assert engine._kv_pool.allocator.total_pages == solo_pages
    for g, w in zip(got, want):
        _assert_equal(g, w)


def test_solo_oom_is_a_typed_503_through_the_backend(monkeypatch):
    backend = port_backend(max_new_tokens=4)

    def always_oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(engine_mod, "paged_verify_step", always_oom)
    with pytest.raises(BackendUnavailableError, match="device out of memory"):
        backend.chat_completion(_chat())
    assert backend.engine.oom_stats == {"splits": 1, "unrecovered": 1}
    assert backend.health()["state"] == "degraded"  # the scheduler backed its width off
    backend.close()


# -- the abort poller ------------------------------------------------------------


class CancelAfter(RequestBudget):
    """A budget that cancels itself at its ``polls``-th poll, as a caller
    cancelling from another thread a few steps in would."""

    def __init__(self, polls):
        super().__init__()
        self.polls = polls

    def should_abort(self):
        self.polls -= 1
        if self.polls == 0:
            self.cancel()
        return super().should_abort()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cancelled_member_freezes_and_survivors_equal_jax(paged):
    engine = _engine(paged)
    eos = [257]
    specs = [GROUP[0], GenRequestSpec(GROUP[1].prompt_ids, 2, 4, CancelAfter(3))]
    got = engine.generate_many(specs, max_new_tokens=12, temperature=0.8, eos_ids=eos)
    assert isinstance(got[1], RequestCancelledError)
    # The poller saw the cancel at its third poll, after decode step 2.
    assert engine.last_launch_stats["aborted"][1][0] == 2

    jeng = shared_engine("tiny", kv_layout="paged") if paged else shared_engine("tiny")
    cancelled = RequestBudget()
    cancelled.cancel()
    want = jeng.generate_many(
        [JaxSpec(GROUP[0].prompt_ids, 2, 3), JaxSpec(GROUP[1].prompt_ids, 2, 4, cancelled)],
        max_new_tokens=12, temperature=0.8, eos_ids=eos,
    )
    assert isinstance(want[1], Exception)
    _assert_equal(got[0], want[0])


def test_cancelling_every_member_ends_the_launch_early():
    engine = _engine()
    budgets = [CancelAfter(2), CancelAfter(2)]
    specs = [GenRequestSpec(s.prompt_ids, s.n, s.seed, b) for s, b in zip(GROUP, budgets)]
    before = FAILURE_EVENTS.get("engine.decode_abort")
    got = engine.generate_many(specs, max_new_tokens=32, temperature=0.0, eos_ids=[-5])
    assert all(isinstance(g, RequestCancelledError) for g in got)
    assert engine.last_launch_stats["decode_steps"] == 2 < 31
    assert FAILURE_EVENTS.get("engine.decode_abort") == before + 2


def test_mid_decode_cancel_from_another_thread_through_the_client():
    backend = port_backend(max_new_tokens=400)
    slow = backend.engine._decode

    def slowed(step_fn, *args, **kwargs):
        def step(tok, i):
            threading.Event().wait(0.005)
            return step_fn(tok, i)
        return slow(step, *args, **kwargs)

    backend.engine._decode = slowed
    budget = RequestBudget()
    threading.Timer(0.3, budget.cancel).start()
    with pytest.raises(RequestCancelledError):
        backend.chat_completion(_chat(budget=budget, max_tokens=400, stop="\x00"))
    assert backend.engine.last_launch_stats["decode_steps"] < 399
    backend.close()


# -- sample and row faults -------------------------------------------------------


def test_kill_samples_loses_the_jax_selection():
    engine = _engine()
    with fp.failpoints({"engine.decode": FailSpec(action="kill_samples", kill=2, seed=7)}):
        got = engine.generate_many([GenRequestSpec(prompt("kill"), 4, 1)], **KW)[0]
    from k_llms_tpu.engine.engine import _kill_sample_errors as jax_kill

    spec = FailSpec(action="kill_samples", kill=2, seed=7)
    want = jax_kill(4, jfp.FailSpec(action="kill_samples", kill=2, seed=7))
    assert _kill_sample_errors(4, spec) == want
    assert got.sample_errors == want
    killed = [i for i, e in enumerate(want) if e is not None]
    assert all(got.lengths[i] == 0 for i in killed)


def test_nan_drill_quarantines_the_jax_rows():
    engine = _engine()
    jeng = shared_engine("tiny", kv_layout="paged")
    specs = [GenRequestSpec(prompt("poison"), 4, 2)]
    seen = []
    engine.on_quarantine = lambda poisoned, total: seen.append((poisoned, total))
    with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=2, seed=3)}):
        got = engine.generate_many(specs, **KW)[0]
    with jfp.failpoints({"engine.logits": jfp.FailSpec(action="nan", kill=2, seed=3)}):
        want = jeng.generate_many([JaxSpec(prompt("poison"), 4, 2)], **KW)[0]
    assert got.sample_errors == want.sample_errors
    assert sum(e is not None for e in got.sample_errors) == 2
    _assert_equal(got, want)
    assert seen == [(2, 4)]
    assert engine.quarantine_stats == {"samples": 2, "launches": 1}


# -- the restored sites ------------------------------------------------------------


def test_consolidate_failpoint_raises_at_consolidation():
    from k_llms_tpu_torch.consensus.consolidation import consolidate_chat_completions
    from k_llms_tpu_torch.consensus.similarity import SimilarityScorer
    from k_llms_tpu_torch.types import ChatCompletion

    completion = ChatCompletion.model_validate({
        "id": "cc-1", "object": "chat.completion", "created": 0, "model": "tiny",
        "choices": [{"index": 0, "finish_reason": "stop",
                     "message": {"role": "assistant", "content": "hi"}}],
    })
    scorer = SimilarityScorer.levenshtein()
    with fp.failpoints({"consensus.consolidate": FailSpec(action="raise", times=1)}):
        with pytest.raises(RuntimeError, match="injected failpoint fault"):
            consolidate_chat_completions([completion], scorer)
    consolidate_chat_completions([completion], scorer)


def test_paged_attn_drill_fails_a_card_launch_typed():
    """On a card the drill never gives way to the plain version: the launch
    fails with a typed 503, counted, and the next launch takes the kernel."""
    from k_llms_tpu_torch.ops.paged_attention import (
        KernelUnavailableError,
        launch_paged_attention_impl,
    )

    before = KERNEL_EVENTS.snapshot()
    with fp.failpoints({"ops.paged_attn": FailSpec(action="fallback", times=1)}):
        with pytest.raises(KernelUnavailableError) as err:
            launch_paged_attention_impl("cuda", device="cuda")
        assert launch_paged_attention_impl("cuda", device="cuda") == "cuda"
    after = KERNEL_EVENTS.snapshot()
    assert err.value.status_code == 503 and err.value.code == "kernel_unavailable"
    assert isinstance(err.value, BackendUnavailableError)
    for name, moved in (("kernel.paged_attn_unavailable.failpoint", 1),
                        ("kernel.paged_attn_fallback.failpoint", 0),
                        ("kernel.paged_attn_xla_dispatch", 0),
                        ("kernel.paged_attn_cuda_dispatch", 1)):
        assert after.get(name, 0) - before.get(name, 0) == moved, name


def test_paged_attn_drill_runs_the_plain_version_and_is_counted():
    engine = _engine(paged_attention_impl="cuda")  # the kernel's wrapper (its plain version here)
    want = engine.generate_many([GROUP[0]], **KW)[0]
    before = KERNEL_EVENTS.snapshot()
    with fp.failpoints({"ops.paged_attn": FailSpec(action="fallback", times=1)}):
        got = engine.generate_many([GROUP[0]], **KW)[0]
    after = KERNEL_EVENTS.snapshot()
    assert after.get("kernel.paged_attn_fallback.failpoint", 0) == (
        before.get("kernel.paged_attn_fallback.failpoint", 0) + 1)
    assert after.get("kernel.paged_attn_xla_dispatch", 0) == (
        before.get("kernel.paged_attn_xla_dispatch", 0) + 1)
    _assert_equal(got, want)


def test_grammar_failpoint_degrades_to_unconstrained():
    from k_llms_tpu_torch.engine.grammar import grammar_for_schema
    from k_llms_tpu_torch.utils.observability import GRAMMAR_EVENTS

    schema = {"type": "object", "properties": {"a": {"type": "string"}}}
    vocab = [bytes([i]) for i in range(256)] + [None, None]
    before = GRAMMAR_EVENTS.get("grammar.fallback_failpoint")
    with fp.failpoints({"engine.grammar": FailSpec(action="fallback", times=1)}):
        assert grammar_for_schema(schema, vocab) is None
    assert GRAMMAR_EVENTS.get("grammar.fallback_failpoint") == before + 1


def test_loader_corrupt_failpoint_fails_the_load(tmp_path):
    from k_llms_tpu_torch.models import loader
    from k_llms_tpu_torch.models.config import get_config

    path = str(tmp_path / "ckpt")
    loader.save_checkpoint(path, port_params())
    loader.load_checkpoint(path, get_config("tiny"))
    with fp.failpoints({"loader.params": FailSpec(action="corrupt", times=1)}):
        with pytest.raises(CheckpointCorruptError, match="non-finite"):
            loader.load_checkpoint(path, get_config("tiny"))
    assert np.isfinite(port_params()["embed"].numpy()).all()
