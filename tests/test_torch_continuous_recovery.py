"""Fault domains of the port's continuous loop, on the CPU at tiny fp32.

Twins of the cases of ``tests/test_continuous_recovery.py`` that pass on
the reference: a worker crash fails its futures typed and restarts; a hung
step (the ``continuous.step`` hang failpoint) is abandoned behind the epoch
fence, the engine rebuilt and the journal replayed, equal to an
uninterrupted run, on both KV layouts (in place: the abandoned step writes
only into tensors the recovered loop no longer reads); a loop without a
rebuild path and repeated hangs go terminal; numeric poison quarantines
only its row (the paged pool stays conserved); and the backend's
supervisor rebuild hands the new engine to the loop (``adopt_engine``).
"""

import numpy as np
import pytest

from _torch_serving import port_params
from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.reliability.supervisor import LaunchBudgetModel
from k_llms_tpu_torch.types.wire import BackendUnavailableError, EngineHungError
from k_llms_tpu_torch.utils.observability import RECOVERY_EVENTS


def _step_budget(seconds):
    return LaunchBudgetModel(base_s=0.1, per_token_s=0.01, multiplier=1.0,
                             min_budget_s=seconds, max_budget_s=seconds)


def _engine(layout="dense"):
    return LocalEngine("tiny", params=port_params(), device="cpu", kv_layout=layout,
                       kv_page_size=8)


@pytest.fixture(scope="module")
def eng():
    return _engine()


def test_worker_crash_fails_futures_typed_and_restarts(eng):
    loop = ContinuousDecodeLoop(eng, width=2, max_prompt=64, max_new=32)
    try:
        crashes = RECOVERY_EVENTS.get("continuous.worker_crashes")
        with fp.failpoints({"continuous.worker": FailSpec(action="crash", times=1)}):
            fut = loop.submit([1, 2, 3], n=1, max_new=8, temperature=0.0, top_p=None, seed=1)
            with pytest.raises(BackendUnavailableError, match="worker crashed"):
                fut.result(timeout=30)
        assert RECOVERY_EVENTS.get("continuous.worker_crashes") > crashes
        st = loop.stats
        assert st["restarts"] >= 1 and st["last_recovery_reason"] == "worker_crash"
        ok = loop.submit([1, 2, 3], n=1, max_new=4, temperature=0.0, top_p=None, seed=1
                         ).result(timeout=120)
        assert int(ok.lengths[0]) > 0 and loop._terminal_error is None
    finally:
        loop.stop()


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("label,kw", [("greedy", dict(temperature=0.0, top_p=None)),
                                      ("sampled", dict(temperature=0.8, top_p=0.9))])
def test_hung_step_rebuild_replay_differential(layout, label, kw):
    engine = _engine(layout)
    baseline = ContinuousDecodeLoop(engine, width=4, max_prompt=64, max_new=32)
    try:
        base = baseline.submit([5, 6, 7, 8], n=2, max_new=8, seed=23, **kw).result(timeout=120)
    finally:
        baseline.stop()
    sunk = []
    loop = ContinuousDecodeLoop(engine, width=4, max_prompt=64, max_new=32,
                                budget_model=_step_budget(2.0), rebuild_fn=lambda: engine,
                                max_rebuilds=3)
    try:
        hangs = RECOVERY_EVENTS.get("continuous.step_hangs")
        with fp.failpoints({"continuous.step": FailSpec(action="hang", times=1, delay=8.0)}):
            got = loop.submit([5, 6, 7, 8], n=2, max_new=8, seed=23,
                              token_sink=lambda s, t: sunk.append((s, t.copy())), **kw
                              ).result(timeout=120)
        assert RECOVERY_EVENTS.get("continuous.step_hangs") > hangs
        st = loop.stats
        assert st["restarts"] >= 1 and st["replayed_rows"] >= 2
        assert st["last_recovery_reason"] == "hung_step"
        assert np.array_equal(got.tokens, base.tokens), label
        assert np.array_equal(got.logprobs, base.logprobs), label
        steps = [s for s, _ in sunk]
        assert steps == sorted(set(steps))
        for step, row in sunk:
            for j in range(2):
                if step < got.lengths[j]:
                    assert row[j] == got.tokens[j, step]
    finally:
        loop.stop()


def test_fault_without_rebuild_path_goes_terminal(eng):
    loop = ContinuousDecodeLoop(eng, width=2, max_prompt=64, max_new=32,
                                budget_model=_step_budget(1.0))
    try:
        with fp.failpoints({"continuous.step": FailSpec(action="hang", times=1, delay=5.0)}):
            fut = loop.submit([1, 2, 3], n=1, max_new=8, temperature=0.0, top_p=None, seed=2)
            with pytest.raises(EngineHungError, match="without an engine rebuild"):
                fut.result(timeout=60)
        assert isinstance(loop._terminal_error, EngineHungError)
        with pytest.raises(EngineHungError):
            loop.submit([1, 2], n=1, max_new=2, temperature=0.0, top_p=None, seed=2)
    finally:
        loop.stop()


def test_repeated_hangs_exhaust_rebuilds_then_terminal(eng):
    rebuilds = {"n": 0}

    def rebuild():
        rebuilds["n"] += 1
        return eng

    loop = ContinuousDecodeLoop(eng, width=2, max_prompt=64, max_new=32,
                                budget_model=_step_budget(1.0), rebuild_fn=rebuild, max_rebuilds=1)
    try:
        with fp.failpoints({"continuous.step": FailSpec(action="hang", times=10, delay=5.0)}):
            fut = loop.submit([1, 2, 3], n=1, max_new=8, temperature=0.0, top_p=None, seed=3)
            with pytest.raises(EngineHungError, match="did not recover"):
                fut.result(timeout=60)
        assert rebuilds["n"] <= loop.max_rebuilds
        assert isinstance(loop._terminal_error, EngineHungError)
    finally:
        loop.stop()


def test_numeric_poison_quarantines_only_the_poisoned_row(eng):
    loop = ContinuousDecodeLoop(eng, width=4, max_prompt=64, max_new=32)
    try:
        with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=5, times=1)}):
            res = loop.submit([2, 3, 4], n=2, max_new=6, temperature=0.7, top_p=0.9, seed=9
                              ).result(timeout=120)
        errs = res.sample_errors
        assert errs is not None and sum(e is not None for e in errs) == 1
        j = next(i for i, e in enumerate(errs) if e is not None)
        assert errs[j]["code"] == "numeric_poison" and int(res.lengths[j]) == 0
        assert int(res.lengths[1 - j]) > 0 and errs[1 - j] is None
        assert loop.stats["quarantined_rows"] == 1 and loop.stats["restarts"] == 0
        ok = loop.submit([2, 3], n=1, max_new=4, temperature=0.0, top_p=None, seed=9
                         ).result(timeout=120)
        assert int(ok.lengths[0]) > 0
    finally:
        loop.stop()


def test_numeric_poison_quarantine_paged_returns_pages():
    loop = ContinuousDecodeLoop(_engine("paged"), width=2, max_prompt=32, max_new=8)
    try:
        with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=3, times=1)}):
            res = loop.submit([3, 1, 4, 1, 5], n=2, max_new=4, temperature=0.6, top_p=0.9,
                              seed=4).result(timeout=120)
        errs = res.sample_errors
        assert errs is not None and sum(e is not None for e in errs) == 1
        assert loop.stats["quarantined_rows"] == 1
        pages = loop.stats["pages"]
        assert "quarantined" not in pages and pages["loop_refs"] == 0
    finally:
        loop.stop()


def test_supervisor_rebuild_adopts_engine_into_loop():
    """The backend's rebuild (the supervisor's path) hands the new engine to
    the loop, which serves on it afterwards with the same answers."""
    from _torch_serving import port_backend
    from k_llms_tpu_torch import KLLMs

    backend = port_backend(paged=True, continuous_batching=True, continuous_width=4,
                           continuous_max_prompt=128, continuous_max_new=64)
    backend._build_engine = lambda: _engine("paged")
    client = KLLMs(backend=backend, model="tiny")
    msgs = [{"role": "user", "content": "adopt"}]
    try:
        before = client.chat.completions.create(messages=msgs, n=2, seed=5, temperature=0.9)
        old = backend.engine
        backend._rebuild_engine()
        assert backend.engine is not old and backend._continuous.engine is backend.engine
        after = client.chat.completions.create(messages=msgs, n=2, seed=5, temperature=0.9)
        assert [c.message.content for c in after.choices] == [c.message.content for c in before.choices]
        assert backend._continuous.stats["admitted"] == 2
    finally:
        client.close()
