"""The port's twin of ``tests/test_continuous_chaos.py``: the mixed-traffic
chaos soak for the self-healing continuous loop, on the port's backend at
tiny on the CPU.

The drill: crash the worker thread, hang a decode step
AND a prefill chunk, poison logits, and leak KV pages — under concurrent
streaming, grammar-constrained, and plain n-way traffic on the
continuous-batching backend (chunked prefill on, so long admissions ingest
between decode steps while the faults land).
Every request must resolve (success or typed error, never a hung future),
rebuilds must stay bounded, the page pool must end conserved, the scheduler
must end READY, and both the lock-order graph and the Eraser-style lockset
sanitizer must come out clean under KLLMS_LOCKCHECK=1 + KLLMS_RACECHECK=1.
"""

import threading
import time

import pytest
from pydantic import BaseModel

from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends.cuda import CudaBackend
from k_llms_tpu_torch.analysis import lockcheck
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.types.wire import KLLMsError
from k_llms_tpu_torch.utils.observability import RECOVERY_EVENTS


class Record(BaseModel):
    name: str
    count: int


def _backend():
    # Step budget 2 s: far under the 30 s injected hang (the loop watchdog
    # MUST fire) and far over a tiny CPU step (the port compiles nothing).
    return CudaBackend(
        model="tiny", device="cpu", max_new_tokens=8,
        continuous_batching=True, continuous_width=4,
        continuous_max_prompt=128, continuous_max_new=64,
        watchdog_base_s=0.5, watchdog_per_token_s=0.01,
        watchdog_multiplier=1.0, watchdog_min_budget_s=2.0,
        watchdog_max_budget_s=2.0, max_rebuilds=4,
        # Chunked prefill ON: prompts past 32 tokens ingest chunk by chunk,
        # so the soak also drills the PREFILLING fault domain.
        prefill_chunk_tokens=32,
    )


@pytest.mark.slow
@pytest.mark.duration_budget(240)
def test_continuous_chaos_soak_mixed_traffic(monkeypatch):
    """continuous.worker=crash, then continuous.step=hang + engine.logits=nan
    under mixed stream/grammar/non-stream concurrency, then engine.pages=leak
    — the full fault-domain tour on one live backend."""
    monkeypatch.setenv("KLLMS_LOCKCHECK", "1")
    monkeypatch.setenv("KLLMS_RACECHECK", "1")
    lockcheck.reset_state()
    backend = _backend()
    client = KLLMs(backend=backend, model="tiny")
    results = {}
    lock = threading.Lock()

    def worker(i):
        # One wave-2 lane carries a long prompt so a multi-chunk PREFILLING
        # admission is in flight while the faults land (past one 32-token
        # chunk, inside the loop's 128-token prompt bound with the chat
        # template).
        content = ("chaos prefill " * 5) if i == 4 else f"chaos {i}"
        msgs = [{"role": "user", "content": content}]
        try:
            if i % 3 == 0:
                # Streaming lane: drain every chunk; a quarantined sample
                # surfaces as a terminal typed sample_error chunk, not a hang.
                with client.chat.completions.create(
                    messages=msgs, model="tiny", n=2, seed=200 + i,
                    temperature=0.8, stream=True,
                ) as stream:
                    chunks = list(stream)
                with lock:
                    results[i] = ("ok", chunks)
            elif i % 3 == 1:
                # Grammar lane: schema-constrained rows ride the same loop;
                # truncation or degraded samples leave parsed=None, never an
                # untyped error.
                pc = client.chat.completions.parse(
                    messages=msgs, response_format=Record, model="tiny",
                    n=2, seed=200 + i, temperature=0.8,
                )
                with lock:
                    results[i] = ("ok", pc)
            else:
                cc = client.chat.completions.create(
                    messages=msgs, model="tiny", n=2 if i % 2 else 4,
                    seed=200 + i, temperature=0.8,
                )
                with lock:
                    results[i] = ("ok", cc)
        except KLLMsError as e:
            with lock:
                results[i] = ("typed", e)

    # Wave 1 — worker crash under traffic. The crash kills the loop thread
    # while both requests are queued/in flight: each must resolve promptly
    # (typed BackendUnavailableError, or ok if the dispatch retry lands on
    # the restarted loop), never hang. Kept to two requests so the typed
    # failures cannot trip the circuit breaker (threshold 5).
    crashes = RECOVERY_EVENTS.snapshot().get("continuous.worker_crashes", 0)
    with fp.failpoints(
        {"continuous.worker": FailSpec(action="crash", times=1)}
    ):
        wave1 = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
        for t in wave1:
            t.start()
        for t in wave1:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in wave1)
    assert RECOVERY_EVENTS.snapshot()["continuous.worker_crashes"] > crashes

    # Wave 2 — hung step + hung prefill chunk + NaN poison while seven mixed
    # requests ride the restarted loop: the watchdog rebuilds and replays
    # through both hangs (the chunked admission re-ingests from cursor 0),
    # quarantine absorbs the poisoned rows, and traffic keeps flowing.
    with fp.failpoints(
        {
            "continuous.step": FailSpec(action="hang", times=1, delay=30.0),
            "continuous.prefill": FailSpec(action="hang", times=1, delay=30.0),
            "engine.logits": FailSpec(action="nan", kill=1, seed=13, times=2),
        }
    ):
        wave2 = [threading.Thread(target=worker, args=(i,)) for i in range(2, 9)]
        for t in wave2:
            t.start()
        for t in wave2:
            t.join(timeout=180.0)
        # The headline invariant: zero hung futures / zero hung clients.
        assert not any(t.is_alive() for t in wave2)
    assert sorted(results) == list(range(9))
    oks = [k for k, r in results.items() if r[0] == "ok" and k >= 2]
    assert oks, "wave-2 requests must ride through the recovery"

    # Wave 3 — page leak (paged loop only): a retiring slot drops a page from
    # the free list. The next stats audit QUARANTINES the pool (reported as
    # data, not a raise), the worker rebuilds + replays, and subsequent
    # audits come back conserved.
    if "pages" in backend.health()["continuous"]:
        restarts = backend.health()["continuous"]["restarts"]
        with fp.failpoints(
            {"engine.pages": FailSpec(action="leak", kill=1, times=1)}
        ):
            client.chat.completions.create(
                messages=[{"role": "user", "content": "leak"}], model="tiny",
                n=2, seed=303, temperature=0.8,
            )
        # The rebuilt loop sizes its new pool at its next admission (the
        # leak request had already completed, so nothing is replayed): one
        # clean request follows the rebuild before the audit.
        deadline = time.monotonic() + 60.0
        while backend.health()["continuous"]["restarts"] == restarts:
            assert time.monotonic() < deadline, "the leak was never audited"
            time.sleep(0.2)
        client.chat.completions.create(
            messages=[{"role": "user", "content": "healed"}], model="tiny",
            n=2, seed=304, temperature=0.8,
        )
        healed = False
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            pages = backend.health()["continuous"].get("pages", {})
            if "quarantined" not in pages and pages.get("loop_refs") == 0:
                healed = True
                break
            time.sleep(0.2)
        assert healed, "page pool must heal back to a conserved snapshot"

    cont = backend.health()["continuous"]
    # Bounded recovery: the loop healed within its fault budget each time and
    # never went terminal (clean traffic below proves it).
    # crash + step hang + prefill hang + (leak on paged loops)
    assert 1 <= cont["restarts"] <= 5
    if "pages" in cont:
        assert "quarantined" not in cont["pages"]
        assert cont["pages"]["loop_refs"] == 0

    # Clean traffic after the chaos: scheduler healed back to READY.
    cc = client.chat.completions.create(
        messages=[{"role": "user", "content": "after"}], model="tiny",
        n=2, seed=5,
    )
    assert len(cc.choices) == 3  # consensus + both samples
    assert backend.health()["state"] == "ready"
    client.close()
    lockcheck.assert_clean()
