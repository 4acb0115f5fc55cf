"""The tier-1 sanitized soak: both runtime sanitizers armed over the port's
whole serving stack on the CPU, so that every change runs them.

Under ``KLLMS_LOCKCHECK=1`` and ``KLLMS_RACECHECK=1`` (set before the
backend is built: locks made earlier stay plain) a continuous-batching
backend at tiny serves, all at once and behind ``ServerThread(create_app(
client))`` on loopback:

- JSON requests and an SSE stream over HTTP, and a stream whose client
  hangs up after its first chunk;
- a ``parse()`` under the grammar and a ``create()`` at n = 8 (wider than
  the loop, so it goes through the scheduler's coalesced launch);
- a two-item job on the batch lane;
- mid-traffic, one ``continuous.step`` hang and one ``continuous.prefill``
  hang (healed by the loop's watchdog); then one ``engine.logits`` poison
  in a coalesced launch.

Every request resolves (success or a typed error), the page pool ends
conserved, the backend READY, the lock-order graph holds edges naming the
engine's launch lock (``engine.paged_mutex``), the pool, the loop and the
scheduler, and ``assert_clean()`` passes: no cycle, no device dispatch
under a lock without ``allow_dispatch``, no field with an empty lockset.
The slow twins of the JAX package's soaks are in ``test_torch_*_chaos.py``
and ``test_torch_overload_soak.py``.
"""

import http.client
import json
import threading
import time

import pytest
from pydantic import BaseModel

from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.analysis import lockcheck
from k_llms_tpu_torch.backends.cuda import CudaBackend
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.serving import ServerThread, create_app
from k_llms_tpu_torch.types.wire import KLLMsError
from k_llms_tpu_torch.utils.observability import QUARANTINE_EVENTS, RECOVERY_EVENTS

ARMED_LOCKS = ("engine.paged_mutex", "engine.kv_pool", "engine.continuous", "engine.scheduler")


class Record(BaseModel):
    name: str
    count: int


def _post(port, path, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(body) if isinstance(body, dict) else body,
                 headers={"content-type": "application/json"})
    return conn, conn.getresponse()


def _get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()))
    conn.close()
    return out


@pytest.mark.duration_budget(30)
def test_sanitizers_stay_clean_over_mixed_serving_traffic(monkeypatch):
    monkeypatch.setenv("KLLMS_LOCKCHECK", "1")
    monkeypatch.setenv("KLLMS_RACECHECK", "1")
    lockcheck.reset_state()
    # Step budget 2 s: far under the injected 8 s hangs (the loop's
    # watchdog must fire), far over a tiny CPU step.
    backend = CudaBackend(
        model="tiny", device="cpu", max_new_tokens=8,
        continuous_batching=True, continuous_width=4,
        continuous_max_prompt=128, continuous_max_new=64, prefill_chunk_tokens=32,
        watchdog_base_s=0.5, watchdog_per_token_s=0.01, watchdog_multiplier=1.0,
        watchdog_min_budget_s=2.0, watchdog_max_budget_s=2.0, max_rebuilds=4,
    )
    # The factories saw their owners: the engine and the loop are tracked.
    assert type(backend.engine)._kllms_is_tracked
    assert isinstance(backend.engine._launch_lock, lockcheck._CheckedBase)
    client = KLLMs(backend=backend, model="tiny")
    results, lock = {}, threading.Lock()

    def keep(key, value):
        with lock:
            results[key] = value

    with ServerThread(create_app(client)) as srv:
        port = srv.port

        def http_json(i):
            conn, resp = _post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": f"json {i}"}],
                "n": 2, "seed": 10 + i, "temperature": 0.8, "max_tokens": 8})
            body = json.loads(resp.read())
            conn.close()
            keep(f"json{i}", ("ok" if resp.status == 200 else "typed", resp.status, body))

        def http_stream():
            conn, resp = _post(port, "/v1/chat/completions", {
                # Past one 32-token chunk, inside the loop's 128-token
                # prompt bound: a chunked admission the prefill hang hits.
                "messages": [{"role": "user", "content": "chaos prefill " * 5}],
                "n": 2, "seed": 30, "temperature": 0.8, "max_tokens": 8, "stream": True})
            raw = resp.read()
            conn.close()
            keep("stream", ("ok" if raw.endswith(b"data: [DONE]\n\n") else "typed",
                            resp.status, raw))

        def http_disconnect():
            conn, resp = _post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "hang up"}],
                "n": 2, "seed": 31, "temperature": 0.8, "max_tokens": 64, "stream": True})
            first = resp.readline()
            conn.close()  # the client hangs up after its first line
            keep("disconnect", ("ok", resp.status, first))

        def parse():
            try:
                pc = client.chat.completions.parse(
                    messages=[{"role": "user", "content": "parse"}], response_format=Record,
                    n=2, seed=40, temperature=0.8)
                keep("parse", ("ok", 200, pc))
            except KLLMsError as e:
                keep("parse", ("typed", e.status_code, e))

        def wide():
            try:
                cc = client.chat.completions.create(
                    messages=[{"role": "user", "content": "wide"}], n=8, seed=50,
                    temperature=0.8, max_tokens=8)
                keep("wide", ("ok", 200, cc))
            except KLLMsError as e:
                keep("wide", ("typed", e.status_code, e))

        def batch():
            lines = "\n".join(json.dumps({
                "custom_id": f"c{i}", "method": "POST", "url": "/v1/chat/completions",
                "body": {"messages": [{"role": "user", "content": f"offline {i}"}], "n": 1,
                         "seed": 60 + i, "max_tokens": 8}}) for i in range(2))
            conn, resp = _post(port, "/v1/batches", lines.encode())
            job = json.loads(resp.read())
            conn.close()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                status, wire = _get_json(port, f"/v1/batches/{job['id']}")
                if wire["status"] in ("completed", "completed_with_errors", "cancelled"):
                    break
                time.sleep(0.05)
            keep("batch", ("ok" if wire["status"] == "completed" else "typed", status, wire))

        hangs = RECOVERY_EVENTS.get("continuous.step_hangs")
        threads = [threading.Thread(target=f) for f in
                   (lambda: http_json(0), lambda: http_json(1), http_stream, http_disconnect,
                    parse, wide, batch)]
        with fp.failpoints({
            "continuous.step": FailSpec(action="hang", times=1, delay=8.0),
            "continuous.prefill": FailSpec(action="hang", times=1, delay=8.0),
        }):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            # Zero hung futures: every client returned.
            assert not any(t.is_alive() for t in threads)
        # One NaN row in a coalesced launch (a logit bias keeps the request
        # off the loop): quarantined, reported to the scheduler and the
        # supervisor from inside the launch.
        quarantined = QUARANTINE_EVENTS.get("quarantine.samples")
        with fp.failpoints({"engine.logits": FailSpec(action="nan", kill=1, seed=13, times=1)}):
            poisoned = client.chat.completions.create(
                messages=[{"role": "user", "content": "poison"}], n=4, seed=70,
                temperature=0.8, max_tokens=8, logit_bias={"65": 1.0})
        assert QUARANTINE_EVENTS.get("quarantine.samples") == quarantined + 1
        assert len(poisoned.choices) >= 1
        assert sorted(results) == sorted(
            ["json0", "json1", "stream", "disconnect", "parse", "wide", "batch"])
        assert RECOVERY_EVENTS.get("continuous.step_hangs") >= hangs + 2
        # Success or a typed error, never an untyped one.
        for key, (kind, status, _) in results.items():
            assert kind == "ok" or status in (408, 429, 500, 503), (key, status)
        assert results["wide"][0] == "ok" and results["batch"][0] == "ok"

        cont = backend.health()["continuous"]
        assert cont["restarts"] >= 2
        deadline = time.monotonic() + 30
        while backend.health()["continuous"].get("pages", {}).get("loop_refs") != 0:
            assert time.monotonic() < deadline, backend.health()["continuous"]
            time.sleep(0.05)
        backend.engine._kv_pool.allocator.verify()

        after = client.chat.completions.create(
            messages=[{"role": "user", "content": "after"}], n=2, seed=5, max_tokens=8)
        assert len(after.choices) == 3
        assert backend.health()["state"] == "ready"
        srv.stop(drain=False)
    client.close()

    edges = lockcheck.graph()
    named = {name for edge in edges for name in edge}
    for name in ARMED_LOCKS:
        assert name in named, (name, sorted(edges))
    lockcheck.assert_clean()


def test_a_kernel_launch_is_a_device_dispatch(monkeypatch):
    """Every kernel wrapper counts its launch through ``_ext.note_launch``,
    which marks a device dispatch: under a checked lock made without
    ``allow_dispatch`` it is one violation (the card smoke's mutant), under
    one made with it none."""
    from k_llms_tpu_torch.ops import _ext

    monkeypatch.setenv("KLLMS_LOCKCHECK", "1")
    lockcheck.reset_state()
    counts = dict(_ext.LAUNCH_COUNTS)
    try:
        with lockcheck.make_lock("t.launch_gate", allow_dispatch=True):
            _ext.note_launch("paged_decode_attention")
        assert lockcheck.violations() == []
        with lockcheck.make_lock("t.plain_guard"):
            _ext.note_launch("paged_decode_attention")
        (found,) = lockcheck.violations()
        assert "kernel paged_decode_attention" in found and "t.plain_guard" in found
    finally:
        _ext.LAUNCH_COUNTS.update(counts)
        lockcheck.reset_state()
