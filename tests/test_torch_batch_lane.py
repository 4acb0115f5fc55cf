"""The port's offline batch lane (``k_llms_tpu_torch/serving/batch.py`` over the
job store) held against the JAX package's: twins of
``tests/test_batch_lane.py``, chaos cases included.

The HTTP scenarios run through both packages' ``ServingApp`` with their
``FakeBackend`` and a frozen clock; every response equals JAX's once the
random job id is replaced by a placeholder (the output records' ids are
content-derived, so the output files are equal byte for byte). The lane's
chaos cases run on the port: a typed error captured into the output, the
``batch.worker`` crash failpoint contained, drain then recovery exactly
once, the owner's batch lane, and a SIGKILL mid-job recovered into output
bytes equal to an uninterrupted run.
"""

import asyncio
import json
import os
import signal  # noqa: F401  (the child script's SIGKILL)
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from _torch_wire import asgi, both, pkg, run

REPO = Path(__file__).resolve().parent.parent
PORT = "k_llms_tpu_torch"


def _jsonl(n, seed_base=100):
    return "\n".join(json.dumps({
        "custom_id": f"c{i}", "method": "POST", "url": "/v1/chat/completions",
        "body": {"messages": [{"role": "user", "content": f"question {i}"}], "n": 1,
                 "seed": seed_base + i}}) for i in range(n)).encode()


def _client(p, gate=None):
    client = p.KLLMs(backend=p.FakeBackend(), model="fake-model")
    if gate is not None:
        inner = client.chat.completions.create

        def gated(**kwargs):
            assert gate.wait(30)
            return inner(**kwargs)

        client.chat.completions.create = gated
    return client


async def _poll_terminal(c, jid, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = await c.get(f"/v1/batches/{jid}")
        if r.json()["status"] in ("completed", "completed_with_errors", "cancelled"):
            return r
        await asyncio.sleep(0.01)
    raise AssertionError(f"job {jid} never reached a terminal status")


async def submit_poll_output(c, gate):
    r = [await c.post("/v1/batches", content=_jsonl(4))]
    jid = r[0].json()["id"]
    return r + [await _poll_terminal(c, jid), await c.get(f"/v1/batches/{jid}/output"),
                await c.get(f"/v1/batches/{jid}")]


async def not_found_and_method(c, gate):
    return [await c.get("/v1/batches/batch_nope"), await c.get("/v1/batches"),
            await c.post("/healthz"), await c.get("/v1/nope")]


async def conflict_before_terminal(c, gate):
    r = [await c.post("/v1/batches", content=_jsonl(2))]
    jid = r[0].json()["id"]
    r.append(await c.get(f"/v1/batches/{jid}/output"))
    gate.set()
    return r + [await _poll_terminal(c, jid), await c.get(f"/v1/batches/{jid}/output")]


async def cancel(c, gate):
    r = [await c.post("/v1/batches", content=_jsonl(3))]
    jid = r[0].json()["id"]
    r.append(await c.post(f"/v1/batches/{jid}/cancel"))
    gate.set()
    return r + [await c.get(f"/v1/batches/{jid}/output")]


async def bad_jsonl(c, gate):
    bodies = [b"not json\n", b"", json.dumps({
        "custom_id": "x", "method": "GET", "url": "/v1/embeddings",
        "body": {"messages": [{"role": "user", "content": "hi"}]}}).encode(),
        json.dumps({"body": {"messages": []}}).encode()]
    return [await c.post("/v1/batches", content=b) for b in bodies]


HTTP_SCENARIOS = {f.__name__: f for f in (submit_poll_output, not_found_and_method,
                                          conflict_before_terminal, cancel, bad_jsonl)}


def _normalised(resps):
    ids = set()
    for r in resps:
        if r.headers.get("content-type") == "application/json":
            body = r.json()
            if isinstance(body, dict) and str(body.get("id", "")).startswith("batch_"):
                ids.add(body["id"])
    out = []
    for r in resps:
        text = r.content
        for jid in ids:
            text = text.replace(jid.encode(), b"<job>")
        out.append((r.status_code, r.headers.get("content-type"), r.headers.get("allow"), text))
    return out


@pytest.mark.parametrize("name", sorted(HTTP_SCENARIOS))
def test_http_scenario_equals_jax(name, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    outs = []
    for p in both():
        gate = threading.Event()
        gated = name in ("conflict_before_terminal", "cancel")
        app = p.ServingApp(_client(p, gate if gated else None), batch_dir=str(tmp_path / p.root))

        async def go():
            async with asgi(app) as c:
                return await HTTP_SCENARIOS[name](c, gate)

        try:
            outs.append(_normalised(run(go())))
        finally:
            gate.set()
            app.drain()
    assert outs[1] == outs[0]
    if name == "submit_poll_output":
        status, _, _, body = outs[1][2]
        assert status == 200 and [json.loads(x)["custom_id"] for x in body.splitlines()] == [
            "c0", "c1", "c2", "c3"]


# -- the lane's chaos cases (port) ----------------------------------------------


def _lane(tmp_path, client=None, **kw):
    p = pkg(PORT)
    return p, p.batch.BatchLane(client or _client(p), p.jobstore.JobStore(tmp_path), **kw)


def _ids(lane, jid):
    return [json.loads(x)["id"] for x in lane.output_bytes(jid).splitlines()]


def test_typed_error_captured_into_output(tmp_path):
    p = pkg(PORT)
    client = _client(p)
    inner = client.chat.completions.create

    def flaky(**kwargs):
        if "poison" in kwargs["messages"][-1]["content"]:
            raise p.wire.InvalidRequestError("poisoned item", param="messages")
        return inner(**kwargs)

    client.chat.completions.create = flaky
    _, lane = _lane(tmp_path, client, max_in_flight=2)
    body = b"\n".join(json.dumps({"body": {"messages": [{"role": "user", "content": c}],
                                           "seed": i}}).encode()
                      for i, c in enumerate(["fine", "poison", "also fine"]))
    wire = lane.submit(body, tenant="default")
    assert lane.wait_idle(30), lane.health()
    final = lane.job_wire(wire["id"])
    assert final["status"] == "completed_with_errors"
    assert final["request_counts"] == {"total": 3, "completed": 2, "failed": 1}
    records = [json.loads(x) for x in lane.output_bytes(wire["id"]).splitlines()]
    assert records[1]["response"] is None and records[1]["error"]["status_code"] == 400
    assert records[0]["error"] is None and records[2]["error"] is None
    lane.close()


def test_worker_crash_failpoint_contained_and_the_job_completes(tmp_path):
    p, lane = _lane(tmp_path, max_in_flight=2)
    before = p.obs.BATCH_EVENTS.get("batch.worker_crashes")
    spec = p.fp.FailSpec(action="crash", times=1)
    with p.fp.failpoints({"batch.worker": spec}):
        wire = lane.submit(_jsonl(5), tenant="default")
        assert lane.wait_idle(30), lane.health()
    assert spec._fired == 1
    assert lane.job_wire(wire["id"])["status"] == "completed"
    assert p.obs.BATCH_EVENTS.get("batch.worker_crashes") == before + 1
    assert lane.health()["worker_respawns"] >= 1
    ids = _ids(lane, wire["id"])
    assert len(ids) == 5 and len(set(ids)) == 5
    lane.close()


def test_drain_requeues_then_recovery_completes_exactly_once(tmp_path):
    p = pkg(PORT)
    client = _client(p)
    gate, entered = threading.Event(), threading.Event()
    inner = client.chat.completions.create

    def gated(**kwargs):
        entered.set()
        assert gate.wait(30)
        return inner(**kwargs)

    client.chat.completions.create = gated
    store = p.jobstore.JobStore(tmp_path)
    lane = p.batch.BatchLane(client, store, max_in_flight=1)
    wire = lane.submit(_jsonl(3), tenant="default")
    assert entered.wait(10)
    lane.drain(timeout=0.3)
    assert store.job(wire["id"]).items.count("pending") == 3
    gate.set()
    seg0 = tmp_path / "jobs" / wire["id"] / "out" / "00000.json"
    deadline = time.monotonic() + 10
    while not seg0.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert seg0.exists()
    lane.close()
    client.chat.completions.create = inner
    lane2 = p.batch.BatchLane(client, p.jobstore.JobStore(tmp_path), max_in_flight=2)
    assert lane2.recover() == 1
    assert lane2.wait_idle(30), lane2.health()
    assert lane2.job_wire(wire["id"])["status"] == "completed"
    ids = _ids(lane2, wire["id"])
    assert len(ids) == 3 and len(set(ids)) == 3
    lane2.close()


def test_lane_runs_under_the_owners_batch_lane(tmp_path):
    p = pkg(PORT)
    seen = {}
    client = _client(p)
    inner = client.chat.completions.create

    def spy(**kwargs):
        seen["tenant"] = kwargs.get("tenant")
        return inner(**kwargs)

    client.chat.completions.create = spy

    class Tenancy:
        def batch_lane(self, owner):
            return type("Ctx", (), {"name": f"{owner}#batch"})()

    client.backend.tenancy = Tenancy()
    _, lane = _lane(tmp_path, client, max_in_flight=1)
    wire = lane.submit(_jsonl(1), tenant="acme")
    assert lane.wait_idle(30)
    assert seen["tenant"] == "acme#batch"
    assert lane.job_wire(wire["id"])["status"] == "completed"
    lane.close()


_CHILD = r"""
import json, os, signal, sys, time

time.time = lambda: 1_700_000_000.0

root, mode = sys.argv[1], sys.argv[2]

from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends.fake import FakeBackend
from k_llms_tpu_torch.reliability.jobstore import JobStore
from k_llms_tpu_torch.serving.batch import BatchLane

client = KLLMs(backend=FakeBackend(), model="fake-model")
store = JobStore(root)
lane = BatchLane(client, store, max_in_flight=1)
jid_file = os.path.join(root, "jid.txt")
if os.path.exists(jid_file):
    jid = open(jid_file).read().strip()
    lane.recover()
else:
    body = "\n".join(json.dumps({"custom_id": "c%d" % i, "body": {
        "messages": [{"role": "user", "content": "question %d" % i}], "n": 1,
        "seed": 1000 + i}}) for i in range(6)).encode()
    jid = lane.submit(body, tenant="default")["id"]
    with open(jid_file, "w") as fh:
        fh.write(jid)
if mode == "run":
    ok = lane.wait_idle(90)
    status = store.job(jid).status
    lane.close()
    sys.exit(0 if ok and status == "completed" else 3)
kill_after = int(mode)
outdir = os.path.join(root, "jobs", jid, "out")
deadline = time.monotonic() + 90
while time.monotonic() < deadline:
    if len([f for f in os.listdir(outdir) if f.endswith(".json")]) >= kill_after:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(0.005)
sys.exit(4)
"""


@pytest.mark.duration_budget(30)
def test_sigkill_recovery_output_byte_identical(tmp_path):
    """A child process running the port's lane SIGKILLs itself after two
    committed items; a second child recovers and finishes. The output
    equals an uninterrupted run's byte for byte."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(REPO)

    def child(root, mode):
        return subprocess.run([sys.executable, str(script), str(root), mode], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)

    def output(root):
        jid = (root / "jid.txt").read_text().strip()
        return (root / "jobs" / jid / "output.jsonl").read_bytes()

    clean, killed = tmp_path / "clean", tmp_path / "killed"
    clean.mkdir()
    killed.mkdir()
    assert child(clean, "run").returncode == 0
    assert child(killed, "2").returncode == -9
    assert child(killed, "run").returncode == 0
    assert output(killed) == output(clean)
    assert len(output(clean).splitlines()) == 6
