"""The port's request tracing, latency histograms and flight recorder
(``k_llms_tpu_torch/observability/``): twins of ``tests/test_tracing.py``.

- W3C ``traceparent`` parsing and formatting give the JAX package's answers
  on the same vectors; a malformed header never fails a trace.
- ``/metrics`` is valid Prometheus text with the JAX app's families.
- A ``traceparent`` joins the ``KLLMS_TRACE=1`` timings and the request's
  ``/debug/requests`` record; ``POST /debug/profile`` writes a
  ``torch.profiler`` trace; the ``serving.trace`` drop failpoint degrades
  to no-op spans and the request completes.
- On the port's engine (fp32 ``tiny``, the JAX weights): the scheduler's
  and the loop's hooks attribute queue_wait, prefill, decode and
  consolidate; a request healed through the loop's rebuild and replay has
  one flight record, annotated ``replayed``; the tokens are the same traced,
  dropped and untraced.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from _torch_serving import port_backend, port_params
from _torch_wire import BODY, both, exchange, fake_client, parse_prometheus, pkg
from k_llms_tpu_torch.observability import trace as port_trace
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.utils.observability import (
    FLIGHT_RECORDER,
    LATENCY,
    NOOP_TRACE,
    TRACER,
    LatencyHistograms,
    format_traceparent,
    parse_traceparent,
    use_trace,
)

TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"

HEADERS = [
    TRACEPARENT,
    None,
    "",
    "not-a-traceparent",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-XYZ92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parsing_equals_jax(header):
    from k_llms_tpu.observability.trace import parse_traceparent as jax_parse

    assert parse_traceparent(header) == jax_parse(header)
    trace = TRACER.start(header)
    assert not trace.noop and len(trace.trace_id) == 32
    if parse_traceparent(header) is not None:
        assert trace.trace_id == TRACE_ID and trace.parent_span_id == "00f067aa0ba902b7"
        out = format_traceparent(trace.trace_id, trace.span_id, trace.flags)
        assert parse_traceparent(out) == (TRACE_ID, trace.span_id, "01")


def test_histogram_vocabulary_is_enforced():
    h = LatencyHistograms(declared=("a.b", "keyed.*"), buckets=(0.1, 1.0))
    h.observe("a.b", 0.05)
    h.observe("keyed.route", 5.0)
    with pytest.raises(ValueError, match="not declared"):
        h.observe("a.typo", 0.05)
    snap = h.snapshot()
    assert snap["a.b"]["count"] == 1
    assert snap["keyed.route"]["buckets"] == [(0.1, 0), (1.0, 0)]
    assert snap["keyed.route"]["count"] == 1


def test_metrics_scrape_is_valid_and_has_the_jax_families():
    """After the same request, the port's ``/metrics`` parses as Prometheus
    0.0.4 (cumulative buckets closed by ``+Inf`` = ``_count``) and declares
    the JAX app's families with the same types and help."""
    scrapes = []
    for p in both():
        resps = exchange(p.ServingApp(fake_client(p)),
                         [("POST", "/v1/chat/completions", {"json": BODY}), ("GET", "/metrics", {})])
        assert resps[1].status_code == 200 and "version=0.0.4" in resps[1].headers["content-type"]
        scrapes.append(parse_prometheus(resps[1].text))
    jax_fams, port_fams = scrapes

    def declared(fams):
        # Per-tenant families appear once a tenant is observed, which other
        # tests in the process may have done in one package and not the other.
        return {f: (d["type"], d["help"]) for f, d in fams.items() if "_by_tenant_" not in f}

    assert declared(port_fams) == declared(jax_fams)
    assert "kllms_request_e2e_by_tenant_seconds" in port_fams
    hists = {f: d for f, d in port_fams.items() if d["type"] == "histogram"}
    for fam in ("kllms_request_e2e_seconds", "kllms_request_ttft_seconds",
                "kllms_scheduler_queue_wait_seconds", "kllms_continuous_step_seconds",
                "kllms_engine_decode_launch_seconds", "kllms_consensus_consolidate_seconds"):
        assert fam in hists, fam
    for fam, data in hists.items():
        groups = {}
        for n, labels, v in data["samples"]:
            key = ",".join(x for x in labels.split(",") if x and not x.startswith("le="))
            groups.setdefault(key, []).append((n, labels, v))
        for samples in groups.values():
            buckets = [(labels, v) for n, labels, v in samples if n == fam + "_bucket"]
            counts = [v for n, _, v in samples if n == fam + "_count"]
            values = [v for _, v in buckets]
            assert values == sorted(values) and buckets[-1][0].endswith('le="+Inf"')
            assert values[-1] == counts[0]
    assert any(n.endswith("_count") and v >= 1
               for n, _, v in port_fams["kllms_request_e2e_seconds"]["samples"])


def test_traceparent_joins_timings_and_flight_record(monkeypatch):
    monkeypatch.setenv("KLLMS_TRACE", "1")
    p = pkg("k_llms_tpu_torch")
    client = fake_client(p)
    client.backend.backend_config = SimpleNamespace(debug_endpoints=True)
    e2e_before = LATENCY.count("request.e2e")
    chat, debug = exchange(p.ServingApp(client), [
        ("POST", "/v1/chat/completions", {"json": BODY, "headers": {"traceparent": TRACEPARENT}}),
        ("GET", "/debug/requests", {})])
    assert chat.status_code == 200
    timings = chat.json()["timings"]
    assert timings["trace_id"] == TRACE_ID and "consolidate" in timings
    payload = debug.json()
    assert payload["capacity"] >= payload["held"] >= 1
    (rec,) = [r for r in payload["requests"] if r["trace_id"] == TRACE_ID]
    assert (rec["route"], rec["status"], rec["n"]) == ("chat", 200, 3)
    assert rec["parent_span_id"] == "00f067aa0ba902b7" and rec["duration_s"] > 0
    assert LATENCY.count("request.e2e") > e2e_before


def test_debug_profile_writes_a_torch_profiler_trace(tmp_path):
    p = pkg("k_llms_tpu_torch")
    client = fake_client(p)
    client.backend.backend_config = SimpleNamespace(debug_endpoints=True)
    ok, bad = exchange(p.ServingApp(client), [
        ("POST", "/debug/profile", {"json": {"duration_s": 0.01, "log_dir": str(tmp_path)}}),
        ("POST", "/debug/profile", {"content": b"{nope"})])
    assert ok.status_code == 200 and ok.json()["log_dir"] == str(tmp_path)
    assert 0.01 <= ok.json()["duration_s"] <= 10.0
    assert [f.name.endswith(".pt.trace.json") for f in tmp_path.iterdir()] == [True]
    assert bad.status_code == 400


def test_serving_trace_drop_degrades_to_noop_and_the_request_completes(monkeypatch):
    monkeypatch.setenv("KLLMS_TRACE", "1")
    p = pkg("k_llms_tpu_torch")
    total_before = FLIGHT_RECORDER.stats()["recorded_total"]
    spec = FailSpec(action="drop", times=1)
    with fp.failpoints({"serving.trace": spec}):
        (resp,) = exchange(p.ServingApp(fake_client(p)), [
            ("POST", "/v1/chat/completions", {"json": BODY, "headers": {"traceparent": TRACEPARENT}})])
    assert spec._fired == 1 and resp.status_code == 200
    data = resp.json()
    assert data["choices"][0]["message"]["content"]
    assert "trace_id" not in data.get("timings", {})
    assert FLIGHT_RECORDER.stats()["recorded_total"] == total_before
    assert not TRACER.start().noop
    fp.configure_from_env("serving.trace=drop:2")
    try:
        assert TRACER.start() is NOOP_TRACE and TRACER.start() is NOOP_TRACE
        assert not TRACER.start().noop
    finally:
        fp.clear()


# -- the port's engine: the phases its hooks attribute ---------------------------


def test_scheduler_hooks_attribute_the_phases_of_a_create():
    """A ``create()`` through the port's backend: its trace holds the
    scheduler's queue_wait and decode inside sample, then consolidate, and
    its flight record's phases fit its wall time."""
    from k_llms_tpu_torch import KLLMs

    client = KLLMs(backend=port_backend(paged=True), model="tiny")
    trace = TRACER.start()
    try:
        with use_trace(trace):
            client.chat.completions.create(messages=[{"role": "user", "content": "hi"}],
                                           n=2, seed=1, max_tokens=4)
    finally:
        client.close()
    rec = TRACER.finish(trace, route="test", status="ok", n=2)
    phases = rec["phases"]
    for name in ("queue_wait", "decode", "sample", "consolidate"):
        assert name in phases, phases
    assert phases["queue_wait"] + phases["decode"] <= phases["sample"]
    assert phases["sample"] + phases["consolidate"] <= rec["duration_s"]


def _loop(**kw):
    from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop
    from k_llms_tpu_torch.engine.engine import LocalEngine

    engine = LocalEngine("tiny", params=port_params(), device="cpu", kv_layout="paged",
                         kv_page_size=8)
    return engine, ContinuousDecodeLoop(engine, width=4, max_prompt=64, max_new=32, **kw)


def test_loop_rebuild_and_replay_yields_one_flight_record_annotated():
    """A request that survives a hung step, a rebuild and the journal replay
    finishes with one flight record for its trace, annotated ``replayed``,
    holding the loop's queue_wait, prefill and decode phases."""
    from k_llms_tpu_torch.reliability.supervisor import LaunchBudgetModel

    budget = LaunchBudgetModel(base_s=0.1, per_token_s=0.01, multiplier=1.0,
                               min_budget_s=2.0, max_budget_s=2.0)
    engine, loop = _loop(budget_model=budget, rebuild_fn=lambda: engine, max_rebuilds=3)
    trace = TRACER.start()
    try:
        with fp.failpoints({"continuous.step": FailSpec(action="hang", times=1, delay=6.0)}):
            with use_trace(trace):
                fut = loop.submit([5, 6, 7, 8], n=2, max_new=8, temperature=0.0, top_p=None, seed=23)
            got = fut.result(timeout=60)
        assert int(got.lengths[0]) > 0 and loop.stats["replayed_rows"] >= 2
    finally:
        loop.stop()
    TRACER.finish(trace, route="continuous", status="ok", n=2)
    TRACER.finish(trace, route="continuous", status="ok", n=2)
    (rec,) = [r for r in FLIGHT_RECORDER.snapshot() if r["trace_id"] == trace.trace_id]
    assert rec["annotations"].get("replayed") is True
    assert rec["annotations"].get("replayed_rows", 0) >= 2
    for phase in ("queue_wait", "prefill", "decode"):
        assert phase in rec["phases"], rec["phases"]


def test_tracing_leaves_the_tokens_unchanged():
    """The same seeded loop request decodes the same tokens with a live
    trace, with the tracer dropped by ``serving.trace`` and untraced."""
    outs = []
    for mode in ("traced", "dropped", "untraced"):
        _, loop = _loop()
        try:
            if mode == "traced":
                trace = TRACER.start()
            elif mode == "dropped":
                with fp.failpoints({"serving.trace": FailSpec(action="drop", times=1)}):
                    trace = TRACER.start()
                assert trace.noop
            else:
                trace = None
            with use_trace(trace):
                fut = loop.submit([5, 6, 7, 8], n=2, max_new=8, temperature=0.8, top_p=0.9, seed=23)
            outs.append(fut.result(timeout=60))
        finally:
            loop.stop()
    for other in outs[1:]:
        np.testing.assert_array_equal(outs[0].tokens, other.tokens)
        np.testing.assert_array_equal(outs[0].logprobs, other.logprobs)


def test_the_trace_module_is_the_package_copy():
    assert port_trace.TRACER is TRACER
