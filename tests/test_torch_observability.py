"""The port's observability surface held against the JAX package's: twins
of ``tests/test_observability.py`` and ``tests/test_metrics_tenant_labels.py``.

- ``Trace`` phases and ``confidence_histogram`` give JAX's answers.
- ``KLLMS_TRACE=1`` attaches ``timings`` (every backend) and, on the port's
  engine, ``engine_stats``; without it the wire payload is unchanged.
- Every counter group declares JAX's vocabulary, the serving, streaming
  and batch groups included; the one listed difference is the kernel
  group's rename of ``kernel.paged_attn_pallas_dispatch`` to
  ``kernel.paged_attn_cuda_dispatch`` (plus the card's
  ``kernel.paged_attn_unavailable.*``).
- Hostile tenant ids (API keys) are escaped in ``/metrics`` as in JAX.
- ``configure_logging`` and ``device_profiler`` (on ``torch.profiler``).
"""

import pytest

from _torch_serving import port_backend
from _torch_wire import BODY, both, exchange, fake_client, pkg
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.utils import observability as obs

#: The kernel group's documented difference: (JAX names, port names).
KERNEL_RENAME = ({"kernel.paged_attn_pallas_dispatch"},
                 {"kernel.paged_attn_cuda_dispatch", "kernel.paged_attn_unavailable.*"})


def test_trace_phases():
    t = obs.Trace()
    with t.phase("a"):
        pass
    with t.phase("b"):
        with t.phase("a"):
            pass
    d = t.as_dict()
    assert set(d) == {"a", "b"} and d["a"] >= 0


@pytest.mark.parametrize("likelihoods", [
    {"a": 0.9, "b": [0.1, 0.5], "c": {"d": 1.0, "reason": True}},
    {},
    [1.5, -0.2, 0.35, 0.999, 0.0],
])
def test_confidence_histogram_equals_jax(likelihoods):
    from k_llms_tpu.utils.observability import confidence_histogram as jax_histogram

    assert obs.confidence_histogram(likelihoods) == jax_histogram(likelihoods)
    assert obs.confidence_histogram(likelihoods, bins=4) == jax_histogram(likelihoods, bins=4)


def test_timings_attached_when_traced_and_absent_by_default(monkeypatch):
    req = dict(messages=[{"role": "user", "content": "q"}], model="m", n=2)
    monkeypatch.delenv("KLLMS_TRACE", raising=False)
    plain = KLLMs(backend="fake", responses=[["a", "a"]]).chat.completions.create(**req)
    assert getattr(plain, "timings", None) is None
    monkeypatch.setenv("KLLMS_TRACE", "1")
    resp = KLLMs(backend="fake", responses=[["a", "a"]]).chat.completions.create(**req)
    assert resp.timings["sample"] >= 0 and "consolidate" in resp.timings
    assert getattr(resp, "engine_stats", None) is None


def test_engine_stats_attached_when_traced(monkeypatch):
    monkeypatch.setenv("KLLMS_TRACE", "1")
    client = KLLMs(backend=port_backend(max_new_tokens=4), model="tiny")
    resp = client.chat.completions.create(messages=[{"role": "user", "content": "q"}],
                                          model="tiny", n=2, seed=1)
    client.close()
    stats = resp.engine_stats
    assert set(stats) == {"spec", "prefix_cache", "scheduler"}
    assert stats["spec"] == {}
    assert stats["prefix_cache"] == {"hits": 0, "partial_hits": 0, "misses": 0}
    assert stats["scheduler"]["served"] >= 1
    assert resp.timings["decode"] > 0 and resp.timings["queue_wait"] >= 0


def _groups(module):
    from k_llms_tpu_torch.utils.observability import EventCounters as PortCounters

    return {name: set(getattr(module, name).declared) for name in dir(module)
            if name.endswith("_EVENTS") and hasattr(getattr(module, name), "declared")
            and (module is obs) == isinstance(getattr(module, name), PortCounters)}


def test_counter_vocabularies_equal_jax_but_the_kernel_rename():
    from k_llms_tpu.utils import observability as jax_obs

    port, jax = _groups(obs), _groups(jax_obs)
    assert set(port) == set(jax)
    for name in ("SERVE_EVENTS", "STREAM_EVENTS", "BATCH_EVENTS"):
        assert port[name] == jax[name], name
    for name in set(port) - {"KERNEL_EVENTS"}:
        assert port[name] == jax[name], name
    assert jax["KERNEL_EVENTS"] - port["KERNEL_EVENTS"] == KERNEL_RENAME[0]
    assert port["KERNEL_EVENTS"] - jax["KERNEL_EVENTS"] == KERNEL_RENAME[1]
    assert set(obs.LATENCY.declared) == set(jax_obs.LATENCY.declared)


#: A tenant id with every character class the 0.0.4 format escapes, and an
#: attempted sample-line injection after a newline.
HOSTILE = 'ten"ant\\evil\nkllms_fake_total{x="y"} 999'


def test_escaping_equals_jax():
    snap = {"buckets": [(0.1, 1), (1.0, 2)], "sum": 0.3, "count": 2}
    texts = []
    for p in both():
        assert p.prom.escape_label_value('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
        fam = p.prom.labeled_histogram_family(
            "kllms_request_e2e_by_tenant_seconds", "per-tenant e2e", {HOSTILE: snap})
        texts.append(p.prom.render_families([fam]))
    assert texts[1] == texts[0]
    assert len(texts[1].strip().split("\n")) == 7 and "\nkllms_fake_total" not in texts[1]


def test_hostile_api_key_cannot_corrupt_the_scrape():
    p = pkg("k_llms_tpu_torch")
    app = p.ServingApp(fake_client(p, ["alpha beta", "alpha"]))
    try:
        chat, scrape = exchange(app, [
            ("POST", "/v1/chat/completions",
             {"json": {**BODY, "n": 2}, "headers": {"Authorization": 'Bearer k"ey\\with"quotes'}}),
            ("GET", "/metrics", {})])
        assert chat.status_code == 200 and scrape.status_code == 200
        assert 'tenant="k\\"ey\\\\with\\"quotes"' in scrape.text
        obs.LATENCY.observe(f"request.e2e.{HOSTILE}", 0.25)
        obs.TENANT_EVENTS.record(f"tenant.requests.{HOSTILE}")
        (scrape,) = exchange(app, [("GET", "/metrics", {})])
        for line in scrape.text.strip().split("\n"):
            assert line
            if not line.startswith("#"):
                name_and_labels, _, value = line.rpartition(" ")
                assert name_and_labels and not name_and_labels.startswith("{")
                float(value)
        assert 'kllms_fake_total{x="y"} 999' not in scrape.text
    finally:
        obs.LATENCY.reset()
        obs.TENANT_EVENTS.reset()


def test_configure_logging(monkeypatch):
    monkeypatch.setenv("ENV_NAME", "dev")
    assert obs.configure_logging().name == "k_llms_tpu_torch"
    assert obs.configure_logging().level == 10
    monkeypatch.setenv("ENV_NAME", "prod")
    assert obs.configure_logging().level == 20


def test_device_profiler_writes_a_trace_or_nothing(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("KLLMS_PROFILE_DIR", raising=False)
    with obs.device_profiler(None):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("KLLMS_PROFILE_DIR", str(tmp_path / "env"))
    with obs.device_profiler():
        torch.ones(4).sum()
    (trace,) = (tmp_path / "env").iterdir()
    assert trace.name.endswith(".pt.trace.json") and trace.stat().st_size > 0
