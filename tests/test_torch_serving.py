"""The port's HTTP front door (``k_llms_tpu_torch/serving/``) held against the
JAX package's: twins of ``tests/test_serving.py``.

The same requests go into JAX's ``ServingApp`` and the port's over
``httpx.ASGITransport``, each with its package's ``FakeBackend``; with the
clock frozen, the response bodies and the SSE bytes are equal byte for byte
(no field needs normalising: the fake backend's ids hash the request, and
``created`` reads the frozen clock). Then the port's own backend over the
wire on the CPU (fp32 ``tiny`` with the JAX weights): the non-streamed
bytes equal the in-process ``create()``'s, a stream delivers every sample
before its final event, and the ``serving.request`` failpoint fires. The
socket tier stands up the port's stdlib ``ServerThread`` on loopback.
"""

import json
import time

import httpx
import pytest

from _torch_serving import port_backend
from _torch_wire import BODY, both, exchange, fake_client, pkg

PORT = "k_llms_tpu_torch"


@pytest.fixture
def frozen(monkeypatch):
    now = int(time.time())
    monkeypatch.setattr(time, "time", lambda: now)
    return now


def _both_exchange(calls, client_fn=fake_client):
    """Responses of JAX's app and the port's to the same calls."""
    return [exchange(p.ServingApp(client_fn(p)), calls) for p in both()]


CALLS = {
    "nonstream": [("POST", "/v1/chat/completions", {"json": BODY})],
    "stream": [("POST", "/v1/chat/completions", {"json": {**BODY, "stream": True}})],
    "bad_json": [("POST", "/v1/chat/completions", {"content": b"{nope"})],
    "no_messages": [("POST", "/v1/chat/completions", {"json": {"messages": []}})],
    "not_an_object": [("POST", "/v1/chat/completions", {"json": [1, 2]})],
    "unknown_route": [("GET", "/unknown/route", {})],
    "wrong_method": [("GET", "/v1/chat/completions", {})],
    "healthz": [("GET", "/healthz", {})],
    "debug_off": [("GET", "/debug/requests", {}), ("POST", "/debug/profile", {"json": {}})],
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_wire_bytes_equal_jax(frozen, case):
    """Status, content type and body bytes of every response are JAX's."""
    jax_resps, port_resps = _both_exchange(CALLS[case])
    for j, t in zip(jax_resps, port_resps):
        assert t.status_code == j.status_code
        assert t.headers.get("content-type") == j.headers.get("content-type")
        assert t.headers.get("allow") == j.headers.get("allow")
        assert t.content == j.content


def test_nonstream_bytes_equal_inprocess_create(frozen):
    p = pkg(PORT)
    (resp,) = exchange(p.ServingApp(fake_client(p)), CALLS["nonstream"])
    direct = fake_client(p).chat.completions.create(**BODY)
    assert resp.content == json.dumps(direct.model_dump(mode="json"), separators=(",", ":")).encode()


def test_sse_event_order_and_final_consensus():
    p = pkg(PORT)
    (resp,) = exchange(p.ServingApp(fake_client(p)), CALLS["stream"])
    assert resp.headers["content-type"].startswith("text/event-stream")
    events = list(p.sse.parse_stream(resp.content))
    assert events[-1] == ("done", None)
    datas = [d for kind, d in events if kind == "data"]
    finals = [d for d in datas if d["object"] == "chat.completion"]
    assert len(finals) == 1 and datas[-1] is finals[0]
    per_sample = {}
    for d in datas[:-1]:
        c = d["choices"][0]
        per_sample.setdefault(c["index"], []).append(c["delta"])
    for idx in (1, 2, 3):
        deltas = per_sample[idx]
        assert deltas[0].get("role") == "assistant"
        assert all("role" not in d for d in deltas[1:])
        text = "".join(d.get("content") or "" for d in deltas)
        assert text == finals[0]["choices"][idx]["message"]["content"]
    assert finals[0]["choices"][0]["index"] == 0 and finals[0]["likelihoods"]


def test_stream_counters_move():
    p = pkg(PORT)
    before = p.obs.STREAM_EVENTS.snapshot()
    exchange(p.ServingApp(fake_client(p)), CALLS["stream"])
    after = p.obs.STREAM_EVENTS.snapshot()
    for key in ("streams.opened", "streams.completed", "tokens.streamed"):
        assert after.get(key, 0) > before.get(key, 0), key


ERRORS = {
    "rate_limit": ("RateLimitError", ("queue full",), {"retry_after": 7.0}, 429),
    "draining": ("ServerDrainingError", ("draining",), {}, 503),
    "unavailable": ("BackendUnavailableError", ("engine down",), {}, 503),
    "timeout": ("RequestTimeoutError", ("deadline exceeded",), {}, 408),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_typed_wire_errors_map_to_http_as_in_jax(case):
    """A backend's typed error becomes the same status, body and
    ``Retry-After`` in both packages."""
    name, args, kw, status = ERRORS[case]

    def erroring(p):
        exc = getattr(p.wire, name)(*args, **kw)

        class ErrorBackend(p.FakeBackend):
            def chat_completion(self, request):
                raise exc

        return p.KLLMs(backend=ErrorBackend(["x"]), model="m")

    jax_resps, port_resps = _both_exchange(CALLS["nonstream"], erroring)
    (j,), (t,) = jax_resps, port_resps
    assert t.status_code == j.status_code == status
    assert t.content == j.content
    assert t.headers.get("retry-after") == j.headers.get("retry-after")


def test_stream_on_a_non_streaming_backend_is_a_typed_400():
    p = pkg(PORT)

    class NoStream(p.FakeBackend):
        supports_streaming = False

    client = p.KLLMs(backend=NoStream(["x"]), model="m")
    with pytest.raises(p.wire.InvalidRequestError) as err:
        client.chat.completions.create(**BODY, stream=True)
    assert err.value.param == "stream" and err.value.status_code == 400
    (resp,) = exchange(p.ServingApp(client), CALLS["stream"])
    assert resp.status_code == 400 and resp.json()["error"]["param"] == "stream"


def test_parse_rejects_stream():
    from pydantic import BaseModel

    p = pkg(PORT)

    class Out(BaseModel):
        x: int

    with pytest.raises(p.wire.InvalidRequestError, match="parse"):
        fake_client(p).chat.completions.parse(
            messages=BODY["messages"], response_format=Out, stream=True)


@pytest.mark.parametrize("action", ["raise", "disconnect"])
def test_serving_request_failpoint_fires_as_in_jax(frozen, action):
    """``serving.request``: ``raise`` maps to a 500 and the next request is
    clean; ``disconnect`` truncates the stream after its first delta (no
    final event, no ``[DONE]``) and counts a disconnect. Both packages
    answer with the same bytes."""
    calls = CALLS["nonstream"] + CALLS["nonstream"] if action == "raise" else CALLS["stream"]
    out = []
    for p in both():
        spec = p.fp.FailSpec(action=action, times=1)
        before = p.obs.SERVE_EVENTS.get("request.disconnect")
        with p.fp.failpoints({"serving.request": spec}):
            resps = exchange(p.ServingApp(fake_client(p)), calls)
        assert spec._fired == 1
        out.append((resps, p.obs.SERVE_EVENTS.get("request.disconnect") - before))
    (jax_resps, jax_drops), (port_resps, port_drops) = out
    assert [r.content for r in port_resps] == [r.content for r in jax_resps]
    assert [r.status_code for r in port_resps] == [r.status_code for r in jax_resps]
    if action == "raise":
        assert [r.status_code for r in port_resps] == [500, 200]
    else:
        events = list(pkg(PORT).sse.parse_stream(port_resps[0].content))
        assert events and all(d["object"] == "chat.completion.chunk" for _, d in events)
        assert port_drops == jax_drops == 1


# -- the port's backend over the wire (CPU, tiny, the JAX weights) -------------


@pytest.fixture(scope="module")
def tiny_app():
    p = pkg(PORT)
    client = p.KLLMs(backend=port_backend(paged=True), model="tiny")
    yield p.ServingApp(client), client
    client.close()


def test_cuda_backend_nonstream_bytes_equal_create(tiny_app, frozen):
    app, client = tiny_app
    body = {**BODY, "model": "tiny", "max_tokens": 8}
    (resp,) = exchange(app, [("POST", "/v1/chat/completions", {"json": body})])
    assert resp.status_code == 200
    direct = client.chat.completions.create(**body)
    assert resp.content == json.dumps(direct.model_dump(mode="json"), separators=(",", ":")).encode()


def test_cuda_backend_stream_delivers_each_sample_before_the_final(tiny_app):
    """A sampled stream through the engine's token tap: the deltas of each
    sample concatenate to its final text; the final event is the last
    before ``[DONE]`` and equals a non-streamed call with the same seed."""
    app, client = tiny_app
    body = {**BODY, "model": "tiny", "n": 2, "max_tokens": 8, "temperature": 0.9}
    (resp,) = exchange(app, [("POST", "/v1/chat/completions", {"json": {**body, "stream": True}})])
    events = list(pkg(PORT).sse.parse_stream(resp.content))
    assert resp.status_code == 200 and events[-1] == ("done", None)
    datas = [d for kind, d in events if kind == "data"]
    final = datas[-1]
    assert final["object"] == "chat.completion"
    for i in (1, 2):
        text = "".join(d["choices"][0]["delta"].get("content") or "" for d in datas[:-1]
                       if d["choices"][0]["index"] == i)
        assert text == final["choices"][i]["message"]["content"]
    direct = client.chat.completions.create(**body).model_dump(mode="json")
    assert {k: v for k, v in final.items() if k != "created"} == {
        k: v for k, v in direct.items() if k != "created"}


# -- the socket tier -----------------------------------------------------------


def test_real_socket_stream_and_keepalive_pings():
    """The stdlib HTTP/1.1 runner on loopback: health, a JSON request, and a
    stream whose backend stays quiet past ``sse_ping_interval_s`` (``: ping``
    comment frames, invisible to the SSE parser)."""
    from types import SimpleNamespace

    p = pkg(PORT)
    client = fake_client(p)
    backend = client.backend
    backend.backend_config = SimpleNamespace(sse_ping_interval_s=0.1)
    orig = backend.chat_completion_stream

    def slow_stream(request, emit):
        time.sleep(0.5)
        return orig(request, emit)

    backend.chat_completion_stream = slow_stream
    pings = p.obs.STREAM_EVENTS.get("streams.pings")
    with p.ServerThread(p.ServingApp(client)) as srv:
        assert httpx.get(srv.base_url + "/healthz", timeout=10).status_code == 200
        r = httpx.post(srv.base_url + "/v1/chat/completions", json=BODY, timeout=30)
        assert r.status_code == 200 and len(r.json()["choices"]) == BODY["n"] + 1
        with httpx.stream("POST", srv.base_url + "/v1/chat/completions",
                          json={**BODY, "stream": True}, timeout=30) as resp:
            raw = b"".join(resp.iter_raw())
    assert raw.count(b": ping\n\n") >= 2
    assert p.obs.STREAM_EVENTS.get("streams.pings") >= pings + 2
    events = list(p.sse.parse_stream(raw))
    assert events[-1] == ("done", None)
    assert any(d["object"] == "chat.completion" for kind, d in events if kind == "data")


def test_main_parses_the_port_backends_and_device():
    from k_llms_tpu_torch.serving.__main__ import _parse_args

    args = _parse_args(["--backend", "cuda", "--device", "cpu", "--model", "tiny"])
    assert (args.backend, args.device, args.model) == ("cuda", "cpu", "tiny")
    assert _parse_args([]).backend == "cuda" and _parse_args([]).device is None
    with pytest.raises(SystemExit):
        _parse_args(["--backend", "tpu"])
