"""Helpers for the serving-layer twins: one namespace per package (the JAX
package and the port) holding the same names, so that a scenario written
once runs against both, and the in-process ASGI transport the JAX package's
wire tests use (no sockets)."""

import asyncio
import importlib
from types import SimpleNamespace

import httpx

PACKAGES = ("k_llms_tpu", "k_llms_tpu_torch")

#: The request the JAX package's wire tests send.
BODY = {
    "messages": [{"role": "user", "content": "say something"}],
    "model": "fake-model",
    "n": 3,
    "seed": 11,
}

FAKE_RESPONSES = ["alpha beta gamma", "alpha beta", "delta"]


def pkg(root):
    """The modules of one package that the serving twins drive."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        root=root,
        KLLMs=mod("client").KLLMs,
        FakeBackend=mod("backends.fake").FakeBackend,
        ServingApp=mod("serving").ServingApp,
        ServerThread=mod("serving").ServerThread,
        sse=mod("serving.sse"),
        batch=mod("serving.batch"),
        fp=mod("reliability.failpoints"),
        jobstore=mod("reliability.jobstore"),
        scheduler=mod("engine.scheduler"),
        obs=mod("utils.observability"),
        prom=mod("observability.prometheus"),
        wire=mod("types.wire"),
    )


def both():
    return [pkg(root) for root in PACKAGES]


def fake_client(p, responses=None, **backend_kw):
    return p.KLLMs(backend=p.FakeBackend(responses or FAKE_RESPONSES, **backend_kw),
                   model="fake-model")


def asgi(app):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://testserver")


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def exchange(app, calls):
    """Send ``calls`` ((method, path, kwargs), ...) in order through the
    app; returns the httpx responses."""

    async def go():
        async with asgi(app) as c:
            return [await c.request(method, path, **kw) for method, path, kw in calls]

    return run(go())


def parse_prometheus(body):
    """A Prometheus 0.0.4 text parser: {family: {"type", "help", "samples":
    [(name, labels, value)]}}. Fails on a sample outside a HELP/TYPE'd
    family."""
    families = {}
    for line in body.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            families.setdefault(name, {"samples": []})["help"] = line.split(" ", 3)[3]
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            families.setdefault(name, {"samples": []})["type"] = kind
            continue
        assert not line.startswith("#"), f"unknown comment line: {line!r}"
        metric, _, value = line.rpartition(" ")
        name, labels = metric, ""
        if "{" in metric:
            name, _, rest = metric.partition("{")
            labels = rest.rstrip("}")
        fam = name
        if fam not in families:
            for suffix in ("_bucket", "_sum", "_count", "_total"):
                if name.endswith(suffix) and name[: -len(suffix)] in families:
                    fam = name[: -len(suffix)]
                    break
        assert fam in families, f"sample {name!r} outside any HELP/TYPE'd family"
        families[fam]["samples"].append((name, labels, float(value)))
    for fam, data in families.items():
        assert data.get("help") and data.get("type"), fam
    return families
