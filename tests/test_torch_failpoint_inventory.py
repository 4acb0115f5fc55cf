"""The port's failpoint inventory, on the port's own kllms-check AST scan.

Twin of ``tests/test_failpoint_inventory.py``: the ``failpoint-coverage``
rule, run over ``k_llms_tpu_torch`` with the port's tests as its context
(``tests/test_torch_*.py``), finds every registered site fired, named by a
port test and documented in the README, every action variant exercised,
and its AST registry equal to the runtime ``SITES`` tuple. The drills at the
end are the port's tests of the sites and actions no other port test named:
``scheduler.admit``, ``engine.pages`` (``leak``), ``replica.dispatch``
(``sleep``) and ``serving.request`` (``disconnect``), each run through both
packages where the JAX one is cheap.
"""

import pathlib
import time

import pytest

from _torch_wire import BODY, PACKAGES, asgi, fake_client, pkg, run
from k_llms_tpu_torch.analysis.framework import load_project, run_rules, unsuppressed
from k_llms_tpu_torch.analysis.rules.contracts import FailpointCoverageRule
from k_llms_tpu_torch.reliability.failpoints import SITES

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def project():
    return load_project(REPO)


def _registry():
    project = load_project(REPO, with_context=False)
    reg = project.find_file("reliability/failpoints.py")
    assert reg is not None and reg.rel.startswith("k_llms_tpu_torch/")
    return project, reg


def test_every_site_is_fired_tested_and_documented(project):
    """The full cross-surface sweep over the port: registry <-> call sites
    <-> the port's tests <-> README."""
    assert project.test_sources and all(
        pathlib.PurePosixPath(rel).name.startswith("test_torch_") for rel in project.test_sources
    )
    findings = unsuppressed(run_rules(project, ["failpoint-coverage"]))
    assert not findings, "\n".join(f.format() for f in findings)


def test_ast_registry_matches_runtime_registry():
    """The rule's AST extraction of the port's SITES equals the imported
    tuple, which is the JAX package's registry."""
    from k_llms_tpu.reliability.failpoints import SITES as JAX_SITES

    _, reg = _registry()
    sites = FailpointCoverageRule()._sites(reg)
    assert set(sites) == set(SITES) == set(JAX_SITES)
    assert len(sites) >= 21
    for site in sites:
        sub, _, name = site.partition(".")
        assert sub and name, f"site {site!r} must be subsystem.name"


@pytest.mark.parametrize("site", sorted(SITES))
def test_site_is_fired_in_the_port_and_named_by_a_port_test(site, project):
    """Each site has a literal fire()/fire_keyed() call in the port's
    modules and appears in some ``tests/test_torch_*.py``."""
    fired = {s for _, _, s in FailpointCoverageRule()._fire_calls(project)}
    assert site in fired
    assert any(site in text for text in project.test_sources.values())


def test_action_whitelist_is_extracted():
    _, reg = _registry()
    actions = FailpointCoverageRule()._actions(reg)
    assert len(actions) >= 4
    for action in ("raise", "hang", "crash", "drop", "exhaust", "torn", "leak", "sleep",
                   "disconnect"):
        assert action in actions


# --- drills of the sites and actions no other port test names ----------------

@pytest.mark.parametrize("root", PACKAGES)
def test_scheduler_admit_raises_at_submission(root):
    """``scheduler.admit`` fires at submit time, before any queueing: the
    fault reaches the caller synchronously, and the next call is served."""
    p = pkg(root)
    s = p.scheduler.EngineScheduler(name="admit-fp")
    try:
        with p.fp.failpoints({"scheduler.admit": p.fp.FailSpec(action="raise", times=1)}):
            with pytest.raises(RuntimeError, match="injected failpoint fault"):
                s.call(lambda: 1)
        assert s.call(lambda: 2) == 2
    finally:
        s.drain(timeout=5.0)


def test_pages_leak_quarantines_the_loop_pool():
    """``engine.pages=leak:N`` on slot retirement: the next ``stats`` read
    quarantines the pool (the accounting fault as data), and a bare loop
    without a rebuild path ends in a typed terminal state."""
    from _torch_serving import port_params
    from k_llms_tpu_torch.engine.continuous import ContinuousDecodeLoop
    from k_llms_tpu_torch.engine.engine import LocalEngine
    from k_llms_tpu_torch.reliability.failpoints import FailSpec, failpoints
    from k_llms_tpu_torch.types.wire import EngineHungError

    eng = LocalEngine("tiny", params=port_params(), device="cpu", kv_layout="paged",
                      kv_page_size=8)
    loop = ContinuousDecodeLoop(eng, width=2, max_prompt=32, max_new=8)
    try:
        with failpoints({"engine.pages": FailSpec(action="leak", kill=2, times=1)}):
            loop.submit([3, 1, 4, 1, 5], n=1, max_new=4, temperature=0.0, top_p=None,
                        seed=2).result(timeout=120)
        pages = loop.stats["pages"]
        assert pages["quarantined"] is True and "leak" in pages["error"]
        deadline = time.monotonic() + 10.0
        while loop._terminal_error is None and time.monotonic() < deadline:
            _ = loop.stats
            time.sleep(0.01)
        assert isinstance(loop._terminal_error, EngineHungError)
        with pytest.raises(EngineHungError):
            loop.submit([3, 1, 4], n=1, max_new=2, temperature=0.0, top_p=None, seed=2)
    finally:
        loop.stop()


@pytest.mark.parametrize("root", PACKAGES)
def test_replica_dispatch_sleep_is_hedged(root):
    """``replica.dispatch=sleep`` slows one member; the hedge answers from
    the other without waiting it out."""
    import importlib

    p = pkg(root)
    ReplicaSet = importlib.import_module(f"{root}.reliability.replicas").ReplicaSet
    ChatRequest = importlib.import_module(f"{root}.backends.base").ChatRequest
    rs = ReplicaSet(
        members=[p.FakeBackend(["slowpoke"]), p.FakeBackend(["rescue"])], model="fake",
        hedge=True, hedge_delay_s=0.03, route_policy="round_robin",
        probe_interval_s=float("inf"),
    )
    try:
        with p.fp.failpoints(
            {"replica.dispatch": p.fp.FailSpec(action="sleep", member="r0", delay=0.5)}
        ):
            t0 = time.perf_counter()
            out = rs.dispatch_chat_completion(
                ChatRequest(messages=[{"role": "user", "content": "hi"}], model="fake", n=1)
            )
            elapsed = time.perf_counter() - t0
        assert out.choices[0].message.content == "rescue"
        assert elapsed < 0.4
    finally:
        rs._executor.shutdown(wait=False)


@pytest.mark.parametrize("root", PACKAGES)
def test_serving_request_disconnect_truncates_the_stream(root):
    """``serving.request=disconnect``: the server drops the response after
    the first delta, as if the client hung up."""
    p = pkg(root)
    app = p.ServingApp(fake_client(p))

    async def go():
        async with asgi(app) as c:
            return await c.post("/v1/chat/completions", json={**BODY, "stream": True})

    before = p.obs.SERVE_EVENTS.snapshot().get("request.disconnect", 0)
    with p.fp.failpoints({"serving.request": p.fp.FailSpec(action="disconnect", times=1)}):
        resp = run(go())
    events = list(p.sse.parse_stream(resp.content))
    datas = [d for kind, d in events if kind == "data"]
    assert datas and all(d["object"] == "chat.completion.chunk" for d in datas)
    assert ("done", None) not in events
    assert p.obs.SERVE_EVENTS.snapshot()["request.disconnect"] == before + 1
