"""Tenancy through the port's backend on the CPU: weighted-fair dequeue
across tenant queues (interactive before batch), quota 429s whose
``retry_after`` is the tenant's own bucket refill, the keyed
``scheduler.tenant`` drill, and brownout shedding of batch-class work, all
configured through the JAX package's ``BackendConfig`` tenancy fields."""

import pytest

from _torch_serving import port_backend, prompt
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.reliability import failpoints as fp
from k_llms_tpu_torch.reliability.drills import park_worker, queue_in_order
from k_llms_tpu_torch.reliability.failpoints import FailSpec
from k_llms_tpu_torch.reliability.tenancy import TenancyConfig
from k_llms_tpu_torch.types.wire import RateLimitError
from k_llms_tpu_torch.utils.observability import TENANT_EVENTS


def _generate(backend, text, tenant, seed=1, max_new=4):
    return lambda: backend._generate_batched(
        prompt(text), n=1, max_new=max_new, temperature=0.0, top_p=None, seed=seed,
        constraint=None, tenant=tenant,
    )


def test_tenancy_fields_reach_the_scheduler():
    backend = port_backend(tenants={"gold": {"weight": 3.0}, "bulk": {"slo": "batch"}},
                           tenant_api_keys={"sk-1": "gold"}, tenant_default_weight=2.0)
    tenancy = backend.scheduler.tenancy
    assert tenancy is backend.tenancy and isinstance(tenancy, TenancyConfig)
    assert tenancy.resolve("gold").weight == 3.0
    assert not tenancy.resolve("bulk").interactive
    assert tenancy.resolve("someone").weight == 2.0
    assert tenancy.tenant_for_key("sk-1") == "gold"
    backend.close()


def test_weighted_fair_order_and_interactive_before_batch():
    backend = port_backend(batch_window=0.0,
                           tenants={"gold": {"weight": 3.0}, "bronze": {"weight": 1.0},
                                    "bulk": {"slo": "batch"}})
    served = []
    engine_generate = backend.engine.generate_many
    names = {}

    def spy(specs, **kw):
        served.extend(names[tuple(s.prompt_ids)] for s in specs)
        return engine_generate(specs, **kw)

    backend.engine.generate_many = spy
    gate = park_worker(backend.scheduler)
    # Bulk, then bronze, queue first. Each request has its own max_tokens,
    # so its own batch key: nothing coalesces and every launch is one
    # request, in the order the fair queue picks.
    order = [("bulk", 2), ("bronze", 4), ("gold", 4)]
    calls = []
    for tenant, count in order:
        for i in range(count):
            names[tuple(prompt(f"{tenant}{i}"))] = tenant
            calls.append(_generate(backend, f"{tenant}{i}", tenant, seed=i, max_new=3 + i))
    threads, results = queue_in_order(backend.scheduler, calls)
    gate.set()
    for t in threads:
        t.join(timeout=60)
    assert all(not isinstance(r, BaseException) for r in results.values()), results
    # Interactive work drains strictly before batch-class work, and gold's
    # 3x weight earns it three of every four slots while both are queued:
    # bronze, gold, gold, gold, bronze, gold, bronze, bronze.
    want = ["bronze", "gold", "gold", "gold", "bronze", "gold", "bronze", "bronze", "bulk", "bulk"]
    assert served == want, served
    backend.close()


def test_quota_429_carries_the_tenants_own_refill():
    # One request every 20 s: the second request, a moment after the first,
    # waits for the rest of that refill, whatever the machine's load.
    client = KLLMs(backend=port_backend(
        tenants={"meter": {"requests_per_s": 0.05, "request_burst": 1.0}}))
    msgs = [{"role": "user", "content": "q"}]
    before = TENANT_EVENTS.get("tenant.shed_quota.meter")
    client.chat.completions.create(messages=msgs, n=1, seed=1, tenant="meter")
    with pytest.raises(RateLimitError) as ei:
        client.chat.completions.create(messages=msgs, n=1, seed=1, tenant="meter")
    assert ei.value.status_code == 429
    assert 15.0 <= ei.value.retry_after <= 20.0
    assert TENANT_EVENTS.get("tenant.shed_quota.meter") == before + 1
    client.chat.completions.create(messages=msgs, n=1, seed=1, tenant="other")
    health = client.backend.health()
    assert health["shed_quota"] == 1 and health["tenants"]["meter"]["shed_quota"] == 1
    assert client.backend.circuit_breaker.state == "closed"  # a load signal, not a fault
    client.close()


def test_tenant_exhaust_drill_is_keyed():
    backend = port_backend()
    with fp.failpoints({"scheduler.tenant": FailSpec(action="exhaust", member="bulk", times=1)}):
        _generate(backend, "x", "chat")()
        with pytest.raises(RateLimitError, match="forced by failpoint"):
            _generate(backend, "x", "bulk")()
        _generate(backend, "x", "bulk")()  # times=1 consumed
    backend.close()


def test_brownout_sheds_batch_class_with_typed_429():
    backend = port_backend(batch_window=0.0, max_queue_weight=10,
                           tenants={"bulk": {"slo": "batch"}})
    gate = park_worker(backend.scheduler)
    # Weight is n: three n=3 requests queue 9 >= 0.9 * 10, the high-water mark.
    fillers = [lambda i=i: backend._generate_batched(
        prompt(f"fill{i}"), n=3, max_new=4, temperature=0.0, top_p=None, seed=i,
        constraint=None, tenant="chat") for i in range(3)]
    threads, results = queue_in_order(backend.scheduler, fillers)
    assert backend.scheduler.health()["brownout"] is True
    with pytest.raises(RateLimitError, match="brownout") as ei:
        _generate(backend, "late", "bulk")()
    assert ei.value.retry_after >= 0.1
    health = backend.scheduler.health()
    assert health["shed_brownout"] == 1 and health["tenants"]["bulk"]["shed_brownout"] == 1
    gate.set()
    for t in threads:
        t.join(timeout=60)
    assert all(not isinstance(r, BaseException) for r in results.values())
    backend.close()
