"""Multi-tenant quotas, SLO classes, and weighted-fair shares.

The serving stack already has budgets, priority queuing, and
per-request traces/histograms, but nothing composing them into
*tenancy*: one bulk-extraction customer can starve interactive chat and no
scrape output can prove otherwise. This module supplies the policy objects
the admission path needs:

- :class:`TokenBucket` — a monotonic-clock token bucket with ``try_take``
  (atomic under the owner's lock) and ``time_until`` (the tenant's own
  refill horizon, which becomes the 429 ``retry_after`` instead of the
  global drain-rate estimate).
- :class:`TenantSpec` — frozen per-tenant policy: WFQ ``weight``, SLO class
  (``interactive`` | ``batch``), and optional request/s + device-row/s
  quotas (None = unlimited).
- :class:`TenantContext` — a spec plus its two live buckets behind one
  lock. ``try_admit(rows)`` checks BOTH buckets before deducting either,
  so a partial charge can never leak tokens on a rejected request.
- :class:`TenancyConfig` — the registry: a default spec, named overrides,
  an API-key → tenant-name map for ``serving/app.py`` resolution, and a
  bounded cache of dynamically materialized contexts (unmapped API keys
  become their own tenants so per-key fairness works without pre-config).

Scheduling policy built on these lives in ``engine/scheduler.py`` (WFQ over
coalesced launches, brownout shed tiers) and ``engine/continuous.py`` (WFQ
slot admission); this module is pure bookkeeping with no thread of its own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from ..utils.locks import make_lock

__all__ = [
    "SLO_CLASSES",
    "TokenBucket",
    "TenantSpec",
    "TenantContext",
    "TenancyConfig",
    "DEFAULT_TENANT",
    "BATCH_LANE_SUFFIX",
]

#: Recognized SLO classes, in strictly descending admission priority.
SLO_CLASSES: Tuple[str, ...] = ("interactive", "batch")

#: Name of the implicit tenant used when no credential resolves.
DEFAULT_TENANT = "default"

#: Dynamic (API-key-derived) tenant contexts are capped; overflow collapses
#: to the default tenant so a credential-spraying client cannot grow the
#: registry (or the /metrics label set) without bound.
MAX_DYNAMIC_TENANTS = 1024

#: Name suffix of a tenant's derived batch-lane context. ``#`` can
#: never appear in an API-key-derived tenant name's configured form by
#: accident of quoting — and even if a hostile key contains it, the lane view
#: only ever SHARES the owner's buckets, so no quota is gained by collision.
BATCH_LANE_SUFFIX = "#batch"


class TokenBucket:
    """Classic token bucket over a monotonic clock.

    Not internally locked — the owning :class:`TenantContext` serializes
    access so its two buckets (requests/s and rows/s) charge atomically.
    """

    __slots__ = ("rate", "burst", "_level", "_stamp", "_clock")

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        if burst <= 0:
            raise ValueError(f"token bucket burst must be > 0, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._level = float(burst)
        self._stamp = clock()
        self._clock = clock

    def _refill(self) -> None:
        now = self._clock()
        elapsed = now - self._stamp
        if elapsed > 0:
            self._level = min(self.burst, self._level + elapsed * self.rate)
        self._stamp = now

    def try_take(self, cost: float = 1.0) -> bool:
        """Deduct ``cost`` tokens if available; False leaves the level as-is."""
        self._refill()
        if self._level >= cost:
            self._level -= cost
            return True
        return False

    def time_until(self, cost: float = 1.0) -> float:
        """Seconds until ``cost`` tokens will be available (0.0 if now).

        Costs beyond ``burst`` can never be satisfied; report the full-burst
        refill horizon so callers still get a finite, honest retry hint.
        """
        self._refill()
        deficit = min(cost, self.burst) - self._level
        if deficit <= 0:
            return 0.0
        return deficit / self.rate

    def level(self) -> float:
        """Current token level (refills first); diagnostic only."""
        self._refill()
        return self._level


@dataclass(frozen=True)
class TenantSpec:
    """Frozen per-tenant policy. ``None`` quota fields mean unlimited."""

    name: str
    weight: float = 1.0
    slo: str = "interactive"
    requests_per_s: Optional[float] = None
    request_burst: Optional[float] = None
    rows_per_s: Optional[float] = None
    rows_burst: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: slo must be one of {SLO_CLASSES}, "
                f"got {self.slo!r}"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}"
            )
        for fname in ("requests_per_s", "request_burst", "rows_per_s", "rows_burst"):
            v = getattr(self, fname)
            if v is not None and v <= 0:
                raise ValueError(
                    f"tenant {self.name!r}: {fname} must be > 0 or None, got {v}"
                )


class TenantContext:
    """A :class:`TenantSpec` plus live quota state.

    One lock guards both buckets so a request's (1 request, N rows) charge is
    atomic: either both buckets admit and both are deducted, or neither is
    touched and the caller gets the max of the two refill horizons.
    """

    __slots__ = ("spec", "_lock", "_req_bucket", "_row_bucket")

    def __init__(
        self, spec: TenantSpec, clock: Callable[[], float] = time.monotonic
    ):
        self.spec = spec
        # Leaf lock: taken under the scheduler's condition (quota checks in
        # eviction tiers) and never the other way around.
        self._lock = make_lock("tenancy.tenant")
        self._req_bucket: Optional[TokenBucket] = None
        self._row_bucket: Optional[TokenBucket] = None
        if spec.requests_per_s is not None:
            burst = spec.request_burst
            if burst is None:
                burst = max(1.0, spec.requests_per_s)
            self._req_bucket = TokenBucket(spec.requests_per_s, burst, clock)
        if spec.rows_per_s is not None:
            burst = spec.rows_burst
            if burst is None:
                burst = max(1.0, spec.rows_per_s)
            self._row_bucket = TokenBucket(spec.rows_per_s, burst, clock)

    # -- identity passthroughs -------------------------------------------
    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def weight(self) -> float:
        return self.spec.weight

    @property
    def slo(self) -> str:
        return self.spec.slo

    @property
    def interactive(self) -> bool:
        return self.spec.slo == "interactive"

    @property
    def limited(self) -> bool:
        return self._req_bucket is not None or self._row_bucket is not None

    # -- quota -----------------------------------------------------------
    def try_admit(self, rows: float = 0.0) -> Optional[float]:
        """Charge one request + ``rows`` device rows against the quotas.

        Returns ``None`` on success (both buckets deducted atomically) or
        the number of seconds until this tenant's OWN buckets could admit
        the same charge — the quota-aware ``retry_after``.
        """
        with self._lock:
            wait = 0.0
            if self._req_bucket is not None:
                wait = max(wait, self._req_bucket.time_until(1.0))
            if self._row_bucket is not None and rows > 0:
                wait = max(wait, self._row_bucket.time_until(rows))
            if wait > 0:
                return wait
            if self._req_bucket is not None:
                self._req_bucket.try_take(1.0)
            if self._row_bucket is not None and rows > 0:
                self._row_bucket.try_take(rows)
            return None

    def refill_horizon(self, rows: float = 0.0) -> float:
        """Seconds until the buckets could admit one request + ``rows`` rows,
        WITHOUT charging anything. 0.0 when admissible now (or unlimited) —
        the scheduler uses this for forced quota misses (the
        ``scheduler.tenant=exhaust`` failpoint) and brownout retry hints."""
        with self._lock:
            wait = 0.0
            if self._req_bucket is not None:
                wait = max(wait, self._req_bucket.time_until(1.0))
            if self._row_bucket is not None and rows > 0:
                wait = max(wait, self._row_bucket.time_until(rows))
            return wait

    def over_quota(self) -> bool:
        """True when either bucket is currently empty — used by brownout
        eviction to pick over-quota interactive victims before in-SLO work."""
        with self._lock:
            if self._req_bucket is not None and self._req_bucket.level() < 1.0:
                return True
            if self._row_bucket is not None and self._row_bucket.level() < 1.0:
                return True
            return False

    def quota_snapshot(self) -> Dict[str, Any]:
        """Bucket levels for health/debug endpoints."""
        with self._lock:
            snap: Dict[str, Any] = {"slo": self.spec.slo, "weight": self.spec.weight}
            if self._req_bucket is not None:
                snap["request_tokens"] = round(self._req_bucket.level(), 3)
            if self._row_bucket is not None:
                snap["row_tokens"] = round(self._row_bucket.level(), 3)
            return snap

    @classmethod
    def lane_view(cls, owner: "TenantContext", spec: TenantSpec) -> "TenantContext":
        """A sibling context over the OWNER'S lock and buckets.

        The offline batch lane runs under the owning tenant's quota but the
        ``batch`` SLO class, and the scheduler keys its WFQ queues by context
        name — so the lane needs a distinct name and spec while every quota
        charge still lands atomically in the owner's token buckets."""
        view = cls.__new__(cls)
        view.spec = spec
        view._lock = owner._lock
        view._req_bucket = owner._req_bucket
        view._row_bucket = owner._row_bucket
        return view

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TenantContext({self.spec.name!r}, slo={self.spec.slo!r})"


@dataclass
class TenancyConfig:
    """The tenant registry the admission path consults.

    ``default`` covers unconfigured traffic; ``tenants`` holds named
    overrides; ``api_keys`` maps serving-layer credentials to tenant names.
    Unmapped API keys materialize their own (default-policy) contexts so
    per-key fairness and per-key metrics work without pre-registration —
    bounded by :data:`MAX_DYNAMIC_TENANTS`.
    """

    default: TenantSpec = field(
        default_factory=lambda: TenantSpec(name=DEFAULT_TENANT)
    )
    tenants: Dict[str, TenantSpec] = field(default_factory=dict)
    api_keys: Dict[str, str] = field(default_factory=dict)
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._lock = make_lock("tenancy.registry")
        self._contexts: Dict[str, TenantContext] = {}
        for name, spec in self.tenants.items():
            if spec.name != name:
                raise ValueError(
                    f"tenant registry key {name!r} != spec.name {spec.name!r}"
                )
        self._dynamic = 0

    @classmethod
    def from_options(
        cls,
        *,
        default_weight: float = 1.0,
        default_slo: str = "interactive",
        default_requests_per_s: Optional[float] = None,
        default_rows_per_s: Optional[float] = None,
        tenants: Optional[Mapping[str, Mapping[str, Any]]] = None,
        api_keys: Optional[Mapping[str, str]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> "TenancyConfig":
        """Build from the flat knob shapes ``BackendConfig`` carries.

        ``tenants`` values are dicts of TenantSpec field overrides, e.g.
        ``{"bulk": {"slo": "batch", "weight": 1.0, "rows_per_s": 8}}``.
        """
        default = TenantSpec(
            name=DEFAULT_TENANT,
            weight=default_weight,
            slo=default_slo,
            requests_per_s=default_requests_per_s,
            rows_per_s=default_rows_per_s,
        )
        specs: Dict[str, TenantSpec] = {}
        for name, overrides in dict(tenants or {}).items():
            fields = {
                "weight": default.weight,
                "slo": default.slo,
                "requests_per_s": default.requests_per_s,
                "rows_per_s": default.rows_per_s,
            }
            fields.update(dict(overrides))
            fields.pop("name", None)
            specs[name] = TenantSpec(name=name, **fields)
        return cls(
            default=default, tenants=specs, api_keys=dict(api_keys or {}),
            clock=clock,
        )

    # -- resolution ------------------------------------------------------
    def resolve(self, tenant: Any = None) -> TenantContext:
        """Resolve a request's ``tenant=`` value to a live context.

        ``None`` → the default tenant; a :class:`TenantContext` passes
        through; a string names a configured tenant or materializes a
        dynamic one (default policy, own buckets) up to the cap.
        """
        if tenant is None:
            return self._context(self.default.name, self.default)
        if isinstance(tenant, TenantContext):
            return tenant
        name = str(tenant)
        with self._lock:
            ctx = self._contexts.get(name)
        if ctx is not None:
            return ctx
        if name.endswith(BATCH_LANE_SUFFIX):
            # A lane name round-tripped as a string (Completions.create's
            # tenant= is a plain str): re-derive the shared-bucket view
            # instead of materializing an unrelated dynamic tenant.
            return self.batch_lane(name[: -len(BATCH_LANE_SUFFIX)] or None)
        spec = self.tenants.get(name)
        if spec is not None:
            return self._context(name, spec)
        if name == self.default.name:
            return self._context(name, self.default)
        # Dynamic tenant: default policy under its own name (own buckets).
        with self._lock:
            if self._dynamic >= MAX_DYNAMIC_TENANTS:
                name = self.default.name
                spec = self.default
            else:
                self._dynamic += 1
                spec = TenantSpec(
                    name=name,
                    weight=self.default.weight,
                    slo=self.default.slo,
                    requests_per_s=self.default.requests_per_s,
                    rows_per_s=self.default.rows_per_s,
                )
        return self._context(name, spec)

    def tenant_for_key(self, api_key: Optional[str]) -> str:
        """Map a serving-layer credential to a tenant name.

        Mapped keys get their configured tenant; unmapped non-empty keys
        become their own dynamic tenant (per-key fairness by default);
        missing/empty credentials fall to the default tenant.
        """
        if not api_key:
            return self.default.name
        mapped = self.api_keys.get(api_key)
        if mapped is not None:
            return mapped
        return api_key

    def _context(self, name: str, spec: TenantSpec) -> TenantContext:
        with self._lock:
            ctx = self._contexts.get(name)
            if ctx is None:
                ctx = TenantContext(spec, clock=self.clock)
                self._contexts[name] = ctx
            return ctx

    def batch_lane(self, tenant: Any = None) -> TenantContext:
        """The batch-SLO sibling of a tenant: ``<name>#batch``.

        Shares the owner's lock and token buckets (offline work draws down
        the SAME quota as the owner's interactive traffic) but carries
        ``slo="batch"`` under its own name, so the scheduler's WFQ keys it
        as a separate, strictly-lower-priority queue. A tenant already in
        the batch class IS its own lane."""
        owner = self.resolve(tenant)
        if owner.slo == "batch":
            return owner
        lane_name = owner.name + BATCH_LANE_SUFFIX
        with self._lock:
            ctx = self._contexts.get(lane_name)
            if ctx is None:
                spec = replace(owner.spec, name=lane_name, slo="batch")
                ctx = TenantContext.lane_view(owner, spec)
                self._contexts[lane_name] = ctx
            return ctx

    def known_tenants(self) -> Dict[str, TenantContext]:
        """Snapshot of materialized contexts (for health endpoints)."""
        with self._lock:
            return dict(self._contexts)


def permissive() -> TenancyConfig:
    """An unlimited single-class config — the implicit policy everywhere a
    component is constructed without explicit tenancy, preserving pre-tenancy
    behavior bit-for-bit (no quotas, one weight, everything interactive)."""
    return TenancyConfig()
