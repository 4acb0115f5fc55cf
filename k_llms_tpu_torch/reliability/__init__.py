"""Request lifecycle and serving reliability: deadlines and cancellation
budgets, retry and the circuit breaker, the failpoint registry, tenancy,
the engine supervisor and the replica set (copies of the JAX package's
modules; ``tests/test_torch_host_copies.py`` lists their edits)."""

from . import failpoints
from .deadline import Deadline, RequestBudget
from .failpoints import FailSpec, failpoints as failpoint_scope
from .retry import CircuitBreaker, RetryPolicy, is_retryable
from .supervisor import EngineSupervisor, LaunchBudgetModel
from .tenancy import TenancyConfig, TenantContext, TenantSpec, TokenBucket

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "EngineSupervisor",
    "FailSpec",
    "LaunchBudgetModel",
    "RequestBudget",
    "RetryPolicy",
    "TenancyConfig",
    "TenantContext",
    "TenantSpec",
    "TokenBucket",
    "failpoint_scope",
    "failpoints",
    "is_retryable",
]
