"""Request lifecycle and serving reliability: deadlines and cancellation
budgets, retry and the circuit breaker, the failpoint registry, tenancy,
the engine supervisor and the replica set (copies of the JAX package's
modules; ``tests/test_torch_host_copies.py`` lists their edits)."""
