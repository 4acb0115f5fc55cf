"""kllms-check: static analysis + runtime concurrency checking for this repo.

Two halves, one vocabulary:

- :mod:`.framework` + :mod:`.rules` — an AST lint suite enforcing the serving
  stack's own invariants (lock order, no host syncs in decode steps, kernel
  builds made once, failpoint/counter/wire-error registries). Run it with
  ``python -m k_llms_tpu_torch.analysis --check``; tier-1 runs it via
  ``tests/test_torch_analysis.py``.
- :mod:`.lockcheck` — instrumented Lock/RLock/Condition factories. Off by
  default (plain ``threading`` primitives, zero overhead); under
  ``KLLMS_LOCKCHECK=1`` they record per-thread acquisition stacks, build the
  global lock-order graph, and fail on cycles or device dispatch under a
  lock not created with ``allow_dispatch=True``. The lock *names* given to
  the factories are the same canonical ids the static lock-order rule
  reports, so a runtime violation and a lint finding point at the same lock.

Import cost matters: ``k_llms_tpu_torch.__init__`` pulls this package indirectly
via the engine's lockcheck factories, so nothing here may import torch, the
rule modules, or anything else heavy at module scope.
"""

from .lockcheck import (  # noqa: F401
    LockCheckError,
    assert_clean,
    lockcheck_enabled,
    make_condition,
    make_lock,
    make_rlock,
    note_device_dispatch,
    reset_state,
    violations,
)

__all__ = [
    "LockCheckError",
    "assert_clean",
    "lockcheck_enabled",
    "make_condition",
    "make_lock",
    "make_rlock",
    "note_device_dispatch",
    "reset_state",
    "violations",
]
