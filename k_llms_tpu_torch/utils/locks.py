"""Named lock factories.

The JAX package's lock factories feed a lock-order checker and a lockset
sanitizer; the port keeps only their call shape (a diagnostic name, ignored
here) so copied host modules construct their locks and declare their exempt
fields unchanged.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


def make_lock(name: str = "") -> threading.Lock:
    del name
    return threading.Lock()


def make_rlock(name: str = "") -> threading.RLock:
    del name
    return threading.RLock()


def make_condition(name: str = "", lock: Optional[Any] = None) -> threading.Condition:
    del name
    return threading.Condition(lock)


def race_exempt(owner: Any, *names: str) -> None:
    """The JAX package's lockset-sanitizer exemption; the port has no
    sanitizer, so there is nothing to exempt from."""
    del owner, names
