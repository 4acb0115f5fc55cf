"""Named lock factories.

The JAX package's lock factories feed a lock-order checker; the port keeps
only their call shape (a diagnostic name, ignored here) so copied host
modules construct their locks unchanged.
"""

from __future__ import annotations

import threading


def make_lock(name: str = "") -> threading.Lock:
    del name
    return threading.Lock()


def make_rlock(name: str = "") -> threading.RLock:
    del name
    return threading.RLock()
