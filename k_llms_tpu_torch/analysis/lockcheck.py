"""Runtime lock-order sanitizer (TSan-lite for this package's threading).

The serving stack's deadlock freedom rests on a global lock acquisition
order that no single test can see. These factories make it observable:

- ``make_lock/make_rlock/make_condition(name)`` return plain ``threading``
  primitives when ``KLLMS_LOCKCHECK`` is unset — zero overhead, identical
  semantics — and instrumented wrappers when it is ``1``. The env var is
  read at *factory call time*, so a test can ``monkeypatch.setenv`` and every
  lock constructed afterwards is checked (module-level locks created at
  import time stay plain; they are leaves by design).
- Each wrapper records per-thread acquisition stacks and folds every
  "B acquired while A held" pair into one process-wide lock-order graph. A
  cycle in that graph is a potential deadlock — two threads walking it from
  different ends — and is recorded as a violation with the offending path
  and the ``file:line`` that closed it.
- ``note_device_dispatch()`` marks device-dispatch points (batch launches,
  ``device_get`` syncs). Dispatching while holding any lock not created with
  ``allow_dispatch=True`` is a violation: a decode step takes milliseconds
  and serializes every waiter behind it. ``allow_dispatch`` exists because
  two locks guard device state on purpose (the paged pool's atomic-swap
  contract); the flag moves that decision to the lock's creation site where
  the static ``dispatch-under-lock`` rule reads the same declaration.

Violations are recorded, not raised, at the point of detection — raising in
an arbitrary worker thread would wedge the very soak that is trying to
surface the bug. Call :func:`assert_clean` at the end of a test/soak.

Lock names are canonical ids shared with the static ``lock-order`` rule
(``engine.scheduler``, ``engine.kv_pool``...), so a runtime violation and a
lint finding point at the same lock.

Racecheck — the lockset sanitizer (``KLLMS_RACECHECK=1``)
---------------------------------------------------------

The second sanitizer the factories feed is an Eraser-style data-race
detector over the *fields* of lock-owning objects, the runtime twin of the
static ``guarded-by`` rule family:

- When ``KLLMS_RACECHECK=1``, every ``make_lock/make_rlock/make_condition``
  call made from a method (``self`` in the caller's frame) registers its
  owner via :func:`shared_state`: the owner's class is swapped for a tracked
  subclass whose ``__setattr__``/``__getattribute__`` observe every instance
  -dict field access together with the set of checked locks the accessing
  thread holds.
- Each field keeps a candidate lockset refined by intersection across
  threads (Eraser's algorithm). The first thread to touch a field owns it
  exclusively — initialization writes are exempt. Once a second thread
  joins, reads move the field to *shared* and writes to *shared-modified*;
  a shared-modified field whose candidate lockset goes empty is a race, and
  the violation records BOTH access stacks (the one that emptied the set
  and the previous access).
- Fields that are unsynchronized by design carry a static
  ``# kllms: unguarded — reason`` annotation AND a runtime
  :func:`race_exempt` call next to it, so the two sides never disagree.

Racecheck violations flow through the same :func:`violations` /
:func:`assert_clean` surface, so any soak that already asserts lockcheck
cleanliness becomes a race detector by exporting one more env var. With
``KLLMS_RACECHECK`` unset, :func:`shared_state` and :func:`race_exempt`
return before allocating anything: zero instrumentation objects exist.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple, Union

__all__ = [
    "LockCheckError",
    "assert_clean",
    "graph",
    "lockcheck_enabled",
    "make_condition",
    "make_lock",
    "make_rlock",
    "note_device_dispatch",
    "race_exempt",
    "racecheck_enabled",
    "reset_state",
    "shared_state",
    "violations",
]

_TRUE = ("1", "true", "yes", "on")


def lockcheck_enabled() -> bool:
    return os.getenv("KLLMS_LOCKCHECK", "").strip().lower() in _TRUE


def racecheck_enabled() -> bool:
    return os.getenv("KLLMS_RACECHECK", "").strip().lower() in _TRUE


class LockCheckError(AssertionError):
    """Raised by :func:`assert_clean` when any violation was recorded."""


# Process-wide state. ``_state_lock`` is a plain threading.Lock on purpose —
# instrumenting the sanitizer's own lock would recurse. Leaf: held only for
# dict/list mutation in this module.
# kllms: ignore[lock-order] — the sanitizer cannot instrument itself
_state_lock = threading.Lock()
_graph: Dict[Tuple[str, str], str] = {}  # (held, acquired) -> first site
_violations: List[str] = []
_violation_keys: set = set()
_tls = threading.local()


@dataclass
class _HeldEntry:
    lock: "_CheckedBase"
    name: str
    count: int


def _held() -> List[_HeldEntry]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = []
        _tls.held = held
    return held


_THIS_FILE = __file__


def _caller() -> str:
    # Nearest stack frame outside this module; only runs on first-edge
    # creation and on violations, never on the steady-state acquire path.
    for frame in reversed(traceback.extract_stack(limit=16)):
        if frame.filename != _THIS_FILE:
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _record_violation(msg: str) -> None:
    with _state_lock:
        if msg not in _violation_keys:
            _violation_keys.add(msg)
            _violations.append(msg)


def _path_locked(src: str, dst: str) -> Optional[List[str]]:
    """BFS path src -> dst over the edge relation; _state_lock must be held."""
    adj: Dict[str, List[str]] = {}
    for a, b in _graph:
        adj.setdefault(a, []).append(b)
    frontier: List[List[str]] = [[src]]
    seen = {src}
    while frontier:
        path = frontier.pop(0)
        if path[-1] == dst:
            return path
        for nxt in adj.get(path[-1], ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(path + [nxt])
    return None


def _note_acquired(lock: "_CheckedBase") -> None:
    held = _held()
    for e in held:
        if e.lock is lock:
            if lock.kind == "lock":
                _record_violation(
                    f"non-reentrant lock {lock.name!r} re-acquired by the "
                    f"same thread at {_caller()}"
                )
            e.count += 1
            return
    site: Optional[str] = None
    with _state_lock:
        for e in held:
            if e.name == lock.name:
                # distinct instances sharing a canonical name (per-member
                # locks): no global order exists between them, skip the edge
                continue
            edge = (e.name, lock.name)
            if edge in _graph:
                continue
            if site is None:
                site = _caller()
            _graph[edge] = site
            back = _path_locked(lock.name, e.name)
            if back is not None:
                # back runs lock.name..e.name; prefixing e.name closes the walk
                cycle = [e.name] + back
                _violations_append_locked(
                    "lock-order cycle: "
                    + " -> ".join(cycle)
                    + f" (edge {e.name}->{lock.name} closed at {site})"
                )
    held.append(_HeldEntry(lock=lock, name=lock.name, count=1))


def _violations_append_locked(msg: str) -> None:
    if msg not in _violation_keys:
        _violation_keys.add(msg)
        _violations.append(msg)


def _note_released(lock: "_CheckedBase") -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        e = held[i]
        if e.lock is lock:
            e.count -= 1
            if e.count <= 0:
                del held[i]
            return


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class _CheckedBase:
    kind = "lock"

    def __init__(self, inner: Any, name: str, allow_dispatch: bool) -> None:
        self._inner = inner
        self.name = name
        self.allow_dispatch = allow_dispatch

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquired(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_released(self)

    def __enter__(self) -> "_CheckedBase":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.release()
        return False

    def __getattr__(self, item: str) -> Any:
        return getattr(self._inner, item)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<checked {self.kind} {self.name!r}>"


class _CheckedLock(_CheckedBase):
    kind = "lock"

    def __init__(self, name: str, allow_dispatch: bool) -> None:
        super().__init__(threading.Lock(), name, allow_dispatch)


class _CheckedRLock(_CheckedBase):
    kind = "rlock"

    def __init__(self, name: str, allow_dispatch: bool) -> None:
        super().__init__(threading.RLock(), name, allow_dispatch)


class _CheckedCondition(_CheckedBase):
    """Condition wrapper. ``wait`` fully releases the underlying lock (that
    is Condition's contract even under reentrancy), so the held entry is
    popped for the duration and re-pushed on wake — otherwise the sanitizer
    would see phantom "held across wait" orderings."""

    kind = "condition"

    def __init__(
        self, name: str, allow_dispatch: bool, lock: Optional[Any] = None
    ) -> None:
        inner_lock = lock._inner if isinstance(lock, _CheckedBase) else lock
        super().__init__(threading.Condition(inner_lock), name, allow_dispatch)

    def _pop_for_wait(self) -> Optional[_HeldEntry]:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                return held.pop(i)
        return None

    def wait(self, timeout: Optional[float] = None) -> bool:
        entry = self._pop_for_wait()
        try:
            return self._inner.wait(timeout)
        finally:
            if entry is not None:
                _held().append(entry)

    def wait_for(
        self, predicate: Callable[[], Any], timeout: Optional[float] = None
    ) -> Any:
        # Mirrors threading.Condition.wait_for, routed through our wait()
        # so the held-stack bookkeeping stays correct.
        endtime: Optional[float] = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result


# ---------------------------------------------------------------------------
# racecheck: Eraser-style lockset sanitizer over lock-owning objects
# ---------------------------------------------------------------------------

# Values that are synchronization machinery (or per-thread by construction),
# never shared data — accesses to them carry no lockset signal.
_EXEMPT_VALUE_TYPES = (
    _CheckedBase,
    threading.local,
    type(threading.Lock()),
    type(threading.RLock()),
    threading.Condition,
    threading.Event,
    threading.Thread,
    threading.Semaphore,
)

# Original class -> tracked subclass (same name, interposed accessors). A
# cache, not per-object state: one entry per lock-owning *class*.
_tracked_classes: Dict[type, type] = {}

# Process-unique thread identity. ``threading.get_ident()`` is recycled the
# moment a thread exits, so a field written by a dead thread and then by its
# ident-reusing successor would look single-threaded and never leave the
# exclusive state. A serial handed out once per thread cannot collide.
_thread_serial_next = [0]


def _thread_serial() -> int:
    s = getattr(_tls, "race_serial", None)
    if s is None:
        with _state_lock:
            _thread_serial_next[0] += 1
            s = _thread_serial_next[0]
        _tls.race_serial = s
    return s


@dataclass
class _FieldState:
    """Eraser state machine for one field of one tracked object.

    ``state``: ``exclusive`` (single thread so far — the first-thread
    exemption that keeps initialization silent) -> ``shared`` (second
    thread read it) -> ``shared-modified`` (any thread wrote it after it
    went multi-thread). ``lockset`` is the candidate-guard intersection,
    started at the first cross-thread access; ``None`` means "all locks"
    (still exclusive). A shared-modified field with an empty lockset is a
    race, reported once with both access stacks."""

    state: str
    first_thread: int
    lockset: Optional[FrozenSet[str]] = None
    last_stack: Tuple[Tuple[str, int, str], ...] = ()
    last_thread: str = ""
    last_kind: str = ""
    reported: bool = False


def _mini_stack() -> Tuple[Tuple[str, int, str], ...]:
    """Cheap raw-frame capture (no string formatting on the access path —
    frames are only rendered if a violation is reported)."""
    out: List[Tuple[str, int, str]] = []
    f = sys._getframe(1)
    while f is not None and len(out) < 5:
        co = f.f_code
        if co.co_filename != _THIS_FILE:
            out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_stack(stack: Tuple[Tuple[str, int, str], ...]) -> str:
    if not stack:
        return "<unknown>"
    return " <- ".join(f"{fn}:{ln} in {name}" for fn, ln, name in stack)


def _track_name(name: str) -> bool:
    return not (name.startswith("__") or name.startswith("_kllms"))


def _race_access(owner: Any, name: str, kind: str) -> None:
    d = object.__getattribute__(owner, "__dict__")
    fields = d.get("_kllms_race_fields")
    if fields is None:
        return
    exempt = d.get("_kllms_race_exempt")
    if exempt is not None and name in exempt:
        return
    tid = _thread_serial()
    held_entries = getattr(_tls, "held", None) or ()
    held = frozenset(e.name for e in held_entries)
    stack = _mini_stack()
    tname = threading.current_thread().name
    with _state_lock:
        st = fields.get(name)
        if st is None:
            fields[name] = _FieldState(
                state="exclusive",
                first_thread=tid,
                last_stack=stack,
                last_thread=tname,
                last_kind=kind,
            )
            return
        if st.state == "exclusive" and tid == st.first_thread:
            st.last_stack, st.last_thread, st.last_kind = stack, tname, kind
            return
        if st.state == "exclusive":
            st.state = "shared-modified" if kind == "write" else "shared"
            st.lockset = held
        else:
            st.lockset = held if st.lockset is None else (st.lockset & held)
            if kind == "write":
                st.state = "shared-modified"
        if (
            st.state == "shared-modified"
            and st.lockset is not None
            and not st.lockset
            and not st.reported
        ):
            st.reported = True
            _violations_append_locked(
                f"racecheck: {type(owner).__name__}.{name} has an empty "
                f"candidate lockset under multi-thread access (owner "
                f"registered via lock {d.get('_kllms_race_owner', '?')!r})\n"
                f"  access A [{st.last_kind} by {st.last_thread}]: "
                f"{_fmt_stack(st.last_stack)}\n"
                f"  access B [{kind} by {tname}]: {_fmt_stack(stack)}"
            )
        st.last_stack, st.last_thread, st.last_kind = stack, tname, kind


def _make_tracked(cls: type) -> type:
    """Subclass *cls* (same name) with accessors that feed the sanitizer.
    Only instance-dict data fields count: methods, properties, dunders, and
    lock-valued attributes are filtered on the access path."""

    def __setattr__(self: Any, name: str, value: Any, _cls: type = cls) -> None:
        if _track_name(name) and not isinstance(value, _EXEMPT_VALUE_TYPES):
            _race_access(self, name, "write")
        _cls.__setattr__(self, name, value)

    def __getattribute__(self: Any, name: str, _cls: type = cls) -> Any:
        value = _cls.__getattribute__(self, name)
        if _track_name(name):
            d = object.__getattribute__(self, "__dict__")
            if name in d and not isinstance(value, _EXEMPT_VALUE_TYPES):
                _race_access(self, name, "read")
        return value

    return type(
        cls.__name__,
        (cls,),
        {
            "__setattr__": __setattr__,
            "__getattribute__": __getattribute__,
            "__module__": cls.__module__,
            "_kllms_is_tracked": True,
        },
    )


def shared_state(owner: Any, name: str) -> None:
    """Register *owner*'s fields for lockset tracking (no-op unless
    ``KLLMS_RACECHECK=1``). Called automatically by the lock factories when
    they can see their owner (``self`` in the calling frame); public so
    tests and lock-less shared objects can register explicitly. ``name`` is
    the canonical lock id used to attribute violations."""
    if owner is None or not racecheck_enabled():
        return
    cls = type(owner)
    if not cls.__dict__.get("_kllms_is_tracked"):
        try:
            object.__getattribute__(owner, "__dict__")
        except AttributeError:  # __slots__-only object: cannot interpose
            return
        tracked = _tracked_classes.get(cls)
        if tracked is None:
            tracked = _make_tracked(cls)
            _tracked_classes[cls] = tracked
        try:
            object.__setattr__(owner, "__class__", tracked)
        except TypeError:  # incompatible layout (extension type, slots)
            return
    d = object.__getattribute__(owner, "__dict__")
    d.setdefault("_kllms_race_fields", {})
    d.setdefault("_kllms_race_owner", name)


def race_exempt(owner: Any, *names: str) -> None:
    """Exclude fields of *owner* from lockset tracking — the runtime twin of
    the static ``# kllms: unguarded — reason`` annotation. Call it right
    next to the annotated assignment so the two exemption lists cannot
    drift. No-op (and allocation-free) unless ``KLLMS_RACECHECK=1``."""
    if owner is None or not racecheck_enabled():
        return
    d = object.__getattribute__(owner, "__dict__")
    exempt = d.get("_kllms_race_exempt")
    if exempt is None:
        exempt = set()
        d["_kllms_race_exempt"] = exempt
    exempt.update(names)
    fields = d.get("_kllms_race_fields")
    if fields is not None:
        with _state_lock:
            for n in names:
                fields.pop(n, None)


def _auto_register(name: str) -> None:
    # The idiomatic factory call is ``self._lock = make_lock(...)`` inside
    # ``__init__``; the owner is the ``self`` two frames up. Module-level
    # locks (no ``self``) simply have no fields to track.
    try:
        frame = sys._getframe(2)
    except ValueError:  # pragma: no cover - interpreter without frames
        return
    owner = frame.f_locals.get("self")
    if owner is not None:
        shared_state(owner, name)


# ---------------------------------------------------------------------------
# factories + dispatch marker + reporting
# ---------------------------------------------------------------------------


def make_lock(
    name: str, *, allow_dispatch: bool = False
) -> Union[threading.Lock, _CheckedLock]:
    """A ``threading.Lock`` (or its checked twin under KLLMS_LOCKCHECK=1 /
    KLLMS_RACECHECK=1 — the lockset sanitizer needs held-lock tracking too).
    ``name`` is the canonical id shared with the static lock-order rule."""
    if racecheck_enabled():
        _auto_register(name)
    elif not lockcheck_enabled():
        return threading.Lock()
    return _CheckedLock(name, allow_dispatch)


def make_rlock(
    name: str, *, allow_dispatch: bool = False
) -> Union[threading.RLock, _CheckedRLock]:
    if racecheck_enabled():
        _auto_register(name)
    elif not lockcheck_enabled():
        return threading.RLock()
    return _CheckedRLock(name, allow_dispatch)


def make_condition(
    name: str, lock: Optional[Any] = None, *, allow_dispatch: bool = False
) -> Union[threading.Condition, _CheckedCondition]:
    if racecheck_enabled():
        _auto_register(name)
    elif not lockcheck_enabled():
        inner = lock._inner if isinstance(lock, _CheckedBase) else lock
        return threading.Condition(inner)
    return _CheckedCondition(name, allow_dispatch, lock)


def note_device_dispatch(what: str = "device dispatch") -> None:
    """Mark a device-dispatch point. A violation is recorded for every held
    checked lock not created with ``allow_dispatch=True``. Near-free when the
    sanitizer is off: the calling thread holds no checked locks."""
    held = getattr(_tls, "held", None)
    if not held:
        return
    for e in held:
        if not e.lock.allow_dispatch:
            _record_violation(
                f"{what} while holding {e.name!r} (created without "
                f"allow_dispatch=True) at {_caller()}"
            )


def violations() -> List[str]:
    with _state_lock:
        return list(_violations)


def graph() -> Dict[Tuple[str, str], str]:
    """The observed lock-order edges: (held, acquired) -> first site."""
    with _state_lock:
        return dict(_graph)


def reset_state() -> None:
    """Clear the global graph and violation log (test isolation). Held-lock
    stacks are thread-local and owned by live threads; they are not touched.
    Racecheck field states live on the tracked instances themselves and die
    with them — only the recorded violations are global, and those clear
    here."""
    with _state_lock:
        _graph.clear()
        _violations.clear()
        _violation_keys.clear()


def assert_clean() -> None:
    """Raise :class:`LockCheckError` listing every recorded violation."""
    found = violations()
    if found:
        raise LockCheckError(
            f"{len(found)} lockcheck violation(s):\n" + "\n".join(found)
        )
