"""Concurrency rules: static lock-order extraction and device-dispatch-under-lock.

The serving stack holds 15+ locks across engine/, reliability/, serving/ and
consensus/device.py. Two invariants keep it deadlock- and stall-free:

1. **lock-order** — the global acquisition graph (edges A→B whenever B is
   acquired while A is held) must stay acyclic; a cycle is a potential
   deadlock the moment two threads walk it from different ends. Acquisitions
   are extracted from ``with <lock>:`` nesting, propagated through same-class
   / aliased method calls, and seeded by the project convention that a method
   named ``*_locked`` runs with its class's primary lock held.
2. **dispatch-under-lock** — device dispatch (a kernel wrapper of ``ops/``,
   a model forward, ``torch.cuda.synchronize`` or an event's
   ``synchronize``) must not run under a lock
   unless that lock was created with ``allow_dispatch=True`` (the
   ``lockcheck`` factories record the same decision at runtime). A decode
   step can take milliseconds; serializing it behind a scheduler or
   allocator lock stalls every other thread at exactly the hot moment.

Lock identity: locks created via ``analysis.lockcheck.make_lock("name")`` /
``make_rlock`` / ``make_condition`` use their given runtime name, so the
static graph and the ``KLLMS_LOCKCHECK=1`` runtime graph share a vocabulary.
Raw ``threading.Lock()`` attributes are tracked as ``Class.attr`` — and
reported (a raw lock is invisible to the runtime sanitizer).

Cross-object references (``engine._launch_lock``, ``pool.lock``) resolve
through the ``owners`` alias table in ``[lock-order]`` of the package's
``analysis/kllms-check.toml``.
"""

from __future__ import annotations

import ast
import fnmatch
import weakref
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..framework import Finding, Project, Rule, register
from ._astutil import FuncInfo, dotted, functions_in, str_const, walk_same_scope

_THREADING_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
}
_FACTORY_KINDS = {
    "make_lock": "lock",
    "make_rlock": "rlock",
    "make_condition": "condition",
}

#: Call patterns that mean "device work" (matched against the full dotted
#: callee and its last segment): the kernel wrappers of ``ops/``, the model
#: forwards of ``models/llama.py``, and the host's waits on the card.
#: Extended via config ``dispatch_calls``.
_DEFAULT_DISPATCH_CALLS = [
    # kernel wrappers
    "paged_decode_attention*",
    "flash_attention",
    "decode_prefix_attention",
    "w4_matmul",
    "threefry_uniform_*",
    "levenshtein",
    "batched_levenshtein",
    "batched_votes",
    # model forwards
    "prefill",
    "prefill_continue",
    "prefill_chunk_step*",
    "decode_step",
    "verify_step",
    "paged_verify_step",
    # waits on the card
    "torch.cuda.synchronize",
    "*.synchronize",
]


@dataclass(eq=False)  # identity semantics: one LockDef per definition site
class LockDef:
    name: str  # canonical id (runtime lockcheck name when factory-created)
    kind: str  # lock | rlock | condition
    allow_dispatch: bool
    class_name: Optional[str]
    attr: str
    file: str
    line: int
    factory: bool  # created through analysis.lockcheck


@dataclass
class _FuncFacts:
    info: FuncInfo
    file: str
    # (lock, line, locks-held-at-that-point-within-this-function)
    acquisitions: List[Tuple[LockDef, int, Tuple[LockDef, ...]]]
    # (callee-key, line, held)
    calls: List[Tuple[Tuple[str, str], int, Tuple[LockDef, ...]]]
    # (callee-dotted, line, held)
    dispatches: List[Tuple[str, int, Tuple[LockDef, ...]]]


class _LockWorld:
    """Project-wide lock inventory + per-function acquisition facts."""

    def __init__(self, project: Project, owners: Dict[str, str]):
        self.project = project
        self.owners = owners
        self.by_class_attr: Dict[Tuple[str, str], LockDef] = {}
        self.by_module_var: Dict[Tuple[str, str], LockDef] = {}
        self.raw_defs: List[LockDef] = []
        self.functions: Dict[Tuple[str, str], _FuncFacts] = {}
        self.primary: Dict[str, LockDef] = {}  # class -> first declared lock
        self._discover()
        self._analyze()

    # -- discovery ---------------------------------------------------------

    def _lock_from_call(self, call: ast.Call) -> Optional[Tuple[str, bool, bool, Optional[str]]]:
        """(kind, factory, allow_dispatch, runtime_name) when the call creates
        a lock primitive."""
        d = dotted(call.func)
        if d is None:
            return None
        last = d.rsplit(".", 1)[-1]
        if last in _THREADING_KINDS and (d == last or d.startswith("threading.")):
            return _THREADING_KINDS[last], False, False, None
        if last in _FACTORY_KINDS:
            name = str_const(call.args[0]) if call.args else None
            allow = False
            for kw in call.keywords:
                if kw.arg == "allow_dispatch" and isinstance(kw.value, ast.Constant):
                    allow = bool(kw.value.value)
            return _FACTORY_KINDS[last], True, allow, name
        return None

    def _discover(self) -> None:
        for pf in self.project.files:
            if pf.tree is None:
                continue
            for fn in functions_in(pf.tree):
                for node in walk_same_scope(fn.node):
                    if not isinstance(node, ast.Assign) or not isinstance(
                        node.value, ast.Call
                    ):
                        continue
                    made = self._lock_from_call(node.value)
                    if made is None:
                        continue
                    kind, factory, allow, runtime_name = made
                    for target in node.targets:
                        td = dotted(target)
                        if td is None:
                            continue
                        parts = td.split(".")
                        if parts[0] == "self" and len(parts) == 2 and fn.class_name:
                            key = (fn.class_name, parts[1])
                            name = runtime_name or f"{fn.class_name}.{parts[1]}"
                            ld = LockDef(
                                name, kind, allow, fn.class_name, parts[1],
                                pf.rel, node.lineno, factory,
                            )
                            self.by_class_attr[key] = ld
                            self.primary.setdefault(fn.class_name, ld)
                            if not factory:
                                self.raw_defs.append(ld)
            # class-body locks (class attributes shared across instances)
            for cls_node in ast.walk(pf.tree):
                if not isinstance(cls_node, ast.ClassDef):
                    continue
                for node in ast.iter_child_nodes(cls_node):
                    if not isinstance(node, ast.Assign) or not isinstance(
                        node.value, ast.Call
                    ):
                        continue
                    made = self._lock_from_call(node.value)
                    if made is None:
                        continue
                    kind, factory, allow, runtime_name = made
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            key = (cls_node.name, target.id)
                            name = runtime_name or f"{cls_node.name}.{target.id}"
                            ld = LockDef(
                                name, kind, allow, cls_node.name, target.id,
                                pf.rel, node.lineno, factory,
                            )
                            self.by_class_attr.setdefault(key, ld)
                            self.primary.setdefault(cls_node.name, ld)
                            if not factory:
                                self.raw_defs.append(ld)
            # module-level lock globals
            for node in ast.iter_child_nodes(pf.tree):
                if not isinstance(node, ast.Assign) or not isinstance(
                    node.value, ast.Call
                ):
                    continue
                made = self._lock_from_call(node.value)
                if made is None:
                    continue
                kind, factory, allow, runtime_name = made
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        name = runtime_name or f"{pf.module_name}.{target.id}"
                        ld = LockDef(
                            name, kind, allow, None, target.id,
                            pf.rel, node.lineno, factory,
                        )
                        self.by_module_var[(pf.module_name, target.id)] = ld
                        if not factory:
                            self.raw_defs.append(ld)

    # -- resolution --------------------------------------------------------

    def resolve_lock(
        self, expr: ast.AST, class_name: Optional[str], module: str
    ) -> Optional[LockDef]:
        d = dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        attr = parts[-1]
        if len(parts) == 1:
            return self.by_module_var.get((module, attr))
        owner = parts[-2]
        if owner == "self" and len(parts) == 2:
            if class_name is None:
                return None
            return self.by_class_attr.get((class_name, attr))
        alias = self.owners.get(owner)
        if alias is None:
            return None
        return self.by_class_attr.get((alias, attr))

    def resolve_callee(
        self, func_expr: ast.AST, class_name: Optional[str], module: str
    ) -> Optional[Tuple[str, str]]:
        """Key of the called function when statically resolvable: same-class
        methods (``self.m``), alias-table methods (``engine.m``), same-module
        functions (``f``)."""
        d = dotted(func_expr)
        if d is None:
            return None
        parts = d.split(".")
        name = parts[-1]
        if len(parts) == 1:
            return ("mod:" + module, name)
        owner = parts[-2]
        if owner == "self" and len(parts) == 2 and class_name:
            return ("cls:" + class_name, name)
        alias = self.owners.get(owner)
        if alias is not None:
            return ("cls:" + alias, name)
        return None

    # -- per-function facts ------------------------------------------------

    def _analyze(self) -> None:
        for pf in self.project.files:
            if pf.tree is None:
                continue
            for fn in functions_in(pf.tree):
                facts = _FuncFacts(fn, pf.rel, [], [], [])
                self._walk_body(
                    list(fn.node.body), (), facts, fn.class_name, pf.module_name
                )
                scope = (
                    "cls:" + fn.class_name if fn.class_name else "mod:" + pf.module_name
                )
                # Last definition wins on name collisions across modules —
                # acceptable: lock-bearing classes here have unique names.
                self.functions[(scope, fn.name)] = facts

    def _scan_calls(
        self,
        stmt: ast.AST,
        held: Tuple[LockDef, ...],
        facts: _FuncFacts,
        class_name: Optional[str],
        module: str,
    ) -> None:
        for node in walk_same_scope(stmt):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None:
                continue
            facts.dispatches.append((d, node.lineno, held))
            key = self.resolve_callee(node.func, class_name, module)
            if key is not None:
                facts.calls.append((key, node.lineno, held))

    def _walk_body(
        self,
        stmts: List[ast.stmt],
        held: Tuple[LockDef, ...],
        facts: _FuncFacts,
        class_name: Optional[str],
        module: str,
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    # calls inside the context expr run under the outer set
                    self._scan_calls(item.context_expr, inner, facts, class_name, module)
                    ld = self.resolve_lock(item.context_expr, class_name, module)
                    if ld is not None:
                        facts.acquisitions.append((ld, stmt.lineno, inner))
                        inner = inner + (ld,)
                self._walk_body(list(stmt.body), inner, facts, class_name, module)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # separate scope, analyzed on its own
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_calls(stmt.test, held, facts, class_name, module)
                self._walk_body(list(stmt.body), held, facts, class_name, module)
                self._walk_body(list(stmt.orelse), held, facts, class_name, module)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_calls(stmt.iter, held, facts, class_name, module)
                self._walk_body(list(stmt.body), held, facts, class_name, module)
                self._walk_body(list(stmt.orelse), held, facts, class_name, module)
            elif isinstance(stmt, ast.Try):
                self._walk_body(list(stmt.body), held, facts, class_name, module)
                for handler in stmt.handlers:
                    self._walk_body(list(handler.body), held, facts, class_name, module)
                self._walk_body(list(stmt.orelse), held, facts, class_name, module)
                self._walk_body(list(stmt.finalbody), held, facts, class_name, module)
            else:
                self._scan_calls(stmt, held, facts, class_name, module)


def _propagate(world: _LockWorld) -> Tuple[
    Dict[Tuple[str, str], Tuple[str, int]],  # edge (a,b) -> first site
    List[Tuple[str, str, int]],  # dispatch violations (lock, file, line)
    Dict[str, LockDef],
]:
    """Fixpoint propagation of held-lock sets through the static call graph.

    Seeds: every function with the empty set, plus the ``*_locked`` naming
    convention (method runs under its class's primary lock). Each (function,
    held-set) pair is processed once; graphs here are tiny."""
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    dispatch_hits: Dict[Tuple[str, str, int], None] = {}
    locks: Dict[str, LockDef] = {}

    dispatch_patterns = list(_DEFAULT_DISPATCH_CALLS)
    cfg = world.project.rule_config("dispatch-under-lock")
    dispatch_patterns += [str(p) for p in cfg.get("dispatch_calls", [])]

    def is_dispatch(callee: str) -> bool:
        last = callee.rsplit(".", 1)[-1]
        return any(
            fnmatch.fnmatch(callee, pat) or fnmatch.fnmatch(last, pat)
            for pat in dispatch_patterns
        )

    work: List[Tuple[Tuple[str, str], Tuple[LockDef, ...]]] = []
    for key, facts in world.functions.items():
        work.append((key, ()))
        if facts.info.name.endswith("_locked") and facts.info.class_name:
            primary = world.primary.get(facts.info.class_name)
            if primary is not None:
                work.append((key, (primary,)))

    seen: Set[Tuple[Tuple[str, str], Tuple[str, ...]]] = set()
    while work:
        key, held_in = work.pop()
        facts = world.functions.get(key)
        if facts is None:
            continue
        marker = (key, tuple(sorted({l.name for l in held_in})))
        if marker in seen:
            continue
        seen.add(marker)
        for ld, line, local in facts.acquisitions:
            locks[ld.name] = ld
            for h in set(held_in) | set(local):
                locks[h.name] = h
                if h.name == ld.name:
                    if ld.kind == "lock":
                        # non-reentrant self-nesting: immediate deadlock risk
                        edges.setdefault((h.name, ld.name), (facts.file, line))
                    continue
                edges.setdefault((h.name, ld.name), (facts.file, line))
        for callee_d, line, local in facts.dispatches:
            if not is_dispatch(callee_d):
                continue
            for h in set(held_in) | set(local):
                if not h.allow_dispatch:
                    dispatch_hits[(h.name, facts.file, line)] = None
        for callee_key, line, local in facts.calls:
            now_held = tuple({l.name: l for l in held_in + local}.values())
            work.append((callee_key, now_held))

    return edges, [k for k in dispatch_hits], locks


def _find_cycles(edges: Dict[Tuple[str, str], Tuple[str, int]]) -> List[List[str]]:
    """Every elementary cycle's node list (deduped by node set), via DFS from
    each node over the edge relation. Self-edges come out as [a, a]."""
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    cycles: List[List[str]] = []
    seen_sets: Set[frozenset] = set()

    def dfs(start: str, node: str, path: List[str], visited: Set[str]) -> None:
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                key = frozenset(path)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(path + [start])
            elif nxt not in visited and nxt > start:
                # only walk nodes ordered after start: each cycle found once
                dfs(start, nxt, path + [nxt], visited | {nxt})

    for a, b in sorted(edges):
        if a == b:
            key = frozenset((a,))
            if key not in seen_sets:
                seen_sets.add(key)
                cycles.append([a, a])
    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return cycles


_WORLD: Optional[Tuple["weakref.ref[Project]", _LockWorld]] = None


def build_world(project: Project) -> _LockWorld:
    """The project's lock inventory, built once per project: lock-order,
    dispatch-under-lock and the guarded-by family all read it."""
    global _WORLD
    if _WORLD is not None and _WORLD[0]() is project:
        return _WORLD[1]
    owners = {
        str(k): str(v)
        for k, v in project.rule_config("lock-order").get("owners", {}).items()
    }
    world = _LockWorld(project, owners)
    _WORLD = (weakref.ref(project), world)
    return world


@register
class LockOrderRule(Rule):
    id = "lock-order"
    summary = "global lock acquisition graph must stay acyclic"
    invariant = (
        "no two lock sites acquire the same pair of locks in opposite order "
        "(cycle in the static acquisition graph = potential deadlock); "
        "non-reentrant locks never self-nest; every lock is created through "
        "the lockcheck factories so the runtime sanitizer can see it"
    )
    subsystem = "engine/, reliability/, consensus/device.py"

    def check(self, project: Project) -> Iterable[Finding]:
        world = build_world(project)
        edges, _, locks = _propagate(world)
        for cycle in _find_cycles(edges):
            first_edge = (cycle[0], cycle[1])
            site = edges.get(first_edge, ("", 0))
            path = " -> ".join(cycle)
            provenance = "; ".join(
                f"{a}->{b} at {edges[(a, b)][0]}:{edges[(a, b)][1]}"
                for a, b in zip(cycle, cycle[1:])
                if (a, b) in edges
            )
            if len(cycle) == 2 and cycle[0] == cycle[1]:
                msg = (
                    f"non-reentrant lock {cycle[0]!r} acquired while already "
                    f"held (self-deadlock, or two instances of the same class "
                    f"nested without an ordering rule): {provenance}"
                )
            else:
                msg = (
                    f"lock-order cycle {path} — two threads walking this from "
                    f"different ends deadlock ({provenance})"
                )
            yield Finding(self.id, site[0], site[1], msg)
        for raw in world.raw_defs:
            yield Finding(
                self.id,
                raw.file,
                raw.line,
                f"lock {raw.name!r} is created with threading.{raw.kind.capitalize() if raw.kind != 'rlock' else 'RLock'}()"
                " directly; use analysis.lockcheck.make_lock/make_rlock/"
                "make_condition so KLLMS_LOCKCHECK=1 can instrument it",
            )


@register
class DispatchUnderLockRule(Rule):
    id = "dispatch-under-lock"
    summary = "no device dispatch while holding a lock not marked allow_dispatch"
    invariant = (
        "kernel wrappers, model forwards and torch.cuda/event synchronize "
        "do not run under a lock unless the lock was created with "
        "allow_dispatch=True — device steps take milliseconds and serialize "
        "every waiter behind them"
    )
    subsystem = "engine/, consensus/device.py"

    def check(self, project: Project) -> Iterable[Finding]:
        world = build_world(project)
        _, dispatch_hits, _ = _propagate(world)
        for lock_name, file, line in sorted(dispatch_hits):
            yield Finding(
                self.id,
                file,
                line,
                f"device dispatch while holding {lock_name!r} (created "
                "without allow_dispatch=True); move the dispatch outside the "
                "critical section or justify the hold at the lock's creation "
                "site",
            )
