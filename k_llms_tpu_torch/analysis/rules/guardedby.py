"""guarded-by: static guard inference + race flagging for lock-owning classes.

``lock-order`` proves the acquisition graph is acyclic but says
nothing about *coverage*: nothing knew which lock is supposed to guard
``_SlotRequest`` journals, ``LatencyHistograms`` buckets, or ``ReplicaSet``
EWMAs, so a ``Trace.phase()``-class race (an unsynchronized dict behind a
concurrent API) could ship silently. This rule family closes the gap
with the GUARDED_BY discipline from production C++ thread-safety analysis,
adapted to this package's lock factories:

For every class owning a ``make_lock``/``make_rlock``/``make_condition``
factory lock, each ``self._attr`` (or alias, via the lock-order ``owners``
table) read/write site is collected together with the locks that are
provably held there:

- syntactic ``with self._lock:`` scopes,
- the ``*_locked`` naming convention (method runs under its class's primary
  lock — same seed the lock-order rule uses),
- an interprocedural entry-lockset fixpoint: a private helper's entry set is
  the intersection, over every static intra-class call site, of the locks
  held at that call (so ``_retire_finished_rows`` called only from locked
  regions is known to run locked without a rename).

The **majority** lock over an attribute's access sites becomes its inferred
guard. Findings:

- ``guarded-by`` — an access site that does not hold the attribute's guard
  (inferred or declared), or a tie that makes inference ambiguous;
- ``guarded-by-unguarded`` — an attribute written from ≥2 methods whose
  inferred lockset is empty (classic multi-writer race shape);
- ``guarded-by-escape`` — a guarded mutable container returned raw or
  passed raw into a callback/executor: the reference outlives the critical
  section, so every later reader races the lock-holding writers;
- ``guarded-by-annotation`` — annotation hygiene (unknown lock names,
  missing reasons, conflicts).

Inference is overridden by explicit annotations on the attribute's
assignment line (or a comment line directly above, mirroring suppressions):

    self._ring = []  # kllms: guarded-by[observability.flight]
    self._hint = 0   # kllms: unguarded — monotonic hint, torn reads benign

Annotation lock names are cross-checked against the canonical names the
lock-order rule extracts (``engine.continuous``, ``ReplicaHandle.lock``...),
so the static guard relation, the runtime ``KLLMS_RACECHECK=1`` lockset
sanitizer, and the lint all share one vocabulary.

Scope limits (by design, documented so nobody trusts this as a verifier):
attributes only written in ``__init__`` are treated as immutable
configuration; accesses inside nested functions lose their ``self`` binding
and are skipped; dynamic dispatch and cross-module aliasing resolve only
through the configured ``owners`` table.
"""

from __future__ import annotations

import ast
import fnmatch
import re
import weakref
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from ..framework import Finding, Project, Rule, register
from ._astutil import dotted, functions_in, walk_same_scope
from .locks import build_world

_GUARD_RE = re.compile(r"#\s*kllms:\s*guarded-by\[([^\]]*)\]")
_UNGUARDED_RE = re.compile(r"#\s*kllms:\s*unguarded\b(.*)$")

#: Method names that mutate their receiver in place: ``self._ring.append(x)``
#: is a *write* to ``_ring`` for lockset purposes, not a read.
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
}

#: Constructors whose result is shared mutable state worth escape-checking.
_MUTABLE_CTORS = {
    "list", "dict", "set", "deque", "defaultdict", "OrderedDict", "Counter",
}

#: Call patterns that hand their arguments to another thread/deferred
#: context; a raw guarded container passed here escapes its lock. Extended
#: via config ``callback_calls``.
_DEFAULT_CALLBACK_CALLS = [
    "*.submit", "*.add_done_callback", "*.call_soon",
    "*.call_soon_threadsafe", "Thread", "threading.Thread",
]

_FAMILY = (
    "guarded-by",
    "guarded-by-unguarded",
    "guarded-by-escape",
    "guarded-by-annotation",
)


def _scan_annotations(text: str) -> Dict[int, Tuple[str, str]]:
    """1-based line -> ("guard", lock_name) | ("unguarded", reason).

    Same attachment mechanics as suppressions: an annotation on a code line
    covers that line; on a comment-only line it covers the next line too."""
    out: Dict[int, Tuple[str, str]] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _GUARD_RE.search(line)
        if m:
            entry: Tuple[str, str] = ("guard", m.group(1).strip())
        else:
            m2 = _UNGUARDED_RE.search(line)
            if not m2:
                continue
            entry = ("unguarded", m2.group(1).strip().lstrip("—-– ").strip())
        targets = [lineno]
        if line.strip().startswith("#"):
            targets.append(lineno + 1)
        for t in targets:
            out.setdefault(t, entry)
    return out


def _is_mutable_ctor(value: ast.AST) -> bool:
    if isinstance(
        value,
        (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp),
    ):
        return True
    if isinstance(value, ast.Call):
        d = dotted(value.func)
        if d is not None and d.rsplit(".", 1)[-1] in _MUTABLE_CTORS:
            return True
    return False


@dataclass
class _Site:
    owner: str  # class owning the attribute
    attr: str
    kind: str  # "read" | "write"
    func_key: Tuple[str, str]  # ("cls:C" | "mod:m", func name)
    func_qual: str
    in_init: bool
    file: str
    line: int
    held: FrozenSet[str]  # syntactically-held canonical lock names


@dataclass
class _Ctx:
    rel: str
    module: str
    class_name: Optional[str]
    key: Tuple[str, str]
    qual: str
    in_init: bool
    ann: Dict[int, Tuple[str, str]]


class _Analysis:
    """One pass over the project shared by the whole rule family."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.world = build_world(project)
        cfg = project.rule_config("guarded-by")
        self.ignore = [str(p) for p in cfg.get("ignore", [])]
        self.min_write_methods = int(cfg.get("min_write_methods", 2))
        self.callback_calls = list(_DEFAULT_CALLBACK_CALLS) + [
            str(p) for p in cfg.get("callback_calls", [])
        ]
        self.lock_classes: Set[str] = {
            cls
            for (cls, _a), ld in self.world.by_class_attr.items()
            if ld.factory
        }
        self.lock_attrs: Set[Tuple[str, str]] = set(self.world.by_class_attr)
        self.known_lock_names: Set[str] = {
            ld.name for ld in self.world.by_class_attr.values()
        } | {ld.name for ld in self.world.by_module_var.values()}

        self._site_map: Dict[Tuple[str, str, str, int], _Site] = {}
        # callee key -> [(caller key, locks held at the call site)]
        self.callsites: Dict[
            Tuple[str, str], List[Tuple[Tuple[str, str], FrozenSet[str]]]
        ] = {}
        self.func_names: Dict[Tuple[str, str], str] = {}
        # (cls, attr) -> [(kind, value, file, line)]
        self.annotations: Dict[
            Tuple[str, str], List[Tuple[str, str, str, int]]
        ] = {}
        self.mutable: Set[Tuple[str, str]] = set()
        # ((cls, attr), how, callee, func_qual, file, line)
        self.escape_events: List[
            Tuple[Tuple[str, str], str, str, str, str, int]
        ] = []

        self._collect()
        self.entries = self._solve_entries()
        self.findings: Dict[str, List[Finding]] = {rid: [] for rid in _FAMILY}
        self._infer()

    # -- collection --------------------------------------------------------

    def _resolve_parts(
        self, parts: List[str], ctx: _Ctx
    ) -> Optional[Tuple[str, str]]:
        if len(parts) < 2:
            return None
        base = parts[0]
        if base in ("self", "cls"):
            owner = ctx.class_name
        else:
            owner = self.world.owners.get(base)
        if owner is None or owner not in self.lock_classes:
            return None
        attr = parts[1]
        if (owner, attr) in self.lock_attrs or attr.startswith("__"):
            return None
        if any(
            fnmatch.fnmatch(f"{owner}.{attr}", pat) for pat in self.ignore
        ):
            return None
        return owner, attr

    def _attr_ref(
        self, node: ast.AST, ctx: _Ctx
    ) -> Optional[Tuple[str, str]]:
        """(cls, attr) when ``node`` is exactly a two-part tracked chain."""
        d = dotted(node)
        if d is None:
            return None
        parts = d.split(".")
        if len(parts) != 2:
            return None
        return self._resolve_parts(parts, ctx)

    def _resolve_held(self, expr: ast.AST, ctx: _Ctx):
        ld = self.world.resolve_lock(expr, ctx.class_name, ctx.module)
        if ld is None and ctx.class_name is not None:
            # ``with cls._registry_lock:`` in classmethods: same-class attr.
            d = dotted(expr)
            if d is not None:
                parts = d.split(".")
                if parts[0] == "cls" and len(parts) == 2:
                    ld = self.world.by_class_attr.get(
                        (ctx.class_name, parts[1])
                    )
        return ld

    def _record(
        self,
        ref: Tuple[str, str],
        kind: str,
        line: int,
        held: FrozenSet[str],
        ctx: _Ctx,
    ) -> None:
        key = (ref[0], ref[1], ctx.rel, line)
        site = self._site_map.get(key)
        if site is None:
            self._site_map[key] = _Site(
                owner=ref[0],
                attr=ref[1],
                kind=kind,
                func_key=ctx.key,
                func_qual=ctx.qual,
                in_init=ctx.in_init,
                file=ctx.rel,
                line=line,
                held=held,
            )
        else:
            if kind == "write" and site.kind == "read":
                site.kind = "write"
            # Same line reached under different branches: keep the
            # conservative (intersection) view of what is provably held.
            site.held = site.held & held
        if kind == "write":
            ann = ctx.ann.get(line)
            if ann is not None:
                self.annotations.setdefault(ref, []).append(
                    (ann[0], ann[1], ctx.rel, line)
                )

    def _is_callback(self, callee: str) -> bool:
        last = callee.rsplit(".", 1)[-1]
        return any(
            fnmatch.fnmatch(callee, pat) or fnmatch.fnmatch(last, pat)
            for pat in self.callback_calls
        )

    def _scan(self, node: ast.AST, held: FrozenSet[str], ctx: _Ctx) -> None:
        nodes = [node]
        nodes.extend(walk_same_scope(node))
        for n in nodes:
            if isinstance(n, ast.Call):
                if (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in _MUTATOR_METHODS
                ):
                    ref = self._attr_ref(n.func.value, ctx)
                    if ref is not None:
                        self._record(ref, "write", n.lineno, held, ctx)
                fd = dotted(n.func)
                if fd is not None and self._is_callback(fd):
                    for sub in list(n.args) + [kw.value for kw in n.keywords]:
                        ref = self._attr_ref(sub, ctx)
                        if ref is not None:
                            self.escape_events.append(
                                (ref, "callback", fd, ctx.qual, ctx.rel, n.lineno)
                            )
                ckey = self.world.resolve_callee(
                    n.func, ctx.class_name, ctx.module
                )
                if ckey is not None:
                    self.callsites.setdefault(ckey, []).append((ctx.key, held))
            elif isinstance(n, ast.Return) and n.value is not None:
                ref = self._attr_ref(n.value, ctx)
                if ref is not None:
                    self.escape_events.append(
                        (ref, "return", "", ctx.qual, ctx.rel, n.lineno)
                    )
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                value = n.value
                targets = (
                    n.targets if isinstance(n, ast.Assign) else [n.target]
                )
                if value is not None and _is_mutable_ctor(value):
                    for t in targets:
                        ref = self._attr_ref(t, ctx)
                        if ref is not None:
                            self.mutable.add(ref)
            elif isinstance(n, ast.Subscript) and isinstance(
                n.ctx, (ast.Store, ast.Del)
            ):
                ref = self._attr_ref(n.value, ctx)
                if ref is not None:
                    self._record(ref, "write", n.lineno, held, ctx)
            if isinstance(n, ast.Attribute):
                d = dotted(n)
                if d is None:
                    continue
                parts = d.split(".")
                if isinstance(n.ctx, (ast.Store, ast.Del)):
                    ref = self._resolve_parts(parts, ctx)
                    if ref is not None:
                        self._record(ref, "write", n.lineno, held, ctx)
                elif len(parts) == 2:
                    ref = self._resolve_parts(parts, ctx)
                    if ref is not None:
                        self._record(ref, "read", n.lineno, held, ctx)

    def _walk(
        self, stmts: List[ast.stmt], held: FrozenSet[str], ctx: _Ctx
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    self._scan(item.context_expr, inner, ctx)
                    ld = self._resolve_held(item.context_expr, ctx)
                    if ld is not None:
                        inner = inner | {ld.name}
                self._walk(list(stmt.body), inner, ctx)
            elif isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # separate scope, analyzed on its own
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan(stmt.test, held, ctx)
                self._walk(list(stmt.body), held, ctx)
                self._walk(list(stmt.orelse), held, ctx)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan(stmt.target, held, ctx)
                self._scan(stmt.iter, held, ctx)
                self._walk(list(stmt.body), held, ctx)
                self._walk(list(stmt.orelse), held, ctx)
            elif isinstance(stmt, ast.Try):
                self._walk(list(stmt.body), held, ctx)
                for handler in stmt.handlers:
                    self._walk(list(handler.body), held, ctx)
                self._walk(list(stmt.orelse), held, ctx)
                self._walk(list(stmt.finalbody), held, ctx)
            else:
                self._scan(stmt, held, ctx)

    def _collect(self) -> None:
        for pf in self.project.files:
            if pf.tree is None:
                continue
            ann = _scan_annotations(pf.text)
            for fn in functions_in(pf.tree):
                scope = (
                    "cls:" + fn.class_name
                    if fn.class_name
                    else "mod:" + pf.module_name
                )
                key = (scope, fn.name)
                self.func_names.setdefault(key, fn.name)
                ctx = _Ctx(
                    rel=pf.rel,
                    module=pf.module_name,
                    class_name=fn.class_name,
                    key=key,
                    qual=fn.qualname,
                    in_init=fn.name in ("__init__", "__post_init__"),
                    ann=ann,
                )
                self._walk(list(fn.node.body), frozenset(), ctx)

    # -- interprocedural entry locksets ------------------------------------

    def _floor(self, key: Tuple[str, str]) -> FrozenSet[str]:
        name = self.func_names.get(key, key[1])
        if name.endswith("_locked") and key[0].startswith("cls:"):
            primary = self.world.primary.get(key[0][4:])
            if primary is not None:
                return frozenset({primary.name})
        return frozenset()

    def _solve_entries(self) -> Dict[Tuple[str, str], FrozenSet[str]]:
        """Fixpoint: a private method's entry lockset is the intersection of
        (caller entry ∪ locks held at the call site) over every observed
        call site; public/dunder methods and never-called privates get the
        empty set (anyone may call them with nothing held). ``*_locked``
        names floor their entry at the class primary lock. The lattice only
        descends (TOP → smaller sets), so iteration terminates."""
        TOP = None
        entries: Dict[Tuple[str, str], Optional[FrozenSet[str]]] = {}
        for key, name in self.func_names.items():
            private = name.startswith("_") and not name.startswith("__")
            if private and key in self.callsites:
                entries[key] = TOP
            else:
                entries[key] = self._floor(key)
        changed = True
        while changed:
            changed = False
            for callee, sites in self.callsites.items():
                if callee not in entries:
                    continue
                name = self.func_names[callee]
                if not name.startswith("_") or name.startswith("__"):
                    continue
                concrete: List[FrozenSet[str]] = []
                for caller_key, held in sites:
                    ce = entries.get(caller_key, frozenset())
                    if ce is TOP:
                        continue  # TOP caller: no constraint yet
                    concrete.append(ce | held)
                if not concrete:
                    new: Optional[FrozenSet[str]] = TOP
                else:
                    acc = concrete[0]
                    for c in concrete[1:]:
                        acc = acc & c
                    new = acc | self._floor(callee)
                if new != entries[callee]:
                    entries[callee] = new
                    changed = True
        return {
            key: (val if val is not None else self._floor(key))
            for key, val in entries.items()
        }

    # -- inference + findings ----------------------------------------------

    def _effective(self, site: _Site) -> FrozenSet[str]:
        return site.held | self.entries.get(site.func_key, frozenset())

    def _emit(self, rid: str, file: str, line: int, msg: str) -> None:
        self.findings[rid].append(Finding(rid, file, line, msg))

    def _class_lock_names(self, cls: str) -> List[str]:
        return sorted(
            ld.name
            for (c, _a), ld in self.world.by_class_attr.items()
            if c == cls
        )

    def _infer(self) -> None:
        by_attr: Dict[Tuple[str, str], List[_Site]] = {}
        for site in self._site_map.values():
            by_attr.setdefault((site.owner, site.attr), []).append(site)

        for (cls, attr), sites in sorted(by_attr.items()):
            non_init = sorted(
                (s for s in sites if not s.in_init),
                key=lambda s: (s.file, s.line),
            )
            writes = [s for s in non_init if s.kind == "write"]
            if not writes:
                # Written only during construction (or never): effectively
                # immutable configuration, not shared mutable state.
                continue

            declared: Optional[str] = None
            unguarded_reason: Optional[str] = None
            anns = self.annotations.get((cls, attr), [])
            distinct = sorted({(a[0], a[1]) for a in anns})
            if len(distinct) > 1:
                first = min(anns, key=lambda a: (a[2], a[3]))
                self._emit(
                    "guarded-by-annotation",
                    first[2],
                    first[3],
                    f"conflicting annotations on {cls}.{attr}: "
                    + ", ".join(
                        f"'{k}[{v}]'" if k == "guard" else f"'{k}'"
                        for k, v in distinct
                    )
                    + " — keep exactly one",
                )
            if anns:
                kind, value, afile, aline = min(
                    anns, key=lambda a: (a[2], a[3])
                )
                if kind == "unguarded":
                    if not value:
                        self._emit(
                            "guarded-by-annotation",
                            afile,
                            aline,
                            f"annotation '# kllms: unguarded' on {cls}.{attr}"
                            " needs a reason: '# kllms: unguarded — <why"
                            " unsynchronized access is safe>'",
                        )
                    unguarded_reason = value or "(missing)"
                else:
                    if value in self.known_lock_names:
                        declared = value
                    else:
                        self._emit(
                            "guarded-by-annotation",
                            afile,
                            aline,
                            f"annotation '# kllms: guarded-by[{value}]' on "
                            f"{cls}.{attr} names no known lock; canonical "
                            f"names for {cls}: "
                            + (", ".join(self._class_lock_names(cls)) or "none")
                            + " (vocabulary shared with the lock-order rule)",
                        )

            if unguarded_reason is not None:
                continue  # explicitly exempted from guard checking

            guard: Optional[str] = None
            prov = ""
            tie = False
            n = len(non_init)
            if declared is not None:
                guard = declared
                prov = "declared via # kllms: guarded-by"
            elif n:
                counts: Dict[str, int] = {}
                for s in non_init:
                    for lock in self._effective(s):
                        counts[lock] = counts.get(lock, 0) + 1
                majority = {
                    lock: c for lock, c in counts.items() if c * 2 > n
                }
                if majority:
                    top = max(majority.values())
                    winners = sorted(
                        l for l, c in majority.items() if c == top
                    )
                    if len(winners) > 1:
                        tie = True
                        first = non_init[0]
                        self._emit(
                            "guarded-by",
                            first.file,
                            first.line,
                            f"cannot infer a guard for {cls}.{attr}: tie "
                            f"between {', '.join(repr(w) for w in winners)} "
                            f"(each held at {top} of {n} access sites); "
                            "declare one with '# kllms: guarded-by[<lock>]'"
                            " at the attribute's assignment",
                        )
                    else:
                        guard = winners[0]
                        prov = (
                            f"inferred: held at {top} of {n} access sites"
                        )

            if guard is not None:
                for s in non_init:
                    if guard not in self._effective(s):
                        self._emit(
                            "guarded-by",
                            s.file,
                            s.line,
                            f"{cls}.{attr} is guarded by {guard!r} ({prov}) "
                            f"but this {s.kind} in {s.func_qual} does not "
                            f"hold it; acquire the lock around the access "
                            "or annotate the attribute",
                        )
                if (cls, attr) in self.mutable:
                    for ref, how, callee, qual, file, line in sorted(
                        self.escape_events, key=lambda e: (e[4], e[5])
                    ):
                        if ref != (cls, attr):
                            continue
                        if how == "return":
                            msg = (
                                f"guarded attribute {cls}.{attr} (guard "
                                f"{guard!r}) is returned raw from {qual}; "
                                "the reference outlives the critical "
                                "section — return a copy"
                            )
                        else:
                            msg = (
                                f"guarded attribute {cls}.{attr} (guard "
                                f"{guard!r}) is passed raw into {callee} "
                                f"from {qual}; the callee outlives the "
                                "critical section — pass a copy"
                            )
                        self._emit("guarded-by-escape", file, line, msg)
            elif not tie:
                writers = sorted({s.func_qual for s in writes})
                if len(writers) >= self.min_write_methods:
                    first = min(writes, key=lambda s: (s.file, s.line))
                    self._emit(
                        "guarded-by-unguarded",
                        first.file,
                        first.line,
                        f"{cls}.{attr} is written from {len(writers)} "
                        f"methods ({', '.join(writers)}) with no "
                        "consistently-held lock (inferred lockset is "
                        "empty); guard it with one of the class's locks or "
                        "annotate '# kllms: unguarded — <reason>'",
                    )


# One-entry cache: the four family rules run back-to-back over the same
# Project; re-deriving the world + fixpoint per rule would quadruple the
# lint's hot path for no information gain.
_CACHE: Optional[Tuple["weakref.ref[Project]", _Analysis]] = None


def _analysis_for(project: Project) -> _Analysis:
    global _CACHE
    if _CACHE is not None and _CACHE[0]() is project:
        return _CACHE[1]
    analysis = _Analysis(project)
    _CACHE = (weakref.ref(project), analysis)
    return analysis


class _FamilyRule(Rule):
    def check(self, project: Project) -> Iterable[Finding]:
        return list(_analysis_for(project).findings[self.id])


@register
class GuardedByRule(_FamilyRule):
    id = "guarded-by"
    summary = "every access to a lock-guarded attribute holds its guard"
    invariant = (
        "for each attribute of a factory-locked class, the majority lock "
        "over its access sites (or the declared # kllms: guarded-by[...] "
        "lock) is held at every read and write outside __init__"
    )
    subsystem = "engine/, serving/, reliability/, observability/, consensus/"


@register
class GuardedByUnguardedRule(_FamilyRule):
    id = "guarded-by-unguarded"
    summary = "no multi-writer attribute without an inferable guard"
    invariant = (
        "an attribute of a factory-locked class written from two or more "
        "methods has a non-empty inferred lockset, or carries an explicit "
        "# kllms: unguarded — <reason> annotation"
    )
    subsystem = "engine/, serving/, reliability/, observability/, consensus/"


@register
class GuardedByEscapeRule(_FamilyRule):
    id = "guarded-by-escape"
    summary = "guarded mutable containers do not escape their critical section"
    invariant = (
        "a guarded list/dict/set/deque attribute is never returned raw or "
        "passed raw into a callback/executor — hand out copies so readers "
        "cannot race the lock-holding writers"
    )
    subsystem = "engine/, serving/, reliability/, observability/, consensus/"


@register
class GuardedByAnnotationRule(_FamilyRule):
    id = "guarded-by-annotation"
    summary = "guarded-by annotations name real locks and carry reasons"
    invariant = (
        "# kllms: guarded-by[<name>] names a canonical lock the lock-order "
        "rule knows; # kllms: unguarded carries a reason; annotations on "
        "one attribute do not conflict"
    )
    subsystem = "engine/, serving/, reliability/, observability/, consensus/"
