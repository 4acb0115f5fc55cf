"""Device-performance rules: host syncs in hot paths, per-request compiles.

- **host-sync-hot-path** — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``torch.cuda.synchronize()``, an event's ``.synchronize()``
  and ``bool(...)``/``int(...)``/``float(...)`` of a tensor expression wait
  for the card to drain its queue and copy a value back: a pipeline stall.
  Inside a configured hot function (the per-token decode step, see
  ``[host-sync-hot-path] hot_functions`` in ``analysis/kllms-check.toml``)
  each one is a per-token sync that caps throughput. The continuous loop's
  single by-design sync per step carries an inline suppression explaining
  why. A hot pattern matches a function's name or its qualified name
  (``LocalEngine._decode.sample`` for a closure).
- **jit-recompile-hygiene** — what the package compiles or loads at call
  time (``torch.compile``, a ``torch.cuda.CUDAGraph`` capture, a kernel
  library's ``ctypes`` load) costs seconds the first time each object is
  used. One made inside a per-request function is a new object every call,
  so the work repeats every request. Sanctioned patterns: memoized stores
  (``self._x = torch.compile(f)``, ``cache[key] = ctypes.CDLL(path)``),
  module-level objects, ``functools.lru_cache``-decorated factories, and
  builder functions (``__init__``, ``_build*``, ``make_*``...).
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..framework import Finding, Project, Rule, register
from ._astutil import FuncInfo, decorator_names, dotted, functions_in, walk_same_scope

#: Zero-argument methods that read a CUDA tensor back (or wait for the card).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: Module functions that wait for the card.
_SYNC_DOTTED = {"torch.cuda.synchronize"}
#: ``bool``/``int``/``float`` of a tensor is a readback; the AST can tell a
#: tensor only where the argument is a call of ``torch.*`` or of one of
#: these tensor reductions (``bool(done.all())``).
_SCALAR_CASTS = {"bool", "int", "float"}
_TENSOR_REDUCTIONS = {
    "all", "any", "sum", "max", "min", "amax", "amin", "argmax", "argmin",
    "mean", "prod", "count_nonzero", "norm",
}
#: Calls that compile or load something at call time.
_COMPILE_NAMES = {
    "torch.compile",
    "torch.cuda.CUDAGraph",
    "ctypes.CDLL",
    "ctypes.cdll.LoadLibrary",
}
_MEMO_DECORATORS = {
    "functools.lru_cache",
    "lru_cache",
    "functools.cache",
    "cache",
}
_DEFAULT_BUILDERS = [
    "__init__",
    "_build*",
    "build_*",
    "_make*",
    "make_*",
    "*_factory",
]


def _is_compile_call(call: ast.Call) -> bool:
    d = dotted(call.func)
    if d in _COMPILE_NAMES:
        return True
    # functools.partial(torch.compile, mode=...) applied later
    if d in ("functools.partial", "partial") and call.args:
        return dotted(call.args[0]) in _COMPILE_NAMES
    return False


def _is_tensor_expr(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted(node.func)
    if d is not None and d.startswith("torch."):
        return True
    return isinstance(node.func, ast.Attribute) and node.func.attr in _TENSOR_REDUCTIONS


def _sync_call_name(call: ast.Call) -> str:
    """Non-empty description when the call is a host sync."""
    d = dotted(call.func)
    if d is not None and d in _SYNC_DOTTED:
        return d
    if isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_METHODS:
        # Zero-arg attribute calls only: x.item(), t.cpu(), ev.synchronize().
        # ``.cpu(non_blocking=...)``-style calls and dict methods that take
        # arguments are not matched.
        if not call.args and not call.keywords:
            return f"*.{call.func.attr}"
    if (
        isinstance(call.func, ast.Name)
        and call.func.id in _SCALAR_CASTS
        and len(call.args) == 1
        and not call.keywords
        and _is_tensor_expr(call.args[0])
    ):
        return f"{call.func.id}(<tensor>)"
    return ""


def _is_hot(fn: FuncInfo, patterns: Iterable[str]) -> bool:
    return any(
        fnmatch.fnmatch(fn.name, p) or fnmatch.fnmatch(fn.qualname, p) for p in patterns
    )


@register
class HostSyncHotPathRule(Rule):
    id = "host-sync-hot-path"
    summary = "no host↔device syncs inside decode-step functions"
    invariant = (
        ".item()/.tolist()/.cpu()/.numpy()/torch.cuda.synchronize()/"
        "event.synchronize() and bool/int/float of a tensor do not appear "
        "inside configured hot functions (per-token decode steps) — each one "
        "is a full pipeline stall"
    )
    subsystem = "engine/, models/, ops/, consensus/device.py"

    def check(self, project: Project) -> Iterable[Finding]:
        hot_patterns = [
            str(p)
            for p in project.rule_config(self.id).get("hot_functions", [])
        ]
        for pf in project.files:
            if pf.tree is None:
                continue
            for fn in functions_in(pf.tree):
                if not _is_hot(fn, hot_patterns):
                    continue
                for node in walk_same_scope(fn.node):
                    if not isinstance(node, ast.Call):
                        continue
                    sync = _sync_call_name(node)
                    if sync:
                        yield Finding(
                            self.id,
                            pf.rel,
                            node.lineno,
                            f"host sync {sync} inside a configured hot function "
                            f"({fn.qualname}) — forces a device→host round "
                            "trip per invocation",
                        )


@register
class JitRecompileRule(Rule):
    id = "jit-recompile-hygiene"
    summary = "compiled graphs and kernel libraries are made once, not per request"
    invariant = (
        "torch.compile / torch.cuda.CUDAGraph / ctypes.CDLL results are "
        "stored in memoized slots (self attribute, cache subscript, module "
        "global) or created inside builder/lru_cache factories — one made "
        "inside a per-request function compiles or loads on every call"
    )
    subsystem = "engine/, models/, ops/, consensus/device.py"

    def check(self, project: Project) -> Iterable[Finding]:
        builders = _DEFAULT_BUILDERS + [
            str(p)
            for p in project.rule_config(self.id).get("builder_functions", [])
        ]
        for pf in project.files:
            if pf.tree is None:
                continue
            # Module-level objects are made once per import; only code inside
            # functions can repeat per call, so only that is walked.
            for fn in functions_in(pf.tree):
                if any(fnmatch.fnmatch(fn.name, p) for p in builders):
                    continue
                if any(
                    d in _MEMO_DECORATORS for d in decorator_names(fn.node)
                ):
                    continue  # memoized factory: one object per arg tuple
                sanctioned: set = set()
                made_locals: dict = {}  # local name -> [compile call ids]
                stored_names: set = set()
                # ``global _lib`` names: an assignment to one is a module
                # global, a memoized slot like a cache subscript.
                module_globals = {
                    name
                    for node in walk_same_scope(fn.node)
                    if isinstance(node, ast.Global)
                    for name in node.names
                }

                def memo_slot(t: ast.AST) -> bool:
                    return isinstance(t, (ast.Attribute, ast.Subscript)) or (
                        isinstance(t, ast.Name) and t.id in module_globals
                    )

                for node in walk_same_scope(fn.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    is_compile = isinstance(node.value, ast.Call) and _is_compile_call(
                        node.value
                    )
                    if is_compile and all(memo_slot(t) for t in node.targets):
                        # self._fn = torch.compile(...) / cache[key] = ... /
                        # a module global: the store is the memoization.
                        sanctioned.add(id(node.value))
                    elif is_compile:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                made_locals.setdefault(t.id, []).append(
                                    id(node.value)
                                )
                    elif isinstance(node.value, ast.Name) and any(
                        memo_slot(t) for t in node.targets
                    ):
                        # cache[key] = lib — the memoized-getter idiom where
                        # the object is made in a local first.
                        stored_names.add(node.value.id)
                for name in stored_names:
                    sanctioned.update(made_locals.get(name, ()))
                for node in walk_same_scope(fn.node):
                    if not (isinstance(node, ast.Call) and _is_compile_call(node)):
                        continue
                    if id(node) in sanctioned:
                        continue
                    yield Finding(
                        self.id,
                        pf.rel,
                        node.lineno,
                        f"{dotted(node.func)}(...) inside {fn.qualname} is "
                        "neither stored in a memoized slot (self attribute / "
                        "cache subscript / module global) nor inside a "
                        "builder or lru_cache factory — this recompiles on "
                        "every call",
                    )
