"""Registry/contract rules: failpoint coverage, counter hygiene, wire errors.

These rules check the cross-surface invariants that a unit test can't see from
any single file:

- **failpoint-coverage** — every ``failpoints.fire(...)`` /
  ``fire_keyed(...)`` call site names a literal site registered in ``SITES``;
  every registered site is fired somewhere, exercised by a test, and
  documented in the README registry table; every ``FailSpec`` action variant
  is exercised by at least one test.
- **counter-hygiene** — every ``*_EVENTS.record(...)`` literal (or f-string
  shape) is covered by its group's ``declared=`` patterns; every declared
  non-wildcard counter is actually recorded somewhere; every group is
  surfaced by the ``/metrics`` endpoint. The same contract covers
  ``LatencyHistograms``: every ``observe(...)`` against a declared histogram
  group uses a declared family, every declared family is observed somewhere,
  and the group is surfaced on ``/metrics``.
- **wire-error-contract** — every direct ``KLLMsError`` subclass pins
  ``type`` and ``status_code`` in its class body, and every ``as_wire``
  override builds on ``super().as_wire()`` so the base error envelope
  ({"error": {message, type, code, param}}) survives subclassing.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..framework import Finding, Project, ProjectFile, Rule, register
from ._astutil import dotted, str_const


def _module_assign_calls(
    pf: ProjectFile, callee_last: str
) -> Iterable[Tuple[str, ast.Call, int]]:
    """(target_name, call, lineno) for module-level ``NAME = callee(...)``."""
    if pf.tree is None:
        return
    for node in ast.iter_child_nodes(pf.tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        d = dotted(node.value.func)
        if d is None or d.rsplit(".", 1)[-1] != callee_last:
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                yield target.id, node.value, node.lineno


# ---------------------------------------------------------------------------
# failpoint-coverage
# ---------------------------------------------------------------------------


@register
class FailpointCoverageRule(Rule):
    id = "failpoint-coverage"
    summary = "every failpoint site is registered, fired, tested, and documented"
    invariant = (
        "fire()/fire_keyed() call sites use literal site names present in "
        "failpoints.SITES; every registered site has a call site, appears in "
        "a test, and has a README registry-table row; every FailSpec action "
        "variant is exercised by at least one test"
    )
    subsystem = "reliability/failpoints.py + call sites + tests + README"

    def _sites(self, pf: ProjectFile) -> Dict[str, int]:
        out: Dict[str, int] = {}
        if pf.tree is None:
            return out
        for node in ast.iter_child_nodes(pf.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "SITES" for t in node.targets
            ):
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                for elt in node.value.elts:
                    s = str_const(elt)
                    if s is not None:
                        out[s] = elt.lineno
        return out

    def _actions(self, pf: ProjectFile) -> List[str]:
        """The action-name whitelist from FailSpec.__post_init__'s membership
        check — the single source of truth for legal actions."""
        if pf.tree is None:
            return []
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Compare) or len(node.ops) != 1:
                continue
            if not isinstance(node.ops[0], (ast.NotIn, ast.In)):
                continue
            left = dotted(node.left)
            if left not in ("self.action", "action"):
                continue
            cmp = node.comparators[0]
            if isinstance(cmp, (ast.Tuple, ast.List, ast.Set)):
                actions = [s for s in (str_const(e) for e in cmp.elts) if s]
                if len(actions) >= 2:
                    return actions
        return []

    def _fire_calls(self, project: Project) -> List[Tuple[ProjectFile, ast.Call, Optional[str]]]:
        out = []
        for pf in project.files:
            if pf.tree is None:
                continue
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d is None:
                    continue
                parts = d.split(".")
                if parts[-1] not in ("fire", "fire_keyed"):
                    continue
                if len(parts) < 2 or parts[-2].lstrip("_") != "failpoints":
                    continue
                site = str_const(node.args[0]) if node.args else None
                out.append((pf, node, site))
        return out

    def check(self, project: Project) -> Iterable[Finding]:
        reg = project.find_file("reliability/failpoints.py")
        if reg is None:
            return
        sites = self._sites(reg)
        if not sites:
            yield Finding(
                self.id, reg.rel, 1, "could not locate the SITES tuple"
            )
            return

        fired: Set[str] = set()
        for pf, call, site in self._fire_calls(project):
            if site is None:
                yield Finding(
                    self.id,
                    pf.rel,
                    call.lineno,
                    "failpoint site must be a string literal so the registry "
                    "stays statically checkable",
                )
                continue
            fired.add(site)
            if site not in sites:
                yield Finding(
                    self.id,
                    pf.rel,
                    call.lineno,
                    f"failpoint site {site!r} is not registered in "
                    "failpoints.SITES — a typo'd site never fires",
                )

        all_tests = "\n".join(project.test_sources.values())
        for site, line in sites.items():
            if site not in fired:
                yield Finding(
                    self.id,
                    reg.rel,
                    line,
                    f"registered failpoint site {site!r} has no "
                    "fire()/fire_keyed() call site — dead registry entry",
                )
            if project.test_sources and site not in all_tests:
                yield Finding(
                    self.id,
                    reg.rel,
                    line,
                    f"failpoint site {site!r} is exercised by no test under "
                    "tests/ — an untested failure path is an unhardened one",
                )
            if project.readme is not None and f"`{site}`" not in project.readme:
                yield Finding(
                    self.id,
                    reg.rel,
                    line,
                    f"failpoint site {site!r} has no README registry-table "
                    "row (expected a `" + site + "` cell)",
                )

        if project.test_sources:
            for action in self._actions(reg):
                pat = re.compile(
                    r"action\s*=\s*['\"]" + re.escape(action) + r"['\"]"
                    r"|=" + re.escape(action) + r"[:'\",]"
                )
                if not pat.search(all_tests):
                    yield Finding(
                        self.id,
                        reg.rel,
                        1,
                        f"failpoint action variant {action!r} is never "
                        "exercised by any test (no FailSpec(action=...) or "
                        "KLLMS_FAILPOINTS spec uses it)",
                    )


# ---------------------------------------------------------------------------
# counter-hygiene
# ---------------------------------------------------------------------------


@register
class CounterHygieneRule(Rule):
    id = "counter-hygiene"
    summary = "every recorded counter is declared; every declared counter is live"
    invariant = (
        "each *_EVENTS.record(name) literal (or f-string shape) matches a "
        "pattern in that group's declared= tuple; each declared non-wildcard "
        "counter is recorded somewhere; each group is surfaced on /metrics; "
        "the same holds for LatencyHistograms families via observe()"
    )
    subsystem = (
        "utils/observability.py + observability/ + all record()/observe() "
        "call sites + serving/app.py"
    )

    def _declared_groups(
        self, pf: ProjectFile
    ) -> Dict[str, Tuple[List[str], int]]:
        groups: Dict[str, Tuple[List[str], int]] = {}
        for name, call, lineno in _module_assign_calls(pf, "EventCounters"):
            declared: Optional[List[str]] = None
            for kw in call.keywords:
                if kw.arg == "declared" and isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    declared = [
                        s for s in (str_const(e) for e in kw.value.elts) if s
                    ]
            groups[name] = (declared if declared is not None else [], lineno)
        return groups

    @staticmethod
    def _record_shape(arg: ast.AST) -> Optional[Tuple[str, bool]]:
        """(shape, is_glob): a literal name, or an f-string with each
        interpolated field as ``*``. None for dynamic expressions."""
        s = str_const(arg)
        if s is not None:
            return s, False
        if isinstance(arg, ast.JoinedStr):
            parts: List[str] = []
            for piece in arg.values:
                if isinstance(piece, ast.Constant):
                    parts.append(str(piece.value))
                else:
                    parts.append("*")
            return "".join(parts), True
        return None

    def check(self, project: Project) -> Iterable[Finding]:
        obs = project.find_file("utils/observability.py")
        if obs is None:
            return
        groups = self._declared_groups(obs)
        for name, (declared, lineno) in groups.items():
            if not declared:
                yield Finding(
                    self.id,
                    obs.rel,
                    lineno,
                    f"counter group {name} is constructed without declared= — "
                    "undeclared groups accept typo'd counter names silently",
                )

        # Every record() call against a known group, project-wide.
        recorded_literals: Set[str] = set()
        recorded_globs: Set[str] = set()
        for pf in project.files:
            if pf.tree is None:
                continue
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d is None:
                    continue
                parts = d.split(".")
                if parts[-1] != "record" or len(parts) < 2:
                    continue
                group = parts[-2]
                if group not in groups:
                    continue
                declared, _ = groups[group]
                if not declared:
                    continue  # already flagged at the declaration
                if not node.args:
                    continue
                shape = self._record_shape(node.args[0])
                if shape is None:
                    continue  # dynamic name; statically unresolvable
                text, is_glob = shape
                if is_glob:
                    recorded_globs.add(text)
                    example = text.replace("*", "x")
                else:
                    recorded_literals.add(text)
                    example = text
                if not any(fnmatch.fnmatch(example, pat) for pat in declared):
                    yield Finding(
                        self.id,
                        pf.rel,
                        node.lineno,
                        f"counter {text!r} recorded on {group} is not covered "
                        f"by its declared= patterns {declared}",
                    )

        for name, (declared, lineno) in groups.items():
            for pat in declared:
                if "*" in pat or "?" in pat:
                    continue
                if pat in recorded_literals:
                    continue
                if any(fnmatch.fnmatch(pat, g) for g in recorded_globs):
                    continue
                yield Finding(
                    self.id,
                    obs.rel,
                    lineno,
                    f"declared counter {pat!r} in group {name} is never "
                    "recorded anywhere — stale name or dead instrumentation",
                )

        metrics_rel = str(
            project.rule_config(self.id).get("metrics_file", "serving/app.py")
        )
        metrics = project.find_file(metrics_rel)
        if metrics is not None:
            for name, (_, lineno) in groups.items():
                if name not in metrics.text:
                    yield Finding(
                        self.id,
                        obs.rel,
                        lineno,
                        f"counter group {name} is not surfaced by "
                        f"{metrics.rel} — /metrics must export every group",
                    )

        yield from self._check_histograms(project, metrics)

    def _check_histograms(
        self, project: Project, metrics: Optional[ProjectFile]
    ) -> Iterable[Finding]:
        """Mirror the counter contract for ``LatencyHistograms`` families.

        Histogram groups are module-level ``NAME = LatencyHistograms(...)``
        assignments anywhere in the package (the canonical ``LATENCY`` lives
        in ``observability/histograms.py``; ``utils/observability.py`` only
        re-exports it, which is an ImportFrom, not an Assign). ``observe()``
        receivers are matched by the group's name normalised for private
        aliases (``self._latency.observe`` attributes to ``LATENCY``)."""
        hist_groups: Dict[str, Tuple[List[str], int, ProjectFile]] = {}
        for pf in project.files:
            if pf.tree is None:
                continue
            for name, call, lineno in _module_assign_calls(
                pf, "LatencyHistograms"
            ):
                declared: Optional[List[str]] = None
                for kw in call.keywords:
                    if kw.arg == "declared" and isinstance(
                        kw.value, (ast.Tuple, ast.List)
                    ):
                        declared = [
                            s for s in (str_const(e) for e in kw.value.elts) if s
                        ]
                hist_groups[name] = (
                    declared if declared is not None else [],
                    lineno,
                    pf,
                )

        for name, (declared, lineno, pf) in hist_groups.items():
            if not declared:
                yield Finding(
                    self.id,
                    pf.rel,
                    lineno,
                    f"histogram group {name} is constructed without declared= "
                    "— undeclared groups accept typo'd family names silently",
                )

        norm_groups = {g.lstrip("_").upper(): g for g in hist_groups}
        observed_literals: Set[str] = set()
        observed_globs: Set[str] = set()
        for pf in project.files:
            if pf.tree is None:
                continue
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d is None:
                    continue
                parts = d.split(".")
                if parts[-1] != "observe" or len(parts) < 2:
                    continue
                group = norm_groups.get(parts[-2].lstrip("_").upper())
                if group is None:
                    continue
                declared, _, _ = hist_groups[group]
                if not declared:
                    continue  # already flagged at the declaration
                if not node.args:
                    continue
                shape = self._record_shape(node.args[0])
                if shape is None:
                    continue  # dynamic family name; statically unresolvable
                text, is_glob = shape
                if is_glob:
                    observed_globs.add(text)
                    example = text.replace("*", "x")
                else:
                    observed_literals.add(text)
                    example = text
                if not any(fnmatch.fnmatch(example, pat) for pat in declared):
                    yield Finding(
                        self.id,
                        pf.rel,
                        node.lineno,
                        f"histogram family {text!r} observed on {group} is "
                        f"not covered by its declared= patterns {declared}",
                    )

        for name, (declared, lineno, pf) in hist_groups.items():
            for pat in declared:
                if "*" in pat or "?" in pat:
                    continue
                if pat in observed_literals:
                    continue
                if any(fnmatch.fnmatch(pat, g) for g in observed_globs):
                    continue
                yield Finding(
                    self.id,
                    pf.rel,
                    lineno,
                    f"declared histogram family {pat!r} in group {name} is "
                    "never observed anywhere — stale name or dead "
                    "instrumentation",
                )

        if metrics is not None:
            for name, (_, lineno, pf) in hist_groups.items():
                if name not in metrics.text:
                    yield Finding(
                        self.id,
                        pf.rel,
                        lineno,
                        f"histogram group {name} is not surfaced by "
                        f"{metrics.rel} — /metrics must export every group",
                    )


# ---------------------------------------------------------------------------
# wire-error-contract
# ---------------------------------------------------------------------------


@register
class WireErrorContractRule(Rule):
    id = "wire-error-contract"
    summary = "typed wire errors pin their HTTP mapping and keep the envelope"
    invariant = (
        "every direct KLLMsError subclass sets type and status_code in its "
        "class body (indirect subclasses inherit); every as_wire override "
        "calls super().as_wire() so the base error envelope survives"
    )
    subsystem = "types/wire.py (+ any module defining wire errors)"

    def check(self, project: Project) -> Iterable[Finding]:
        base = str(project.rule_config(self.id).get("base", "KLLMsError"))
        classes: Dict[str, Tuple[ProjectFile, ast.ClassDef]] = {}
        for pf in project.files:
            if pf.tree is None:
                continue
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.ClassDef):
                    classes.setdefault(node.name, (pf, node))

        if base not in classes:
            return

        # Transitive subclasses of the base, by last-segment base names.
        in_family: Set[str] = {base}
        changed = True
        while changed:
            changed = False
            for name, (_, node) in classes.items():
                if name in in_family:
                    continue
                for b in node.bases:
                    bd = dotted(b)
                    if bd and bd.rsplit(".", 1)[-1] in in_family:
                        in_family.add(name)
                        changed = True
                        break

        for name in sorted(in_family - {base}):
            pf, node = classes[name]
            direct = any(
                (dotted(b) or "").rsplit(".", 1)[-1] == base for b in node.bases
            )
            assigned: Set[str] = set()
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            assigned.add(t.id)
                elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    if stmt.value is not None:
                        assigned.add(stmt.target.id)
            if direct:
                missing = [a for a in ("type", "status_code") if a not in assigned]
                if missing:
                    yield Finding(
                        self.id,
                        pf.rel,
                        node.lineno,
                        f"{name} subclasses {base} directly but does not set "
                        f"{', '.join(missing)} in its class body — the wire "
                        "mapping would silently fall back to the base 500",
                    )
            for stmt in node.body:
                if (
                    isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name == "as_wire"
                ):
                    calls_super = any(
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "as_wire"
                        and isinstance(n.func.value, ast.Call)
                        and isinstance(n.func.value.func, ast.Name)
                        and n.func.value.func.id == "super"
                        for n in ast.walk(stmt)
                    )
                    if not calls_super:
                        yield Finding(
                            self.id,
                            pf.rel,
                            stmt.lineno,
                            f"{name}.as_wire does not call super().as_wire() "
                            "— overrides must extend the OpenAI error "
                            "envelope, not rebuild it",
                        )
