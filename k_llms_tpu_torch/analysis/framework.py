"""kllms-check: AST lint framework for the serving stack's own invariants.

The serving stack is a heavily concurrent system whose correctness
rests on conventions — lock acquisition order, no host syncs inside decode
loops, every failpoint registered and tested, every counter declared and
surfaced, every wire error carrying its HTTP mapping. Conventions rot; this
framework turns each one into a named, fixture-tested rule that runs over the
package AST in milliseconds (``python -m k_llms_tpu_torch.analysis --check``) and
gates tier-1 via ``tests/test_torch_analysis.py``.

Vocabulary:

- A :class:`Rule` inspects a :class:`Project` (parsed files + repo context
  like README/tests) and yields :class:`Finding`\\ s with ``file:line``.
- Findings are suppressed inline with ``# kllms: ignore[rule-id] — reason``
  (same line, or a comment-only line directly above). ``ignore[*]`` silences
  every rule for that line. Unsuppressed findings fail the check.
- Configuration lives inside the package, in ``analysis/kllms-check.toml``
  (enabled rules, excluded paths, per-rule options), so the lint's settings
  ship with the code they describe. Python 3.10 has no ``tomllib``, so a
  minimal TOML subset parser backs it up.
- The repo context a rule reads is ``README.md`` and this package's own
  tests, ``tests/test_torch_*.py``: a failpoint or counter counts as tested
  only when one of them names it.

The module imports only the stdlib — ``python -m k_llms_tpu_torch.analysis`` must
stay fast enough (<10 s, enforced by the duration-budget guard) to run inside
the tier-1 suite on every PR.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Type

__all__ = [
    "Finding",
    "Project",
    "ProjectFile",
    "Rule",
    "RULES",
    "register",
    "load_config",
    "load_project",
    "run_rules",
]


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    """One rule violation, anchored at ``file:line`` (repo-relative path)."""

    rule: str
    file: str
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}{tag}"

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*kllms:\s*ignore\[([^\]]*)\]\s*(.*)$")


def _scan_suppressions(text: str) -> Dict[int, Dict[str, str]]:
    """Map 1-based line number -> {rule_id_or_'*': reason}.

    A suppression on a code line covers that line; a suppression on a
    comment-only line covers the next line as well (so long messages fit)."""
    out: Dict[int, Dict[str, str]] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
        reason = m.group(2).strip().lstrip("—-– ").strip()
        if not rules:
            continue
        targets = [lineno]
        if line.strip().startswith("#"):
            targets.append(lineno + 1)
        for target in targets:
            slot = out.setdefault(target, {})
            for rule in rules:
                slot[rule] = reason
    return out


# ---------------------------------------------------------------------------
# project model
# ---------------------------------------------------------------------------


@dataclass
class ProjectFile:
    """One parsed source file (AST + raw text + suppression map)."""

    path: Path
    rel: str  # repo-relative posix path
    text: str
    tree: Optional[ast.AST]
    parse_error: Optional[str] = None
    suppressions: Dict[int, Dict[str, str]] = field(default_factory=dict)

    @property
    def module_name(self) -> str:
        return Path(self.rel).stem


@dataclass
class Project:
    """Everything a rule may inspect: the package files under analysis plus
    repo context (README text, test sources) when available. Rules must
    degrade gracefully when context is absent — fixture runs hand them a bare
    file list."""

    root: Path
    files: List[ProjectFile]
    config: Dict[str, Any] = field(default_factory=dict)
    readme: Optional[str] = None
    test_sources: Dict[str, str] = field(default_factory=dict)  # rel -> text

    def rule_config(self, rule_id: str) -> Dict[str, Any]:
        cfg = self.config.get(rule_id)
        return dict(cfg) if isinstance(cfg, dict) else {}

    def find_file(self, rel_suffix: str) -> Optional[ProjectFile]:
        for f in self.files:
            if f.rel.endswith(rel_suffix):
                return f
        return None


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


class Rule:
    """Base class: subclass, set ``id``/``summary``/``invariant``/``subsystem``,
    implement :meth:`check`, decorate with :func:`register`."""

    id: str = ""
    summary: str = ""
    invariant: str = ""
    subsystem: str = ""

    def check(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError


RULES: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.id:
        raise ValueError(f"rule class {cls.__name__} has no id")
    if cls.id in RULES:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    RULES[cls.id] = cls
    return cls


def _ensure_rules_loaded() -> None:
    # Imported lazily so framework consumers (e.g. lockcheck) never pay for
    # rule modules, and so rules can import framework without a cycle.
    from . import rules as _rules  # noqa: F401


# ---------------------------------------------------------------------------
# minimal TOML (Python 3.10 has no tomllib; we only need the subset that
# the lint configuration file uses: sections, scalars, arrays, inline tables)
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    out = []
    quote: Optional[str] = None
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in ("'", '"'):
            quote = ch
            out.append(ch)
            continue
        if ch == "#":
            break
        out.append(ch)
    return "".join(out)


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in ("'", '"'):
        return tok[1:-1]
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _split_top_level(body: str) -> List[str]:
    """Split on commas not nested in quotes/brackets/braces."""
    parts: List[str] = []
    depth = 0
    quote: Optional[str] = None
    cur: List[str] = []
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in ("'", '"'):
            quote = ch
            cur.append(ch)
        elif ch in "[{":
            depth += 1
            cur.append(ch)
        elif ch in "]}":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return parts


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("["):
        return [_parse_value(p) for p in _split_top_level(tok[1:-1]) if p.strip()]
    if tok.startswith("{"):
        table: Dict[str, Any] = {}
        for item in _split_top_level(tok[1:-1]):
            if "=" not in item:
                continue
            k, _, v = item.partition("=")
            table[_parse_scalar(k)] = _parse_value(v)
        return table
    return _parse_scalar(tok)


def _balanced(tok: str) -> bool:
    depth = 0
    quote: Optional[str] = None
    for ch in tok:
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in ("'", '"'):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth <= 0


def parse_toml(text: str) -> Dict[str, Any]:
    """Parse the TOML subset used by the lint's configuration file into
    nested dicts. Prefers the stdlib parser when present (3.11+)."""
    try:  # pragma: no cover - 3.11+ only
        import tomllib

        return tomllib.loads(text)
    except ModuleNotFoundError:
        pass
    doc: Dict[str, Any] = {}
    section = doc
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            section = doc
            for part in line.strip("[]").split("."):
                section = section.setdefault(part.strip().strip('"'), {})
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip()
        # Multiline arrays: keep consuming until brackets balance.
        while not _balanced(value) and i < len(lines):
            value += " " + _strip_comment(lines[i]).strip()
            i += 1
        section[_parse_scalar(key)] = _parse_value(value)
    return doc


# ---------------------------------------------------------------------------
# config + project loading
# ---------------------------------------------------------------------------

DEFAULT_CONFIG: Dict[str, Any] = {
    "package": "k_llms_tpu_torch",
    "exclude": [],
    "rules": [],  # empty = all registered rules
}


#: The package's own lint configuration, relative to the repo root.
CONFIG_FILE = Path(DEFAULT_CONFIG["package"]) / "analysis" / "kllms-check.toml"

#: The tests that count as the package's own (the context rules read).
TEST_GLOB = "test_torch_*.py"


def load_config(root: Path) -> Dict[str, Any]:
    """``<root>/k_llms_tpu_torch/analysis/kllms-check.toml`` merged over
    defaults; a root without that file (a fixture tree) yields the
    defaults."""
    cfg = dict(DEFAULT_CONFIG)
    path = Path(root) / CONFIG_FILE
    if path.is_file():
        doc = parse_toml(path.read_text(encoding="utf-8"))
        if isinstance(doc, dict):
            cfg.update(doc)
    return cfg


def _parse_file(path: Path, root: Path) -> ProjectFile:
    text = path.read_text(encoding="utf-8")
    try:
        rel = path.resolve().relative_to(Path(root).resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    tree: Optional[ast.AST] = None
    err: Optional[str] = None
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError as e:
        err = f"{e.msg} (line {e.lineno})"
    return ProjectFile(
        path=path,
        rel=rel,
        text=text,
        tree=tree,
        parse_error=err,
        suppressions=_scan_suppressions(text),
    )


def load_project(
    root: Path,
    paths: Optional[Sequence[Path]] = None,
    config: Optional[Dict[str, Any]] = None,
    with_context: bool = True,
) -> Project:
    """Build a :class:`Project`. Default file set is every ``*.py`` under the
    configured package dir; explicit ``paths`` (files or directories) override
    it. ``with_context`` loads README.md and the package's test sources
    (``tests/test_torch_*.py``) for the cross-surface rules
    (failpoint-coverage, counter-hygiene)."""
    root = Path(root)
    cfg = dict(config) if config is not None else load_config(root)
    exclude = [str(p) for p in cfg.get("exclude", [])]

    candidates: List[Path] = []
    if paths:
        for p in paths:
            p = Path(p)
            if p.is_dir():
                candidates.extend(sorted(p.rglob("*.py")))
            else:
                candidates.append(p)
    else:
        pkg = root / str(cfg.get("package", DEFAULT_CONFIG["package"]))
        candidates = sorted(pkg.rglob("*.py"))

    files: List[ProjectFile] = []
    for path in candidates:
        pf = _parse_file(path, root)
        if any(fnmatch.fnmatch(pf.rel, pat) for pat in exclude):
            continue
        files.append(pf)

    readme: Optional[str] = None
    test_sources: Dict[str, str] = {}
    if with_context:
        readme_path = root / "README.md"
        if readme_path.is_file():
            readme = readme_path.read_text(encoding="utf-8")
        tests_dir = root / "tests"
        if tests_dir.is_dir():
            for tp in sorted(tests_dir.rglob(TEST_GLOB)):
                rel = tp.relative_to(root).as_posix()
                test_sources[rel] = tp.read_text(encoding="utf-8")
    return Project(
        root=root, files=files, config=cfg, readme=readme, test_sources=test_sources
    )


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def enabled_rules(project: Project) -> List[str]:
    _ensure_rules_loaded()
    chosen = [str(r) for r in project.config.get("rules", [])] or sorted(RULES)
    unknown = [r for r in chosen if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule id(s) {unknown}; known: {sorted(RULES)}")
    return chosen


def _apply_suppressions(project: Project, findings: List[Finding]) -> None:
    by_rel = {f.rel: f for f in project.files}
    for finding in findings:
        pf = by_rel.get(finding.file)
        if pf is None:
            continue
        slot = pf.suppressions.get(finding.line, {})
        for key in (finding.rule, "*"):
            if key in slot:
                finding.suppressed = True
                finding.suppress_reason = slot[key]
                break


def run_rules(
    project: Project, rule_ids: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the selected (default: configured/enabled) rules and return all
    findings, suppressed ones included, sorted by location. Unparseable files
    surface as synthetic ``parse-error`` findings so a syntax error can never
    silently shrink the analysis surface."""
    _ensure_rules_loaded()
    ids = list(rule_ids) if rule_ids else enabled_rules(project)
    unknown = [r for r in ids if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule id(s) {unknown}; known: {sorted(RULES)}")
    findings: List[Finding] = []
    for pf in project.files:
        if pf.parse_error is not None:
            findings.append(
                Finding(
                    rule="parse-error",
                    file=pf.rel,
                    line=1,
                    message=f"file does not parse: {pf.parse_error}",
                )
            )
    for rid in ids:
        rule = RULES[rid]()
        findings.extend(rule.check(project))
    _apply_suppressions(project, findings)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return findings


def unsuppressed(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]
