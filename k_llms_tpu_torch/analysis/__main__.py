"""``python -m k_llms_tpu_torch.analysis`` — run the kllms-check lint suite.

Exit codes: 0 = clean (no unsuppressed findings), 1 = findings, 2 = usage
error. ``--check`` is the CI entry point (quiet on success); the default mode
prints every finding, suppressed ones included with their reasons.

Machine outputs:

- ``--sarif`` emits SARIF 2.1.0 so findings render as native annotations in
  any CI that understands the format (GitHub code scanning, GitLab, ...).
- ``--baseline FILE`` suppresses findings whose fingerprint is recorded in
  FILE — a dirty tree passes while any NEW finding still fails — and
  ``--write-baseline FILE`` records the current findings. Fingerprints hash
  (rule, file, message) but NOT the line number, so unrelated code motion
  does not churn the baseline.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from .framework import (
    RULES,
    Finding,
    _ensure_rules_loaded,
    load_project,
    run_rules,
    unsuppressed,
)

SARIF_SCHEMA_URI = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def fingerprint(f: Finding) -> str:
    """Stable id for baseline matching: line-insensitive on purpose (code
    motion above a finding must not invalidate a recorded baseline)."""
    key = f"{f.rule}\0{f.file}\0{f.message}"
    return hashlib.sha256(key.encode("utf-8")).hexdigest()


def sarif_document(
    root: Path, findings: List[Finding], rule_ids: Optional[List[str]]
) -> Dict[str, Any]:
    """SARIF 2.1.0: one run, the rule metadata as the tool driver's rule
    descriptors, one result per finding with a file/line region."""
    _ensure_rules_loaded()
    ids = sorted(rule_ids or RULES)
    rules_meta = [
        {
            "id": rid,
            "shortDescription": {"text": RULES[rid]().summary},
            "fullDescription": {"text": RULES[rid]().invariant},
            "properties": {"subsystem": RULES[rid]().subsystem},
        }
        for rid in ids
    ]
    index = {rid: i for i, rid in enumerate(ids)}
    results: List[Dict[str, Any]] = []
    for f in findings:
        result: Dict[str, Any] = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.file,
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": max(1, int(f.line))},
                    }
                }
            ],
            "partialFingerprints": {"kllmsFingerprint/v1": fingerprint(f)},
        }
        if f.rule in index:
            result["ruleIndex"] = index[f.rule]
        if f.suppressed:
            result["suppressions"] = [
                {"kind": "inSource", "justification": f.suppress_reason}
            ]
        results.append(result)
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {"driver": {"name": "kllms-check", "rules": rules_meta}},
                "originalUriBaseIds": {
                    "SRCROOT": {"uri": Path(root).resolve().as_uri() + "/"}
                },
                "results": results,
            }
        ],
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k_llms_tpu_torch.analysis",
        description="kllms-check: project lint enforcing the serving stack's invariants",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        type=Path,
        help="files or directories to lint (default: the configured package)",
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=None,
        help="repo root holding the package (default: auto-detect from this package)",
    )
    parser.add_argument(
        "--rule",
        action="append",
        dest="rules",
        metavar="ID",
        help="run only this rule id (repeatable)",
    )
    parser.add_argument(
        "--check",
        action="store_true",
        help="CI mode: print only unsuppressed findings, exit 1 if any",
    )
    parser.add_argument("--json", action="store_true", help="JSON output")
    parser.add_argument(
        "--sarif",
        action="store_true",
        help="SARIF 2.1.0 output (CI code-scanning annotations)",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=None,
        metavar="FILE",
        help="suppress findings fingerprinted in FILE; fail only on new ones",
    )
    parser.add_argument(
        "--write-baseline",
        type=Path,
        default=None,
        metavar="FILE",
        help="record the current unsuppressed findings into FILE and exit 0",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list registered rules and exit"
    )
    args = parser.parse_args(argv)
    if args.sarif and args.json:
        parser.error("--sarif and --json are mutually exclusive")

    root = args.root
    if root is None:
        # .../k_llms_tpu_torch/analysis/__main__.py -> repo root two levels above
        # the package directory.
        root = Path(__file__).resolve().parent.parent.parent
    if not Path(root).is_dir():
        parser.error(f"--root {root} is not a directory")

    if args.list_rules:
        _ensure_rules_loaded()
        for rid in sorted(RULES):
            rule = RULES[rid]()
            print(f"{rid}: {rule.summary}")
        return 0

    try:
        project = load_project(root, paths=args.paths or None)
        findings = run_rules(project, rule_ids=args.rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline is not None:
        doc = {
            "version": 1,
            "tool": "kllms-check",
            "fingerprints": {
                fingerprint(f): f"{f.rule} {f.file}:{f.line}"
                for f in unsuppressed(findings)
            },
        }
        args.write_baseline.write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n", encoding="utf-8"
        )
        print(
            f"kllms-check: wrote {len(doc['fingerprints'])} fingerprint(s) "
            f"to {args.write_baseline}"
        )
        return 0

    if args.baseline is not None:
        try:
            known = set(
                json.loads(args.baseline.read_text(encoding="utf-8"))[
                    "fingerprints"
                ]
            )
        except (OSError, ValueError, KeyError, TypeError) as e:
            parser.error(f"--baseline {args.baseline}: {e}")
        for f in findings:
            if not f.suppressed and fingerprint(f) in known:
                f.suppressed = True
                f.suppress_reason = f"baseline: {args.baseline.name}"

    visible = unsuppressed(findings) if args.check else findings
    failing = unsuppressed(findings)

    if args.sarif:
        print(json.dumps(sarif_document(root, visible, args.rules), indent=2))
    elif args.json:
        print(
            json.dumps(
                {
                    "root": str(root),
                    "files": len(project.files),
                    "rules": args.rules or sorted(RULES),
                    "findings": [f.as_dict() for f in visible],
                    "ok": not failing,
                },
                indent=2,
            )
        )
    else:
        for f in visible:
            print(f.format())
        tag = "unsuppressed " if not args.check else ""
        print(
            f"kllms-check: {len(failing)} {tag}finding(s) across "
            f"{len(project.files)} file(s)"
        )
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
