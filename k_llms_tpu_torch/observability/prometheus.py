"""Prometheus text exposition (format 0.0.4) renderer for ``/metrics``.

Proper exposition hygiene, not a bare text dump: every metric family gets
``# HELP``/``# TYPE`` lines, label values are escaped per the format spec
(backslash, double-quote, newline), and histograms render the full
``_bucket``/``_sum``/``_count`` triple with cumulative counts and the
mandatory ``+Inf`` bucket. The serving app builds family dicts with the
helpers here and renders once per scrape — no client library dependency.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

FamilyDict = Dict[str, Any]


def escape_label_value(value: Any) -> str:
    """Label-value escaping per the 0.0.4 text format: backslash first, then
    double-quote and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    """HELP-line escaping: only backslash and newline are special."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(value: Any) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def format_bound(bound: float) -> str:
    """A bucket bound as Prometheus expects it: trimmed decimal, no
    float-repr noise (0.0025 stays "0.0025")."""
    text = format(float(bound), ".12g")
    return text


def _labels_text(labels: Mapping[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def counter_family(
    name: str, help_text: str, samples: Iterable[Tuple[Mapping[str, Any], Any]]
) -> FamilyDict:
    return {
        "name": name,
        "type": "counter",
        "help": help_text,
        "samples": [("", dict(labels), value) for labels, value in samples],
    }


def gauge_family(name: str, help_text: str, value: Any) -> FamilyDict:
    return {
        "name": name,
        "type": "gauge",
        "help": help_text,
        "samples": [("", {}, value)],
    }


def histogram_family(name: str, help_text: str, snap: Mapping[str, Any]) -> FamilyDict:
    """A histogram family from a ``LatencyHistograms.snapshot()`` entry:
    cumulative ``_bucket`` samples (``+Inf`` = count), ``_sum``, ``_count``."""
    samples: List[Tuple[str, Dict[str, Any], Any]] = []
    for bound, cumulative in snap["buckets"]:
        samples.append(("_bucket", {"le": format_bound(bound)}, cumulative))
    samples.append(("_bucket", {"le": "+Inf"}, snap["count"]))
    samples.append(("_sum", {}, snap["sum"]))
    samples.append(("_count", {}, snap["count"]))
    return {
        "name": name,
        "type": "histogram",
        "help": help_text,
        "samples": samples,
    }


def labeled_histogram_family(
    name: str,
    help_text: str,
    snaps: Mapping[str, Mapping[str, Any]],
    label: str = "tenant",
) -> FamilyDict:
    """One histogram family carrying a label dimension: each entry of
    ``snaps`` (label value → ``LatencyHistograms.snapshot()`` entry) emits a
    full ``_bucket``/``_sum``/``_count`` triple with ``label`` merged into
    every sample. Prometheus requires one HELP/TYPE per family, so per-tenant
    histograms must share a family rather than minting one per tenant; label
    values are escaped at render time (hostile tenant ids included)."""
    samples: List[Tuple[str, Dict[str, Any], Any]] = []
    for value in sorted(snaps):
        snap = snaps[value]
        for bound, cumulative in snap["buckets"]:
            samples.append(
                ("_bucket", {label: value, "le": format_bound(bound)}, cumulative)
            )
        samples.append(("_bucket", {label: value, "le": "+Inf"}, snap["count"]))
        samples.append(("_sum", {label: value}, snap["sum"]))
        samples.append(("_count", {label: value}, snap["count"]))
    return {
        "name": name,
        "type": "histogram",
        "help": help_text,
        "samples": samples,
    }


def render_families(families: Iterable[FamilyDict]) -> str:
    """The full exposition body. Families render in the order given; each
    emits HELP and TYPE even when it currently has no samples, so the scrape
    surface (and the scrape-validity test) is stable."""
    lines: List[str] = []
    for fam in families:
        lines.append(f"# HELP {fam['name']} {escape_help(fam['help'])}")
        lines.append(f"# TYPE {fam['name']} {fam['type']}")
        for suffix, labels, value in fam["samples"]:
            lines.append(
                f"{fam['name']}{suffix}{_labels_text(labels)} {format_value(value)}"
            )
    return "\n".join(lines) + "\n"
