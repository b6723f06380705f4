"""Prometheus text exposition (format version 0.0.4) for the tagged
registry.

The JSON snapshot at ``GET /metrics`` stays the debugging surface; this
module renders the same registry contents in the exposition format a
Prometheus scraper (or ``promtool check metrics``) accepts:

- metric names sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots and
  slashes in the reference's dotted names become underscores);
- tags become labels with proper value escaping (backslash, quote,
  newline);
- counters → ``counter``, gauges → ``gauge``, histograms → ``summary``
  with ``quantile`` labels plus ``_count``/``_sum`` series and an
  exact-tracked ``_max`` gauge.

Content type: ``text/plain; version=0.0.4; charset=utf-8``.

OpenMetrics flavour (``?format=openmetrics`` ONLY — never
Accept-negotiated): the same families, terminated with ``# EOF``, with
each histogram's ``_count`` line carrying a ``trace_id`` exemplar of
the most recent in-trace observation — the link from a latency series
back to the PR 1 span tree (``GET /traces`` /
``/debug/schedule/<pod>``).  Plain Prometheus text output is
byte-identical to before.  (Strict OpenMetrics attaches exemplars to
counters and histogram buckets and requires ``_total`` counter
samples; this flavour keeps the plain exposition's series names and
carries the exemplar on the counter-like summary ``_count``, so a
strict OpenMetrics parser — e.g. Prometheus with ``scrape_protocols:
[OpenMetricsText1.0.0]`` — would reject it and fail the whole scrape.
That is why Accept headers always get the plain 0.0.4 text —
server/http.py ``_metrics_format``.)
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")

TagSet = Tuple[Tuple[str, str], ...]


def sanitize_metric_name(name: str) -> str:
    out = _NAME_BAD_CHARS.sub("_", name)
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def sanitize_label_name(name: str) -> str:
    out = _LABEL_BAD_CHARS.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(tags: Iterable[Tuple[str, str]]) -> str:
    parts = [
        f'{sanitize_label_name(k)}="{escape_label_value(v)}"' for k, v in tags
    ]
    return "{" + ",".join(parts) + "}" if parts else ""


def _group(
    entries: Dict[Tuple[str, TagSet], object]
) -> Dict[str, List[Tuple[TagSet, object]]]:
    """Group (name, tags) keys by sanitized name, preserving insertion
    order, so the TYPE header is emitted once per family."""
    grouped: Dict[str, List[Tuple[TagSet, object]]] = {}
    for (name, tags), value in entries.items():
        grouped.setdefault(sanitize_metric_name(name), []).append((tags, value))
    return grouped


def _exemplar_suffix(snap: dict, openmetrics: bool) -> str:
    """OpenMetrics exemplar (`` # {trace_id="…"} value``) for a
    histogram's ``_count`` line; empty in plain mode or when no in-trace
    observation has been recorded."""
    if not openmetrics:
        return ""
    ex = snap.get("exemplar")
    if not ex:
        return ""
    trace_id, value = ex
    return (
        f' # {{trace_id="{escape_label_value(trace_id)}"}} {_fmt_value(value)}'
    )


def render(registry, openmetrics: bool = False) -> str:
    """Render a MetricsRegistry into Prometheus text format (or the
    OpenMetrics flavour with exemplars + ``# EOF`` when asked)."""
    collected = registry.collect()
    lines: List[str] = []

    for family, series in sorted(_group(collected["counters"]).items()):
        lines.append(f"# TYPE {family} counter")
        for tags, value in series:
            lines.append(f"{family}{_label_str(tags)} {_fmt_value(value)}")

    for family, series in sorted(_group(collected["gauges"]).items()):
        lines.append(f"# TYPE {family} gauge")
        for tags, value in series:
            lines.append(f"{family}{_label_str(tags)} {_fmt_value(value)}")

    for family, series in sorted(_group(collected["histograms"]).items()):
        lines.append(f"# TYPE {family} summary")
        max_lines: List[str] = []
        for tags, snap in series:
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                q_tags = tuple(tags) + (("quantile", q),)
                lines.append(
                    f"{family}{_label_str(q_tags)} {_fmt_value(snap[key])}"
                )
            lines.append(f"{family}_sum{_label_str(tags)} {_fmt_value(snap['sum'])}")
            lines.append(
                f"{family}_count{_label_str(tags)} {_fmt_value(snap['count'])}"
                f"{_exemplar_suffix(snap, openmetrics)}"
            )
            max_lines.append(f"{family}_max{_label_str(tags)} {_fmt_value(snap['max'])}")
        # exact stream max isn't part of the summary type — expose it as
        # a sibling gauge family
        lines.append(f"# TYPE {family}_max gauge")
        lines.extend(max_lines)

    if openmetrics:
        # the terminator is mandatory even for an empty exposition — a
        # scrape before the first recorded metric must still parse
        lines.append("# EOF")
    return "\n".join(lines) + "\n" if lines else ""
