"""schedlint output: human text and machine JSON.

The JSON schema is **stable** — CI diffs findings between runs, so keys
are never renamed, only added (bump ``schema_version`` when they are).

.. code-block:: json

    {
      "schema_version": 1,
      "tool": "schedlint",
      "strict": false,
      "findings": [
        {"rule": "TS001", "category": "determinism", "file": "tracing/spans.py",
         "line": 118, "col": 8, "message": "...", "symbol": "Span.__enter__"}
      ],
      "counts": {"total": 1, "by_rule": {"TS001": 1}, "by_category": {"determinism": 1}},
      "suppressed": [
        {"rule": "TS002", "file": "util/locktime.py", "line": 40, "col": 8,
         "category": "determinism", "message": "...", "symbol": "...",
         "suppressed_via": "allowlist", "why": "monotonic deadline arithmetic"}
      ]
    }

``suppressed`` (added, schema unchanged: keys are only ever added) lists
every finding that an allowlist entry or pragma silenced, with the
justification.  CI diffs it against a committed baseline so a *new*
suppression — someone pragma-ing their way past a fresh finding — fails
review even though the findings list stays empty.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .core import Finding, SuppressedFinding

SCHEMA_VERSION = 1


def render_text(findings: List[Finding]) -> str:
    if not findings:
        return "schedlint: clean (0 findings)\n"
    lines = []
    for f in findings:
        where = f"{f.file}:{f.line}:{f.col}"
        sym = f" [{f.symbol}]" if f.symbol else ""
        lines.append(f"{where}: {f.rule} {f.message}{sym}")
    by_rule = _count_by(findings, "rule")
    summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    lines.append(f"schedlint: {len(findings)} finding(s) ({summary})")
    return "\n".join(lines) + "\n"


def render_json(
    findings: List[Finding],
    strict: bool = False,
    suppressed: Optional[List[SuppressedFinding]] = None,
) -> str:
    doc = {
        "schema_version": SCHEMA_VERSION,
        "tool": "schedlint",
        "strict": strict,
        "findings": [f.to_dict() for f in findings],
        "counts": {
            "total": len(findings),
            "by_rule": _count_by(findings, "rule"),
            "by_category": _count_by(findings, "category"),
        },
        "suppressed": [s.to_dict() for s in (suppressed or [])],
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


def _count_by(findings: List[Finding], attr: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        key = getattr(f, attr)
        counts[key] = counts.get(key, 0) + 1
    return counts
