"""Matrix comparison layer: fold per-cell scorecards into one report;
a copy of the reference package's ``lab/report.py``.

The report is what a reviewer reads to judge a policy change: every
cell's KPI row (packing efficiency, p50/p95/p99 wait, eviction waste,
DRF fairness gap, SLO burn verdicts), rankings per dimension, and a
canonical digest over the deterministic body so the report itself can
be baselined.  Cell-vs-cell comparisons reuse
``lifecycle/scorecard.py::scorecard_diff`` — the SAME leaf-walk the
policy-regression gate prints, so a lab diff and a CI gate failure
read identically.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Tuple

from ..lifecycle.scorecard import scorecard_diff

REPORT_SCHEMA = "tpu-gang-scheduler-matrix-report"
REPORT_VERSION = 1

# ranking dimensions: (name, kpi extractor, better-direction)
_DIMENSIONS = (
    ("packing", lambda k: k["packing_efficiency"]["max"], "desc"),
    ("wait_p50", lambda k: k["wait_seconds"]["p50"], "asc"),
    ("wait_p99", lambda k: k["wait_seconds"]["p99"], "asc"),
    ("eviction_waste", lambda k: k["eviction_waste_seconds"]["total"], "asc"),
    ("fairness_gap", lambda k: k["fairness_gap"]["p95"], "asc"),
)


def _slo_verdict(scorecard: Dict) -> Dict[str, str]:
    return {
        name: obj.get("state", "ok")
        for name, obj in sorted(scorecard.get("objectives", {}).items())
    }


def _worst_state(verdicts: Dict[str, str]) -> str:
    rank = {"ok": 0, "ticket": 1, "page": 2}
    worst = "ok"
    for state in verdicts.values():
        if rank.get(state, 0) > rank.get(worst, 0):
            worst = state
    return worst


def build_matrix_report(matrix: Dict) -> Dict:
    """Fold a matrix results document (``runner.run_matrix`` output)
    into the comparison report."""
    cells = matrix.get("cells", [])
    rows = []
    for doc in cells:
        kpis = doc["kpis"]
        verdicts = _slo_verdict(doc["scorecard"])
        rows.append(
            {
                "cell": doc["cell"],
                "axes": doc["axes"],
                "digest": doc["digest"],
                "scorecardDigest": doc["scorecard"]["digest"],
                "packing": kpis["packing_efficiency"]["max"],
                "wait_p50": kpis["wait_seconds"]["p50"],
                "wait_p95": kpis["wait_seconds"]["p95"],
                "wait_p99": kpis["wait_seconds"]["p99"],
                "eviction_waste": kpis["eviction_waste_seconds"]["total"],
                "evictions": kpis["eviction_waste_seconds"]["events"],
                "fairness_gap": kpis["fairness_gap"]["p95"],
                "completed": kpis["throughput"]["completed"],
                "pending_at_end": kpis["throughput"]["pending_at_end"],
                "slo": verdicts,
                "sloWorst": _worst_state(verdicts),
            }
        )

    rankings: Dict[str, List[str]] = {}
    for name, extract, direction in _DIMENSIONS:
        order = sorted(
            cells,
            key=lambda d: (
                -extract(d["kpis"]) if direction == "desc" else extract(d["kpis"]),
                d["cell"],
            ),
        )
        rankings[name] = [d["cell"] for d in order]

    report: Dict = {
        "schema": REPORT_SCHEMA,
        "version": REPORT_VERSION,
        "name": matrix.get("name", "matrix"),
        "specDigest": matrix.get("specDigest", ""),
        "traceDigest": matrix.get("traceDigest", ""),
        "arrivals": matrix.get("arrivals", 0),
        "cellCount": len(rows),
        "cells": rows,
        "rankings": rankings,
        "leaders": {name: order[0] if order else None for name, order in rankings.items()},
    }
    report["digest"] = _report_digest(report)
    return report


def _report_digest(report: Dict) -> str:
    body = {k: v for k, v in report.items() if k != "digest"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def diff_cells(
    matrix: Dict, cell_a: str, cell_b: str
) -> List[Tuple[str, object, object]]:
    """Leaf-level scorecard differences between two cells of a matrix
    document (``scorecard_diff`` semantics: (path, a, b) tuples)."""
    a = _find_cell(matrix, cell_a)
    b = _find_cell(matrix, cell_b)
    return scorecard_diff(a["scorecard"], b["scorecard"])


def _find_cell(matrix: Dict, cell_id: str) -> Dict:
    for doc in matrix.get("cells", []):
        if doc.get("cell") == cell_id:
            return doc
    known = [d.get("cell") for d in matrix.get("cells", [])]
    raise KeyError(f"cell {cell_id!r} not in matrix (cells: {known})")


def render_report_text(report: Dict, limit: Optional[int] = None) -> str:
    """Human-readable table for the CLI (kept deliberately plain)."""
    lines = [
        f"matrix report: {report['name']}  cells={report['cellCount']}  "
        f"arrivals={report['arrivals']}",
        f"spec={report['specDigest'][:12]} trace={report['traceDigest'][:12]}",
        "",
        f"{'cell':<40} {'pack':>7} {'p50':>8} {'p99':>9} {'waste':>10} "
        f"{'fair':>7} {'slo':>7}",
    ]
    rows = report["cells"][:limit] if limit else report["cells"]
    for row in rows:
        lines.append(
            f"{row['cell']:<40} {row['packing']:>7.3f} {row['wait_p50']:>8.1f} "
            f"{row['wait_p99']:>9.1f} {row['eviction_waste']:>10.1f} "
            f"{row['fairness_gap']:>7.3f} {row['sloWorst']:>7}"
        )
    lines.append("")
    for name, leader in sorted(report["leaders"].items()):
        lines.append(f"best {name}: {leader}")
    return "\n".join(lines)
