"""Policy-regression gate over the SLO scorecard; a copy of the
reference's ``tools/policy_regression.py`` on this package's
``lifecycle/`` and ``lab/`` (the same flags, reports and exit codes).

The chaos scenario is deterministic (same scenario + seed ⇒ byte-
identical event log), so its scorecard — objective outcomes and
lifecycle counts rendered by ``lifecycle/scorecard.py``, the SAME
schema a live server serves on ``GET /slo`` — is a pure function of
scheduler policy.  A committed baseline
(``tests/baselines/scorecard_chaos.json``) therefore turns any
behavioral policy change into a reviewable diff: CI re-runs the
scenario, recomputes both digests, and fails when they diverge,
printing the leaf-level paths that moved.

    python -m k8s_spark_scheduler_tpu_torch.sim --scenario examples/sim/chaos.json \
        --device cpu --out /tmp/sim --quiet
    python -m k8s_spark_scheduler_tpu_torch.tools.policy_regression \
        --current /tmp/sim/scorecard.json

Digests are recomputed from the documents (never trusted from the
files), so a hand-edited baseline digest cannot mask a drift.  An
INTENDED policy change is landed by refreshing the baseline in the
same PR: ``--update`` rewrites it from ``--current``, and the diff of
the committed baseline IS the review artifact.

The gate also runs in **matrix mode** over the policy lab's output
(``python -m k8s_spark_scheduler_tpu_torch.lab run``): ``--matrix-current``
compares every cell of a fresh matrix.json against the committed
multi-cell baseline (``tests/baselines/matrix_smoke.json``), so one
gate covers the whole policy surface — ordering × preemption ×
backfill — instead of the single chaos scenario.  Per-cell scorecard
digests AND the composite cell digests (``lab.engine.
compute_cell_digest``) are recomputed from the documents; drifted cells
print their leaf-level scorecard diffs.

    python -m k8s_spark_scheduler_tpu_torch.lab synth \
        --spec examples/lab/smoke_synth.json --out /tmp/t.jsonl
    python -m k8s_spark_scheduler_tpu_torch.lab run \
        --spec examples/lab/smoke_matrix.json --trace /tmp/t.jsonl --out /tmp/lab-smoke
    python -m k8s_spark_scheduler_tpu_torch.tools.policy_regression \
        --matrix-current /tmp/lab-smoke/matrix.json

The default baselines are found from the repo root (the directory that
holds this package).  Exit 0 = digests match; 1 = policy drift (or
schema mismatch, or a baseline cell missing); 2 = missing/invalid input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..lab.engine import compute_cell_digest
from ..lifecycle import scorecard_diff, scorecard_digest

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_COMMAND = "python -m k8s_spark_scheduler_tpu_torch.tools.policy_regression"

DEFAULT_BASELINE = os.path.join(_REPO, "tests", "baselines", "scorecard_chaos.json")
DEFAULT_MATRIX_BASELINE = os.path.join(
    _REPO, "tests", "baselines", "matrix_smoke.json"
)


def _load(path: str, label: str):
    if not os.path.exists(path):
        print(f"no {label} scorecard at {path}", file=sys.stderr)
        return None
    try:
        with open(path) as f:
            card = json.load(f)
    except ValueError as exc:
        print(f"{label} scorecard {path} is not valid JSON: {exc}", file=sys.stderr)
        return None
    if not isinstance(card, dict) or "schema" not in card:
        print(f"{label} scorecard {path} has no schema block", file=sys.stderr)
        return None
    return card


def _cell_digests(doc):
    """Recompute a cell's scorecard digest and composite digest from
    the document bodies (stored digests are never trusted)."""
    sc_digest = scorecard_digest(doc.get("scorecard", {}))
    cell_digest = compute_cell_digest(
        sc_digest, doc.get("eventsDigest", ""), doc.get("kpis", {})
    )
    return sc_digest, cell_digest


def _matrix_gate(args) -> int:
    current = _load(args.matrix_current, "current matrix")
    if current is None or not isinstance(current.get("cells"), list):
        if current is not None:
            print(
                f"current matrix {args.matrix_current} has no cells list",
                file=sys.stderr,
            )
        return 2

    if args.update:
        os.makedirs(os.path.dirname(args.matrix_baseline), exist_ok=True)
        with open(args.matrix_baseline, "w") as f:
            json.dump(current, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"matrix baseline updated: {args.matrix_baseline}")
        return 0

    baseline = _load(args.matrix_baseline, "baseline matrix")
    if baseline is None or not isinstance(baseline.get("cells"), list):
        if baseline is not None:
            print(
                f"baseline matrix {args.matrix_baseline} has no cells list",
                file=sys.stderr,
            )
        return 2

    schema_ok = current.get("schema") == baseline.get("schema")
    current_by_id = {c.get("cell"): c for c in current["cells"]}
    drifted = []
    missing = []
    for base_cell in baseline["cells"]:
        cell_id = base_cell.get("cell")
        cur_cell = current_by_id.get(cell_id)
        if cur_cell is None:
            missing.append(cell_id)
            continue
        base_sc, base_digest = _cell_digests(base_cell)
        cur_sc, cur_digest = _cell_digests(cur_cell)
        if base_digest != cur_digest:
            diffs = (
                scorecard_diff(base_cell["scorecard"], cur_cell["scorecard"])
                if base_sc != cur_sc
                else []
            )
            drifted.append((cell_id, base_digest, cur_digest, diffs))

    report = {
        "mode": "matrix",
        "current": os.path.basename(args.matrix_current),
        "baseline": os.path.basename(args.matrix_baseline),
        "schemaMatch": schema_ok,
        "cells": len(baseline["cells"]),
        "missingCells": missing,
        "driftedCells": [
            {
                "cell": cell_id,
                "baselineDigest": a,
                "currentDigest": b,
                "diffs": [
                    {"path": p, "baseline": x, "current": y} for p, x, y in diffs
                ],
            }
            for cell_id, a, b, diffs in drifted
        ],
        "pass": schema_ok and not drifted and not missing,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    if report["pass"]:
        print(
            f"policy-regression(matrix): PASS "
            f"{len(baseline['cells'])} cells byte-identical"
        )
        return 0
    if not schema_ok:
        print(
            f"policy-regression(matrix): FAIL schema mismatch "
            f"(baseline {baseline.get('schema')!r} vs current {current.get('schema')!r})",
            file=sys.stderr,
        )
    for cell_id in missing:
        print(
            f"policy-regression(matrix): FAIL cell {cell_id!r} missing from current",
            file=sys.stderr,
        )
    for cell_id, a, b, diffs in drifted:
        print(
            f"policy-regression(matrix): FAIL cell {cell_id!r} drift "
            f"(baseline {a} vs current {b})",
            file=sys.stderr,
        )
        for path, x, y in diffs:
            print(f"  {path}: {x!r} -> {y!r}", file=sys.stderr)
    print(
        "intended policy change? refresh the matrix baseline in this PR:\n"
        f"  {_COMMAND} --matrix-current {args.matrix_current} --update",
        file=sys.stderr,
    )
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=_COMMAND,
        description="scorecard policy-regression gate (sim vs committed baseline)"
    )
    parser.add_argument(
        "--current",
        default=None,
        help="scorecard.json from a fresh sim run (sim --out <dir>)",
    )
    parser.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help=f"committed baseline scorecard (default: {DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--matrix-current",
        default=None,
        help="matrix.json from a fresh lab run (lab run --out <dir>)",
    )
    parser.add_argument(
        "--matrix-baseline",
        default=DEFAULT_MATRIX_BASELINE,
        help=f"committed baseline matrix (default: {DEFAULT_MATRIX_BASELINE})",
    )
    parser.add_argument("--json", default=None, help="write the gate report here too")
    parser.add_argument(
        "--update",
        action="store_true",
        help="rewrite the baseline from the current document "
        "(landing an intended policy change)",
    )
    args = parser.parse_args(argv)

    if (args.current is None) == (args.matrix_current is None):
        parser.error("exactly one of --current / --matrix-current is required")
    if args.matrix_current is not None:
        return _matrix_gate(args)

    current = _load(args.current, "current")
    if current is None:
        return 2

    if args.update:
        os.makedirs(os.path.dirname(args.baseline), exist_ok=True)
        with open(args.baseline, "w") as f:
            json.dump(current, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"baseline updated: {args.baseline} digest={scorecard_digest(current)}")
        return 0

    baseline = _load(args.baseline, "baseline")
    if baseline is None:
        return 2

    current_digest = scorecard_digest(current)
    baseline_digest = scorecard_digest(baseline)
    schema_ok = current.get("schema") == baseline.get("schema")
    diffs = scorecard_diff(baseline, current) if current_digest != baseline_digest else []

    report = {
        "current": os.path.basename(args.current),
        "baseline": os.path.basename(args.baseline),
        "currentDigest": current_digest,
        "baselineDigest": baseline_digest,
        "schemaMatch": schema_ok,
        "diffs": [
            {"path": path, "baseline": a, "current": b} for path, a, b in diffs
        ],
        "pass": schema_ok and current_digest == baseline_digest,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    if report["pass"]:
        print(f"policy-regression: PASS digest={current_digest}")
        return 0
    if not schema_ok:
        print(
            f"policy-regression: FAIL schema mismatch "
            f"(baseline {baseline.get('schema')} vs current {current.get('schema')})",
            file=sys.stderr,
        )
    print(
        f"policy-regression: FAIL digest drift "
        f"(baseline {baseline_digest} vs current {current_digest})",
        file=sys.stderr,
    )
    for path, a, b in diffs:
        print(f"  {path}: {a!r} -> {b!r}", file=sys.stderr)
    print(
        "intended policy change? refresh the baseline in this PR:\n"
        f"  {_COMMAND} --current {args.current} --update",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
