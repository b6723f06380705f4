"""Policy-lab CLI.

    python -m k8s_spark_scheduler_tpu_torch.lab synth  --spec synth.json --out trace.jsonl
    python -m k8s_spark_scheduler_tpu_torch.lab run    --spec matrix.json --out out/ --workers 4
    python -m k8s_spark_scheduler_tpu_torch.lab report --matrix out/matrix.json
    python -m k8s_spark_scheduler_tpu_torch.lab diff   --matrix out/matrix.json --cells A B

``synth`` generates a seed-reproducible production-shaped trace;
``run`` expands and executes the matrix (optionally across worker
processes, optionally cross-process digest-verified); ``report`` folds
cell scorecards into rankings; ``diff`` prints leaf-level scorecard
differences between two cells.  See the reference's runbook
(docs/operations.md, "Running the policy lab"): the verbs and flags are
the same.  The lab is host-only and takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..sim.manifest import write_run_manifest
from ..sim.workload import dump_trace
from .report import build_matrix_report, diff_cells, render_report_text
from .runner import run_matrix
from .spec import MatrixSpec
from .synth import SynthSpec, synthesize


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _cmd_synth(args: argparse.Namespace) -> int:
    raw = _load_json(args.spec) if args.spec else {}
    if args.seed is not None:
        raw["seed"] = args.seed
    if args.arrivals is not None:
        raw["arrivals"] = args.arrivals
    spec = SynthSpec.from_dict(raw)
    apps = synthesize(spec)
    dump_trace(apps, args.out)
    print(f"wrote {len(apps)} apps -> {args.out} (seed={spec.seed})")
    return 0


def _cmd_run(args: argparse.Namespace) -> int:
    raw = _load_json(args.spec)
    if args.trace:
        raw["trace"] = args.trace
    spec = MatrixSpec.from_dict(raw)
    matrix = run_matrix(
        spec, workers=args.workers, out_dir=args.out, verify=args.verify
    )
    report = build_matrix_report(matrix)
    if args.out:
        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        # refresh the manifest so report.json is hashed alongside
        # matrix.json (the manifest covers every sibling artifact)
        write_run_manifest(
            args.out,
            kind="lab-matrix",
            digests={
                "spec": matrix["specDigest"],
                "trace": matrix["traceDigest"],
                "report": report["digest"],
            },
            extra={"name": matrix["name"], "cells": [c["cell"] for c in matrix["cells"]]},
        )
    print(render_report_text(report))
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    matrix = _load_json(args.matrix)
    report = build_matrix_report(matrix)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_report_text(report))
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    matrix = _load_json(args.matrix)
    cell_a, cell_b = args.cells
    diffs = diff_cells(matrix, cell_a, cell_b)
    if not diffs:
        print(f"{cell_a} and {cell_b} have identical scorecard bodies")
        return 0
    print(f"{len(diffs)} scorecard leaves differ ({cell_a} vs {cell_b}):")
    for path, a, b in diffs:
        print(f"  {path}: {a!r} -> {b!r}")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_spark_scheduler_tpu_torch.lab",
        description="trace synthesis + policy-matrix evaluation lab",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("synth", help="generate a production-shaped trace")
    p.add_argument("--spec", help="synth spec JSON (defaults apply if omitted)")
    p.add_argument("--out", required=True, help="output trace JSONL path")
    p.add_argument("--seed", type=int, help="override spec seed")
    p.add_argument("--arrivals", type=int, help="override spec arrival count")
    p.set_defaults(func=_cmd_synth)

    p = sub.add_parser("run", help="execute a policy matrix")
    p.add_argument("--spec", required=True, help="matrix spec JSON")
    p.add_argument("--trace", help="override the spec's trace path")
    p.add_argument("--out", help="artifact directory (cells/, matrix.json, report.json)")
    p.add_argument("--workers", type=int, default=0, help="worker processes (0 = in-process)")
    p.add_argument(
        "--verify",
        type=int,
        default=0,
        help="re-run first N cells in-process and compare digests",
    )
    p.set_defaults(func=_cmd_run)

    p = sub.add_parser("report", help="fold a matrix document into rankings")
    p.add_argument("--matrix", required=True, help="matrix.json from a run")
    p.add_argument("--out", help="write report JSON here")
    p.add_argument("--json", action="store_true", help="print JSON instead of a table")
    p.set_defaults(func=_cmd_report)

    p = sub.add_parser("diff", help="leaf-diff two cells' scorecards")
    p.add_argument("--matrix", required=True, help="matrix.json from a run")
    p.add_argument("--cells", nargs=2, required=True, metavar=("A", "B"))
    p.set_defaults(func=_cmd_diff)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
