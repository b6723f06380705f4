"""Diff the port's schedlint *suppressions* against a committed baseline.

The strict run over the package reports zero findings — but that is
only meaningful if nobody pragma'd or allowlisted their way past a new
finding.  The analyzer reports every silenced finding on the JSON
``suppressed`` channel; this tool pins that set, for the
``k8s_spark_scheduler_tpu_torch`` package, to
``tests/baselines/torch_schedlint_suppressions.json`` (found from the
repo root, the directory that holds the package), so a change that adds
a suppression has to regenerate the baseline, which makes the new
justification show up in review instead of vanishing into a "clean"
run.

Usage::

    python -m k8s_spark_scheduler_tpu_torch.tools.schedlint_diff --diff-baseline   # the gate
    python -m k8s_spark_scheduler_tpu_torch.tools.schedlint_diff --write-baseline  # after review

Suppressions are keyed by (rule, file, symbol, via) and compared by
count — line numbers drift with unrelated edits and must not churn the
baseline.  Exit codes: 0 no new suppressions, 1 new suppressions (or
missing baseline in diff mode), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

from ..analysis import AnalysisConfig, analyze_paths_detailed, package_root

REPO_ROOT = os.path.dirname(package_root())

DEFAULT_BASELINE = os.path.join(
    REPO_ROOT, "tests", "baselines", "torch_schedlint_suppressions.json"
)

Key = Tuple[str, str, str, str]


def current_suppressions() -> List[dict]:
    config = AnalysisConfig(strict=True)
    root = package_root()
    result = analyze_paths_detailed([root], config=config, root=root)
    return [s.to_dict() for s in result.suppressed]


def key_of(entry: dict) -> Key:
    return (
        entry.get("rule", ""),
        entry.get("file", ""),
        entry.get("symbol") or "",
        entry.get("suppressed_via", ""),
    )


def count_by_key(entries: List[dict]) -> Dict[Key, int]:
    counts: Dict[Key, int] = {}
    for e in entries:
        k = key_of(e)
        counts[k] = counts.get(k, 0) + 1
    return counts


def write_baseline(path: str) -> int:
    entries = current_suppressions()
    doc = {
        "comment": (
            "Reviewed schedlint suppressions of the PyTorch port "
            "(allowlist entries and justified pragmas). Regenerate with "
            "`python -m k8s_spark_scheduler_tpu_torch.tools.schedlint_diff "
            "--write-baseline` and have the diff reviewed — every new "
            "entry is a finding someone chose to silence."
        ),
        "suppressions": [
            {"rule": r, "file": f, "symbol": s, "via": v, "count": n}
            for (r, f, s, v), n in sorted(count_by_key(entries).items())
        ],
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(
        f"schedlint-diff: wrote {len(doc['suppressions'])} suppression "
        f"key(s) ({len(entries)} site(s)) to {os.path.relpath(path, REPO_ROOT)}"
    )
    return 0


def diff_baseline(path: str) -> int:
    if not os.path.exists(path):
        print(
            f"schedlint-diff: baseline {os.path.relpath(path, REPO_ROOT)} "
            "is missing; run --write-baseline and commit it",
            file=sys.stderr,
        )
        return 1
    with open(path) as fh:
        doc = json.load(fh)
    baseline: Dict[Key, int] = {
        (e["rule"], e["file"], e["symbol"], e["via"]): e["count"]
        for e in doc.get("suppressions", [])
    }
    current = count_by_key(current_suppressions())

    new: List[str] = []
    for key, n in sorted(current.items()):
        allowed = baseline.get(key, 0)
        if n > allowed:
            rule, f, symbol, via = key
            where = f"{f}" + (f" [{symbol}]" if symbol else "")
            new.append(
                f"  {rule} via {via} at {where}: {n} site(s), baseline {allowed}"
            )
    gone = [k for k in baseline if k not in current]

    if new:
        print("schedlint-diff: NEW suppressions not in the baseline:")
        print("\n".join(new))
        print(
            "A new suppression silences a finding. If it is justified, "
            "regenerate the baseline (--write-baseline) so the "
            "justification is reviewed; otherwise fix the finding."
        )
        return 1
    msg = f"schedlint-diff: no new suppressions ({len(current)} key(s) tracked)"
    if gone:
        msg += (
            f"; {len(gone)} baseline key(s) no longer present — consider "
            "regenerating to shrink the baseline"
        )
    print(msg)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_spark_scheduler_tpu_torch.tools.schedlint_diff",
        description=__doc__.split("\n\n")[0],
    )
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument(
        "--diff-baseline",
        nargs="?",
        const=DEFAULT_BASELINE,
        metavar="FILE",
        help="fail (exit 1) if the current run has suppressions missing "
        "from the baseline",
    )
    mode.add_argument(
        "--write-baseline",
        nargs="?",
        const=DEFAULT_BASELINE,
        metavar="FILE",
        help="regenerate the baseline from the current run",
    )
    args = parser.parse_args(argv)
    if args.write_baseline:
        return write_baseline(args.write_baseline)
    return diff_baseline(args.diff_baseline)


if __name__ == "__main__":
    sys.exit(main())
