"""CLI: ``python -m k8s_spark_scheduler_tpu_torch.analysis [--strict] [paths]``.

Exit codes: 0 clean, 1 findings, 2 usage/config error (including a
``--select`` token that matches no known rule family — a typo must not
silently select nothing and report "clean").
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .core import (
    AnalysisConfig,
    analyze_paths_detailed,
    load_allowlist,
    package_root,
)
from .reporters import render_json, render_text

# The rule registry, grouped by family prefix.  ``--select`` tokens are
# validated against this: every token must be a prefix of at least one
# rule id listed here, so adding a rule means adding it to its family
# (test_cli_list_rules_covers_all_families enforces the catalogue stays
# in sync with the implemented rule set).
RULE_FAMILIES: Tuple[Tuple[str, str, Tuple[Tuple[str, str], ...]], ...] = (
    (
        "TS",
        "determinism / time",
        (
            ("TS001", "direct time.time() — semantic timestamps must use timesource.now()"),
            ("TS002", "direct time.monotonic() — infra-only (allowlist or justified pragma)"),
            ("TS003", "datetime.now()/utcnow()/today() bypasses the timesource"),
        ),
    ),
    (
        "DT",
        "determinism / randomness",
        (
            ("DT001", "unseeded randomness (global random.* or random.Random())"),
            ("DT002", "legacy NumPy global RNG (numpy.random.*)"),
        ),
    ),
    (
        "LK",
        "locking",
        (
            ("LK001", "mutation of a @guarded_by attribute outside 'with self.<lock>:'"),
            ("LK002", "bare .acquire() without try/finally release"),
            ("LK003", "@guarded_by declaration whose lock attr is never assigned in __init__"),
            ("LK004", "threading.Lock attribute + mutating methods but no @guarded_by"),
        ),
    ),
    (
        "NA",
        "device boundary (the device session and the kernel libraries)",
        (
            ("NA001", "device-session call while holding a @guarded_by lock (not on the GIL-safe list)"),
            ("NA002", "raw KernelLibrary CDLL referenced outside the kernel binding modules"),
        ),
    ),
    (
        "TK",
        "device contracts (hand kernels on the card, CUDA by default)",
        (
            ("TK001", "hand-kernel launch inside a try whose handler does not re-raise (a fallback)"),
            ("TK002", "device parameter whose default is not None (an entry point off the card)"),
            ("TK003", "import of jax, jaxlib or the reference package"),
        ),
    ),
    (
        "PC",
        "protocol (flow-sensitive typestate over the CFG)",
        (
            ("PC001", "CommitGate ticket can leak: a path reaches an exit without retire"),
            ("PC002", "double retire: a retire may run on an already-retired ticket"),
            ("PC003", "kube-mutating call not dominated by a FencedWriter.check from its entry point"),
            ("PC004", "journal intent acked on a path where the execute may not have happened"),
            ("PC005", "manually opened span/lock not closed on every path"),
            ("PC006", "phase boundary crossed without re-arming the deadline check"),
        ),
    ),
    (
        "PR",
        "pragma hygiene",
        (
            ("PR000", "file does not parse"),
            ("PR001", "(--strict) pragma without a '-- justification'"),
        ),
    ),
)

ALL_RULE_IDS: Tuple[str, ...] = tuple(
    rule_id for _, _, rules in RULE_FAMILIES for rule_id, _ in rules
)


def render_rule_catalogue() -> str:
    lines = ["schedlint rules (see the analysis package's docstring for how to run them):"]
    for family, title, rules in RULE_FAMILIES:
        lines.append("")
        lines.append(f"{family}  {title}")
        for rule_id, desc in rules:
            lines.append(f"  {rule_id}  {desc}")
    return "\n".join(lines) + "\n"


def validate_select(tokens: Sequence[str]) -> List[str]:
    """Return the select tokens that match no known rule id prefix."""
    return [t for t in tokens if not any(r.startswith(t) for r in ALL_RULE_IDS)]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_spark_scheduler_tpu_torch.analysis",
        description="schedlint: determinism, lock-discipline, protocol "
        "and device-contract analysis for the gang scheduler's PyTorch port",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to analyze (default: the installed package)",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="require a justification on every pragma (PR001)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt",
    )
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule-id prefixes to run (e.g. TS,DT or LK001); "
        "unknown prefixes are an error (exit 2), not an empty selection",
    )
    parser.add_argument(
        "--allowlist", default=None, metavar="FILE",
        help="JSON allowlist merged over the built-in one",
    )
    parser.add_argument(
        "--no-default-allowlist", action="store_true",
        help="ignore the built-in allowlist (audit mode)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue grouped by family",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        print(render_rule_catalogue(), end="")
        return 0

    select: Optional[Tuple[str, ...]] = None
    if args.select:
        select = tuple(s.strip() for s in args.select.split(",") if s.strip())
        unknown = validate_select(select)
        if unknown:
            known = ", ".join(family for family, _, _ in RULE_FAMILIES)
            print(
                "schedlint: unknown rule selector(s): "
                f"{', '.join(unknown)} (known families: {known}; "
                "see --list-rules)",
                file=sys.stderr,
            )
            return 2

    extra_allowlist = {}
    if args.allowlist:
        try:
            extra_allowlist = load_allowlist(args.allowlist)
        except (OSError, ValueError) as exc:
            print(f"schedlint: bad allowlist: {exc}", file=sys.stderr)
            return 2

    config = AnalysisConfig(
        select=select,
        allowlist=extra_allowlist,
        use_default_allowlist=not args.no_default_allowlist,
        strict=args.strict,
    )
    root = package_root()
    paths = args.paths or [root]
    result = analyze_paths_detailed(paths, config=config, root=root)

    if args.fmt == "json":
        sys.stdout.write(
            render_json(
                result.findings, strict=args.strict, suppressed=result.suppressed
            )
        )
    else:
        sys.stdout.write(render_text(result.findings))
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
