"""schedlint core: findings, pragmas, allowlists, and the analysis driver.

A *finding* is one rule violation at one source location.  Suppression
is layered:

1. **inline pragma** — ``# schedlint: disable=TS002 -- justification``
   on the offending line (or alone on the line directly above it).
   Multiple rules separate with commas; ``disable=all`` suppresses every
   rule on that line.  In ``--strict`` mode a pragma *must* carry a
   justification after ``--``; a bare pragma is itself a finding
   (``PR001``), so nothing is ever silenced without a recorded reason.
2. **per-rule allowlist** — a mapping of rule id → package-relative
   path prefixes where the rule does not apply (e.g. ``TS002`` in
   ``testing/``: harness deadlines intentionally read the real
   monotonic clock).  The built-in allowlist is
   :data:`DEFAULT_ALLOWLIST`; ``--allowlist file.json`` merges a
   user-supplied one on top, and each entry carries a ``why`` string so
   the exemption is as justified as a pragma.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PACKAGE_NAME = "k8s_spark_scheduler_tpu_torch"

_PRAGMA_RE = re.compile(
    r"#\s*schedlint:\s*disable=(?P<rules>[A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(?P<why>.*\S))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    rule: str
    category: str        # determinism | locking | native-boundary | device | protocol | pragma
    file: str            # package-relative, forward slashes
    line: int
    col: int
    message: str
    symbol: str = ""     # enclosing function/class, when known

    def sort_key(self):
        return (self.file, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "category": self.category,
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
        }


@dataclass
class Pragma:
    line: int            # line the pragma suppresses
    rules: Tuple[str, ...]
    why: Optional[str]
    pragma_line: int     # line the comment physically sits on

    def covers(self, rule: str) -> bool:
        return "all" in self.rules or rule in self.rules


# Rule-id → list of {"path": <prefix>, "why": <reason>}.  Paths are
# package-relative prefixes (a file matches when it equals the prefix or
# lives under it).  Keep every entry justified — this list is reviewed
# with the rule catalogue in this package's docstring.  The entries are
# the reference package's, less its TPU probe (it has no file here); a
# JSON allowlist loads the same in both packages.
DEFAULT_ALLOWLIST: Dict[str, List[dict]] = {
    "TS001": [
        {"path": "timesource.py", "why": "the timesource IS the wall-clock abstraction"},
        {"path": "sim/clock.py", "why": "the virtual clock replaces the timesource in sims"},
    ],
    "TS002": [
        {"path": "testing/", "why": "harness waits bound REAL time; a frozen virtual clock must never make them infinite"},
        {"path": "resilience/deadline.py", "why": "request deadlines bound wall latency for a live HTTP caller"},
        {"path": "resilience/gate.py", "why": "shed-recently window is an operator-facing wall-clock signal"},
        {"path": "kube/restclient.py", "why": "idle-connection reconnect tracks real socket age"},
        {"path": "kube/ratelimit.py", "why": "token-bucket refill meters real API-server wall time"},
        {"path": "ha/crashmatrix.py", "why": "matrix cells run live servers with wall-clock lease TTLs; waits must bound real time"},
        {"path": "tracing/", "why": "latency measurement wants real durations even in sims"},
    ],
    "DT001": [],
    "LK002": [],
}


def load_allowlist(path: str) -> Dict[str, List[dict]]:
    """Load a user allowlist JSON file: ``{"RULE": [{"path":..,"why":..},..]}``.
    Entries missing ``why`` are rejected — exemptions carry reasons."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: allowlist must be a JSON object keyed by rule id")
    out: Dict[str, List[dict]] = {}
    for rule, entries in data.items():
        if not isinstance(entries, list):
            raise ValueError(f"{path}: allowlist[{rule!r}] must be a list")
        for e in entries:
            if not isinstance(e, dict) or "path" not in e:
                raise ValueError(f"{path}: allowlist[{rule!r}] entries need a 'path'")
            if not str(e.get("why", "")).strip():
                raise ValueError(
                    f"{path}: allowlist[{rule!r}] entry for {e['path']!r} "
                    f"needs a 'why' justification"
                )
        out[rule] = list(entries)
    return out


def merge_allowlists(*lists: Dict[str, List[dict]]) -> Dict[str, List[dict]]:
    merged: Dict[str, List[dict]] = {}
    for al in lists:
        for rule, entries in al.items():
            merged.setdefault(rule, []).extend(entries)
    return merged


def allowlisted(allowlist: Dict[str, List[dict]], rule: str, relpath: str) -> bool:
    for entry in allowlist.get(rule, ()):
        prefix = entry["path"]
        if relpath == prefix or relpath.startswith(prefix.rstrip("/") + "/") or (
            prefix.endswith("/") and relpath.startswith(prefix)
        ):
            return True
    return False


@dataclass
class AnalysisConfig:
    select: Optional[Sequence[str]] = None      # rule-id prefixes, e.g. ("TS", "LK001")
    allowlist: Dict[str, List[dict]] = field(default_factory=dict)
    use_default_allowlist: bool = True
    strict: bool = False                        # pragmas must carry justifications

    def effective_allowlist(self) -> Dict[str, List[dict]]:
        if self.use_default_allowlist:
            return merge_allowlists(DEFAULT_ALLOWLIST, self.allowlist)
        return dict(self.allowlist)

    def rule_selected(self, rule: str) -> bool:
        if not self.select:
            return True
        return any(rule.startswith(prefix) for prefix in self.select)


def extract_pragmas(source: str) -> List[Pragma]:
    """Pragmas by suppressed line.  A pragma trailing code suppresses
    its own line; a pragma alone on a line suppresses the next line."""
    pragmas: List[Pragma] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        why = m.group("why")
        own_line = text[: m.start()].strip() != ""
        pragmas.append(
            Pragma(
                line=lineno if own_line else lineno + 1,
                rules=rules,
                why=why.strip() if why else None,
                pragma_line=lineno,
            )
        )
    return pragmas


class FileContext:
    """Everything the rule visitors need about one source file."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.pragmas = extract_pragmas(source)

    def pragma_for(self, rule: str, line: int) -> Optional[Pragma]:
        for p in self.pragmas:
            if p.line == line and p.covers(rule):
                return p
        return None


def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class SuppressedFinding:
    """A finding that a pragma or allowlist entry silenced — kept so
    tooling (``tools/schedlint_diff.py``) can tell pre-existing
    justified suppressions apart from *new* ones."""

    finding: Finding
    via: str             # "pragma" | "allowlist"
    why: str

    def to_dict(self) -> dict:
        d = self.finding.to_dict()
        d["suppressed_via"] = self.via
        d["why"] = self.why
        return d


@dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: List[SuppressedFinding]


def analyze_paths_detailed(
    paths: Sequence[str],
    config: Optional[AnalysisConfig] = None,
    root: Optional[str] = None,
) -> AnalysisResult:
    """Analyze the given files/directories.  ``root`` anchors the
    package-relative paths used by pragmas/allowlists (defaults to the
    installed package directory).

    Two passes: the per-file rule modules run on each file as it is
    parsed, then the protocol rules (:mod:`.rules_protocol`) run once
    over the whole file set — PC003's fence-dominance is
    interprocedural, so it needs every function in scope at once."""
    from . import rules_locks, rules_native, rules_protocol, rules_time, rules_torch

    config = config or AnalysisConfig()
    root = os.path.abspath(root or package_root())
    allowlist = config.effective_allowlist()

    files: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            files.extend(_iter_py_files(p))
        else:
            files.append(p)

    findings: List[Finding] = []
    suppressed: List[SuppressedFinding] = []
    contexts: List[FileContext] = []
    raw: List[Finding] = []
    for path in files:
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            findings.append(
                Finding(
                    rule="PR000",
                    category="pragma",
                    file=relpath,
                    line=exc.lineno or 1,
                    col=exc.offset or 0,
                    message=f"file does not parse: {exc.msg}",
                )
            )
            continue
        ctx = FileContext(relpath, source, tree)
        contexts.append(ctx)
        raw.extend(rules_time.check(ctx))
        raw.extend(rules_locks.check(ctx))
        raw.extend(rules_torch.check(ctx))
        raw.extend(rules_native.check(ctx))
        raw.extend(rules_protocol.check(ctx))

        if config.strict:
            # every pragma in the file — used or not — must carry a
            # justification: nothing gets silenced without a reason
            for pragma in ctx.pragmas:
                if not pragma.why:
                    findings.append(
                        Finding(
                            rule="PR001",
                            category="pragma",
                            file=relpath,
                            line=pragma.pragma_line,
                            col=0,
                            message=(
                                "pragma suppresses "
                                + ",".join(pragma.rules)
                                + " without a justification "
                                "(append: -- <one-line reason>)"
                            ),
                        )
                    )

    # package-wide pass (interprocedural rules)
    raw.extend(rules_protocol.check_package(contexts))

    ctx_by_relpath = {c.relpath: c for c in contexts}
    for finding in raw:
        if not config.rule_selected(finding.rule):
            continue
        if allowlisted(allowlist, finding.rule, finding.file):
            for entry in allowlist.get(finding.rule, ()):
                prefix = entry["path"]
                if finding.file == prefix or finding.file.startswith(
                    prefix.rstrip("/") + "/"
                ) or (prefix.endswith("/") and finding.file.startswith(prefix)):
                    suppressed.append(
                        SuppressedFinding(finding, "allowlist", str(entry.get("why", "")))
                    )
                    break
            continue
        ctx = ctx_by_relpath.get(finding.file)
        pragma = ctx.pragma_for(finding.rule, finding.line) if ctx else None
        if pragma is not None:
            suppressed.append(
                SuppressedFinding(finding, "pragma", pragma.why or "")
            )
            continue
        findings.append(finding)

    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=lambda s: s.finding.sort_key())
    return AnalysisResult(findings=findings, suppressed=suppressed)


def analyze_paths(
    paths: Sequence[str],
    config: Optional[AnalysisConfig] = None,
    root: Optional[str] = None,
) -> List[Finding]:
    """Backward-compatible wrapper: just the surviving findings."""
    return analyze_paths_detailed(paths, config=config, root=root).findings


def analyze_package(config: Optional[AnalysisConfig] = None) -> List[Finding]:
    """Analyze the whole installed ``k8s_spark_scheduler_tpu_torch`` package."""
    root = package_root()
    return analyze_paths([root], config=config, root=root)
