"""TS/DT — determinism rules: clock reads and random streams.

The discrete-event simulator (``sim/``) replays hours of cluster life in
milliseconds by swapping ``timesource.now`` for a virtual clock.  That
only works if *every semantic clock read* goes through the timesource:
a direct ``time.time()`` stamps a virtual-era object with a real epoch
(breaking FIFO ordering and digest stability), and an unseeded RNG
makes two runs of the same scenario diverge.

Rules:

- **TS001** — direct ``time.time()`` call.  Semantic timestamps must go
  through ``timesource.now()``; latency measurement should use
  ``time.perf_counter()`` (allowed).
- **TS002** — direct ``time.monotonic()`` call.  Legitimate only for
  *infrastructure* deadlines that must keep binding real time while the
  sim clock is frozen — those sites live on the allowlist or carry a
  justified pragma.
- **TS003** — ``datetime.now()`` / ``datetime.utcnow()`` /
  ``date.today()``: wall-clock reads that bypass the timesource
  entirely.
- **DT001** — unseeded randomness: module-level ``random.<fn>()``
  calls (the shared global RNG) or ``random.Random()`` constructed
  without a seed.  Every random stream in the scheduler must be
  explicitly seeded so scenario replays are byte-identical.
- **DT002** — legacy NumPy global RNG (``numpy.random.<fn>()`` /
  ``np.random.seed``): global mutable RNG state is unseedable per
  stream; use ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import ast
from typing import List

from .core import FileContext, Finding

_DATETIME_WALL_FNS = {"now", "utcnow", "today"}
_RANDOM_GLOBAL_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "seed", "getrandbits", "random_bytes",
}


def _finding(ctx: FileContext, rule: str, node: ast.AST, message: str, symbol: str) -> Finding:
    return Finding(
        rule=rule,
        category="determinism",
        file=ctx.relpath,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=message,
        symbol=symbol,
    )


class _TimeVisitor(ast.NodeVisitor):
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        # names bound to the time module in this file ("import time",
        # "import time as _time")
        self.time_aliases = set()
        self.datetime_aliases = set()     # "import datetime [as d]"
        self.datetime_class_names = set() # "from datetime import datetime [as dt]"
        self.random_aliases = set()
        self.numpy_random_aliases = set() # "from numpy import random as npr"
        self.numpy_aliases = set()

    # -- imports --------------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            bound = alias.asname or alias.name.split(".")[0]
            if alias.name == "time":
                self.time_aliases.add(bound)
            elif alias.name == "datetime":
                self.datetime_aliases.add(bound)
            elif alias.name == "random":
                self.random_aliases.add(bound)
            elif alias.name in ("numpy", "numpy.random"):
                self.numpy_aliases.add(bound)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "datetime":
            for alias in node.names:
                if alias.name in ("datetime", "date"):
                    self.datetime_class_names.add(alias.asname or alias.name)
        elif node.module == "time":
            for alias in node.names:
                bound = alias.asname or alias.name
                if alias.name == "time":
                    # "from time import time" — calls look like bare time()
                    self.time_aliases.add(f"bare:{bound}")
                elif alias.name == "monotonic":
                    self.time_aliases.add(f"bare-mono:{bound}")
        elif node.module == "numpy":
            for alias in node.names:
                if alias.name == "random":
                    self.numpy_random_aliases.add(alias.asname or alias.name)
        elif node.module == "random":
            for alias in node.names:
                if alias.name in _RANDOM_GLOBAL_FNS:
                    self.random_aliases.add(f"bare:{alias.asname or alias.name}")

    # -- scopes ---------------------------------------------------------------

    def _visit_scoped(self, node, name: str) -> None:
        self._scope.append(name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_FunctionDef(self, node):  # noqa: N802 (ast API)
        self._visit_scoped(node, node.name)

    def visit_AsyncFunctionDef(self, node):  # noqa: N802
        self._visit_scoped(node, node.name)

    def visit_ClassDef(self, node):  # noqa: N802
        self._visit_scoped(node, node.name)

    def _symbol(self) -> str:
        return ".".join(self._scope)

    # -- calls ----------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            base, attr = fn.value.id, fn.attr
            if base in self.time_aliases:
                if attr == "time":
                    self.findings.append(_finding(
                        self.ctx, "TS001", node,
                        "direct time.time() — semantic timestamps must use "
                        "timesource.now() (sim runs swap in a virtual clock)",
                        self._symbol(),
                    ))
                elif attr == "monotonic":
                    self.findings.append(_finding(
                        self.ctx, "TS002", node,
                        "direct time.monotonic() — infra-only; allowlist the "
                        "module or pragma with a justification",
                        self._symbol(),
                    ))
            elif base in self.datetime_class_names and attr in _DATETIME_WALL_FNS:
                self.findings.append(_finding(
                    self.ctx, "TS003", node,
                    f"datetime wall-clock read {base}.{attr}() bypasses the "
                    "timesource",
                    self._symbol(),
                ))
            elif base in self.random_aliases:
                if attr in _RANDOM_GLOBAL_FNS:
                    self.findings.append(_finding(
                        self.ctx, "DT001", node,
                        f"global-RNG call random.{attr}() — use an explicitly "
                        "seeded random.Random(seed) stream",
                        self._symbol(),
                    ))
                elif attr == "Random" and not node.args and not node.keywords:
                    self.findings.append(_finding(
                        self.ctx, "DT001", node,
                        "random.Random() constructed without a seed",
                        self._symbol(),
                    ))
            elif base in self.numpy_random_aliases and attr in (
                _RANDOM_GLOBAL_FNS | {"rand", "randn", "permutation"}
            ):
                self.findings.append(_finding(
                    self.ctx, "DT002", node,
                    f"legacy NumPy global RNG numpy.random.{attr}() — use "
                    "numpy.random.default_rng(seed)",
                    self._symbol(),
                ))
        elif isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Attribute):
            # datetime.datetime.now() / np.random.rand() shapes
            inner = fn.value
            if isinstance(inner.value, ast.Name):
                if (
                    inner.value.id in self.datetime_aliases
                    and inner.attr in ("datetime", "date")
                    and fn.attr in _DATETIME_WALL_FNS
                ):
                    self.findings.append(_finding(
                        self.ctx, "TS003", node,
                        f"datetime wall-clock read "
                        f"{inner.value.id}.{inner.attr}.{fn.attr}() bypasses "
                        "the timesource",
                        self._symbol(),
                    ))
                elif (
                    inner.value.id in self.numpy_aliases
                    and inner.attr == "random"
                    and fn.attr in (_RANDOM_GLOBAL_FNS | {"rand", "randn", "permutation"})
                ):
                    self.findings.append(_finding(
                        self.ctx, "DT002", node,
                        f"legacy NumPy global RNG "
                        f"{inner.value.id}.random.{fn.attr}() — use "
                        "numpy.random.default_rng(seed)",
                        self._symbol(),
                    ))
        elif isinstance(fn, ast.Name):
            for alias in self.time_aliases:
                if alias == f"bare:{fn.id}":
                    self.findings.append(_finding(
                        self.ctx, "TS001", node,
                        "direct time() call (from-imported) — use "
                        "timesource.now()",
                        self._symbol(),
                    ))
                elif alias == f"bare-mono:{fn.id}":
                    self.findings.append(_finding(
                        self.ctx, "TS002", node,
                        "direct monotonic() call (from-imported) — infra-only",
                        self._symbol(),
                    ))
            for alias in self.random_aliases:
                if alias == f"bare:{fn.id}":
                    self.findings.append(_finding(
                        self.ctx, "DT001", node,
                        f"global-RNG call {fn.id}() (from-imported) — use a "
                        "seeded random.Random(seed) stream",
                        self._symbol(),
                    ))
        self.generic_visit(node)


def check(ctx: FileContext) -> List[Finding]:
    visitor = _TimeVisitor(ctx)
    visitor.visit(ctx.tree)
    return visitor.findings
