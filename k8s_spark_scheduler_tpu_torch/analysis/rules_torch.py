"""TK — the port's device contracts: hand kernels on the card, CUDA by
default, no JAX.

The reference package's JX family checks its JAX kernels' tracer
safety; this package has no tracer.  Its hot path is hand-written CUDA
kernels behind thin wrappers, and its contracts are different ones,
which until now only tests held:

- **TK001** — a hand-kernel launch inside a ``try`` whose handler does
  anything but re-raise.  That is a fallback lane: a kernel that fails
  to build or launch must fail loudly, never answer from the plain
  version (or nothing) while the caller believes the card decided.  A
  launch is a call through a library obtained from ``LIBRARY.load()``
  (``lib = LIBRARY.load(); lib.fifo_queue(...)``), the ``load()``
  itself, or a call to a function imported from a kernel binding module
  (a module named ``*_kernel``: ``ops/queue_kernel.py`` and its
  siblings).  A handler passes when its last statement is a ``raise``.
  The rule sees only launches written in the ``try`` body itself: a
  fallback one call up (``try: sess.native.solve(...)`` or
  ``binpacker.solve(...)`` with a handler that answers otherwise) is not
  flagged: the rule does not resolve calls across functions.
- **TK002** — a function whose ``device`` parameter has a default other
  than ``None``.  ``None`` means the card (``device.resolve_device``
  raises where there is none); any other default is an entry point that
  runs on the CPU unless the caller asks for the card.
- **TK003** — an import of ``jax``, ``jaxlib`` or
  ``k8s_spark_scheduler_tpu`` (those exact packages and their
  submodules, not ``k8s_spark_scheduler_tpu_torch``), by an ``import``
  statement or by ``importlib.import_module`` / ``__import__`` with a
  constant name.  The port copies what it needs; it never imports the
  reference or its framework.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .core import FileContext, Finding
from .rules_native import _attr_chain, is_library_load

CATEGORY = "device"
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")


def _finding(ctx: FileContext, rule: str, node: ast.AST, message: str, symbol: str) -> Finding:
    return Finding(
        rule=rule,
        category=CATEGORY,
        file=ctx.relpath,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=message,
        symbol=symbol,
    )


def _is_kernel_module(module: str) -> bool:
    return bool(module) and module.split(".")[-1].endswith("_kernel")


class _Launches:
    """What counts as a launch in one file."""

    def __init__(self, tree: ast.Module):
        # names bound to a function of a kernel module, and names bound to
        # a kernel module itself
        self.launchers: Set[str] = set()
        self.modules: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if _is_kernel_module(node.module or ""):
                    for alias in node.names:
                        self.launchers.add(alias.asname or alias.name)
                else:
                    for alias in node.names:
                        if alias.name.endswith("_kernel"):
                            self.modules.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_kernel_module(alias.name):
                        self.modules.add(alias.asname or alias.name.split(".")[0])

    def libraries(self, body: List[ast.stmt]) -> Set[str]:
        """Local names assigned from ``LIBRARY.load()`` in a function."""
        names: Set[str] = set()
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Assign) and is_library_load(node.value):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            names.add(target.id)
        return names

    def launch(self, call: ast.Call, libs: Set[str]) -> Optional[str]:
        if is_library_load(call):
            return ".".join(_attr_chain(call.func)) + "()"
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in self.launchers:
            return fn.id + "()"
        if isinstance(fn, ast.Attribute):
            chain = _attr_chain(fn)
            if len(chain) >= 2 and (chain[0] in libs or chain[0] in self.modules):
                return ".".join(chain) + "()"
            if is_library_load(fn.value):
                return ".".join(_attr_chain(fn.value.func)) + "()." + fn.attr + "()"
        return None


def _reraises(handler: ast.ExceptHandler) -> bool:
    return bool(handler.body) and isinstance(handler.body[-1], ast.Raise)


def _calls_outside_defs(stmts: List[ast.stmt]):
    """Every Call under ``stmts``, skipping nested function and class
    bodies (they run later, outside this try)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_tk001(ctx: FileContext, launches: _Launches) -> List[Finding]:
    findings: List[Finding] = []
    reported: Set[Tuple[int, int]] = set()  # a launch in nested fallback trys, once

    def visit(node: ast.AST, scope: List[str], libs: Set[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = scope + [node.name]
            libs = launches.libraries(node.body)
        elif isinstance(node, ast.ClassDef):
            scope = scope + [node.name]
        if isinstance(node, (ast.Try, ast.TryStar)) and node.handlers:
            fallback = [h for h in node.handlers if not _reraises(h)]
            if fallback:
                for call in _calls_outside_defs(node.body):
                    what = launches.launch(call, libs)
                    key = (call.lineno, call.col_offset)
                    if what is None or key in reported:
                        continue
                    reported.add(key)
                    findings.append(_finding(
                        ctx, "TK001", call,
                        f"hand-kernel launch {what} inside a try whose "
                        f"handler (line {fallback[0].lineno}) does not "
                        "re-raise: a failed build or launch must raise, "
                        "never fall back to another lane",
                        ".".join(scope),
                    ))
        for child in ast.iter_child_nodes(node):
            visit(child, scope, libs)

    visit(ctx.tree, [], set())
    return findings


def _check_tk002(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []

    def visit(node: ast.AST, scope: List[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = scope + [node.name]
            a = node.args
            positional = a.posonlyargs + a.args
            pairs = list(zip(positional[len(positional) - len(a.defaults):], a.defaults))
            pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
            for arg, default in pairs:
                if arg.arg != "device":
                    continue
                if isinstance(default, ast.Constant) and default.value is None:
                    continue
                findings.append(_finding(
                    ctx, "TK002", default,
                    f"{node.name}() defaults device to "
                    f"{ast.unparse(default)}: an entry point runs on the "
                    "card unless the caller asks for the CPU — default "
                    "to None and resolve it with device.resolve_device",
                    ".".join(scope),
                ))
        elif isinstance(node, ast.ClassDef):
            scope = scope + [node.name]
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    visit(ctx.tree, [])
    return findings


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN_IMPORTS)


def _check_tk003(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []

    def report(node: ast.AST, module: str, scope: List[str]) -> None:
        findings.append(_finding(
            ctx, "TK003", node,
            f"import of {module}: the port imports neither jax nor the "
            "reference package — keep a copy of what it needs",
            ".".join(scope),
        ))

    def visit(node: ast.AST, scope: List[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            scope = scope + [node.name]
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _forbidden(alias.name):
                    report(node, alias.name, scope)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            if _forbidden(node.module or ""):
                report(node, node.module, scope)
        elif isinstance(node, ast.Call) and node.args:
            fn = _attr_chain(node.func)
            first = node.args[0]
            if (
                fn in (["importlib", "import_module"], ["import_module"], ["__import__"])
                and isinstance(first, ast.Constant)
                and isinstance(first.value, str)
                and _forbidden(first.value)
            ):
                report(node, first.value, scope)
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    visit(ctx.tree, [])
    return findings


def check(ctx: FileContext) -> List[Finding]:
    findings = _check_tk001(ctx, _Launches(ctx.tree))
    findings.extend(_check_tk002(ctx))
    findings.extend(_check_tk003(ctx))
    return findings
