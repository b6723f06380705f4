"""LK — lock-discipline rules over ``@guarded_by`` declarations.

Many threads touch the scheduler's shared caches (async write-back
workers, journal replay, the admission gate, informer callbacks, the
observatories).  The locking convention is simple —
one lock per component, every mutation inside ``with self._lock:`` —
but nothing enforced it.  These rules read the
:func:`~.guarded.guarded_by` declarations and verify the convention
*lexically*; the runtime lockset detector (:mod:`.racecheck`) covers
the paths the AST cannot see.

Rules:

- **LK001** — a method of a ``@guarded_by``-decorated class mutates a
  declared attribute (assignment, augmented assignment, subscript
  write/delete, or a known mutating method call such as ``.append`` /
  ``.pop`` / ``.update``) outside a lexical ``with self.<lock>:`` block.
  ``__init__`` is exempt (construction happens-before publication).
  Helper methods that run with the lock already held by the caller
  carry a justified pragma.
- **LK002** — statement-level ``<lock>.acquire()`` with no enclosing or
  immediately-following ``try/finally`` that calls ``.release()``: an
  exception between acquire and release leaks the lock forever.  Prefer
  ``with lock:``.
- **LK003** — a ``@guarded_by`` declaration whose lock attribute is
  never assigned in ``__init__``: the declaration is dead and the rule
  family silently stops protecting the class.
- **LK004** — a class assigns a ``threading.Lock``/``RLock`` attribute
  in ``__init__`` and has mutating methods, but declares no
  ``@guarded_by``: the lock exists, yet neither the LK001 lexical check
  nor the runtime race detectors can see what it guards.  Either
  declare the guarded fields or carry a justified pragma on the class
  line (e.g. a lock that guards no *fields* — a pure serializer).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .core import FileContext, Finding

_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "add", "discard", "setdefault", "appendleft", "popleft",
    "sort", "reverse",
}


def _finding(ctx: FileContext, rule: str, node: ast.AST, message: str, symbol: str) -> Finding:
    return Finding(
        rule=rule,
        category="locking",
        file=ctx.relpath,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=message,
        symbol=symbol,
    )


def _guarded_decl(cls: ast.ClassDef) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """Parse ``@guarded_by("lock", "f1", ...)`` off a class, if present."""
    for deco in cls.decorator_list:
        if not isinstance(deco, ast.Call):
            continue
        fn = deco.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None
        )
        if name != "guarded_by":
            continue
        strings: List[str] = []
        for arg in deco.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                strings.append(arg.value)
        if strings:
            return strings[0], tuple(strings[1:])
    return None


def _is_self_attr(node: ast.AST, attr: Optional[str] = None) -> Optional[str]:
    """Return the attribute name when ``node`` is ``self.<attr>``."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        if attr is None or node.attr == attr:
            return node.attr
    return None


def _with_holds_lock(node: ast.With, lock_attr: str) -> bool:
    for item in node.items:
        expr = item.context_expr
        if _is_self_attr(expr, lock_attr):
            return True
    return False


class _ClassChecker:
    def __init__(self, ctx: FileContext, cls: ast.ClassDef, lock_attr: str, fields: Tuple[str, ...]):
        self.ctx = ctx
        self.cls = cls
        self.lock_attr = lock_attr
        self.fields = set(fields)
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        init_assigns = self._init_assigned_attrs()
        if self.lock_attr not in init_assigns:
            self.findings.append(_finding(
                self.ctx, "LK003", self.cls,
                f"@guarded_by({self.lock_attr!r}, ...) on {self.cls.name} but "
                f"__init__ never assigns self.{self.lock_attr}",
                self.cls.name,
            ))
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name == "__init__":
                    continue
                self._check_method(stmt)
        return self.findings

    def _init_assigned_attrs(self) -> Set[str]:
        assigned: Set[str] = set()
        for stmt in self.cls.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__":
                for node in ast.walk(stmt):
                    if isinstance(node, (ast.Assign, ast.AnnAssign)):
                        targets = (
                            node.targets if isinstance(node, ast.Assign) else [node.target]
                        )
                        for t in targets:
                            name = _is_self_attr(t)
                            if name:
                                assigned.add(name)
        return assigned

    def _check_method(self, method: ast.FunctionDef) -> None:
        self._walk(method.body, lock_held=False, method_name=method.name)

    def _walk(self, stmts, lock_held: bool, method_name: str) -> None:
        for stmt in stmts:
            self._check_stmt(stmt, lock_held, method_name)

    def _check_stmt(self, stmt: ast.stmt, lock_held: bool, method_name: str) -> None:
        symbol = f"{self.cls.name}.{method_name}"
        if isinstance(stmt, ast.With):
            held = lock_held or _with_holds_lock(stmt, self.lock_attr)
            self._walk(stmt.body, held, method_name)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested function may run later, on another thread, with
            # the lock long released — analyze it as lock-free
            self._walk(stmt.body, False, method_name)
            return
        if not lock_held:
            for field_name, node in self._mutations_in(stmt):
                self.findings.append(_finding(
                    self.ctx, "LK001", node,
                    f"mutation of guarded attribute self.{field_name} outside "
                    f"'with self.{self.lock_attr}:' in {symbol}",
                    symbol,
                ))
        # recurse into compound statements, preserving lock state
        for child_block in self._child_blocks(stmt):
            self._walk(child_block, lock_held, method_name)

    @staticmethod
    def _child_blocks(stmt: ast.stmt):
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(stmt, attr, None)
            if isinstance(block, list) and not isinstance(stmt, (ast.With, ast.FunctionDef, ast.AsyncFunctionDef)):
                yield block
        for handler in getattr(stmt, "handlers", ()) or ():
            yield handler.body
        for case in getattr(stmt, "cases", ()) or ():
            yield case.body

    def _mutations_in(self, stmt: ast.stmt):
        """(field, node) pairs for direct mutations in this statement
        only (children handled by recursion for compound statements)."""
        out = []
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for target in targets:
                out.extend(self._target_mutations(target))
        elif isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                out.extend(self._target_mutations(target))
        elif isinstance(stmt, ast.Expr):
            for node in ast.walk(stmt.value):
                out.extend(self._call_mutations(node))
        else:
            # mutating calls buried in non-block expressions (an If/While
            # test, a Return value, a For iterable) — block bodies are
            # handled by the recursion in _check_stmt
            exprs = []
            if isinstance(stmt, (ast.If, ast.While)):
                exprs.append(stmt.test)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                exprs.append(stmt.value)
            elif isinstance(stmt, ast.For):
                exprs.append(stmt.iter)
            for expr in exprs:
                for node in ast.walk(expr):
                    out.extend(self._call_mutations(node))
        return out

    def _target_mutations(self, target: ast.AST):
        out = []
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                out.extend(self._target_mutations(elt))
            return out
        name = _is_self_attr(target)
        if name and name in self.fields:
            out.append((name, target))
            return out
        if isinstance(target, ast.Subscript):
            name = _is_self_attr(target.value)
            if name and name in self.fields:
                out.append((name, target))
        return out

    def _call_mutations(self, expr: ast.AST):
        out = []
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
            if expr.func.attr in _MUTATING_METHODS:
                name = _is_self_attr(expr.func.value)
                if name and name in self.fields:
                    out.append((name, expr))
        return out


# -- LK004: a lock with no @guarded_by declaration ----------------------------


_LOCK_FACTORIES = {"Lock", "RLock"}


def _init_lock_attrs(cls: ast.ClassDef) -> List[str]:
    """self attributes assigned a threading.Lock()/RLock() in __init__."""
    out: List[str] = []
    for stmt in cls.body:
        if not (isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__"):
            continue
        for node in ast.walk(stmt):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if not (isinstance(value, ast.Call)):
                continue
            fn = value.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name not in _LOCK_FACTORIES:
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                attr = _is_self_attr(t)
                if attr:
                    out.append(attr)
    return out


def _has_mutating_method(cls: ast.ClassDef) -> bool:
    """Any non-__init__ method that assigns a self attribute / subscript
    or calls a known mutating method on one."""
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name == "__init__":
            continue
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if _is_self_attr(t):
                        return True
                    if isinstance(t, ast.Subscript) and _is_self_attr(t.value):
                        return True
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATING_METHODS
                and _is_self_attr(node.func.value)
            ):
                return True
    return False


def _check_lk004(ctx: FileContext, cls: ast.ClassDef) -> List[Finding]:
    lock_attrs = _init_lock_attrs(cls)
    if not lock_attrs or not _has_mutating_method(cls):
        return []
    return [_finding(
        ctx, "LK004", cls,
        f"{cls.name} assigns {', '.join('self.' + a for a in lock_attrs)} "
        "but declares no @guarded_by: neither the LK001 lexical check nor "
        "the runtime race detectors can see what the lock guards",
        cls.name,
    )]


# -- LK002: acquire() without try/finally -------------------------------------


class _AcquireVisitor(ast.NodeVisitor):
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.findings: List[Finding] = []
        self._scope: List[str] = []

    def visit_FunctionDef(self, node):  # noqa: N802 (ast API)
        self._scope.append(node.name)
        self._check_block(node.body)
        self.generic_visit(node)
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_block(self, stmts, in_protected_try: bool = False) -> None:
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, ast.Expr) and self._is_acquire_call(stmt.value):
                nxt = stmts[i + 1] if i + 1 < len(stmts) else None
                protected = in_protected_try or (
                    isinstance(nxt, ast.Try) and self._finally_releases(nxt)
                )
                if not protected:
                    self.findings.append(Finding(
                        rule="LK002",
                        category="locking",
                        file=self.ctx.relpath,
                        line=stmt.lineno,
                        col=stmt.col_offset,
                        message=(
                            "bare .acquire() without try/finally release — an "
                            "exception leaks the lock; use 'with lock:' or "
                            "follow with try/finally"
                        ),
                        symbol=".".join(self._scope),
                    ))
            for block, protected in self._sub_blocks(stmt):
                self._check_block(block, in_protected_try or protected)

    @staticmethod
    def _sub_blocks(stmt: ast.stmt):
        if isinstance(stmt, ast.Try):
            protected = _AcquireVisitor._finally_releases(stmt)
            yield stmt.body, protected
            for handler in stmt.handlers:
                yield handler.body, False
            yield stmt.orelse, False
            yield stmt.finalbody, False
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # handled by visitor recursion
        else:
            for attr in ("body", "orelse", "finalbody"):
                block = getattr(stmt, attr, None)
                if isinstance(block, list):
                    yield block, False
            for case in getattr(stmt, "cases", ()) or ():
                yield case.body, False

    @staticmethod
    def _is_acquire_call(expr: ast.AST) -> bool:
        return (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "acquire"
        )

    @staticmethod
    def _finally_releases(try_stmt: ast.Try) -> bool:
        for node in ast.walk(ast.Module(body=list(try_stmt.finalbody), type_ignores=[])):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "release"
            ):
                return True
        return False


def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            decl = _guarded_decl(node)
            if decl is not None:
                lock_attr, fields = decl
                findings.extend(_ClassChecker(ctx, node, lock_attr, fields).run())
            else:
                findings.extend(_check_lk004(ctx, node))
    acquire_visitor = _AcquireVisitor(ctx)
    acquire_visitor.visit(ctx.tree)
    findings.extend(acquire_visitor.findings)
    return findings
