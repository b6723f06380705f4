"""NA — the device boundary: the device session and the kernel libraries.

The reference package reaches a native C++ solver through ctypes; this
package reaches the card instead, through two doors no other rule
watches:

- **NA001** — a device-session call inside a ``with self.<lock>:``
  block of a ``@guarded_by`` class.  The delta-solve engine's
  ``_Session.native`` is the device-resident
  :class:`~..ops.fifo_session.FifoSession`: ``sess.native.solve(...)``
  is a kernel launch and its synchronize, so under a guarded lock it
  (a) extends the hold by the whole device round trip and (b) stalls
  every thread that only wanted the lock's bookkeeping.  The only legal
  in-lock calls are the ones on the GIL-safe list below: O(1) host
  accessors that touch no device state.  Everything else moves outside
  the lock (the engine's ``solve()`` steps its session outside
  ``_lock`` for exactly this reason) or carries a justified pragma.
  The detection is the reference's, unchanged, so the rule reads the
  same findings in both packages.
- **NA002** — a raw kernel library referenced outside the kernel
  binding modules (:data:`BINDING_MODULES`): ``<module>.LIBRARY.load()``,
  a :class:`~..ops.cuda_build.KernelLibrary`'s ``_lib``, or a
  ``ctypes.CDLL``.  The library is a bare ``ctypes.CDLL``: its entry
  points take raw device pointers and check nothing, so a caller that
  skips the binding module's wrapper skips its tensor checks
  (``check_tensor``: dtype, shape, device, contiguity), its stream and
  its launch count — an out-of-bounds write on the card, or a launch
  that ``chip_smoke.py`` never sees.

Detection is lexical, matching the package's binding idioms: calls to
names imported from a ``native`` module, and calls through attribute
chains containing ``native`` or ``_lib`` (``sess.native.solve(...)``,
``self._lib.fifo_queue(...)``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import FileContext, Finding
from .rules_locks import _guarded_decl, _with_holds_lock

# In-lock native calls that are proven O(1), GIL-hold-trivial accessors.
# Every entry carries its justification here — this list is the rule's
# contract, reviewed like an allowlist.
GIL_SAFE_NATIVE_CALLS = {
    # sums the byte sizes of the session's tensors on the host: no launch,
    # no synchronize, no device memory read (ops/fifo_session.py
    # FifoSession.mem_bytes)
    "mem_bytes",
}

# The modules that own a KernelLibrary: the module that builds it and the
# four kernels' wrappers (each checks its tensors, picks the stream and
# counts its launches before it calls the library).
BINDING_MODULES = (
    "ops/cuda_build.py",
    "ops/queue_kernel.py",
    "ops/minfrag_kernel.py",
    "ops/single_az_kernel.py",
    "ops/class_kernel.py",
)

# attribute/receiver names that mark a call as crossing the boundary
_BOUNDARY_MARKERS = {"native", "_lib"}


def _finding(ctx: FileContext, rule: str, node: ast.AST, message: str,
             symbol: str) -> Finding:
    return Finding(
        rule=rule,
        category="native-boundary",
        file=ctx.relpath,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=message,
        symbol=symbol,
    )


def _native_imported_names(tree: ast.Module) -> Set[str]:
    """Names bound by ``from ...native[...] import X [as Y]`` anywhere in
    the file (module- or function-level)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            parts = module.split(".")
            if "native" in parts:
                for alias in node.names:
                    names.add(alias.asname or alias.name)
    return names


def _attr_chain(node: ast.AST) -> List[str]:
    """['self', '_lib', 'snap_read'] for ``self._lib.snap_read``."""
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        chain.append(node.id)
    chain.reverse()
    return chain


def _native_call_name(call: ast.Call, imported: Set[str]) -> Optional[str]:
    """The called symbol when this call crosses the native boundary."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id if fn.id in imported else None
    if isinstance(fn, ast.Attribute):
        chain = _attr_chain(fn)
        # the final element is the callee; boundary if any RECEIVER link
        # is a marker, or the callee resolves to an imported native name
        if any(link in _BOUNDARY_MARKERS for link in chain[:-1]):
            return chain[-1]
        if chain and chain[0] in imported:
            return chain[-1]
    return None


class _Na001Checker:
    """Walks a @guarded_by class, tracking the declared-lock scope."""

    def __init__(self, ctx: FileContext, cls: ast.ClassDef, lock_attr: str,
                 imported: Set[str]):
        self.ctx = ctx
        self.cls = cls
        self.lock_attr = lock_attr
        self.imported = imported
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(stmt.body, False, stmt.name)
        return self.findings

    def _walk(self, stmts, lock_held: bool, method: str) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                held = lock_held or _with_holds_lock(stmt, self.lock_attr)
                self._walk(stmt.body, held, method)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(stmt.body, False, stmt.name)
                continue
            if lock_held:
                # one flat scan that skips nested defs (they run later,
                # lock-free); no recursion afterwards — recursing too
                # would report each nested call once per block level
                self._report_calls(stmt, method)
                continue
            for attr in ("body", "orelse", "finalbody"):
                block = getattr(stmt, attr, None)
                if isinstance(block, list):
                    self._walk(block, lock_held, method)
            for handler in getattr(stmt, "handlers", ()) or ():
                self._walk(handler.body, lock_held, method)
            for case in getattr(stmt, "cases", ()) or ():
                self._walk(case.body, lock_held, method)

    def _report_calls(self, stmt: ast.stmt, method: str) -> None:
        stack: List[ast.AST] = [stmt]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # deferred body: not under the lock when it runs
            if isinstance(node, ast.Call):
                callee = _native_call_name(node, self.imported)
                if callee is not None and callee not in GIL_SAFE_NATIVE_CALLS:
                    self.findings.append(_finding(
                        self.ctx, "NA001", node,
                        f"native-boundary call {callee}() while "
                        f"holding self.{self.lock_attr}: ctypes "
                        "releases the GIL, so the guarded lock is "
                        "held across foreign code — move the call "
                        "outside the lock or add it to "
                        "GIL_SAFE_NATIVE_CALLS with a justification",
                        f"{self.cls.name}.{method}",
                    ))
            stack.extend(ast.iter_child_nodes(node))


def is_library_load(node: ast.AST) -> bool:
    """``LIBRARY.load()`` or ``<module>.LIBRARY.load()``: a kernel
    library's CDLL."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    chain = _attr_chain(node.func.value)
    return node.func.attr == "load" and bool(chain) and chain[-1] == "LIBRARY"


def _raw_library_use(node: ast.AST) -> Optional[str]:
    """What makes ``node`` a raw kernel-library reference, if anything."""
    if isinstance(node, ast.Attribute) and node.attr == "_lib":
        return "KernelLibrary._lib"
    if is_library_load(node):
        return ".".join(_attr_chain(node.func)) + "()"
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "CDLL":
            return "ctypes.CDLL()"
        if isinstance(fn, ast.Name) and fn.id == "CDLL":
            return "CDLL()"
    return None


def _check_na002(ctx: FileContext) -> List[Finding]:
    if ctx.relpath in BINDING_MODULES:
        return []
    findings: List[Finding] = []
    scope: List[str] = []

    def visit(node: ast.AST) -> None:
        pushed = False
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            scope.append(node.name)
            pushed = True
        what = _raw_library_use(node)
        if what is not None:
            findings.append(_finding(
                ctx, "NA002", node,
                f"raw kernel library {what} referenced outside the "
                "kernel binding modules: the CDLL checks no tensor, "
                "stream or launch count — call the binding module's "
                "wrapper instead",
                ".".join(scope),
            ))
        for child in ast.iter_child_nodes(node):
            visit(child)
        if pushed:
            scope.pop()

    visit(ctx.tree)
    return findings


def check(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    imported = _native_imported_names(ctx.tree)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            decl = _guarded_decl(node)
            if decl is not None:
                lock_attr, _fields = decl
                findings.extend(
                    _Na001Checker(ctx, node, lock_attr, imported).run()
                )
    findings.extend(_check_na002(ctx))
    return findings
