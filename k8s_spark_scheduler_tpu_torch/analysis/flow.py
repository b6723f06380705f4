"""Flow-sensitive analysis substrate for schedlint protocol rules.

Three layers, each usable on its own:

1. :class:`CFG` — a statement-level control-flow graph per function,
   built from the ``ast`` module with *explicit* exception, ``finally``
   and ``with`` edges.  Synthetic nodes model entry, normal exit,
   raise-exit (the "function unwinds" sink), except-handler dispatch,
   shared ``finally`` bodies and the implicit ``__exit__`` of a
   ``with`` block.

2. Dominance (:meth:`CFG.dominators`, :meth:`CFG.dominates`) and a
   generic forward worklist dataflow engine (:func:`forward_dataflow`)
   over caller-supplied transfer/join functions.  Exception edges carry
   a separately computed state (``transfer_exc``) so typestate rules
   can model "the call raised before/after the effect took hold".

3. :class:`PackageIndex` — a lightweight intra-package call graph:
   every function/method in the analyzed file set keyed by
   ``relpath::qualname``, with resolution for ``self.method(...)``,
   same-module ``name(...)`` and ``imported_module.name(...)`` calls.
   Attribute-typed receivers (``self._client.create``) are *not*
   resolved — by design they participate only as lexical patterns in
   the rules, never as call-graph edges.

Modelling decisions (documented imprecision)
--------------------------------------------
* Exception edges are added only from statements whose own expressions
  contain a ``Call``, ``Raise``, ``Assert``, ``Await`` or ``Yield`` —
  plain assignments and constant returns are assumed not to raise.
  ``yield`` gets a raise edge because a generator can be abandoned
  (``GeneratorExit``) or ``throw``-injected at any suspension point.
* ``finally`` bodies are built ONCE and shared by every path that
  crosses them (normal fall-through, every ``return``/``break``/
  ``continue``, and exception propagation).  Continuations are merged:
  after the shared finally body the CFG branches to every continuation
  any path requested.  This over-approximates paths (a ``return`` may
  appear to "fall through") but never hides one.
* ``with`` blocks are modelled like ``try/finally`` whose cleanup is a
  single synthetic ``with-exit`` node (the ``__exit__`` call) — rules
  treat it as the close event for the context object.
* Handler lists never swallow propagation: even a bare ``except:``
  keeps an edge from the protected body to the outer exception target,
  because the repo deliberately injects ``BaseException``-derived
  crashes (:mod:`..ha.crashpoint`) that bypass ``except Exception``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

# absolute imports that name one of these packages resolve inside the
# analyzed tree: this package, or the reference package it was copied
# from (the two trees have the same layout, so one index reads either)
_PACKAGE_NAMES = ("k8s_spark_scheduler_tpu_torch", "k8s_spark_scheduler_tpu")

__all__ = [
    "CFG",
    "Node",
    "build_cfg",
    "forward_dataflow",
    "may_raise",
    "FunctionUnit",
    "PackageIndex",
]

# Edge kinds
NORMAL = "normal"
EXC = "exc"

# Node kinds
ENTRY = "entry"
EXIT = "exit"
RAISE_EXIT = "raise-exit"
STMT = "stmt"
TEST = "test"
EXCEPT = "except"
FINALLY = "finally"
WITH_EXIT = "with-exit"
JOIN = "join"


class Node:
    """One CFG node.  ``stmt`` is the owning ast node (None for the
    synthetic entry/exit/join nodes); ``kind`` distinguishes synthetic
    roles so rules can pattern-match on them."""

    __slots__ = ("idx", "stmt", "kind", "line")

    def __init__(self, idx: int, stmt: Optional[ast.AST], kind: str):
        self.idx = idx
        self.stmt = stmt
        self.kind = kind
        self.line = getattr(stmt, "lineno", 0) if stmt is not None else 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Node {self.idx} {self.kind} L{self.line}>"


class _MayRaiseScan(ast.NodeVisitor):
    """Does this expression tree contain anything that can raise?

    Deliberately narrow: calls, raises, asserts, awaits and yields.
    Attribute access / arithmetic can raise too, but flagging them
    would drown typestate rules in impossible paths."""

    def __init__(self) -> None:
        self.found = False

    def generic_visit(self, node: ast.AST) -> None:
        if self.found:
            return
        if isinstance(
            node, (ast.Call, ast.Raise, ast.Assert, ast.Await, ast.Yield, ast.YieldFrom)
        ):
            self.found = True
            return
        # do not descend into nested function/class bodies
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            return
        super().generic_visit(node)


def may_raise(node: ast.AST) -> bool:
    """True when the statement's own expressions may raise (see
    :class:`_MayRaiseScan` for the deliberate narrowness)."""
    scan = _MayRaiseScan()
    if isinstance(node, (ast.If, ast.While)):
        scan.visit(node.test)
    elif isinstance(node, (ast.For, ast.AsyncFor)):
        scan.visit(node.iter)
        # iteration itself (StopIteration handling aside) calls __next__
        return True
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        return True
    elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return False
    else:
        scan.visit(node)
    return scan.found


@dataclass
class _Cleanup:
    """A shared cleanup region (finally body or with-exit node).

    ``head`` is wired as the target of every path that crosses the
    cleanup; ``out`` (the cleanup subgraph's exit frontier) gets edges
    to every requested continuation once the function is built."""

    head: int
    out: List[int] = field(default_factory=list)
    requests: Set[int] = field(default_factory=set)


@dataclass
class _Loop:
    continue_target: int
    break_join: int
    cleanup_depth: int


class CFG:
    """Statement-level control-flow graph for one function body."""

    def __init__(self, func: Optional[ast.AST] = None):
        self.func = func
        self.nodes: List[Node] = []
        self.succs: List[List[Tuple[int, str]]] = []
        self.preds: List[List[Tuple[int, str]]] = []
        self._dom: Optional[List[int]] = None  # bitsets, lazily computed

    # -- construction helpers (used by _Builder) --------------------------

    def new_node(self, stmt: Optional[ast.AST], kind: str) -> int:
        idx = len(self.nodes)
        self.nodes.append(Node(idx, stmt, kind))
        self.succs.append([])
        self.preds.append([])
        return idx

    def add_edge(self, src: int, dst: int, kind: str = NORMAL) -> None:
        if (dst, kind) not in self.succs[src]:
            self.succs[src].append((dst, kind))
            self.preds[dst].append((src, kind))
        self._dom = None

    # -- queries -----------------------------------------------------------

    @property
    def entry(self) -> int:
        return 0

    @property
    def exit(self) -> int:
        return 1

    @property
    def raise_exit(self) -> int:
        return 2

    def reachable(self) -> List[int]:
        """Nodes reachable from entry, in reverse post-order."""
        seen: Set[int] = set()
        order: List[int] = []

        def dfs(n: int) -> None:
            stack = [(n, iter(self.succs[n]))]
            seen.add(n)
            while stack:
                node, it = stack[-1]
                advanced = False
                for dst, _kind in it:
                    if dst not in seen:
                        seen.add(dst)
                        stack.append((dst, iter(self.succs[dst])))
                        advanced = True
                        break
                if not advanced:
                    order.append(node)
                    stack.pop()

        dfs(self.entry)
        order.reverse()
        return order

    def dominators(self) -> Dict[int, Set[int]]:
        """dom(n) = nodes on *every* path entry→n (classic iterative
        dataflow over bitsets; functions are small so this is cheap)."""
        if self._dom is None:
            order = self.reachable()
            n_nodes = len(self.nodes)
            full = (1 << n_nodes) - 1
            dom = [full] * n_nodes
            dom[self.entry] = 1 << self.entry
            changed = True
            reach = set(order)
            while changed:
                changed = False
                for n in order:
                    if n == self.entry:
                        continue
                    new = full
                    for p, _k in self.preds[n]:
                        if p in reach:
                            new &= dom[p]
                    new |= 1 << n
                    if new != dom[n]:
                        dom[n] = new
                        changed = True
            self._dom = dom
        out: Dict[int, Set[int]] = {}
        for n in self.reachable():
            bits = self._dom[n]
            out[n] = {i for i in range(len(self.nodes)) if bits >> i & 1}
        return out

    def dominates(self, a: int, b: int) -> bool:
        """True when every path from entry to ``b`` passes through ``a``."""
        if self._dom is None:
            self.dominators()
        assert self._dom is not None
        return bool(self._dom[b] >> a & 1)

    def stmt_nodes(self) -> Iterable[Node]:
        for node in self.nodes:
            if node.stmt is not None:
                yield node


class _Builder:
    """Recursive-descent CFG construction.

    ``frontier`` holds the node indices whose normal-completion edge
    flows into whatever comes next.  ``exc_stack`` holds, innermost
    last, the *flattened* list of exception targets active for the
    region being built (handler dispatch nodes, cleanup heads, and
    ultimately the function's raise-exit)."""

    def __init__(self, func: ast.AST):
        self.cfg = CFG(func)
        self.cfg.new_node(None, ENTRY)  # 0
        self.cfg.new_node(None, EXIT)  # 1
        self.cfg.new_node(None, RAISE_EXIT)  # 2
        self.exc_stack: List[List[int]] = [[self.cfg.raise_exit]]
        self.cleanups: List[_Cleanup] = []
        self.loops: List[_Loop] = []
        self.frontier: List[int] = [self.cfg.entry]

    # -- plumbing ----------------------------------------------------------

    def _flow_to(self, idx: int) -> None:
        for src in self.frontier:
            self.cfg.add_edge(src, idx, NORMAL)
        self.frontier = [idx]

    def _exc_edges(self, idx: int) -> None:
        for target in self.exc_stack[-1]:
            self.cfg.add_edge(idx, target, EXC)

    def _stmt_node(self, stmt: ast.AST, kind: str = STMT) -> int:
        idx = self.cfg.new_node(stmt, kind)
        self._flow_to(idx)
        if may_raise(stmt):
            self._exc_edges(idx)
        return idx

    def _route_abrupt(self, src: int, final_target: int, down_to: int) -> None:
        """Route an abrupt jump (return/break/continue) from ``src``
        through every cleanup region inner to ``down_to`` (a cleanup
        stack depth), landing at ``final_target``."""
        chain = self.cleanups[down_to:]
        if not chain:
            self.cfg.add_edge(src, final_target, NORMAL)
            return
        # innermost first when crossing outward
        chain = list(reversed(chain))
        self.cfg.add_edge(src, chain[0].head, NORMAL)
        for inner, outer in zip(chain, chain[1:]):
            inner.requests.add(outer.head)
        chain[-1].requests.add(final_target)

    # -- statement dispatch -------------------------------------------------

    def build(self) -> CFG:
        body = self.cfg.func.body  # type: ignore[union-attr]
        self._block(body)
        for src in self.frontier:
            self.cfg.add_edge(src, self.cfg.exit, NORMAL)
        # flush cleanup continuation requests
        for cleanup in self.cleanups:
            for target in sorted(cleanup.requests):
                for out in cleanup.out:
                    self.cfg.add_edge(out, target, NORMAL)
        return self.cfg

    def _block(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if not self.frontier:
                # dead code after return/raise/break — still build nodes
                # so rules can see them, but leave them unreachable
                pass
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.If):
            self._if(stmt)
        elif isinstance(stmt, (ast.While,)):
            self._while(stmt)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._for(stmt)
        elif isinstance(stmt, ast.Try):
            self._try(stmt)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._with(stmt)
        elif isinstance(stmt, ast.Return):
            idx = self._stmt_node(stmt)
            self.frontier = []
            self._route_abrupt(idx, self.cfg.exit, 0)
        elif isinstance(stmt, ast.Raise):
            idx = self.cfg.new_node(stmt, STMT)
            self._flow_to(idx)
            self._exc_edges(idx)
            self.frontier = []
        elif isinstance(stmt, ast.Break):
            idx = self._stmt_node(stmt)
            self.frontier = []
            if self.loops:
                loop = self.loops[-1]
                self._route_abrupt(idx, loop.break_join, loop.cleanup_depth)
        elif isinstance(stmt, ast.Continue):
            idx = self._stmt_node(stmt)
            self.frontier = []
            if self.loops:
                loop = self.loops[-1]
                self._route_abrupt(idx, loop.continue_target, loop.cleanup_depth)
        elif isinstance(stmt, ast.Match):
            self._match(stmt)
        else:
            # simple statement (incl. nested def/class, which are opaque)
            self._stmt_node(stmt)

    def _if(self, stmt: ast.If) -> None:
        test = self._stmt_node(stmt, TEST)
        self.frontier = [test]
        self._block(stmt.body)
        body_frontier = self.frontier
        if stmt.orelse:
            self.frontier = [test]
            self._block(stmt.orelse)
            self.frontier = body_frontier + self.frontier
        else:
            self.frontier = body_frontier + [test]

    @staticmethod
    def _const_true(expr: ast.expr) -> bool:
        return isinstance(expr, ast.Constant) and bool(expr.value)

    def _while(self, stmt: ast.While) -> None:
        test = self._stmt_node(stmt, TEST)
        break_join = self.cfg.new_node(None, JOIN)
        self.loops.append(_Loop(test, break_join, len(self.cleanups)))
        self.frontier = [test]
        self._block(stmt.body)
        for src in self.frontier:
            self.cfg.add_edge(src, test, NORMAL)  # back edge
        self.loops.pop()
        exits: List[int] = [break_join]
        if not self._const_true(stmt.test):
            exits.append(test)
        if stmt.orelse:
            self.frontier = [test] if not self._const_true(stmt.test) else []
            self._block(stmt.orelse)
            exits = [break_join] + self.frontier
        self.frontier = exits

    def _for(self, stmt) -> None:
        head = self._stmt_node(stmt, TEST)
        break_join = self.cfg.new_node(None, JOIN)
        self.loops.append(_Loop(head, break_join, len(self.cleanups)))
        self.frontier = [head]
        self._block(stmt.body)
        for src in self.frontier:
            self.cfg.add_edge(src, head, NORMAL)
        self.loops.pop()
        if stmt.orelse:
            self.frontier = [head]
            self._block(stmt.orelse)
            self.frontier = [break_join] + self.frontier
        else:
            self.frontier = [break_join, head]

    def _try(self, stmt: ast.Try) -> None:
        handlers = [self.cfg.new_node(h, EXCEPT) for h in stmt.handlers]
        cleanup: Optional[_Cleanup] = None
        if stmt.finalbody:
            head = self.cfg.new_node(None, FINALLY)
            cleanup = _Cleanup(head=head)
            self.cleanups.append(cleanup)
            outer_exc = self.exc_stack[-1]
            # uncaught exceptions run the finally, then propagate
            cleanup.requests.update(outer_exc)
            body_exc = handlers + [head]
            handler_exc = [head]
        else:
            body_exc = handlers + list(self.exc_stack[-1])
            handler_exc = list(self.exc_stack[-1])

        # protected body (+ else clause, same protection minus handlers)
        self.exc_stack.append(body_exc)
        entry_frontier = list(self.frontier)
        self._block(stmt.body)
        self.exc_stack.pop()
        if stmt.orelse:
            self.exc_stack.append(
                [cleanup.head] if cleanup else list(self.exc_stack[-1])
            )
            self._block(stmt.orelse)
            self.exc_stack.pop()
        normal_out = list(self.frontier)

        # handlers
        handler_outs: List[int] = []
        for h_node, handler in zip(handlers, stmt.handlers):
            self.exc_stack.append(handler_exc)
            self.frontier = [h_node]
            self._block(handler.body)
            handler_outs.extend(self.frontier)
            self.exc_stack.pop()
        del entry_frontier

        if cleanup is not None:
            # all normal completions funnel through the shared finally
            for src in normal_out + handler_outs:
                self.cfg.add_edge(src, cleanup.head, NORMAL)
            self.exc_stack.append(list(self.exc_stack[-1]))
            self.frontier = [cleanup.head]
            self._block(stmt.finalbody)
            self.exc_stack.pop()
            cleanup.out = list(self.frontier)
            # the cleanup is now sealed: subsequent abrupt routing in
            # enclosing code no longer crosses it
            self.cleanups.remove(cleanup)
            self.cleanups_done_append(cleanup)
            # fall-through continues after the finally body
            self.frontier = list(cleanup.out)
        else:
            self.frontier = normal_out + handler_outs

    # sealed cleanups kept so build() can flush their requests
    def cleanups_done_append(self, cleanup: _Cleanup) -> None:
        if not hasattr(self, "_sealed"):
            self._sealed: List[_Cleanup] = []
        self._sealed.append(cleanup)

    def _with(self, stmt) -> None:
        head = self._stmt_node(stmt, STMT)  # context-expr evaluation
        exit_node = self.cfg.new_node(stmt, WITH_EXIT)
        cleanup = _Cleanup(head=exit_node, out=[exit_node])
        self.cleanups.append(cleanup)
        # body exceptions run __exit__, then propagate outward
        cleanup.requests.update(self.exc_stack[-1])
        self.exc_stack.append([exit_node])
        self.frontier = [head]
        self._block(stmt.body)
        self.exc_stack.pop()
        for src in self.frontier:
            self.cfg.add_edge(src, exit_node, NORMAL)
        # __exit__ itself may raise
        for target in self.exc_stack[-1]:
            self.cfg.add_edge(exit_node, target, EXC)
        self.cleanups.remove(cleanup)
        self.cleanups_done_append(cleanup)
        self.frontier = [exit_node]

    def _match(self, stmt: ast.Match) -> None:
        subject = self._stmt_node(stmt, TEST)
        outs: List[int] = []
        for case in stmt.cases:
            self.frontier = [subject]
            self._block(case.body)
            outs.extend(self.frontier)
        self.frontier = outs + [subject]


def build_cfg(func: ast.AST) -> CFG:
    """Build the CFG for a FunctionDef/AsyncFunctionDef body."""
    builder = _Builder(func)
    cfg = builder.build()
    # flush sealed cleanup continuations (finally / with-exit regions)
    for cleanup in getattr(builder, "_sealed", []):
        for target in sorted(cleanup.requests):
            for out in cleanup.out:
                cfg.add_edge(out, target, NORMAL)
    return cfg


# ---------------------------------------------------------------------------
# forward dataflow
# ---------------------------------------------------------------------------


def forward_dataflow(
    cfg: CFG,
    init: Any,
    transfer: Callable[[Node, Any], Any],
    join: Callable[[Any, Any], Any],
    transfer_exc: Optional[Callable[[Node, Any], Any]] = None,
    max_iter: int = 10000,
) -> Dict[int, Any]:
    """Worklist forward dataflow.  Returns IN-state per node index.

    ``transfer(node, in_state) -> out_state`` is applied along normal
    edges; ``transfer_exc`` (default: same as ``transfer``) along
    exception edges — typestate rules use it to model effects that do
    or don't take hold when the statement raises.  ``join`` must be
    monotone and idempotent; ``None`` is the implicit bottom (absent
    state) and is never passed to ``join``/``transfer``."""
    if transfer_exc is None:
        transfer_exc = transfer
    in_state: Dict[int, Any] = {cfg.entry: init}
    order = cfg.reachable()
    pos = {n: i for i, n in enumerate(order)}
    work = list(order)
    in_work = set(work)
    iters = 0
    while work:
        iters += 1
        if iters > max_iter:  # pragma: no cover - safety valve
            break
        n = work.pop(0)
        in_work.discard(n)
        if n not in in_state:
            continue
        node = cfg.nodes[n]
        state = in_state[n]
        out_normal = transfer(node, state)
        out_exc = transfer_exc(node, state)
        for dst, kind in cfg.succs[n]:
            out = out_exc if kind == EXC else out_normal
            if dst in in_state:
                merged = join(in_state[dst], out)
            else:
                merged = out
            if dst not in in_state or merged != in_state[dst]:
                in_state[dst] = merged
                if dst not in in_work and dst in pos:
                    in_work.add(dst)
                    work.append(dst)
                    work.sort(key=lambda x: pos.get(x, 0))
    return in_state


# ---------------------------------------------------------------------------
# package index / call graph
# ---------------------------------------------------------------------------


@dataclass
class FunctionUnit:
    """One function or method in the analyzed file set."""

    relpath: str
    qualname: str  # "Class.method", "func", "outer.<locals>.inner"
    name: str
    class_name: Optional[str]
    node: ast.AST
    ctx: Any  # analysis.core.FileContext
    _cfg: Optional[CFG] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.relpath, self.qualname)

    def cfg(self) -> CFG:
        if self._cfg is None:
            self._cfg = build_cfg(self.node)
        return self._cfg


class PackageIndex:
    """Function units + import maps + call resolution for one analysis
    run.  ``contexts`` is the list of per-file FileContext objects the
    schedlint driver parsed."""

    def __init__(self, contexts: Sequence[Any]):
        self.contexts = list(contexts)
        self.units: Dict[Tuple[str, str], FunctionUnit] = {}
        # relpath -> {name -> qualname} for module-level functions
        self.module_funcs: Dict[str, Dict[str, str]] = {}
        # relpath -> {alias -> imported module relpath}
        self.module_aliases: Dict[str, Dict[str, str]] = {}
        # relpath -> {alias -> (module relpath, symbol name)}
        self.symbol_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        by_relpath = {c.relpath: c for c in self.contexts}
        for ctx in self.contexts:
            self._collect_units(ctx)
            self._collect_imports(ctx, by_relpath)

    # -- construction ------------------------------------------------------

    def _collect_units(self, ctx: Any) -> None:
        module_funcs: Dict[str, str] = {}

        def walk(node: ast.AST, class_name: Optional[str], prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = prefix + child.name
                    unit = FunctionUnit(
                        relpath=ctx.relpath,
                        qualname=qual,
                        name=child.name,
                        class_name=class_name,
                        node=child,
                        ctx=ctx,
                    )
                    self.units[unit.key] = unit
                    if not prefix:
                        module_funcs[child.name] = qual
                    walk(child, None, qual + ".<locals>.")
                elif isinstance(child, ast.ClassDef):
                    walk(child, child.name, prefix + child.name + ".")
        walk(ctx.tree, None, "")
        self.module_funcs[ctx.relpath] = module_funcs

    def _collect_imports(self, ctx: Any, by_relpath: Dict[str, Any]) -> None:
        aliases: Dict[str, str] = {}
        symbols: Dict[str, Tuple[str, str]] = {}
        pkg_dir = ctx.relpath.rsplit("/", 1)[0] if "/" in ctx.relpath else ""
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                base = self._resolve_from_base(node, pkg_dir)
                if base is None:
                    continue
                for alias in node.names:
                    bound = alias.asname or alias.name
                    as_module = (base + "/" if base else "") + alias.name + ".py"
                    if as_module in by_relpath:
                        aliases[bound] = as_module
                    else:
                        mod_file = (base + ".py") if base else ""
                        if mod_file in by_relpath:
                            symbols[bound] = (mod_file, alias.name)
        self.module_aliases[ctx.relpath] = aliases
        self.symbol_imports[ctx.relpath] = symbols

    @staticmethod
    def _resolve_from_base(node: ast.ImportFrom, pkg_dir: str) -> Optional[str]:
        """Map an ImportFrom to a package-relative directory/module path
        ("" means the package root).  Returns None when the import is
        outside the analyzed package."""
        if node.level:
            parts = pkg_dir.split("/") if pkg_dir else []
            up = node.level - 1
            if up > len(parts):
                return None
            base_parts = parts[: len(parts) - up]
            if node.module:
                base_parts.extend(node.module.split("."))
            return "/".join(base_parts)
        if node.module and node.module.split(".")[0] in _PACKAGE_NAMES:
            rest = node.module.split(".")[1:]
            return "/".join(rest)
        return None

    # -- resolution --------------------------------------------------------

    def resolve_call(
        self, call: ast.Call, unit: FunctionUnit
    ) -> Optional[FunctionUnit]:
        func = call.func
        if isinstance(func, ast.Name):
            # same-module function
            qual = self.module_funcs.get(unit.relpath, {}).get(func.id)
            if qual is not None:
                return self.units.get((unit.relpath, qual))
            # imported symbol
            target = self.symbol_imports.get(unit.relpath, {}).get(func.id)
            if target is not None:
                relpath, name = target
                qual = self.module_funcs.get(relpath, {}).get(name)
                if qual is not None:
                    return self.units.get((relpath, qual))
            return None
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            recv, attr = func.value.id, func.attr
            if recv == "self" and unit.class_name is not None:
                return self.units.get(
                    (unit.relpath, f"{unit.class_name}.{attr}")
                )
            mod = self.module_aliases.get(unit.relpath, {}).get(recv)
            if mod is not None:
                qual = self.module_funcs.get(mod, {}).get(attr)
                if qual is not None:
                    return self.units.get((mod, qual))
        return None

    def calls_in(self, unit: FunctionUnit) -> List[ast.Call]:
        """Every Call expression lexically inside the unit's body,
        excluding nested function bodies (those are separate units)."""
        out: List[ast.Call] = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(child, ast.Call):
                    out.append(child)
                walk(child)

        for stmt in unit.node.body:  # type: ignore[union-attr]
            walk(stmt)
            if isinstance(stmt, ast.Call):  # pragma: no cover - stmts aren't Calls
                out.append(stmt)
        return out
