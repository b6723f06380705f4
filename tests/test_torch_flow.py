"""The port's ``analysis/flow.py``: the reference's CFG / dominance /
dataflow cases (tests/test_flow.py) against the port's module, and the
port's CFGs held equal to the reference's.

The parity corpus is every function fixture of tests/test_flow.py and
every function of the reference's ``concurrent/engine.py``,
``state/cache.py`` and ``policy/preempt.py``: both packages build a CFG
from the same source, and the CFGs are compared by node kinds and lines,
edges with their kinds, and dominator sets.
"""

import ast
import os
import textwrap

import pytest

from k8s_spark_scheduler_tpu.analysis import flow as ref_flow
from k8s_spark_scheduler_tpu_torch.analysis import flow
from k8s_spark_scheduler_tpu_torch.analysis.core import FileContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(src):
    tree = ast.parse(textwrap.dedent(src))
    func = tree.body[0]
    return flow.build_cfg(func)


def _node(cfg, line, kind=None):
    hits = [
        n
        for n in cfg.nodes
        if n.line == line and (kind is None or n.kind == kind)
    ]
    assert hits, f"no node at line {line} (kind={kind}) in {cfg.nodes}"
    return hits[0]


def _has_edge(cfg, src, dst, kind=None):
    return any(
        d == dst.idx and (kind is None or k == kind) for d, k in cfg.succs[src.idx]
    )


# -- basic shape --------------------------------------------------------------


def test_linear_flow_dominance():
    cfg = _cfg(
        """
        def f(self):
            a = self.one()
            b = self.two(a)
            return b
        """
    )
    n_a, n_b, n_r = _node(cfg, 3), _node(cfg, 4), _node(cfg, 5)
    assert _has_edge(cfg, n_a, n_b, flow.NORMAL)
    assert _has_edge(cfg, n_b, n_r, flow.NORMAL)
    assert cfg.dominates(n_a.idx, n_r.idx)
    assert cfg.dominates(cfg.entry, n_r.idx)
    assert not cfg.dominates(n_r.idx, n_a.idx)
    # calls may raise: each call node has an edge to the raise exit
    assert _has_edge(cfg, n_a, cfg.nodes[cfg.raise_exit], flow.EXC)


def test_early_return_splits_paths():
    cfg = _cfg(
        """
        def f(self, x):
            if x:
                return 1
            self.work()
            return 2
        """
    )
    test = _node(cfg, 3, flow.TEST)
    work = _node(cfg, 5)
    assert cfg.dominates(test.idx, cfg.exit)
    # the fall-through arm does not dominate the exit (the early return
    # bypasses it)
    assert not cfg.dominates(work.idx, cfg.exit)


# -- try/finally --------------------------------------------------------------


def test_finally_dominates_every_exit():
    cfg = _cfg(
        """
        def f(self):
            try:
                return self.work()
            finally:
                self.cleanup()
        """
    )
    cleanup = _node(cfg, 6)
    # the return is routed THROUGH the shared finally body
    assert cfg.dominates(cleanup.idx, cfg.exit)
    # and so is exception propagation out of work()
    assert cfg.dominates(cleanup.idx, cfg.raise_exit)


def test_except_handler_and_uncaught_propagation():
    cfg = _cfg(
        """
        def f(self):
            try:
                self.work()
            except ValueError:
                return None
            return 1
        """
    )
    work = _node(cfg, 4)
    handler = _node(cfg, 5, flow.EXCEPT)
    assert _has_edge(cfg, work, handler, flow.EXC)
    # a handler list never swallows propagation: crash injection raises
    # BaseException-derived types that bypass `except ValueError`
    assert _has_edge(cfg, work, cfg.nodes[cfg.raise_exit], flow.EXC)
    assert not cfg.dominates(handler.idx, cfg.exit)


def test_break_and_continue_route_through_finally():
    cfg = _cfg(
        """
        def f(self, items):
            for it in items:
                try:
                    if self.skip(it):
                        continue
                    if self.stop(it):
                        break
                finally:
                    self.note(it)
            return None
        """
    )
    note = _node(cfg, 10)
    head = _node(cfg, 3, flow.TEST)
    # continue re-enters the loop head only via the finally body
    assert _has_edge(cfg, note, head, flow.NORMAL)
    # break leaves the loop only via the finally body: the note node
    # dominates the function exit on every leaving path except the
    # normal loop exhaustion — so it cannot dominate exit, but the
    # break join must be one of its successors
    succ_kinds = {cfg.nodes[d].kind for d, _ in cfg.succs[note.idx]}
    assert flow.JOIN in succ_kinds


# -- with blocks --------------------------------------------------------------


def test_with_exit_covers_body_exception_but_not_enter_failure():
    cfg = _cfg(
        """
        def f(self):
            with self.lock():
                self.work()
        """
    )
    head = _node(cfg, 3, flow.STMT)
    work = _node(cfg, 4)
    wexit = _node(cfg, 3, flow.WITH_EXIT)
    # body exceptions run __exit__ first
    assert _has_edge(cfg, work, wexit, flow.EXC)
    # every normal completion passes the close
    assert cfg.dominates(wexit.idx, cfg.exit)
    # but a failed __enter__ never opened, so the close does NOT
    # dominate the raise exit (RAII: acquisition failure = not held)
    assert _has_edge(cfg, head, cfg.nodes[cfg.raise_exit], flow.EXC)
    assert not cfg.dominates(wexit.idx, cfg.raise_exit)


def test_nested_with_unwinds_inner_to_outer():
    cfg = _cfg(
        """
        def f(self):
            with self.outer():
                with self.inner():
                    self.work()
        """
    )
    outer_exit = _node(cfg, 3, flow.WITH_EXIT)
    inner_exit = _node(cfg, 4, flow.WITH_EXIT)
    work = _node(cfg, 5)
    assert _has_edge(cfg, work, inner_exit, flow.EXC)
    # unwinding order: inner close, then outer close
    assert _has_edge(cfg, inner_exit, outer_exit)
    # the body's normal completion also runs the inner close first
    assert _has_edge(cfg, work, inner_exit, flow.NORMAL)
    assert cfg.dominates(outer_exit.idx, cfg.exit)
    # the inner close does NOT dominate the exit: a failing inner
    # __enter__ unwinds through the outer close only (nothing inner to
    # release), and cleanup continuations are merged — a known,
    # documented imprecision that errs toward fewer findings
    assert not cfg.dominates(inner_exit.idx, cfg.exit)


# -- loops --------------------------------------------------------------------


def test_loop_back_edge_and_head_dominance():
    cfg = _cfg(
        """
        def f(self, items):
            total = 0
            for it in items:
                total += self.step(it)
            return total
        """
    )
    head = _node(cfg, 4, flow.TEST)
    body = _node(cfg, 5)
    ret = _node(cfg, 6)
    assert _has_edge(cfg, body, head, flow.NORMAL)  # the back edge
    assert cfg.dominates(head.idx, body.idx)
    assert cfg.dominates(head.idx, ret.idx)
    assert not cfg.dominates(body.idx, ret.idx)


def test_while_true_exits_only_via_break():
    cfg = _cfg(
        """
        def f(self):
            while True:
                if self.done():
                    break
                self.step()
            return None
        """
    )
    test = _node(cfg, 4, flow.TEST)
    # `while True` has no fall-out edge: every path to the function
    # exit passes the `if self.done()` test
    assert cfg.dominates(test.idx, cfg.exit)


# -- generators ---------------------------------------------------------------


def test_yield_gets_a_raise_edge():
    cfg = _cfg(
        """
        def f(self, items):
            for it in items:
                yield it
        """
    )
    y = _node(cfg, 4)
    # a generator can be abandoned (GeneratorExit) or throw()-injected
    # at any suspension point
    assert _has_edge(cfg, y, cfg.nodes[cfg.raise_exit], flow.EXC)


# -- forward dataflow ---------------------------------------------------------


def test_dataflow_must_analysis_over_finally():
    cfg = _cfg(
        """
        def f(self):
            try:
                return self.work()
            finally:
                self.cleanup()
        """
    )
    cleanup = _node(cfg, 6)

    def transfer(node, state):
        return True if node.idx == cleanup.idx else state

    in_state = flow.forward_dataflow(
        cfg, init=False, transfer=transfer, join=lambda a, b: a and b
    )
    # every path to either exit ran the cleanup
    assert in_state[cfg.exit] is True
    assert in_state[cfg.raise_exit] is True


def test_dataflow_exception_edges_carry_their_own_state():
    cfg = _cfg(
        """
        def f(self):
            x = self.open()
            self.close(x)
        """
    )
    open_n = _node(cfg, 3)
    close_n = _node(cfg, 4)

    def transfer(node, state):
        if node.idx == open_n.idx:
            return "open"
        if node.idx == close_n.idx:
            return "closed"
        return state

    def transfer_exc(node, state):
        # the acquisition raising means nothing was acquired
        if node.idx == open_n.idx:
            return state
        return transfer(node, state)

    in_state = flow.forward_dataflow(
        cfg,
        init="none",
        transfer=transfer,
        transfer_exc=transfer_exc,
        join=lambda a, b: a if a == b else "mixed",
    )
    assert in_state[cfg.exit] == "closed"
    # raise-exit merges the failed-open ("none") and failed-close
    # ("open" via transfer on the close node's in-state) paths
    assert in_state[cfg.raise_exit] == "mixed"


def test_dominator_sets_basics():
    cfg = _cfg(
        """
        def f(self, x):
            a = self.one()
            if x:
                b = self.two()
            return a
        """
    )
    doms = cfg.dominators()
    for n, ds in doms.items():
        assert cfg.entry in ds
        assert n in ds


# -- package index / call graph -----------------------------------------------


UTIL_SRC = """\
def helper(x):
    return x + 1


def other(x):
    return helper(x)
"""

MAIN_SRC = """\
from k8s_spark_scheduler_tpu_torch import util


class Svc:
    def run(self, x):
        y = self.prep(x)
        return util.helper(y)

    def prep(self, x):
        return x * 2
"""


def _index():
    util_ctx = FileContext("util.py", UTIL_SRC, ast.parse(UTIL_SRC))
    main_ctx = FileContext("svc/main.py", MAIN_SRC, ast.parse(MAIN_SRC))
    return flow.PackageIndex([util_ctx, main_ctx])


def test_package_index_resolves_self_methods():
    index = _index()
    run = index.units[("svc/main.py", "Svc.run")]
    calls = index.calls_in(run)
    resolved = {
        index.resolve_call(c, run).qualname
        for c in calls
        if index.resolve_call(c, run) is not None
    }
    assert resolved == {"Svc.prep", "helper"}


def test_package_index_resolves_same_module_functions():
    index = _index()
    other = index.units[("util.py", "other")]
    (call,) = index.calls_in(other)
    target = index.resolve_call(call, other)
    assert target is not None and target.key == ("util.py", "helper")


def test_package_index_leaves_attribute_receivers_unresolved():
    index = _index()
    run = index.units[("svc/main.py", "Svc.run")]
    unresolved_ok = ast.parse("self._client.create(x)", mode="eval").body
    assert index.resolve_call(unresolved_ok, run) is None


def test_package_index_resolves_either_package_name():
    """Absolute imports resolve inside the analyzed tree under the port's
    name and the reference's (the parity runs read both trees)."""
    for package in ("k8s_spark_scheduler_tpu", "k8s_spark_scheduler_tpu_torch"):
        main = MAIN_SRC.replace("k8s_spark_scheduler_tpu_torch", package)
        index = flow.PackageIndex([
            FileContext("util.py", UTIL_SRC, ast.parse(UTIL_SRC)),
            FileContext("svc/main.py", main, ast.parse(main)),
        ])
        run = index.units[("svc/main.py", "Svc.run")]
        targets = [index.resolve_call(c, run) for c in index.calls_in(run)]
        assert {t.key for t in targets if t is not None} == {("svc/main.py", "Svc.prep"), ("util.py", "helper")}


# -- parity with the reference's flow ------------------------------------------


def _fixture_functions():
    """(id, source) of every function fixture in tests/test_flow.py: the
    dedented strings passed to ``_cfg`` and the call-graph sources."""
    path = os.path.join(REPO, "tests", "test_flow.py")
    tree = ast.parse(open(path).read())
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "_cfg"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            out.append((f"test_flow.py:{node.lineno}", textwrap.dedent(node.args[0].value)))
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.endswith("_SRC")
        ):
            out.append((f"test_flow.py:{node.targets[0].id}", node.value.value))
    return out


def _module_functions(relpath):
    """Every function and method of a reference module, as one source."""
    with open(os.path.join(REPO, "k8s_spark_scheduler_tpu", relpath)) as f:
        return [(f"k8s_spark_scheduler_tpu/{relpath}", f.read())]


CFG_CORPUS = _fixture_functions() + [
    entry for rel in ("concurrent/engine.py", "state/cache.py", "policy/preempt.py") for entry in _module_functions(rel)
]


def _functions(source):
    return [
        node for node in ast.walk(ast.parse(source))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def _shape(cfg):
    """A CFG normalized to what the rules read: node kinds and lines,
    edges with their kinds, dominator sets."""
    doms = cfg.dominators()
    return (
        [(n.kind, n.line) for n in cfg.nodes],
        [sorted(s) for s in cfg.succs],
        {n: sorted(ds) for n, ds in doms.items()},
        (cfg.entry, cfg.exit, cfg.raise_exit),
    )


def test_cfg_corpus_covers_the_fixtures_and_modules():
    # 13 CFG fixtures and the two call-graph sources
    assert len([c for c in CFG_CORPUS if c[0].startswith("test_flow.py")]) == 15
    n_functions = sum(len(_functions(source)) for _, source in CFG_CORPUS)
    assert n_functions >= 60, n_functions


@pytest.mark.parametrize("where,source", CFG_CORPUS, ids=[c[0] for c in CFG_CORPUS])
def test_cfgs_and_dominators_equal_the_reference(where, source):
    for func in _functions(source):
        ours, theirs = flow.build_cfg(func), ref_flow.build_cfg(func)
        assert _shape(ours) == _shape(theirs), (where, func.name, func.lineno)
        for a in range(len(ours.nodes)):
            for b in (ours.exit, ours.raise_exit):
                assert ours.dominates(a, b) == theirs.dominates(a, b), (where, func.name, a, b)


@pytest.mark.parametrize("where,source", CFG_CORPUS, ids=[c[0] for c in CFG_CORPUS])
def test_forward_dataflow_equals_the_reference(where, source):
    """A reaching-definitions-shaped dataflow (the set of statement lines
    a path has run, joined by union; exception edges without the raising
    node) reads the same in-states in both packages."""
    def transfer(node, state):
        return state | {node.line} if node.stmt is not None else state

    def join(a, b):
        return a | b

    for func in _functions(source):
        states = []
        for module in (flow, ref_flow):
            cfg = module.build_cfg(func)
            states.append(module.forward_dataflow(
                cfg, init=frozenset(), transfer=transfer, transfer_exc=lambda node, state: state, join=join,
            ))
        assert states[0] == states[1], (where, func.name)
