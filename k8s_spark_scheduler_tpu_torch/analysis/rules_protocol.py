"""PC — flow-sensitive protocol rules over :mod:`.flow` CFGs.

Concurrent admission, fencing and the intent journals make correctness
hinge on *protocol discipline* rather than any single call site.  These rules
prove the lifecycles hold on **every** path — including the exception
paths tests never take — by running typestate dataflow over the
per-function CFGs from :mod:`.flow`:

- **PC001** — a :class:`~..concurrent.commitgate.CommitGate` ticket is
  issued (``gate.ticket()``) but some path to the function's normal or
  raise exit never retires it.  A leaked ticket is a *permanent*
  head-of-line stall: every later ticket waits on it forever.
- **PC002** — a path may retire the same ticket twice (double-retire
  releases somebody else's turn).
- **PC003** — a kube-mutating call (CRD create/update/delete/patch on
  an api/client receiver) is reachable from a configured entry point
  without a dominating ``FencedWriter.check`` — computed
  *interprocedurally* over the intra-package call graph, so a fence
  check in the caller covers the callee and a fencing helper
  (``AsyncClient._pre_commit``) counts wherever it is called.
  The pervasive guarded idiom ``gate = self.fence_gate`` /
  ``if gate is not None: gate.check(op)`` is recognized and treated as
  an unconditional check (the protocol is "fenced when a fence is
  installed"; single-replica runs install none).
- **PC004** — a journal intent may be **acked on a path where its
  operation never executed**: ``record(); try: execute() finally:
  ack()`` acks the intent when ``execute`` raised, losing the replay
  *and* the effect (breaks the I-P4/J1 exactly-once contract).
  Exits in the recorded-but-unacked state are fine — that is "left
  pending", and recovery replays it.
- **PC005** — a manually opened span or lock (``x.__enter__()``,
  ``<lock>.acquire()``) has a path to an exit with no matching close
  (``__exit__``/``close``/``finish``/``release``).  ``with`` blocks are
  balanced by construction and exempt.
- **PC006** — a phase boundary (fifo-gate → binpack →
  reservation-writeback) is crossed without an intervening deadline
  check: an expired request must answer fail-fast at the boundary, not
  burn the solver's budget first.

Scope and deliberate imprecision
--------------------------------
* Typestate tracking keys on **local names** (tickets, spans, locks).
  A resource stored into ``self.*`` or returned escapes the
  intra-procedural discipline and is dropped — cross-method lifecycles
  (e.g. a server's root span) are out of scope by design.
* An acquisition that *raises* is modelled as not-acquired (RAII
  semantics); a close that raises is modelled as closed — otherwise no
  ``finally: close()`` could ever satisfy the rule.
* PC003 reports at the mutation site and names the entry point and
  call chain, so the fix target is the unfenced *path*, not the write.
* PC006 only fires inside functions that either arm a deadline check
  themselves or span two distinct phase families — a raw helper that
  wraps a single phase op is the callee side of the contract, not a
  boundary crossing.
* Entry points for PC003 default to :data:`DEFAULT_ENTRYPOINTS` and can
  be extended per file with ``# schedlint: entrypoints=Class.method``
  (used by rule fixtures).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from . import flow
from .core import FileContext, Finding

CATEGORY = "protocol"

# PC003 roots: the paths where a mutation escaping the fence protocol
# breaks I-H3.  Package-relative file → method qualnames.
DEFAULT_ENTRYPOINTS: Dict[str, Tuple[str, ...]] = {
    "scheduler/extender.py": ("SparkSchedulerExtender.predicate",),
    "policy/preempt.py": (
        "PreemptionCoordinator.commit",
        "PreemptionCoordinator.recover",
    ),
    "state/cache.py": (
        "AsyncClient._run_worker",
        "AsyncClient.replay_journal",
        "AsyncClient.nudge_recovery",
    ),
    "concurrent/engine.py": (
        "ConcurrentAdmissionEngine.predicate",
        "ConcurrentAdmissionEngine.submit_intent",
        "ConcurrentAdmissionEngine.make_intent",
    ),
}

_ENTRY_DIRECTIVE_RE = re.compile(
    r"#\s*schedlint:\s*entrypoints=([A-Za-z0-9_.]+(?:\s*,\s*[A-Za-z0-9_.]+)*)"
)

_MUTATING_ATTRS = {"create", "update", "delete", "patch", "replace"}
_CLOSE_ATTRS = {"__exit__", "close", "finish"}

_PHASE_CALL_FAMILIES = {
    "_try_device_fifo": "fifo-gate",
    "_fit_earlier_drivers": "fifo-gate",
    "create_reservations": "reservation-writeback",
}
_PHASE_SPAN_FAMILIES = {"binpack": "binpack"}
ANY_PHASE = "*"


def check(ctx: FileContext) -> List[Finding]:
    """Per-file hook kept for driver symmetry — PC rules need the whole
    file set (PC003 is interprocedural), so the work happens in
    :func:`check_package`."""
    return []


# ---------------------------------------------------------------------------
# lexical event extraction
# ---------------------------------------------------------------------------


def _attr_parts(expr: ast.expr) -> Optional[List[str]]:
    """``self.gate.retire`` → ["self", "gate", "retire"]; None when the
    chain contains anything but Names/Attributes."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def _is_gateish(comp: str) -> bool:
    return "gate" in comp.lower()


def _is_fenceish(recv: Sequence[str]) -> bool:
    last = recv[-1].lower()
    if "deadline" in last:
        return False
    return any(tok in last for tok in ("gate", "fence", "writer"))


def _is_journalish(recv: Sequence[str]) -> bool:
    return "journal" in recv[-1].lower()


def _is_clientish(recv: Sequence[str]) -> bool:
    last = recv[-1]
    stripped = last.lstrip("_")
    return (
        stripped in ("api", "client", "kube")
        or last.endswith("_api")
        or last.endswith("_client")
    )


def _is_deadlineish(recv: Sequence[str]) -> bool:
    return "deadline" in recv[-1].lower()


def _const_str(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr):
        return None  # dynamic op string arms every phase / fences its class
    return None


@dataclass
class _Event:
    kind: str  # see _events_for_call
    call: ast.Call
    var: Optional[str] = None  # tracked key (local name / dotted receiver)
    arg: Optional[str] = None  # op class / phase name


def _events_for_call(call: ast.Call) -> List[_Event]:
    func = call.func
    events: List[_Event] = []
    parts = _attr_parts(func)
    if parts is None or len(parts) < 2:
        return events
    attr, recv = parts[-1], parts[:-1]
    dotted = ".".join(recv)
    if attr == "ticket" and _is_gateish(recv[-1]):
        events.append(_Event("ticket-open", call))
    elif attr == "retire" and _is_gateish(recv[-1]):
        var = None
        if call.args and isinstance(call.args[0], ast.Name):
            var = call.args[0].id
        events.append(_Event("ticket-retire", call, var=var))
    elif attr == "check" and _is_deadlineish(recv) or (
        attr in ("_check_deadline", "check_deadline")
    ):
        phase = _const_str(call.args[0]) if call.args else None
        events.append(_Event("arm", call, arg=phase or ANY_PHASE))
    elif attr == "check" and _is_fenceish(recv):
        op = _const_str(call.args[0]) if call.args else None
        events.append(_Event("fence", call, arg=op or "*"))
    elif attr in _MUTATING_ATTRS and _is_clientish(recv):
        events.append(_Event("mutate", call, var=dotted + "." + attr))
    elif attr == "record" and _is_journalish(recv):
        events.append(_Event("record", call))
    elif attr == "ack" and _is_journalish(recv):
        events.append(_Event("ack", call))
    elif attr == "__enter__" and len(recv) == 1:
        events.append(_Event("open", call, var=recv[0]))
    elif attr in _CLOSE_ATTRS and len(recv) == 1:
        events.append(_Event("close", call, var=recv[0]))
    elif attr == "acquire" and "lock" in recv[-1].lower():
        events.append(_Event("open", call, var=dotted))
    elif attr == "release" and "lock" in recv[-1].lower():
        events.append(_Event("close", call, var=dotted))
    if attr in _PHASE_CALL_FAMILIES:
        events.append(
            _Event("phase", call, arg=_PHASE_CALL_FAMILIES[attr], var=attr)
        )
    return events


def _own_exprs(stmt: ast.AST, kind: str) -> List[ast.expr]:
    """The expressions evaluated *at this CFG node* (compound bodies are
    their own nodes)."""
    if kind == flow.WITH_EXIT:
        return []
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Match):
        return [stmt.subject]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    if isinstance(stmt, ast.ExceptHandler):
        return []
    return [stmt] if isinstance(stmt, ast.expr) else list(ast.iter_child_nodes(stmt))


def _calls_in_expr(expr: ast.AST) -> List[ast.Call]:
    out: List[ast.Call] = []

    def walk(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            out.append(node)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(expr)
    return out


def _guard_idiom_events(stmt: ast.If) -> List[_Event]:
    """``if gate is not None: gate.check(op)`` (or bare truthiness, no
    else) — the check is unconditional for protocol purposes."""
    if stmt.orelse:
        return []
    test = stmt.test
    guarded_ok = isinstance(test, (ast.Name, ast.Attribute)) or (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.IsNot)
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    )
    if not guarded_ok:
        return []
    events: List[_Event] = []
    for inner in stmt.body:
        if isinstance(inner, ast.Expr) and isinstance(inner.value, ast.Call):
            for ev in _events_for_call(inner.value):
                if ev.kind in ("fence", "arm"):
                    events.append(ev)
    return events


class _UnitEvents:
    """Per-CFG-node events + per-node resolvable calls for one unit."""

    def __init__(self, unit: flow.FunctionUnit, index: flow.PackageIndex):
        self.unit = unit
        self.cfg = unit.cfg()
        self.events: Dict[int, List[_Event]] = {}
        self.calls: Dict[int, List[ast.Call]] = {}
        self.ticket_opens: Dict[int, str] = {}  # node -> var bound by `v = gate.ticket()`
        self.escapes: Dict[int, Set[str]] = {}
        for node in self.cfg.nodes:
            if node.stmt is None:
                continue
            stmt = node.stmt
            evs: List[_Event] = []
            calls: List[ast.Call] = []
            if node.kind == flow.TEST and isinstance(stmt, ast.If):
                evs.extend(_guard_idiom_events(stmt))
            for expr in _own_exprs(stmt, node.kind):
                for call in _calls_in_expr(expr):
                    calls.append(call)
                    evs.extend(_events_for_call(call))
            # with items that open spans count as phase anchors
            if node.kind == flow.STMT and isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    c = item.context_expr
                    if isinstance(c, ast.Call):
                        p = _attr_parts(c.func)
                        if p and p[-1] in ("span", "child_span") and c.args:
                            name = _const_str(c.args[0])
                            if name in _PHASE_SPAN_FAMILIES:
                                evs.append(
                                    _Event(
                                        "phase",
                                        c,
                                        arg=_PHASE_SPAN_FAMILIES[name],
                                        var=f"span:{name}",
                                    )
                                )
            if node.kind != flow.TEST and isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                )
                value = stmt.value
                if (
                    value is not None
                    and isinstance(value, ast.Call)
                    and len(targets) == 1
                    and isinstance(targets[0], ast.Name)
                ):
                    for ev in _events_for_call(value):
                        if ev.kind == "ticket-open":
                            self.ticket_opens[node.idx] = targets[0].id
            esc = _escaping_names(stmt, node.kind)
            if esc:
                self.escapes[node.idx] = esc
            if evs:
                self.events[node.idx] = evs
            if calls:
                self.calls[node.idx] = calls

    def node_events(self, idx: int, *kinds: str) -> List[_Event]:
        return [e for e in self.events.get(idx, ()) if e.kind in kinds]


def _escaping_names(stmt: ast.AST, kind: str) -> Set[str]:
    """Local names this statement aliases, returns, yields or stores —
    tracked resources named here leave the function's custody, so the
    typestate rules stop tracking them.  Names that only appear as call
    *arguments* do not escape (passing a ticket to ``speculate`` does
    not transfer the retire obligation)."""

    def direct_names(expr: ast.AST) -> Set[str]:
        found: Set[str] = set()

        def walk(node: ast.AST) -> None:
            if isinstance(node, (ast.Call, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return
            if isinstance(node, ast.Name):
                found.add(node.id)
            for child in ast.iter_child_nodes(node):
                walk(child)

        walk(expr)
        return found

    if kind == flow.TEST:
        return set()
    out: Set[str] = set()
    if isinstance(stmt, ast.Return) and stmt.value is not None:
        out |= direct_names(stmt.value)
    elif isinstance(stmt, ast.Assign):
        # aliasing (`y = t`) or storing (`self.t = t`, `d[k] = t`);
        # names that only feed a call (`f(t)`) stay tracked
        out |= direct_names(stmt.value)
    elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, (ast.Yield, ast.YieldFrom)):
        if stmt.value.value is not None:
            out |= direct_names(stmt.value.value)
    return out


# ---------------------------------------------------------------------------
# PC001 / PC002 — ticket typestate
# ---------------------------------------------------------------------------

_ISSUED = "issued"
_RETIRED = "retired"

StateMap = Dict[str, FrozenSet[str]]


def _join_maps(a: StateMap, b: StateMap) -> StateMap:
    out = dict(a)
    for var, states in b.items():
        out[var] = out.get(var, frozenset()) | states
    return out


def _check_tickets(ue: _UnitEvents) -> List[Finding]:
    cfg, unit = ue.cfg, ue.unit
    if not any(
        e.kind in ("ticket-open", "ticket-retire")
        for evs in ue.events.values()
        for e in evs
    ):
        return []

    def apply(node: flow.Node, state: StateMap, on_raise: bool) -> StateMap:
        out = dict(state)
        for var in ue.escapes.get(node.idx, ()):
            out.pop(var, None)
        opened = ue.ticket_opens.get(node.idx)
        if opened is not None and not on_raise:
            # acquisition that raises never bound the name (RAII)
            out[opened] = frozenset({_ISSUED})
        for ev in ue.node_events(node.idx, "ticket-retire"):
            if ev.var is not None:
                # retire applies even on the raise edge: a retire that
                # itself raised cannot be meaningfully re-driven
                out[ev.var] = frozenset({_RETIRED})
        return out

    in_state = flow.forward_dataflow(
        cfg,
        init={},
        transfer=lambda n, s: apply(n, s, on_raise=False),
        transfer_exc=lambda n, s: apply(n, s, on_raise=True),
        join=_join_maps,
    )

    findings: List[Finding] = []
    open_lines: Dict[str, int] = {}
    for idx, var in ue.ticket_opens.items():
        open_lines.setdefault(var, cfg.nodes[idx].line)
    # PC002: retire may run on an already-retired ticket
    for idx, evs in sorted(ue.events.items()):
        state = in_state.get(idx)
        if state is None:
            continue
        for ev in evs:
            if ev.kind == "ticket-retire" and ev.var is not None:
                if _RETIRED in state.get(ev.var, frozenset()):
                    findings.append(
                        Finding(
                            rule="PC002",
                            category=CATEGORY,
                            file=unit.relpath,
                            line=cfg.nodes[idx].line,
                            col=ev.call.col_offset,
                            message=(
                                f"ticket '{ev.var}' may already be retired when "
                                "this retire runs (double-retire releases "
                                "someone else's commit turn)"
                            ),
                            symbol=unit.qualname,
                        )
                    )
    # PC001: a leak path to either exit
    for exit_idx, how in ((cfg.exit, "a fall-through"), (cfg.raise_exit, "an exception")):
        state = in_state.get(exit_idx)
        if not state:
            continue
        for var, states in sorted(state.items()):
            if _ISSUED in states:
                line = open_lines.get(var)
                if line is None:
                    continue  # ticket came from a parameter — caller owns it
                findings.append(
                    Finding(
                        rule="PC001",
                        category=CATEGORY,
                        file=unit.relpath,
                        line=line,
                        col=0,
                        message=(
                            f"ticket '{var}' issued here may never be retired on "
                            f"{how} path — a leaked CommitGate ticket stalls "
                            "the FIFO line forever; retire in a finally that "
                            "cannot be skipped"
                        ),
                        symbol=unit.qualname,
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# PC003 — fence dominance, interprocedural
# ---------------------------------------------------------------------------


class _FenceAnalysis:
    def __init__(self, index: flow.PackageIndex, events: Dict[Tuple[str, str], _UnitEvents]):
        self.index = index
        self.events = events
        self._fences_exit: Dict[Tuple[str, str], bool] = {}
        self._exposed: Dict[Tuple[str, str], List[Tuple[_Event, flow.FunctionUnit, Tuple[str, ...]]]] = {}

    # -- summaries ---------------------------------------------------------

    def fences_exit(self, unit: flow.FunctionUnit, stack: FrozenSet[Tuple[str, str]] = frozenset()) -> bool:
        """Does every normal completion of ``unit`` pass a fence check?"""
        key = unit.key
        if key in self._fences_exit:
            return self._fences_exit[key]
        if key in stack:
            return False
        ue = self.events.get(key)
        if ue is None:
            return False
        state = self._run_fence_flow(ue, stack | {key})
        result = bool(state.get(ue.cfg.exit, False))
        self._fences_exit[key] = result
        return result

    def _run_fence_flow(
        self, ue: _UnitEvents, stack: FrozenSet[Tuple[str, str]]
    ) -> Dict[int, bool]:
        def transfer(node: flow.Node, fenced: bool) -> bool:
            if fenced:
                return True
            if ue.node_events(node.idx, "fence"):
                return True
            for call in ue.calls.get(node.idx, ()):
                callee = self.index.resolve_call(call, ue.unit)
                if callee is not None and callee.key not in stack:
                    if self.fences_exit(callee, stack):
                        return True
            return False

        return flow.forward_dataflow(
            ue.cfg,
            init=False,
            transfer=transfer,
            join=lambda a, b: a and b,
        )

    # -- exposure ----------------------------------------------------------

    def exposed(
        self, unit: flow.FunctionUnit, stack: FrozenSet[Tuple[str, str]] = frozenset()
    ) -> List[Tuple[_Event, flow.FunctionUnit, Tuple[str, ...]]]:
        """Mutations reachable from ``unit``'s entry with no fence check
        on the way — each as (event, owning unit, call chain)."""
        key = unit.key
        if key in self._exposed:
            return self._exposed[key]
        if key in stack:
            return []
        ue = self.events.get(key)
        if ue is None:
            return []
        stack = stack | {key}
        fenced_in = self._run_fence_flow(ue, stack)
        out: List[Tuple[_Event, flow.FunctionUnit, Tuple[str, ...]]] = []
        for idx in sorted(ue.events.keys() | ue.calls.keys()):
            fenced = fenced_in.get(idx)
            if fenced is None or fenced:
                continue
            # replay this node's events/calls in lexical order: a fence
            # in the same statement covers mutations after it
            node_fenced = False
            for ev in ue.events.get(idx, ()):
                if ev.kind == "fence":
                    node_fenced = True
                elif ev.kind == "mutate" and not node_fenced:
                    out.append((ev, unit, (unit.qualname,)))
            if node_fenced:
                continue
            for call in ue.calls.get(idx, ()):
                callee = self.index.resolve_call(call, ue.unit)
                if callee is None or callee.key in stack:
                    continue
                if self.fences_exit(callee, stack):
                    continue
                for ev, owner, chain in self.exposed(callee, stack):
                    out.append((ev, owner, (unit.qualname,) + chain))
        self._exposed[key] = out
        return out


def _entrypoints_for(ctx: FileContext) -> List[str]:
    entries = list(DEFAULT_ENTRYPOINTS.get(ctx.relpath, ()))
    for m in _ENTRY_DIRECTIVE_RE.finditer(ctx.source):
        entries.extend(s.strip() for s in m.group(1).split(",") if s.strip())
    return entries


def _check_fencing(
    index: flow.PackageIndex,
    events: Dict[Tuple[str, str], _UnitEvents],
    contexts: Sequence[FileContext],
) -> List[Finding]:
    analysis = _FenceAnalysis(index, events)
    findings: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()
    for ctx in sorted(contexts, key=lambda c: c.relpath):
        for qualname in _entrypoints_for(ctx):
            unit = index.units.get((ctx.relpath, qualname))
            if unit is None:
                continue
            for ev, owner, chain in analysis.exposed(unit):
                site = (owner.relpath, ev.call.lineno, ev.var or "")
                if site in seen:
                    continue
                seen.add(site)
                via = " -> ".join(chain)
                findings.append(
                    Finding(
                        rule="PC003",
                        category=CATEGORY,
                        file=owner.relpath,
                        line=ev.call.lineno,
                        col=ev.call.col_offset,
                        message=(
                            f"kube-mutating call {ev.var} is reachable from "
                            f"entry point {qualname} (via {via}) without a "
                            "dominating FencedWriter.check — a deposed replica "
                            "could still write (violates I-H3)"
                        ),
                        symbol=owner.qualname,
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# PC004 — journal exactly-once
# ---------------------------------------------------------------------------

_J_NONE = "none"
_J_RECORDED = "recorded"
_J_EXECUTED = "executed"
_J_ACKED = "acked"


def _check_journal(
    ue: _UnitEvents, index: flow.PackageIndex, mutates: "_MutationSummary"
) -> List[Finding]:
    cfg, unit = ue.cfg, ue.unit
    has_record = any(
        e.kind == "record" for evs in ue.events.values() for e in evs
    )
    if not has_record:
        return []

    def is_execute(node_idx: int) -> bool:
        if any(e.kind == "mutate" for e in ue.events.get(node_idx, ())):
            return True
        for call in ue.calls.get(node_idx, ()):
            callee = index.resolve_call(call, unit)
            if callee is not None and mutates.any_mutation(callee):
                return True
        return False

    def apply(node: flow.Node, state: FrozenSet[str], on_raise: bool) -> FrozenSet[str]:
        out = set(state)
        for ev in ue.events.get(node.idx, ()):
            if ev.kind == "record":
                out = {_J_RECORDED}
            elif ev.kind == "ack":
                if _J_EXECUTED in out:
                    out.discard(_J_EXECUTED)
                    out.add(_J_ACKED)
                out.discard(_J_RECORDED)  # the violation is reported, then cleared
        if is_execute(node.idx):
            if _J_RECORDED in out:
                out.add(_J_EXECUTED)
                if not on_raise:
                    # on the normal edge the execute definitely ran
                    out.discard(_J_RECORDED)
                # on the raise edge both outcomes stay possible
        return frozenset(out)

    in_state = flow.forward_dataflow(
        cfg,
        init=frozenset({_J_NONE}),
        transfer=lambda n, s: apply(n, s, on_raise=False),
        transfer_exc=lambda n, s: apply(n, s, on_raise=True),
        join=lambda a, b: a | b,
    )

    findings: List[Finding] = []
    for idx, evs in sorted(ue.events.items()):
        state = in_state.get(idx)
        if state is None:
            continue
        for ev in evs:
            if ev.kind == "ack" and _J_RECORDED in state:
                findings.append(
                    Finding(
                        rule="PC004",
                        category=CATEGORY,
                        file=unit.relpath,
                        line=cfg.nodes[idx].line,
                        col=ev.call.col_offset,
                        message=(
                            "journal intent may be acked on a path where its "
                            "operation never executed — an exception between "
                            "record and execute must leave the intent pending "
                            "for replay, not ack it away (I-P4/J1 exactly-once)"
                        ),
                        symbol=unit.qualname,
                    )
                )
    return findings


class _MutationSummary:
    """Transitive "does this unit (or anything it calls) perform a
    kube mutation?" — PC004's notion of 'the operation executed'."""

    def __init__(self, index: flow.PackageIndex, events: Dict[Tuple[str, str], _UnitEvents]):
        self.index = index
        self.events = events
        self._memo: Dict[Tuple[str, str], bool] = {}

    def any_mutation(self, unit: flow.FunctionUnit, stack: FrozenSet[Tuple[str, str]] = frozenset()) -> bool:
        key = unit.key
        if key in self._memo:
            return self._memo[key]
        if key in stack:
            return False
        ue = self.events.get(key)
        if ue is None:
            return False
        stack = stack | {key}
        result = any(
            e.kind == "mutate" for evs in ue.events.values() for e in evs
        )
        if not result:
            for calls in ue.calls.values():
                for call in calls:
                    callee = self.index.resolve_call(call, unit)
                    if callee is not None and self.any_mutation(callee, stack):
                        result = True
                        break
                if result:
                    break
        self._memo[key] = result
        return result


# ---------------------------------------------------------------------------
# PC005 — span / lock open-close
# ---------------------------------------------------------------------------


def _check_spans(ue: _UnitEvents) -> List[Finding]:
    cfg, unit = ue.cfg, ue.unit
    opens = {
        e.var
        for evs in ue.events.values()
        for e in evs
        if e.kind == "open" and e.var is not None
    }
    if not opens:
        return []

    _OPEN, _CLOSED = "open", "closed"

    def apply(node: flow.Node, state: StateMap, on_raise: bool) -> StateMap:
        out = dict(state)
        for var in ue.escapes.get(node.idx, ()):
            out.pop(var, None)
        for ev in ue.events.get(node.idx, ()):
            if ev.kind == "open" and ev.var is not None:
                if not on_raise:  # an acquire that raised never held the lock
                    out[ev.var] = frozenset({_OPEN})
            elif ev.kind == "close" and ev.var in out:
                out[ev.var] = frozenset({_CLOSED})
        return out

    in_state = flow.forward_dataflow(
        cfg,
        init={},
        transfer=lambda n, s: apply(n, s, on_raise=False),
        transfer_exc=lambda n, s: apply(n, s, on_raise=True),
        join=_join_maps,
    )

    open_lines: Dict[str, int] = {}
    for idx, evs in sorted(ue.events.items()):
        for ev in evs:
            if ev.kind == "open" and ev.var is not None:
                open_lines.setdefault(ev.var, cfg.nodes[idx].line)

    findings: List[Finding] = []
    reported: Set[Tuple[str, str]] = set()
    for exit_idx, how in ((cfg.exit, "a fall-through"), (cfg.raise_exit, "an exception")):
        state = in_state.get(exit_idx)
        if not state:
            continue
        for var, states in sorted(state.items()):
            if _OPEN in states and (var, how) not in reported:
                reported.add((var, how))
                findings.append(
                    Finding(
                        rule="PC005",
                        category=CATEGORY,
                        file=unit.relpath,
                        line=open_lines.get(var, cfg.nodes[0].line or 1),
                        col=0,
                        message=(
                            f"'{var}' is opened here but {how} path reaches "
                            "the end of the function without closing it — use "
                            "`with` or close in a finally"
                        ),
                        symbol=unit.qualname,
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# PC006 — phase-boundary deadline checks
# ---------------------------------------------------------------------------


def _check_phases(ue: _UnitEvents) -> List[Finding]:
    cfg, unit = ue.cfg, ue.unit
    arms = any(e.kind == "arm" for evs in ue.events.values() for e in evs)
    families = {
        e.arg for evs in ue.events.values() for e in evs if e.kind == "phase"
    }
    # a helper wrapping a single phase family is the callee side of the
    # contract; the *crossing* happens where phases meet or arms exist
    if not families or (not arms and len(families) < 2):
        return []

    def apply(node: flow.Node, state: FrozenSet[str]) -> FrozenSet[str]:
        out = state
        for ev in ue.events.get(node.idx, ()):
            if ev.kind == "arm":
                out = frozenset({ev.arg or ANY_PHASE})
            elif ev.kind == "phase":
                # running an op keeps its own phase armed (consecutive
                # same-phase ops need one check), but a later different
                # phase must re-arm
                if ANY_PHASE not in out:
                    out = out | {ev.arg}
        return out

    in_state = flow.forward_dataflow(
        cfg,
        init=frozenset(),
        transfer=apply,
        join=lambda a, b: a & b,
    )

    findings: List[Finding] = []
    for idx, evs in sorted(ue.events.items()):
        state = in_state.get(idx)
        if state is None:
            continue
        armed = set(state)
        for ev in evs:
            if ev.kind == "arm":
                armed = {ev.arg or ANY_PHASE}
            elif ev.kind == "phase":
                if ev.arg not in armed and ANY_PHASE not in armed:
                    findings.append(
                        Finding(
                            rule="PC006",
                            category=CATEGORY,
                            file=unit.relpath,
                            line=cfg.nodes[idx].line,
                            col=ev.call.col_offset,
                            message=(
                                f"phase op '{ev.var}' ({ev.arg}) runs without "
                                "an armed deadline check for this boundary — "
                                "re-check the request deadline when crossing "
                                "fifo-gate -> binpack -> reservation-writeback"
                            ),
                            symbol=unit.qualname,
                        )
                    )
                armed.add(ev.arg)
    return findings


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def check_package(contexts: Sequence[FileContext]) -> List[Finding]:
    """Run the PC family over the whole analyzed file set."""
    contexts = [c for c in contexts if c.tree is not None]
    index = flow.PackageIndex(contexts)
    events: Dict[Tuple[str, str], _UnitEvents] = {}
    for key, unit in index.units.items():
        events[key] = _UnitEvents(unit, index)

    findings: List[Finding] = []
    mutation_summary = _MutationSummary(index, events)
    for key in sorted(events):
        ue = events[key]
        findings.extend(_check_tickets(ue))
        findings.extend(_check_journal(ue, index, mutation_summary))
        findings.extend(_check_spans(ue))
        findings.extend(_check_phases(ue))
    findings.extend(_check_fencing(index, events, contexts))
    return findings
