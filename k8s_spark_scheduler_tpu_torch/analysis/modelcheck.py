"""Systematic interleaving model checker for small concurrency scenarios.

The race detectors (:mod:`.racecheck`) observe whatever interleaving a
test happens to produce; this module *controls* the interleaving.  A
scenario's threads run under a cooperative scheduler: exactly one
thread executes at a time, and at every preemption point — each
:class:`~.racecheck.TrackedLock` acquire/release, each
:func:`~.racecheck.note_access` checkpoint, each explicit
:func:`checkpoint` — control returns to the scheduler, which decides
whether to continue the current thread or preempt it.  Schedules are
explored systematically (iterative DFS over untried decisions with a
bounded preemption count, the CHESS discipline) and then randomly from
a seed, so the same budget is spent first on the "few preemptions"
schedules that find most bugs and then on diversity.

Every explored schedule checks:

- the scenario's ``invariant`` (called at every scheduling point, while
  all threads are parked) and ``final`` (after quiescence);
- freedom from deadlock (no runnable thread, not all done — this is how
  a lost wakeup manifests);
- the race detectors: each schedule runs under a fresh
  :class:`~.racecheck.RaceDetector`, so a lockset/happens-before race or
  a lock-order cycle on ANY explored schedule fails the scenario.

A violation is returned as a :class:`Counterexample` carrying the exact
decision sequence and a formatted trace; :func:`replay` re-runs it
deterministically (same scenario + same schedule ⇒ same execution,
because only one thread ever runs at a time and scenario code is
required to be deterministic — no wall clock, no unseeded randomness;
schedlint's TS/DT rules enforce exactly this).

Scenario code synchronizing through anything other than a tracked lock
uses the cooperative primitives here: :class:`CoopEvent` (sticky, like
``threading.Event``) and :class:`CoopPulse` (memoryless notify — the
primitive whose misuse IS the classic lost wakeup).  Blocking on a raw
``threading.Event``/``queue.Queue`` inside a controlled thread would
hang the schedule; the run guard turns that into a loud
``stuck schedule`` failure rather than a silent CI timeout.

The scenario corpus over the scheduler's own guarded components lives
in :mod:`.mcscenarios`; ``python -m k8s_spark_scheduler_tpu_torch.analysis.modelcheck``
runs it (on CUDA unless ``--device cpu``: the capacity sampler's probes
run on the device under controlled interleavings).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from . import racecheck

# Per-run guard rails.  A schedule that exceeds them is reported as a
# failure (livelock / uncontrolled blocking), never silently dropped.
# The park timeout is WALL time and exists only to catch scenarios that
# block on untracked primitives — keep it generous: on a small shared
# host a concurrent test suite's compile storm can starve this process
# for tens of seconds, and a false "stuck schedule" is worse than a
# slow loud failure (livelock is caught by the step cap and deadlock by
# the blocked-thread check, neither of which is wall-time based).
DEFAULT_MAX_STEPS = 20_000
_PARK_TIMEOUT_S = 120.0


class _Abort(BaseException):
    """Raised inside controlled threads to unwind an abandoned run.
    BaseException so scenario code's ``except Exception`` can't eat it."""


class StuckSchedule(RuntimeError):
    """A controlled thread failed to reach a preemption point — almost
    always a blocking call on an untracked primitive inside a scenario."""


# ---------------------------------------------------------------------------
# Scenario definition
# ---------------------------------------------------------------------------


@dataclass
class Scenario:
    """One model-checked concurrency scenario.

    ``setup()`` builds fresh state per schedule; ``threads(state)``
    returns ``[(name, zero-arg callable), ...]``; ``invariant(state)``
    (optional) raises ``AssertionError`` on violation and is called at
    every scheduling point; ``final(state)`` (optional) runs after all
    threads finish."""

    name: str
    setup: Callable[[], object]
    threads: Callable[[object], Sequence[Tuple[str, Callable[[], None]]]]
    invariant: Optional[Callable[[object], None]] = None
    final: Optional[Callable[[object], None]] = None
    description: str = ""


@dataclass
class Counterexample:
    reason: str
    schedule: Tuple[int, ...]     # chosen runnable-index at each decision
    trace: Tuple[str, ...]        # one line per scheduling step
    schedule_index: int           # which explored schedule failed

    def __str__(self) -> str:
        lines = [f"counterexample ({self.reason})",
                 f"schedule: {list(self.schedule)}"]
        lines += [f"  {line}" for line in self.trace]
        return "\n".join(lines)


@dataclass
class ExploreResult:
    scenario: str
    schedules: int                # schedules fully executed
    decisions: int                # total scheduling decisions taken
    max_preemptions: int
    violation: Optional[Counterexample] = None

    @property
    def ok(self) -> bool:
        return self.violation is None


# ---------------------------------------------------------------------------
# Cooperative synchronization primitives for scenario code
# ---------------------------------------------------------------------------


class CoopEvent:
    """Sticky event (``threading.Event`` semantics) that parks under the
    cooperative scheduler instead of blocking the OS thread.  Outside a
    model-check run it degrades to a real Event."""

    def __init__(self):
        self._flag = False
        self._real = threading.Event()

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        self._real.set()
        run = _current_run()
        if run is not None:
            run.object_signaled(self)

    def wait(self) -> None:
        run = _current_run()
        if run is not None and run.controls_current_thread():
            while not self._flag:
                run.wait_for_object(self, "event")
            return
        self._real.wait()


class CoopPulse:
    """Memoryless notify: ``notify()`` wakes the threads waiting *right
    now* and is lost otherwise — the condition-variable pulse whose
    check-then-wait misuse is the textbook lost wakeup.  Only usable
    under the scheduler (a real memoryless wait cannot be emulated
    portably outside it)."""

    def notify(self) -> None:
        run = _current_run()
        if run is not None:
            run.object_signaled(self)

    def wait(self) -> None:
        run = _current_run()
        if run is None or not run.controls_current_thread():
            raise RuntimeError("CoopPulse.wait outside a model-check run")
        run.wait_for_object(self, "pulse")


def checkpoint(label: str = "checkpoint") -> None:
    """Explicit preemption point for scenario code between synchronized
    regions (tracked locks and note_access checkpoints yield already)."""
    run = _current_run()
    if run is not None and run.controls_current_thread():
        run.preempt(label)


# ---------------------------------------------------------------------------
# One schedule execution
# ---------------------------------------------------------------------------

_READY = "ready"
_RUNNING = "running"
_BLOCKED = "blocked"
_DONE = "done"


class _Cell:
    __slots__ = ("index", "name", "fn", "thread", "state", "waiting",
                 "label", "error", "locks_held")

    def __init__(self, index: int, name: str, fn: Callable[[], None]):
        self.index = index
        self.name = name
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.state = _READY
        self.waiting: Optional[object] = None   # lock/object blocked on
        self.label = "start"
        self.error: Optional[BaseException] = None
        self.locks_held = 0


# The per-thread run registry lives on the racecheck module, NOT here:
# under ``python -m …analysis.modelcheck`` THIS module is loaded twice
# (once as __main__, once canonically via mcscenarios' import), and two
# private ``threading.local()``s would split the registry — the _Run
# registers in one copy while CoopEvent.wait consults the other, gets
# None, and falls back to a REAL blocking wait that never yields (a
# phantom "stuck schedule" on correct code).  racecheck is imported by
# both copies as the same canonical module, so its attribute is shared.
_run_tls = racecheck._modelcheck_run_tls


def _current_run() -> Optional["_Run"]:
    return getattr(_run_tls, "run", None)


class _Run:
    """Executes one scenario under one schedule.  Doubles as the
    racecheck scheduler hook (set for the run's duration)."""

    def __init__(self, scenario: Scenario, forced: Sequence[int],
                 rng: Optional[random.Random], max_steps: int):
        self.scenario = scenario
        self.forced = list(forced)
        self.rng = rng                    # None ⇒ deterministic default policy
        self.max_steps = max_steps
        self._cv = threading.Condition()
        self._cells: List[_Cell] = []
        self._current: Optional[_Cell] = None
        self._abort = False
        self._last: Optional[_Cell] = None
        # per-decision record: (chosen index into runnable, runnable size,
        # default index — what the continue-current policy would pick —
        # and whether the previously-running cell was among the runnable,
        # i.e. whether a different choice costs a preemption)
        self.decisions: List[Tuple[int, int, int, bool]] = []
        self.trace: List[str] = []
        self.failure: Optional[str] = None
        self.detector: Optional[racecheck.RaceDetector] = None

    # -- hook protocol (called from controlled threads) -----------------------

    def controls_current_thread(self) -> bool:
        return getattr(_run_tls, "cell", None) is not None

    def preempt(self, label: str) -> None:
        cell: _Cell = _run_tls.cell
        self._park(cell, _READY, None, label)

    def wait_for_lock(self, lock) -> None:
        cell: _Cell = _run_tls.cell
        self._park(cell, _BLOCKED, lock, f"lock-wait:{lock.name}")

    def lock_acquired(self, lock) -> None:
        _run_tls.cell.locks_held += 1

    def lock_released(self, lock) -> None:
        cell: _Cell = _run_tls.cell
        if cell.locks_held > 0:
            cell.locks_held -= 1
        with self._cv:
            for c in self._cells:
                if c.state == _BLOCKED and c.waiting is lock:
                    c.state = _READY
                    c.waiting = None

    def wait_for_object(self, obj: object, kind: str) -> None:
        cell: _Cell = _run_tls.cell
        self._park(cell, _BLOCKED, obj, f"{kind}-wait")

    def object_signaled(self, obj: object) -> None:
        with self._cv:
            for c in self._cells:
                if c.state == _BLOCKED and c.waiting is obj:
                    c.state = _READY
                    c.waiting = None

    def _park(self, cell: _Cell, state: str, waiting: Optional[object],
              label: str) -> None:
        with self._cv:
            if self._abort:
                raise _Abort()
            cell.state = state
            cell.waiting = waiting
            cell.label = label
            self._current = None
            self._cv.notify_all()
            while self._current is not cell:
                if not self._cv.wait(timeout=_PARK_TIMEOUT_S):
                    raise StuckSchedule(
                        f"{self.scenario.name}: thread {cell.name} parked "
                        f"at {label} was never rescheduled"
                    )
            if self._abort:
                raise _Abort()
            cell.state = _RUNNING
            cell.waiting = None

    # -- thread bodies --------------------------------------------------------

    def _runner(self, cell: _Cell) -> None:
        _run_tls.run = self
        _run_tls.cell = cell
        try:
            # park until first scheduled
            with self._cv:
                while self._current is not cell:
                    if not self._cv.wait(timeout=_PARK_TIMEOUT_S):
                        raise StuckSchedule(
                            f"{self.scenario.name}: thread {cell.name} "
                            "never received its first slot"
                        )
                if self._abort:
                    raise _Abort()
                cell.state = _RUNNING
            cell.fn()
        except _Abort:
            pass
        except BaseException as exc:  # reported as the run's failure
            cell.error = exc
        finally:
            _run_tls.cell = None
            _run_tls.run = None
            with self._cv:
                cell.state = _DONE
                if self._current is cell:
                    self._current = None
                self._cv.notify_all()

    # -- scheduling -----------------------------------------------------------

    def _choose(self, runnable: List[_Cell]) -> _Cell:
        step = len(self.decisions)
        had_last = self._last is not None and self._last in runnable
        default_idx = runnable.index(self._last) if had_last else 0
        if step < len(self.forced):
            idx = self.forced[step] % len(runnable)
        elif self.rng is not None:
            # hybrid phase: bias toward staying on the current thread so
            # random schedules still resemble real executions
            if had_last and self.rng.random() < 0.6:
                idx = default_idx
            else:
                idx = self.rng.randrange(len(runnable))
        else:
            # deterministic default: keep running the same thread
            idx = default_idx
        self.decisions.append((idx, len(runnable), default_idx, had_last))
        return runnable[idx]

    def execute(self) -> None:
        """Run the schedule to completion; failures land in
        ``self.failure`` (+ ``self.trace``)."""
        prev_detector = racecheck.disable()
        self.detector = racecheck.enable(racecheck.RaceDetector())
        racecheck.set_sched_hook(self)
        try:
            state = self.scenario.setup()
            specs = list(self.scenario.threads(state))
            self._cells = [
                _Cell(i, name, fn) for i, (name, fn) in enumerate(specs)
            ]
            for cell in self._cells:
                cell.thread = threading.Thread(
                    target=self._runner, args=(cell,),
                    name=f"mc-{self.scenario.name}-{cell.name}", daemon=True,
                )
                cell.thread.start()
            self._orchestrate(state)
        finally:
            self._shutdown()
            racecheck.set_sched_hook(None)
            racecheck.disable()
            if prev_detector is not None:
                racecheck.enable(prev_detector)

    def _orchestrate(self, state: object) -> None:
        while True:
            with self._cv:
                while self._current is not None:
                    if not self._cv.wait(timeout=_PARK_TIMEOUT_S):
                        self.failure = (
                            "stuck schedule: running thread never yielded "
                            "(blocking call on an untracked primitive?)"
                        )
                        return
                runnable = [c for c in self._cells if c.state == _READY]
                done = all(c.state == _DONE for c in self._cells)
                # invariants may take component locks, so only check at
                # lock-quiescent points (no parked thread mid-critical-
                # section — otherwise the orchestrator would block on a
                # lock whose holder is parked)
                locks_quiescent = all(c.locks_held == 0 for c in self._cells)
            if done:
                break
            if (
                self.failure is None
                and locks_quiescent
                and self.scenario.invariant is not None
            ):
                try:
                    self._observe(self.scenario.invariant, state)
                except AssertionError as exc:
                    self.failure = f"invariant violated: {exc}"
                    return
            if not runnable:
                blocked = [
                    f"{c.name}({c.label})"
                    for c in self._cells
                    if c.state == _BLOCKED
                ]
                self.failure = (
                    "deadlock: no runnable thread; blocked: "
                    + (", ".join(blocked) or "<none>")
                )
                return
            if len(self.decisions) >= self.max_steps:
                self.failure = (
                    f"schedule exceeded {self.max_steps} steps (livelock?)"
                )
                return
            chosen = self._choose(runnable)
            self.trace.append(
                f"step {len(self.decisions) - 1}: run {chosen.name} "
                f"(at {chosen.label}; runnable "
                f"{[c.name for c in runnable]})"
            )
            with self._cv:
                self._last = chosen
                self._current = chosen
                self._cv.notify_all()
        # quiesced: thread errors, final check, then the race detectors
        for cell in self._cells:
            if cell.error is not None:
                self.failure = (
                    f"thread {cell.name} raised: {cell.error!r}"
                )
                return
        if self.scenario.final is not None:
            try:
                self._observe(self.scenario.final, state)
            except AssertionError as exc:
                self.failure = f"final check failed: {exc}"
                return
        det = self.detector
        if det is not None and not det.clean():
            self.failure = "race detected: " + "; ".join(det.report_lines())

    def _observe(self, check: Callable[[object], None], state: object) -> None:
        """Run an invariant/final check on the orchestrator thread with
        its detector bookkeeping QUARANTINED: the check may take
        component locks, and without the quarantine the orchestrator's
        cumulative vector clock would flow through every lock it
        touches, fabricating happens-before (and acquisition-graph)
        edges between scenario threads that mask real races."""
        det = self.detector
        if det is not None:
            det.quarantine_current_thread(True)
        try:
            check(state)
        finally:
            if det is not None:
                det.quarantine_current_thread(False)

    def _shutdown(self) -> None:
        """Unwind any still-live controlled threads (abandoned run)."""
        with self._cv:
            self._abort = True
            for c in self._cells:
                if c.state in (_READY, _BLOCKED):
                    c.state = _READY
            self._cv.notify_all()
        deadline_tries = 0
        for cell in self._cells:
            while cell.thread is not None and cell.thread.is_alive():
                with self._cv:
                    if cell.state == _DONE:
                        break
                    self._current = cell
                    self._cv.notify_all()
                cell.thread.join(timeout=0.05)
                deadline_tries += 1
                if deadline_tries > 200:
                    return  # daemon threads; give up rather than hang


# ---------------------------------------------------------------------------
# Exploration
# ---------------------------------------------------------------------------


def _preemption_count(decisions, upto: int,
                      alt: Optional[Tuple[int, int]] = None) -> int:
    """Preemptions in ``decisions[:upto]`` (+ one hypothetical ``alt`` =
    (step, idx)): a preemption is choosing a thread other than the one
    that was running while that one was still runnable."""
    count = 0
    for step, (idx, _n, default_idx, had_last) in enumerate(decisions[:upto]):
        if alt is not None and step == alt[0]:
            idx = alt[1]
        if had_last and idx != default_idx:
            count += 1
    return count


def explore(
    scenario: Scenario,
    max_schedules: int = 200,
    max_preemptions: int = 2,
    seed: int = 0,
    max_steps: int = DEFAULT_MAX_STEPS,
) -> ExploreResult:
    """Systematically explore interleavings of ``scenario``.

    Phase 1 (DFS): starting from the default schedule, branch on every
    untried decision whose preemption count stays within
    ``max_preemptions``.  Phase 2 (random): spend any remaining budget
    on seeded random schedules.  Stops at the first violation."""
    result = ExploreResult(
        scenario=scenario.name, schedules=0, decisions=0,
        max_preemptions=max_preemptions,
    )
    stack: List[List[int]] = [[]]
    visited = {()}
    rng_master = random.Random(seed)
    schedule_index = 0
    while schedule_index < max_schedules:
        if stack:
            forced = stack.pop()
            rng = None
        else:
            # hybrid tail: seeded random walks
            forced = []
            rng = random.Random(rng_master.randrange(2**63))
        run = _Run(scenario, forced, rng, max_steps)
        run.execute()
        result.schedules += 1
        result.decisions += len(run.decisions)
        if run.failure is not None:
            result.violation = Counterexample(
                reason=run.failure,
                schedule=tuple(d[0] for d in run.decisions),
                trace=tuple(run.trace),
                schedule_index=schedule_index,
            )
            return result
        if rng is None:
            # enqueue untried siblings along this run, deepest-first so
            # the DFS stays DFS-shaped
            for step in range(len(run.decisions) - 1, len(forced) - 1, -1):
                idx, n, _default_idx, had_last = run.decisions[step]
                for alt in range(n):
                    if alt == idx:
                        continue
                    if had_last and _preemption_count(
                        run.decisions, step + 1, (step, alt)
                    ) > max_preemptions:
                        continue
                    prefix = [d[0] for d in run.decisions[:step]]
                    prefix.append(alt)
                    key = tuple(prefix)
                    if key not in visited:
                        visited.add(key)
                        stack.append(prefix)
        schedule_index += 1
    return result


def replay(
    scenario: Scenario,
    schedule: Sequence[int],
    max_steps: int = DEFAULT_MAX_STEPS,
) -> Optional[Counterexample]:
    """Deterministically re-run one schedule (e.g. a counterexample's);
    returns the reproduced Counterexample, or None if it runs clean."""
    run = _Run(scenario, list(schedule), None, max_steps)
    run.execute()
    if run.failure is None:
        return None
    return Counterexample(
        reason=run.failure,
        schedule=tuple(d[0] for d in run.decisions),
        trace=tuple(run.trace),
        schedule_index=0,
    )


# ---------------------------------------------------------------------------
# CLI: run the scenario corpus (CI's model-check lane)
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json as _json
    import sys as _sys

    parser = argparse.ArgumentParser(
        prog="python -m k8s_spark_scheduler_tpu_torch.analysis.modelcheck",
        description="explore thread interleavings of the scheduler's "
        "guarded components and fail on any invariant violation, "
        "deadlock, or race on any schedule",
    )
    parser.add_argument("--schedules", type=int, default=1000,
                        help="schedules to explore per scenario")
    parser.add_argument("--preemptions", type=int, default=2,
                        help="DFS preemption bound")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--scenario", default=None,
                        help="run one scenario by name (default: all)")
    parser.add_argument("--json", default=None, metavar="FILE",
                        help="write a machine-readable summary")
    parser.add_argument("--device", default=None,
                        help="device of the scenarios' device components "
                        "(default: CUDA, which raises without a card)")
    args = parser.parse_args(argv)

    from .mcscenarios import corpus

    scenarios = corpus(device=args.device)
    if args.scenario is not None:
        scenarios = [s for s in scenarios if s.name == args.scenario]
        if not scenarios:
            print(f"unknown scenario: {args.scenario}", file=_sys.stderr)
            return 2

    summaries = []
    failed = False
    for sc in scenarios:
        res = explore(
            sc, max_schedules=args.schedules,
            max_preemptions=args.preemptions, seed=args.seed,
        )
        status = "ok" if res.ok else "VIOLATION"
        print(
            f"{sc.name:32s} {status:10s} "
            f"schedules={res.schedules} decisions={res.decisions}"
        )
        if not res.ok:
            failed = True
            print(str(res.violation))
        summaries.append({
            "scenario": sc.name,
            "ok": res.ok,
            "schedules": res.schedules,
            "decisions": res.decisions,
            "violation": (
                None if res.ok else {
                    "reason": res.violation.reason,
                    "schedule": list(res.violation.schedule),
                    "trace": list(res.violation.trace),
                }
            ),
        })
    if args.json:
        with open(args.json, "w") as f:
            _json.dump(
                {"seed": args.seed, "schedules": args.schedules,
                 "preemptions": args.preemptions, "results": summaries},
                f, indent=2, sort_keys=True,
            )
    return 1 if failed else 0


if __name__ == "__main__":
    import sys as _sys

    # dispatch through the CANONICAL module so every class/TLS the
    # scenarios touch is the same object this run uses (python -m loads
    # this file as __main__ AND as the package module)
    from k8s_spark_scheduler_tpu_torch.analysis.modelcheck import main as _canonical_main

    _sys.exit(_canonical_main())
