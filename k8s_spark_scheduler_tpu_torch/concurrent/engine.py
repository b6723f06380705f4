"""The concurrent admission engine: speculate in parallel, commit FIFO
(the reference package's ``concurrent/engine.py``).

:meth:`ConcurrentAdmissionEngine.predicate` is a drop-in for
``SparkSchedulerExtender.predicate`` (the HTTP layer and the harness
route through it when ``concurrent.enabled``).  Per request:

1. a FIFO ticket is issued at arrival (the commit order);
2. the speculative solve runs on the request's own thread, outside any
   lock, its kernel on the thread's own CUDA stream on the card
   (:mod:`.speculation`);
3. the request waits its turn at the commit gate (:mod:`.commitgate`),
   re-checks its deadline at gate entry (expired requests abandon their
   speculative work and answer fail-fast without ever taking the
   predicate lock), then executes the *serial* extender with the
   verdict installed as the ``speculation_intake`` hook — the extender
   revalidates (seq → memcmp → conflict) inside the predicate lock and
   either consumes the verdict or re-solves on the warm delta path.

Because commits are the unchanged serial extender run strictly in
ticket order, the decision stream is byte-identical to a serial run of
the same workload.

Crash points (swept by the HA crash matrix) bracket the
speculation→commit window: ``concurrent.speculation-solved`` after the
speculative solve, ``concurrent.commit-revalidated`` after the gate
admits the commit (verdict revalidation about to execute under the
lock), ``concurrent.commit-written`` after the write-back returned but
before the response leaves — exactly-once reservation state across a
cold restart is the matrix's audit.

Multi-active: a standby replica speculates against its own warm basis
(:meth:`make_intent`) and forwards a
:class:`~.commitgate.CommitIntent`; the committer
(:meth:`submit_intent`) refuses intents stamped with a stale fencing
epoch before they reach the gate — and the
:class:`~..ha.fencing.FencedWriter` on the write-back path refuses the
actual write by construction even if one slipped through."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..analysis.guarded import guarded_by
from ..ha import crashpoint
from ..ha.fencing import StaleEpochError
from ..metrics import names as mnames
from ..metrics.registry import MetricsRegistry, default_registry
from ..resilience import deadline as req_deadline
from ..scheduler.extender import FAILURE_DEADLINE
from .commitgate import CommitGate, CommitIntent
from .speculation import Speculator


@guarded_by("_stats_lock", "_commit_results")
class ConcurrentAdmissionEngine:
    """Speculation layer + FIFO commit gate over the serial extender."""

    def __init__(
        self,
        extender,
        config,
        metrics: MetricsRegistry | None = None,
        epoch_source: Optional[Callable[[], int]] = None,
    ):
        self._extender = extender
        self._config = config
        self._metrics = metrics or default_registry
        # the fencing-epoch reader (HA wiring); None on single-replica
        self._epoch_source = epoch_source
        self.gate = CommitGate()
        self.speculator = Speculator(
            extender, metrics=self._metrics,
            max_inflight=config.max_inflight_speculations,
        )
        self._stats_lock = threading.Lock()
        self._commit_results: Dict[str, int] = {}

    # -- stats ------------------------------------------------------------

    def _note_commit(self, result: str) -> None:
        self._metrics.counter(
            mnames.CONCURRENT_COMMIT_RESULT, {"result": result}
        )
        if result in ("conflict", "queue-drift", "skip-drift", "candidate-drift"):
            self._metrics.counter(mnames.CONCURRENT_COMMIT_CONFLICTS)
        with self._stats_lock:
            self._commit_results[result] = self._commit_results.get(result, 0) + 1

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            results = dict(self._commit_results)
        return {
            "gate": self.gate.stats(),
            "commit_results": results,
            "inflight_speculations": self.speculator.inflight(),
        }

    # -- the request path -------------------------------------------------

    def predicate(
        self,
        args,
        ticket: Optional[int] = None,
        post_commit: Optional[Callable[[Any], None]] = None,
        verdict=None,
    ):
        """Concurrent Filter: speculate, then commit in FIFO order.

        ``ticket`` lets a caller pre-assign the FIFO slot (the tests
        issue tickets in workload order before fanning requests across
        threads); ``post_commit`` runs inside the commit turn, after the
        decision — the deterministic stand-in for the kube bind that
        follows a granted Filter."""
        if ticket is None:
            ticket = self.gate.ticket()
        committed = False
        try:
            if verdict is None and self._config.speculation:
                verdict = self.speculator.speculate(ticket, args)
            crashpoint.maybe_crash(crashpoint.CONCURRENT_SPECULATION_SOLVED)

            # commit-gate entry: the deadline is checked HERE, not only
            # at the extender's phase boundaries — an expired request
            # abandons its speculative work and never takes the lock
            try:
                req_deadline.check("commit-gate")
            except req_deadline.DeadlineExceeded as err:
                if verdict is not None:
                    self._metrics.counter(
                        mnames.CONCURRENT_SPECULATION_CANCELLED,
                        {"phase": "commit-gate"},
                    )
                self._metrics.counter(
                    mnames.RESILIENCE_DEADLINE_EXPIRED_COUNT,
                    {"phase": "commit-gate"},
                )
                return self._extender._fail_with_message(
                    FAILURE_DEADLINE, args, str(err)
                )

            t0 = time.perf_counter()
            self.gate.await_turn(ticket)
            self._metrics.histogram(
                mnames.CONCURRENT_TICKET_WAIT_TIME, time.perf_counter() - t0
            )
            self._metrics.gauge(
                mnames.CONCURRENT_INFLIGHT, self.speculator.inflight()
            )
            crashpoint.maybe_crash(crashpoint.CONCURRENT_COMMIT_REVALIDATED)
            result = self._commit(args, verdict)
            committed = True
            crashpoint.maybe_crash(crashpoint.CONCURRENT_COMMIT_WRITTEN)
            if post_commit is not None:
                post_commit(result)
            return result
        finally:
            # retire must be unskippable: if finish() ever raised, a
            # skipped retire would stall the FIFO line forever
            try:
                self.speculator.finish(ticket)
            finally:
                self.gate.retire(ticket, committed)

    def _commit(self, args, verdict):
        """Execute the serial extender under this ticket's turn, with
        the speculative verdict (if any) installed as the revalidation
        intake.  Only one commit runs at a time (the gate guarantees
        it), so the hook handoff on the shared extender is single-
        writer by construction."""
        if verdict is None:
            self._note_commit("serial")
            return self._extender.predicate(args)

        def intake(driver, snap, node_names, earlier_apps, skip_allowed, current):
            served, reason = verdict.consume(
                driver, snap, node_names, earlier_apps, skip_allowed
            )
            if served is not None and verdict.artifacts is not None:
                # replay the speculative solve's artifacts into the
                # decision's provenance window so the refusal message
                # enrichment (shortfall explain) and the lane tag match
                # a serial solve byte-for-byte; their device tensors
                # move to this thread's stream first
                prov = self._extender._provenance
                if prov is not None and prov.enabled:
                    verdict.hand_over()
                    prov.capture(verdict.artifacts)
            self._note_commit(reason)
            return served

        self._extender.speculation_intake = intake
        try:
            return self._extender.predicate(args)
        finally:
            self._extender.speculation_intake = None

    # -- multi-active intents ---------------------------------------------

    def make_intent(self, args, origin: str = "") -> CommitIntent:
        """Standby side: speculate against the local warm basis and wrap
        the verdict as a commit intent stamped with the fencing epoch it
        was served under."""
        ticket = self.gate.ticket()
        try:
            verdict = (
                self.speculator.speculate(ticket, args)
                if self._config.speculation
                else None
            )
        finally:
            try:
                self.speculator.finish(ticket)
            finally:
                self.gate.retire(ticket, False)
        epoch = self._epoch_source() if self._epoch_source is not None else 0
        return CommitIntent(
            pod_name=args.pod.name,
            namespace=args.pod.namespace,
            epoch=epoch,
            args=args,
            verdict=verdict,
            origin=origin,
        )

    def submit_intent(self, intent: CommitIntent):
        """Committer side: refuse intents from a stale leadership epoch,
        then run the forwarded request through the normal FIFO commit
        path (the verdict revalidates exactly like a local one)."""
        if self._epoch_source is not None:
            current = self._epoch_source()
            if intent.epoch != current:
                self._metrics.counter(
                    mnames.CONCURRENT_INTENTS_FORWARDED,
                    {"result": "stale-epoch"},
                )
                raise StaleEpochError(
                    f"concurrent.commit-intent {intent.namespace}/{intent.pod_name}",
                    intent.epoch,
                    current,
                )
        self._metrics.counter(
            mnames.CONCURRENT_INTENTS_FORWARDED, {"result": "committed"}
        )
        return self.predicate(intent.args, verdict=intent.verdict)
