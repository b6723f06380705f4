"""Gang lifecycle ledger: per-application state machine + drain loop.

Every Spark application is tracked through
``submitted → queued → solving → reserved → bound → running →
completed | evicted | expired`` with first-arrival timestamps per
phase and queue-wait and solve-tenure durations.

Feeding never happens under the predicate lock (the capacity
observatory's pattern):

- informer handlers (pod add/update/delete, reservation add) run on
  API/informer threads and record phase transitions directly;
- everything that originates inside the predicate
  (``application_scheduled`` events, completed predicate traces) is
  drained by cursor off-thread: the background thread parks on wakeup
  Events attached to the EventLog and the tensor-mirror ChangeFeed,
  debounces, and pulls ``events_since``/``completed_since``.

``drain`` refuses to run while the calling thread holds the predicate
lock (``in_predicate_lock``), counting ``lock_violations``, which
must stay zero.

The reference also drains a policy engine's evictions and DRF shares
and stamps each transition with the HA epoch; this package has neither
a policy engine (ROADMAP A.6.5) nor HA (A.6.6), so no gang is ever
evicted or spans epochs here, and the bodies carry the reference's keys
with those parts empty.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import timesource
from ..capacity import in_predicate_lock

logger = logging.getLogger(__name__)

PHASES: Tuple[str, ...] = (
    "submitted",
    "queued",
    "solving",
    "reserved",
    "bound",
    "running",
    "completed",
    "evicted",
    "expired",
    # admission-gate shed: terminal for the Filter ATTEMPT (the request
    # answered fail-fast without a solve), but revivable — kube-scheduler
    # retries Pending pods, and the retry re-enters the lifecycle
    "shed",
)
TERMINAL = frozenset(("completed", "evicted", "expired", "shed"))
_PHASE_RANK = {p: i for i, p in enumerate(PHASES)}


@dataclass
class GangRecord:
    app_id: str
    namespace: str = ""
    driver_pod: str = ""
    instance_group: str = ""
    phase: str = "submitted"
    # first time each phase was reached (timesource)
    phase_times: Dict[str, float] = field(default_factory=dict)
    min_executors: int = 0
    max_executors: int = 0
    executors_bound: int = 0
    queue_wait_s: Optional[float] = None
    solve_count: int = 0
    solve_tenure_s: float = 0.0
    # most recent scheduling-request traces touching this gang
    trace_ids: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "app": self.app_id,
            "namespace": self.namespace,
            "driverPod": self.driver_pod,
            "instanceGroup": self.instance_group,
            "phase": self.phase,
            "phaseTimes": {
                p: round(t, 6) for p, t in self.phase_times.items()
            },
            "minExecutors": self.min_executors,
            "maxExecutors": self.max_executors,
            "executorsBound": self.executors_bound,
            "queueWaitSeconds": (
                None
                if self.queue_wait_s is None
                else round(self.queue_wait_s, 6)
            ),
            "solveCount": self.solve_count,
            "solveTenureSeconds": round(self.solve_tenure_s, 6),
            "evictionCause": "",  # no policy engine evicts here
            "traceIds": list(self.trace_ids),
            "epochs": [],  # no HA epochs here
        }


class LifecycleLedger:
    """See module docstring.  Thread model: informer handlers and the
    drain path both take the ledger lock per transition; whole drains
    are serialized by ``_drain_mutex`` (never taken on a scheduling
    path)."""

    def __init__(
        self,
        event_log=None,
        tracer=None,
        feed=None,
        slo=None,
        metrics=None,
        ring_size: int = 2048,
        debounce_seconds: float = 0.05,
        interval_seconds: float = 5.0,
    ):
        self._event_log = event_log
        self._tracer = tracer
        self._feed = feed
        self._slo = slo
        self._metrics = metrics
        self.ring_size = int(ring_size)
        self.debounce_seconds = float(debounce_seconds)
        self.interval_seconds = float(interval_seconds)

        self._lock = threading.Lock()
        # serializes whole drains (cursor reads → marks → evaluate):
        # the HTTP freshen path and the background thread may pass
        # maybe_drain's gate together
        self._drain_mutex = threading.Lock()
        self._records: Dict[str, GangRecord] = {}
        self._order: deque = deque()  # app ids, insertion order
        self._by_driver: Dict[str, str] = {}  # driver pod name → app id
        self._queue_waits: deque = deque(maxlen=ring_size)
        self._transitions = 0
        self._stats = {
            "drains": 0,
            "skipped_unchanged": 0,
            "lock_violations": 0,
        }

        # drain cursors
        self._event_seq = 0
        self._trace_cursor = 0
        self._last_gate: Tuple = ()

        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for source in (event_log, feed):
            if source is not None and hasattr(source, "attach_wakeup"):
                source.attach_wakeup(self._wake)

    # -- wiring ---------------------------------------------------------------

    def wire_informers(self, pod_informer=None, rr_informer=None) -> None:
        """Register informer handlers (wiring time).  Handlers run on
        API/informer threads — never under the predicate lock."""
        from ..scheduler import labels as L

        if pod_informer is not None:
            pod_informer.add_event_handler(
                on_add=self._on_pod_add,
                on_update=self._on_pod_update,
                on_delete=self._on_pod_delete,
                filter_func=L.is_spark_scheduler_pod,
            )
        if rr_informer is not None:
            rr_informer.add_event_handler(on_add=self._on_reservation)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="lifecycle-ledger"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            fired = self._wake.wait(timeout=self.interval_seconds)
            if self._stop.is_set():
                return
            if fired:
                self._wake.clear()
                # debounce: one drain for a burst of emits
                if self.debounce_seconds > 0:
                    time.sleep(self.debounce_seconds)
                self._wake.clear()
            try:
                self.maybe_drain(trigger="feed" if fired else "interval")
            except Exception:
                logger.exception("lifecycle drain failed (diagnostic only)")

    # -- informer handlers (API threads; off the predicate lock) -------------

    def _on_pod_add(self, pod) -> None:
        from ..scheduler import labels as L

        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        if not app_id:
            return
        role = pod.labels.get(L.SPARK_ROLE_LABEL, "")
        now = timesource.now()
        if role == L.DRIVER:
            with self._lock:
                record = self._record_locked(app_id, now)
                record.namespace = pod.namespace
                record.driver_pod = pod.name
                self._by_driver[pod.name] = app_id
                self._advance_locked(record, "queued", now)
            if pod.node_name:
                self._mark_bound(app_id, now)
        elif role == L.EXECUTOR and pod.node_name:
            self._mark_executor_bound(app_id, now)

    def _on_pod_update(self, old, new) -> None:
        from ..scheduler import labels as L

        if not L.on_pod_scheduled(old, new):
            return
        app_id = new.labels.get(L.SPARK_APP_ID_LABEL, "")
        if not app_id:
            return
        now = timesource.now()
        if new.labels.get(L.SPARK_ROLE_LABEL) == L.DRIVER:
            self._mark_bound(app_id, now)
        else:
            self._mark_executor_bound(app_id, now)

    def _on_pod_delete(self, pod) -> None:
        from ..scheduler import labels as L

        if pod.labels.get(L.SPARK_ROLE_LABEL) != L.DRIVER:
            return
        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        if not app_id:
            return
        now = timesource.now()
        with self._lock:
            record = self._records.get(app_id)
            if record is None or record.phase in TERMINAL:
                return
            # a driver that dies after binding completed its run; one
            # that vanishes still queued expired
            terminal = (
                "completed"
                if record.phase in ("bound", "running")
                else "expired"
            )
            self._advance_locked(record, terminal, now)

    def _on_reservation(self, rr) -> None:
        # ResourceReservation name == app id (reservations_manager)
        app_id = getattr(rr, "name", "")
        if not app_id:
            return
        now = timesource.now()
        with self._lock:
            record = self._records.get(app_id)
            if record is None:
                record = self._record_locked(app_id, now)
                record.namespace = getattr(rr, "namespace", "")
            self._advance_locked(record, "reserved", now)

    # -- transition plumbing --------------------------------------------------

    def _record_locked(self, app_id: str, now: float) -> GangRecord:
        record = self._records.get(app_id)
        if record is not None:
            return record
        record = GangRecord(app_id=app_id)
        record.phase_times["submitted"] = now
        self._records[app_id] = record
        self._order.append(app_id)
        while len(self._order) > self.ring_size:
            self._evict_one_locked()
        return record

    def _evict_one_locked(self) -> None:
        """Drop the oldest terminal record (or the oldest outright when
        every record is live) to bound memory."""
        for app_id in list(self._order):
            record = self._records.get(app_id)
            if record is None or record.phase in TERMINAL:
                self._order.remove(app_id)
                if record is not None:
                    self._records.pop(app_id, None)
                    self._by_driver.pop(record.driver_pod, None)
                return
        app_id = self._order.popleft()
        record = self._records.pop(app_id, None)
        if record is not None:
            self._by_driver.pop(record.driver_pod, None)

    def _advance_locked(self, record: GangRecord, phase: str, now: float) -> bool:
        """Move ``record`` to ``phase`` if that is forward progress.
        Stamps first-arrival time; returns True when a transition
        happened."""
        current = record.phase
        if phase == current:
            return False
        # "shed" is the one escapable terminal: the gang was never
        # admitted, so a retried Filter revives it into the live phases
        revival = current == "shed" and phase not in TERMINAL
        if _PHASE_RANK[phase] < _PHASE_RANK[current] and not revival:
            # drains lag the informer path, so an earlier phase (e.g.
            # "solving" off the event log) can arrive after "bound" was
            # observed live — record its first-arrival time without
            # moving the state machine backwards
            if phase not in TERMINAL and current not in TERMINAL:
                record.phase_times.setdefault(phase, now)
            return False
        if current in TERMINAL and not revival:
            return False
        record.phase = phase
        record.phase_times.setdefault(phase, now)
        self._transitions += 1
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(
                mnames.LIFECYCLE_TRANSITIONS,
                tags={mnames.TAG_PHASE: phase},
            )
        return True

    def _mark_bound(self, app_id: str, now: float) -> None:
        with self._lock:
            record = self._records.get(app_id)
            if record is None:
                record = self._record_locked(app_id, now)
            if self._advance_locked(record, "bound", now):
                submitted = record.phase_times.get("submitted", now)
                record.queue_wait_s = max(0.0, now - submitted)
                self._queue_waits.append(record.queue_wait_s)
                queue_wait = record.queue_wait_s
            else:
                queue_wait = None
            # a gang with no minimum (or already-satisfied minimum) is
            # running as soon as its driver binds
            if (
                record.phase == "bound"
                and record.executors_bound >= record.min_executors
            ):
                self._advance_locked(record, "running", now)
        if queue_wait is not None:
            if self._slo is not None:
                self._slo.observe("time_to_admit", queue_wait, t=now)
            if self._metrics is not None:
                from ..metrics import names as mnames

                self._metrics.histogram(
                    mnames.LIFECYCLE_QUEUE_WAIT, queue_wait
                )

    def _mark_executor_bound(self, app_id: str, now: float) -> None:
        with self._lock:
            record = self._records.get(app_id)
            if record is None:
                return
            record.executors_bound += 1
            if (
                record.phase == "bound"
                and record.executors_bound >= max(record.min_executors, 1)
            ):
                self._advance_locked(record, "running", now)

    def mark_shed(self, pod) -> None:
        """An AdmissionGate shed answered this gang's Filter without a
        solve — record the verdict so shed gangs are visible in the
        ledger instead of silently vanishing.  Terminal for the attempt
        only: kube-scheduler retries Pending pods, and the retry's next
        transition revives the record out of ``shed``."""
        from ..scheduler import labels as L

        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        if not app_id:
            return
        now = timesource.now()
        with self._lock:
            record = self._record_locked(app_id, now)
            if not record.namespace:
                record.namespace = pod.namespace
            if (
                pod.labels.get(L.SPARK_ROLE_LABEL) == L.DRIVER
                and not record.driver_pod
            ):
                record.driver_pod = pod.name
                self._by_driver[pod.name] = app_id
            self._advance_locked(record, "shed", now)

    # -- drain (cursor consumers; never under the predicate lock) -------------

    def _gate(self) -> Tuple:
        ev = self._event_log.seq if self._event_log is not None else 0
        tr = (
            self._tracer.completed_total
            if self._tracer is not None
            and hasattr(self._tracer, "completed_total")
            else 0
        )
        with self._lock:
            transitions = self._transitions
        return (ev, tr, transitions)

    def maybe_drain(self, trigger: str = "feed") -> Optional[Dict[str, Any]]:
        """Drain iff any cursor source moved since the last drain —
        O(1) when nothing changed."""
        gate = self._gate()
        if gate == self._last_gate:
            with self._lock:
                self._stats["skipped_unchanged"] += 1
            return None
        return self.drain(trigger=trigger)

    def drain(self, trigger: str = "manual") -> Optional[Dict[str, Any]]:
        """Pull every cursor source forward and re-evaluate the SLOs.
        Refuses (and counts) when called while the predicate lock is
        held — the ledger must add zero work there."""
        if in_predicate_lock():
            with self._lock:
                self._stats["lock_violations"] += 1
            return None
        with self._drain_mutex:
            gate = self._gate()
            self._drain_events()
            self._drain_traces()
            now = timesource.now()
            if self._slo is not None:
                self._slo.evaluate(now=now)
            self._last_gate = gate
            with self._lock:
                self._stats["drains"] += 1
            if self._metrics is not None:
                self._publish_gauges()
        return self.summary()

    def _drain_events(self) -> None:
        if self._event_log is None:
            return
        from ..events import events as ev

        fresh, self._event_seq = self._event_log.events_since(
            self._event_seq
        )
        for event in fresh:
            if event.name != ev.APPLICATION_SCHEDULED:
                continue
            values = event.values
            app_id = values.get("sparkAppID", "")
            if not app_id:
                continue
            with self._lock:
                record = self._record_locked(app_id, event.timestamp)
                record.namespace = values.get(
                    "podNamespace", record.namespace
                )
                record.driver_pod = values.get("podName", record.driver_pod)
                record.instance_group = values.get(
                    "instanceGroup", record.instance_group
                )
                record.min_executors = int(values.get("minExecutorCount", 0))
                record.max_executors = int(values.get("maxExecutorCount", 0))
                if record.driver_pod:
                    self._by_driver[record.driver_pod] = app_id
                self._advance_locked(record, "solving", event.timestamp)
                if event.trace_id and event.trace_id not in record.trace_ids:
                    record.trace_ids.append(event.trace_id)
                    del record.trace_ids[:-8]

    def _drain_traces(self) -> None:
        if self._tracer is None or not hasattr(
            self._tracer, "completed_since"
        ):
            return
        fresh, self._trace_cursor = self._tracer.completed_since(
            self._trace_cursor
        )
        for trace in fresh:
            duration_s = trace.get("durationMs", 0.0) / 1000.0
            if self._slo is not None:
                self._slo.observe(
                    "filter_latency",
                    duration_s,
                    t=trace.get("startTime", 0.0) + duration_s,
                )
            pod = trace.get("root", {}).get("tags", {}).get("pod", "")
            if not pod:
                continue
            with self._lock:
                app_id = self._by_driver.get(pod)
                record = (
                    self._records.get(app_id) if app_id is not None else None
                )
                if record is None:
                    continue
                record.solve_count += 1
                record.solve_tenure_s += duration_s
                trace_id = trace.get("traceId", "")
                if trace_id and trace_id not in record.trace_ids:
                    record.trace_ids.append(trace_id)
                    del record.trace_ids[:-8]
                solve_tenure = duration_s
            if self._metrics is not None:
                from ..metrics import names as mnames

                self._metrics.histogram(
                    mnames.LIFECYCLE_SOLVE_TENURE, solve_tenure
                )

    # -- read side ------------------------------------------------------------

    def record(self, app_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            record = self._records.get(app_id)
            return record.to_dict() if record is not None else None

    def records_brief(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "app": r.app_id,
                    "phase": r.phase,
                    "queueWaitSeconds": (
                        None
                        if r.queue_wait_s is None
                        else round(r.queue_wait_s, 6)
                    ),
                    "evictionCause": "",
                }
                for r in (self._records[a] for a in self._order)
            ]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            phase_counts = {p: 0 for p in PHASES}
            for record in self._records.values():
                phase_counts[record.phase] += 1
            waits = sorted(self._queue_waits)
            stats = dict(self._stats)
            transitions = self._transitions
            total = len(self._records)
        return {
            "gangs": total,
            "phases": {p: c for p, c in phase_counts.items() if c},
            "transitions": transitions,
            "queueWait": {
                "count": len(waits),
                "p50": _pct(waits, 0.50),
                "p95": _pct(waits, 0.95),
                "p99": _pct(waits, 0.99),
            },
            # no policy engine evicts and no HA epoch changes here
            "evictionsByCause": {},
            "epochContinuity": {"gangsSpanningEpochs": 0, "epochRegressions": 0},
            "drains": stats["drains"],
            "lockViolations": stats["lock_violations"],
        }

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    @property
    def lock_violations(self) -> int:
        with self._lock:
            return self._stats["lock_violations"]

    def _publish_gauges(self) -> None:
        from ..metrics import names as mnames

        with self._lock:
            phase_counts: Dict[str, int] = {}
            for record in self._records.values():
                phase_counts[record.phase] = (
                    phase_counts.get(record.phase, 0) + 1
                )
        for phase in PHASES:
            self._metrics.gauge(
                mnames.LIFECYCLE_GANGS,
                float(phase_counts.get(phase, 0)),
                {mnames.TAG_PHASE: phase},
            )


def _pct(sorted_values: List[float], q: float) -> Optional[float]:
    if not sorted_values:
        return None
    idx = min(
        len(sorted_values) - 1, max(0, int(q * len(sorted_values) + 0.5) - 1)
    )
    return round(sorted_values[idx], 6)
