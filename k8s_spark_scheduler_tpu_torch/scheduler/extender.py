"""SparkSchedulerExtender: the gang-scheduling Filter implementation
(reference ``internal/extender/resource.go``).

Per-request flow: reconcile-if-idle → DA compaction → role dispatch.
Drivers: idempotent replay, node-affinity filtering, availability
snapshot, AZ-aware sort, FIFO earlier-drivers pass, gang binpack,
demand create/delete, reservation creation.  Executors: bound-
reservation replay, unbound rebinding, rescheduling with optional
single-AZ confinement, soft-reservation consumption.

The tpu-batch* binpackers' queue solvers run on the device the server
was built for: the tensor lane (``_try_fast_driver_path``) and the
metadata lane (``_try_device_fifo``) never catch a solver error — a
build, launch or solve failure propagates out of ``predicate``.  A lane
declines only by its documented semantics: an inexact snapshot
(``build_cluster_tensor`` returns None) or ``outcome.supported`` False.

With the resilience kit (resilience/), a request whose deadline passed
answers fail-fast at the next phase boundary (lock acquired, FIFO gate,
binpack, reservation write-back).  With provenance (provenance/), every
decision leaves a record, the queue solve is captured, and a refused
driver's failure message carries the tightest-dimension shortfall and
the earlier drivers that took the capacity.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import compat
from .. import timesource
from ..capacity import enter_predicate_lock, exit_predicate_lock
from ..config import FifoConfig
from ..contention.locktime import TimedLock
from ..tracing import spans as tracing
from ..demands.manager import DemandManager
from ..events import events as ev
from ..kube.informer import Informer
from ..metrics import names as mnames
from ..metrics.registry import MetricsRegistry, default_registry
from ..ops import capacity as cap
from ..ops.efficiency import compute_avg_packing_efficiency
from ..ops.nodesort import NodeSorter
from ..ops.registry import SINGLE_AZ_MINIMAL_FRAGMENTATION, Binpacker
from ..resilience import deadline as req_deadline
from ..types.extenderapi import ExtenderArgs, ExtenderFilterResult
from ..types.objects import Node, Pod
from ..types.resources import (
    ZONE_LABEL,
    available_for_nodes,
    node_scheduling_metadata_for_nodes,
    subtract_usage_if_exists,
)
from . import labels as L
from .overhead import OverheadComputer
from .reservations_manager import DRIVER_RESERVATION_NAME, ResourceReservationManager
from .sparkpods import (
    AnnotationError,
    SparkPodLister,
    spark_resource_usage,
    spark_app_demand_cached,
    spark_resources,
    spark_resources_cached,
)

logger = logging.getLogger(__name__)

# outcome constants (resource.go:46-60)
FAILURE_UNBOUND = "failure-unbound"
FAILURE_INTERNAL = "failure-internal"
FAILURE_FIT = "failure-fit"
FAILURE_EARLIER_DRIVER = "failure-earlier-driver"
FAILURE_NON_SPARK_POD = "failure-non-spark-pod"
# the request outlived its caller's httpTimeout: answer fail-fast so the
# extender lock serves callers that are still listening (retriable — the
# next kube-scheduler attempt gets a fresh deadline)
FAILURE_DEADLINE = "failure-deadline-exceeded"
SUCCESS = "success"
SUCCESS_RESCHEDULED = "success-rescheduled"
SUCCESS_ALREADY_BOUND = "success-already-bound"
SUCCESS_SCHEDULED_EXTRA_EXECUTOR = "success-scheduled-extra-executor"

SUCCESS_OUTCOMES = {
    SUCCESS,
    SUCCESS_ALREADY_BOUND,
    SUCCESS_RESCHEDULED,
    SUCCESS_SCHEDULED_EXTRA_EXECUTOR,
}

# reconciliation trigger: default LeaseDuration for core clients
# (resource.go:57-59)
LEADER_ELECTION_INTERVAL_SECONDS = 15.0


class SchedulingFailure(Exception):
    def __init__(self, outcome: str, message: str):
        super().__init__(message)
        self.outcome = outcome


class SparkSchedulerExtender:
    def __init__(
        self,
        node_informer: Informer,
        pod_lister: SparkPodLister,
        resource_reservation_cache,
        soft_reservation_store,
        resource_reservation_manager: ResourceReservationManager,
        demands_manager: DemandManager,
        is_fifo: bool,
        fifo_config: FifoConfig,
        binpacker: Binpacker,
        should_schedule_dynamically_allocated_executors_in_same_az: bool,
        overhead_computer: OverheadComputer,
        instance_group_label: str,
        node_sorter: NodeSorter,
        metrics: MetricsRegistry | None = None,
        event_log: Optional[ev.EventLog] = None,
        waste_reporter=None,
        tensor_snapshot_cache=None,
        strict_reference_parity: bool = compat.DEFAULT_STRICT,
        tracer: Optional[tracing.Tracer] = None,
        delta_solve: bool = True,
        provenance=None,
        policy=None,
    ):
        self._node_informer = node_informer
        self._pod_lister = pod_lister
        self._resource_reservations = resource_reservation_cache
        self._soft_reservation_store = soft_reservation_store
        self._rrm = resource_reservation_manager
        self._demands = demands_manager
        self._is_fifo = is_fifo
        self._fifo_config = fifo_config
        self.binpacker = binpacker
        self._single_az_da = should_schedule_dynamically_allocated_executors_in_same_az
        self._overhead = overhead_computer
        self._instance_group_label = instance_group_label
        self._node_sorter = node_sorter
        self._metrics = metrics or default_registry
        self._event_log = event_log
        self._waste_reporter = waste_reporter
        self._tracer = tracer if tracer is not None else tracing.default_tracer
        # event-driven integer snapshot for the driver fast path; the
        # fast lexsort replicates the NodeSorter ordering including any
        # configured per-role label-priority re-sort
        self._tensor_snapshot = tensor_snapshot_cache
        # kube-scheduler serializes Filter calls per scheduler instance
        # (SURVEY §2.10); the reference's state (lastRequest, the
        # reconcile-then-pack flow) relies on that — enforce it here so a
        # threaded HTTP front end can't interleave predicates.  The
        # TimedLock wrapper (contention/locktime.py) measures every
        # acquire — the one lock every Filter takes — so it records
        # unsampled and stamps lockWaitMs on the request span for the
        # critical-path decomposition.
        self._predicate_lock = TimedLock(
            threading.Lock(), "extender.predicate", sample_every=1, tag_waits=True
        )
        self._fast_path_ok = tensor_snapshot_cache is not None
        # incremental delta-solve engine (ops/deltasolve.py):
        # device-resident solver sessions + prefix-feasibility reuse for
        # the earlier-drivers pass.  None when disabled or when there is
        # no tensor mirror to key invalidation on; the engine itself
        # declines (returns None) per request when it can't serve
        # exactly, so construction is cheap and unconditional otherwise.
        self.delta_engine = None
        if delta_solve and tensor_snapshot_cache is not None:
            from ..ops.deltasolve import DeltaSolveEngine

            self.delta_engine = DeltaSolveEngine(metrics=self._metrics)
        self._strict_reference_parity = strict_reference_parity
        # decision provenance (provenance/tracker.py): None or disabled
        # keeps every capture sink None — the solver then runs with zero
        # provenance work
        self._provenance = provenance
        # scheduling-policy engine (policy/engine.py): None (the
        # default) keeps every hook a single attribute check — the
        # Filter path is then byte-identical to pre-policy behavior
        self._policy = policy
        if provenance is not None and provenance.enabled:
            solver = getattr(binpacker, "queue_solver", None)
            if solver is not None and hasattr(solver, "capture_sink"):
                solver.capture_sink = provenance.capture
            if self.delta_engine is not None:
                self.delta_engine.capture_sink = provenance.capture
        self._last_request = 0.0
        # diagnostics: which lane served the last executor reschedule
        self.last_reschedule_path: Optional[str] = None
        # HA fabric hook (server/wiring.py): the fencing-epoch reader,
        # so every decision trace carries the epoch it was served under
        # — post-mortems can attribute a decision to a leadership term.
        # None (the default / single-replica) costs one attribute check.
        self.epoch_source: Optional[Callable[[], int]] = None
        # SLO engine hook (server/wiring.py): reads the precomputed
        # alert-tag string (e.g. "eviction_waste:page") so decision
        # traces made during an SLO burn carry that context.  The value
        # is computed at ledger drain time, never on this path.
        self.slo_alert_source: Optional[Callable[[], str]] = None
        # concurrent admission hook (concurrent/engine.py): installed
        # for exactly one predicate call at a time (the commit gate
        # serializes commits), consulted on the driver fast path with
        # the commit-time basis — returns (outcome, zones) when the
        # speculative verdict revalidates, None to run the normal solve.
        # None (the default / serial operation) costs one attribute read.
        self.speculation_intake = None

    # -- entry point ---------------------------------------------------------

    def predicate(self, args: ExtenderArgs) -> ExtenderFilterResult:
        """resource.go:128-183."""
        with self._predicate_lock:
            # mark lock tenure in the thread-local the capacity sampler
            # and the lifecycle ledger check: a probe or a drain invoked
            # from inside a decision would stretch lock hold time, so
            # they refuse it
            enter_predicate_lock()
            try:
                # one span per scheduling decision; role/instanceGroup/
                # outcome/node tags land via add_tag as they are
                # computed.  Becomes the trace root when called outside
                # the HTTP layer.
                with self._tracer.span(
                    "predicate",
                    {"pod": args.pod.name, "namespace": args.pod.namespace},
                ):
                    if self.epoch_source is not None:
                        tracing.add_tag("epoch", self.epoch_source())
                    if self.slo_alert_source is not None:
                        alert = self.slo_alert_source()
                        if alert:
                            tracing.add_tag("sloAlert", alert)
                    # the request may have queued behind slow decisions
                    # for its whole deadline; answer fail-fast rather
                    # than spend the lock on a caller that already hung
                    # up
                    try:
                        self._check_deadline("lock-acquired")
                    except SchedulingFailure as err:
                        tracing.add_tag("outcome", err.outcome)
                        if self._provenance is not None and self._provenance.enabled:
                            self._provenance.on_trigger(
                                "deadline-exceeded",
                                f"{args.pod.namespace}/{args.pod.name} at lock-acquired",
                            )
                        return self._fail_with_message(err.outcome, args, str(err))
                    return self._predicate_locked(args)
            finally:
                exit_predicate_lock()

    def _check_deadline(self, phase: str) -> None:
        """Phase-boundary deadline check (resilience/deadline.py): one
        contextvar read when no deadline is bound."""
        try:
            req_deadline.check(phase)
        except req_deadline.DeadlineExceeded as err:
            self._metrics.counter(
                mnames.RESILIENCE_DEADLINE_EXPIRED_COUNT, {"phase": phase}
            )
            raise SchedulingFailure(FAILURE_DEADLINE, str(err))

    def _predicate_locked(self, args: ExtenderArgs) -> ExtenderFilterResult:
        pod = args.pod
        # the wire pod is authoritative for spec/labels, but reservation
        # owner references need the cluster UID: a UID-less wire pod
        # (kube-scheduler always sends one; simulators may not) would
        # create reservations the owner GC can never match — a permanent
        # capacity leak
        if not pod.meta.uid:
            stored = self._pod_lister.informer.get(pod.namespace, pod.name)
            if stored is None:
                # kube-scheduler always sends the UID and only schedules
                # pods that exist; a UID-less pod unknown to the informer
                # is a broken client — reject rather than create an
                # owner-less (uncollectable) reservation
                logger.warning(
                    "rejecting pod %s/%s: no UID and not in the informer",
                    pod.namespace,
                    pod.name,
                )
                return self._fail_with_message(
                    FAILURE_INTERNAL, args, "pod has no UID and is unknown"
                )
            pod.meta.uid = stored.meta.uid
        role = pod.labels.get(L.SPARK_ROLE_LABEL, "")
        instance_group, ok = L.find_instance_group_from_pod_spec(pod, self._instance_group_label)
        if not ok:
            instance_group = ""
        if self._provenance is not None and self._provenance.enabled:
            self._provenance.begin_decision(pod, role=role)

        t0 = time.perf_counter()
        try:
            self._reconcile_if_needed()
        except Exception:
            logger.exception("failed to reconcile")
            self._finish_provenance(
                FAILURE_INTERNAL, instance_group, message="failed to reconcile"
            )
            return self._fail_with_message(FAILURE_INTERNAL, args, "failed to reconcile")
        self._rrm.compact_dynamic_allocation_applications()

        try:
            node_name, outcome = self._select_node(instance_group, role, pod, args.node_names)
        except SchedulingFailure as err:
            self._mark_schedule(instance_group, role, err.outcome, t0, pod)
            self._finish_provenance(err.outcome, instance_group, message=str(err))
            if err.outcome == FAILURE_INTERNAL:
                logger.exception("internal error scheduling pod %s", pod.name)
            else:
                logger.info("failed to schedule pod %s: %s (%s)", pod.name, err, err.outcome)
            return self._fail_with_message(err.outcome, args, str(err))

        self._mark_schedule(instance_group, role, outcome, t0, pod)
        self._finish_provenance(outcome, instance_group, node=node_name)
        tracing.add_tag("node", node_name)

        if role == L.DRIVER:
            try:
                app_resources = spark_resources(pod)
            except AnnotationError as err:
                logger.exception("internal error scheduling pod")
                return self._fail_with_message(FAILURE_INTERNAL, args, str(err))
            ev.emit_application_scheduled(
                instance_group,
                pod.labels.get(L.SPARK_APP_ID_LABEL, ""),
                pod.name,
                pod.namespace,
                app_resources.driver_resources,
                app_resources.executor_resources,
                app_resources.min_executor_count,
                app_resources.max_executor_count,
                self._event_log,
            )

        logger.info("scheduling pod %s to node %s", pod.name, node_name)
        return ExtenderFilterResult(node_names=[node_name])

    def _mark_schedule(
        self, instance_group: str, role: str, outcome: str, t0: float, pod: Pod = None
    ) -> None:
        """ScheduleTimer semantics (metrics.go:164-219): the retry tag is
        derived statelessly from the pod's PodScheduled condition, the
        last-seen time from that condition's transition time, and the
        first-sight slow log fires only on first tries."""
        from ..metrics import names as mnames

        tracing.add_tag("role", role)
        tracing.add_tag("instanceGroup", instance_group)
        tracing.add_tag("outcome", outcome)
        tags = {"instanceGroup": instance_group, "role": role, "outcome": outcome}
        self._metrics.histogram(mnames.SCHEDULING_PROCESSING_TIME, time.perf_counter() - t0, tags)
        self._metrics.counter(mnames.REQUEST_COUNTER, tags)
        if pod is not None:
            now = timesource.now()
            created = pod.creation_timestamp or now
            scheduled_condition = pod.conditions.get("PodScheduled")
            is_retry = scheduled_condition is not None
            last_seen = (
                scheduled_condition.transition_time
                if is_retry and scheduled_condition.transition_time
                else created
            )
            wait = max(now - created, 0.0)
            self._metrics.histogram(mnames.SCHEDULING_WAIT_TIME, wait, tags)
            self._metrics.histogram(
                mnames.SCHEDULING_RETRY_TIME,
                max(now - last_seen, 0.0),
                dict(tags, retry="true" if is_retry else "false"),
            )
            if wait > mnames.SLOW_LOG_THRESHOLD_SECONDS and not is_retry:
                logger.warning(
                    "pod %s/%s first seen by the extender but older than the slow "
                    "log threshold (%.0fs, outcome %s)",
                    pod.namespace,
                    pod.name,
                    wait,
                    outcome,
                )

    def _finish_provenance(
        self, outcome: str, instance_group: str, node: str = "", message: str = ""
    ) -> None:
        """Seal the pending decision record (provenance/tracker.py) and
        fire the deadline flight-recorder trigger when the decision died
        at a phase boundary."""
        prov = self._provenance
        if prov is None or not prov.enabled:
            return
        # lane comes from the captured artifacts when a queue solve ran
        # for THIS decision; passing the solver's last_queue_lane here
        # would stamp artifact-less decisions (executor replays, early
        # failures) with a stale lane from a previous driver solve
        prov.finish_decision(
            outcome,
            node=node,
            lane="",
            policy=self.binpacker.name,
            instance_group=instance_group,
            message=message,
        )
        if outcome == FAILURE_DEADLINE:
            prov.on_trigger("deadline-exceeded", message)

    def _refusal_message(self, base: str, kind: str) -> str:
        """Thread the tightest-dimension shortfall + blocker set into
        the shared failure message ("short 12 executors … in cpu;
        blocked by 3 earlier drivers").  The enriched message flows
        through uniform_failure into the encode-once buffer — one
        serialization per (candidates, message) pair, unchanged."""
        prov = self._provenance
        if prov is None or not prov.enabled:
            return base
        detail = prov.refusal_detail(kind)
        return f"{base}: {detail}" if detail else base

    # -- policy hooks (no-ops when no engine is configured) ------------------

    def _earlier_drivers(self, driver: Pod) -> List[Pod]:
        """The queue-ahead set for the FIFO gate; the policy engine may
        re-order it (priority-then-fifo, DRF) without touching the
        queue solve itself."""
        if self._policy is not None:
            return self._policy.earlier_queue(driver)
        return self._pod_lister.list_earlier_drivers(driver)

    def _skip_verdict(self, queued: Pod, driver: Pod, skip_cutoff: float) -> bool:
        """enforce-after-age skip verdict for one queued driver,
        optionally widened by the policy engine's conservative backfill
        probe (which can only ADD skips, never remove one)."""
        base = queued.creation_timestamp > skip_cutoff
        if self._policy is not None:
            return self._policy.skip_allowed(queued, driver, base)
        return base

    def _raise_driver_refusal(
        self, driver: Pod, app_resources, outcome: str, base_message: str, kind: str
    ):
        """Shared refusal tail for the driver path: enrich the message
        with the shortfall explanation, give the policy engine its
        preemption shot (the explanation memoized the blocker set it
        seeds from), and stamp any committed victim set into the
        FailedNodes message."""
        message = self._refusal_message(base_message, kind)
        if self._policy is not None:
            note = self._policy.on_driver_refusal(driver, app_resources, outcome)
            if note:
                message = f"{message}; {note}"
        raise SchedulingFailure(outcome, message)

    def _fail_with_message(self, outcome: str, args: ExtenderArgs, message: str) -> ExtenderFilterResult:
        if self._waste_reporter is not None:
            self._waste_reporter.mark_failed_scheduling_attempt(args.pod, outcome)
        # the uniform_failure hint lets the HTTP layer reuse an encoded
        # response buffer for this (candidate tuple, message) pair
        # instead of re-serializing a 10k-entry map per retry
        return ExtenderFilterResult(
            failed_nodes={n: message for n in args.node_names},
            uniform_failure=(args.node_names, message),
        )

    def _reconcile_if_needed(self) -> None:
        """resource.go:194-205."""
        now = timesource.now()
        if now > self._last_request + LEADER_ELECTION_INTERVAL_SECONDS:
            from ..metrics import names as mnames
            from .failover import sync_resource_reservations_and_demands

            t0 = time.perf_counter()
            with self._tracer.span("reconcile"):
                sync_resource_reservations_and_demands(self)
            self._metrics.histogram(
                mnames.RECONCILIATION_TIME, time.perf_counter() - t0
            )
        self._last_request = now

    def _select_node(
        self, instance_group: str, role: str, pod: Pod, node_names: List[str]
    ) -> Tuple[str, str]:
        """resource.go:207-220."""
        if role == L.DRIVER:
            return self._select_driver_node(instance_group, pod, node_names)
        if role == L.EXECUTOR:
            node, outcome = self._select_executor_node(pod, node_names)
            if outcome in SUCCESS_OUTCOMES:
                self._demands.delete_demand_if_exists(pod, "SparkSchedulerExtender")
            return node, outcome
        raise SchedulingFailure(FAILURE_NON_SPARK_POD, "can not schedule non spark pod")

    # -- driver path ---------------------------------------------------------

    def _select_driver_node(
        self, instance_group: str, driver: Pod, node_names: List[str]
    ) -> Tuple[str, str]:
        """resource.go:272-370."""
        app_id = driver.labels.get(L.SPARK_APP_ID_LABEL, "")
        rr = self._rrm.get_resource_reservation(app_id, driver.namespace)
        if rr is not None:
            # idempotent replay: return the previously reserved node
            driver_reserved_node = rr.spec.reservations[DRIVER_RESERVATION_NAME].node
            if driver_reserved_node not in node_names:
                logger.warning(
                    "driver already has a reservation but node %s is not in candidate list; "
                    "returning it anyway",
                    driver_reserved_node,
                )
            return driver_reserved_node, SUCCESS

        try:
            app_resources_early = spark_resources(driver)
        except AnnotationError as err:
            raise SchedulingFailure(FAILURE_INTERNAL, f"failed to get spark resources: {err}")
        fast = self._try_fast_driver_path(
            instance_group, driver, node_names, app_resources_early
        )
        self._metrics.counter(
            mnames.TPU_FASTPATH,
            {"path": "driver", "lane": "fast" if fast is not None else "slow"},
        )
        if fast is not None:
            outcome, zones = fast
            if not outcome.earlier_ok:
                self._demands.create_demand_for_application_in_any_zone(
                    driver, app_resources_early
                )
                self._raise_driver_refusal(
                    driver,
                    app_resources_early,
                    FAILURE_EARLIER_DRIVER,
                    "earlier drivers do not fit to the cluster",
                    "earlier-driver",
                )
            return self._finish_driver_selection(
                instance_group, driver, app_resources_early, outcome.result, zones
            )

        available_nodes: List[Node] = self._node_informer.list_with_predicate(
            lambda node: driver.matches_node(node)
        )

        usage = self._rrm.get_reserved_resources()
        overhead = self._overhead.get_overhead(available_nodes)
        metadata = node_scheduling_metadata_for_nodes(available_nodes, usage, overhead)
        driver_node_names, executor_node_names = self._node_sorter.potential_nodes(
            metadata, node_names
        )
        app_resources = app_resources_early

        packing_result = None
        self._check_deadline("fifo-gate")
        if self._is_fifo:
            queued_drivers = self._earlier_drivers(driver)
            # tpu-batch: the whole earlier-drivers pass plus this driver's
            # pack is ONE device solve (ops/fifo_solver); other policies
            # run the host loop
            outcome = self._try_device_fifo(
                instance_group,
                queued_drivers,
                driver_node_names,
                executor_node_names,
                metadata,
                app_resources,
                driver,
            )
            if outcome is not None and outcome.supported:
                earlier_ok = outcome.earlier_ok
                packing_result = outcome.result
            else:
                earlier_ok = self._fit_earlier_drivers(
                    instance_group,
                    queued_drivers,
                    driver_node_names,
                    executor_node_names,
                    metadata,
                    driver,
                )
            if not earlier_ok:
                self._demands.create_demand_for_application_in_any_zone(driver, app_resources)
                self._raise_driver_refusal(
                    driver,
                    app_resources,
                    FAILURE_EARLIER_DRIVER,
                    "earlier drivers do not fit to the cluster",
                    "earlier-driver",
                )

        if packing_result is None:
            self._check_deadline("binpack")
            with self._tracer.span(
                "binpack", {"policy": self.binpacker.name, "lane": "host"}
            ) as sp:
                packing_result = self.binpacker.binpack_func(
                    app_resources.driver_resources,
                    app_resources.executor_resources,
                    app_resources.min_executor_count,
                    driver_node_names,
                    executor_node_names,
                    metadata,
                )
                sp.tag("hasCapacity", packing_result.has_capacity)
        efficiency = compute_avg_packing_efficiency(
            metadata, list(packing_result.packing_efficiencies.values())
        ) if packing_result.has_capacity else None
        zones = {
            node.name: node.labels.get(ZONE_LABEL, "") for node in available_nodes
        }
        return self._finish_driver_selection(
            instance_group, driver, app_resources, packing_result, zones, efficiency
        )

    def _finish_driver_selection(
        self, instance_group, driver, app_resources, packing_result, zones, efficiency=None
    ) -> Tuple[str, str]:
        """Common driver-path tail: demand lifecycle, metrics, reservation
        creation (resource.go:347-369)."""
        self._check_deadline("reservation-writeback")
        if not packing_result.has_capacity:
            self._demands.create_demand_for_application_in_any_zone(driver, app_resources)
            self._raise_driver_refusal(
                driver,
                app_resources,
                FAILURE_FIT,
                "application does not fit to the cluster",
                "fit",
            )

        if efficiency is None:
            if packing_result.max_avg_efficiency is not None:
                # precomputed by the tensor lanes (same float64 value as
                # the iteration below, without materializing every node)
                max_avg = packing_result.max_avg_efficiency
            else:
                # fast path: average the per-node efficiencies directly
                # (the device adapters compute them with exact value()
                # semantics)
                effs = list(packing_result.packing_efficiencies.values())
                max_sum = sum(max(e.gpu, e.cpu, e.memory) for e in effs)
                max_avg = max_sum / max(len(effs), 1)
        else:
            max_avg = efficiency.max
        self._metrics.gauge(
            mnames.PACKING_EFFICIENCY_MAX,
            max_avg,
            {"instanceGroup": instance_group, "binpacker": self.binpacker.name},
        )
        self._report_placement_metrics(instance_group, packing_result, zones)

        self._demands.delete_demand_if_exists(driver, "SparkSchedulerExtender")
        self._rrm.create_reservations(
            driver,
            app_resources,
            packing_result.driver_node,
            packing_result.executor_nodes,
        )
        return packing_result.driver_node, SUCCESS

    def _try_fast_driver_path(self, instance_group, driver, node_names, app_resources):
        """Whole driver decision (FIFO pass + gang pack) from the
        event-driven tensor snapshot: zero Quantity arithmetic.  The
        delta-solve engine serves first; when it declines, the
        per-request tensor build and cold solve.  Returns (FifoOutcome,
        zones), or None when the lane declines (no solve_tensor solver,
        an inexact snapshot, an unsupported problem) and the Quantity
        path serves.  A solver error propagates."""
        solver = getattr(self.binpacker, "queue_solver", None)
        # the tensor-snapshot lane needs a solver that accepts prebuilt
        # tensors; the single-AZ FIFO solver requires Quantity metadata
        # (zone efficiency choice) and goes through the metadata path
        if (
            solver is None
            or not hasattr(solver, "solve_tensor")
            or not self._fast_path_ok
        ):
            return None
        from ..ops.fast_path import build_cluster_tensor
        from ..ops.sparkapp import AppDemand

        with self._tracer.span("fast_path.snapshot"):
            snap = self._tensor_snapshot.snapshot()
        prov = self._provenance
        if prov is not None and not prov.enabled:
            prov = None
        earlier_apps = []
        skip_allowed = []
        queue_names: Optional[List[str]] = [] if prov is not None else None
        if self._is_fifo:
            with self._tracer.span("fast_path.earlier_drivers") as sp:
                skip_cutoff = self._fifo_skip_cutoff(instance_group)
                for queued in self._earlier_drivers(driver):
                    try:
                        # stable AppDemand per pod version: tensor rows
                        # are computed once per app, not per request
                        _, demand = spark_app_demand_cached(queued)
                    except AnnotationError:
                        logger.warning(
                            "failed to get driver resources, skipping driver %s",
                            queued.name,
                        )
                        continue
                    earlier_apps.append(demand)
                    skip_allowed.append(self._skip_verdict(queued, driver, skip_cutoff))
                    if queue_names is not None:
                        queue_names.append(queued.name)
                sp.tag("earlierApps", len(earlier_apps))
        if prov is not None:
            prov.note_context(
                queue_names=queue_names,
                content_key=snap.content_key,
                feed_seq=int(snap.content_key[1]),
            )
        current = AppDemand(
            app_resources.driver_resources,
            app_resources.executor_resources,
            app_resources.min_executor_count,
        )

        # speculative-verdict intake first (concurrent/engine.py): the
        # commit gate installed a verdict solved outside the lock;
        # consume it only if it revalidates against THIS basis (seq →
        # memcmp → conflict) — a conflict falls through to the warm
        # delta solve below (the bounded re-solve), so decisions never
        # depend on speculation
        intake = self.speculation_intake
        if intake is not None:
            served = intake(driver, snap, node_names, earlier_apps, skip_allowed, current)
            if served is not None:
                tracing.add_tag("speculation", "hit")
                return served

        # incremental lane first: a warm session skips the tensor build,
        # the sorts, the GCD scaling, the basis upload AND the
        # already-proved queue prefix — the engine declines (None)
        # whenever it cannot serve the request exactly.  Its misses after a
        # cold build (inexact, scale, mf-sentinel) build the tensor again
        # below; they are rare enough that the second build is not kept
        if self.delta_engine is not None:
            served = self.delta_engine.solve(
                snap, driver, node_names, self._node_sorter,
                earlier_apps, skip_allowed, current, solver,
            )
            if served is not None:
                return served

        with self._tracer.span("fast_path.build_tensor") as sp:
            # node_names flows through verbatim — on the HTTP path it is
            # the interned tuple, so prep-cache keys share one string set
            # instead of pinning per-request copies
            built = build_cluster_tensor(
                snap,
                driver,
                node_names,
                driver_label_priority=self._node_sorter.driver_label_priority,
                executor_label_priority=self._node_sorter.executor_label_priority,
            )
            sp.tag("exact", built is not None)
        if built is None:
            return None
        cluster, zones = built
        outcome = solver.solve_tensor(cluster, earlier_apps, skip_allowed, current)
        if not outcome.supported:
            return None
        return outcome, zones

    def _try_device_fifo(
        self,
        instance_group: str,
        queued_drivers: List[Pod],
        driver_node_names: List[str],
        executor_node_names: List[str],
        metadata,
        app_resources,
        current_driver: Pod,
    ):
        """Run the FIFO pass + current pack on the device when the
        configured binpacker provides a queue solver; returns None when
        it has none (the host loop takes over).  A solver error
        propagates."""
        solver = getattr(self.binpacker, "queue_solver", None)
        if solver is None:
            return None
        from ..ops.sparkapp import AppDemand

        prov = self._provenance
        if prov is not None and not prov.enabled:
            prov = None
        earlier_apps = []
        skip_allowed = []
        queue_names: Optional[List[str]] = [] if prov is not None else None
        skip_cutoff = self._fifo_skip_cutoff(instance_group)
        for queued in queued_drivers:
            try:
                _, demand = spark_app_demand_cached(queued)
            except AnnotationError:
                logger.warning(
                    "failed to get driver resources, skipping driver %s", queued.name
                )
                continue
            earlier_apps.append(demand)
            skip_allowed.append(self._skip_verdict(queued, current_driver, skip_cutoff))
            if queue_names is not None:
                queue_names.append(queued.name)
        if prov is not None:
            prov.note_context(queue_names=queue_names)
        outcome = solver.solve(
            metadata,
            driver_node_names,
            executor_node_names,
            earlier_apps,
            skip_allowed,
            AppDemand(
                app_resources.driver_resources,
                app_resources.executor_resources,
                app_resources.min_executor_count,
            ),
        )
        lane = getattr(solver, "last_path", None)
        if lane is not None:
            # single-AZ solvers report fused (one-dispatch) vs host
            # (exact fallback) — the ops signal for how often the
            # certified fixed-point zone choice holds
            self._metrics.counter(mnames.SINGLEAZ_LANE, {"lane": lane})
        return outcome

    def _fit_earlier_drivers(
        self,
        instance_group: str,
        drivers: List[Pod],
        node_names: List[str],
        executor_node_names: List[str],
        metadata,
        current_driver: Pod,
    ) -> bool:
        """resource.go:224-262: binpack every earlier driver and subtract
        its usage before considering this one."""
        with self._tracer.span(
            "fifo_gate", {"lane": "host", "earlierApps": len(drivers)}
        ) as sp:
            skip_cutoff = self._fifo_skip_cutoff(instance_group)
            for driver in drivers:
                try:
                    app_resources = spark_resources_cached(driver)
                except AnnotationError:
                    logger.warning("failed to get driver resources, skipping driver %s", driver.name)
                    continue
                packing_result = self.binpacker.binpack_func(
                    app_resources.driver_resources,
                    app_resources.executor_resources,
                    app_resources.min_executor_count,
                    node_names,
                    executor_node_names,
                    metadata,
                )
                if not packing_result.has_capacity:
                    if self._skip_verdict(driver, current_driver, skip_cutoff):
                        logger.debug(
                            "skipping non-fitting driver %s from FIFO: not old enough", driver.name
                        )
                        continue
                    logger.warning("failed to fit earlier driver %s", driver.name)
                    sp.tag("earlierOk", False).tag("blockedBy", driver.name)
                    return False
                subtract_usage_if_exists(
                    metadata,
                    spark_resource_usage(
                        app_resources.driver_resources,
                        app_resources.executor_resources,
                        packing_result.driver_node,
                        packing_result.executor_nodes,
                    ),
                )
            sp.tag("earlierOk", True)
            return True

    def _fifo_skip_cutoff(self, instance_group: str) -> float:
        """Creation-time cutoff above which a queued driver is young
        enough to skip — hoistable out of the per-request queue loop
        (one clock sample per request instead of one per queued pod;
        the reference's per-pod time.Now() drift within a request is
        sub-millisecond wall clock, not decision semantics)."""
        enforce_after = self._fifo_config.enforce_after_pod_age_by_instance_group.get(
            instance_group, self._fifo_config.default_enforce_after_pod_age
        )
        return timesource.now() - enforce_after

    # -- executor path -------------------------------------------------------

    def _select_executor_node(self, executor: Pod, node_names: List[str]) -> Tuple[str, str]:
        """resource.go:383-435."""
        try:
            already_bound_node, found = self._rrm.find_already_bound_reservation_node(executor)
        except KeyError as err:
            raise SchedulingFailure(
                FAILURE_INTERNAL, f"error when looking for already bound reservations: {err}"
            )
        if found:
            result = self._reservation_node_from_node_list([already_bound_node], node_names)
            if result is not None:
                return result, SUCCESS_ALREADY_BOUND
            logger.info(
                "found already bound node %s for executor, but not in potential nodes",
                already_bound_node,
            )

        try:
            unbound_nodes, found_unbound = self._rrm.find_unbound_reservation_nodes(executor)
        except KeyError as err:
            raise SchedulingFailure(
                FAILURE_INTERNAL, f"error when looking for unbound reservations: {err}"
            )
        if found_unbound:
            result = self._reservation_node_from_node_list(unbound_nodes, node_names)
            if result is not None:
                try:
                    self._rrm.reserve_for_executor_on_unbound_reservation(executor, result)
                except Exception as err:
                    raise SchedulingFailure(
                        FAILURE_INTERNAL, f"failed to reserve node for executor: {err}"
                    )
                return result, SUCCESS

        try:
            free_spots = self._rrm.get_remaining_allowed_executor_count(
                executor.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.namespace
            )
        except KeyError as err:
            raise SchedulingFailure(
                FAILURE_INTERNAL, f"error when checking remaining allowed executors: {err}"
            )
        if free_spots > 0:
            is_extra_executor = not found_unbound
            node_name, outcome = self._reschedule_executor(executor, node_names, is_extra_executor)
            try:
                self._rrm.reserve_for_executor_on_rescheduled_node(executor, node_name)
            except Exception as err:
                raise SchedulingFailure(
                    FAILURE_INTERNAL, f"failed to reserve node for rescheduled executor: {err}"
                )
            return node_name, outcome

        raise SchedulingFailure(
            FAILURE_UNBOUND, "application has no free executor spots to schedule this one"
        )

    @staticmethod
    def _reservation_node_from_node_list(
        reservation_nodes: List[str], node_names: List[str]
    ) -> Optional[str]:
        """resource.go:438-447."""
        reservation_set = set(reservation_nodes)
        for name in node_names:
            if name in reservation_set:
                return name
        return None

    def _get_nodes(self, node_names: List[str]) -> List[Node]:
        nodes = []
        for name in node_names:
            node = self._node_informer.get("default", name)
            if node is None:
                logger.warning("failed to find node %s in cache, skipping", name)
                continue
            nodes.append(node)
        return nodes

    def _reschedule_executor(
        self, executor: Pod, node_names: List[str], is_extra_executor: bool
    ) -> Tuple[str, str]:
        """resource.go:594-673."""
        driver = self._pod_lister.get_driver_pod_for_executor(executor)
        if driver is None:
            raise SchedulingFailure(FAILURE_INTERNAL, "failed to get driver pod for executor")
        try:
            app_resources = spark_resources(driver)
        except AnnotationError as err:
            raise SchedulingFailure(FAILURE_INTERNAL, str(err))
        executor_resources = app_resources.executor_resources

        should_schedule_into_single_az = False
        single_az_zone = ""
        if self.binpacker.is_single_az and self._single_az_da:
            zone, all_in_same_az = self._get_common_zone_for_executors_application(executor)
            if all_in_same_az:
                single_az_zone = zone
                should_schedule_into_single_az = True

        potential_outcome = (
            SUCCESS_SCHEDULED_EXTRA_EXECUTOR if is_extra_executor else SUCCESS_RESCHEDULED
        )

        # executor fast lane: order + fit from the event-driven tensor
        # mirror, zero Quantity arithmetic and no O(all-reservations)
        # usage walk (ref hot path resource.go:594-663)
        fast = self._try_fast_reschedule(
            executor,
            node_names,
            executor_resources,
            single_az_zone if should_schedule_into_single_az else None,
        )
        self._metrics.counter(
            mnames.TPU_FASTPATH,
            {"path": "executor", "lane": "fast" if fast is not None else "slow"},
        )
        if fast is not None:
            hit, name = fast
            if hit:
                return name, potential_outcome
            self._reschedule_miss(
                executor, executor_resources, should_schedule_into_single_az, single_az_zone
            )

        available_nodes = self._get_nodes(node_names)
        if should_schedule_into_single_az:
            available_nodes = self._filter_nodes_to_zone(available_nodes, single_az_zone)
            node_names = [n.name for n in available_nodes]

        usage = self._rrm.get_reserved_resources()
        overhead = self._overhead.get_overhead(available_nodes)
        metadata = node_scheduling_metadata_for_nodes(available_nodes, usage, overhead)

        # QUIRK (switchable, install key strict-reference-parity;
        # reference resource.go:638-643 + resources.go:61-100): the Go
        # NodeSchedulingMetadataForNodes mutates the caller's usage map
        # in place (usage[node].Add(overhead) through a shared pointer) for
        # nodes that have a usage entry, and the subsequent usage.Add(
        # overhead) adds it AGAIN — so the first-fit reschedule path sees
        # allocatable − reserved − 2×overhead on nodes with reservations,
        # and allocatable − overhead on nodes without.  Replicated exactly
        # for decision parity; with strict parity off overhead counts once
        # on every node (the driver path's semantics).
        double_overhead = self._strict_reference_parity
        for node_name, node_overhead in overhead.items():
            if node_name in usage:
                usage[node_name] = usage[node_name].add(node_overhead)
                if double_overhead:
                    usage[node_name] = usage[node_name].add(node_overhead)
            else:
                usage[node_name] = node_overhead
        available_resources = available_for_nodes(available_nodes, usage)

        _, executor_node_names = self._node_sorter.potential_nodes(metadata, node_names)

        if self._is_single_az_min_frag():
            name = self._reschedule_executor_with_minimal_fragmentation(
                executor, executor_node_names, metadata, overhead, executor_resources
            )
            if name is not None:
                return name, potential_outcome
        else:
            for name in executor_node_names:
                if not executor_resources.greater_than(available_resources[name]):
                    return name, potential_outcome

        self._reschedule_miss(
            executor, executor_resources, should_schedule_into_single_az, single_az_zone
        )

    def _is_single_az_min_frag(self) -> bool:
        """Both the host policy and its tpu-batch counterpart use the
        min-frag reschedule variant (resource.go:652's name check) — the
        device name must not silently flip the variant to first-fit."""
        return self.binpacker.name.endswith(SINGLE_AZ_MINIMAL_FRAGMENTATION)

    def _reschedule_miss(
        self, executor: Pod, executor_resources, into_single_az: bool, zone: str
    ):
        """Shared no-capacity tail of the reschedule path
        (resource.go:664-672): demand creation + failure."""
        if into_single_az:
            self._metrics.counter(
                mnames.SINGLE_AZ_DA_PACK_FAILURE_ZONED,
                {"zone": zone},
            )
            self._demands.create_demand_for_executor_in_specific_zone(
                executor, executor_resources, zone
            )
        else:
            self._demands.create_demand_for_executor_in_any_zone(executor, executor_resources)
        raise SchedulingFailure(FAILURE_FIT, "not enough capacity to reschedule the executor")

    def _try_fast_reschedule(
        self,
        executor: Pod,
        node_names: List[str],
        executor_resources,
        zone: Optional[str],
    ):
        """Executor reschedule served entirely from the tensor mirror:
        AZ-aware executor order (including label priority) and the fit
        check in vectorized integer math.  Returns (hit, node_name) or
        None to use the Quantity path.  Decision parity: availability
        rows equal the slow path's alloc − reserved − overhead exactly
        (tests/test_tensor_snapshot.py); the double-overhead reschedule
        quirk applies to reservation-entry nodes under strict parity
        (compat.py #1).  The single-az-minimal-fragmentation policy's
        app-attraction variant (resource.go:675-703) is served as a
        vectorized lexicographic min instead of first-fit."""
        self.last_reschedule_path = "slow"
        if self._tensor_snapshot is None or not self._fast_path_ok:
            return None
        with self._tracer.span("executor.fast_reschedule") as span:
            return self._try_fast_reschedule_traced(
                executor, node_names, executor_resources, zone, span
            )

    def _try_fast_reschedule_traced(
        self, executor, node_names, executor_resources, zone, span
    ):
        from ..ops.fast_path import executor_reschedule_order
        from ..ops.tensorize import _resources_to_base

        snap = self._tensor_snapshot.snapshot()
        exec_row, exact = _resources_to_base(executor_resources)
        if not exact:
            return None
        built = executor_reschedule_order(
            snap,
            list(node_names),
            self._node_sorter.executor_label_priority,
            zone,
        )
        if built is None:
            return None
        names, avail, overhead, res_entry = built
        row = np.array(exec_row, dtype=np.int64)
        if self._is_single_az_min_frag():
            hit_name = self._fast_min_frag_reschedule(
                executor, names, avail, overhead, row
            )
            self.last_reschedule_path = "fast"
            span.tag("hit", hit_name is not None)
            if hit_name is not None:
                return True, hit_name
            return False, None
        fit_avail = avail
        if self._strict_reference_parity and len(names):
            # QUIRK #1 (resource.go:638-643): nodes with a usage
            # entry see overhead subtracted twice on this path
            fit_avail = avail.copy()
            fit_avail[res_entry] -= overhead[res_entry]
        fits = (fit_avail >= row[None, :]).all(axis=1)
        hit = np.flatnonzero(fits)
        self.last_reschedule_path = "fast"
        span.tag("hit", bool(len(hit)))
        if len(hit):
            return True, names[int(hit[0])]
        return False, None

    def _fast_min_frag_reschedule(self, executor, names, avail, overhead, row):
        """resource.go:675-703 from the mirror: capacity per node with
        overhead passed as the reserved map (the reference's
        GetNodeCapacities call — net DOUBLE overhead on top of the
        availability rows, which already subtract it once; unconditional
        in the reference, unlike the first-fit branch's flagged quirk),
        then the best node = lexicographic min of (not-hosting-this-app,
        capacity, priority position) among capacity ≥ 1 — identical to
        the sequential strict-improvement loop."""
        if not len(names):
            return None
        # capacity_against_single_dimension per dim: reserved > available
        # → 0; zero requirement → unbounded; else exact floor division
        diff = avail - overhead
        per_dim = np.where(
            overhead > avail,
            np.int64(0),
            np.where(
                row[None, :] == 0,
                np.int64(2**62),
                np.floor_divide(diff, np.maximum(row[None, :], 1)),
            ),
        )
        cap = per_dim.min(axis=1)
        candidates = np.flatnonzero(cap >= 1)
        if not len(candidates):
            return None
        app_nodes = self._get_nodes_with_executors_belonging_to_same_app(executor)
        not_in_app = np.fromiter(
            (names[i] not in app_nodes for i in candidates),
            dtype=bool,
            count=len(candidates),
        )
        order = np.lexsort((candidates, cap[candidates], not_in_app))
        return names[int(candidates[order[0]])]

    def _reschedule_executor_with_minimal_fragmentation(
        self,
        executor: Pod,
        executor_node_names: List[str],
        metadata,
        overhead,
        executor_resources,
    ) -> Optional[str]:
        """resource.go:675-703: prefer nodes already hosting this app, then
        least capacity."""
        capacities = cap.get_node_capacities(
            executor_node_names, metadata, overhead, executor_resources
        )
        app_nodes = self._get_nodes_with_executors_belonging_to_same_app(executor)

        best: Optional[cap.NodeAndExecutorCapacity] = None
        for node_capacity in capacities:
            if node_capacity.capacity >= 1:
                if best is None:
                    best = node_capacity
                elif node_capacity.node_name in app_nodes and best.node_name not in app_nodes:
                    best = node_capacity
                elif (node_capacity.node_name in app_nodes) == (best.node_name in app_nodes) and (
                    node_capacity.capacity < best.capacity
                ):
                    best = node_capacity
        return best.node_name if best is not None else None

    def _get_nodes_with_executors_belonging_to_same_app(self, executor: Pod) -> set:
        """resource.go:565-584."""
        nodes = set()
        app_id = executor.labels.get(L.SPARK_APP_ID_LABEL, "")
        rr = self._rrm.get_resource_reservation(app_id, executor.namespace)
        if rr is not None:
            for pod, reservation in rr.spec.reservations.items():
                if pod != DRIVER_RESERVATION_NAME:
                    nodes.add(reservation.node)
        sr, ok = self._rrm.get_soft_resource_reservation(app_id)
        if ok:
            for pod, reservation in sr.reservations.items():
                if pod != DRIVER_RESERVATION_NAME:
                    nodes.add(reservation.node)
        return nodes

    # -- single-AZ helpers ---------------------------------------------------

    def _get_common_zone_for_executors_application(self, executor: Pod) -> Tuple[str, bool]:
        """resource.go:493-515."""
        app_id = executor.labels.get(L.SPARK_APP_ID_LABEL)
        if app_id is None:
            raise SchedulingFailure(FAILURE_INTERNAL, "executor has no spark app id label")
        app_pods = self._pod_lister.list(
            namespace=executor.namespace, label_selector={L.SPARK_APP_ID_LABEL: app_id}
        )
        from ..types.objects import PodPhase

        running = [p for p in app_pods if p.phase == PodPhase.RUNNING]
        zones = set()
        for pod in running:
            node = self._node_informer.get("default", pod.node_name)
            if node is None:
                raise SchedulingFailure(FAILURE_INTERNAL, f"node {pod.node_name} not found")
            zone = node.labels.get(ZONE_LABEL)
            if zone is None:
                raise SchedulingFailure(
                    FAILURE_INTERNAL, "could not read zone label from node"
                )
            zones.add(zone)
        if len(zones) > 1:
            return "", False
        if len(zones) == 0:
            raise SchedulingFailure(
                FAILURE_INTERNAL,
                "application has no scheduled pods, can't make scheduling decisions based on AZ",
            )
        return next(iter(zones)), True

    def _filter_nodes_to_zone(self, nodes: List[Node], zone: str) -> List[Node]:
        """resource.go:463-478."""
        out = []
        for node in nodes:
            zone_label = node.labels.get(ZONE_LABEL)
            if zone_label is None:
                raise SchedulingFailure(
                    FAILURE_INTERNAL, "could not read zone label from node"
                )
            if zone_label == zone:
                out.append(node)
        return out

    # -- metrics -------------------------------------------------------------

    def _report_placement_metrics(self, instance_group, packing_result, zones) -> None:
        executor_nodes = set(packing_result.executor_nodes)
        self._metrics.gauge(
            mnames.DRIVER_EXECUTOR_COLLOCATION,
            1.0 if packing_result.driver_node in executor_nodes else 0.0,
            {"instanceGroup": instance_group},
        )
        self._metrics.gauge(
            mnames.EXECUTOR_NODE_COUNT,
            float(len(executor_nodes)),
            {"instanceGroup": instance_group},
        )
        used_zones = {zones.get(n, "") for n in executor_nodes | {packing_result.driver_node}}
        self._metrics.gauge(
            mnames.APP_CROSS_ZONE,
            1.0 if len(used_zones) > 1 else 0.0,
            {"instanceGroup": instance_group},
        )
