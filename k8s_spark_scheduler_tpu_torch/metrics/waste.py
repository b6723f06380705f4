"""WasteMetricsReporter (reference internal/metrics/waste.go:67-293).

Attributes a pod's time-to-schedule to phases around Demand creation and
fulfillment, so autoscaler-induced delays are visible:

- ``total-time-no-demand``: pod scheduled without ever needing a demand
- ``before-demand-creation``: pod creation → demand creation
- ``after-demand-fulfilled``: demand fulfilled → pod scheduled, plus the
  no-failures / since-last-failure / failure-<outcome> split depending on
  failed scheduling attempts after fulfillment

Best-effort in-memory state, cleaned up after 6h (waste.go:33-35).
``slo_sink`` forwards every waste sample to the SLO engine's
eviction_waste objective (lifecycle/slo.py); ``scheduling_info`` is the
capacity observatory's read-out of a pod's demand phase boundaries.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .. import timesource
from ..demands.manager import pod_name_from_demand
from ..scheduler import labels as L
from ..types.objects import Demand, Pod
from . import names
from .registry import MetricsRegistry
from ..analysis.guarded import guarded_by

logger = logging.getLogger(__name__)

DEMAND_FULFILLED_AGE_CLEANUP_SECONDS = 6 * 3600.0
SLOW_WASTE_LOG_SECONDS = 60.0
SLOW_NO_DEMAND_LOG_SECONDS = 600.0


@dataclass
class _PodSchedulingInfo:
    demand_created_at: Optional[float] = None
    demand_fulfilled_at: Optional[float] = None
    last_failure_at: Optional[float] = None
    last_failure_outcome: str = ""
    created_at: float = field(default_factory=timesource.now)


@guarded_by("_lock", "_info")
class WasteMetricsReporter:
    def __init__(self, metrics: MetricsRegistry, instance_group_label: str):
        self._metrics = metrics
        self._instance_group_label = instance_group_label
        self._lock = threading.Lock()
        self._info: Dict[Tuple[str, str], _PodSchedulingInfo] = {}
        # SLO hook (server/wiring.py): ``slo_sink(waste_type, duration)``
        # forwards every waste sample to the eviction_waste objective —
        # this reporter is the single source of truth for waste, so the
        # SLO engine never re-derives it from raw informer events
        self.slo_sink = None

    # -- wiring (waste.go:88-120) -------------------------------------------

    def start(self, pod_informer, lazy_demand_informer) -> None:
        pod_informer.add_event_handler(
            on_update=self._on_pod_update,
            on_delete=self._on_pod_deleted,
            filter_func=L.is_spark_scheduler_pod,
        )

        def wire_demands() -> None:
            informer = lazy_demand_informer.informer()
            if informer is None:
                return
            informer.add_event_handler(
                on_add=self._on_demand_created,
                on_update=self._on_demand_update,
                filter_func=lambda d: L.SPARK_APP_ID_LABEL in d.labels,
            )

        lazy_demand_informer.on_ready(wire_demands)

    # -- events --------------------------------------------------------------

    def mark_failed_scheduling_attempt(self, pod: Pod, outcome: str) -> None:
        """waste.go:147-186 (channel replaced by a direct locked update)."""
        with self._lock:
            info = self._get_or_create(pod.namespace, pod.name)
            info.last_failure_at = timesource.now()
            info.last_failure_outcome = outcome

    def _on_demand_created(self, demand: Demand) -> None:
        pod_name = pod_name_from_demand(demand)
        with self._lock:
            info = self._get_or_create(demand.namespace, pod_name)
            # the demand's own creation timestamp, not delivery time
            # (waste.go:245-254) — synthetic informer replays after a
            # restart must not reset the phase boundary
            info.demand_created_at = demand.creation_timestamp or timesource.now()

    def _on_demand_update(self, old: Demand, new: Demand) -> None:
        from ..types.objects import DemandPhase

        old_fulfilled = old is not None and old.status.phase == DemandPhase.FULFILLED
        if not old_fulfilled and new.status.phase == DemandPhase.FULFILLED:
            pod_name = pod_name_from_demand(new)
            with self._lock:
                info = self._get_or_create(new.namespace, pod_name)
                info.demand_fulfilled_at = timesource.now()
                info.demand_created_at = new.creation_timestamp or info.demand_created_at

    def _on_pod_update(self, old: Optional[Pod], new: Pod) -> None:
        if not L.on_pod_scheduled(old, new):
            return
        self._on_pod_scheduled(new)

    def _on_pod_scheduled(self, pod: Pod) -> None:
        """waste.go:196-222."""
        now = timesource.now()
        with self._lock:
            info = self._info.pop((pod.namespace, pod.name), None)
        instance_group, _ = L.find_instance_group_from_pod_spec(pod, self._instance_group_label)

        if info is None or info.demand_created_at is None:
            created = pod.creation_timestamp or (info.created_at if info else now)
            self._mark(pod, instance_group, "total-time-no-demand", now - created,
                       SLOW_NO_DEMAND_LOG_SECONDS)
            return

        self._mark(
            pod,
            instance_group,
            "before-demand-creation",
            info.demand_created_at - (pod.creation_timestamp or info.created_at),
            SLOW_WASTE_LOG_SECONDS,
        )
        if info.demand_fulfilled_at is not None:
            self._mark(
                pod,
                instance_group,
                "after-demand-fulfilled",
                now - info.demand_fulfilled_at,
                SLOW_WASTE_LOG_SECONDS,
            )
            if info.last_failure_at is None or info.last_failure_at < info.demand_fulfilled_at:
                self._mark(
                    pod,
                    instance_group,
                    "after-demand-fulfilled-no-failures",
                    now - info.demand_fulfilled_at,
                    SLOW_WASTE_LOG_SECONDS,
                )
            else:
                # waste.go:211-215: the failure-<outcome> phase measures
                # fulfillment → last failed attempt; since-last-failure
                # measures last failed attempt → scheduled
                self._mark(
                    pod,
                    instance_group,
                    f"after-demand-fulfilled-failure-{info.last_failure_outcome}",
                    info.last_failure_at - info.demand_fulfilled_at,
                    SLOW_WASTE_LOG_SECONDS,
                )
                self._mark(
                    pod,
                    instance_group,
                    "after-demand-fulfilled-since-last-failure",
                    now - info.last_failure_at,
                    SLOW_WASTE_LOG_SECONDS,
                )

    def _on_pod_deleted(self, pod: Pod) -> None:
        with self._lock:
            self._info.pop((pod.namespace, pod.name), None)

    # -- internals -----------------------------------------------------------

    def _mark(self, pod: Pod, instance_group: str, waste_type: str, duration: float,
              slow_threshold: float) -> None:
        duration = max(duration, 0.0)
        self._metrics.histogram(
            names.SCHEDULING_WASTE, duration, {names.TAG_WASTE_TYPE: waste_type}
        )
        self._metrics.histogram(
            names.SCHEDULING_WASTE_PER_INSTANCE_GROUP,
            duration,
            {names.TAG_WASTE_TYPE: waste_type, names.TAG_INSTANCE_GROUP: instance_group},
        )
        if duration > slow_threshold:
            logger.warning(
                "scheduling waste above threshold: pod=%s/%s type=%s duration=%.1fs",
                pod.namespace,
                pod.name,
                waste_type,
                duration,
            )
        if self.slo_sink is not None:
            try:
                self.slo_sink(waste_type, duration)
            except Exception:  # the sink must never break pod handling
                logger.exception("slo waste sink failed")

    def _get_or_create(self, namespace: str, pod_name: str) -> _PodSchedulingInfo:
        info = self._info.get((namespace, pod_name))
        if info is None:
            # every caller holds _lock
            info = self._info[(namespace, pod_name)] = _PodSchedulingInfo()  # schedlint: disable=LK001 -- private helper, every caller holds _lock (see callers)
        return info

    def cleanup_metric_cache(self) -> None:
        """waste.go:160-172: drop entries older than 6h."""
        cutoff = timesource.now() - DEMAND_FULFILLED_AGE_CLEANUP_SECONDS
        with self._lock:
            stale = [k for k, v in self._info.items() if v.created_at < cutoff]
            for k in stale:
                logger.warning(
                    "deleting pod from scheduling waste reporter, not scheduled for 6 hours: %s/%s",
                    k[0],
                    k[1],
                )
                del self._info[k]

    def scheduling_info(self, namespace: str, pod_name: str):
        """Read-only view of a pod's demand phase boundaries for the
        capacity observatory's time-to-admit forecast (None when the
        reporter has never seen the pod)."""
        with self._lock:
            info = self._info.get((namespace, pod_name))
            if info is None:
                return None
            return {
                "createdAt": info.created_at,
                "demandCreatedAt": info.demand_created_at,
                "demandFulfilledAt": info.demand_fulfilled_at,
                "lastFailureOutcome": info.last_failure_outcome or None,
            }
