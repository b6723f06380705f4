"""Demand manager (reference ``internal/demands/demand.go``).

Creates Demand CRs when an app or executor doesn't fit (signaling the
cluster autoscaler) and deletes them on success, with event emission and
source attribution.  Demand name = ``demand-<podName>``
(internal/common/utils/demands.go:60-62).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..events import events as ev
from ..ops.registry import Binpacker
from ..scheduler.labels import SPARK_APP_ID_LABEL, find_instance_group_from_pod_spec
from ..state.typed_caches import SafeDemandCache
from ..types.objects import (
    Demand,
    DemandSpec,
    DemandUnit,
    ObjectMeta,
    OwnerReference,
    Pod,
)
from ..types.resources import Resources

logger = logging.getLogger(__name__)


def demand_name(pod: Pod) -> str:
    return "demand-" + pod.name


class DemandManager:
    """demands.Manager (demand.go:37-42)."""

    def __init__(
        self,
        demands: SafeDemandCache,
        binpacker: Binpacker,
        instance_group_label: str,
        event_log: Optional[ev.EventLog] = None,
    ):
        self._demands = demands
        self._binpacker = binpacker
        self._instance_group_label = instance_group_label
        self._event_log = event_log

    # -- create --------------------------------------------------------------

    def create_demand_for_application_in_any_zone(
        self, driver_pod: Pod, application_resources
    ) -> None:
        if not self._demands.crd_exists():
            return
        self._create_demand(
            driver_pod, self._application_units(driver_pod, application_resources), None
        )

    def create_demand_for_executor_in_any_zone(
        self, executor_pod: Pod, executor_resources: Resources
    ) -> None:
        self.create_demand_for_executor_in_specific_zone(executor_pod, executor_resources, None)

    def create_demand_for_executor_in_specific_zone(
        self, executor_pod: Pod, executor_resources: Resources, zone: Optional[str]
    ) -> None:
        if not self._demands.crd_exists():
            return
        units = [
            DemandUnit(
                count=1,
                resources=executor_resources,
                pod_names_by_namespace={executor_pod.namespace: [executor_pod.name]},
            )
        ]
        self._create_demand(executor_pod, units, zone)

    def _create_demand(self, pod: Pod, units: List[DemandUnit], zone: Optional[str]) -> None:
        instance_group, ok = find_instance_group_from_pod_spec(pod, self._instance_group_label)
        if not ok:
            logger.error(
                "no instance group label %s on pod %s; skipping demand",
                self._instance_group_label,
                pod.name,
            )
            return
        demand = self._new_demand(pod, instance_group, units, zone)
        if demand is None:
            return
        try:
            self._demands.create(demand)
        except Exception:
            # demand already exists for this pod → no action (demand.go:120-126)
            if self._demands.get(demand.namespace, demand.name) is not None:
                return
            logger.exception("failed to create demand %s", demand.name)
            return
        ev.emit_demand_created(demand, self._event_log)

    def _new_demand(
        self, pod: Pod, instance_group: str, units: List[DemandUnit], zone: Optional[str]
    ) -> Optional[Demand]:
        """demand.go:149-173."""
        app_id = pod.labels.get(SPARK_APP_ID_LABEL)
        if app_id is None:
            logger.error("pod %s has no %s label", pod.name, SPARK_APP_ID_LABEL)
            return None
        return Demand(
            meta=ObjectMeta(
                name=demand_name(pod),
                namespace=pod.namespace,
                labels={SPARK_APP_ID_LABEL: app_id},
                owner_references=[
                    OwnerReference(kind="Pod", name=pod.name, uid=pod.meta.uid)
                ],
            ),
            spec=DemandSpec(
                instance_group=instance_group,
                units=units,
                enforce_single_zone_scheduling=self._binpacker.is_single_az,
                zone=zone,
            ),
        )

    @staticmethod
    def _application_units(driver_pod: Pod, application_resources) -> List[DemandUnit]:
        """demand.go:175-201: 1 driver unit (deduped by pod name) +
        min-executor-count executor units."""
        units = [
            DemandUnit(
                count=1,
                resources=application_resources.driver_resources,
                pod_names_by_namespace={driver_pod.namespace: [driver_pod.name]},
            )
        ]
        if application_resources.min_executor_count > 0:
            units.append(
                DemandUnit(
                    count=application_resources.min_executor_count,
                    resources=application_resources.executor_resources,
                )
            )
        return units

    # -- delete --------------------------------------------------------------

    def delete_demand_if_exists(self, pod: Pod, source: str) -> None:
        """demand.go:136-147."""
        if not self._demands.crd_exists():
            return
        name = demand_name(pod)
        demand = self._demands.get(pod.namespace, name)
        if demand is not None:
            self._demands.delete(pod.namespace, name)
            ev.emit_demand_deleted(demand, source, self._event_log)
