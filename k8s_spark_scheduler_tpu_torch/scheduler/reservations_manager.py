"""ResourceReservationManager (reference
``internal/extender/resourcereservations.go``): the single authority for
creating/binding/querying hard (CRD) and soft (in-memory) reservations,
unbound-reservation discovery, and dynamic-allocation compaction."""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from .. import timesource
from ..kube.informer import Informer
from ..analysis.guarded import guarded_by
from ..state.softreservations import SoftReservation, SoftReservationStore
from ..state.typed_caches import ResourceReservationCache
from ..types.objects import (
    ObjectMeta,
    OwnerReference,
    Pod,
    Reservation,
    ResourceReservation,
    ResourceReservationSpec,
    ResourceReservationStatus,
    now,
)
from ..types.resources import NodeGroupResources, Resources, usage_for_nodes
from . import labels as L
from .sparkpods import SparkApplicationResources, SparkPodLister, spark_resources

logger = logging.getLogger(__name__)

# slow time-to-first-bind log threshold (resourcereservations.go:42-44)
SLOW_LOG_DURATION_SECONDS = 120.0

DRIVER_RESERVATION_NAME = "driver"


def executor_reservation_name(i: int) -> str:
    """resourcereservations.go:531-533 (1-based)."""
    return f"executor-{i + 1}"


def new_resource_reservation(
    driver_node: str,
    executor_nodes: List[str],
    driver: Pod,
    driver_resources: Resources,
    executor_resources: Resources,
) -> ResourceReservation:
    """resourcereservations.go:491-528."""
    reservations: Dict[str, Reservation] = {
        DRIVER_RESERVATION_NAME: Reservation.for_resources(driver_node, driver_resources)
    }
    for idx, node_name in enumerate(executor_nodes):
        reservations[executor_reservation_name(idx)] = Reservation.for_resources(
            node_name, executor_resources
        )
    app_id = driver.labels.get(L.SPARK_APP_ID_LABEL, "")
    return ResourceReservation(
        meta=ObjectMeta(
            name=app_id,
            namespace=driver.namespace,
            creation_timestamp=now(),
            labels={L.SPARK_APP_ID_LABEL: app_id},
            owner_references=[OwnerReference(kind="Pod", name=driver.name, uid=driver.meta.uid)],
        ),
        spec=ResourceReservationSpec(reservations=reservations),
        status=ResourceReservationStatus(pods={DRIVER_RESERVATION_NAME: driver.name}),
    )


@guarded_by("_da_compaction_lock", "_da_compaction_apps")
class ResourceReservationManager:
    """resourcereservations.go:68-102."""

    def __init__(
        self,
        resource_reservations: ResourceReservationCache,
        soft_reservation_store: SoftReservationStore,
        pod_lister: SparkPodLister,
        pod_informer: Informer,
        metrics=None,
        tracer=None,
    ):
        from ..metrics.registry import default_registry
        from ..tracing import default_tracer

        self._resource_reservations = resource_reservations
        self._soft_reservations = soft_reservation_store
        self._metrics = metrics if metrics is not None else default_registry
        self._tracer = tracer if tracer is not None else default_tracer
        self._pod_lister = pod_lister
        self._mutex = threading.RLock()
        self._da_compaction_apps: Dict[str, str] = {}  # appID → namespace
        self._da_compaction_lock = threading.Lock()
        pod_informer.add_event_handler(
            on_delete=self._on_executor_pod_deletion,
            filter_func=L.is_spark_scheduler_executor_pod,
        )

    # -- reads ---------------------------------------------------------------

    def get_resource_reservation(self, app_id: str, namespace: str) -> Optional[ResourceReservation]:
        return self._resource_reservations.get(namespace, app_id)

    def get_soft_resource_reservation(self, app_id: str) -> Tuple[SoftReservation, bool]:
        return self._soft_reservations.get_soft_reservation(app_id)

    def pod_has_reservation(self, pod: Pod) -> bool:
        """resourcereservations.go:115-132."""
        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL)
        if app_id is None:
            return False
        rr = self.get_resource_reservation(app_id, pod.namespace)
        if rr is not None and pod.name in rr.status.pods.values():
            return True
        if pod.labels.get(L.SPARK_ROLE_LABEL) == L.EXECUTOR:
            if self._soft_reservations.executor_has_soft_reservation(pod):
                return True
        return False

    def get_reserved_resources(self) -> NodeGroupResources:
        """All hard reservations + soft reservations per node
        (resourcereservations.go:258-263)."""
        usage = usage_for_nodes(self._resource_reservations.list())
        for node, r in self._soft_reservations.used_soft_reservation_resources().items():
            usage[node] = usage.get(node, Resources.zero()).add(r)
        return usage

    # -- creation ------------------------------------------------------------

    def create_reservations(
        self,
        driver: Pod,
        application_resources: SparkApplicationResources,
        driver_node: str,
        executor_nodes: List[str],
    ) -> ResourceReservation:
        """resourcereservations.go:136-159."""
        app_id = driver.labels.get(L.SPARK_APP_ID_LABEL, "")
        with self._tracer.span(
            "reservation.writeback",
            {"app": app_id, "executors": len(executor_nodes)},
        ) as sp:
            rr = self.get_resource_reservation(app_id, driver.namespace)
            sp.tag("replay", rr is not None)
            if rr is None:
                rr = new_resource_reservation(
                    driver_node,
                    executor_nodes,
                    driver,
                    application_resources.driver_resources,
                    application_resources.executor_resources,
                )
                self._resource_reservations.create(rr)
                # the async write-back queue drains to the API server;
                # its depth at enqueue time is the staleness signal for
                # a slow write-back investigation
                try:
                    sp.tag(
                        "writeQueueDepth",
                        sum(self._resource_reservations.inflight_queue_lengths()),
                    )
                except Exception:
                    pass

            if application_resources.max_executor_count > application_resources.min_executor_count:
                # only DA apps can request extra executors
                self._soft_reservations.create_soft_reservation_if_not_exists(app_id)
            return rr

    # -- executor binding ----------------------------------------------------

    def find_already_bound_reservation_node(self, executor: Pod) -> Tuple[Optional[str], bool]:
        """Idempotent-retry path (resourcereservations.go:163-179)."""
        rr = self.get_resource_reservation(
            executor.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.namespace
        )
        if rr is None:
            raise KeyError("failed to get resource reservations")
        for name, reservation in rr.spec.reservations.items():
            if rr.status.pods.get(name) == executor.name:
                return reservation.node, True
        sr = self._soft_reservations.get_executor_soft_reservation(executor)
        if sr is not None:
            return sr.node, True
        return None, False

    def find_unbound_reservation_nodes(self, executor: Pod) -> Tuple[List[str], bool]:
        """resourcereservations.go:184-196."""
        unbound = self._get_unbound_reservations(
            executor.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.namespace
        )
        nodes = sorted(set(unbound.values()))
        return nodes, len(nodes) > 0

    def get_remaining_allowed_executor_count(self, app_id: str, namespace: str) -> int:
        """unbound hard reservations + free soft spots
        (resourcereservations.go:199-209)."""
        unbound = self._get_unbound_reservations(app_id, namespace)
        return len(unbound) + self._get_free_soft_reservation_spots(app_id, namespace)

    def reserve_for_executor_on_unbound_reservation(self, executor: Pod, node: str) -> None:
        """resourcereservations.go:213-228."""
        with self._mutex:
            unbound = self._get_unbound_reservations(
                executor.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.namespace
            )
            for reservation_name, reservation_node in unbound.items():
                if reservation_node == node:
                    self._bind_executor_to_resource_reservation(executor, reservation_name, node)
                    return
        raise RuntimeError("failed to find free reservation on requested node for executor")

    def reserve_for_executor_on_rescheduled_node(self, executor: Pod, node: str) -> None:
        """Rebind an unbound hard reservation onto a new node, else consume
        a soft spot (resourcereservations.go:232-255)."""
        with self._mutex:
            app_id = executor.labels.get(L.SPARK_APP_ID_LABEL, "")
            unbound = self._get_unbound_reservations(app_id, executor.namespace)
            if unbound:
                reservation_name = next(iter(unbound))
                self._bind_executor_to_resource_reservation(executor, reservation_name, node)
                return
            free_spots = self._get_free_soft_reservation_spots(app_id, executor.namespace)
            if free_spots > 0:
                self._bind_executor_to_soft_reservation(executor, node)
                return
        raise RuntimeError("failed to find free reservation for executor")

    # -- DA compaction -------------------------------------------------------

    def compact_dynamic_allocation_applications(self) -> None:
        """Move soft reservations onto hard reservations freed by dead
        executors (resourcereservations.go:268-298)."""
        apps = self._drain_da_compaction_apps()
        with self._mutex:
            for app_id, namespace in apps.items():
                sr, ok = self._soft_reservations.get_soft_reservation(app_id)
                if not ok:
                    continue
                pods = self._get_active_pods(app_id, namespace)
                for pod_name in list(sr.reservations):
                    pod = pods.get(pod_name)
                    if pod is None:
                        continue  # no longer active
                    self._compact_soft_reservation_pod(pod)

    def _compact_soft_reservation_pod(self, pod: Pod) -> None:
        """resourcereservations.go:302-336 (caller holds the mutex)."""
        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        try:
            unbound = self._get_unbound_reservations(app_id, pod.namespace)
        except KeyError:
            logger.exception("failed to get unbound reservations for %s", pod.name)
            return
        if not unbound:
            return
        # prefer an unbound reservation on the pod's own node
        for reservation_name, reservation_node in unbound.items():
            if reservation_node == pod.node_name:
                self._bind_executor_to_resource_reservation(pod, reservation_name, reservation_node)
                self._soft_reservations.remove_executor_reservation(app_id, pod.name)
                return
        # cross-node: bind keeping the RESERVATION's node (the reference
        # passes unboundReservationsToNodes[name], resourcereservations.go
        # :326-335 — the reservation stays on its node and, since the pod
        # runs elsewhere, remains discoverable as unbound for rebinding)
        reservation_name = next(iter(unbound))
        self._bind_executor_to_resource_reservation(
            pod, reservation_name, unbound[reservation_name]
        )
        self._soft_reservations.remove_executor_reservation(app_id, pod.name)

    def _drain_da_compaction_apps(self) -> Dict[str, str]:
        with self._da_compaction_lock:
            drained = dict(self._da_compaction_apps)
            self._da_compaction_apps = {}
            return drained

    def _on_executor_pod_deletion(self, pod: Pod) -> None:
        """resourcereservations.go:469-488: queue DA apps for compaction
        when an executor without a soft reservation dies (it may free a
        hard reservation a soft-reserved executor can take)."""
        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        _, has_soft_store = self._soft_reservations.get_soft_reservation(app_id)
        if has_soft_store and not self._soft_reservations.executor_has_soft_reservation(pod):
            with self._da_compaction_lock:
                self._da_compaction_apps[app_id] = pod.namespace

    # -- internals -----------------------------------------------------------

    def _bind_executor_to_resource_reservation(
        self, executor: Pod, reservation_name: str, node: str
    ) -> None:
        """resourcereservations.go:349-389."""
        rr = self.get_resource_reservation(
            executor.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.namespace
        )
        if rr is None:
            raise KeyError(f"failed to get resource reservation {reservation_name}")
        copy_rr = rr.deepcopy()
        reservation = copy_rr.spec.reservations[reservation_name]
        reservation.node = node
        first_bind = reservation_name not in rr.status.pods
        copy_rr.status.pods[reservation_name] = executor.name
        self._resource_reservations.update(copy_rr)

        # time-to-first-bind metric + slow log, only on the reservation's
        # first binding (resourcereservations.go:364-387)
        if first_bind and rr.meta.creation_timestamp:

            from ..metrics import names as mnames

            duration = timesource.now() - rr.meta.creation_timestamp
            self._metrics.histogram(mnames.TIME_TO_FIRST_BIND, duration)
            snap = self._metrics.get_histogram(mnames.TIME_TO_FIRST_BIND)
            self._metrics.gauge(mnames.TIME_TO_FIRST_BIND_MEDIAN, snap["p50"])
            self._metrics.gauge(mnames.TIME_TO_FIRST_BIND_MEAN, snap["mean"])
            if duration > SLOW_LOG_DURATION_SECONDS:
                logger.warning(
                    "time to first executor bind above threshold: "
                    "duration=%.0fs appID=%s node=%s executor=%s reservation=%s",
                    duration,
                    rr.labels.get(L.SPARK_APP_ID_LABEL, ""),
                    node,
                    executor.name,
                    reservation_name,
                )

    def _bind_executor_to_soft_reservation(self, executor: Pod, node: str) -> None:
        """resourcereservations.go:391-409."""
        driver = self._pod_lister.get_driver_pod_for_executor(executor)
        if driver is None:
            raise KeyError("failed to get driver pod for executor")
        app_resources = spark_resources(driver)
        reservation = Reservation.for_resources(node, app_resources.executor_resources)
        self._soft_reservations.add_reservation_for_pod(
            driver.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.name, reservation
        )

    def _get_unbound_reservations(self, app_id: str, namespace: str) -> Dict[str, str]:
        """reservationName → node for reservations that are unbound, bound
        to a dead executor, or bound to an executor now on another node
        (resourcereservations.go:413-432)."""
        rr = self.get_resource_reservation(app_id, namespace)
        if rr is None:
            raise KeyError("failed to get resource reservation")
        active_pods = self._get_active_pods(app_id, namespace)
        unbound: Dict[str, str] = {}
        for reservation_name, reservation in rr.spec.reservations.items():
            pod_identifier = rr.status.pods.get(reservation_name)
            pod = active_pods.get(pod_identifier) if pod_identifier is not None else None
            if (
                pod_identifier is None
                or pod is None
                or (pod.node_name != "" and pod.node_name != reservation.node)
            ):
                unbound[reservation_name] = reservation.node
        return unbound

    def _get_free_soft_reservation_spots(self, app_id: str, namespace: str) -> int:
        """resourcereservations.go:434-451."""
        sr, ok = self._soft_reservations.get_soft_reservation(app_id)
        if not ok:
            return 0
        used = len(sr.reservations)
        driver = self._pod_lister.get_driver_pod(app_id, namespace)
        if driver is None:
            raise KeyError("failed to get driver pod")
        app_resources = spark_resources(driver)
        max_extra = app_resources.max_executor_count - app_resources.min_executor_count
        return max(max_extra - used, 0)

    def _get_active_pods(self, app_id: str, namespace: str) -> Dict[str, Pod]:
        """resourcereservations.go:454-467."""
        pods = self._pod_lister.list(
            namespace=namespace, label_selector={L.SPARK_APP_ID_LABEL: app_id}
        )
        return {p.name: p for p in pods if not L.is_pod_terminated(p)}
