"""Failover reconciliation (reference ``internal/extender/failover.go``).

Async write-back means reservation writes can be lost on leader change;
before serving requests after an idle period the extender rebuilds:
hard reservations for scheduled pods missing from any RR, soft
reservations for DA extra executors, and deletes demands of
now-scheduled pods.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..types.objects import Node, Pod, PodPhase, Reservation
from ..types.resources import (
    NodeGroupResources,
    Resources,
    available_for_nodes,
    group_add,
    usage_for_nodes,
)
from . import labels as L
from .reservations_manager import (
    executor_reservation_name,
    new_resource_reservation,
)
from .sparkpods import AnnotationError, spark_resources

logger = logging.getLogger(__name__)


@dataclass
class _SparkPods:
    """failover.go:84-91: stale state for one app."""

    app_id: str
    inconsistent_driver: Optional[Pod] = None
    inconsistent_executors: List[Pod] = field(default_factory=list)


def sync_resource_reservations_and_demands(extender) -> None:
    """failover.go:43-82.  `extender` is the SparkSchedulerExtender; the
    reconciler reads through its wired components."""
    pods = extender._pod_lister.list()
    nodes = extender._node_informer.list()
    rrs = extender._resource_reservations.list()
    fast = _available_resources_fast(extender, nodes)
    if fast is not None:
        available, ordered_nodes = fast
    else:
        overhead = extender._overhead.get_overhead(nodes)
        soft_overhead = (
            extender._soft_reservation_store.used_soft_reservation_resources()
        )
        available, ordered_nodes = _available_resources_per_instance_group(
            extender._instance_group_label, rrs, nodes, overhead, soft_overhead
        )
    stale = _unreserved_spark_pods_by_spark_id(rrs, extender._soft_reservation_store, pods)
    logger.info("starting reconciliation for %d stale apps", len(stale))

    r = _Reconciler(
        pod_lister=extender._pod_lister,
        resource_reservations=extender._resource_reservations,
        soft_reservations=extender._soft_reservation_store,
        demands=extender._demands,
        available_resources=available,
        ordered_nodes=ordered_nodes,
        instance_group_label=extender._instance_group_label,
    )

    extra_executors_with_no_rrs: Dict[str, List[Pod]] = {}
    for sp in stale.values():
        extra = r.sync_resource_reservations(sp)
        if extra:
            extra_executors_with_no_rrs[sp.app_id] = extra
        r.sync_demands(sp)
    r.sync_soft_reservations(extra_executors_with_no_rrs)


def _unreserved_spark_pods_by_spark_id(
    rrs, soft_store, pods: List[Pod]
) -> Dict[str, _SparkPods]:
    """failover.go:243-280: scheduled spark pods missing from every
    RR.Status.Pods and the soft store."""
    pods_with_rrs = set()
    for rr in rrs:
        for pod_name in rr.status.pods.values():
            pods_with_rrs.add(pod_name)

    by_app: Dict[str, _SparkPods] = {}
    for pod in pods:
        if _is_not_scheduled_spark_pod(pod) or pod.name in pods_with_rrs:
            continue
        if pod.labels.get(L.SPARK_ROLE_LABEL) == L.EXECUTOR and soft_store.executor_has_soft_reservation(pod):
            continue
        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        sp = by_app.setdefault(app_id, _SparkPods(app_id=app_id))
        role = pod.labels.get(L.SPARK_ROLE_LABEL)
        if role == L.DRIVER:
            sp.inconsistent_driver = pod
        elif role == L.EXECUTOR:
            sp.inconsistent_executors.append(pod)
        else:
            logger.error("received non spark pod %s, ignoring", pod.name)
    return by_app


def _is_not_scheduled_spark_pod(pod: Pod) -> bool:
    """failover.go:282-284."""
    return (
        pod.scheduler_name != L.SPARK_SCHEDULER_NAME
        or pod.meta.deletion_timestamp is not None
        or pod.node_name == ""
    )


class _LazyNodeGroupResources(dict):
    """NodeGroupResources materialized on demand from exact integer
    availability rows.  Reconciliation touches only the handful of nodes
    the greedy filler probes, so constructing 3 Quantities for every
    node in a 10k-node snapshot up front (the dominant reconcile cost)
    is wasted work; reads through [] / .get build entries lazily and
    writes behave like a plain dict."""

    def __init__(self, rows_by_name):
        super().__init__()
        self._rows = rows_by_name  # name → int64 base-unit row

    def __missing__(self, name):
        row = self._rows[name]  # KeyError for unknown nodes, like the eager map
        res = _resources_from_base_row(row)
        self[name] = res
        return res

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default


def _resources_from_base_row(row) -> Resources:
    from fractions import Fraction

    from ..utils.quantity import Quantity

    return Resources(
        Quantity(Fraction(int(row[0]), 1000)),
        Quantity(int(row[1])),
        Quantity(Fraction(int(row[2]), 1000)),
    )


def _schedulable_nodes_by_group(
    instance_group_label: str, nodes: List[Node]
) -> Dict[str, List[Node]]:
    """failover.go:286-323's node-eligibility step, shared by both
    availability lanes: ready schedulable nodes grouped by instance
    group, newest first."""
    ordered = sorted(nodes, key=lambda n: n.creation_timestamp, reverse=True)
    schedulable: Dict[str, List[Node]] = {}
    for n in ordered:
        if n.unschedulable or not n.ready:
            continue
        group = n.labels.get(instance_group_label, "")
        schedulable.setdefault(group, []).append(n)
    return schedulable


def _available_resources_fast(extender, nodes: List[Node]):
    """The reconcile availability map served from the tensor mirror:
    identical values to _available_resources_per_instance_group
    (mirror avail = allocatable − reservations − overhead − soft, proven
    by tests/test_tensor_snapshot.py), with per-node Resources built
    only when the reconciler actually reads them.  Returns None when the
    mirror fast paths are disabled (_fast_path_ok, the same kill switch
    the extender's other mirror lanes honor), the mirror is absent or
    inexact, or it is out of step with the informer."""
    cache = getattr(extender, "_tensor_snapshot", None)
    if cache is None or not getattr(extender, "_fast_path_ok", False):
        return None
    snap = cache.snapshot()
    if not snap.exact:
        return None
    index = snap.name_index
    rows = snap.avail
    schedulable = _schedulable_nodes_by_group(extender._instance_group_label, nodes)
    available = {}
    for group, ns in schedulable.items():
        group_rows = {}
        for n in ns:
            i = index.get(n.name)
            if i is None:
                return None  # informer/mirror drift: take the exact path
            group_rows[n.name] = rows[i]
        available[group] = _LazyNodeGroupResources(group_rows)
    return available, schedulable


def _available_resources_per_instance_group(
    instance_group_label: str,
    rrs,
    nodes: List[Node],
    overhead: NodeGroupResources,
    soft_reservation_overhead: NodeGroupResources,
):
    """failover.go:286-323: ready schedulable nodes grouped by instance
    group (newest first), availability = allocatable − RRs − overhead −
    soft usage."""
    schedulable = _schedulable_nodes_by_group(instance_group_label, nodes)

    usages = usage_for_nodes(rrs)
    group_add(usages, overhead)
    group_add(usages, soft_reservation_overhead)
    available = {
        group: available_for_nodes(ns, usages) for group, ns in schedulable.items()
    }
    return available, schedulable


@dataclass
class _Reconciler:
    """failover.go:95-103."""

    pod_lister: object
    resource_reservations: object
    soft_reservations: object
    demands: object
    available_resources: Dict[str, NodeGroupResources]
    ordered_nodes: Dict[str, List[Node]]
    instance_group_label: str

    def sync_resource_reservations(self, sp: _SparkPods) -> List[Pod]:
        """failover.go:105-163."""
        extra_executors: List[Pod] = []
        if sp.inconsistent_driver is None and sp.inconsistent_executors:
            # driver keeps its RR: claim reservations for orphan executors
            exec0 = sp.inconsistent_executors[0]
            rr = self.resource_reservations.get(exec0.namespace, sp.app_id)
            if rr is None:
                logger.error("resource reservation deleted, ignoring %s", sp.app_id)
                return []
            new_rr = self._patch_resource_reservation(sp.inconsistent_executors, rr.deepcopy())
            if new_rr is None:
                return []
            pods_with_rr = set(new_rr.status.pods.values())
            for executor in sp.inconsistent_executors:
                if executor.name not in pods_with_rr:
                    extra_executors.append(executor)
        elif sp.inconsistent_driver is not None:
            # driver stale: a fresh RR must be constructed
            try:
                app_resources = self._get_app_resources(sp)
            except (AnnotationError, KeyError) as err:
                logger.error("could not get app resources for %s: %s", sp.app_id, err)
                return []
            group, _ = L.find_instance_group_from_pod_spec(
                sp.inconsistent_driver, self.instance_group_label
            )
            end_idx = min(len(sp.inconsistent_executors), app_resources.min_executor_count)
            executors_up_to_min = sp.inconsistent_executors[:end_idx]
            extra_executors = sp.inconsistent_executors[end_idx:]

            built = self._construct_resource_reservation(
                sp.inconsistent_driver, executors_up_to_min, group, app_resources
            )
            if built is None:
                return []
            new_rr, reserved = built
            try:
                self.resource_reservations.create(new_rr)
            except Exception:
                logger.info("resource reservation already exists for %s, force updating", sp.app_id)
                try:
                    self.resource_reservations.update(new_rr)
                except Exception:
                    logger.error("resource reservation deleted, ignoring %s", sp.app_id)
                    return []
            group_avail = self.available_resources.get(group)
            if group_avail is not None:
                for node, res in reserved.items():
                    group_avail[node] = group_avail.get(node, Resources.zero()).sub(res)
        return extra_executors

    def sync_demands(self, sp: _SparkPods) -> None:
        """failover.go:165-172."""
        if sp.inconsistent_driver is not None:
            self.demands.delete_demand_if_exists(sp.inconsistent_driver, "Reconciler")
        for e in sp.inconsistent_executors:
            self.demands.delete_demand_if_exists(e, "Reconciler")

    def sync_soft_reservations(self, extra_executors_by_app: Dict[str, List[Pod]]) -> None:
        """failover.go:174-212."""
        self._sync_application_soft_reservations()
        for app_id, extra_executors in extra_executors_by_app.items():
            driver = self.pod_lister.get_driver_pod_for_executor(extra_executors[0])
            if driver is None:
                logger.error("error getting driver pod for app %s, skipping", app_id)
                continue
            try:
                app_resources = spark_resources(driver)
            except AnnotationError:
                logger.exception("error getting spark resources for app %s, skipping", app_id)
                continue
            max_extra = app_resources.max_executor_count - app_resources.min_executor_count
            for i, extra_executor in enumerate(extra_executors):
                if i >= max_extra:
                    break
                try:
                    self.soft_reservations.add_reservation_for_pod(
                        app_id,
                        extra_executor.name,
                        Reservation.for_resources(
                            extra_executor.node_name, app_resources.executor_resources
                        ),
                    )
                except KeyError:
                    logger.exception("failed to add soft reservation on failover")

    def _sync_application_soft_reservations(self) -> None:
        """failover.go:216-241: prefill the store with running DA drivers."""
        drivers = self.pod_lister.list(label_selector={L.SPARK_ROLE_LABEL: L.DRIVER})
        for d in drivers:
            if (
                d.scheduler_name != L.SPARK_SCHEDULER_NAME
                or d.node_name == ""
                or d.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)
            ):
                continue
            try:
                app_resources = spark_resources(d)
            except AnnotationError:
                logger.exception("failed to get driver resources, skipping driver %s", d.name)
                continue
            if app_resources.max_executor_count > app_resources.min_executor_count:
                self.soft_reservations.create_soft_reservation_if_not_exists(
                    d.labels.get(L.SPARK_APP_ID_LABEL, "")
                )

    def _patch_resource_reservation(self, execs: List[Pod], rr):
        """failover.go:325-346: claim reservations on matching nodes for
        orphan executors (unbound, or bound to a gone/terminated pod)."""
        for e in execs:
            for name, reservation in rr.spec.reservations.items():
                if reservation.node != e.node_name:
                    continue
                current_pod_name = rr.status.pods.get(name)
                if current_pod_name is None:
                    rr.status.pods[name] = e.name
                    break
                pod = self.pod_lister.informer.get(e.namespace, current_pod_name)
                if pod is None or L.is_pod_terminated(pod):
                    rr.status.pods[name] = e.name
                    break
        try:
            self.resource_reservations.update(rr)
        except Exception:
            logger.error("resource reservation deleted, ignoring %s", rr.name)
            return None
        return rr

    def _construct_resource_reservation(
        self, driver: Pod, executors: List[Pod], group: str, app_resources
    ):
        """failover.go:348-390."""
        nodes = self.ordered_nodes.get(group)
        available = self.available_resources.get(group)
        if nodes is None or available is None:
            logger.error("instance group %r not found", group)
            return None

        reserved_node_names: List[str] = []
        reserved: NodeGroupResources = {}
        to_assign = app_resources.min_executor_count - len(executors)
        if to_assign > 0:
            reserved_node_names, reserved = _find_nodes(
                to_assign, app_resources.executor_resources, available, nodes
            )
            if len(reserved_node_names) < to_assign:
                logger.error("could not reserve space for all executors of %s", driver.name)

        executor_nodes = [e.node_name for e in executors] + reserved_node_names
        rr = new_resource_reservation(
            driver.node_name,
            executor_nodes,
            driver,
            app_resources.driver_resources,
            app_resources.executor_resources,
        )
        for i, e in enumerate(executors):
            rr.status.pods[executor_reservation_name(i)] = e.name
        return rr, reserved

    def _get_app_resources(self, sp: _SparkPods):
        """failover.go:392-407."""
        if sp.inconsistent_driver is not None:
            driver = sp.inconsistent_driver
        elif sp.inconsistent_executors:
            driver = self.pod_lister.get_driver_pod_for_executor(sp.inconsistent_executors[0])
            if driver is None:
                raise KeyError("error getting driver pod for executor")
        else:
            raise KeyError("no inconsistent driver or executor")
        return spark_resources(driver)


def _find_nodes(
    executor_count: int,
    executor_resources: Resources,
    available_resources: NodeGroupResources,
    ordered_nodes: List[Node],
):
    """failover.go:412-436: greedy fill in node order.

    QUIRK: the failed probe is NOT subtracted back (failover.go:424-427),
    so the returned reserved map is inflated by one executor per exhausted
    node — and that inflated map is subtracted from instance-group
    availability by the caller.  Reference behavior, kept for parity.
    """
    executor_node_names: List[str] = []
    reserved: NodeGroupResources = {}
    for n in ordered_nodes:
        if n.name not in reserved:
            reserved[n.name] = Resources.zero()
        while True:
            reserved[n.name] = reserved[n.name].add(executor_resources)
            if reserved[n.name].greater_than(available_resources.get(n.name, Resources.zero())):
                break
            executor_node_names.append(n.name)
            if len(executor_node_names) == executor_count:
                return executor_node_names, reserved
    return executor_node_names, reserved
