"""Overhead computer (reference ``internal/extender/overhead.go``):
event-driven tracking of requests of pods without reservations.

Overhead = requests of pods that have a node but no reservation of ours;
non-schedulable overhead = the subset not managed by this scheduler at
all (daemonsets etc.).  Pod requests = max(sum of containers, each init
container) per dimension (overhead.go:195-209)."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

from ..kube.informer import Informer
from ..types.objects import Node, Pod
from ..types.resources import NodeGroupResources, Resources
from . import labels as L
from ..analysis.guarded import guarded_by


def pod_to_resources(pod: Pod) -> Resources:
    """max(sum containers, init containers) (overhead.go:195-209)."""
    total = Resources.zero()
    for c in pod.containers:
        total = total.add(c.requests)
    for c in pod.init_containers:
        total = total.set_max(c.requests)
    return total


@dataclass
class _PodRequestInfo:
    pod_name: str
    pod_namespace: str
    requests: Resources


@guarded_by("_lock", "_requests")
class OverheadComputer:
    """overhead.go:33-209."""

    def __init__(self, pod_informer: Informer, resource_reservation_manager):
        self._pod_informer = pod_informer
        self._rrm = resource_reservation_manager
        self._lock = threading.RLock()
        # node → {pod uid → request info}
        self._requests: Dict[str, Dict[str, _PodRequestInfo]] = {}
        pod_informer.add_event_handler(
            on_add=self._add_pod_requests,
            on_update=self._on_update,
            on_delete=self._delete_pod_requests,
        )

    # informer wiring: the reference filters to pods with a nodeName
    # (overhead.go:72-79, 155-161); updates matter here because our
    # informer delivers bind transitions as MODIFIED

    def _on_update(self, old: Pod, new: Pod) -> None:
        if new.node_name != "":
            self._add_pod_requests(new)

    def _add_pod_requests(self, pod: Pod) -> None:
        if pod.node_name == "":
            return
        with self._lock:
            self._requests.setdefault(pod.node_name, {})[pod.meta.uid] = _PodRequestInfo(
                pod.name, pod.namespace, pod_to_resources(pod)
            )

    def _delete_pod_requests(self, pod: Pod) -> None:
        if pod.node_name == "":
            return
        with self._lock:
            node_requests = self._requests.get(pod.node_name)
            if node_requests is None or pod.meta.uid not in node_requests:
                return
            del node_requests[pod.meta.uid]
            if not node_requests:
                del self._requests[pod.node_name]

    # -- queries -------------------------------------------------------------

    def get_overhead(self, nodes: Iterable[Node]) -> NodeGroupResources:
        return {n.name: self._compute_node_overhead(n.name)[0] for n in nodes}

    def _compute_node_overhead(self, node_name: str) -> Tuple[Resources, Resources]:
        """overhead.go:120-153."""
        with self._lock:
            node_requests = dict(self._requests.get(node_name, {}))
        overhead = Resources.zero()
        non_schedulable = Resources.zero()
        for info in node_requests.values():
            pod = self._pod_informer.get(info.pod_namespace, info.pod_name)
            if pod is None:
                continue
            if not self._rrm.pod_has_reservation(pod):
                overhead = overhead.add(info.requests)
                if pod.scheduler_name != L.SPARK_SCHEDULER_NAME:
                    non_schedulable = non_schedulable.add(info.requests)
        return overhead, non_schedulable

    def get_non_schedulable_overhead(self, nodes: Iterable[Node]) -> NodeGroupResources:
        """Overhead from pods not managed by this scheduler (used by the
        unschedulable-pod marker, unschedulablepods.go:149-151)."""
        return {n.name: self._compute_node_overhead(n.name)[1] for n in nodes}
