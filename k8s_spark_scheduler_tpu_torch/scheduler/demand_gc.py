"""DemandGC (reference ``internal/extender/demand_gc.go``): deletes a
pod's Demand when the pod gets scheduled, covering race windows the
inline deletions miss."""

from __future__ import annotations

from ..demands.manager import DemandManager
from ..kube.informer import Informer
from . import labels as L


def start_demand_gc(pod_informer: Informer, manager: DemandManager) -> None:
    """demand_gc.go:35-55."""

    def on_update(old, new):
        if L.on_pod_scheduled(old, new):
            manager.delete_demand_if_exists(new, "DemandGC")

    pod_informer.add_event_handler(
        on_update=on_update,
        filter_func=L.is_spark_scheduler_pod,
    )
