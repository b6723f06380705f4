"""In-memory soft reservations for dynamic-allocation extra executors.

internal/cache/softreservations.go: per-app extra-executor reservations
above the min count, with a Status tombstone map that remembers dead
executors to defeat the death-event/schedule race
(softreservations.go:41-50, 204-210).  Intentionally not persisted —
rebuilt by failover reconciliation (failover.go:174-241).
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..kube.informer import Informer
from ..scheduler.labels import SPARK_APP_ID_LABEL, SPARK_ROLE_LABEL, DRIVER, EXECUTOR, is_spark_scheduler_pod
from ..types.objects import Pod, Reservation
from ..types.resources import NodeGroupResources, Resources


@dataclass
class SoftReservation:
    """softreservations.go:41-50."""

    # executor pod name → Reservation (valid ones only)
    reservations: Dict[str, Reservation] = field(default_factory=dict)
    # executor pod name → valid?  False entries are tombstones of dead
    # executors so a late schedule request can't resurrect a spot
    status: Dict[str, bool] = field(default_factory=dict)


@guarded_by("_lock", "_store", "_observers")
class SoftReservationStore:
    def __init__(self, pod_informer: Optional[Informer] = None):
        self._lock = threading.RLock()
        self._store: Dict[str, SoftReservation] = {}
        # (node, Resources, +1/-1) observers for incremental usage mirrors
        self._observers = []
        if pod_informer is not None:
            pod_informer.add_event_handler(
                on_delete=self._on_pod_deletion,
                filter_func=is_spark_scheduler_pod,
            )

    def get_soft_reservation(self, app_id: str) -> Tuple[SoftReservation, bool]:
        with self._lock:
            sr = self._store.get(app_id)
            if sr is None:
                return SoftReservation(), False
            return copy.deepcopy(sr), True

    def get_all_soft_reservations_copy(self) -> Dict[str, SoftReservation]:
        with self._lock:
            return {app_id: copy.deepcopy(sr) for app_id, sr in self._store.items()}

    def create_soft_reservation_if_not_exists(self, app_id: str) -> None:
        with self._lock:
            racecheck.note_access(self, "_store")
            if app_id not in self._store:
                self._store[app_id] = SoftReservation()

    def add_reservation_for_pod(self, app_id: str, pod_name: str, reservation: Reservation) -> None:
        """No-op if the pod was ever seen (incl. tombstoned)
        (softreservations.go:110-131)."""
        with self._lock:
            racecheck.note_access(self, "_store")
            sr = self._store.get(app_id)
            if sr is None:
                raise KeyError(f"no soft reservation store entry for app {app_id}")
            if pod_name in sr.status:
                return
            sr.reservations[pod_name] = reservation
            sr.status[pod_name] = True
            self._notify(reservation.node, reservation.resources_value(), +1, pod_name)

    def executor_has_soft_reservation(self, executor: Pod) -> bool:
        return self.get_executor_soft_reservation(executor) is not None

    def get_executor_soft_reservation(self, executor: Pod) -> Optional[Reservation]:
        with self._lock:
            app_id = executor.labels.get(SPARK_APP_ID_LABEL)
            if app_id is None:
                return None
            sr = self._store.get(app_id)
            if sr is not None:
                res = sr.reservations.get(executor.name)
                if res is not None:
                    return copy.deepcopy(res)
            return None

    def used_soft_reservation_resources(self) -> NodeGroupResources:
        """softreservations.go:155-170."""
        with self._lock:
            usage: NodeGroupResources = {}
            for sr in self._store.values():
                for reservation in sr.reservations.values():
                    node = reservation.node
                    usage[node] = usage.get(node, Resources.zero()).add(
                        reservation.resources_value()
                    )
            return usage

    def remove_executor_reservation(self, app_id: str, executor_name: str) -> None:
        """Drop the reservation but tombstone the name
        (softreservations.go:204-216)."""
        with self._lock:
            racecheck.note_access(self, "_store")
            sr = self._store.get(app_id)
            if sr is None:
                return
            removed = sr.reservations.pop(executor_name, None)
            sr.status[executor_name] = False
            if removed is not None:
                self._notify(removed.node, removed.resources_value(), -1, executor_name)

    def remove_driver_reservation(self, app_id: str) -> None:
        with self._lock:
            racecheck.note_access(self, "_store")
            sr = self._store.pop(app_id, None)
            if sr is not None:
                for pod_name, reservation in sr.reservations.items():
                    self._notify(reservation.node, reservation.resources_value(), -1, pod_name)

    def _on_pod_deletion(self, pod: Pod) -> None:
        app_id = pod.labels.get(SPARK_APP_ID_LABEL, "")
        role = pod.labels.get(SPARK_ROLE_LABEL)
        if role == DRIVER:
            self.remove_driver_reservation(app_id)
        elif role == EXECUTOR:
            self.remove_executor_reservation(app_id, pod.name)

    def add_change_observer(self, fn) -> None:
        """fn(node, resources, sign, pod_name): called under the store lock
        on every reservation add (+1) / removal (-1)."""
        # under the lock: registration must not race a concurrent
        # _notify iteration over the same list
        with self._lock:
            racecheck.note_access(self, "_observers")
            self._observers.append(fn)

    def _notify(self, node: str, resources: Resources, sign: int, pod_name: str) -> None:
        for fn in self._observers:
            try:
                fn(node, resources, sign, pod_name)
            except Exception:
                import logging

                logging.getLogger(__name__).exception("soft reservation observer failed")

    # -- metrics helpers -----------------------------------------------------

    def get_application_count(self) -> int:
        with self._lock:
            return len(self._store)

    def get_active_extra_executor_count(self) -> int:
        with self._lock:
            return sum(len(sr.reservations) for sr in self._store.values())
