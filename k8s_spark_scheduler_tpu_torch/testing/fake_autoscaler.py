"""Fake cluster autoscaler for end-to-end flows (the reference's demand
consumer is an external scaler watching the Demand CRD, SURVEY §1).

Watches Demands on the embedded API server; for each pending demand it
adds nodes sized to the demand units (in the demanded zone when
enforce_single_zone_scheduling is set) and marks the demand fulfilled —
driving the same phase transitions the waste reporter and demand GC key
on.

Two knobs model real autoscaler behavior instead of instant infinite
capacity:

- ``fulfillment_delay`` (seconds, on the :mod:`..timesource` clock):
  a demand only becomes eligible ``delay`` after it is observed.
  Delayed demands queue in ``pending`` and are provisioned by
  :meth:`process_due` — the discrete-event simulator pumps this at
  virtual due-times; wall-clock tests call it directly.
- ``max_nodes``: a hard cap on nodes this autoscaler will ever create.
  A demand whose first-fit provisioning would exceed the cap is left
  pending (a real bounded ASG does not partially help a gang) and
  counted in ``capped``.

Node names come from a per-instance counter so runs are deterministic
regardless of construction order elsewhere in the process.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from .. import timesource
from ..kube.apiserver import APIServer
from ..kube.errors import NotFoundError
from ..kube.informer import Informer
from ..types.objects import Demand, DemandPhase, Node, ObjectMeta
from ..types.resources import ZONE_LABEL, Resources


@dataclass(eq=False)  # identity equality: two queued demands may carry equal payloads
class _PendingDemand:
    due: float
    namespace: str
    name: str
    zone: str
    instance_group: str
    # (resources, count) per unit, captured at observation time
    units: List = field(default_factory=list)


class FakeAutoscaler:
    def __init__(
        self,
        api: APIServer,
        demand_informer: Informer,
        node_cpu: str = "16",
        node_memory: str = "32Gi",
        node_gpu: str = "0",
        instance_group_label: str = "resource_channel",
        default_zone: str = "zone1",
        fulfillment_delay: float = 0.0,
        max_nodes: Optional[int] = None,
        deferred: bool = False,
        name_prefix: str = "scaled",
    ):
        self._api = api
        self._node_cpu = node_cpu
        self._node_memory = node_memory
        self._node_gpu = node_gpu
        self._instance_group_label = instance_group_label
        self._default_zone = default_zone
        self._delay = fulfillment_delay
        self._max_nodes = max_nodes
        # deferred=True forces even zero-delay demands through the
        # pending queue: fulfillment then happens only at explicit
        # process_due() pumps, in sorted order — the determinism the
        # simulator needs (watch events arrive from racing write-back
        # shards, so inline fulfillment order is scheduling-dependent)
        self._deferred = deferred or fulfillment_delay > 0
        self._name_prefix = name_prefix
        self._counter = itertools.count(1)
        self._lock = threading.Lock()
        self.fulfilled: list[str] = []
        self.pending: list[_PendingDemand] = []
        self.created_nodes = 0
        self.capped: list[str] = []
        demand_informer.add_event_handler(on_add=self._on_demand)

    # -- intake ---------------------------------------------------------------

    def _on_demand(self, demand: Demand) -> None:
        with self._lock:
            if demand.status.phase == DemandPhase.FULFILLED:
                return
            if self._deferred:
                self.pending.append(
                    _PendingDemand(
                        due=timesource.now() + self._delay,
                        namespace=demand.namespace,
                        name=demand.name,
                        zone=demand.spec.zone or self._default_zone,
                        instance_group=demand.spec.instance_group,
                        units=[(u.resources, u.count) for u in demand.spec.units],
                    )
                )
                return
            self._fulfill(
                demand.namespace,
                demand.name,
                demand.spec.zone or self._default_zone,
                demand.spec.instance_group,
                [(u.resources, u.count) for u in demand.spec.units],
            )

    # -- delayed pump ---------------------------------------------------------

    def due_times(self) -> List[float]:
        """Due instants of still-pending demands (for the sim to turn
        into clock events)."""
        with self._lock:
            return sorted({p.due for p in self.pending})

    def process_due(self, now: Optional[float] = None) -> int:
        """Fulfill every pending demand whose delay has elapsed at
        ``now`` (timesource.now() when omitted), in (due, namespace,
        name) order.  Returns the number of demands fulfilled."""
        if now is None:
            now = timesource.now()
        with self._lock:
            due = [p for p in self.pending if p.due <= now]
            if not due:
                return 0
            due.sort(key=lambda p: (p.due, p.namespace, p.name))
            fulfilled = 0
            due_ids = {id(p) for p in due}
            remaining = [p for p in self.pending if id(p) not in due_ids]
            for p in due:
                if self._fulfill(p.namespace, p.name, p.zone, p.instance_group, p.units):
                    fulfilled += 1
                # capped demands stay pending: a later cordon-lift or a
                # raised cap (not modeled) would retry them; dropping
                # them silently would under-report scale-up pressure
                elif self._demand_still_open(p.namespace, p.name):
                    remaining.append(p)
            self.pending = remaining
            return fulfilled

    def _demand_still_open(self, namespace: str, name: str) -> bool:
        try:
            fresh = self._api.get(Demand.KIND, namespace, name)
        except NotFoundError:
            return False
        return fresh.status.phase != DemandPhase.FULFILLED

    # -- provisioning ---------------------------------------------------------

    def _fulfill(self, namespace, name, zone, instance_group, units) -> bool:
        """First-fit the demand units onto fresh nodes and mark the
        demand fulfilled.  Always called with self._lock held."""
        node_capacity = Resources.of(self._node_cpu, self._node_memory, self._node_gpu)
        # first-fit the demand units onto fresh nodes: summed-demand
        # division under-provisions when unit sizes don't divide node
        # capacity (a 10-cpu unit only fits once on a 16-cpu node)
        free: list[Resources] = []
        for resources, count in units:
            for _ in range(count):
                placed = False
                for i, avail in enumerate(free):
                    if not resources.greater_than(avail):
                        free[i] = avail.sub(resources)
                        placed = True
                        break
                if not placed:
                    free.append(node_capacity.sub(resources))
        needed = max(len(free), 1)
        if self._max_nodes is not None and self.created_nodes + needed > self._max_nodes:
            if name not in self.capped:
                self.capped.append(name)
            return False
        for _ in range(needed):
            self._api.create(
                Node(
                    meta=ObjectMeta(
                        name=f"{self._name_prefix}-{next(self._counter)}",
                        labels={
                            ZONE_LABEL: zone,
                            self._instance_group_label: instance_group,
                        },
                    ),
                    allocatable=node_capacity,
                )
            )
        self.created_nodes += needed
        try:
            fresh = self._api.get(Demand.KIND, namespace, name)
        except NotFoundError:
            # demand deleted while queued (pod scheduled anyway): the
            # nodes stay (real autoscalers don't roll back either)
            return True
        fresh.status.phase = DemandPhase.FULFILLED
        fresh.status.fulfilled_zone = zone
        self._api.update(fresh)
        self.fulfilled.append(name)
        return True
