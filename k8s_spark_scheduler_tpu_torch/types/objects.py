"""API object model: pods, nodes, reservations, demands.

Covers the reference's CRD types
(``lib/pkg/apis/sparkscheduler/v1beta2/types_resource_reservation.go:51-57``,
``lib/pkg/apis/scaler/v1alpha2/types_demand.go:72-157``) and the small
subset of core/v1 Pod + Node the scheduler reads.  The objects are plain
dataclasses with dict (de)serialization so they can live in the embedded
state store, be diffed by resourceVersion, and round-trip through JSON.
"""

from __future__ import annotations

import copy as _copy
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import timesource
from ..utils.quantity import Quantity
from .resources import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_NVIDIA_GPU,
    Resources,
)

_monotonic_counter = itertools.count(1)


def now() -> float:
    return timesource.now()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    uid: str = ""
    owner_references: List["OwnerReference"] = field(default_factory=list)

    def ensure_identity(self) -> None:
        if not self.uid:
            self.uid = f"uid-{next(_monotonic_counter)}"
        if not self.creation_timestamp:
            self.creation_timestamp = now()

    def copy(self) -> "ObjectMeta":
        return ObjectMeta(
            name=self.name,
            namespace=self.namespace,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            creation_timestamp=self.creation_timestamp,
            deletion_timestamp=self.deletion_timestamp,
            resource_version=self.resource_version,
            uid=self.uid,
            owner_references=[
                OwnerReference(r.kind, r.name, r.uid, r.controller)
                for r in self.owner_references
            ],
        )


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    controller: bool = True


class APIObject:
    """Base for objects stored in the state store."""

    meta: ObjectMeta
    KIND: str = "Object"

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def namespace(self) -> str:
        return self.meta.namespace

    @property
    def labels(self) -> Dict[str, str]:
        return self.meta.labels

    @property
    def annotations(self) -> Dict[str, str]:
        return self.meta.annotations

    @property
    def creation_timestamp(self) -> float:
        return self.meta.creation_timestamp

    def deepcopy(self):
        """Deep copy of the object tree.  Subclasses override with
        hand-rolled constructions: ``copy.deepcopy``'s generic reflection
        cost ~3.5ms per ResourceReservation on the async write-back
        threads, which on a single-core host steals GIL time from
        in-flight Filter requests.  ``Quantity``/``Resources`` values are
        immutable (utils/quantity.py) and shared, not cloned."""
        return _copy.deepcopy(self)


# ---------------------------------------------------------------------------
# core/v1 subset
# ---------------------------------------------------------------------------


@dataclass
class Container:
    name: str = "main"
    requests: Resources = field(default_factory=Resources.zero)


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class Pod(APIObject):
    KIND = "Pod"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    scheduler_name: str = ""
    node_name: str = ""  # spec.nodeName: set on bind
    node_selector: Dict[str, str] = field(default_factory=dict)
    # required node affinity match expressions: label → allowed values
    # (In semantics; the reference extracts instance group from
    # nodeAffinity/nodeSelector, internal/podspec.go:29-53)
    node_affinity: Dict[str, List[str]] = field(default_factory=dict)
    # full nodeSelectorTerms with k8s GetRequiredNodeAffinity semantics:
    # a list of TERMS (OR — a node must satisfy at least one), each a
    # list of (key, operator, values) expressions (AND within the term);
    # operators: In/NotIn/Exists/DoesNotExist/Gt/Lt.  When present this
    # supersedes the simple node_affinity dict (which serde fills only
    # for the single-term all-In case)
    affinity_terms: List[list] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    phase: str = PodPhase.PENDING
    # per-container terminated flags used by IsPodTerminated
    # (internal/common/utils/pods.go:69-75: terminated iff there is at
    # least one container status and all are terminated)
    container_terminated: List[bool] = field(default_factory=list)
    conditions: Dict[str, "PodCondition"] = field(default_factory=dict)

    def is_terminated(self) -> bool:
        return len(self.container_terminated) > 0 and all(self.container_terminated)

    def deepcopy(self) -> "Pod":
        return Pod(
            meta=self.meta.copy(),
            scheduler_name=self.scheduler_name,
            node_name=self.node_name,
            node_selector=dict(self.node_selector),
            node_affinity={k: list(v) for k, v in self.node_affinity.items()},
            # terms are lists of (key, op, values) expressions; the
            # values lists are never mutated after parse, so sharing the
            # expression tuples is safe — only the list nesting is cloned
            affinity_terms=[list(term) for term in self.affinity_terms],
            containers=[Container(c.name, c.requests) for c in self.containers],
            init_containers=[
                Container(c.name, c.requests) for c in self.init_containers
            ],
            phase=self.phase,
            container_terminated=list(self.container_terminated),
            conditions={
                k: PodCondition(
                    c.type, c.status, c.reason, c.message, c.transition_time
                )
                for k, c in self.conditions.items()
            },
        )

    def matches_node(self, node: "Node") -> bool:
        """Required node affinity + nodeSelector match."""
        return self.matches_labels(node.labels)

    def matches_labels(self, labels: Dict[str, str]) -> bool:
        """The k8s required-scheduling match against a label set
        (component-helpers nodeaffinity semantics, as the reference
        evaluates via GetRequiredNodeAffinity): nodeSelector entries AND;
        nodeSelectorTerms OR, expressions within a term AND."""
        for k, v in self.node_selector.items():
            if labels.get(k) != v:
                return False
        terms = self.affinity_terms
        if not terms and self.node_affinity:
            terms = [[(k, "In", values) for k, values in self.node_affinity.items()]]
        if not terms:
            return True
        return any(self._term_matches(term, labels) for term in terms)

    @staticmethod
    def _term_matches(term, labels: Dict[str, str]) -> bool:
        for key, operator, values in term:
            value = labels.get(key)
            if operator == "In":
                if value not in values:
                    return False
            elif operator == "NotIn":
                if value is not None and value in values:
                    return False
            elif operator == "Exists":
                if value is None:
                    return False
            elif operator == "DoesNotExist":
                if value is not None:
                    return False
            elif operator in ("Gt", "Lt"):
                try:
                    node_val = int(value)
                    want = int(values[0])
                except (TypeError, ValueError, IndexError):
                    return False
                if operator == "Gt" and not node_val > want:
                    return False
                if operator == "Lt" and not node_val < want:
                    return False
            else:
                return False  # unknown operator: fail closed
        return True


@dataclass
class PodCondition:
    type: str
    status: str  # "True" / "False"
    reason: str = ""
    message: str = ""
    transition_time: float = 0.0


@dataclass
class Node(APIObject):
    KIND = "Node"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    allocatable: Resources = field(default_factory=Resources.zero)
    unschedulable: bool = False
    ready: bool = True

    @property
    def zone(self) -> str:
        from .resources import ZONE_LABEL, ZONE_LABEL_PLACEHOLDER

        return self.labels.get(ZONE_LABEL, ZONE_LABEL_PLACEHOLDER)

    def deepcopy(self) -> "Node":
        return Node(
            meta=self.meta.copy(),
            allocatable=self.allocatable,  # immutable value
            unschedulable=self.unschedulable,
            ready=self.ready,
        )


# ---------------------------------------------------------------------------
# ResourceReservation (v1beta2 storage schema,
# types_resource_reservation.go:23-103)
# ---------------------------------------------------------------------------


@dataclass
class Reservation:
    node: str
    resources: Dict[str, Quantity] = field(default_factory=dict)

    @staticmethod
    def for_resources(node: str, r: Resources) -> "Reservation":
        return Reservation(
            node=node,
            resources={
                RESOURCE_CPU: r.cpu,
                RESOURCE_MEMORY: r.memory,
                RESOURCE_NVIDIA_GPU: r.nvidia_gpu,
            },
        )

    def resources_value(self) -> Resources:
        return Resources(
            self.resources.get(RESOURCE_CPU, Quantity(0)),
            self.resources.get(RESOURCE_MEMORY, Quantity(0)),
            self.resources.get(RESOURCE_NVIDIA_GPU, Quantity(0)),
        )


@dataclass
class ResourceReservationSpec:
    reservations: Dict[str, Reservation] = field(default_factory=dict)


@dataclass
class ResourceReservationStatus:
    # reservation name → bound pod name (types_resource_reservation.go:99-103)
    pods: Dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceReservation(APIObject):
    KIND = "ResourceReservation"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceReservationSpec = field(default_factory=ResourceReservationSpec)
    status: ResourceReservationStatus = field(default_factory=ResourceReservationStatus)

    def deepcopy(self) -> "ResourceReservation":
        return ResourceReservation(
            meta=self.meta.copy(),
            spec=ResourceReservationSpec(
                reservations={
                    name: Reservation(r.node, dict(r.resources))
                    for name, r in self.spec.reservations.items()
                }
            ),
            status=ResourceReservationStatus(pods=dict(self.status.pods)),
        )


# ---------------------------------------------------------------------------
# Demand (v1alpha2 storage schema, types_demand.go:29-157)
# ---------------------------------------------------------------------------


class DemandPhase:
    EMPTY = ""
    PENDING = "pending"
    FULFILLED = "fulfilled"
    CANNOT_FULFILL = "cannot-fulfill"


@dataclass
class DemandUnit:
    resources: Resources
    count: int
    # pod names this unit is for, keyed by namespace
    pod_names_by_namespace: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class DemandSpec:
    units: List[DemandUnit] = field(default_factory=list)
    instance_group: str = ""
    is_long_lived: bool = False
    enforce_single_zone_scheduling: bool = False
    zone: Optional[str] = None


@dataclass
class DemandStatus:
    phase: str = DemandPhase.EMPTY
    last_transition_time: float = 0.0
    fulfilled_zone: Optional[str] = None


@dataclass
class Demand(APIObject):
    KIND = "Demand"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DemandSpec = field(default_factory=DemandSpec)
    status: DemandStatus = field(default_factory=DemandStatus)

    def deepcopy(self) -> "Demand":
        return Demand(
            meta=self.meta.copy(),
            spec=DemandSpec(
                units=[
                    DemandUnit(
                        resources=u.resources,  # immutable value
                        count=u.count,
                        pod_names_by_namespace={
                            ns: list(names)
                            for ns, names in u.pod_names_by_namespace.items()
                        },
                    )
                    for u in self.spec.units
                ],
                instance_group=self.spec.instance_group,
                is_long_lived=self.spec.is_long_lived,
                enforce_single_zone_scheduling=self.spec.enforce_single_zone_scheduling,
                zone=self.spec.zone,
            ),
            status=DemandStatus(
                phase=self.status.phase,
                last_transition_time=self.status.last_transition_time,
                fulfilled_zone=self.status.fulfilled_zone,
            ),
        )
