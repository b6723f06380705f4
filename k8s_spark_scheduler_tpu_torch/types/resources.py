"""Resource algebra: the L4 layer of the reference.

Covers the reference's ``pkg/resources/resources.go`` —
``Resources`` (3-dim quantity vector), ``NodeGroupResources``,
``NodeSchedulingMetadata`` and the builders that derive availability from
node allocatable minus usage minus overhead.

Unlike the Go original (mutating methods on shared pointers), ``Resources``
here is an immutable value type: the scheduler core threads updated copies
explicitly, which keeps the snapshot → tensor marshalling for the batch
solver trivially consistent (no aliasing).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional

from ..utils.quantity import Quantity, QuantityLike, parse_quantity

RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_NVIDIA_GPU = "nvidia.com/gpu"

# zone label fallback when a node carries no zone label
# (reference resources.go:27, :78-81)
ZONE_LABEL_PLACEHOLDER = "default"
# failure-domain zone label key (reference uses corev1.LabelZoneFailureDomain
# for metadata and v1.LabelTopologyZone when filtering; both map here)
ZONE_LABEL = "topology.kubernetes.io/zone"


@dataclass(frozen=True)
class Resources:
    """CPU / Memory / NvidiaGPU quantity vector (resources.go:151-155)."""

    cpu: Quantity = field(default_factory=Quantity)
    memory: Quantity = field(default_factory=Quantity)
    nvidia_gpu: Quantity = field(default_factory=Quantity)

    @staticmethod
    def of(cpu: QuantityLike = 0, memory: QuantityLike = 0, nvidia_gpu: QuantityLike = 0) -> "Resources":
        return Resources(parse_quantity(cpu), parse_quantity(memory), parse_quantity(nvidia_gpu))

    @staticmethod
    def zero() -> "Resources":
        return Resources()

    def add(self, other: "Resources") -> "Resources":
        return Resources(
            self.cpu.add(other.cpu),
            self.memory.add(other.memory),
            self.nvidia_gpu.add(other.nvidia_gpu),
        )

    def sub(self, other: "Resources") -> "Resources":
        return Resources(
            self.cpu.sub(other.cpu),
            self.memory.sub(other.memory),
            self.nvidia_gpu.sub(other.nvidia_gpu),
        )

    def set_max(self, other: "Resources") -> "Resources":
        """Per-dimension max (resources.go:224-235)."""
        return Resources(
            other.cpu if other.cpu.cmp(self.cpu) > 0 else self.cpu,
            other.memory if other.memory.cmp(self.memory) > 0 else self.memory,
            other.nvidia_gpu if other.nvidia_gpu.cmp(self.nvidia_gpu) > 0 else self.nvidia_gpu,
        )

    def greater_than(self, other: "Resources") -> bool:
        """True if ANY dimension is greater (resources.go:239-241).

        ``demand.greater_than(available)`` is the reference's
        does-not-fit test.
        """
        return (
            self.cpu.cmp(other.cpu) > 0
            or self.memory.cmp(other.memory) > 0
            or self.nvidia_gpu.cmp(other.nvidia_gpu) > 0
        )

    def eq(self, other: "Resources") -> bool:
        return (
            self.cpu.cmp(other.cpu) == 0
            and self.memory.cmp(other.memory) == 0
            and self.nvidia_gpu.cmp(other.nvidia_gpu) == 0
        )

    def copy(self) -> "Resources":
        return self  # immutable

    def to_dict(self) -> Dict[str, str]:
        return {
            RESOURCE_CPU: self.cpu.serialize(),
            RESOURCE_MEMORY: self.memory.serialize(),
            RESOURCE_NVIDIA_GPU: self.nvidia_gpu.serialize(),
        }

    @staticmethod
    def from_dict(d: Mapping[str, QuantityLike]) -> "Resources":
        return Resources.of(
            d.get(RESOURCE_CPU, 0), d.get(RESOURCE_MEMORY, 0), d.get(RESOURCE_NVIDIA_GPU, 0)
        )

    def __repr__(self) -> str:
        return (
            f"Resources(cpu={self.cpu.serialize()}, memory={self.memory.serialize()}, "
            f"gpu={self.nvidia_gpu.serialize()})"
        )


# NodeGroupResources — map[node]Resources (resources.go:103).  Plain dict,
# with the reference's in-place Add/Sub helpers as functions.
NodeGroupResources = Dict[str, Resources]


def group_add(into: NodeGroupResources, other: NodeGroupResources) -> None:
    for node, r in other.items():
        into[node] = into.get(node, Resources.zero()).add(r)


def group_sub(into: NodeGroupResources, other: NodeGroupResources) -> None:
    for node, r in other.items():
        into[node] = into.get(node, Resources.zero()).sub(r)


@dataclass
class NodeSchedulingMetadata:
    """Per-node scheduling view (resources.go:158-166)."""

    available: Resources
    schedulable: Resources
    creation_timestamp: float = 0.0
    zone_label: str = ZONE_LABEL_PLACEHOLDER
    all_labels: Mapping[str, str] = field(default_factory=dict)
    unschedulable: bool = False
    ready: bool = True


NodeGroupSchedulingMetadata = Dict[str, NodeSchedulingMetadata]


def subtract_usage_if_exists(
    metadata: NodeGroupSchedulingMetadata, used: NodeGroupResources
) -> None:
    """Subtract usage per node, only for known nodes (resources.go:129-135).

    Mutates ``metadata`` entries' ``available`` in place (rebinds the
    immutable Resources value).
    """
    for node_name, used_resources in used.items():
        md = metadata.get(node_name)
        if md is not None:
            md.available = md.available.sub(used_resources)


def usage_for_nodes(resource_reservations: Iterable) -> NodeGroupResources:
    """Tally reserved resources per node from reservations
    (resources.go:31-43).  Accepts any iterable of objects exposing
    ``spec.reservations`` mapping name → object with .node / .resources.
    """
    usage: NodeGroupResources = {}
    for rr in resource_reservations:
        for reservation in rr.spec.reservations.values():
            node = reservation.node
            usage[node] = usage.get(node, Resources.zero()).add(reservation.resources_value())
    return usage


def available_for_nodes(nodes: Iterable, current_usage: NodeGroupResources) -> NodeGroupResources:
    """allocatable − usage per node (resources.go:46-56)."""
    out: NodeGroupResources = {}
    for node in nodes:
        used = current_usage.get(node.name, Resources.zero())
        out[node.name] = node.allocatable.sub(used)
    return out


def node_scheduling_metadata_for_nodes(
    nodes: Iterable,
    current_usage: NodeGroupResources,
    overhead_usage: NodeGroupResources,
) -> NodeGroupSchedulingMetadata:
    """available = allocatable − usage − overhead; schedulable =
    allocatable − overhead (resources.go:61-100)."""
    out: NodeGroupSchedulingMetadata = {}
    for node in nodes:
        overhead = overhead_usage.get(node.name, Resources.zero())
        used = current_usage.get(node.name, Resources.zero()).add(overhead)
        zone = node.labels.get(ZONE_LABEL, ZONE_LABEL_PLACEHOLDER)
        out[node.name] = NodeSchedulingMetadata(
            available=node.allocatable.sub(used),
            schedulable=node.allocatable.sub(overhead),
            creation_timestamp=node.creation_timestamp,
            zone_label=zone,
            all_labels=dict(node.labels),
            unschedulable=node.unschedulable,
            ready=node.ready,
        )
    return out


def create_scheduling_metadata(
    cpu: QuantityLike,
    memory: QuantityLike,
    nvidia_gpu: QuantityLike = 0,
    zone_label: str = ZONE_LABEL_PLACEHOLDER,
    schedulable: Optional[Resources] = None,
) -> NodeSchedulingMetadata:
    """Test helper mirroring CreateSchedulingMetadata (resources.go:260-266):
    schedulable defaults to effectively-infinite totals."""
    inf = Resources.of(2**62, 2**62, 2**62)
    return NodeSchedulingMetadata(
        available=Resources.of(cpu, memory, nvidia_gpu),
        schedulable=schedulable if schedulable is not None else inf,
        zone_label=zone_label,
    )


def copy_metadata(metadata: NodeGroupSchedulingMetadata) -> NodeGroupSchedulingMetadata:
    """Deep-enough copy for what the packers mutate (available)."""
    return {name: dataclasses.replace(md) for name, md in metadata.items()}
