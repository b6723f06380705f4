"""Node executor-capacity math (reference ``lib/pkg/capacity/capacity.go``).

Exact floor division over Fractions reproduces the reference's
``inf.Dec`` arithmetic (capacity.go:36-54) bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..types.resources import (
    NodeGroupResources,
    NodeGroupSchedulingMetadata,
    Resources,
)
from ..utils.quantity import Quantity

# stand-in for Go's math.MaxInt (capacity.go:45-48): an unbounded dimension
MAX_CAPACITY = 2**63 - 1


@dataclass
class NodeAndExecutorCapacity:
    node_name: str
    capacity: int


def capacity_against_single_dimension(
    available: Quantity, reserved: Quantity, required: Quantity
) -> int:
    """floor((available - reserved) / required); 0 if reserved > available;
    MAX if required is zero (capacity.go:36-54)."""
    if reserved.cmp(available) == 1:
        return 0
    if required.is_zero():
        return MAX_CAPACITY
    q = (available.exact - reserved.exact) / required.exact
    return int(q.numerator // q.denominator)  # Fraction floor division


def get_node_capacity(available: Resources, reserved: Resources, single_executor: Resources) -> int:
    """min over cpu/memory/gpu dimensions (capacity.go:57-75)."""
    return min(
        capacity_against_single_dimension(available.cpu, reserved.cpu, single_executor.cpu),
        capacity_against_single_dimension(available.memory, reserved.memory, single_executor.memory),
        capacity_against_single_dimension(
            available.nvidia_gpu, reserved.nvidia_gpu, single_executor.nvidia_gpu
        ),
    )


def get_node_capacities(
    node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
    reserved_resources: NodeGroupResources,
    single_executor: Resources,
) -> List[NodeAndExecutorCapacity]:
    """Capacity per node, ordered by node_priority_order (capacity.go:78-102);
    nodes missing from metadata are skipped."""
    capacities: List[NodeAndExecutorCapacity] = []
    for node_name in node_priority_order:
        md = metadata.get(node_name)
        if md is None:
            continue
        reserved = reserved_resources.get(node_name, Resources.zero())
        capacities.append(
            NodeAndExecutorCapacity(node_name, get_node_capacity(md.available, reserved, single_executor))
        )
    return capacities


def filter_out_nodes_without_capacity(
    capacities: List[NodeAndExecutorCapacity],
) -> List[NodeAndExecutorCapacity]:
    return [c for c in capacities if c.capacity > 0]
