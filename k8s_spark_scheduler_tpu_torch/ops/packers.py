"""Gang binpacking oracles — exact reference semantics on host.

The scalar "oracles" for the tightly-pack and distribute-evenly policies
of the reference (``lib/pkg/binpack/``).  The batch solver
(:mod:`.batch_solver` and the queue kernel) is validated against these
decision for decision; the tpu-batch binpackers also run them when a
snapshot is not exactly tensorizable.  Minimal-fragmentation and the
single-AZ combinators are not ported yet.

Behavioral quirks of the reference are reproduced deliberately and marked
with ``# QUIRK`` comments — parity gates on decisions, not on cleaned-up
semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..types.resources import (
    NodeGroupResources,
    NodeGroupSchedulingMetadata,
    Resources,
)
from .efficiency import PackingEfficiency, compute_packing_efficiencies


@dataclass
class PackingResult:
    """Result of one gang binpacking (binpack.go:25-40)."""

    driver_node: str = ""
    executor_nodes: List[str] = field(default_factory=list)
    packing_efficiencies: Dict[str, PackingEfficiency] = field(default_factory=dict)
    has_capacity: bool = False
    # set by the tensor fast lanes: avg of per-node max efficiencies with
    # the same float64 value the metrics path would compute by iterating
    # packing_efficiencies — lets the gauge skip materializing 10k lazy
    # entries per request
    max_avg_efficiency: Optional[float] = None


def empty_packing_result() -> PackingResult:
    return PackingResult()


# GenericBinPackFunction (binpack.go:52-57): distributes `count` identical
# items over nodes; returns (nodes, ok) and mutates reserved_resources.
GenericBinPackFunction = Callable[
    [Resources, int, Sequence[str], NodeGroupSchedulingMetadata, NodeGroupResources],
    Tuple[Optional[List[str]], bool],
]

# SparkBinPackFunction (binpack.go:43-50)
SparkBinPackFunction = Callable[
    [Resources, Resources, int, Sequence[str], Sequence[str], NodeGroupSchedulingMetadata],
    PackingResult,
]


def spark_bin_pack(
    driver_resources: Resources,
    executor_resources: Resources,
    executor_count: int,
    driver_node_priority_order: Sequence[str],
    executor_node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
    distribute_executors: GenericBinPackFunction,
) -> PackingResult:
    """Driver-first gang packing loop (binpack.go:60-87): first driver node
    with capacity whose executor distribution succeeds wins."""
    for driver_node_name in driver_node_priority_order:
        md = metadata.get(driver_node_name)
        if md is None or driver_resources.greater_than(md.available):
            continue
        reserved: NodeGroupResources = {driver_node_name: driver_resources.copy()}
        executor_nodes, ok = distribute_executors(
            executor_resources, executor_count, executor_node_priority_order, metadata, reserved
        )
        if ok:
            return PackingResult(
                driver_node=driver_node_name,
                executor_nodes=list(executor_nodes or []),
                has_capacity=True,
                packing_efficiencies=compute_packing_efficiencies(metadata, reserved),
            )
    return empty_packing_result()


def tightly_pack_executors(
    executor_resources: Resources,
    executor_count: int,
    node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
    reserved_resources: NodeGroupResources,
) -> Tuple[Optional[List[str]], bool]:
    """First-fit: fill each node to capacity before moving on
    (pack_tightly.go:34-63)."""
    executor_nodes: List[str] = []
    if executor_count == 0:
        return executor_nodes, True
    for n in node_priority_order:
        if n not in reserved_resources:
            reserved_resources[n] = Resources.zero()
        while True:
            reserved_resources[n] = reserved_resources[n].add(executor_resources)
            md = metadata.get(n)
            if md is None or reserved_resources[n].greater_than(md.available):
                reserved_resources[n] = reserved_resources[n].sub(executor_resources)
                break
            executor_nodes.append(n)
            if len(executor_nodes) == executor_count:
                return executor_nodes, True
    return None, False


def distribute_executors_evenly(
    executor_resources: Resources,
    executor_count: int,
    node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
    reserved_resources: NodeGroupResources,
) -> Tuple[Optional[List[str]], bool]:
    """Round-robin one executor per node per sweep (distribute_evenly.go:34-73)."""
    available_nodes = {name for name in node_priority_order}
    executor_nodes: List[str] = []
    if executor_count == 0:
        return executor_nodes, True
    while available_nodes:
        for n in node_priority_order:
            if n not in available_nodes:
                continue
            if n not in reserved_resources:
                reserved_resources[n] = Resources.zero()
            reserved_resources[n] = reserved_resources[n].add(executor_resources)
            md = metadata.get(n)
            if md is None or reserved_resources[n].greater_than(md.available):
                available_nodes.discard(n)
                reserved_resources[n] = reserved_resources[n].sub(executor_resources)
            else:
                executor_nodes.append(n)
                if len(executor_nodes) == executor_count:
                    return executor_nodes, True
    return None, False


# ---------------------------------------------------------------------------
# The named SparkBinPackFunctions
# ---------------------------------------------------------------------------


def tightly_pack(
    driver_resources: Resources,
    executor_resources: Resources,
    executor_count: int,
    driver_node_priority_order: Sequence[str],
    executor_node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
) -> PackingResult:
    return spark_bin_pack(
        driver_resources,
        executor_resources,
        executor_count,
        driver_node_priority_order,
        executor_node_priority_order,
        metadata,
        tightly_pack_executors,
    )


def distribute_evenly(
    driver_resources: Resources,
    executor_resources: Resources,
    executor_count: int,
    driver_node_priority_order: Sequence[str],
    executor_node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
) -> PackingResult:
    return spark_bin_pack(
        driver_resources,
        executor_resources,
        executor_count,
        driver_node_priority_order,
        executor_node_priority_order,
        metadata,
        distribute_executors_evenly,
    )
