"""Gang binpacking oracles — exact reference semantics on host.

The scalar "oracles" for the five packing policies of the reference
(``lib/pkg/binpack/``): tightly-pack, distribute-evenly,
az-aware-tightly-pack, single-az-tightly-pack, single-az-minimal-
fragmentation (+ plain minimal-fragmentation).  The batch solver
(:mod:`.batch_solver` and the queue kernels) is validated against these
decision for decision; the tpu-batch binpackers also run them when a
snapshot is not exactly tensorizable.

Behavioral quirks of the reference are reproduced deliberately and marked
with ``# QUIRK`` comments — parity gates on decisions, not on cleaned-up
semantics.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import compat
from ..types.resources import (
    NodeGroupResources,
    NodeGroupSchedulingMetadata,
    Resources,
)
from . import capacity as cap
from .efficiency import (
    PackingEfficiency,
    compute_avg_packing_efficiency,
    compute_packing_efficiencies,
    worst_avg_packing_efficiency,
)


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


def make_minimal_fragmentation(
    strict_reference_parity: bool = compat.DEFAULT_STRICT,
) -> GenericBinPackFunction:
    """Prefer fewest hosts, avoiding mostly-empty nodes unless needed
    (minimal_fragmentation.go:59-94).

    QUIRK (switchable, install key ``strict-reference-parity``): unlike
    the other distribution functions the reference never writes back into
    reserved_resources, so packing efficiencies reported upstream reflect
    only the driver reservation.  With strict parity off the placements
    are folded in and efficiencies are complete.
    """

    def minimal_fragmentation(
        executor_resources: Resources,
        executor_count: int,
        node_priority_order: Sequence[str],
        metadata: NodeGroupSchedulingMetadata,
        reserved_resources: NodeGroupResources,
    ) -> Tuple[Optional[List[str]], bool]:
        if executor_count == 0:
            return [], True

        capacities = cap.get_node_capacities(
            node_priority_order, metadata, reserved_resources, executor_resources
        )
        capacities = cap.filter_out_nodes_without_capacity(capacities)
        executor_nodes, ok = minimal_fragmentation_from_capacities(executor_count, capacities)
        if ok and executor_nodes and not strict_reference_parity:
            for n in executor_nodes:
                reserved_resources[n] = reserved_resources.get(n, Resources.zero()).add(
                    executor_resources
                )
        return executor_nodes, ok

    return minimal_fragmentation


# strict default instance (the reference's exact behavior)
minimal_fragmentation = make_minimal_fragmentation()


def minimal_fragmentation_from_capacities(
    executor_count: int, capacities: List[cap.NodeAndExecutorCapacity]
) -> Tuple[Optional[List[str]], bool]:
    """The capacity-driven core of minimal_fragmentation.go:71-94, shared
    by the oracle and the device decode (bit-identical is a parity
    requirement)."""
    if not capacities:
        return None, False

    capacities = sorted(capacities, key=lambda c: c.capacity)  # stable, ascending
    max_capacity = capacities[-1].capacity
    if executor_count < max_capacity:
        target_capacity = (executor_count + max_capacity) // 2
        first_at_least_target = bisect.bisect_left(
            [c.capacity for c in capacities], target_capacity
        )
        # try a subset that excludes the 'emptiest' nodes
        executor_nodes, ok = _internal_minimal_fragmentation(
            executor_count, capacities[:first_at_least_target]
        )
        if ok:
            return executor_nodes, True

    return _internal_minimal_fragmentation(executor_count, capacities)


def _internal_minimal_fragmentation(
    executor_count: int,
    node_capacities: List[cap.NodeAndExecutorCapacity],
) -> Tuple[Optional[List[str]], bool]:
    """minimal_fragmentation.go:96-137."""
    remaining = list(node_capacities)
    executor_nodes: List[str] = []

    while remaining:
        keys = [c.capacity for c in remaining]
        # first node that can fit everything that's left
        position = bisect.bisect_left(keys, executor_count)
        if position != len(remaining):
            executor_nodes.extend([remaining[position].node_name] * executor_count)
            return executor_nodes, True

        # drain max-capacity nodes
        max_capacity = remaining[-1].capacity
        first_max_idx = bisect.bisect_left(keys, max_capacity)
        current_pos = first_max_idx
        while executor_count >= max_capacity and current_pos < len(remaining):
            executor_nodes.extend([remaining[current_pos].node_name] * max_capacity)
            executor_count -= max_capacity
            current_pos += 1

        if executor_count == 0:
            return executor_nodes, True

        remaining = remaining[:first_max_idx] + remaining[current_pos:]

    return None, False


# ---------------------------------------------------------------------------
# Single-AZ combinator (single_az.go)
# ---------------------------------------------------------------------------


def group_nodes_by_zone(
    node_names: Sequence[str], metadata: NodeGroupSchedulingMetadata
) -> Tuple[List[str], Dict[str, List[str]]]:
    """(zones in first-appearance order, zone → nodes in order)
    (single_az.go:57-72); nodes missing from metadata are dropped."""
    zones_in_order: List[str] = []
    by_zone: Dict[str, List[str]] = {}
    for node_name in node_names:
        md = metadata.get(node_name)
        if md is None:
            continue
        zone = md.zone_label
        if zone not in by_zone:
            zones_in_order.append(zone)
            by_zone[zone] = []
        by_zone[zone].append(node_name)
    return zones_in_order, by_zone


def _choose_best_result(
    metadata: NodeGroupSchedulingMetadata, results: List[PackingResult]
) -> PackingResult:
    """Highest avg packing efficiency among feasible AZs (single_az.go:75-97).

    QUIRK: per-node efficiencies are collected once per pod occurrence
    (driver + each executor), so multi-executor nodes weigh more; and a
    candidate only replaces the current best on a strict Max improvement,
    so an all-zero-efficiency result set returns the empty (infeasible)
    result.
    """
    best = empty_packing_result()
    best_avg = worst_avg_packing_efficiency()
    for result in results:
        node_names = [result.driver_node] + list(result.executor_nodes)
        effs = [result.packing_efficiencies[n] for n in node_names]
        avg = compute_avg_packing_efficiency(metadata, effs)
        if best_avg.less_than(avg):
            best = result
            best_avg = avg
    return best


def _single_az_spark_bin_function(fn: GenericBinPackFunction) -> SparkBinPackFunction:
    """single_az.go:23-55: run the inner packer per AZ, keep feasible AZs,
    pick the best by avg packing efficiency."""

    def packer(
        driver_resources: Resources,
        executor_resources: Resources,
        executor_count: int,
        driver_node_priority_order: Sequence[str],
        executor_node_priority_order: Sequence[str],
        metadata: NodeGroupSchedulingMetadata,
    ) -> PackingResult:
        driver_zones_in_order, driver_by_zone = group_nodes_by_zone(
            driver_node_priority_order, metadata
        )
        _, executor_by_zone = group_nodes_by_zone(executor_node_priority_order, metadata)

        results: List[PackingResult] = []
        for zone in driver_zones_in_order:
            executor_order = executor_by_zone.get(zone)
            if executor_order is None:
                continue
            result = spark_bin_pack(
                driver_resources,
                executor_resources,
                executor_count,
                driver_by_zone[zone],
                executor_order,
                metadata,
                fn,
            )
            if result.has_capacity:
                results.append(result)

        if not results:
            return empty_packing_result()
        return _choose_best_result(metadata, results)

    return packer


# ---------------------------------------------------------------------------
# The five named SparkBinPackFunctions
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


def make_minimal_fragmentation_pack(
    strict_reference_parity: bool = compat.DEFAULT_STRICT,
) -> SparkBinPackFunction:
    fn = make_minimal_fragmentation(strict_reference_parity)

    def minimal_fragmentation_pack(
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
            fn,
        )

    return minimal_fragmentation_pack


def make_single_az_minimal_fragmentation(
    strict_reference_parity: bool = compat.DEFAULT_STRICT,
) -> SparkBinPackFunction:
    return _single_az_spark_bin_function(make_minimal_fragmentation(strict_reference_parity))


minimal_fragmentation_pack = make_minimal_fragmentation_pack()
single_az_tightly_pack = _single_az_spark_bin_function(tightly_pack_executors)
single_az_minimal_fragmentation = make_single_az_minimal_fragmentation()


def az_aware_tightly_pack(
    driver_resources: Resources,
    executor_resources: Resources,
    executor_count: int,
    driver_node_priority_order: Sequence[str],
    executor_node_priority_order: Sequence[str],
    metadata: NodeGroupSchedulingMetadata,
) -> PackingResult:
    """Single-AZ first, fall back to plain tightly-pack
    (az_aware_pack_tightly.go:27-38)."""
    result = single_az_tightly_pack(
        driver_resources,
        executor_resources,
        executor_count,
        driver_node_priority_order,
        executor_node_priority_order,
        metadata,
    )
    if result.has_capacity:
        return result
    return tightly_pack(
        driver_resources,
        executor_resources,
        executor_count,
        driver_node_priority_order,
        executor_node_priority_order,
        metadata,
    )
