"""AZ-aware node priority ordering (reference ``internal/sort/nodesorting.go``).

Priority: AZs ascending by total available resources (memory before CPU),
nodes within an AZ ascending by (memory, cpu), then name.  Driver
candidates are the intersection with kube-scheduler's candidate list;
executor candidates are all schedulable+ready nodes.  Optional per-role
label-priority stable re-sort (nodesorting.go:161-180).

The reference's Go map iteration makes AZ/node ties nondeterministic; we
break ties deterministically (zone name, node name) which stays inside the
reference's behavior envelope.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..types.resources import (
    NodeGroupSchedulingMetadata,
    Resources,
)


@dataclass
class LabelPriorityOrder:
    """config.LabelPriorityOrder (config/config.go:81-84)."""

    name: str
    descending_priority_values: List[str]


def get_node_names_in_priority_order(metadata: NodeGroupSchedulingMetadata) -> List[str]:
    """nodesorting.go:95-122."""
    by_az: Dict[str, List[str]] = {}
    for node_name, md in metadata.items():
        by_az.setdefault(md.zone_label, []).append(node_name)

    az_totals: Dict[str, Resources] = {}
    for az, nodes in by_az.items():
        total = Resources.zero()
        for n in nodes:
            total = total.add(metadata[n].available)
        az_totals[az] = total

    az_order = sorted(
        by_az.keys(),
        key=lambda az: (az_totals[az].memory.exact, az_totals[az].cpu.exact, az),
    )
    az_priority = {az: i for i, az in enumerate(az_order)}

    return sorted(
        metadata.keys(),
        key=lambda n: (
            az_priority[metadata[n].zone_label],
            metadata[n].available.memory.exact,
            metadata[n].available.cpu.exact,
            n,
        ),
    )


def _label_less_than(
    order: LabelPriorityOrder,
) -> "callable":
    value_ranks = {v: i for i, v in enumerate(order.descending_priority_values)}

    def less_than(md1, md2) -> bool:
        rank1 = value_ranks.get(md1.all_labels.get(order.name)) if md1 is not None else None
        rank2 = value_ranks.get(md2.all_labels.get(order.name)) if md2 is not None else None
        if rank1 is None:
            return False
        if rank2 is None:
            return True
        return rank1 < rank2

    return less_than


def _stable_sort_by_less_than(names: List[str], metadata, less_than) -> List[str]:
    return sorted(
        names,
        key=functools.cmp_to_key(
            lambda a, b: -1
            if less_than(metadata.get(a), metadata.get(b))
            else (1 if less_than(metadata.get(b), metadata.get(a)) else 0)
        ),
    )


class NodeSorter:
    """nodesorting.go:25-64."""

    def __init__(
        self,
        driver_prioritized_node_label: Optional[LabelPriorityOrder] = None,
        executor_prioritized_node_label: Optional[LabelPriorityOrder] = None,
    ):
        # public capability surface: consumers (the tensor fast path)
        # read these instead of the comparator internals
        self.driver_label_priority = driver_prioritized_node_label
        self.executor_label_priority = executor_prioritized_node_label
        self._driver_less_than = (
            _label_less_than(driver_prioritized_node_label)
            if driver_prioritized_node_label
            else None
        )
        self._executor_less_than = (
            _label_less_than(executor_prioritized_node_label)
            if executor_prioritized_node_label
            else None
        )

    def potential_nodes(
        self, metadata: NodeGroupSchedulingMetadata, node_names: Sequence[str]
    ) -> Tuple[List[str], List[str]]:
        """(driver candidates ∩ kube list, executor candidates) both in
        priority order (nodesorting.go:41-64)."""
        priority_order = get_node_names_in_priority_order(metadata)
        candidate_set = set(node_names)
        driver_nodes = [n for n in priority_order if n in candidate_set]
        executor_nodes = [
            n for n in priority_order if not metadata[n].unschedulable and metadata[n].ready
        ]
        if self._driver_less_than is not None:
            driver_nodes = _stable_sort_by_less_than(driver_nodes, metadata, self._driver_less_than)
        if self._executor_less_than is not None:
            executor_nodes = _stable_sort_by_less_than(
                executor_nodes, metadata, self._executor_less_than
            )
        return driver_nodes, executor_nodes
