"""Packing-efficiency math (reference ``lib/pkg/binpack/efficiency.go``).

Efficiency is reporting/selection metadata (used to pick the best AZ in
the single-AZ combinator and for metrics), so float math is acceptable
exactly as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..types.resources import (
    NodeGroupResources,
    NodeGroupSchedulingMetadata,
    NodeSchedulingMetadata,
)


@dataclass
class PackingEfficiency:
    """Per-node reserved/schedulable ratios (efficiency.go:53-63)."""

    node_name: str
    cpu: float
    memory: float
    gpu: float

    def max(self) -> float:
        return max(self.gpu, self.cpu, self.memory)


@dataclass
class AvgPackingEfficiency:
    """Average over nodes (efficiency.go:25-30)."""

    cpu: float
    memory: float
    gpu: float
    max: float

    def less_than(self, other: "AvgPackingEfficiency") -> bool:
        return self.max < other.max


def worst_avg_packing_efficiency() -> AvgPackingEfficiency:
    return AvgPackingEfficiency(0.0, 0.0, 0.0, 0.0)


def _normalize(v: int) -> int:
    return 1 if v == 0 else v


def compute_packing_efficiency(
    node_name: str,
    md: NodeSchedulingMetadata,
    reserved_resources: NodeGroupResources,
) -> PackingEfficiency:
    """(schedulable - available + newly_reserved) / schedulable per dim
    (efficiency.go:80-105)."""
    node_reserved = md.schedulable.sub(md.available)
    extra = reserved_resources.get(node_name)
    if extra is not None:
        node_reserved = node_reserved.add(extra)
    schedulable = md.schedulable

    gpu_eff = 0.0
    if schedulable.nvidia_gpu.value() != 0:
        gpu_eff = float(node_reserved.nvidia_gpu.value()) / float(
            _normalize(schedulable.nvidia_gpu.value())
        )

    return PackingEfficiency(
        node_name=node_name,
        cpu=float(node_reserved.cpu.value()) / float(_normalize(schedulable.cpu.value())),
        memory=float(node_reserved.memory.value()) / float(_normalize(schedulable.memory.value())),
        gpu=gpu_eff,
    )


def compute_packing_efficiencies(
    metadata: NodeGroupSchedulingMetadata,
    reserved_resources: NodeGroupResources,
) -> Dict[str, PackingEfficiency]:
    """Efficiency for every node in the snapshot (efficiency.go:66-77)."""
    return {
        node_name: compute_packing_efficiency(node_name, md, reserved_resources)
        for node_name, md in metadata.items()
    }


def compute_avg_packing_efficiency(
    metadata: NodeGroupSchedulingMetadata,
    packing_efficiencies: List[PackingEfficiency],
) -> AvgPackingEfficiency:
    """Average of per-node efficiencies; GPU averaged only over GPU nodes,
    defaulting to 1.0 when none (efficiency.go:114-156).  Callers may pass
    one entry per pod occurrence: the average weights by occurrences, as
    single_az.go:75-97 uses it."""
    if not packing_efficiencies:
        return worst_avg_packing_efficiency()

    cpu_sum = memory_sum = gpu_sum = max_sum = 0.0
    nodes_with_gpu = 0
    for eff in packing_efficiencies:
        md = metadata[eff.node_name]
        cpu_sum += eff.cpu
        memory_sum += eff.memory
        if md.schedulable.nvidia_gpu.value() != 0:
            gpu_sum += eff.gpu
            nodes_with_gpu += 1
        max_sum += max(eff.gpu, eff.cpu, eff.memory)

    length = max(float(len(packing_efficiencies)), 1.0)
    gpu_eff = 1.0 if nodes_with_gpu == 0 else gpu_sum / float(nodes_with_gpu)
    return AvgPackingEfficiency(
        cpu=cpu_sum / length,
        memory=memory_sum / length,
        gpu=gpu_eff,
        max=max_sum / length,
    )
