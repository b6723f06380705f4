"""Packing-efficiency math (reference ``lib/pkg/binpack/efficiency.go``).

Efficiency is reporting/selection metadata (metrics here; the best-AZ
choice of the single-AZ combinator, which is not ported yet, also reads
it), so float math is acceptable exactly as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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
