"""GangPacker — the whole-queue gang packer on one device.

Snapshot tensors in, whole-FIFO-queue decisions out: the ``binpack:
tpu-batch`` data plane.  The control plane marshals cluster state into
``ClusterTensor`` / ``AppTensor`` and reads back per-app decisions; the
solve is one launch of the CUDA queue kernel (its plain PyTorch version
on the CPU).  The node-axis sharded variant of the JAX package is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.batch_solver import QueueSolve
from ..ops.queue_kernel import fifo_queue
from ..ops.tensorize import AppTensor, ClusterTensor, ScaledProblem, scale_problem


@dataclass(frozen=True)
class GangPackerConfig:
    assignment_policy: str = "tightly-pack"  # or "distribute-evenly"
    node_bucket: Optional[int] = None
    app_bucket: Optional[int] = None


class GangPacker:
    """Whole-queue gang packer on `device` (None = CUDA)."""

    def __init__(self, config: GangPackerConfig = GangPackerConfig(), device: DeviceLike = None):
        if config.assignment_policy not in ("tightly-pack", "distribute-evenly"):
            raise NotImplementedError(
                f"assignment policy {config.assignment_policy!r} is not ported to PyTorch yet"
            )
        self.config = config
        self.device = resolve_device(device)

    def scale(self, cluster: ClusterTensor, apps: AppTensor) -> ScaledProblem:
        return scale_problem(
            cluster, apps, node_bucket=self.config.node_bucket, app_bucket=self.config.app_bucket
        )

    def device_args(self, problem: ScaledProblem):
        return tuple(
            torch.as_tensor(x, device=self.device)
            for x in (
                problem.avail,
                problem.driver_rank,
                problem.exec_ok,
                problem.driver,
                problem.executor,
                problem.count,
                problem.app_valid,
            )
        )

    def solve(self, problem: ScaledProblem) -> QueueSolve:
        """Per-app (feasible, driver_idx) and the final availability.
        problem.ok must be True.  exec_counts / exec_capacity are empty:
        any single app's placement is recovered with one O(N)
        batch_solver.solve_single on the carried availability, as
        TpuFifoSolver decodes the current driver."""
        if not problem.ok:
            raise ValueError("problem is not exactly tensorizable; use the host oracle")
        feasible, driver_idx, avail_after = fifo_queue(
            *self.device_args(problem),
            evenly=self.config.assignment_policy == "distribute-evenly",
        )
        empty = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return QueueSolve(
            feasible=feasible,
            driver_idx=driver_idx,
            exec_counts=empty,
            exec_capacity=empty,
            avail_after=avail_after,
        )
