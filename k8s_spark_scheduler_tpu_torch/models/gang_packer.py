"""GangPacker — the whole-queue gang packer, on one device or on a mesh.

Snapshot tensors in, whole-FIFO-queue decisions out: the ``binpack:
tpu-batch`` data plane.  The control plane marshals cluster state into
``ClusterTensor`` / ``AppTensor`` and reads back per-app decisions.  On
one device the solve is one launch of the CUDA queue kernel (its plain
PyTorch version on the CPU).  With ``use_mesh`` the node axis is sharded
over a ``torch.distributed`` process group (``parallel/mesh.py``): each
rank holds its block of node rows and the apps whole, and runs
``batch_solver.solve_queue`` with a ``ShardedAxis``, whose node-axis
reductions are collectives — the program the JAX package's mesh branch
runs, partitioned there by GSPMD.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..device import DeviceLike, lane_of, resolve_device
from ..ops import batch_solver
from ..ops.batch_solver import QueueSolve
from ..ops.queue_kernel import fifo_queue
from ..ops.tensorize import AppTensor, ClusterTensor, ScaledProblem, bucket_size, scale_problem
from ..parallel import mesh as meshlib
from ..tracing.profiling import default_profiler


@dataclass(frozen=True)
class GangPackerConfig:
    assignment_policy: str = "tightly-pack"  # or "distribute-evenly"
    node_bucket: Optional[int] = None
    app_bucket: Optional[int] = None
    use_mesh: bool = False


class GangPacker:
    """Whole-queue gang packer on `device` (None = CUDA), or, with
    ``config.use_mesh``, on `mesh` (by default the 1-D mesh over the
    world's process group, each rank on its `device`)."""

    def __init__(self, config: GangPackerConfig = GangPackerConfig(), device: DeviceLike = None,
                 mesh: Optional[meshlib.NodeMesh] = None):
        if config.assignment_policy not in ("tightly-pack", "distribute-evenly"):
            raise NotImplementedError(
                f"assignment policy {config.assignment_policy!r} is not ported to PyTorch yet"
            )
        self.config = config
        self._mesh = None
        if config.use_mesh:
            self._mesh = mesh if mesh is not None else meshlib.make_mesh(device=device)
            self.device = self._mesh.device
        else:
            self.device = resolve_device(device)

    @property
    def mesh(self) -> Optional[meshlib.NodeMesh]:
        return self._mesh

    @property
    def _evenly(self) -> bool:
        return self.config.assignment_policy == "distribute-evenly"

    def scale(self, cluster: ClusterTensor, apps: AppTensor) -> ScaledProblem:
        node_bucket = self.config.node_bucket
        if self._mesh is not None:
            base = node_bucket or bucket_size(cluster.avail.shape[0])
            node_bucket = meshlib.pad_to_multiple(base, self._mesh.size)
        return scale_problem(cluster, apps, node_bucket=node_bucket, app_bucket=self.config.app_bucket)

    def device_args(self, problem: ScaledProblem):
        """The solve's inputs on the device; under a mesh this rank's rows
        of avail, driver_rank and exec_ok, and the apps whole."""
        node = (problem.avail, problem.driver_rank, problem.exec_ok)
        apps = (problem.driver, problem.executor, problem.count, problem.app_valid)
        if self._mesh is not None:
            return tuple(self._mesh.shard(x) for x in node) + tuple(self._mesh.replicate(x) for x in apps)
        return tuple(torch.as_tensor(x, device=self.device) for x in node + apps)

    def solve(self, problem: ScaledProblem) -> QueueSolve:
        """Per-app (feasible, driver_idx) and the final availability.
        problem.ok must be True.  Under a mesh also exec_counts /
        exec_capacity [A, N] (the program's placements), every output
        gathered to its global shape on every rank.  On one device
        exec_counts / exec_capacity are empty: any single app's placement
        is recovered with one O(N) batch_solver.solve_single on the
        carried availability, as TpuFifoSolver decodes the current driver."""
        if not problem.ok:
            raise ValueError("problem is not exactly tensorizable; use the host oracle")
        lane = "mesh" if self._mesh is not None else lane_of(self.device)
        with default_profiler.profile(
            "gang_packer.solve_queue", lane=lane, shape_key=(problem.avail.shape, problem.driver.shape)
        ) as rec:
            out = self.solve_fn()(*self.device_args(problem))
            rec.sync(out.avail_after)
        return out

    def solve_fn(self):
        """The callable `solve` runs on `device_args`' tensors."""
        if self._mesh is None:
            return self._solve_one
        return self._solve_mesh

    def _solve_one(self, *args) -> QueueSolve:
        feasible, driver_idx, avail_after = fifo_queue(*args, evenly=self._evenly)
        empty = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return QueueSolve(
            feasible=feasible,
            driver_idx=driver_idx,
            exec_counts=empty,
            exec_capacity=empty,
            avail_after=avail_after,
        )

    def _solve_mesh(self, *args) -> QueueSolve:
        mesh = self._mesh
        out = batch_solver.solve_queue(
            *args, evenly=self._evenly, with_placements=True, axis=mesh.axis(args[0].shape[0] * mesh.size)
        )
        return QueueSolve(
            feasible=out.feasible,
            driver_idx=out.driver_idx,
            exec_counts=mesh.gather_nodes(out.exec_counts, 1),
            exec_capacity=mesh.gather_nodes(out.exec_capacity, 1),
            avail_after=mesh.gather_nodes(out.avail_after, 0),
        )
