"""Bridge between the scheduler's SparkBinPackFunction interface and the
PyTorch batch solver: marshals snapshots to tensors, runs the solve on
the configured device, and decodes results into the reference's exact
placement lists.

Any problem that can't be represented exactly in scaled int32
(tensorize.scale_problem.ok == False) is packed by the host oracle, as
in the reference package: that is the decision semantics of
``binpack: tpu-batch``, not a device fallback.
"""

from __future__ import annotations

import logging
from fractions import Fraction
from typing import List, Sequence

import numpy as np
import torch

from .. import compat
from ..device import DeviceLike, resolve_device
from ..types.resources import NodeGroupSchedulingMetadata, Resources
from ..utils.quantity import Quantity
from . import packers
from .batch_solver import solve_single
from .efficiency import compute_packing_efficiencies
from .packers import PackingResult, empty_packing_result
from .registry import TPU_BATCH, TPU_BATCH_EVENLY, Binpacker
from .sparkapp import AppDemand
from .tensorize import ClusterTensor, ScaledProblem, scale_problem, tensorize_apps, tensorize_cluster

logger = logging.getLogger(__name__)

POLICIES = ("tightly-pack", "distribute-evenly")


def evenly_counts(cap: np.ndarray, k: int) -> np.ndarray:
    """Exact distribute-evenly per-node counts from per-node capacities
    (distribute_evenly.go:34-73): t complete round-robin sweeps plus a
    partial sweep over the first r capacity-remaining nodes in priority
    order."""
    cap = cap.astype(np.int64)
    if k <= 0:
        return np.zeros_like(cap)
    total = int(cap.sum())
    assert total >= k, "evenly_counts called on infeasible problem"

    # S(t) = Σ min(cap, t) is monotone; find t_full = max{t : S(t) ≤ k}
    lo, hi = 0, int(cap.max())
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int(np.minimum(cap, mid).sum()) <= k:
            lo = mid
        else:
            hi = mid - 1
    t_full = lo
    counts = np.minimum(cap, t_full)
    r = k - int(counts.sum())
    if r > 0:
        open_nodes = np.flatnonzero(cap > t_full)[:r]
        counts[open_nodes] += 1
    return counts


def build_reserved(
    names: List[str],
    counts: np.ndarray,
    driver_node: str,
    driver_resources: Resources,
    executor_resources: Resources,
) -> dict:
    """Per-node reserved map for efficiency computation, identical to the
    oracle's mutation of `reserved` (driver + count x executor per node),
    in O(#hosting-nodes) exact arithmetic."""
    reserved = {driver_node: driver_resources}
    for name, c in zip(names, counts):
        if c > 0:
            total = Resources(
                Quantity(executor_resources.cpu.exact * int(c)),
                Quantity(executor_resources.memory.exact * int(c)),
                Quantity(executor_resources.nvidia_gpu.exact * int(c)),
            )
            reserved[name] = reserved.get(name, Resources.zero()).add(total)
    return reserved


def counts_to_tightly_list(names: List[str], counts: np.ndarray) -> List[str]:
    out: List[str] = []
    for name, c in zip(names, counts):
        if c > 0:
            out.extend([name] * int(c))
    return out


def counts_to_evenly_list(names: List[str], counts: np.ndarray) -> List[str]:
    """Round-robin visit order: sweep t emits every node with count > t,
    in priority order (matches the Go loop's append order)."""
    counts = counts.astype(np.int64)
    k = int(counts.sum())
    if k == 0:
        return []
    idx = np.flatnonzero(counts)
    # (sweep, priority position) pairs for each emitted executor
    sweeps = np.concatenate([np.arange(counts[i]) for i in idx])
    positions = np.repeat(idx, counts[idx])
    order = np.lexsort((positions, sweeps))
    return [names[positions[j]] for j in order]


def problem_tensors(problem: ScaledProblem, device: torch.device):
    """The node-side arrays of a ScaledProblem on `device`:
    (avail, driver_rank, exec_ok)."""
    return (
        torch.as_tensor(problem.avail, device=device),
        torch.as_tensor(problem.driver_rank, device=device),
        torch.as_tensor(problem.exec_ok, device=device),
    )


class TpuBatchBinpacker:
    """A drop-in SparkBinPackFunction backed by the PyTorch solver.

    assignment_policy: 'tightly-pack' or 'distribute-evenly' — controls
    the executor placement list (feasibility and driver choice are
    policy-invariant, see batch_solver docstring).  device: None = CUDA.
    """

    def __init__(
        self,
        assignment_policy: str = "tightly-pack",
        verify_against_oracle: bool = False,
        strict_reference_parity: bool = compat.DEFAULT_STRICT,
        device: DeviceLike = None,
    ):
        if assignment_policy not in POLICIES:
            raise NotImplementedError(
                f"assignment policy {assignment_policy!r} is not ported to PyTorch yet"
            )
        self.assignment_policy = assignment_policy
        self.verify_against_oracle = verify_against_oracle
        self.strict_reference_parity = strict_reference_parity
        self.device = resolve_device(device)

    def __call__(
        self,
        driver_resources: Resources,
        executor_resources: Resources,
        executor_count: int,
        driver_node_priority_order: Sequence[str],
        executor_node_priority_order: Sequence[str],
        metadata: NodeGroupSchedulingMetadata,
    ) -> PackingResult:
        cluster = tensorize_cluster(
            metadata, driver_node_priority_order, executor_node_priority_order
        )
        apps = tensorize_apps([AppDemand(driver_resources, executor_resources, executor_count)])
        problem = scale_problem(cluster, apps)
        oracle = (
            packers.tightly_pack
            if self.assignment_policy == "tightly-pack"
            else packers.distribute_evenly
        )
        if not problem.ok:
            logger.warning("snapshot not exactly tensorizable; using host oracle")
            return oracle(
                driver_resources,
                executor_resources,
                executor_count,
                driver_node_priority_order,
                executor_node_priority_order,
                metadata,
            )

        result = self._solve_and_decode(cluster, problem, executor_count, metadata)

        if self.verify_against_oracle:
            expected = oracle(
                driver_resources,
                executor_resources,
                executor_count,
                driver_node_priority_order,
                executor_node_priority_order,
                metadata,
            )
            if (
                expected.has_capacity != result.has_capacity
                or expected.driver_node != result.driver_node
                or expected.executor_nodes != result.executor_nodes
            ):
                logger.error(
                    "tpu-batch solver disagreed with oracle (solver %s@%s vs oracle %s@%s); "
                    "using oracle",
                    result.has_capacity,
                    result.driver_node,
                    expected.has_capacity,
                    expected.driver_node,
                )
                return expected
        return result

    def _solve_and_decode(
        self,
        cluster: ClusterTensor,
        problem: ScaledProblem,
        executor_count: int,
        metadata: NodeGroupSchedulingMetadata,
    ) -> PackingResult:
        avail, driver_rank, exec_ok = problem_tensors(problem, self.device)
        solve = solve_single(
            avail,
            driver_rank,
            exec_ok,
            torch.as_tensor(problem.driver[0], device=self.device),
            torch.as_tensor(problem.executor[0], device=self.device),
            int(problem.count[0]),
        )
        if not bool(solve.feasible):
            return empty_packing_result()

        driver_idx = int(solve.driver_idx)
        names = cluster.node_names
        driver_node = names[driver_idx]

        if self.assignment_policy == "tightly-pack":
            counts = solve.exec_counts.cpu().numpy()[: len(names)]
            executor_nodes = counts_to_tightly_list(names, counts)
        else:
            cap = solve.exec_capacity.cpu().numpy()[: len(names)]
            counts = evenly_counts(cap, executor_count)
            executor_nodes = counts_to_evenly_list(names, counts)

        # efficiencies as the reference computes them: driver + per-node
        # executor reservations folded into `reserved`
        reserved = {driver_node: self._scale_back(problem, problem.driver[0])}
        for name, c in zip(names, counts):
            if c > 0:
                add = self._scale_back(problem, problem.executor[0] * int(c))
                reserved[name] = reserved.get(name, Resources.zero()).add(add)
        return PackingResult(
            driver_node=driver_node,
            executor_nodes=executor_nodes,
            has_capacity=True,
            packing_efficiencies=compute_packing_efficiencies(metadata, reserved),
        )

    @staticmethod
    def _scale_back(problem: ScaledProblem, row: np.ndarray) -> Resources:
        cpu_m, mem_b, gpu_m = (
            int(row[0]) * int(problem.scale[0]),
            int(row[1]) * int(problem.scale[1]),
            int(row[2]) * int(problem.scale[2]),
        )
        return Resources(
            Quantity(Fraction(cpu_m, 1000)),
            Quantity(mem_b),
            Quantity(Fraction(gpu_m, 1000)),
        )


def _tpu_batch(name: str, policy: str, strict: bool, device: DeviceLike) -> Binpacker:
    from .fifo_solver import TpuFifoSolver

    return Binpacker(
        name=name,
        binpack_func=TpuBatchBinpacker(
            assignment_policy=policy, strict_reference_parity=strict, device=device
        ),
        is_single_az=False,
        queue_solver=TpuFifoSolver(
            assignment_policy=policy, strict_reference_parity=strict, device=device
        ),
    )


def tpu_batch_binpacker(
    strict_reference_parity: bool = compat.DEFAULT_STRICT, device: DeviceLike = None
) -> Binpacker:
    return _tpu_batch(TPU_BATCH, "tightly-pack", strict_reference_parity, device)


def tpu_batch_evenly_binpacker(
    strict_reference_parity: bool = compat.DEFAULT_STRICT, device: DeviceLike = None
) -> Binpacker:
    return _tpu_batch(TPU_BATCH_EVENLY, "distribute-evenly", strict_reference_parity, device)
