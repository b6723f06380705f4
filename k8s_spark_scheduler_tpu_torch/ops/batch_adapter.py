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
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import compat
from ..device import DeviceLike, resolve_device
from ..types.resources import NodeGroupSchedulingMetadata, Resources
from ..utils.quantity import Quantity
from . import packers
from .batch_solver import solve_single, solve_zones
from .capacity import NodeAndExecutorCapacity
from .efficiency import compute_packing_efficiencies
from .packers import PackingResult, empty_packing_result
from .registry import (
    TPU_BATCH,
    TPU_BATCH_AZ_AWARE,
    TPU_BATCH_EVENLY,
    TPU_BATCH_MIN_FRAG,
    TPU_BATCH_SINGLE_AZ,
    TPU_BATCH_SINGLE_AZ_MIN_FRAG,
    Binpacker,
)
from .sparkapp import AppDemand
from .tensorize import ClusterTensor, ScaledProblem, scale_problem, tensorize_apps, tensorize_cluster

logger = logging.getLogger(__name__)

POLICIES = ("tightly-pack", "distribute-evenly", "minimal-fragmentation")


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


def min_frag_unclamped_caps(
    avail: np.ndarray, exec_row: np.ndarray, exec_ok: np.ndarray, driver_idx: int,
    driver_row: np.ndarray,
) -> np.ndarray:
    """Exact UNCLAMPED per-node capacities (int64) for the min-frag
    decode, from scaled integer availability rows with the driver
    subtracted on its node (capacity.go:36-75; negative dims are 0 even
    under a zero requirement — the reserved>available short-circuit)."""
    avail = avail.astype(np.int64).copy()
    avail[driver_idx] -= driver_row.astype(np.int64)
    exec_row = exec_row.astype(np.int64)
    per_dim = np.where(
        exec_row[None, :] == 0,
        np.where(avail >= 0, np.int64(2**62), np.int64(0)),
        np.floor_divide(avail, np.maximum(exec_row[None, :], 1)),
    )
    cap = np.clip(per_dim.min(axis=1), 0, None)
    return np.where(exec_ok, cap, 0)


def minimal_fragmentation_assignment(
    names: List[str], cap: np.ndarray, k: int
) -> Optional[List[str]]:
    """Exact minimal-fragmentation placement from per-node integer
    capacities (minimal_fragmentation.go:59-137): the capacities equal the
    oracle's Fraction floor divisions, so the host-side bisect algorithm
    reproduces the oracle list exactly."""
    if k == 0:
        return []
    capacities = [NodeAndExecutorCapacity(name, int(c)) for name, c in zip(names, cap) if c > 0]
    nodes, ok = packers.minimal_fragmentation_from_capacities(k, capacities)
    return nodes if ok else None


def min_frag_zone_decode(
    names: List[str],
    avail_rows: np.ndarray,
    exec_row: np.ndarray,
    zone_exec_ok: np.ndarray,
    d_idx: int,
    driver_row: np.ndarray,
    k: int,
    strict_reference_parity: bool,
):
    """Per-zone minimal-fragmentation decode shared by the single-AZ
    binpacker and the FIFO solver's host lane: exact bisect placements,
    the true per-node counts (for the usage carry), and the
    efficiency-side counts — zeroed under strict parity, where the
    reference's no-write-back quirk makes the zone choice see only the
    driver's reservation.  Returns (executor_nodes, counts, eff_counts) or
    None (infeasible)."""
    zcap = min_frag_unclamped_caps(avail_rows, exec_row, zone_exec_ok, d_idx, driver_row)
    executor_nodes = minimal_fragmentation_assignment(names, zcap, k)
    if executor_nodes is None:
        return None
    counts = counts_of(names, executor_nodes)
    eff_counts = np.zeros_like(counts) if strict_reference_parity else counts
    return executor_nodes, counts, eff_counts


def counts_of(names: List[str], executor_nodes: List[str]) -> np.ndarray:
    """Executors per node (int64, in `names` order) of a placement list."""
    counts = np.zeros(len(names), dtype=np.int64)
    pos = {name: i for i, name in enumerate(names)}
    for node in executor_nodes:
        counts[pos[node]] += 1
    return counts


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

    assignment_policy: 'tightly-pack', 'distribute-evenly' or
    'minimal-fragmentation' — controls the executor placement list
    (feasibility and driver choice are policy-invariant, see batch_solver
    docstring).  device: None = CUDA.
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
        oracle = {
            "tightly-pack": packers.tightly_pack,
            "minimal-fragmentation": packers.make_minimal_fragmentation_pack(
                self.strict_reference_parity
            ),
        }.get(self.assignment_policy, packers.distribute_evenly)
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
        elif self.assignment_policy == "minimal-fragmentation":
            # the (k+max)/2 subset threshold needs UNCLAMPED capacities (the
            # solve clamps to k): recompute exactly from the scaled integer
            # rows, with the driver subtracted on its node
            cap = min_frag_unclamped_caps(
                problem.avail[: len(names)],
                problem.executor[0],
                problem.exec_ok[: len(names)],
                driver_idx,
                problem.driver[0],
            )
            executor_nodes = minimal_fragmentation_assignment(names, cap, executor_count)
            if executor_nodes is None:
                return empty_packing_result()
            # QUIRK (switchable): the reference's min-frag does not fold the
            # placements into reserved, so under strict parity efficiencies
            # see only the driver
            counts = np.zeros(len(names), dtype=np.int64)
            if not self.strict_reference_parity:
                counts = counts_of(names, executor_nodes)
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


def tpu_batch_min_frag_binpacker(
    strict_reference_parity: bool = compat.DEFAULT_STRICT, device: DeviceLike = None
) -> Binpacker:
    return _tpu_batch(TPU_BATCH_MIN_FRAG, "minimal-fragmentation", strict_reference_parity, device)


def candidate_zone_masks(driver_order, executor_order, metadata, names, nb):
    """Zone ordering + per-zone node masks shared by the single-AZ gang
    and FIFO paths (single_az.go:30-45 first-appearance order; zones
    without executor candidates are dropped)."""
    driver_zones_in_order, _ = packers.group_nodes_by_zone(driver_order, metadata)
    _, executor_by_zone = packers.group_nodes_by_zone(executor_order, metadata)
    candidate_zones = [z for z in driver_zones_in_order if z in executor_by_zone]
    zone_of = {name: metadata[name].zone_label for name in names}
    zone_masks = np.zeros((max(len(candidate_zones), 1), nb), dtype=bool)
    for zi, zone in enumerate(candidate_zones):
        for i, name in enumerate(names):
            zone_masks[zi, i] = zone_of[name] == zone
    return candidate_zones, zone_masks


class TpuSingleAzBinpacker:
    """Single-AZ combinator on the device (single_az.go:23-55): every
    zone's gang solve in one call (batch_solver.solve_zones), the zone
    chosen on the host with the oracle's exact efficiency math
    (_choose_best_result).  az_aware=True adds the cross-zone fallback
    (az_aware_pack_tightly.go:27-38).

    inner_policy selects the per-zone distribution: "tightly-pack" (device
    counts) or "minimal-fragmentation" (single-az-minimal-fragmentation:
    zone feasibility and driver choice are policy-invariant, so the zone
    solves are shared; placements come from the exact host bisect, and
    under strict parity the reference's no-efficiency-write-back quirk
    makes the zone choice see only the driver's reservation).  device:
    None = CUDA."""

    def __init__(
        self,
        az_aware: bool = False,
        inner_policy: str = "tightly-pack",
        strict_reference_parity: bool = compat.DEFAULT_STRICT,
        device: DeviceLike = None,
    ):
        self.az_aware = az_aware
        self.inner_policy = inner_policy
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
        if self.inner_policy == "minimal-fragmentation":
            oracle = packers.make_single_az_minimal_fragmentation(self.strict_reference_parity)
        else:
            oracle = packers.az_aware_tightly_pack if self.az_aware else packers.single_az_tightly_pack
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

        names = cluster.node_names
        n = len(names)
        nb = problem.avail.shape[0]
        candidate_zones, zone_masks = candidate_zone_masks(
            driver_node_priority_order, executor_node_priority_order, metadata, names, nb
        )
        avail, driver_rank, exec_ok = problem_tensors(problem, self.device)
        solves = solve_zones(
            avail,
            driver_rank,
            exec_ok,
            torch.as_tensor(zone_masks, device=self.device),
            torch.as_tensor(problem.driver[0], device=self.device),
            torch.as_tensor(problem.executor[0], device=self.device),
            int(problem.count[0]),
        )
        feasible = solves.feasible.cpu().numpy()
        driver_idx = solves.driver_idx.cpu().numpy()
        counts = solves.exec_counts.cpu().numpy()

        results = []
        for zi, zone in enumerate(candidate_zones):
            if not feasible[zi]:
                continue
            d_idx = int(driver_idx[zi])
            driver_node = names[d_idx]
            if self.inner_policy == "minimal-fragmentation":
                decoded = min_frag_zone_decode(
                    names,
                    problem.avail[:n],
                    problem.executor[0],
                    problem.exec_ok[:n] & zone_masks[zi][:n],
                    d_idx,
                    problem.driver[0],
                    executor_count,
                    self.strict_reference_parity,
                )
                if decoded is None:  # unreachable: zone feasibility proven
                    continue
                executor_nodes, _counts, eff_counts = decoded
            else:
                eff_counts = counts[zi][:n]
                executor_nodes = counts_to_tightly_list(names, eff_counts)
            results.append(
                PackingResult(
                    driver_node=driver_node,
                    executor_nodes=executor_nodes,
                    has_capacity=True,
                    packing_efficiencies=compute_packing_efficiencies(
                        metadata,
                        build_reserved(
                            names, eff_counts, driver_node, driver_resources, executor_resources
                        ),
                    ),
                )
            )

        if results:
            best = packers._choose_best_result(metadata, results)
            # _choose_best_result returns the empty result when every
            # candidate has zero avg efficiency (the documented quirk) —
            # az-aware must then still take the cross-zone fallback, like
            # az_aware_pack_tightly.go:34-37's has_capacity check
            if best.has_capacity or not self.az_aware:
                return best
        if self.az_aware:
            # cross-zone fallback: plain tightly-pack on the device
            return TpuBatchBinpacker(
                assignment_policy="tightly-pack",
                strict_reference_parity=self.strict_reference_parity,
                device=self.device,
            )(
                driver_resources,
                executor_resources,
                executor_count,
                driver_node_priority_order,
                executor_node_priority_order,
                metadata,
            )
        return empty_packing_result()


def _tpu_batch_single_az(
    name: str, az_aware: bool, inner_policy: str, strict: bool, device: DeviceLike
) -> Binpacker:
    from .fifo_solver import TpuSingleAzFifoSolver

    return Binpacker(
        name=name,
        binpack_func=TpuSingleAzBinpacker(
            az_aware=az_aware, inner_policy=inner_policy, strict_reference_parity=strict,
            device=device,
        ),
        is_single_az=True,
        queue_solver=TpuSingleAzFifoSolver(
            az_aware=az_aware, inner_policy=inner_policy, strict_reference_parity=strict,
            device=device,
        ),
    )


def tpu_batch_single_az_binpacker(
    strict_reference_parity: bool = compat.DEFAULT_STRICT, device: DeviceLike = None
) -> Binpacker:
    return _tpu_batch_single_az(
        TPU_BATCH_SINGLE_AZ, False, "tightly-pack", strict_reference_parity, device
    )


def tpu_batch_single_az_min_frag_binpacker(
    strict_reference_parity: bool = compat.DEFAULT_STRICT, device: DeviceLike = None
) -> Binpacker:
    return _tpu_batch_single_az(
        TPU_BATCH_SINGLE_AZ_MIN_FRAG, False, "minimal-fragmentation", strict_reference_parity,
        device,
    )


def tpu_batch_az_aware_binpacker(
    strict_reference_parity: bool = compat.DEFAULT_STRICT, device: DeviceLike = None
) -> Binpacker:
    return _tpu_batch_single_az(TPU_BATCH_AZ_AWARE, True, "tightly-pack", strict_reference_parity, device)
