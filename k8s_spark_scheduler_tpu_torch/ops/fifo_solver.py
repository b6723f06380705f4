"""FIFO queue solver: the extender's earlier-drivers pass on the device.

Replaces the host loop of resource.go:224-262 (binpack every earlier
driver, subtract its usage, fail if an enforced driver doesn't fit) with
ONE whole-queue solve — the CUDA queue kernel (:mod:`.queue_kernel`) on
a CUDA device, its plain PyTorch version on the CPU — then packs the
current driver against the resulting availability.  Decisions are
bit-identical to the JAX package's ``TpuFifoSolver`` (tests/
test_torch_fifo_solver.py); problems that can't be exactly tensorized
return ``supported=False`` and the caller uses the host oracle path.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import compat
from ..device import DeviceLike, lane_of, resolve_device
from ..types.resources import NodeGroupSchedulingMetadata, Resources
from ..utils.quantity import Quantity
from .batch_adapter import (
    POLICIES,
    build_reserved,
    counts_to_evenly_list,
    counts_to_tightly_list,
    evenly_counts,
    problem_tensors,
)
from .batch_solver import solve_single
from .efficiency import PackingEfficiency, compute_packing_efficiencies
from .packers import PackingResult, empty_packing_result
from .queue_kernel import fifo_queue
from .sparkapp import AppDemand
from .tensorize import (
    AppTensor,
    _app_base_rows,
    scale_problem,
    tensorize_apps,
    tensorize_cluster,
)
from .tensorize import _resources_to_base as _res_rows


def _ceil_div(v, d: int):
    return -((-v) // d)


class LazyEfficiencies(dict):
    """Per-node PackingEfficiency mapping backed by vectorized float64
    columns.  The metrics path needs only the average of per-node maxes,
    so building 10k dataclasses per Filter request is deferred: [] / .get
    materialize single entries; values()/items() materialize everything
    (only the exact Quantity-parity consumers do that)."""

    def __init__(self, names, cpu, mem, gpu):
        super().__init__()
        self._names = list(names)
        # name → column dict built on first materialization
        self._col_idx_lazy = None
        self._cpu = cpu
        self._mem = mem
        self._gpu = gpu

    @property
    def _col_idx(self):
        if self._col_idx_lazy is None:
            self._col_idx_lazy = dict(zip(self._names, range(len(self._names))))
        return self._col_idx_lazy

    def __missing__(self, name):
        i = self._col_idx[name]
        e = PackingEfficiency(
            node_name=name,
            cpu=float(self._cpu[i]),
            memory=float(self._mem[i]),
            gpu=float(self._gpu[i]),
        )
        self[name] = e
        return e

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    # the full dict read protocol reflects ALL nodes (not just the
    # materialized subset), in node order, so order-sensitive float
    # accumulations see exactly the sequence an eager dict produces
    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __contains__(self, name):
        return name in self._col_idx

    def keys(self):
        return list(self._names)

    def values(self):
        return [self[n] for n in self._names]

    def items(self):
        return [(n, self[n]) for n in self._names]

    def seq_max_avg(self) -> float:
        """sum(max(gpu, cpu, memory)) / n for the packing-efficiency
        gauge, Neumaier-compensated: lanes that sum the same per-node
        maxes in different orders must agree bit for bit, and
        compensation makes the rounded result order-robust (exact
        whenever the true sum is representable)."""
        if not self._names:
            return 0.0
        maxes = np.maximum(np.maximum(self._cpu, self._mem), self._gpu)
        s = 0.0
        c = 0.0
        for x in maxes.tolist():
            t = s + x
            if abs(s) >= abs(x):
                c += (s - t) + x
            else:
                c += (x - t) + s
            s = t
        return (s + c) / float(len(self._names))


def efficiencies_from_rows(names, sched_rows, avail_rows, reserved_rows):
    """compute_packing_efficiencies from exact base-unit int rows —
    bit-identical floats to the Quantity path (efficiency.go:80-105):
    per-dim reserved = schedulable − available + newly_reserved, then
    Quantity.value() semantics (ceil to canonical units) and ratio —
    computed as vectorized int64/float64 columns behind a
    lazily-materialized mapping."""
    n = len(names)
    s = np.asarray(sched_rows)[:n].astype(np.int64)
    r = (
        s
        - np.asarray(avail_rows)[:n].astype(np.int64)
        + np.asarray(reserved_rows)[:n].astype(np.int64)
    )
    s_cpu = _ceil_div(s[:, 0], 1000)
    s_gpu = _ceil_div(s[:, 2], 1000)
    r_cpu = _ceil_div(r[:, 0], 1000)
    r_gpu = _ceil_div(r[:, 2], 1000)
    # Go divides by normalize(schedulable)=1 when schedulable is 0
    cpu = r_cpu / np.maximum(s_cpu, 1)
    mem = r[:, 1] / np.maximum(s[:, 1], 1)
    gpu = np.where(s_gpu != 0, r_gpu / np.maximum(s_gpu, 1), 0.0)
    return LazyEfficiencies(names, cpu, mem, gpu)


def _patch_available(metadata, names, avail_rows):
    """Metadata view whose candidate-node availability is replaced by the
    post-queue carry (exact base-unit ints → exact Quantities): host-lane
    parity for efficiency metrics, which the reference computes against
    the metadata mutated by fitEarlierDrivers (resource.go:255-259)."""
    patched = dict(metadata)
    for i, name in enumerate(names):
        patched[name] = replace(
            metadata[name],
            available=Resources(
                Quantity(Fraction(int(avail_rows[i, 0]), 1000)),
                Quantity(int(avail_rows[i, 1])),
                Quantity(Fraction(int(avail_rows[i, 2]), 1000)),
            ),
        )
    return patched


@dataclass
class FifoOutcome:
    """Result of the combined earlier-drivers + current-driver solve."""

    supported: bool  # False → caller must use the host oracle path
    earlier_ok: bool = True  # False → an enforced earlier driver doesn't fit
    result: Optional[PackingResult] = None  # current driver's packing


class TpuFifoSolver:
    """One device round for the whole FIFO queue + the current driver.

    The queue pass is one launch of the CUDA queue kernel on a CUDA
    device (lane "cuda") or its plain PyTorch version on the CPU (lane
    "torch"); the current driver is decoded with one O(N) solve_single
    against the carried availability.

    backend: "auto" (the lane of `device`), "cuda" or "torch"; a backend
    that does not match the device raises.  device: None = CUDA.
    minimal-fragmentation is not ported yet: its solves report
    supported=False."""

    def __init__(
        self,
        assignment_policy: str = "tightly-pack",
        backend: str = "auto",
        strict_reference_parity: bool = compat.DEFAULT_STRICT,
        device: DeviceLike = None,
    ):
        self.assignment_policy = assignment_policy
        self.device = resolve_device(device)
        if backend not in ("auto", lane_of(self.device)):
            raise ValueError(f"backend {backend!r} does not run on device {self.device}")
        self.backend = backend
        # min-frag only: whether the reference's no-efficiency-write-back
        # quirk applies to the current driver's reported efficiencies
        self.strict_reference_parity = strict_reference_parity
        # which lane served the last queue pass: "cuda" or "torch";
        # None = no queue pass ran
        self.last_queue_lane: Optional[str] = None
        # (ids, strong refs, AppTensor) of the last earlier-apps list:
        # consecutive Filters tensorize the same pending queue.  The
        # cached list holds strong references, so an id can never be
        # reused while the entry lives — id-tuple equality therefore
        # proves the SAME AppDemand objects, making the hit exact.
        self._earlier_tensor_cache = None

    def solve(
        self,
        metadata: NodeGroupSchedulingMetadata,
        driver_order: Sequence[str],
        executor_order: Sequence[str],
        earlier_apps: List[AppDemand],
        earlier_skip_allowed: List[bool],
        current_app: AppDemand,
    ) -> FifoOutcome:
        cluster = tensorize_cluster(metadata, driver_order, executor_order)
        return self.solve_tensor(
            cluster, earlier_apps, earlier_skip_allowed, current_app, metadata=metadata
        )

    def _tensorize_with_cache(self, earlier, current_app):
        """AppTensor for earlier + [current]: the earlier block is cached
        by object identity (see _earlier_tensor_cache) and the current
        app's rows are appended."""
        key = tuple(map(id, earlier))
        cached = self._earlier_tensor_cache
        if cached is not None and cached[0] == key:
            base = cached[2]
        else:
            base = tensorize_apps(earlier)
            self._earlier_tensor_cache = (key, earlier, base)
        drow, erow, exact = _app_base_rows(current_app)
        a = base.driver.shape[0]
        driver = np.empty((a + 1, 3), dtype=np.int64)
        driver[:a] = base.driver
        driver[a] = drow
        executor = np.empty((a + 1, 3), dtype=np.int64)
        executor[:a] = base.executor
        executor[a] = erow
        count = np.empty(a + 1, dtype=np.int64)
        count[:a] = base.count
        count[a] = current_app.min_executor_count
        return AppTensor(
            driver=driver,
            executor=executor,
            count=count,
            valid=np.ones(a + 1, dtype=bool),
            exact=base.exact and exact,
        )

    def _single(self, problem, avail, driver_rank, exec_ok, app: int):
        return solve_single(
            avail,
            driver_rank,
            exec_ok,
            torch.as_tensor(problem.driver[app], device=self.device),
            torch.as_tensor(problem.executor[app], device=self.device),
            int(problem.count[app]),
        )

    def feasible_tensor(self, cluster, app: AppDemand) -> Optional[bool]:
        """Feasibility of one app against a prebuilt ClusterTensor with
        no placement decode and no efficiency math.  Feasibility is
        policy-invariant across tightly/evenly (the work-conserving drain
        rule, batch_solver docstring), identical to binpack_func's
        has_capacity.  None = not exactly tensorizable (caller uses the
        host path)."""
        problem = scale_problem(cluster, tensorize_apps([app]))
        if not problem.ok:
            return None
        return bool(self._single(problem, *problem_tensors(problem, self.device), 0).feasible)

    def solve_tensor(
        self,
        cluster,
        earlier_apps: List[AppDemand],
        earlier_skip_allowed: List[bool],
        current_app: AppDemand,
        metadata: Optional[NodeGroupSchedulingMetadata] = None,
    ) -> FifoOutcome:
        """Solve from a prebuilt ClusterTensor (`metadata` is only used
        for the Quantity-based efficiency computation when provided)."""
        self.last_queue_lane = None
        if self.assignment_policy not in POLICIES:
            return FifoOutcome(supported=False)
        apps = self._tensorize_with_cache(list(earlier_apps), current_app)
        problem = scale_problem(cluster, apps)
        if not problem.ok:
            return FifoOutcome(supported=False)

        evenly = self.assignment_policy == "distribute-evenly"
        n_earlier = len(earlier_apps)
        avail, driver_rank, exec_ok = problem_tensors(problem, self.device)
        if n_earlier > 0:
            # whole-queue pass over the earlier drivers only
            queue_valid = problem.app_valid.copy()
            queue_valid[n_earlier:] = False
            self.last_queue_lane = lane_of(self.device)
            feasible_dev, _, avail = fifo_queue(
                avail,
                driver_rank,
                exec_ok,
                torch.as_tensor(problem.driver, device=self.device),
                torch.as_tensor(problem.executor, device=self.device),
                torch.as_tensor(problem.count, device=self.device),
                torch.as_tensor(queue_valid, device=self.device),
                evenly=evenly,
            )
            feasible = feasible_dev[:n_earlier].cpu().numpy()
            # an enforced (old-enough) earlier driver that doesn't fit
            # fails the whole request (resource.go:244-253)
            for i in range(n_earlier):
                if not feasible[i] and not earlier_skip_allowed[i]:
                    return FifoOutcome(supported=True, earlier_ok=False)

        return self._pack_current(
            cluster, problem, (avail, driver_rank, exec_ok), n_earlier, current_app,
            metadata=metadata,
        )

    def _pack_current(
        self,
        cluster,
        problem,
        node_tensors,
        n_earlier: int,
        current_app: AppDemand,
        metadata: Optional[NodeGroupSchedulingMetadata] = None,
    ) -> FifoOutcome:
        """The current driver's gang pack against the post-queue
        availability carry: solve + placement decode + efficiency rows.
        node_tensors = (avail_after, driver_rank, exec_ok) on the device."""
        avail_after = node_tensors[0]
        solve = self._single(problem, *node_tensors, n_earlier)
        if not bool(solve.feasible):
            return FifoOutcome(supported=True, earlier_ok=True, result=empty_packing_result())

        names = cluster.node_names
        driver_idx = int(solve.driver_idx)
        driver_node = names[driver_idx]
        k = current_app.min_executor_count
        if self.assignment_policy == "distribute-evenly":
            cap = solve.exec_capacity.cpu().numpy()[: len(names)]
            counts = evenly_counts(cap, k)
            executor_nodes = counts_to_evenly_list(names, counts)
        else:
            counts = solve.exec_counts.cpu().numpy()[: len(names)]
            executor_nodes = counts_to_tightly_list(names, counts)

        # efficiencies feed metrics only on this path; the host lane
        # computes them against the metadata MUTATED by the
        # earlier-drivers pass (resource.go:255-259 then binpack on the
        # same map), so both branches use the post-queue availability.
        def post_queue_avail_rows():
            if n_earlier == 0:
                return cluster.avail[: len(names)]
            scale = problem.scale.astype(np.int64)
            return avail_after.cpu().numpy()[: len(names)].astype(np.int64) * scale[None, :]

        if metadata is not None:
            reserved = build_reserved(
                names, counts, driver_node, current_app.driver_resources,
                current_app.executor_resources,
            )
            eff_meta = metadata
            if n_earlier > 0:
                eff_meta = _patch_available(metadata, names, post_queue_avail_rows())
            efficiencies = compute_packing_efficiencies(eff_meta, reserved)
        else:
            # per-node reserved = count × executor (+ driver on its node)
            reserved_rows = np.zeros_like(cluster.avail)
            drv_row, _ = _res_rows(current_app.driver_resources)
            exec_row, _ = _res_rows(current_app.executor_resources)
            reserved_rows[driver_idx] += np.array(drv_row, np.int64)
            reserved_rows[: len(names)] += (
                counts.astype(np.int64)[:, None] * np.array(exec_row, np.int64)[None, :]
            )
            efficiencies = efficiencies_from_rows(
                names, cluster.sched, post_queue_avail_rows(), reserved_rows
            )
        result = PackingResult(
            driver_node=driver_node,
            executor_nodes=executor_nodes,
            has_capacity=True,
            packing_efficiencies=efficiencies,
            max_avg_efficiency=(
                efficiencies.seq_max_avg()
                if isinstance(efficiencies, LazyEfficiencies)
                else None
            ),
        )
        return FifoOutcome(supported=True, earlier_ok=True, result=result)
