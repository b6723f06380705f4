"""FIFO queue solvers: the extender's earlier-drivers pass on the device.

Replaces the host loop of resource.go:224-262 (binpack every earlier
driver, subtract its usage, fail if an enforced driver doesn't fit) with
ONE whole-queue solve — a CUDA kernel on a CUDA device (:mod:`.queue_kernel`
for tightly-pack / distribute-evenly, :mod:`.minfrag_kernel` for
minimal-fragmentation, :mod:`.single_az_kernel` for the single-AZ
policies), its plain PyTorch version on the CPU — then packs the current
driver against the resulting availability.  Decisions are bit-identical
to the JAX package's ``TpuFifoSolver`` and ``TpuSingleAzFifoSolver``
(tests/test_torch_fifo_solver.py, test_torch_min_frag.py,
test_torch_single_az.py); problems that can't be exactly tensorized
return ``supported=False`` and the caller uses the host oracle path.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import compat
from ..device import DeviceLike, lane_of, resolve_device
from ..tracing import spans as tracing
from ..tracing.profiling import default_profiler
from ..types.resources import NodeGroupSchedulingMetadata, Resources
from ..utils.quantity import Quantity
from . import packers
from .batch_adapter import (
    POLICIES,
    build_reserved,
    candidate_zone_masks,
    counts_of,
    counts_to_evenly_list,
    counts_to_tightly_list,
    evenly_counts,
    min_frag_unclamped_caps,
    min_frag_zone_decode,
    minimal_fragmentation_assignment,
    problem_tensors,
)
from .batch_solver import mf_sentinel_safe, queue_policy_code, solve_single, solve_zones
from .efficiency import PackingEfficiency, compute_packing_efficiencies
from .minfrag_kernel import fifo_queue_min_frag
from .packers import PackingResult, empty_packing_result
from .queue_kernel import fifo_queue
from .single_az_kernel import fifo_queue_single_az
from .sparkapp import AppDemand
from .tensorize import (
    AppTensor,
    _app_base_rows,
    scale_problem,
    tensorize_apps,
    tensorize_cluster,
)
from .tensorize import _resources_to_base as _res_rows

logger = logging.getLogger(__name__)


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

    The queue pass is one launch of a CUDA queue kernel on a CUDA device
    (lane "cuda": fifo_queue for tightly-pack / distribute-evenly,
    fifo_queue_min_frag for minimal-fragmentation) or its plain PyTorch
    version on the CPU (lane "torch"); the current driver is decoded with
    one O(N) solve_single against the carried availability, its min-frag
    placement by the exact host bisect.  A min-frag snapshot whose scaled
    availability could reach the drain's unbounded sentinel
    (batch_solver.mf_sentinel_safe) reports supported=False.

    backend: "auto" (the lane of `device`), "cuda" or "torch"; a backend
    that does not match the device raises.  device: None = CUDA."""

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
        # provenance capture (provenance/tracker.py): wiring points this at
        # ProvenanceTracker.capture when provenance is enabled; None (the
        # default) keeps solve_tensor capture-free
        self.capture_sink = None
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
        minfrag = self.assignment_policy == "minimal-fragmentation"
        if minfrag and not mf_sentinel_safe(problem.avail):
            # a real capacity could collide with the drain's
            # unbounded-capacity sentinel (batch_solver.MF_SENT)
            return FifoOutcome(supported=False)
        n_earlier = len(earlier_apps)
        avail, driver_rank, exec_ok = problem_tensors(problem, self.device)
        if n_earlier > 0:
            # whole-queue pass over the earlier drivers only.  The
            # fifo_gate span is the request's "earlier drivers fit?"
            # phase; the kernel profile inside it splits the dispatch
            # into build vs execute time (tracing/profiling.py).
            with tracing.child_span("fifo_gate", {"earlierApps": n_earlier}) as gate_span:
                queue_valid = problem.app_valid.copy()
                queue_valid[n_earlier:] = False
                self.last_queue_lane = lane_of(self.device)
                queue_args = (
                    avail,
                    driver_rank,
                    exec_ok,
                    torch.as_tensor(problem.driver, device=self.device),
                    torch.as_tensor(problem.executor, device=self.device),
                    torch.as_tensor(problem.count, device=self.device),
                    torch.as_tensor(queue_valid, device=self.device),
                )
                kernel = "fifo_queue_min_frag" if minfrag else "fifo_queue"
                shape_key = (problem.avail.shape, problem.driver.shape)
                with default_profiler.profile(kernel, lane=self.last_queue_lane, shape_key=shape_key) as rec:
                    if minfrag:
                        feasible_dev, didx_dev, avail = fifo_queue_min_frag(*queue_args)
                    else:
                        feasible_dev, didx_dev, avail = fifo_queue(*queue_args, evenly=evenly)
                    rec.sync(avail)
                feasible = feasible_dev[:n_earlier].cpu().numpy()
                gate_span.tag("lane", self.last_queue_lane)
                # capture BEFORE the blocked-earlier verdict below: a
                # FAILURE_EARLIER_DRIVER refusal is exactly the decision
                # the provenance explainer must be able to decompose
                if self.capture_sink is not None:
                    self._capture_solve(
                        cluster, problem, earlier_skip_allowed, n_earlier, feasible, didx_dev, avail
                    )
                # an enforced (old-enough) earlier driver that doesn't fit
                # fails the whole request (resource.go:244-253)
                for i in range(n_earlier):
                    if not feasible[i] and not earlier_skip_allowed[i]:
                        gate_span.tag("earlierOk", False)
                        return FifoOutcome(supported=True, earlier_ok=False)
                gate_span.tag("earlierOk", True)
        else:
            with tracing.child_span("fifo_gate", {"earlierApps": 0, "earlierOk": True}):
                pass
            if self.capture_sink is not None:
                self._capture_solve(
                    cluster, problem, earlier_skip_allowed, 0, np.zeros(0, dtype=bool), None, avail
                )

        return self._pack_current(
            cluster, problem, (avail, driver_rank, exec_ok), n_earlier, current_app,
            metadata=metadata,
        )

    def _capture_solve(
        self, cluster, problem, earlier_skip_allowed, n_earlier, feasible, didx, avail_after
    ) -> None:
        """Hand the queue solve's inputs + verdicts to the provenance sink
        (provenance/tracker.py), by reference: the host arrays of the
        problem, the feasible verdicts already on the host, and the
        launch's own output tensors (driver indices, availability after
        the queue), which stay on the device until a bundle or an
        explanation needs them.  Only runs when wiring installed a sink."""
        try:
            from ..provenance.tracker import SolveArtifacts

            policy_code = queue_policy_code(self.assignment_policy)
            if policy_code is None:
                return
            na = n_earlier + 1
            packed = np.empty((na, 8), dtype=np.int32)
            packed[:, 0:3] = problem.driver[:na]
            packed[:, 3:6] = problem.executor[:na]
            packed[:, 6] = problem.count[:na]
            packed[:, 7] = problem.app_valid[:na]
            lane = lane_of(self.device)
            self.capture_sink(SolveArtifacts(
                policy_code=int(policy_code),
                lane=f"{lane}-minfrag" if policy_code == 2 else lane,
                basis=problem.avail,
                driver_rank=problem.driver_rank,
                exec_ok=problem.exec_ok,
                packed=packed,
                n_earlier=n_earlier,
                feasible=np.asarray(feasible, dtype=bool),
                didx=didx,
                resume=0,
                avail_after=avail_after,
                scale=problem.scale,
                node_names=cluster.node_names,
                zone_names=cluster.zone_names,
                zone_id=cluster.zone_id,
                skip_allowed=list(earlier_skip_allowed),
                device=self.device,
            ))
        except Exception:
            logger.exception("provenance capture failed (diagnostic only)")

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
        lane = lane_of(self.device)
        with tracing.child_span("binpack", {"policy": self.assignment_policy}) as binpack_span:
            binpack_span.tag("lane", lane)
            with default_profiler.profile("solve_single", lane=lane, shape_key=avail_after.shape) as rec:
                solve = self._single(problem, *node_tensors, n_earlier)
                rec.sync(solve.exec_counts)
            binpack_span.tag("feasible", bool(solve.feasible))
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
        elif self.assignment_policy == "minimal-fragmentation":
            cap = min_frag_unclamped_caps(
                avail_after.cpu().numpy()[: len(names)],
                problem.executor[n_earlier],
                problem.exec_ok[: len(names)],
                driver_idx,
                problem.driver[n_earlier],
            )
            executor_nodes = minimal_fragmentation_assignment(names, cap, k)
            if executor_nodes is None:  # unreachable: feasibility proven above
                return FifoOutcome(supported=True, earlier_ok=True, result=empty_packing_result())
            # QUIRK (switchable): min-frag reports only the driver in
            # reserved/efficiencies under strict parity
            # (packers.make_minimal_fragmentation)
            counts = np.zeros(len(names), dtype=np.int64)
            if not self.strict_reference_parity:
                counts = counts_of(names, executor_nodes)
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


def _fused_efficiency_inputs(cluster, problem, n_apps: Optional[int] = None):
    """Inputs and numeric-range guards of the device zone-efficiency score
    (single_az_kernel).  Returns None when any bound fails and the host
    zone-choice lane must take over.  The bounds guarantee: int32
    exactness of every reserved numerator (r_base = sched_base − m·scale),
    float32 exactness of all ratio operands (ints ≤ 2^24), ratios ≤ 1
    (avail ≤ schedulable), and an int32-safe score accumulator
    ((k+1)·2^EFF_SHIFT < 2^31) for each of the first `n_apps` apps (every
    app by default), the ones the kernel will score."""
    n = len(cluster.node_names)
    nb = problem.avail.shape[0]
    sched = cluster.sched[:n]  # int64 base units (milli-cpu, bytes, milli-gpu)
    avail_base = cluster.avail[:n]
    scale = problem.scale.astype(np.int64)
    counts = problem.count[:n_apps]
    k_max = int(counts.max()) if counts.size else 0
    if k_max + 1 > 4096:
        return None
    if n == 0:
        return None
    if (sched[:, 0] <= 0).any() or (sched[:, 1] <= 0).any():
        # zero-schedulable dims hit the normalize(0)→1 divisor and can
        # produce efficiencies ≫ 1 — the exact float64 host lane handles those
        return None
    if (sched[:, 0] > 2**31 - 1024).any() or (sched[:, 2] > 2**31 - 1024).any():
        return None
    if (avail_base > sched).any():
        return None
    if int(scale[0]) > 2**31 - 1 or int(scale[2]) > 2**31 - 1:
        return None
    th_mem = _ceil_div(sched[:, 1], int(scale[1]))
    den_c = _ceil_div(sched[:, 0], 1000)
    den_g = _ceil_div(sched[:, 2], 1000)
    if (th_mem > 2**24).any() or (den_c > 2**24).any() or (den_g > 2**24).any():
        return None

    s_cpu = np.zeros(nb, np.int32)
    s_cpu[:n] = sched[:, 0]
    s_gpu = np.zeros(nb, np.int32)
    s_gpu[:n] = sched[:, 2]
    inv_m = np.zeros(nb, np.float32)
    inv_m[:n] = (float(scale[1]) / sched[:, 1].astype(np.float64)).astype(np.float32)
    th = np.zeros(nb, np.int32)
    th[:n] = th_mem
    return s_cpu, s_gpu, inv_m, th, int(scale[0]), int(scale[2])


def single_az_queue_inputs(cluster, problem, zone_masks, n_zones: int, n_earlier: int):
    """The fused single-AZ lane's arguments for the earlier-driver queue:
    ((avail, driver_rank, exec_ok, zone_id, drivers, executors, counts,
    queue_valid, s_cpu, s_gpu, inv_mem, th_mem) as numpy arrays,
    (scale_cpu, scale_gpu, n_zones)) for single_az_kernel.
    fifo_queue_single_az, or None when the score's numeric bounds fail
    (_fused_efficiency_inputs) for the earlier apps, the ones it scores
    (the current app is packed on the host lane: a gang of any size
    leaves the queue on the fused lane)."""
    eff_inputs = _fused_efficiency_inputs(cluster, problem, n_earlier)
    if eff_inputs is None:
        return None
    s_cpu, s_gpu, inv_m, th_m, scale_c, scale_g = eff_inputs
    # disjoint zone masks → one zone index per node (-1 = none)
    zone_id = np.full(problem.avail.shape[0], -1, np.int32)
    for zi in range(n_zones):
        zone_id[zone_masks[zi]] = zi
    queue_valid = problem.app_valid.copy()
    queue_valid[n_earlier:] = False
    arrays = (
        problem.avail, problem.driver_rank, problem.exec_ok, zone_id, problem.driver,
        problem.executor, problem.count, queue_valid, s_cpu, s_gpu, inv_m, th_m,
    )
    return arrays, (scale_c, scale_g, n_zones)


class TpuSingleAzFifoSolver:
    """FIFO pass for the single-AZ policies.

    Fused lane (one launch): single_az_kernel.fifo_queue_single_az runs
    the whole earlier-driver queue — per-zone solves (tightly-pack, or the
    min-frag drain), the zone-efficiency choice in certified fixed point
    (batch_solver.EFF_SHIFT), the az-aware cross-zone fallback and the
    carried usage subtraction — as the CUDA kernel on a CUDA device, its
    plain PyTorch version on the CPU.

    Exactness valve: an earlier app whose zone scores land inside the
    fixed-point margin (`uncertain`) is solved on the host lane —
    per-zone solves (batch_solver.solve_zones on the device) with the
    zone choice in the oracle's float64 efficiency math — from the
    availability the fused lane carried to it, exact because every app
    before it was certain; the fused lane resumes after it.  So a queue
    with u uncertain apps costs 1 + 2u launches and u host solves, not a
    host solve of every app (the reference re-solves the whole queue on
    its host lane; the decisions are the same).  Snapshots outside the
    fused lane's numeric bounds (_fused_efficiency_inputs) or, for the
    min-frag inner policy, failing batch_solver.mf_sentinel_safe go
    straight to the host lane.  The current app's packing is always
    chosen with the exact host math.  `last_path` records which lanes
    served the earlier drivers ("fused": the fused lane alone; "host":
    the host lane solved at least one of them; None when the queue is
    empty or the snapshot is not exactly tensorizable).

    inner_policy "minimal-fragmentation" gives the
    single-az-minimal-fragmentation semantics: zone feasibility and driver
    choice are shared with tightly (work-conserving drain), placements
    come from the min-frag drain / host bisect, and the zone choice sees
    driver-only reserved under strict parity (the reference's
    no-write-back quirk).  az_aware has no min-frag variant in the
    reference.  backend: "auto" (the lane of `device`), "cuda" or "torch".
    device: None = CUDA."""

    def __init__(
        self,
        az_aware: bool = False,
        backend: str = "auto",
        inner_policy: str = "tightly-pack",
        strict_reference_parity: bool = compat.DEFAULT_STRICT,
        device: DeviceLike = None,
    ):
        if az_aware and inner_policy == "minimal-fragmentation":
            raise ValueError("az_aware has no minimal-fragmentation variant")
        self.az_aware = az_aware
        self.inner_policy = inner_policy
        self.strict_reference_parity = strict_reference_parity
        self.device = resolve_device(device)
        if backend not in ("auto", lane_of(self.device)):
            raise ValueError(f"backend {backend!r} does not run on device {self.device}")
        self.backend = backend
        self.last_path: Optional[str] = None

    def solve(
        self,
        metadata: NodeGroupSchedulingMetadata,
        driver_order: Sequence[str],
        executor_order: Sequence[str],
        earlier_apps: List[AppDemand],
        earlier_skip_allowed: List[bool],
        current_app: AppDemand,
    ) -> FifoOutcome:
        dev = self.device
        cluster = tensorize_cluster(metadata, driver_order, executor_order)
        problem = scale_problem(cluster, tensorize_apps(list(earlier_apps) + [current_app]))
        self.last_path = None
        if not problem.ok:
            return FifoOutcome(supported=False)

        names = cluster.node_names
        n = len(names)
        nb = problem.avail.shape[0]
        scale = problem.scale.astype(np.int64)
        candidate_zones, zone_masks = candidate_zone_masks(
            driver_order, executor_order, metadata, names, nb
        )
        zone_masks_dev = torch.as_tensor(zone_masks, device=dev)
        _, rank_dev, exec_dev = problem_tensors(problem, dev)
        avail = problem.avail.astype(np.int32).copy()  # scaled, carried per driver
        minfrag_inner = self.inner_policy == "minimal-fragmentation"

        def pack_one(app_idx: int):
            """Device zone solves + host zone choice for one app.  Returns
            (driver_idx, counts, chosen result) or None when infeasible."""
            if not candidate_zones:
                return None  # no zone has both driver and executor candidates
            solves = solve_zones(
                torch.as_tensor(avail, device=dev),
                rank_dev,
                exec_dev,
                zone_masks_dev,
                torch.as_tensor(problem.driver[app_idx], device=dev),
                torch.as_tensor(problem.executor[app_idx], device=dev),
                int(problem.count[app_idx]),
            )
            feasible = solves.feasible.cpu().numpy()
            driver_idx = solves.driver_idx.cpu().numpy()
            counts_all = solves.exec_counts.cpu().numpy()

            results, per_zone = [], []
            for zi in range(len(candidate_zones)):
                if not feasible[zi]:
                    continue
                d_idx = int(driver_idx[zi])
                if minfrag_inner:
                    # exact host bisect on the carried scaled availability
                    # (capacities are scale-invariant); placement order is
                    # the drain order, not priority order
                    decoded = min_frag_zone_decode(
                        names,
                        avail.astype(np.int64)[:n],
                        problem.executor[app_idx],
                        problem.exec_ok[:n] & zone_masks[zi][:n],
                        d_idx,
                        problem.driver[app_idx],
                        int(problem.count[app_idx]),
                        self.strict_reference_parity,
                    )
                    if decoded is None:  # unreachable: zone feasible
                        continue
                    executor_nodes, zone_counts, eff_counts = decoded
                else:
                    zone_counts = eff_counts = counts_all[zi][:n]
                    executor_nodes = counts_to_tightly_list(names, zone_counts)
                results.append(
                    PackingResult(
                        driver_node=names[d_idx],
                        executor_nodes=executor_nodes,
                        has_capacity=True,
                        packing_efficiencies=efficiencies_from_rows(
                            names,
                            cluster.sched,
                            avail.astype(np.int64) * scale[None, :],
                            _reserved_rows(n, d_idx, eff_counts, problem, app_idx) * scale[None, :],
                        ),
                    )
                )
                per_zone.append((d_idx, zone_counts))
            if not results:
                return None
            best = packers._choose_best_result(metadata, results)
            if not best.has_capacity:
                # the all-zero-efficiency quirk: single-az yields nothing;
                # the caller's az_aware fallback handles the cross-zone pack
                return None
            d_idx, counts = per_zone[results.index(best)]
            return d_idx, counts, best

        def pack_with_fallback(app_idx: int):
            packed = pack_one(app_idx)
            if packed is None and self.az_aware:
                fallback = self._plain_pack(app_idx, avail, problem, n)
                packed = None if fallback is None else (*fallback, None)
            return packed

        n_earlier = len(earlier_apps)
        # min-frag inner: the fused lane's drain uses the int32 MF_SENT
        # sentinel, so the sentinel-collision guard gates it; such
        # snapshots take the exact host lane (its decode uses a 2^62
        # sentinel no int32 capacity can reach)
        mf_fused_ok = not minfrag_inner or mf_sentinel_safe(problem.avail)
        inputs = (
            single_az_queue_inputs(cluster, problem, zone_masks, len(candidate_zones), n_earlier)
            if n_earlier > 0 and mf_fused_ok
            else None
        )

        def host_app(i: int) -> bool:
            """Earlier app i on the host lane: per-zone solves with the
            exact float64 zone choice; False when it blocks the queue."""
            packed = pack_with_fallback(i)
            if packed is None:
                return earlier_skip_allowed[i]
            self._subtract(avail, packed[0], packed[1], problem, i, n)
            return True

        if inputs is None and n_earlier > 0:
            # outside the fused lane's bounds: the whole queue on the host
            self.last_path = "host"
            for i in range(n_earlier):
                if not host_app(i):
                    return FifoOutcome(supported=True, earlier_ok=False)
        elif inputs is not None:
            arrays, scalars = inputs
            self.last_path = "fused"
            start = 0
            while start < n_earlier:
                # the fused lane over apps [start, n_earlier) from the
                # carried availability: exact up to its first uncertain
                # app, which alone goes to the host lane (the valve);
                # the fused lane resumes after it
                feas, uncertain, after = self._fused(arrays, scalars, avail, start, n_earlier, minfrag_inner)
                flagged = np.flatnonzero(uncertain)
                stop = start + int(flagged[0]) if flagged.size else n_earlier
                if flagged.size and stop > start:
                    feas, _, after = self._fused(arrays, scalars, avail, start, stop, minfrag_inner)
                for i in range(start, stop):
                    if not feas[i - start] and not earlier_skip_allowed[i]:
                        return FifoOutcome(supported=True, earlier_ok=False)
                if stop > start:
                    avail[:] = after
                if stop == n_earlier:
                    break
                self.last_path = "host"
                if not host_app(stop):
                    return FifoOutcome(supported=True, earlier_ok=False)
                start = stop + 1

        packed = pack_with_fallback(n_earlier)
        if packed is None:
            return FifoOutcome(supported=True, earlier_ok=True, result=empty_packing_result())
        d_idx, counts, chosen = packed
        if chosen is None:
            # cross-zone fallback: build the result from counts
            chosen = PackingResult(
                driver_node=names[d_idx],
                executor_nodes=counts_to_tightly_list(names, counts),
                has_capacity=True,
                packing_efficiencies=efficiencies_from_rows(
                    names,
                    cluster.sched,
                    avail.astype(np.int64) * scale[None, :],
                    _reserved_rows(n, d_idx, counts, problem, n_earlier) * scale[None, :],
                ),
            )
        return FifoOutcome(supported=True, earlier_ok=True, result=chosen)

    def _fused(self, arrays, scalars, avail, start, stop, minfrag_inner):
        """One launch of the single-AZ queue pass (its plain version on
        the CPU) over earlier apps [start, stop) from the carried scaled
        availability `avail`: (feasible, uncertain, avail_after) as
        numpy."""
        dev = self.device
        apps = tuple(x[start:stop] for x in arrays[4:8])
        with default_profiler.profile(
            "fifo_queue_single_az", lane=lane_of(dev), shape_key=(avail.shape, apps[0].shape),
        ) as rec:
            feas, _zone, _didx, uncertain, after = fifo_queue_single_az(
                *(torch.as_tensor(x, device=dev) for x in (avail,) + tuple(arrays[1:4]) + apps + tuple(arrays[8:])),
                *scalars, az_aware=self.az_aware, minfrag=minfrag_inner, strict=self.strict_reference_parity,
            )
            rec.sync(after)
        return feas.cpu().numpy(), uncertain.cpu().numpy(), after.cpu().numpy()

    def _plain_pack(self, app_idx, avail, problem, n):
        """Cross-zone tightly-pack (the az-aware fallback)."""
        dev = self.device
        solve = solve_single(
            torch.as_tensor(avail, device=dev),
            torch.as_tensor(problem.driver_rank, device=dev),
            torch.as_tensor(problem.exec_ok, device=dev),
            torch.as_tensor(problem.driver[app_idx], device=dev),
            torch.as_tensor(problem.executor[app_idx], device=dev),
            int(problem.count[app_idx]),
        )
        if not bool(solve.feasible):
            return None
        return int(solve.driver_idx), solve.exec_counts.cpu().numpy()[:n]

    @staticmethod
    def _subtract(avail, d_idx, counts, problem, app_idx, n):
        """The reference's usage-overwrite quirk in scaled int space."""
        exec_mask = counts > 0
        delta = np.zeros((avail.shape[0], 3), np.int32)
        delta[:n][exec_mask] = problem.executor[app_idx]
        if not exec_mask[d_idx]:
            delta[d_idx] = problem.driver[app_idx]
        avail -= delta


def _reserved_rows(n, d_idx, counts, problem, app_idx):
    rows = np.zeros((n, 3), np.int64)
    rows += counts.astype(np.int64)[:, None] * problem.executor[app_idx].astype(np.int64)[None, :]
    rows[d_idx] += problem.driver[app_idx].astype(np.int64)
    return rows
