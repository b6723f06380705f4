"""Snapshot → tensor marshalling for the batch solver.

Cluster state (node availability in priority order) and pending-app
demand become dense integer arrays.  Exactness contract: every quantity
is converted to integer base units (milli-CPU, memory bytes, milli-GPU)
and then divided by the per-dimension GCD across the whole problem so
values fit int32.  Any value that is not exactly representable flags the
snapshot inexact and the caller uses the host oracle — the solver never
trades exactness for speed.

Everything here is numpy on the host; the solver moves the scaled arrays
to its device.  Padding: node and app axes are padded to bucket sizes so
the solver sees a small number of shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types.resources import NodeGroupSchedulingMetadata, Resources
from ..utils.quantity import Quantity

DIMS = 3  # cpu, memory, gpu

# k (executor count) must satisfy N_bucket * k < 2^31 so int32 capacity
# sums cannot overflow (see batch_solver).
INT32_SAFE = 2**31 - 1

_INT64_MAX = 2**63 - 1


def _to_base_units(q: Quantity, dim: int) -> Tuple[int, bool]:
    """cpu/gpu → milli units; memory → bytes.  Returns (value, exact);
    values beyond int64 are clamped and flagged inexact."""
    if dim == 1:
        v = q.exact
        value, exact = math.ceil(v), v.denominator == 1
    else:
        value, exact = q.milli_value_exact()
    if value > _INT64_MAX:
        return _INT64_MAX, False
    if value < -_INT64_MAX:
        return -_INT64_MAX, False
    return value, exact


def _resources_to_base(r: Resources) -> Tuple[List[int], bool]:
    out = []
    exact = True
    for dim, q in enumerate((r.cpu, r.memory, r.nvidia_gpu)):
        v, e = _to_base_units(q, dim)
        out.append(v)
        exact = exact and e
    return out, exact


def _app_base_rows(app) -> Tuple[List[int], List[int], bool]:
    """(driver_row, executor_row, exact) for one AppDemand, stashed on the
    instance: the FIFO pass re-tensorizes the same queue of apps on every
    Filter request, so the exact base-unit conversion runs once per app."""
    rows = getattr(app, "_base_rows", None)
    if rows is None:
        drow, e1 = _resources_to_base(app.driver_resources)
        erow, e2 = _resources_to_base(app.executor_resources)
        rows = (drow, erow, e1 and e2)
        try:
            app._base_rows = rows
        except AttributeError:  # frozen/slots instances: just recompute
            pass
    return rows


NODE_BUCKETS = (64, 256, 1024, 4096)
APP_BUCKETS = (16, 64, 256, 1024, 4096)


def bucket_size(n: int, buckets: Sequence[int] = NODE_BUCKETS) -> int:
    """Pad to a bounded set of shapes: fixed small buckets, then
    multiples of 1024."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


@dataclass
class ClusterTensor:
    """Node-side arrays.  Row order = executor priority order, followed by
    driver-only candidate nodes; driver ordering is carried as a per-node
    rank so the two priority lists may disagree (label-priority re-sorts
    can reorder them independently, nodesorting.go:59-62)."""

    node_names: List[str]
    avail: np.ndarray        # [N, 3] int64 base units (pre-scaling)
    sched: np.ndarray        # [N, 3] int64 (schedulable totals, for efficiency)
    driver_rank: np.ndarray  # [N] int32 — position in driver priority list, INT32_SAFE if not a candidate
    exec_ok: np.ndarray      # [N] bool — in executor priority list
    zone_id: np.ndarray      # [N] int32
    zone_names: List[str]
    valid: np.ndarray        # [N] bool — padding mask
    exact: bool

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)


@dataclass
class AppTensor:
    """App-side arrays in FIFO order."""

    driver: np.ndarray    # [A, 3] int64 base units
    executor: np.ndarray  # [A, 3] int64
    count: np.ndarray     # [A] int64 (min executor count = gang size)
    valid: np.ndarray     # [A] bool
    exact: bool

    @property
    def n_apps(self) -> int:
        return int(self.valid.sum())


@dataclass
class ScaledProblem:
    """The int32-scaled problem handed to the device."""

    avail: np.ndarray        # [Nb, 3] int32
    driver_rank: np.ndarray  # [Nb] int32
    exec_ok: np.ndarray      # [Nb] bool
    driver: np.ndarray       # [Ab, 3] int32
    executor: np.ndarray     # [Ab, 3] int32
    count: np.ndarray        # [Ab] int32
    app_valid: np.ndarray    # [Ab] bool
    scale: np.ndarray        # [3] int64 per-dimension divisor
    ok: bool                 # False → caller must use the host oracle


def tensorize_cluster(
    metadata: NodeGroupSchedulingMetadata,
    driver_order: Sequence[str],
    executor_order: Sequence[str],
) -> ClusterTensor:
    """Marshal a snapshot from the two priority-ordered candidate lists
    (nodes missing from metadata are dropped, as in SparkBinPack's
    metadata lookups)."""
    exec_names = [n for n in executor_order if n in metadata]
    exec_set = set(exec_names)
    driver_names = [n for n in driver_order if n in metadata]
    names = exec_names + [n for n in driver_names if n not in exec_set]
    n = len(names)
    driver_rank_map = {name: i for i, name in enumerate(driver_names)}

    avail = np.zeros((n, DIMS), dtype=np.int64)
    sched = np.zeros((n, DIMS), dtype=np.int64)
    exact = True
    zone_names: List[str] = []
    zone_index: Dict[str, int] = {}
    zone_id = np.zeros(n, dtype=np.int32)
    for i, name in enumerate(names):
        md = metadata[name]
        row, e1 = _resources_to_base(md.available)
        # schedulable totals feed efficiency metrics only, never
        # decisions — clamping them must not force an oracle fallback
        srow, _ = _resources_to_base(md.schedulable)
        exact = exact and e1
        avail[i] = row
        sched[i] = srow
        z = md.zone_label
        if z not in zone_index:
            zone_index[z] = len(zone_names)
            zone_names.append(z)
        zone_id[i] = zone_index[z]
    return ClusterTensor(
        node_names=names,
        avail=avail,
        sched=sched,
        driver_rank=np.array(
            [driver_rank_map.get(name, INT32_SAFE) for name in names], dtype=np.int32
        ),
        exec_ok=np.array([name in exec_set for name in names], dtype=bool),
        zone_id=zone_id,
        zone_names=zone_names,
        valid=np.ones(n, dtype=bool),
        exact=exact,
    )


def tensorize_apps(apps: Sequence) -> AppTensor:
    """apps: sequence of AppDemand (FIFO order)."""
    a = len(apps)
    driver = np.zeros((a, DIMS), dtype=np.int64)
    executor = np.zeros((a, DIMS), dtype=np.int64)
    count = np.zeros(a, dtype=np.int64)
    exact = True
    for i, app in enumerate(apps):
        drow, erow, e = _app_base_rows(app)
        exact = exact and e
        driver[i] = drow
        executor[i] = erow
        count[i] = app.min_executor_count
    return AppTensor(
        driver=driver,
        executor=executor,
        count=count,
        valid=np.ones(a, dtype=bool),
        exact=exact,
    )


def scale_rows_int32(avail: np.ndarray, demand_rows: np.ndarray, node_bucket: int):
    """Per-dimension GCD scaling to int32: (ok, avail [node_bucket, 3],
    demands [D, 3], scale [3]).  ok is False when the bucket is smaller
    than the node count or a scaled value does not fit int32."""
    n = avail.shape[0]
    out_avail = np.zeros((max(node_bucket, 0), DIMS), dtype=np.int32)
    out_demands = np.zeros((demand_rows.shape[0], DIMS), dtype=np.int32)
    scale = np.ones(DIMS, dtype=np.int64)
    if node_bucket < n:
        return False, out_avail, out_demands, scale
    for d in range(DIMS):
        values = np.concatenate([avail[:, d], demand_rows[:, d]])
        g = int(np.gcd.reduce(np.abs(values))) if len(values) else 1
        g = max(g, 1)
        scale[d] = g
        sa = avail[:, d] // g
        sd = demand_rows[:, d] // g
        if (np.abs(sa) > INT32_SAFE).any() or (len(sd) and (np.abs(sd) > INT32_SAFE).any()):
            return False, out_avail, out_demands, scale
        out_avail[:n, d] = sa
        out_demands[:, d] = sd
    return True, out_avail, out_demands, scale


def scale_problem(
    cluster: ClusterTensor,
    apps: AppTensor,
    node_bucket: Optional[int] = None,
    app_bucket: Optional[int] = None,
) -> ScaledProblem:
    """GCD-scale each dimension to int32 and pad to bucket shapes."""
    n, a = cluster.avail.shape[0], apps.driver.shape[0]
    nb = node_bucket or bucket_size(n)
    ab = app_bucket or bucket_size(a, buckets=APP_BUCKETS)

    ok = cluster.exact and apps.exact
    scale = np.ones(DIMS, dtype=np.int64)
    avail_s = np.zeros((nb, DIMS), dtype=np.int32)
    driver_s = np.zeros((ab, DIMS), dtype=np.int32)
    executor_s = np.zeros((ab, DIMS), dtype=np.int32)

    if ok:
        demand_rows = np.concatenate([apps.driver, apps.executor], axis=0)
        scaled_ok, scaled_avail, scaled_demands, scale = scale_rows_int32(
            np.ascontiguousarray(cluster.avail, dtype=np.int64),
            np.ascontiguousarray(demand_rows, dtype=np.int64),
            nb,
        )
        if scaled_ok:
            avail_s = scaled_avail
            driver_s[:a] = scaled_demands[:a]
            executor_s[:a] = scaled_demands[a : 2 * a]
        else:
            ok = False

    # int32 sum-overflow guard: capacities are clamped to k in the solver,
    # so sums are bounded by Nb * max(k); require it fits int32
    max_k = int(apps.count.max()) if a else 0
    if max_k > 0 and nb * max_k > INT32_SAFE:
        ok = False
    if max_k > INT32_SAFE:
        ok = False

    driver_rank = np.full(nb, INT32_SAFE, dtype=np.int32)
    exec_ok = np.zeros(nb, dtype=bool)
    app_valid = np.zeros(ab, dtype=bool)
    count = np.zeros(ab, dtype=np.int32)
    driver_rank[:n] = cluster.driver_rank
    exec_ok[:n] = cluster.exec_ok
    app_valid[:a] = apps.valid
    count[:a] = np.minimum(apps.count, INT32_SAFE).astype(np.int32)

    return ScaledProblem(
        avail=avail_s,
        driver_rank=driver_rank,
        exec_ok=exec_ok,
        driver=driver_s,
        executor=executor_s,
        count=count,
        app_valid=app_valid,
        scale=scale,
        ok=ok,
    )
