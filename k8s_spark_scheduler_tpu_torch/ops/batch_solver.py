"""Batch gang-packing solver in PyTorch — the port of the JAX package's
``ops/batch_solver.py`` tightly-pack / distribute-evenly programs.

The key identity making the O(driver-candidates × nodes) Go loop an
O(nodes) vector program: for the tightly-pack / distribute-evenly
policies, executor distribution over a candidate set succeeds iff the
total per-node executor capacity is ≥ k, and placing the driver on node d
only changes node d's capacity.  So

    T_d = S − cap_d + cap'_d          (S = Σ min(cap_n, k))

for every driver candidate d at once, and the chosen driver is the
first-priority d with (driver fits d) ∧ (T_d ≥ k) — bit-identical to
``SparkBinPack`` + ``tightlyPackExecutors`` / ``distributeExecutorsEvenly``
(reference lib/pkg/binpack/binpack.go:60-87, pack_tightly.go:34-63,
distribute_evenly.go:34-73).

The FIFO earlier-drivers pass (resource.go:224-262) is a loop over apps
carrying availability, reproducing the reference's usage-subtraction
quirk (one executor's worth per hosting node, driver overwritten —
sparkpods.go:139-146).  The whole-queue passes on the device are the hand
kernels (:mod:`.queue_kernel`, :mod:`.minfrag_kernel`,
:mod:`.single_az_kernel`); these programs serve the single-app decode
(``solve_single``, ``solve_zones``) on any device and the
placement-returning queue solves.  Minimal fragmentation and the
single-AZ zone choice are ported here as the JAX package writes them
(``min_frag_counts``, ``solve_queue_min_frag``,
``solve_queue_single_az``).

Everything is int32, as in the JAX programs (``tensorize.scale_problem``
guarantees N·max(k) fits): ``torch.sum`` / ``torch.cumsum`` are asked
for int32 results so no value is widened where the reference's is not.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

BIG = 2**31 - 1

IntLike = Union[int, torch.Tensor]


class AppSolve(NamedTuple):
    """Per-app gang decision."""

    feasible: torch.Tensor       # [] bool
    driver_idx: torch.Tensor     # [] int32 (index into node axis; N if infeasible)
    exec_counts: torch.Tensor    # [N] int32 tightly-pack fill counts
    exec_capacity: torch.Tensor  # [N] int32 per-node capacity after driver placement


def node_capacity(avail: torch.Tensor, executor: torch.Tensor, k: IntLike) -> torch.Tensor:
    """Per-node executor capacity clamped to [0, k]
    (capacity.go:36-75: floor division per dim, zero-requirement → ∞ —
    but a dimension whose availability is already negative is 0 even
    when the requirement is 0: reserved(0) > available short-circuits
    before the zero-requirement check, capacity.go:37-44)."""
    safe = torch.clamp(executor, min=1)
    unbounded = torch.where(avail >= 0, torch.full_like(avail, BIG), 0)
    per_dim = torch.where(
        executor[None, :] == 0,
        unbounded,
        torch.div(avail, safe[None, :], rounding_mode="floor"),
    )
    cap = per_dim.min(dim=1).values
    return torch.minimum(torch.clamp(cap, min=0), torch.as_tensor(k, dtype=cap.dtype, device=cap.device))


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """Smallest index where mask holds (N when none), int32."""
    n = mask.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=mask.device)
    return torch.where(mask, ids, n).min() if n else torch.tensor(0, dtype=torch.int32)


def solve_app(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32 — driver priority position, BIG if not a candidate
    exec_ok: torch.Tensor,      # [N] bool — in executor priority list (array order = that list)
    driver: torch.Tensor,       # [3] int32
    executor: torch.Tensor,     # [3] int32
    k: IntLike,                 # [] int32
) -> AppSolve:
    """One gang decision, O(N) vector ops."""
    n = avail.shape[0]
    k = torch.as_tensor(k, dtype=torch.int32, device=avail.device)

    # driver fit mask (Resources.GreaterThan: any-dim; fits = all dims ≤)
    driver_fits = (avail >= driver[None, :]).all(dim=1) & (driver_rank < BIG)

    # capacities without / with the driver on the node
    base_cap = torch.where(exec_ok, node_capacity(avail, executor, k), 0)
    cap_with_driver = torch.where(exec_ok, node_capacity(avail - driver[None, :], executor, k), 0)

    total = base_cap.sum(dtype=torch.int32)
    # total capacity if driver lands on d (only node d's capacity changes)
    total_d = total - base_cap + cap_with_driver

    feasible_d = driver_fits & (total_d >= k)
    # first feasible node in DRIVER priority order; ties to the lowest index
    masked_rank = torch.where(feasible_d, driver_rank, BIG)
    best_rank = masked_rank.min()
    feasible = best_rank < BIG
    driver_idx = torch.where(feasible, _first_index(masked_rank == best_rank), n)

    ids = torch.arange(n, dtype=torch.int32, device=avail.device)
    cap = torch.where(ids == driver_idx, cap_with_driver, base_cap)
    cap = torch.where(feasible, cap, 0)

    # tightly-pack greedy fill: x_n = clip(k − Σ_{m<n} cap_m, 0, cap_n)
    cum_excl = torch.cumsum(cap, 0, dtype=torch.int32) - cap
    exec_counts = torch.minimum(torch.clamp(k - cum_excl, min=0), cap)
    exec_counts = torch.where(feasible, exec_counts, 0)

    return AppSolve(
        feasible=feasible,
        driver_idx=driver_idx.to(torch.int32),
        exec_counts=exec_counts,
        exec_capacity=cap,
    )


def evenly_exec_mask(cap: torch.Tensor, k: IntLike) -> torch.Tensor:
    """Which nodes receive ≥1 executor under distribute-evenly: the first
    min(k, #nodes-with-capacity) capacity-bearing nodes in priority order
    (sweep 0 of the round-robin)."""
    has = (cap > 0).to(torch.int32)
    rank_excl = torch.cumsum(has, 0, dtype=torch.int32) - has
    return (cap > 0) & (rank_excl < k)


def usage_delta(
    solve: AppSolve,
    driver: torch.Tensor,
    executor: torch.Tensor,
    evenly: bool,
) -> torch.Tensor:
    """The reference's post-placement subtraction QUIRK
    (sparkpods.go:139-146 + resources.go:129-135): nodes hosting ≥1
    executor lose ONE executor's worth; the driver node loses the driver —
    unless it also hosts executors, in which case the executor entry
    overwrites the driver's."""
    n = solve.exec_counts.shape[0]
    if evenly:
        exec_mask = evenly_exec_mask(solve.exec_capacity, solve.exec_counts.sum(dtype=torch.int32))
        exec_mask = exec_mask & solve.feasible
    else:
        exec_mask = solve.exec_counts > 0
    is_driver = torch.arange(n, dtype=torch.int32, device=driver.device) == solve.driver_idx
    delta = torch.where(
        exec_mask[:, None],
        executor[None, :],
        torch.where(is_driver[:, None], driver[None, :], 0),
    )
    return torch.where(solve.feasible, delta, 0)


class QueueSolve(NamedTuple):
    feasible: torch.Tensor       # [A] bool
    driver_idx: torch.Tensor     # [A] int32
    exec_counts: torch.Tensor    # [A, N] int32 (tightly-pack counts); [0] without placements
    exec_capacity: torch.Tensor  # [A, N] int32; [0] without placements
    avail_after: torch.Tensor    # [N, 3] int32


def solve_queue(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32
    exec_ok: torch.Tensor,      # [N] bool
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    evenly: bool = False,
    with_placements: bool = True,
) -> QueueSolve:
    """Whole-FIFO-queue gang solve: apps in order, carrying availability.
    Infeasible apps are skipped (no subtraction), exactly like a queue of
    Filter calls draining one by one.

    with_placements=False returns only the per-app decisions (feasible,
    driver_idx) and the final availability; any single app's placement
    is recomputable with solve_single.
    """
    n = avail.shape[0]
    carry = avail
    feas, didx, placed, caps = [], [], [], []
    for a in range(drivers.shape[0]):
        driver, executor = drivers[a], executors[a]
        solve = solve_app(carry, driver_rank, exec_ok, driver, executor, counts[a])
        feasible = solve.feasible & app_valid[a]
        solve = AppSolve(
            feasible=feasible,
            driver_idx=torch.where(feasible, solve.driver_idx, n).to(torch.int32),
            exec_counts=torch.where(feasible, solve.exec_counts, 0),
            exec_capacity=solve.exec_capacity,
        )
        carry = carry - usage_delta(solve, driver, executor, evenly)
        feas.append(feasible)
        didx.append(solve.driver_idx)
        if with_placements:
            placed.append(solve.exec_counts)
            caps.append(solve.exec_capacity)

    def stack(xs, empty_shape, dtype):
        return torch.stack(xs) if xs else torch.zeros(empty_shape, dtype=dtype, device=avail.device)

    empty = torch.zeros((0,), dtype=torch.int32, device=avail.device)
    return QueueSolve(
        feasible=stack(feas, (0,), torch.bool),
        driver_idx=stack(didx, (0,), torch.int32),
        exec_counts=stack(placed, (0, n), torch.int32) if with_placements else empty,
        exec_capacity=stack(caps, (0, n), torch.int32) if with_placements else empty,
        avail_after=carry,
    )


def solve_single(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    driver: torch.Tensor,
    executor: torch.Tensor,
    k: IntLike,
) -> AppSolve:
    """Single-app entry point for the Filter hot path (the current
    driver's decode after the queue pass)."""
    return solve_app(avail, driver_rank, exec_ok, driver, executor, k)


# Unbounded-capacity stand-in for the min-frag drain (host uses 2^63-1,
# capacity.go:45-48).  Capacities here must stay UNCLAMPED for the
# (k+max)/2 subset threshold, so the sentinel lives just above any real
# capacity: callers guard max(avail) ≤ 2^31-3 (mf_sentinel_safe) so a real
# capacity can never collide with it.
MF_SENT = 2**31 - 2


def min_frag_capacity(avail: torch.Tensor, executor: torch.Tensor, exec_ok: torch.Tensor) -> torch.Tensor:
    """UNCLAMPED per-node executor capacity (capacity.go:36-75) for the
    minimal-fragmentation drain; MF_SENT marks unbounded nodes."""
    safe = torch.clamp(executor, min=1)
    per_dim = torch.where(
        executor[None, :] == 0,
        torch.where(avail >= 0, torch.full_like(avail, MF_SENT), 0),
        torch.div(avail, safe[None, :], rounding_mode="floor"),
    )
    cap = per_dim.min(dim=1).values
    return torch.where(exec_ok, torch.clamp(cap, 0, MF_SENT), 0)


def min_frag_counts(cap: torch.Tensor, k: IntLike) -> torch.Tensor:
    """Minimal-fragmentation per-node executor counts from unclamped
    capacities — the whole of minimal_fragmentation.go:59-137 as sort-free
    vector ops.

    The drain loop linearizes over capacity *value classes*: with
    T(v) = Σ_{cap ≥ v} cap, a class v is fully drained iff T(v) < k, so the
    stop class v* = max{v : T(v) ≥ k} (binary-searched in 31 probes).
    Entering v* with R = k − Σ_{cap > v*} cap remaining, t* = ⌈R/v*⌉ − 1 of
    its nodes (earliest in priority order) drain fully and the final
    k* = R − t*·v* executors go to the smallest remaining capacity ≥ k*
    (earliest priority among equals) — exactly the host's ascending bisect.
    Probe sums clamp per-term to k so everything stays int32.  The (k+max)/2
    "avoid mostly-empty nodes" subset attempt (minimal_fragmentation.go:
    71-87) is the same computation under a tighter eligibility mask.  Only
    valid when Σ min(cap, k) ≥ k; returns zeros otherwise and for k = 0."""
    n = cap.shape[0]
    k = torch.as_tensor(k, dtype=torch.int32, device=cap.device)
    elig = cap > 0
    d = torch.where(elig, cap, 0)
    iota = torch.arange(n, dtype=torch.int32, device=cap.device)

    def run(sub):
        """One _internal_minimal_fragmentation pass over the eligibility
        mask `sub`.  Returns (ok, counts-by-node)."""
        dd = torch.where(sub, d, 0)
        dc = torch.minimum(dd, k)  # probe terms, int32-safe to sum
        ok = (dc.sum(dtype=torch.int32) >= k) & (k > 0)
        lo = torch.tensor(1, dtype=torch.int32, device=cap.device)
        hi = torch.tensor(MF_SENT, dtype=torch.int32, device=cap.device)
        for _ in range(31):
            mid = lo + torch.div(hi - lo + 1, 2, rounding_mode="floor")
            good = torch.where(dd >= mid, dc, 0).sum(dtype=torch.int32) >= k
            lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid - 1)
        vstar = lo
        s = torch.where(dd > vstar, dd, 0).sum(dtype=torch.int32)  # drained classes, < k
        r = k - s
        tstar = torch.div(torch.clamp(r - 1, min=0), vstar, rounding_mode="floor")
        kstar = r - tstar * vstar
        at = sub & (dd == vstar)
        at_i = at.to(torch.int32)
        at_rank = torch.cumsum(at_i, 0, dtype=torch.int32) - at_i  # class position in priority order
        drained = (sub & (dd > vstar)) | (at & (at_rank < tstar))
        # final placement: smallest capacity ≥ k* among the not-drained,
        # ties to the earliest priority index (the ascending bisect)
        cand = sub & ~drained & (dd >= kstar)
        vp = torch.where(cand, dd, BIG).min() if n else torch.tensor(BIG, dtype=torch.int32)
        partial = _first_index(cand & (dd == vp))
        partial = torch.where(partial == n, 0, partial)  # argmax of all-false is 0
        counts = torch.where(drained, dd, 0)
        counts = counts + torch.where((iota == partial) & ok, kstar, 0)
        return ok, torch.where(ok, counts, 0)

    max_cap = d.max() if n else torch.tensor(0, dtype=torch.int32, device=cap.device)
    has_sent = (elig & (d == MF_SENT)).any()
    # exact (k + max)//2 without int32 overflow; with an unbounded node the
    # host threshold (k + 2^63-1)//2 admits every bounded capacity
    half = lambda v: torch.div(v, 2, rounding_mode="floor")
    target = half(k) + half(max_cap) + half((k & 1) + (max_cap & 1))
    subset = elig & torch.where(has_sent, d < MF_SENT, d < target)
    attempt = has_sent | (k < max_cap)
    sub_ok, sub_counts = run(subset & attempt)
    full_ok, full_counts = run(elig)
    counts = torch.where(attempt & sub_ok, sub_counts, full_counts)
    return torch.where(full_ok, counts, 0)


def min_frag_step_counts(carry_avail, feasible, driver_idx, driver, executor, exec_ok, k):
    """Shared per-step min-frag placement: subtract the driver on its
    chosen node, run the capacity + drain programs over the eligible mask,
    zero when infeasible.  Used by the min-frag queue solve and the
    single-AZ queue solve's per-zone solves."""
    n = carry_avail.shape[0]
    is_drv = (torch.arange(n, dtype=torch.int32, device=carry_avail.device) == driver_idx) & feasible
    avail_eff = carry_avail - torch.where(is_drv[:, None], driver[None, :], 0)
    mf = min_frag_counts(min_frag_capacity(avail_eff, executor, exec_ok), k)
    return torch.where(feasible, mf, 0)


def mf_sentinel_safe(avail) -> bool:
    """Host-side guard of the min-frag lanes: every scaled availability
    value must stay below MF_SENT − 1 so a real capacity can never collide
    with the unbounded-capacity sentinel."""
    a = np.asarray(avail)
    return a.size == 0 or int(a.max()) <= MF_SENT - 1


# queue-scan assignment policies every whole-queue lane implements, with the
# integer codes the JAX package's native session uses; single-AZ policies
# are a separate solver family
QUEUE_POLICY_CODES = {
    "tightly-pack": 0,
    "distribute-evenly": 1,
    "minimal-fragmentation": 2,
}


def queue_policy_code(assignment_policy: str):
    """The policy code of a TpuFifoSolver assignment policy, or None when
    no whole-queue lane serves it."""
    return QUEUE_POLICY_CODES.get(assignment_policy)


def solve_queue_min_frag(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32
    exec_ok: torch.Tensor,      # [N] bool
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    with_placements: bool = True,
) -> QueueSolve:
    """Whole-FIFO-queue solve under the minimal-fragmentation policy
    (minimal_fragmentation.go:59-137 × resource.go:224-262).  Feasibility
    and driver choice equal tightly-pack's (the drain is work-conserving);
    only the placement — and so the carried usage subtraction — needs the
    min-frag drain.  exec_counts holds the drain's counts; exec_capacity is
    empty."""
    n = avail.shape[0]
    carry = avail
    feas, didx, placed = [], [], []
    for a in range(drivers.shape[0]):
        driver, executor, k = drivers[a], executors[a], counts[a]
        solve = solve_app(carry, driver_rank, exec_ok, driver, executor, k)
        feasible = solve.feasible & app_valid[a]
        d_idx = torch.where(feasible, solve.driver_idx, n).to(torch.int32)
        mf = min_frag_step_counts(carry, feasible, d_idx, driver, executor, exec_ok, k)
        mf_solve = AppSolve(feasible=feasible, driver_idx=d_idx, exec_counts=mf, exec_capacity=mf)
        carry = carry - usage_delta(mf_solve, driver, executor, evenly=False)
        feas.append(feasible)
        didx.append(d_idx)
        if with_placements:
            placed.append(mf)

    def stack(xs, empty_shape, dtype):
        return torch.stack(xs) if xs else torch.zeros(empty_shape, dtype=dtype, device=avail.device)

    empty = torch.zeros((0,), dtype=torch.int32, device=avail.device)
    return QueueSolve(
        feasible=stack(feas, (0,), torch.bool),
        driver_idx=stack(didx, (0,), torch.int32),
        exec_counts=stack(placed, (0, n), torch.int32) if with_placements else empty,
        exec_capacity=empty,
        avail_after=carry,
    )


class ZoneQueueSolve(NamedTuple):
    """Per-app outcome of the single-AZ FIFO queue solve."""

    feasible: torch.Tensor     # [A] bool
    zone_idx: torch.Tensor     # [A] int32 — chosen zone; Z = cross-zone fallback, -1 = none
    driver_idx: torch.Tensor   # [A] int32
    uncertain: torch.Tensor    # [A] bool — zone choice within the fixed-point margin
    avail_after: torch.Tensor  # [N, 3] int32


# Fixed-point bits of the device zone-efficiency score.  The zone choice
# (single_az.go:75-97: highest average of per-occurrence max packing
# efficiency, strict improvement in zone order) is computed as
# Q_z = Σ_n w_n · round(2^EFF_SHIFT · maxEff_n) with integer weights
# w_n = executor count + driver indicator.  Every feasible zone places k
# executors + 1 driver, so comparing averages equals comparing these sums.
# Per-term quantization error is < 0.6 fixed-point ulps, so
# |Q_a − Q_b| > 2(k+1)+2 certifies that the float64 oracle orders the true
# sums the same way; equal Q keeps the earlier zone (identical to Go for
# mathematically equal scores), and distinct-but-closer scores raise
# `uncertain` and the caller re-solves on the exact host lane.
EFF_SHIFT = 18


def _zone_score(
    carry_avail: torch.Tensor,  # [N, 3] int32 scaled
    solve: AppSolve,
    driver: torch.Tensor,
    executor: torch.Tensor,
    s_cpu_milli: torch.Tensor,  # [N] int32 schedulable cpu, base milli units
    s_gpu_milli: torch.Tensor,  # [N] int32
    inv_mem: torch.Tensor,      # [N] float32 = scale_mem / schedulable_mem_bytes
    th_mem: torch.Tensor,       # [N] int32 = ceil(sched_mem_bytes / scale_mem)
    scale_cpu: IntLike,
    scale_gpu: IntLike,
    eff_counts: torch.Tensor = None,  # [N] int32 reservation-side counts when
    # they differ from the occurrence weights (min-frag strict parity: the
    # no-write-back quirk makes efficiencies see only the driver)
):
    """(Q, nonzero): the fixed-point zone score for one zone's packing and
    the exact S > 0 indicator (efficiency.go:80-156 semantics: value() ceil
    to cores for cpu/gpu, bytes for memory; gpu efficiency 0 on gpu-less
    nodes; per-node max over dims; occurrence-weighted sum)."""
    n = carry_avail.shape[0]
    is_driver = (torch.arange(n, dtype=torch.int32, device=carry_avail.device) == solve.driver_idx) & solve.feasible
    counts = solve.exec_counts
    w = counts + is_driver.to(torch.int32)
    res_counts = counts if eff_counts is None else eff_counts
    new = res_counts[:, None] * executor[None, :] + torch.where(is_driver[:, None], driver[None, :], 0)
    m = carry_avail - new  # scaled availability net of this packing; ≥ 0 where w > 0

    def ceil_thousands(v):
        return torch.div(v + 999, 1000, rounding_mode="trunc")

    num_cq = s_cpu_milli - m[:, 0] * scale_cpu
    num_gq = s_gpu_milli - m[:, 2] * scale_gpu
    den_cores = torch.clamp(ceil_thousands(s_cpu_milli), min=1)
    den_gcores = torch.clamp(ceil_thousands(s_gpu_milli), min=1)
    has_gpu = s_gpu_milli > 0

    ratio_c = ceil_thousands(num_cq).to(torch.float32) / den_cores.to(torch.float32)
    ratio_g = torch.where(
        has_gpu, ceil_thousands(num_gq).to(torch.float32) / den_gcores.to(torch.float32), 0.0
    )
    ratio_m = torch.clamp(1.0 - m[:, 1].to(torch.float32) * inv_mem, min=0.0)
    eff = torch.maximum(torch.maximum(ratio_c, ratio_m), ratio_g)
    q = torch.floor(eff * float(2**EFF_SHIFT) + 0.5).to(torch.int32)
    score = torch.where(w > 0, w * q, 0).sum(dtype=torch.int32)
    # exact S > 0: some occupied node has a strictly positive reserved
    # quantity in a dimension that counts (the all-zero-efficiency quirk)
    nonzero = ((w > 0) & ((num_cq > 0) | (m[:, 1] < th_mem) | (has_gpu & (num_gq > 0)))).any()
    return score, nonzero


def solve_queue_single_az(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32
    exec_ok: torch.Tensor,      # [N] bool
    zone_masks: torch.Tensor,   # [Z, N] bool
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    s_cpu_milli: torch.Tensor,  # [N] int32
    s_gpu_milli: torch.Tensor,  # [N] int32
    inv_mem: torch.Tensor,      # [N] float32
    th_mem: torch.Tensor,       # [N] int32
    scale_cpu: IntLike,
    scale_gpu: IntLike,
    az_aware: bool = False,
    minfrag: bool = False,
    strict: bool = True,
) -> ZoneQueueSolve:
    """Whole-FIFO-queue single-AZ gang solve (single_az.go:23-97 ×
    resource.go:224-262): apps in order; each step solves every zone
    (tightly-pack, or the min-frag drain when minfrag=True, with
    driver-only efficiency numerators under strict parity), scores
    feasible zones with the fixed-point comparator (EFF_SHIFT), applies the
    strict-improvement choice in zone order, optionally falls back to a
    cross-zone pack (az_aware_pack_tightly.go:27-38; no min-frag variant),
    and carries availability with the reference's subtraction quirk."""
    assert not (az_aware and minfrag)
    n = avail.shape[0]
    dev = avail.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    carry = avail
    outs = []
    for a in range(drivers.shape[0]):
        driver, executor, k, valid = drivers[a], executors[a], counts[a], app_valid[a]
        band = 2 * (k + 1) + 2
        best_q = torch.tensor(0, dtype=torch.int32, device=dev)
        best_zone = torch.tensor(-1, dtype=torch.int32, device=dev)
        uncertain = torch.tensor(False, device=dev)
        chosen_counts = torch.zeros(n, dtype=torch.int32, device=dev)
        chosen_didx = torch.tensor(n, dtype=torch.int32, device=dev)

        for z, mask in enumerate(zone_masks):
            solve = solve_app(carry, torch.where(mask, driver_rank, BIG), exec_ok & mask, driver, executor, k)
            eff_counts = None
            if minfrag:
                mf = min_frag_step_counts(
                    carry, solve.feasible, solve.driver_idx, driver, executor, exec_ok & mask, k
                )
                solve = solve._replace(exec_counts=mf)
                eff_counts = torch.zeros_like(mf) if strict else mf
            score, nz = _zone_score(
                carry, solve, driver, executor, s_cpu_milli, s_gpu_milli, inv_mem, th_mem,
                scale_cpu, scale_gpu, eff_counts=eff_counts,
            )
            f = solve.feasible
            first = best_zone < 0
            better = f & torch.where(first, nz, score > best_q)
            uncertain = uncertain | (f & ~first & (score != best_q) & (torch.abs(score - best_q) <= band))
            best_q = torch.where(better, score, best_q)
            best_zone = torch.where(better, z, best_zone)
            chosen_counts = torch.where(better, solve.exec_counts, chosen_counts)
            chosen_didx = torch.where(better, solve.driver_idx, chosen_didx)

        if az_aware:
            cross = solve_app(carry, driver_rank, exec_ok, driver, executor, k)
            use_cross = (best_zone < 0) & cross.feasible
            best_zone = torch.where(use_cross, zone_masks.shape[0], best_zone)
            chosen_counts = torch.where(use_cross, cross.exec_counts, chosen_counts)
            chosen_didx = torch.where(use_cross, cross.driver_idx, chosen_didx)

        placed = (best_zone >= 0) & valid
        chosen_counts = torch.where(placed, chosen_counts, 0)
        chosen_didx = torch.where(placed, chosen_didx, n).to(torch.int32)
        # the reference's usage-subtraction quirk: one executor's worth on
        # hosting nodes, executor entry overwriting the driver's
        exec_mask = chosen_counts > 0
        is_driver = ids == chosen_didx
        delta = torch.where(
            exec_mask[:, None], executor[None, :], torch.where(is_driver[:, None], driver[None, :], 0)
        )
        carry = carry - torch.where(placed, delta, 0)
        outs.append((placed, torch.where(placed, best_zone, -1).to(torch.int32), chosen_didx, uncertain))

    if not outs:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return ZoneQueueSolve(empty.to(torch.bool), empty, empty, empty.to(torch.bool), carry)
    placed, zone_idx, didx, uncertain = (torch.stack(x) for x in zip(*outs))
    return ZoneQueueSolve(feasible=placed, zone_idx=zone_idx, driver_idx=didx, uncertain=uncertain, avail_after=carry)


def solve_zones(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32
    exec_ok: torch.Tensor,      # [N] bool
    zone_masks: torch.Tensor,   # [Z, N] bool — node membership per zone
    driver: torch.Tensor,       # [3] int32
    executor: torch.Tensor,     # [3] int32
    k: IntLike,
) -> AppSolve:
    """Per-zone gang solves in one shot (the single-AZ combinator's inner
    loop, single_az.go:23-55): restrict driver candidates and executor
    capacity to each zone and solve every zone.  Fields gain a leading
    zone axis.  Zone selection (best avg packing efficiency) happens on the
    host with the oracle's float64 math for exact parity."""
    solves = [
        solve_app(avail, torch.where(mask, driver_rank, BIG), exec_ok & mask, driver, executor, k)
        for mask in zone_masks
    ]
    return AppSolve(*(torch.stack(field) for field in zip(*solves)))
