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
sparkpods.go:139-146).  The whole-queue pass on the device is the hand
kernel in :mod:`.queue_kernel`; these programs serve the single-app
decode (``solve_single``) on any device and the placement-returning
queue solve.

Everything is int32, as in the JAX programs (``tensorize.scale_problem``
guarantees N·max(k) fits): ``torch.sum`` / ``torch.cumsum`` are asked
for int32 results so no value is widened where the reference's is not.
"""

from __future__ import annotations

from typing import NamedTuple, Union

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
