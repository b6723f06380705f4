"""The refusal explainer's queue walk: why a gang does not fit at its
queue position, and which earlier drivers took what it needed.

Computes the reference's native ``fifo_explain_queue``
(``native/fifo_solver.cpp``, reached through
``native.fifo.explain_queue_native``) exactly: the 12 info fields and
the blocker set, under policy codes 0 (tightly-pack), 1
(distribute-evenly) and 2 (minimal-fragmentation).  The reference walks
the queue one app at a time on the host and probes the target after
every step; this formulation takes one launch of the queue kernel
instead.

- *The flip.*  Steps only subtract, so the target's feasibility can only
  fall along the queue.  The launch runs the queue with the target
  interleaved as a probe before every app and after the last
  (``[T, q0, T, q1, ..., q(t-1), T]``; a probe gets its verdict and
  subtracts nothing), so its verdicts f[p] say whether the target fits
  after the first p steps.  flip = -2 when f[0] is false (the basis
  alone is short), else the last step before the first false f[p], or
  -1 when every f[p] holds.
- *The walk-back.*  The same launch's usage output gives, for every step,
  how many nodes got executors and whether the driver's own row was
  subtracted, so what each earlier gang took of a dimension is
  ``hosts * executor + driver_row * driver``.  The blocker set is the
  feasible steps from the flip backwards until their sum covers the
  shortfall, as the reference walks them.
- *The decomposition* (capacity total, per-dimension totals, the best
  single node, the driver candidates that fit) is a few PyTorch
  reductions over the planes the launch leaves, which are the planes at
  the target's position.

One launch and one copy to the host, on the device of the caller's
choice: the CUDA kernels (``queue_kernel.fifo_queue_explain``,
``minfrag_kernel.fifo_queue_min_frag_explain``) on a CUDA device, their
plain PyTorch versions on the CPU.  No per-step walk runs on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .minfrag_kernel import fifo_queue_min_frag_explain
from .queue_kernel import BIG, fifo_queue_explain


class ExplainResult:
    """Decoded explainer output, field for field the reference's
    ``native.fifo.ExplainResult``.

    ``flip`` is the queue position whose step turned the target
    infeasible (-1 = feasible at its own position, -2 = infeasible even
    against the empty basis); ``blockers`` is the per-position blocker
    mask; the rest decompose the target-position probe."""

    __slots__ = (
        "flip", "feasible", "cap_total", "dim_totals", "max_cap",
        "max_node", "driver_fit", "tightest_dim", "shortfall_execs",
        "blockers",
    )

    def __init__(self, info: np.ndarray, blockers: np.ndarray):
        self.flip = int(info[0])
        self.feasible = bool(info[1])
        self.cap_total = int(info[2])
        self.dim_totals = (int(info[3]), int(info[4]), int(info[5]))
        self.max_cap = int(info[6])
        self.max_node = int(info[7])
        self.driver_fit = int(info[8])
        self.tightest_dim = int(info[9])
        self.shortfall_execs = int(info[10])
        self.blockers = blockers

    @property
    def blocker_count(self) -> int:
        return int(self.blockers.sum())


def _probe_totals(planes: torch.Tensor, rank: torch.Tensor, eok: torch.Tensor, row) -> torch.Tensor:
    """The decomposition of one probe of the app `row` (8 host ints)
    against `planes` [N, 3] int32: int64 [cap_total, dim_total x 3,
    max_cap, max_node, driver_fit].  Clamped capacities as the queue
    pass computes them (floor division, a zero request bounds nothing
    unless the availability is negative, clipped to [0, k]); a
    dimension's total counts it as the only constraint."""
    d, e, k = row[0:3], row[3:6], int(row[6])
    a = planes.to(torch.int64)
    cap = torch.full((planes.shape[0],), k, dtype=torch.int64, device=planes.device)
    dim_totals = []
    for j in range(3):
        col = a[:, j]
        if e[j] == 0:
            cap = torch.where(col >= 0, cap, -1)
            dim_totals.append(torch.where(eok & (col >= 0), k, 0).sum())
        else:
            q = torch.div(col, max(int(e[j]), 1), rounding_mode="floor")
            cap = torch.minimum(cap, q)
            dim_totals.append(torch.where(eok & (col > 0), torch.clamp(q, max=k), 0).sum())
    cap = torch.where(eok, torch.clamp(cap, min=0), 0)
    max_cap = torch.clamp(cap.max(), min=0) if cap.numel() else cap.new_zeros(())
    # the first node holding the largest positive capacity, -1 for none
    first_max = torch.argmax((cap == max_cap).to(torch.int8)) if cap.numel() else cap.new_zeros(())
    max_node = torch.where(max_cap > 0, first_max, -1)
    fits = (rank < BIG) & (planes[:, 0] >= d[0]) & (planes[:, 1] >= d[1]) & (planes[:, 2] >= d[2])
    return torch.stack([cap.sum(), *dim_totals, max_cap, max_node, fits.sum()]).to(torch.int64)


def explain_queue(
    avail: np.ndarray,        # [N, 3] int32 basis (queue position 0)
    driver_rank: np.ndarray,  # [N] int32
    exec_ok: np.ndarray,      # [N] bool
    apps_packed: np.ndarray,  # [A, 8] int32: d0..2 e0..2 count valid
    policy: int,
    target: int,
    device: DeviceLike = None,
) -> Optional[ExplainResult]:
    """Shortfall vector + blocker set for the app at queue position
    ``target``, equal to the reference's ``explain_queue_native``; None
    when the inputs are degenerate.  Runs on ``device`` (None = CUDA).
    Diagnostic only — never a decision input."""
    device = resolve_device(device)
    apps = np.ascontiguousarray(apps_packed, dtype=np.int32)
    nb, na = avail.shape[0], apps.shape[0]
    if nb <= 0 or na <= 0 or not (0 <= target < na):
        return None
    row = [int(v) for v in apps[target]]
    # [T, q0, T, q1, ..., q(t-1), T]: even slots probe the target
    n_slots = 2 * target + 1
    inter = np.empty((n_slots, 8), dtype=np.int32)
    inter[0::2] = apps[target]
    inter[0::2, 7] = 1
    inter[1::2] = apps[:target]
    probe = np.zeros(n_slots, dtype=bool)
    probe[0::2] = True

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    rank = dev(driver_rank, torch.int32)
    eok = dev(exec_ok, torch.bool)
    args = (
        dev(avail, torch.int32), rank, eok,
        dev(inter[:, 0:3], torch.int32), dev(inter[:, 3:6], torch.int32),
        dev(inter[:, 6], torch.int32), dev(inter[:, 7] != 0, torch.bool), dev(probe, torch.bool),
    )
    if policy == 2:
        feasible, _, usage, planes = fifo_queue_min_frag_explain(*args)
    else:
        feasible, _, usage, planes = fifo_queue_explain(*args, evenly=policy == 1)
    # one copy to the host: the probe verdicts, the steps' verdicts and
    # usage, then the decomposition at the target's position
    host = torch.cat([
        feasible.to(torch.int64), usage.to(torch.int64), _probe_totals(planes, rank, eok, row),
    ]).cpu().numpy()
    verdicts, usage_h, totals = host[:n_slots], host[n_slots:2 * n_slots], host[2 * n_slots:]
    fits_after = verdicts[0::2].astype(bool)  # f[p], p = 0..target
    step_feas = verdicts[1::2].astype(bool)
    step_usage = usage_h[1::2]

    if not fits_after[0]:
        flip = -2
    else:
        short = np.flatnonzero(~fits_after)
        flip = int(short[0]) - 1 if len(short) else -1
    feasible_t = bool(fits_after[target])
    cap_total = int(totals[0])
    dim_totals = [int(v) for v in totals[1:4]]
    k, e = row[6], row[3:6]

    tightest, shortfall = -1, 0
    if not feasible_t and cap_total < k:
        for j in range(3):
            if e[j] == 0:
                continue
            if tightest < 0 or dim_totals[j] < dim_totals[tightest]:
                tightest = j
        shortfall = k - cap_total

    blockers = np.zeros(na, dtype=bool)
    if not feasible_t and flip >= 0:
        # the feasible steps from the flip backwards: the flip driver
        # alone when the target is driver-blocked, else until what they
        # took of the tightest dimension covers the shortfall
        walked = np.flatnonzero(step_feas[: flip + 1])[::-1]
        if tightest < 0:
            walked = walked[:1]
        else:
            need = shortfall * int(e[tightest])
            took = (step_usage[walked] >> 1) * apps[walked, 3 + tightest].astype(np.int64) + (
                step_usage[walked] & 1
            ) * apps[walked, tightest].astype(np.int64)
            covered = np.flatnonzero(np.cumsum(took) >= need)
            if len(covered):
                walked = walked[: covered[0] + 1]
        blockers[walked] = True

    info = np.array(
        [
            flip, int(feasible_t), cap_total, *dim_totals, int(totals[4]), int(totals[5]),
            int(totals[6]), tightest, shortfall, int(blockers.sum()),
        ],
        dtype=np.int64,
    )
    return ExplainResult(info, blockers)
