"""What-if capacity probes: the largest admissible gang per resource
shape and a per-dimension fragmentation report, against a FIXED
availability basis (the reference package's ``capacity/probe.py``).

Feasibility replicates the solver's own rule exactly (the queue
kernels' per-app admission at queue position 0: clamp-sum capacity
total plus the driver-row probe), which all three queue policies share
— distribute-evenly only changes placement, and the min-frag drain is
work-conserving — so a probe verdict matches the real solver's verdict
on the same state (tests/test_torch_capacity.py holds it to the port's
FIFO solver across policies and seeds).  Feasibility is monotone in the
executor count (per node ``min(c,k)·(k+1) ≥ min(c,k+1)·k``), so the
headroom search is a bisection over per-node capacities computed once
per shape.

One formulation, on the device the tensors lie on: every function here
is a batched PyTorch program in exact int64 base units.  The headroom
search runs for all shapes and all segments (the cluster, each
(instance-group, zone) combo) at once: ``[S, N]`` tensors, a bisection
state per (segment, shape), a fixed number of rounds (2 +
⌈log2 k_max⌉) with the shapes that are done frozen, and no host
synchronisation until the caller copies the result out.  A row-level
call passes unit multiplicities; a class-level call passes each class's
node count, and one segment ``[0, n]`` is the whole set of rows.

Read-only diagnostics: no scheduling decision consumes a probe output.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

BIG = 2**62
# headroom search roof: far above any real gang
DEFAULT_K_MAX = 1_000_000

_I64 = torch.int64


def caps_unclamped(avail: torch.Tensor, exec_ok: torch.Tensor, executor: torch.Tensor) -> torch.Tensor:
    """Per-node executor capacity, UNCLAMPED (values ≤ 0 = ineligible):
    exact floor division per nonzero requirement dimension, a
    zero-requirement dimension binds only when its availability is
    overdrawn (capacity.go:36-75 semantics).  ``avail`` is ``[N, 3]``
    (or ``[S, N, 3]``, one basis per shape), ``executor`` ``[3]`` or
    ``[S, 3]``; returns ``[N]`` or ``[S, N]`` int64."""
    single = executor.dim() == 1
    e = executor.reshape(-1, 3).to(_I64)
    a = avail.to(_I64)
    if a.dim() == 2:
        a = a.unsqueeze(0)
    caps = torch.full((e.shape[0], a.shape[1]), BIG, dtype=_I64, device=a.device)
    for j in range(3):
        ej = e[:, j : j + 1]
        aj = a[:, :, j]
        # dimensions in order, as the reference: a zero-requirement
        # dimension overwrites with -1 when overdrawn, a nonzero one mins
        caps = torch.where(
            ej == 0,
            torch.where(aj >= 0, caps, torch.full_like(caps, -1)),
            torch.minimum(caps, torch.div(aj, ej.clamp(min=1), rounding_mode="floor")),
        )
    caps = torch.where(exec_ok.to(torch.bool).unsqueeze(0), caps, torch.zeros_like(caps))
    return caps[0] if single else caps


class _Segments:
    """Contiguous row segments ``[offsets[g], offsets[g+1])``: sums over
    a segment are differences of one inclusive prefix sum."""

    def __init__(self, offsets: Sequence[int], device: torch.device):
        offsets = [int(x) for x in offsets]
        self.n = offsets[-1]
        self.count = len(offsets) - 1
        lengths = torch.tensor([b - a for a, b in zip(offsets, offsets[1:])], dtype=_I64, device=device)
        self.lo = torch.tensor(offsets[:-1], dtype=_I64, device=device)
        self.hi = torch.tensor(offsets[1:], dtype=_I64, device=device)
        self.of_row = torch.repeat_interleave(
            torch.arange(self.count, device=device), lengths, output_size=self.n
        )

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[..., N]`` → ``[..., G]`` segment sums."""
        cs = torch.nn.functional.pad(x.to(_I64).cumsum(-1), (1, 0))
        return cs[..., self.hi] - cs[..., self.lo]


def probe_segments(
    avail: torch.Tensor,      # [N, 3] int64 availability (base units)
    mult: torch.Tensor,       # [N] int64 multiplicity (1 = a node, else a class)
    exec_ok: torch.Tensor,    # [N] bool executor eligibility
    cand: torch.Tensor,       # [N] bool driver candidate
    offsets: Sequence[int],   # G + 1 row offsets of the segments
    shapes: torch.Tensor,     # [S, 6] int64: d0..2 e0..2 (base units)
    k_max: int = DEFAULT_K_MAX,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(headroom [G, S], usable [G, S, 3], probes [G, S]) int64 on the
    tensors' device: the largest admissible gang of every shape within
    every segment, its clamp-sum usable capacity, and the feasibility
    checks the reference's search spends on it (the ``hi`` probe, then
    the ``1`` probe, then the bisection), counted per (segment, shape).

    Multiplicity weighting: every member of a class contributes the same
    clamped capacity, so Σ_nodes min(cap, k) = Σ_rows min(cap, k)·mult,
    and the driver probe asks whether one member of some live candidate
    row covers the driver (its contribution switches from ck to
    cap-with-driver, the others keep ck)."""
    dev = avail.device
    avail = avail.to(_I64)
    shapes = shapes.to(_I64).reshape(-1, 6)
    seg = _Segments(offsets, dev)
    d, e = shapes[:, 0:3], shapes[:, 3:6]
    m = mult.to(_I64).unsqueeze(0)
    caps = caps_unclamped(avail, exec_ok, e).clamp(min=0)                        # [S, N]
    capd = caps_unclamped(avail.unsqueeze(0) - d.unsqueeze(1), exec_ok, e).clamp(min=0)
    covers = (avail.unsqueeze(0) >= d.unsqueeze(1)).all(dim=-1)                  # [S, N]
    cand_d = covers & (cand.to(torch.bool) & (mult > 0)).unsqueeze(0)

    total_kmax = seg.sum(caps.clamp(max=k_max) * m)                              # [S, G]
    usable = total_kmax.unsqueeze(-1) * e.unsqueeze(1)                           # [S, G, 3]
    hi = total_kmax.clamp(max=k_max)

    def feasible(k: torch.Tensor) -> torch.Tensor:
        """The admission rule at k (``[S, G]``, ≥ 1) for every pair."""
        kr = k[:, seg.of_row]                                                    # [S, N]
        ck = torch.minimum(caps, kr)
        total = seg.sum(ck * m)
        hosts = cand_d & (total[:, seg.of_row] - ck + torch.minimum(capd, kr) >= kr)
        return (seg.sum(hosts) > 0) & (total >= k)

    ones = torch.ones_like(hi)
    active = hi >= 1
    fit_hi = feasible(hi.clamp(min=1))
    probes = active.to(_I64)
    headroom = torch.where(active & fit_hi, hi, torch.zeros_like(hi))
    need_one = active & ~fit_hi
    probes = probes + need_one
    bisect = need_one & feasible(ones)
    lo = ones
    for _ in range(max(int(k_max) - 1, 0).bit_length()):  # ⌈log2 k_max⌉ rounds
        live = bisect & (hi - lo > 1)
        mid = lo + (hi - lo) // 2
        fit = feasible(mid.clamp(min=1))
        probes = probes + live
        lo = torch.where(live & fit, mid, lo)
        hi = torch.where(live & ~fit, mid, hi)
    headroom = torch.where(bisect, lo, headroom)
    return headroom.T, usable.transpose(0, 1), probes.T


def _frag_index(total: torch.Tensor, largest: torch.Tensor) -> torch.Tensor:
    """1 − largest/total per dimension (0 when nothing is free), float64
    from the same base units as the reference's final step."""
    ratio = largest.to(torch.float64) / total.clamp(min=1).to(torch.float64)
    return torch.where(total > 0, 1.0 - ratio, torch.zeros_like(ratio))


def frag_segments(
    avail: torch.Tensor, mult: torch.Tensor, mask: torch.Tensor, offsets: Sequence[int]
) -> Tuple[torch.Tensor, ...]:
    """(total_free, largest_chunk, free_nodes, overdrawn) ``[G, 3]`` int64
    and frag_index ``[G, 3]`` float64 over each segment's masked live
    rows: sums weight a row by its multiplicity, maxima ignore it."""
    seg = _Segments(offsets, avail.device)
    avail = avail.to(_I64)
    w = torch.where(mask.to(torch.bool) & (mult > 0), mult.to(_I64), torch.zeros_like(mult, dtype=_I64))
    w = w.unsqueeze(0)                                                           # [1, N]
    rows = avail.T                                                               # [3, N]
    pos = rows.clamp(min=0)
    total = seg.sum(pos * w).T
    free_nodes = seg.sum((rows > 0) * w).T
    overdrawn = seg.sum((rows < 0) * w).T
    held = torch.where(w.T > 0, pos.T, 0)                                        # [N, 3]
    largest = torch.zeros((seg.count, 3), dtype=_I64, device=avail.device).scatter_reduce(
        0, seg.of_row.unsqueeze(1).expand(-1, 3), held, "amax"
    )
    return total, largest, free_nodes, overdrawn, _frag_index(total, largest)

