"""The whole-FIFO-queue gang solve under the minimal-fragmentation policy:
a hand-written CUDA kernel (``csrc/minfrag_kernel.cu``) and its plain
PyTorch version.

The kernel replaces the JAX package's Pallas kernel
``pallas_queue.pallas_solve_queue_min_frag`` / ``_minfrag_queue_kernel``.
``fifo_queue_min_frag`` is the wrapper every caller goes through: a tensor
on the CPU takes the plain version (``solve_queue_min_frag_plain``), a
CUDA tensor launches the kernel, and anything else raises.  There is no
fallback from the kernel to the plain version: a refused cluster launch
raises.  The caller guards
``batch_solver.mf_sentinel_safe``: no real capacity may reach ``MF_SENT``.
``fifo_queue_min_frag_explain`` launches the same kernel with the probe
flags and usage output of ``queue_kernel.fifo_queue_explain``, and
``fifo_queue_min_frag`` takes the checkpoint arguments of
``queue_kernel.fifo_queue`` for the delta-solve session.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .batch_solver import MF_SENT
from .cuda_build import KernelLibrary, check_tensor
from .queue_kernel import (
    BIG,
    app_usage,
    apply_flags,
    check_checkpoints,
    check_queue_args,
    count_launch,
    gang_core_plain,
    last_axis_min,
    reset_counts,
    stack_outputs,
    subtract_usage_plain,
    write_checkpoint,
)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fifo_queue_min_frag_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p, p, p, p, i, i, i, p, p]
    lib.fifo_queue_min_frag_launch.restype = ctypes.c_int


LIBRARY = KernelLibrary("minfrag_kernel.cu", _declare)

# kernel launches, counted by fifo_queue_min_frag where it launches
# (a launch that writes checkpoints counts under its own name)
launch_counts = {"fifo_queue_min_frag": 0, "fifo_queue_min_frag_checkpointed": 0}


# the same launches by the raw handle of the CUDA stream they went on
# (queue_kernel.count_launch moves both under one lock)
stream_launch_counts = {}


def reset_launch_counts() -> None:
    reset_counts(launch_counts, stream_launch_counts)


# the kernel's launch: the node axis over one cluster of 8 blocks of 512
# threads (csrc/minfrag_kernel.cu)
CLUSTER_BLOCKS, THREADS = 8, 512


def mf_caps_plain(cpu, mem, gpu, ex, exec_ok):
    """pallas_queue._mf_caps: UNCLAMPED per-node capacity, MF_SENT for
    unbounded nodes."""

    def dim(avail_d, req):
        unbounded = torch.where(avail_d >= 0, torch.full_like(avail_d, MF_SENT), 0)
        return torch.where(req == 0, unbounded, torch.div(avail_d, torch.clamp(req, min=1), rounding_mode="trunc"))

    cap = torch.minimum(torch.minimum(dim(cpu, ex[0]), dim(mem, ex[1])), dim(gpu, ex[2]))
    return torch.where(exec_ok, torch.clamp(cap, 0, MF_SENT), 0)


def _mf_run(d, sub, k, node_ids):
    """pallas_queue._mf_run for every pass at once: d [..., N], sub
    [..., P, N] one eligibility mask per pass.  Returns (ok [..., P],
    drained [..., P, N], partial [..., P], kstar [..., P], vstar [..., P])."""
    dd = torch.where(sub, d[..., None, :], 0)
    dc = torch.minimum(dd, k)
    ok = (dc.sum(-1, dtype=torch.int32) >= k) & (k > 0)

    lo = torch.ones(dd.shape[:-1], dtype=torch.int32, device=dd.device)
    hi = torch.full_like(lo, MF_SENT)
    for _ in range(31):
        mid = lo + torch.div(hi - lo + 1, 2, rounding_mode="floor")
        good = torch.where(dd >= mid[..., None], dc, 0).sum(-1, dtype=torch.int32) >= k
        lo = torch.where(good, mid, lo)
        hi = torch.where(good, hi, mid - 1)
    vstar = lo
    s = torch.where(dd > vstar[..., None], dd, 0).sum(-1, dtype=torch.int32)  # drained classes, < k
    r = k - s
    tstar = torch.div(torch.clamp(r - 1, min=0), vstar, rounding_mode="floor")
    kstar = r - tstar * vstar
    at = sub & (dd == vstar[..., None])
    at_i = at.to(torch.int32)
    at_rank = torch.cumsum(at_i, -1, dtype=torch.int32) - at_i
    drained = (sub & (dd > vstar[..., None])) | (at & (at_rank < tstar[..., None]))
    cand = sub & ~drained & (dd >= kstar[..., None])
    vp = last_axis_min(torch.where(cand, dd, BIG), BIG)
    partial = last_axis_min(torch.where(cand & (dd == vp[..., None]), node_ids, BIG), BIG)
    # empty candidate set → index 0, replicating the host argmax default
    partial = torch.where(partial == BIG, 0, partial)
    return ok, drained, partial, kstar, vstar


def vstar_short(d: torch.Tensor, k: int, in_pass: torch.Tensor) -> Tuple[int, int]:
    """v* of a feasible min-frag pass as the kernel finds it
    (csrc/gang_common.cuh: min_frag_drain), step by step: (v*, probes).
    d [N] are the capacities, in_pass [N] the pass's nodes, k > 0 and the
    pass holds k (sum of min(d, k) >= k).  With m the pass's largest
    capacity: m >= k gives v* = m with no probe; else a binary search over
    [1, m] with d in place of min(d, k).  It equals _mf_run's 31-probe
    search; it exists for the tests."""
    dd = torch.where(in_pass, d, 0)
    m = int(dd.max()) if dd.numel() else 0
    if m >= k:
        return m, 0
    lo, hi, probes = 1, m, 0
    while lo < hi:
        mid = lo + (hi - lo + 1) // 2
        probes += 1
        if int(torch.where(dd >= mid, dd, 0).sum()) >= k:
            lo = mid
        else:
            hi = mid - 1
    return lo, probes


def min_frag_plain(cpu, mem, gpu, rank, exec_ok, dr, ex, k):
    """pallas_queue._solve_min_frag on [..., N] node planes: the gang
    core's feasibility and driver, then the min-frag drain (the (k+max)/2
    subset pass and the full pass; the subset wins when it fits).
    Returns (feasible [...], flat_idx [...], is_driver [..., N], counts
    [..., N]) with counts the executors on each node."""
    n = cpu.shape[-1]
    node_ids = torch.arange(n, dtype=torch.int32, device=cpu.device)
    feasible, flat_idx, is_driver, _ = gang_core_plain(cpu, mem, gpu, rank, exec_ok, dr, ex, k)
    d = mf_caps_plain(
        cpu - torch.where(is_driver, dr[0], 0),
        mem - torch.where(is_driver, dr[1], 0),
        gpu - torch.where(is_driver, dr[2], 0),
        ex,
        exec_ok,
    )
    elig = d > 0
    max_cap = d.amax(-1) if n else torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
    has_sent = (elig & (d == MF_SENT)).any(-1)
    # exact floor((k + max) / 2) without int32 overflow
    half = lambda v: torch.div(v, 2, rounding_mode="floor")
    target = half(k) + half(max_cap) + half((k & 1) + (max_cap & 1))
    subset = elig & torch.where(has_sent[..., None], d < MF_SENT, d < target[..., None])
    attempt = has_sent | (k < max_cap)

    passes = torch.stack([subset & attempt[..., None], elig], dim=-2)
    ok, drained, partial, kstar, _ = _mf_run(d, passes, k, node_ids)
    use_sub = attempt & ok[..., 0]
    drained = torch.where(use_sub[..., None], drained[..., 0, :], drained[..., 1, :])
    partial = torch.where(use_sub, partial[..., 0], partial[..., 1])
    kstar = torch.where(use_sub, kstar[..., 0], kstar[..., 1])
    counts = torch.where(drained, d, 0) + torch.where(node_ids == partial[..., None], kstar[..., None], 0)
    counts = torch.where((ok[..., 1] & feasible)[..., None], counts, 0)
    return feasible, flat_idx, is_driver, counts


def solve_queue_min_frag_plain(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32 (BIG = not a driver candidate)
    exec_ok: torch.Tensor,      # [N] bool
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,  # [K, N, 3] int32, filled in place
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch ops, app by app, as the
    Pallas kernel formulates it (both drain passes run; truncating
    division): (feasible [A] bool, driver_idx [A] int32 (N if
    infeasible), avail_after [N, 3] int32), and the checkpoints into
    chk_out as the kernel writes them (queue_kernel.write_checkpoint)."""
    feasible, idx, _, carry = queue_min_frag_plain(
        avail, driver_rank, exec_ok, drivers, executors, counts, app_valid,
        chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out,
    )
    return feasible, idx, carry


def queue_min_frag_plain(
    avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, probe=None,
    chk_base=0, chk_stride=0, chk_out=None,
):
    """solve_queue_min_frag_plain with the kernel's optional probe flags
    ([A] bool or None): (feasible, driver_idx, usage [A] int32,
    avail_after)."""
    n = avail.shape[0]
    carry = avail.to(torch.int32).clone()
    feasible_out, idx_out, usage_out = [], [], []
    for a in range(drivers.shape[0]):
        write_checkpoint(chk_out, chk_base, chk_stride, a, carry)
        dr, ex = drivers[a], executors[a]
        feasible, flat_idx, is_driver, x = min_frag_plain(
            carry[:, 0], carry[:, 1], carry[:, 2], driver_rank, exec_ok, dr, ex, counts[a]
        )
        feasible = feasible & app_valid[a]
        applied = apply_flags(feasible, probe, a)
        exec_mask, is_driver = (x > 0) & applied, is_driver & applied
        carry = subtract_usage_plain(carry, exec_mask, is_driver, dr, ex)
        feasible_out.append(feasible)
        idx_out.append(torch.where(feasible, flat_idx, n).to(torch.int32))
        usage_out.append(app_usage(exec_mask, is_driver, applied))
    return stack_outputs(feasible_out, idx_out, usage_out, carry)


def fifo_queue_min_frag(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    drivers: torch.Tensor,
    executors: torch.Tensor,
    counts: torch.Tensor,
    app_valid: torch.Tensor,
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-queue min-frag gang solve: (feasible [A] bool, driver_idx [A]
    int32, avail_after [N, 3] int32).  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream (no
    synchronisation) as one cluster of CLUSTER_BLOCKS blocks.  chk_*:
    the checkpoints of queue_kernel.fifo_queue."""
    check_checkpoints(chk_out, chk_base, chk_stride, avail.shape[0], avail.device)
    if avail.device.type == "cpu":
        return solve_queue_min_frag_plain(
            avail, driver_rank, exec_ok, drivers, executors, counts, app_valid,
            chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out,
        )
    feasible, driver_idx, _, avail_after = _launch(
        avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, None,
        (chk_base, chk_stride, chk_out),
    )
    return feasible, driver_idx, avail_after


def fifo_queue_min_frag_explain(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    drivers: torch.Tensor,
    executors: torch.Tensor,
    counts: torch.Tensor,
    app_valid: torch.Tensor,
    probe: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """fifo_queue_min_frag with probe flags ([A] bool: verdict only,
    nothing subtracted) and the usage output: (feasible, driver_idx,
    usage [A] int32, avail_after)."""
    if avail.device.type == "cpu":
        return queue_min_frag_plain(
            avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, probe=probe
        )
    check_tensor(probe, "probe", torch.bool, (drivers.shape[0],), avail.device)
    return _launch(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, probe)


def _launch(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, probe,
            checkpoints=(0, 0, None)):
    """One launch of the kernel on a CUDA device; the usage output only
    when probe flags are given; checkpoints = (chk_base, chk_stride,
    chk_out or None), already checked."""
    device = avail.device
    if device.type != "cuda":
        raise ValueError(f"fifo_queue_min_frag runs on cpu or cuda tensors, not {device}")
    n, a = avail.shape[0], drivers.shape[0]
    check_queue_args(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid)

    lib = LIBRARY.load()
    feasible = torch.empty((a,), dtype=torch.bool, device=device)
    driver_idx = torch.empty((a,), dtype=torch.int32, device=device)
    usage = None if probe is None else torch.zeros((a,), dtype=torch.int32, device=device)
    avail_after = torch.empty((n, 3), dtype=torch.int32, device=device)
    # the node planes when a block's nodes do not fit in its shared memory
    scratch = torch.empty((4 * n,), dtype=torch.int32, device=device)
    chk_base, chk_stride, chk_out = checkpoints
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.fifo_queue_min_frag_launch(
            avail.data_ptr(), driver_rank.data_ptr(), exec_ok.data_ptr(),
            drivers.data_ptr(), executors.data_ptr(), counts.data_ptr(), app_valid.data_ptr(),
            None if probe is None else probe.data_ptr(),
            n, a,
            feasible.data_ptr(), driver_idx.data_ptr(),
            None if usage is None else usage.data_ptr(), avail_after.data_ptr(), scratch.data_ptr(),
            chk_base, chk_stride, 0 if chk_out is None else chk_out.shape[0],
            None if chk_out is None else chk_out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fifo_queue_min_frag kernel launch failed with CUDA error {err}")
    count_launch(launch_counts, stream_launch_counts,
                 "fifo_queue_min_frag_checkpointed" if chk_out is not None else "fifo_queue_min_frag", stream)
    return feasible, driver_idx, usage, avail_after
