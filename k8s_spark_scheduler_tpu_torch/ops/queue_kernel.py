"""The whole-FIFO-queue gang solve: a hand-written CUDA kernel
(``csrc/queue_kernel.cu``) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
``pallas_queue.pallas_solve_queue`` / ``_queue_kernel``: the whole queue
of earlier drivers in one launch, the availability carry resident on
chip.  It launches as one thread-block cluster whose blocks each hold a
segment of the node axis in shared memory (planar global scratch when a
segment does not fit) and exchange partial results through distributed
shared memory, two exchanges an app: the capacity total with the fill's
prefix, then the driver with the one correction its node makes to that
prefix (``layout`` reports the launch).  ``fifo_queue`` is the wrapper
every caller goes through: a tensor on the CPU takes the plain version
(``solve_queue_plain``), a CUDA tensor launches the kernel, and anything
else raises.  There is no fallback from the kernel to the plain version:
a refused cluster launch raises.  ``fifo_queue_explain`` launches the
same kernel with two extra arguments the refusal explainer needs
(``ops/explain.py``): per-app probe flags (a probed app gets its verdict
and subtracts nothing) and a per-app usage output.  The delta-solve
session (``ops/fifo_session.py``) passes ``fifo_queue`` a checkpoint
buffer: the same launch leaves the carried planes behind at every
``chk_stride``-th queue position (``write_checkpoint``), and a later launch
resumes from one of them with ``chk_base`` the queue position of its
first app.

The kernel is compiled from the package's sources at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ctypes, under ``<package>/_build`` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .cuda_build import KernelLibrary, check_tensor, shared_bytes_or_raise

BIG = 2**31 - 1


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fifo_queue_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p, p, p, p, p, i, i, i, p, p]
    lib.fifo_queue_launch.restype = ctypes.c_int
    lib.fifo_queue_shared_bytes.argtypes = [i, p]
    lib.fifo_queue_shared_bytes.restype = ctypes.c_longlong
    lib.fifo_queue_blocks.argtypes = lib.fifo_queue_threads.argtypes = []
    lib.fifo_queue_blocks.restype = lib.fifo_queue_threads.restype = i


LIBRARY = KernelLibrary("queue_kernel.cu", _declare)

# kernel launches per variant, counted by fifo_queue where it launches
# (a launch that writes checkpoints counts under its own name)
launch_counts = {
    "fifo_queue_tightly": 0,
    "fifo_queue_evenly": 0,
    "fifo_queue_tightly_checkpointed": 0,
    "fifo_queue_evenly_checkpointed": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class Layout(NamedTuple):
    """The kernel's launch for a problem of n nodes."""

    blocks: int  # blocks of the one thread-block cluster
    threads: int  # threads a block
    segment_bytes: int  # dynamic shared memory a block keeps its nodes in (0: global scratch)
    static_bytes: int  # static shared memory a block keeps (the app tile, the exchange slots)


def layout(n: int, device: torch.device) -> Layout:
    """How the kernel launches for n nodes on `device`."""
    lib = LIBRARY.load()
    static = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        segment = shared_bytes_or_raise(lib.fifo_queue_shared_bytes(n, ctypes.byref(static)), "queue")
    return Layout(lib.fifo_queue_blocks(), lib.fifo_queue_threads(), segment, static.value)


def last_axis_min(x: torch.Tensor, empty: int) -> torch.Tensor:
    """Minimum over the last axis (`empty` where that axis has length 0)."""
    if x.shape[-1]:
        return x.amin(-1)
    return torch.full(x.shape[:-1], empty, dtype=x.dtype, device=x.device)


def gang_core_plain(cpu, mem, gpu, rank, exec_ok, dr, ex, k):
    """pallas_queue._gang_core in plain PyTorch ops on [..., N] node planes
    (a leading axis, such as zones, broadcasts): feasibility and the first
    driver by the capacity-total identity.  Returns (feasible [...],
    flat_idx [...], is_driver [..., N], cap [..., N]) with cap
    driver-adjusted and zeroed when infeasible."""
    n = cpu.shape[-1]
    node_ids = torch.arange(n, dtype=torch.int32, device=cpu.device)

    def caps(c, m, g):
        def dim(avail_d, req):
            unbounded = torch.where(avail_d >= 0, torch.full_like(avail_d, BIG), 0)
            return torch.where(req == 0, unbounded, torch.div(avail_d, torch.clamp(req, min=1), rounding_mode="trunc"))

        cap = torch.minimum(torch.minimum(dim(c, ex[0]), dim(m, ex[1])), dim(g, ex[2]))
        return torch.minimum(torch.clamp(cap, min=0), k)

    base_cap = torch.where(exec_ok, caps(cpu, mem, gpu), 0)
    cap_with_driver = torch.where(exec_ok, caps(cpu - dr[0], mem - dr[1], gpu - dr[2]), 0)
    driver_fits = (cpu >= dr[0]) & (mem >= dr[1]) & (gpu >= dr[2]) & (rank < BIG)
    total = base_cap.sum(-1, keepdim=True, dtype=torch.int32)
    feasible_d = driver_fits & (total - base_cap + cap_with_driver >= k)

    masked_rank = torch.where(feasible_d, rank, BIG)
    best_rank = last_axis_min(masked_rank, BIG)
    feasible = best_rank < BIG
    flat_idx = last_axis_min(torch.where(masked_rank == best_rank[..., None], node_ids, BIG), BIG)
    is_driver = (node_ids == flat_idx[..., None]) & feasible[..., None]
    cap = torch.where(is_driver, cap_with_driver, base_cap)
    cap = torch.where(feasible[..., None], cap, 0)
    return feasible, flat_idx, is_driver, cap


def subtract_usage_plain(carry, exec_mask, is_driver, dr, ex):
    """The reference's usage-subtraction quirk: one executor's worth on
    every node in exec_mask, else the driver on its node."""
    delta = torch.where(
        exec_mask[:, None], ex[None, :], torch.where(is_driver[:, None], dr[None, :], 0)
    )
    return carry - delta


def stack_outputs(feasible, idx, usage, carry):
    """(feasible [A] bool, driver_idx [A] int32, usage [A] int32, carry)
    from per-app lists."""
    if not feasible:
        empty = torch.zeros((0,), dtype=torch.int32, device=carry.device)
        return empty.to(torch.bool), empty, empty, carry
    return torch.stack(feasible), torch.stack(idx), torch.stack(usage), carry


def app_usage(exec_mask, is_driver, applied):
    """The kernels' per-app usage word: 2 x the nodes given executors, + 1
    when the driver's node got none (the driver row then lands there); 0
    unless the app's usage was applied."""
    hosted = exec_mask.sum(dtype=torch.int32) * 2
    driver_row = (is_driver & ~exec_mask).any().to(torch.int32)
    return torch.where(applied, hosted + driver_row, 0).to(torch.int32)


def apply_flags(feasible, probe, a):
    """Whether app a's usage is subtracted: feasible and not a probe."""
    return feasible if probe is None else feasible & ~probe[a]


def write_checkpoint(chk_out, chk_base: int, chk_stride: int, a: int, carry) -> None:
    """The kernels' checkpoint store (csrc/gang_common.cuh: Checkpoints)
    before local app `a`: the carry goes to slot p // chk_stride - 1 of
    chk_out ([K, N, 3] int32) when p = chk_base + a is a positive
    multiple of chk_stride and the slot is below K; chk_out None stores
    nothing."""
    if chk_out is None:
        return
    p = chk_base + a
    if p > 0 and p % chk_stride == 0 and p // chk_stride - 1 < chk_out.shape[0]:
        chk_out[p // chk_stride - 1] = carry


def check_checkpoints(chk_out, chk_base: int, chk_stride: int, n: int, device) -> None:
    """Raise unless chk_out is a checkpoint buffer the kernels take."""
    if chk_out is None:
        return
    check_tensor(chk_out, "chk_out", torch.int32, (chk_out.shape[0], n, 3), device)
    if chk_stride <= 0 or chk_base < 0:
        raise ValueError(f"checkpoints need chk_stride > 0 and chk_base >= 0, not {chk_stride}, {chk_base}")


def solve_queue_plain(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32 (BIG = not a driver candidate)
    exec_ok: torch.Tensor,      # [N] bool
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    evenly: bool = False,
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,  # [K, N, 3] int32, filled in place
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch ops, app by app:
    (feasible [A] bool, driver_idx [A] int32 (N if infeasible),
    avail_after [N, 3] int32), and the checkpoints into chk_out as the
    kernel writes them (write_checkpoint).  Follows the Pallas kernel's
    formulation (truncating division, (rank, node) minimum) rather than
    batch_solver's, so the two are independent references."""
    feasible, idx, _, carry = queue_plain(
        avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly=evenly,
        chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out,
    )
    return feasible, idx, carry


def queue_plain(
    avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly=False, probe=None,
    chk_base=0, chk_stride=0, chk_out=None,
):
    """solve_queue_plain with the kernel's optional arguments: `probe`
    ([A] bool or None) marks apps that get a verdict and subtract
    nothing.  Returns (feasible, driver_idx, usage [A] int32, avail_after)."""
    n = avail.shape[0]
    carry = avail.to(torch.int32).clone()
    feasible_out, idx_out, usage_out = [], [], []
    for a in range(drivers.shape[0]):
        write_checkpoint(chk_out, chk_base, chk_stride, a, carry)
        dr, ex, k = drivers[a], executors[a], counts[a]
        feasible, flat_idx, is_driver, cap = gang_core_plain(
            carry[:, 0], carry[:, 1], carry[:, 2], driver_rank, exec_ok, dr, ex, k
        )
        feasible = feasible & app_valid[a]
        cap = torch.where(feasible, cap, 0)

        if evenly:
            has = (cap > 0).to(torch.int32)
            exec_mask = (cap > 0) & (torch.cumsum(has, 0, dtype=torch.int32) - has < k)
        else:
            cum_excl = torch.cumsum(cap, 0, dtype=torch.int32) - cap
            exec_mask = torch.minimum(torch.clamp(k - cum_excl, min=0), cap) > 0
        applied = apply_flags(feasible, probe, a)
        exec_mask, is_driver = exec_mask & applied, is_driver & applied
        carry = subtract_usage_plain(carry, exec_mask, is_driver, dr, ex)
        feasible_out.append(feasible)
        idx_out.append(torch.where(feasible, flat_idx, n).to(torch.int32))
        usage_out.append(app_usage(exec_mask, is_driver, applied))
    return stack_outputs(feasible_out, idx_out, usage_out, carry)


def check_queue_args(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid):
    """Raise unless the queue's tensors are what the kernels take."""
    device, n, a = avail.device, avail.shape[0], drivers.shape[0]
    check_tensor(avail, "avail", torch.int32, (n, 3), device)
    check_tensor(driver_rank, "driver_rank", torch.int32, (n,), device)
    check_tensor(exec_ok, "exec_ok", torch.bool, (n,), device)
    check_tensor(drivers, "drivers", torch.int32, (a, 3), device)
    check_tensor(executors, "executors", torch.int32, (a, 3), device)
    check_tensor(counts, "counts", torch.int32, (a,), device)
    check_tensor(app_valid, "app_valid", torch.bool, (a,), device)


def fifo_queue(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    drivers: torch.Tensor,
    executors: torch.Tensor,
    counts: torch.Tensor,
    app_valid: torch.Tensor,
    evenly: bool = False,
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-queue gang solve: (feasible [A] bool, driver_idx [A] int32,
    avail_after [N, 3] int32).  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (no synchronisation)
    as one thread-block cluster.  With chk_out ([K, N, 3] int32 on the
    same device) the launch also writes the carried planes before every
    app whose queue position chk_base + a is a positive multiple of
    chk_stride into slot (chk_base + a) // chk_stride - 1 (slots past K
    are skipped): the delta-solve session's checkpoints."""
    check_checkpoints(chk_out, chk_base, chk_stride, avail.shape[0], avail.device)
    if avail.device.type == "cpu":
        return solve_queue_plain(
            avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly=evenly,
            chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out,
        )
    feasible, driver_idx, _, avail_after = _launch(
        avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly, None,
        (chk_base, chk_stride, chk_out),
    )
    return feasible, driver_idx, avail_after


def fifo_queue_explain(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    drivers: torch.Tensor,
    executors: torch.Tensor,
    counts: torch.Tensor,
    app_valid: torch.Tensor,
    probe: torch.Tensor,
    evenly: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """fifo_queue with probe flags ([A] bool: verdict only, nothing
    subtracted) and the usage output: (feasible, driver_idx, usage [A]
    int32, avail_after).  Same devices and launch as fifo_queue."""
    if avail.device.type == "cpu":
        return queue_plain(
            avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly=evenly, probe=probe
        )
    check_tensor(probe, "probe", torch.bool, (drivers.shape[0],), avail.device)
    return _launch(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly, probe)


def _launch(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly, probe,
            checkpoints=(0, 0, None)):
    """One launch of the kernel on a CUDA device; the usage output only
    when probe flags are given; checkpoints = (chk_base, chk_stride,
    chk_out or None), already checked."""
    device = avail.device
    if device.type != "cuda":
        raise ValueError(f"fifo_queue runs on cpu or cuda tensors, not {device}")
    n, a = avail.shape[0], drivers.shape[0]
    check_queue_args(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid)

    lib = LIBRARY.load()
    feasible = torch.empty((a,), dtype=torch.bool, device=device)
    driver_idx = torch.empty((a,), dtype=torch.int32, device=device)
    usage = None if probe is None else torch.zeros((a,), dtype=torch.int32, device=device)
    avail_after = torch.empty((n, 3), dtype=torch.int32, device=device)
    chk_base, chk_stride, chk_out = checkpoints
    with torch.cuda.device(device):
        # global scratch only when a block's nodes do not fit in its shared memory
        in_shared = shared_bytes_or_raise(lib.fifo_queue_shared_bytes(n, None), "queue") > 0
        scratch = None if in_shared else torch.empty((4 * n,), dtype=torch.int32, device=device)
        err = lib.fifo_queue_launch(
            avail.data_ptr(), driver_rank.data_ptr(), exec_ok.data_ptr(),
            drivers.data_ptr(), executors.data_ptr(), counts.data_ptr(), app_valid.data_ptr(),
            None if probe is None else probe.data_ptr(),
            n, a, int(evenly),
            feasible.data_ptr(), driver_idx.data_ptr(),
            None if usage is None else usage.data_ptr(), avail_after.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            chk_base, chk_stride, 0 if chk_out is None else chk_out.shape[0],
            None if chk_out is None else chk_out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fifo_queue kernel launch failed with CUDA error {err}")
    name = "fifo_queue_evenly" if evenly else "fifo_queue_tightly"
    launch_counts[name + ("_checkpointed" if chk_out is not None else "")] += 1
    return feasible, driver_idx, usage, avail_after
