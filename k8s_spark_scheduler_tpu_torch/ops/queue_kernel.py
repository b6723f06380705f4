"""The whole-FIFO-queue gang solve: a hand-written CUDA kernel
(``csrc/queue_kernel.cu``) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
``pallas_queue.pallas_solve_queue`` / ``_queue_kernel``: the whole queue
of earlier drivers in one launch, the availability carry resident on
chip.  ``fifo_queue`` is the wrapper every caller goes through: a tensor
on the CPU takes the plain version (``solve_queue_plain``), a CUDA tensor
launches the kernel, and anything else raises.  There is no fallback from
the kernel to the plain version.

The kernel is compiled from the package's sources at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ctypes, under ``<package>/_build`` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import torch

BIG = 2**31 - 1

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "queue_kernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# kernel launches per variant, counted by fifo_queue where it launches
launch_counts = {"fifo_queue_tightly": 0, "fifo_queue_evenly": 0}
# compiler output of the build this process ran ("" if it loaded a cached one)
build_log = ""

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        source = KERNEL_SOURCE.read_bytes()
        digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = BUILD_DIR / f"queue_kernel_{digest}.so"
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCE)],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {KERNEL_SOURCE.name}:\n{proc.stderr}")
            build_log = proc.stdout + proc.stderr
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fifo_queue_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p, p, p]
        lib.fifo_queue_launch.restype = ctypes.c_int
        lib.fifo_queue_shared_bytes.argtypes = [i]
        lib.fifo_queue_shared_bytes.restype = ctypes.c_longlong
        _lib = lib
        return lib


def shared_bytes(n: int, device: torch.device) -> int:
    """Dynamic shared memory the kernel takes for n nodes (0: it works
    from global memory because they do not fit)."""
    lib = load_library()
    with torch.cuda.device(device):
        out = lib.fifo_queue_shared_bytes(n)
    if out < 0:
        raise RuntimeError(f"CUDA error {-out} querying the queue kernel")
    return int(out)


def solve_queue_plain(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32 (BIG = not a driver candidate)
    exec_ok: torch.Tensor,      # [N] bool
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    evenly: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch ops, app by app:
    (feasible [A] bool, driver_idx [A] int32 (N if infeasible),
    avail_after [N, 3] int32).  Follows the Pallas kernel's formulation
    (truncating division, (rank, node) minimum) rather than
    batch_solver's, so the two are independent references."""
    n = avail.shape[0]
    dev = avail.device
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    carry = avail.to(torch.int32).clone()
    feasible_out, idx_out = [], []

    def caps(c, m, g, ex, k):
        def dim(avail_d, req):
            unbounded = torch.where(avail_d >= 0, torch.full_like(avail_d, BIG), 0)
            return torch.where(req == 0, unbounded, torch.div(avail_d, torch.clamp(req, min=1), rounding_mode="trunc"))

        cap = torch.minimum(torch.minimum(dim(c, ex[0]), dim(m, ex[1])), dim(g, ex[2]))
        return torch.minimum(torch.clamp(cap, min=0), k)

    for a in range(drivers.shape[0]):
        dr, ex, k, valid = drivers[a], executors[a], counts[a], app_valid[a]
        cpu, mem, gpu = carry[:, 0], carry[:, 1], carry[:, 2]

        base_cap = torch.where(exec_ok, caps(cpu, mem, gpu, ex, k), 0)
        cap_with_driver = torch.where(exec_ok, caps(cpu - dr[0], mem - dr[1], gpu - dr[2], ex, k), 0)
        driver_fits = (cpu >= dr[0]) & (mem >= dr[1]) & (gpu >= dr[2]) & (driver_rank < BIG)
        total = base_cap.sum(dtype=torch.int32)
        feasible_d = driver_fits & (total - base_cap + cap_with_driver >= k)

        masked_rank = torch.where(feasible_d, driver_rank, BIG)
        best_rank = masked_rank.min() if n else torch.tensor(BIG, dtype=torch.int32, device=dev)
        feasible = (best_rank < BIG) & valid
        flat_idx = torch.where(masked_rank == best_rank, node_ids, BIG).min() if n else best_rank
        is_driver = (node_ids == flat_idx) & feasible
        cap = torch.where(is_driver, cap_with_driver, base_cap)
        cap = torch.where(feasible, cap, 0)

        if evenly:
            has = (cap > 0).to(torch.int32)
            exec_mask = (cap > 0) & (torch.cumsum(has, 0, dtype=torch.int32) - has < k)
        else:
            cum_excl = torch.cumsum(cap, 0, dtype=torch.int32) - cap
            exec_mask = torch.minimum(torch.clamp(k - cum_excl, min=0), cap) > 0
        exec_mask = exec_mask & feasible

        # the reference's usage-subtraction quirk: executor overwrites driver
        delta = torch.where(
            exec_mask[:, None], ex[None, :], torch.where(is_driver[:, None], dr[None, :], 0)
        )
        carry = carry - delta
        feasible_out.append(feasible)
        idx_out.append(torch.where(feasible, flat_idx, n).to(torch.int32))

    if not feasible_out:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return empty.to(torch.bool), empty, carry
    return torch.stack(feasible_out), torch.stack(idx_out), carry


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"fifo_queue: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def fifo_queue(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    drivers: torch.Tensor,
    executors: torch.Tensor,
    counts: torch.Tensor,
    app_valid: torch.Tensor,
    evenly: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-queue gang solve: (feasible [A] bool, driver_idx [A] int32,
    avail_after [N, 3] int32).  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (no synchronisation)."""
    device = avail.device
    if device.type == "cpu":
        return solve_queue_plain(
            avail, driver_rank, exec_ok, drivers, executors, counts, app_valid, evenly=evenly
        )
    if device.type != "cuda":
        raise ValueError(f"fifo_queue runs on cpu or cuda tensors, not {device}")
    n, a = avail.shape[0], drivers.shape[0]
    _check(avail, "avail", torch.int32, (n, 3), device)
    _check(driver_rank, "driver_rank", torch.int32, (n,), device)
    _check(exec_ok, "exec_ok", torch.bool, (n,), device)
    _check(drivers, "drivers", torch.int32, (a, 3), device)
    _check(executors, "executors", torch.int32, (a, 3), device)
    _check(counts, "counts", torch.int32, (a,), device)
    _check(app_valid, "app_valid", torch.bool, (a,), device)

    lib = load_library()
    feasible = torch.empty((a,), dtype=torch.bool, device=device)
    driver_idx = torch.empty((a,), dtype=torch.int32, device=device)
    avail_after = torch.empty((n, 3), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        # global scratch only when the nodes do not fit in shared memory
        scratch = None if shared_bytes(n, device) else torch.empty((4 * n,), dtype=torch.int32, device=device)
        err = lib.fifo_queue_launch(
            avail.data_ptr(), driver_rank.data_ptr(), exec_ok.data_ptr(),
            drivers.data_ptr(), executors.data_ptr(), counts.data_ptr(), app_valid.data_ptr(),
            n, a, int(evenly),
            feasible.data_ptr(), driver_idx.data_ptr(), avail_after.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fifo_queue kernel launch failed with CUDA error {err}")
    launch_counts["fifo_queue_evenly" if evenly else "fifo_queue_tightly"] += 1
    return feasible, driver_idx, avail_after
