"""The whole-FIFO-queue single-AZ gang solve: a hand-written CUDA kernel
(``csrc/single_az_kernel.cu``) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
``pallas_queue.pallas_solve_queue_single_az`` / ``_singleaz_kernel``: per
app, every zone's gang solve (tightly-pack, or the min-frag drain), the
fixed-point zone score, the strict-improvement choice in zone order with
its ``uncertain`` flag, the az-aware cross-zone fallback and the carried
usage subtraction, for the whole queue in one launch of a thread-block
cluster whose blocks each own a run of zones (``zone_layout``).
``fifo_queue_single_az`` is the wrapper every caller goes through: a
tensor on the CPU takes the plain version
(``solve_queue_single_az_plain``), a CUDA tensor launches the kernel, and
anything else raises.  There is no fallback from the kernel to the plain
version: a refused cluster launch raises.  The caller guards the score's numeric bounds
(``fifo_solver._fused_efficiency_inputs``) and, for the min-frag drain,
``batch_solver.mf_sentinel_safe``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .batch_solver import EFF_SHIFT
from .cuda_build import KernelLibrary, check_tensor
from .minfrag_kernel import min_frag_plain
from .queue_kernel import BIG, check_queue_args, gang_core_plain, subtract_usage_plain

# kernel variants in the library's order, and their launch-count names;
# strict parity is an argument of the min-frag variant
VARIANTS = (
    "fifo_queue_single_az_tightly",
    "fifo_queue_single_az_az_aware",
    "fifo_queue_single_az_min_frag",
)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fifo_queue_single_az_launch.argtypes = [p] * 14 + [i] * 8 + [p] * 9
    lib.fifo_queue_single_az_launch.restype = ctypes.c_int


LIBRARY = KernelLibrary("single_az_kernel.cu", _declare)

# kernel launches per variant, counted by fifo_queue_single_az where it launches
launch_counts = {name: 0 for name in VARIANTS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def variant_of(az_aware: bool, minfrag: bool) -> int:
    if az_aware and minfrag:
        raise ValueError("the az-aware fallback has no minimal-fragmentation variant")
    return 2 if minfrag else int(az_aware)


# the most blocks a cluster takes (the portable cluster size), and the
# threads of each block (csrc/single_az_kernel.cu)
MAX_CLUSTER = 8
THREADS = 512


class ZoneLayout(NamedTuple):
    """The kernel's node order and its cluster's blocks: perm [N] int32 is
    the input node at each position (zone 0's nodes in input order, then
    zone 1's, ..., then the nodes of no zone), pos_of [N] int32 its
    inverse, zone_start [Z + 1] int32 each zone's first position (the last
    entry is where the nodes of no zone start), block_zone [C + 1] int32
    each block's first zone (block b owns zones [block_zone[b],
    block_zone[b + 1]); the last block also holds the nodes of no zone)."""

    perm: torch.Tensor
    pos_of: torch.Tensor
    zone_start: torch.Tensor
    block_zone: torch.Tensor

    @property
    def cluster(self) -> int:
        return self.block_zone.shape[0] - 1


def zone_layout(zone_id: torch.Tensor, n_zones: int) -> ZoneLayout:
    """The zone-major layout for ``zone_id`` [N] int32 (an id outside
    [0, n_zones) is no zone), computed with torch ops on its device.  The
    cluster has C = min(max(n_zones, 1), MAX_CLUSTER) blocks; a zone goes
    to the block its middle node falls in when the zoned nodes are cut into
    C equal parts, kept so that zone 0 is in block 0, the last zone in the
    last block, and each zone at most one block after the zone before it,
    so that no block is left without a zone."""
    dev = zone_id.device
    n = zone_id.shape[0]
    c = min(max(n_zones, 1), MAX_CLUSTER)
    key = torch.where((zone_id >= 0) & (zone_id < n_zones), zone_id, n_zones).to(torch.int64)
    perm = torch.sort(key, stable=True).indices
    pos_of = torch.empty_like(perm)
    pos_of[perm] = torch.arange(n, dtype=torch.int64, device=dev)
    sizes = torch.bincount(key, minlength=n_zones + 1)[:n_zones]
    zone_start = torch.zeros(n_zones + 1, dtype=torch.int64, device=dev)
    zone_start[1:] = torch.cumsum(sizes, 0)
    z = torch.arange(n_zones, dtype=torch.int64, device=dev)
    total = torch.clamp(zone_start[-1], min=1)
    block = torch.div((2 * zone_start[:-1] + sizes) * c, 2 * total, rounding_mode="floor")
    block = torch.minimum(torch.maximum(block, c - n_zones + z), torch.clamp(z, max=c - 1))
    # block[z] = min(block[z], block[z - 1] + 1), for every z at once
    block = z + torch.cummin(block - z, 0).values
    block_zone = torch.searchsorted(block, torch.arange(c + 1, dtype=torch.int64, device=dev))
    i32 = torch.int32
    return ZoneLayout(perm.to(i32), pos_of.to(i32), zone_start.to(i32), block_zone.to(i32))


def _tightly_plain(cpu, mem, gpu, rank, exec_ok, dr, ex, k):
    """pallas_queue._solve_tightly on [..., N] planes: (feasible, flat_idx,
    is_driver, executor counts)."""
    feasible, flat_idx, is_driver, cap = gang_core_plain(cpu, mem, gpu, rank, exec_ok, dr, ex, k)
    cum_excl = torch.cumsum(cap, -1, dtype=torch.int32) - cap
    x = torch.minimum(torch.clamp(k - cum_excl, min=0), cap)
    return feasible, flat_idx, is_driver, torch.where(feasible[..., None], x, 0)


def _pick_zone(f, nz, q, band, n_zones: int):
    """The kernel's zone choice over [Z] vectors, in closed form: zones
    are walked in order; the first feasible zone with a nonzero score
    opens the choice, after it a feasible zone replaces the choice only
    on a strictly higher score (so ties keep the earlier zone), and a
    feasible zone whose score differs from the choice so far by at most
    ``band`` flags the app uncertain.  Returns (zone [] int32, -1 =
    none; uncertain [] bool)."""
    dev = q.device
    if not n_zones:
        return torch.tensor(-1, dtype=torch.int32, device=dev), torch.tensor(False, device=dev)
    z = torch.arange(n_zones, dtype=torch.int32, device=dev)
    z0 = torch.where(f & nz, z, n_zones).min()  # the zone that opens the choice
    live = f & (z >= z0)
    running = torch.cummax(torch.where(live, q, torch.iinfo(torch.int32).min), 0).values
    best_q = running[-1]
    # the choice before each zone: the running best up to the zone before
    before = torch.where(z > z0, torch.roll(running, 1), q)
    uncertain = (live & (q != before) & (torch.abs(q - before) <= band)).any()
    best_zone = torch.where(live & (q == best_q), z, n_zones).min()
    return torch.where(best_zone < n_zones, best_zone, -1), uncertain


def solve_queue_single_az_plain(
    avail: torch.Tensor,        # [N, 3] int32
    driver_rank: torch.Tensor,  # [N] int32 (BIG = not a driver candidate)
    exec_ok: torch.Tensor,      # [N] bool
    zone_id: torch.Tensor,      # [N] int32 (zone index; -1 = no candidate zone)
    drivers: torch.Tensor,      # [A, 3] int32
    executors: torch.Tensor,    # [A, 3] int32
    counts: torch.Tensor,       # [A] int32
    app_valid: torch.Tensor,    # [A] bool
    s_cpu: torch.Tensor,        # [N] int32 schedulable cpu, base milli units
    s_gpu: torch.Tensor,        # [N] int32 schedulable gpu, base milli units
    inv_mem: torch.Tensor,      # [N] float32 scale_mem / schedulable memory bytes
    th_mem: torch.Tensor,       # [N] int32 ceil(schedulable memory bytes / scale_mem)
    scale_cpu: int,
    scale_gpu: int,
    n_zones: int,
    az_aware: bool = False,
    minfrag: bool = False,
    strict: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch ops, app by app, every zone
    at once on a leading zone axis, as the Pallas kernel formulates it:
    (feasible [A] bool, zone_idx [A] int32 (n_zones = the cross-zone
    fallback, -1 = none), driver_idx [A] int32 (N if none), uncertain [A]
    bool, avail_after [N, 3] int32)."""
    variant_of(az_aware, minfrag)
    n = avail.shape[0]
    dev = avail.device
    masks = zone_id[None, :] == torch.arange(n_zones, dtype=torch.int32, device=dev)[:, None]
    zone_rank = torch.where(masks, driver_rank, BIG)
    zone_ok = exec_ok & masks

    def ceil_thousands(v):
        return torch.div(v + 999, 1000, rounding_mode="trunc")

    den_c = torch.clamp(ceil_thousands(s_cpu), min=1).to(torch.float32)
    den_g = torch.clamp(ceil_thousands(s_gpu), min=1).to(torch.float32)
    has_gpu = s_gpu > 0

    def score(cpu, mem, gpu, x, res, is_driver, dr, ex):
        """(Q [Z], nz [Z]): x weights the occurrences, res is the
        reservation the efficiency numerators see."""
        w = x + is_driver.to(torch.int32)
        m_c = cpu - (res * ex[0] + torch.where(is_driver, dr[0], 0))
        m_m = mem - (res * ex[1] + torch.where(is_driver, dr[1], 0))
        m_g = gpu - (res * ex[2] + torch.where(is_driver, dr[2], 0))
        num_cq = s_cpu - m_c * scale_cpu
        num_gq = s_gpu - m_g * scale_gpu
        ratio_c = ceil_thousands(num_cq).to(torch.float32) / den_c
        ratio_g = torch.where(has_gpu, ceil_thousands(num_gq).to(torch.float32) / den_g, 0.0)
        ratio_m = torch.clamp(1.0 - m_m.to(torch.float32) * inv_mem, min=0.0)
        eff = torch.maximum(torch.maximum(ratio_c, ratio_m), ratio_g)
        q = torch.floor(eff * float(2**EFF_SHIFT) + 0.5).to(torch.int32)
        q_sum = torch.where(w > 0, w * q, 0).sum(-1, dtype=torch.int32)
        nz = ((w > 0) & ((num_cq > 0) | (m_m < th_mem) | (has_gpu & (num_gq > 0)))).any(-1)
        return q_sum, nz

    carry = avail.to(torch.int32).clone()
    outs = []
    for a in range(drivers.shape[0]):
        dr, ex, k, valid = drivers[a], executors[a], counts[a], app_valid[a]
        band = 2 * (k + 1) + 2
        cpu, mem, gpu = carry[:, 0], carry[:, 1], carry[:, 2]
        if minfrag:
            f, flat_idx, is_driver, x = min_frag_plain(cpu, mem, gpu, zone_rank, zone_ok, dr, ex, k)
            q, nz = score(cpu, mem, gpu, x, torch.zeros_like(x) if strict else x, is_driver, dr, ex)
        else:
            f, flat_idx, is_driver, x = _tightly_plain(cpu, mem, gpu, zone_rank, zone_ok, dr, ex, k)
            q, nz = score(cpu, mem, gpu, x, x, is_driver, dr, ex)

        best_zone, uncertain = _pick_zone(f, nz, q, band, n_zones)
        found = best_zone >= 0
        pick = best_zone.clamp(min=0).to(torch.int64).reshape(1)
        if n_zones:
            chosen_x = torch.where(found, x.index_select(0, pick)[0], 0)
            chosen_driver = is_driver.index_select(0, pick)[0] & found
            chosen_idx = torch.where(found, flat_idx.index_select(0, pick)[0], n)
        else:
            chosen_x = torch.zeros(n, dtype=torch.int32, device=dev)
            chosen_driver = torch.zeros(n, dtype=torch.bool, device=dev)
            chosen_idx = torch.tensor(n, dtype=torch.int32, device=dev)
        if az_aware:
            fc, idx_c, driver_c, x_c = _tightly_plain(cpu, mem, gpu, driver_rank, exec_ok, dr, ex, k)
            use_cross = (best_zone < 0) & fc
            best_zone = torch.where(use_cross, n_zones, best_zone)
            chosen_x = torch.where(use_cross, x_c, chosen_x)
            chosen_driver = torch.where(use_cross, driver_c, chosen_driver)
            chosen_idx = torch.where(use_cross, idx_c, chosen_idx)

        placed = (best_zone >= 0) & valid
        carry = subtract_usage_plain(carry, (chosen_x > 0) & placed, chosen_driver & placed, dr, ex)
        outs.append((
            placed,
            torch.where(placed, best_zone, -1).to(torch.int32),
            torch.where(placed, chosen_idx, n).to(torch.int32),
            uncertain,
        ))

    if not outs:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return empty.to(torch.bool), empty, empty, empty.to(torch.bool), carry
    feasible, zone_idx, driver_idx, uncertain = (torch.stack(x) for x in zip(*outs))
    return feasible, zone_idx, driver_idx, uncertain, carry


def fifo_queue_single_az(
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    zone_id: torch.Tensor,
    drivers: torch.Tensor,
    executors: torch.Tensor,
    counts: torch.Tensor,
    app_valid: torch.Tensor,
    s_cpu: torch.Tensor,
    s_gpu: torch.Tensor,
    inv_mem: torch.Tensor,
    th_mem: torch.Tensor,
    scale_cpu: int,
    scale_gpu: int,
    n_zones: int,
    az_aware: bool = False,
    minfrag: bool = False,
    strict: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-queue single-AZ gang solve: (feasible [A] bool, zone_idx [A]
    int32, driver_idx [A] int32, uncertain [A] bool, avail_after [N, 3]
    int32).  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream (no synchronisation)."""
    args = (avail, driver_rank, exec_ok, zone_id, drivers, executors, counts, app_valid,
            s_cpu, s_gpu, inv_mem, th_mem, scale_cpu, scale_gpu, n_zones)
    device = avail.device
    if device.type == "cpu":
        return solve_queue_single_az_plain(*args, az_aware=az_aware, minfrag=minfrag, strict=strict)
    if device.type != "cuda":
        raise ValueError(f"fifo_queue_single_az runs on cpu or cuda tensors, not {device}")
    variant = variant_of(az_aware, minfrag)
    if n_zones < 0:
        raise ValueError(f"fifo_queue_single_az takes a zone count >= 0, not {n_zones}")
    n, a = avail.shape[0], drivers.shape[0]
    check_queue_args(avail, driver_rank, exec_ok, drivers, executors, counts, app_valid)
    check_tensor(zone_id, "zone_id", torch.int32, (n,), device)
    for t, what, dtype in ((s_cpu, "s_cpu", torch.int32), (s_gpu, "s_gpu", torch.int32),
                           (inv_mem, "inv_mem", torch.float32), (th_mem, "th_mem", torch.int32)):
        check_tensor(t, what, dtype, (n,), device)

    lib = LIBRARY.load()
    layout = zone_layout(zone_id, n_zones)
    blocks = torch.cat((layout.zone_start, layout.block_zone))
    feasible = torch.empty((a,), dtype=torch.bool, device=device)
    zone_idx = torch.empty((a,), dtype=torch.int32, device=device)
    driver_idx = torch.empty((a,), dtype=torch.int32, device=device)
    uncertain = torch.empty((a,), dtype=torch.bool, device=device)
    avail_after = torch.empty((n, 3), dtype=torch.int32, device=device)
    # node planes of the blocks whose segment does not fit in shared memory
    # ([5N] int32 and [N] bytes), the cross-zone capacities, and the zone
    # table when it does not fit in shared memory
    scratch = torch.empty((5 * n + (n + 3) // 4,), dtype=torch.int32, device=device)
    cross_caps = torch.empty((n,), dtype=torch.int32, device=device)
    zone_table = torch.empty((2 * n_zones, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.fifo_queue_single_az_launch(
            avail.data_ptr(), driver_rank.data_ptr(), exec_ok.data_ptr(), layout.perm.data_ptr(),
            layout.pos_of.data_ptr(), blocks.data_ptr(),
            drivers.data_ptr(), executors.data_ptr(), counts.data_ptr(), app_valid.data_ptr(),
            s_cpu.data_ptr(), s_gpu.data_ptr(), inv_mem.data_ptr(), th_mem.data_ptr(),
            int(scale_cpu), int(scale_gpu), n, a, n_zones, layout.cluster, variant, int(strict),
            feasible.data_ptr(), zone_idx.data_ptr(), driver_idx.data_ptr(), uncertain.data_ptr(),
            avail_after.data_ptr(), scratch.data_ptr(), cross_caps.data_ptr(),
            zone_table.data_ptr() if n_zones else None,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fifo_queue_single_az kernel launch failed with CUDA error {err}")
    launch_counts[VARIANTS[variant]] += 1
    return feasible, zone_idx, driver_idx, uncertain, avail_after
