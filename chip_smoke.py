"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name, CUDA version, name and power limit;
2. build: the queue kernel from ``ops/csrc/queue_kernel.cu`` (nvcc, sm_90a);
3. kernel vs plain: the CUDA queue kernel against its plain PyTorch
   version on the card, on randomized queues (ragged N, k = 0,
   zero-resource executors, negative availability, invalid apps, a
   problem too large for shared memory) and at 10,240 nodes × 1,024 apps,
   tightly-pack and distribute-evenly; outputs are integers and must be
   exactly equal;
4. main path: ``TpuFifoSolver(device="cuda").solve`` Filter decisions on a
   10,000-node cluster with a 1,000-deep pending queue, tightly-pack and
   distribute-evenly, equal to the same calls on the CPU; one
   ``select_binpacker("tpu-batch").binpack_func`` call; a small snapshot
   checked against the host oracles' sequential FIFO loop; the kernels'
   launch counts over the main path; the queue pass's time, bound and
   serial floor; a breakdown of a decision and the device's busy time in a
   profiler trace of one decision;
5. the kernels line (times, bounds, launches) and the device result line.

Needs CUDA: without it the script exits with an error before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BIG = 2**31 - 1
N_NODES, N_APPS = 10_000, 1_000  # the main path's cluster and queue depth
DECISIONS = 3  # Filter decisions per policy on the main path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
# int32 ALU rate: 132 SMs x 64 int32 lanes a clock x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per node for each valid app, a lower bound: the capacity
# (3 divisions by the app's request, each at least a multiply-high, a shift,
# a sign fix and a select with a per-app magic number; 2 mins, 2 clamps and
# the exec_ok select), the driver fit (4 compares) and the key minimum; the
# capacity beside the driver is counted for no node, as only driver
# candidates need it.  For feasible apps, the fill (a scan add, 2 compares)
# and the carry update (3 subtracts).
OPS_PER_NODE_VALID_APP = 3 * 4 + 5 + 4 + 1
OPS_PER_NODE_FEASIBLE_APP = 3 + 3
FLOOR_NODES = 1024  # one node a thread: the kernel's serial per-app floor

KERNEL_SOURCE = "k8s_spark_scheduler_tpu_torch/ops/csrc/queue_kernel.cu"
REPLACES = "k8s_spark_scheduler_tpu/ops/pallas_queue.py:681"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3 inputs -----------------------------------------------------------


def random_queue(rng: np.random.RandomState, n: int, a: int):
    """A raw queue problem: avail may be negative, ranks are a permutation
    with non-candidates at BIG, executors may need 0 of a dimension,
    k may be 0, some apps invalid."""
    avail = rng.randint(-4, 64, size=(n, 3)).astype(np.int32)
    avail[rng.rand(n) < 0.3, 2] = 0
    rank = rng.permutation(n).astype(np.int32)
    rank[rng.rand(n) < 0.3] = BIG
    exec_ok = rng.rand(n) < 0.85
    drivers = rng.randint(0, 4, size=(a, 3)).astype(np.int32)
    executors = rng.randint(0, 9, size=(a, 3)).astype(np.int32)
    executors[rng.rand(a) < 0.1] = 0
    counts = rng.randint(0, 40, size=a).astype(np.int32)
    valid = rng.rand(a) < 0.9
    return avail, rank, exec_ok, drivers, executors, counts, valid


def on(device, arrays):
    return tuple(torch.as_tensor(x, device=device) for x in arrays)


def compare(kernel_out, plain_out) -> int:
    """Max absolute difference over the three outputs (feasibility as 0/1)."""
    err = 0
    for k, p in zip(kernel_out, plain_out):
        d = (k.to(torch.int64) - p.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 4 snapshot ---------------------------------------------------------


def build_snapshot(seed: int):
    """bench.py's 10k × 1k snapshot distribution, in the port's types:
    avail 4–96 CPU / 8–256 Gi on 96 CPU / 256 Gi nodes in 3 zones,
    executors 1–8 CPU / 2–16 Gi, drivers 1 CPU / 2 Gi, gangs of 1–32."""
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain

    rng = np.random.RandomState(seed)
    metadata = {}
    for i in range(N_NODES):
        metadata[f"node-{i:05d}"] = metadata_from_plain(
            available=(str(int(rng.randint(4, 96))), f"{int(rng.randint(8, 256))}Gi", 0),
            schedulable=("96", "256Gi", 0),
            zone_label=f"z{i % 3}",
        )
    apps = [
        app_from_plain(
            ("1", "2Gi", 0),
            (str(int(rng.randint(1, 8))), f"{int(rng.randint(2, 16))}Gi", 0),
            int(rng.randint(1, 32)),
        )
        for _ in range(N_APPS + 8)
    ]
    skip = [bool(x) for x in rng.rand(N_APPS) < 0.3]
    return metadata, apps[:N_APPS], skip, apps[N_APPS:]


def traced_device_time(fn):
    """Run fn once under torch.profiler: (device busy ms as the union of
    the trace's device intervals, or None if it holds none; host-clock ms
    of the call, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None, wall_ms
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us / 1e3, wall_ms


def outcome_key(o):
    r = o.result
    return (
        o.supported, o.earlier_ok,
        None if r is None else (r.has_capacity, r.driver_node, tuple(r.executor_nodes)),
    )


def host_fifo(metadata, driver_order, executor_order, earlier, skip, current, packer):
    """The reference's fitEarlierDrivers + final pack on the host oracles,
    with its usage-subtraction quirk (per-node entries assigned, the
    executor entry overwriting the driver's)."""
    from k8s_spark_scheduler_tpu_torch.types.resources import (
        copy_metadata,
        subtract_usage_if_exists,
    )

    meta = copy_metadata(metadata)

    def pack(app):
        return packer(
            app.driver_resources, app.executor_resources, app.min_executor_count,
            driver_order, executor_order, meta,
        )

    for app, skippable in zip(earlier, skip):
        result = pack(app)
        if not result.has_capacity:
            if skippable:
                continue
            return (True, False, None)
        usage = {result.driver_node: app.driver_resources}
        for node in result.executor_nodes:
            usage[node] = app.executor_resources
        subtract_usage_if_exists(meta, usage)
    r = pack(current)
    return (True, True, (r.has_capacity, r.driver_node, tuple(r.executor_nodes)))


def small_oracle_check(seed: int) -> int:
    """FIFO decisions on the card against the host oracles on small
    random snapshots; returns the number of decisions checked."""
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain
    from k8s_spark_scheduler_tpu_torch.ops import packers
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter

    rng = random.Random(seed)
    checked = 0
    for policy, packer in (
        ("tightly-pack", packers.tightly_pack),
        ("distribute-evenly", packers.distribute_evenly),
    ):
        solver = TpuFifoSolver(assignment_policy=policy, device="cuda")
        for _ in range(10):
            metadata = {
                f"n{i:02d}": metadata_from_plain(
                    available=(rng.randint(-2, 32), f"{rng.randint(-1, 64)}Gi", rng.choice([0, 0, 1, 4])),
                    schedulable=(32, "64Gi", 4),
                    zone_label=f"z{rng.randint(0, 2)}",
                    unschedulable=rng.random() < 0.1,
                )
                for i in range(rng.randint(2, 20))
            }
            driver_order, executor_order = NodeSorter().potential_nodes(metadata, list(metadata))

            def app():
                return app_from_plain(
                    (rng.choice(["1", "500m"]), rng.choice(["1Gi", "512Mi"]), 0),
                    (rng.choice(["1", "2", "0"]), rng.choice(["1Gi", "2Gi", "0"]), rng.choice([0, 0, 1])),
                    rng.randint(0, 20),
                )

            earlier = [app() for _ in range(rng.randint(0, 8))]
            skip = [rng.random() < 0.3 for _ in earlier]
            current = app()
            want = host_fifo(metadata, driver_order, executor_order, earlier, skip, current, packer)
            got = outcome_key(
                solver.solve(metadata, driver_order, executor_order, earlier, skip, current)
            )
            if got != want:
                raise SystemExit(f"small-snapshot FIFO decision differs from the host oracle: {got} vs {want}")
            checked += 1
    return checked


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2

    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter
    from k8s_spark_scheduler_tpu_torch.ops.registry import select_binpacker
    from k8s_spark_scheduler_tpu_torch.ops.tensorize import scale_problem, tensorize_cluster

    dev = torch.device("cuda")
    # ---- phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    log(f"phase device: {name} | torch {torch.__version__} | cuda {torch.version.cuda} | {smi}")

    # ---- phase 2: build
    t0 = time.perf_counter()
    qk.load_library()
    log(f"phase build: queue kernel ready in {time.perf_counter() - t0:.2f} s")
    for line in qk.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain on the card
    max_err = {False: 0, True: 0}
    cases = [(2, 5), (31, 17), (100, 40), (129, 64), (300, 100), (1000, 200), (4099, 64),
             (12345, 48), (10240, 1024)]
    for ci, (n, a) in enumerate(cases):
        arrays = on(dev, random_queue(np.random.RandomState(args.seed * 1000 + ci), n, a))
        for evenly in (False, True):
            got = qk.fifo_queue(*arrays, evenly=evenly)
            want = qk.solve_queue_plain(*arrays, evenly=evenly)
            torch.cuda.synchronize()
            err = compare(got, want)
            max_err[evenly] = max(max_err[evenly], err)
            if err:
                raise SystemExit(f"kernel != plain at N={n} A={a} evenly={evenly} (max |diff| {err})")
        log(f"phase kernel-vs-plain: N={n} A={a} equal (shared bytes {qk.shared_bytes(n, dev)})")

    # ---- phase 4: main path at full size
    t0 = time.perf_counter()
    metadata, earlier, skip, currents = build_snapshot(args.seed)
    driver_order, executor_order = NodeSorter().potential_nodes(metadata, list(metadata))
    log(f"phase main-path: snapshot {len(metadata)} nodes x {len(earlier)} queued apps "
        f"built in {time.perf_counter() - t0:.2f} s")
    n_checked = small_oracle_check(args.seed)
    log(f"phase main-path: {n_checked} small-snapshot FIFO decisions equal the host oracles")

    policies = ("tightly-pack", "distribute-evenly")
    solvers = {p: TpuFifoSolver(assignment_policy=p, device="cuda") for p in policies}
    cpu_solvers = {p: TpuFifoSolver(assignment_policy=p, device="cpu") for p in policies}
    qk.reset_launch_counts()
    solve_ms = {p: [] for p in policies}
    decisions = {p: [] for p in policies}
    for p in policies:
        for current in currents[:DECISIONS]:
            t = time.perf_counter()
            out = solvers[p].solve(metadata, driver_order, executor_order, earlier, skip, current)
            torch.cuda.synchronize()
            solve_ms[p].append((time.perf_counter() - t) * 1e3)
            decisions[p].append(outcome_key(out))
            if solvers[p].last_queue_lane != "cuda":
                raise SystemExit(f"queue pass ran on lane {solvers[p].last_queue_lane!r}, not cuda")
    binpacker = select_binpacker("tpu-batch", device="cuda")
    cur = currents[0]
    bp_args = (cur.driver_resources, cur.executor_resources, cur.min_executor_count,
               driver_order, executor_order, metadata)
    bp = binpacker.binpack_func(*bp_args)
    torch.cuda.synchronize()
    launches = dict(qk.launch_counts)
    log(f"phase main-path: launches {launches}")
    for kname, count in launches.items():
        if count < 1:
            raise SystemExit(f"{kname} was not launched on the main path")

    # the same decisions on the CPU (the plain versions)
    for p in policies:
        for i, current in enumerate(currents[:DECISIONS]):
            want = outcome_key(
                cpu_solvers[p].solve(metadata, driver_order, executor_order, earlier, skip, current)
            )
            if decisions[p][i] != want:
                raise SystemExit(f"{p} decision {i} on cuda differs from cpu: {decisions[p][i]} vs {want}")
            if not want[1] or not want[2][0]:
                raise SystemExit(f"{p} decision {i} placed nothing: {want}")
        log(f"phase main-path: {p} {DECISIONS} decisions equal on cuda and cpu "
            f"(first driver {decisions[p][0][2][1]}, {len(decisions[p][0][2][2])} executors)")
    bp_cpu = select_binpacker("tpu-batch", device="cpu").binpack_func(*bp_args)
    if (bp.has_capacity, bp.driver_node, bp.executor_nodes) != (
        bp_cpu.has_capacity, bp_cpu.driver_node, bp_cpu.executor_nodes
    ) or not bp.has_capacity:
        raise SystemExit("tpu-batch binpack_func on cuda differs from cpu or placed nothing")
    log(f"phase main-path: tpu-batch binpack_func equal on cuda and cpu (driver {bp.driver_node})")

    # the queue pass alone, at the main path's shapes and inputs
    cluster = tensorize_cluster(metadata, driver_order, executor_order)
    problem = scale_problem(cluster, solvers["tightly-pack"]._tensorize_with_cache(earlier, currents[0]))
    valid = problem.app_valid.copy()
    valid[len(earlier):] = False
    queue_args = on(dev, (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver,
                          problem.executor, problem.count, valid))
    n_b, a_b = problem.avail.shape[0], problem.driver.shape[0]
    kernels = []
    for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly")):
        got = qk.fifo_queue(*queue_args, evenly=evenly)
        want = qk.solve_queue_plain(*queue_args, evenly=evenly)
        err = compare(got, want)
        if err:
            raise SystemExit(f"{kname} != plain on the main-path inputs (max |diff| {err})")
        max_err[evenly] = max(max_err[evenly], err)
        ms = [time_cuda(lambda: qk.fifo_queue(*queue_args, evenly=evenly), 5) for _ in range(3)]
        plain_ms = time_cuda(lambda: qk.solve_queue_plain(*queue_args, evenly=evenly), 1)
        n_valid = int(valid.sum())
        n_feasible = int(got[0].sum())
        bytes_once = 4 * (3 * n_b + n_b) + n_b + a_b * (4 * 3 * 2 + 4 + 1) + a_b * (1 + 4) + 4 * 3 * n_b
        ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * OPS_PER_NODE_FEASIBLE_APP)
        t_bytes, t_ops = bytes_once / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        # the serial floor: the same queue on the first FLOOR_NODES nodes,
        # one node a thread, so each app costs little more than its three
        # block reductions in sequence
        floor_args = tuple(x[:FLOOR_NODES] for x in queue_args[:3]) + queue_args[3:]
        floor_ms = time_cuda(lambda: qk.fifo_queue(*floor_args, evenly=evenly), 5)
        floor_feasible = int(qk.fifo_queue(*floor_args, evenly=evenly)[0].sum())
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches[kname], "max_abs_err": max_err[evenly],
            "ms": statistics.median(ms), "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None,
        })
        log(f"phase main-path: {kname} queue pass N={n_b} A={a_b} ({n_valid} valid, {n_feasible} "
            f"feasible): {statistics.median(ms):.3f} ms (runs {', '.join(f'{x:.3f}' for x in ms)}), "
            f"plain {plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}), serial floor at N={FLOOR_NODES} {floor_ms:.3f} ms "
            f"({floor_feasible} feasible) | {smi}")
    for p in policies:
        log(f"phase main-path: {p} TpuFifoSolver.solve median {statistics.median(solve_ms[p]):.1f} ms "
            f"(runs {', '.join(f'{x:.1f}' for x in solve_ms[p])}) | {smi}")

    # where a Filter decision's time goes (host clock, tightly-pack):
    # tensorizing the cluster, the solve with vectorized efficiency rows,
    # and the solve with exact Quantity efficiencies (what solve() runs)
    solver = solvers["tightly-pack"]
    parts = {"tensorize_cluster": [], "solve_tensor_rows": [], "solve_tensor_metadata": []}
    for _ in range(3):
        t = time.perf_counter()
        cluster = tensorize_cluster(metadata, driver_order, executor_order)
        parts["tensorize_cluster"].append((time.perf_counter() - t) * 1e3)
        for key, meta in (("solve_tensor_rows", None), ("solve_tensor_metadata", metadata)):
            t = time.perf_counter()
            solver.solve_tensor(cluster, earlier, skip, currents[0], metadata=meta)
            torch.cuda.synchronize()
            parts[key].append((time.perf_counter() - t) * 1e3)
    log("phase main-path: breakdown (median ms) " + ", ".join(
        f"{k} {statistics.median(v):.1f}" for k, v in parts.items()) + f" | {smi}")
    busy_ms, wall_ms = traced_device_time(
        lambda: solver.solve(metadata, driver_order, executor_order, earlier, skip, currents[0])
    )
    share = "not measured (no device events in the trace)" if busy_ms is None else (
        f"device busy {busy_ms:.3f} ms of {wall_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.2f} %")
    log(f"phase main-path: profiler trace of one tightly-pack solve: {share} | {smi}")

    # ---- phase 5: results
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
