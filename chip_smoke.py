"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name, CUDA version, name and power limit;
2. build: the three kernels from ``ops/csrc/`` (queue_kernel.cu,
   minfrag_kernel.cu, single_az_kernel.cu; one nvcc each, all started
   together, sm_90a);
3. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, on randomized queues (ragged N, k = 0, zero-resource
   executors, negative availability, invalid apps, zone id -1, a problem
   too large for shared memory, more than 127 zones) and at 10,240 nodes ×
   1,024 apps (3 zones for the single-AZ kernel), every variant; also 10,240
   nodes in one zone, 12,345 in one zone, 4,000 zones, 3 zones with
   one empty, 9 and 17 zones, an az-aware queue where many apps take the
   cross-zone solve, min-frag queues where the pass's largest capacity is
   above k and below it; the queue kernel also on 7 nodes (fewer than its
   cluster's blocks), on 100,000 (its node planes in global scratch) and
   on values near the int32 range (availabilities near 2^31 - 1, large,
   odd and power-of-two requests, gangs whose capacity sums wrap), with
   its cluster size, threads and shared bytes a block; outputs are
   integers and must be exactly equal;
4. main path: Filter decisions on a 10,000-node cluster in 3 zones with a
   1,000-deep pending queue, on the card and equal to the same calls on
   the CPU: ``TpuFifoSolver`` tightly-pack, distribute-evenly and
   minimal-fragmentation, ``TpuSingleAzFifoSolver`` single-AZ tightly-pack,
   az-aware and single-AZ minimal-fragmentation; one ``binpack_func`` call
   of every ``tpu-batch*`` binpacker; small snapshots checked against the
   host oracles' sequential FIFO loop for each policy; each policy's
   kernel launch counts, zeroed just before its decisions and read just
   after; each kernel's time, bound and serial floor at the main path's inputs, the apps that take
   the az-aware cross-zone solve, each variant's cluster size and threads,
   and ptxas's registers and spills for each kernel instantiation; decision breakdowns and the device's busy
   time in profiler traces of single decisions;
5. server: the port's Filter server on the card — ``init_server_with_clients``
   (binpack ``tpu-batch``, then ``tpu-batch-distribute-evenly``, fifo) with
   ``ExtenderHTTPServer`` on port 0, bench.py's headline HTTP snapshot
   (10,000 nodes in 3 zones, allocatable 4–96 CPU / 8–256 Gi, 1,000 queued
   drivers of 1–32 executors of 1–8 CPU / 2–16 Gi) rebuilt from ``--seed``;
   2 warmup and 24 timed ``POST /predicates`` probes with all 10,000 node
   names, each retired and settled before the next; every response body
   equal to the same probe on a ``device="cpu"`` server fed the same
   objects, every timed probe on the tensor lane (``lane=fast``) with the
   CUDA queue kernel (one launch a probe); for 3 granted probes the driver
   is bound and every executor POSTed, each granted its reserved node;
   request latency p50 / p99, span medians and the device's idle share in
   a profiler trace of one request;
6. the kernels line (times, bounds, launches) and the device result line.

Needs CUDA: without it the script exits with an error before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BIG = 2**31 - 1
N_NODES, N_APPS, N_ZONES = 10_000, 1_000, 3  # the main path's cluster and queue depth
DECISIONS = 3  # Filter decisions per tightly-pack / distribute-evenly policy on the main path
NEW_DECISIONS = 2  # Filter decisions per min-frag / single-AZ policy on the main path
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
# the min-frag drain per node for each feasible app, instead of the fill,
# counting only the work its result needs: the unclamped capacity from the
# gang core's quotients (2 selects) and its maximum (1), the two passes'
# totals (2 compares, 2 mins, 2 adds), v* of the placing pass by a radix
# selection (4 rounds of 8 bits, each a digit extract, a prefix compare and
# a histogram add), the drained sum and class count (4), the final
# placement's key (6), the counts (4), the carry update (3)
MF_OPS_PER_NODE_FEASIBLE_APP = 2 + 1 + 6 + 4 * 3 + 4 + 6 + 4 + 3
FLOOR_NODES = 1024  # one node a thread: the kernel's serial per-app floor

CSRC = "k8s_spark_scheduler_tpu_torch/ops/csrc/"
PALLAS = "k8s_spark_scheduler_tpu/ops/pallas_queue.py:"
SOURCES = {"queue": CSRC + "queue_kernel.cu", "min_frag": CSRC + "minfrag_kernel.cu",
           "single_az": CSRC + "single_az_kernel.cu"}
REPLACES = {"queue": PALLAS + "681", "min_frag": PALLAS + "614", "single_az": PALLAS + "525"}
# (az_aware, minfrag) of each single-AZ kernel variant
SINGLE_AZ = {"fifo_queue_single_az_tightly": (False, False),
             "fifo_queue_single_az_az_aware": (True, False),
             "fifo_queue_single_az_min_frag": (False, True)}
# the kernel (variant) each main-path policy's queue pass launches
POLICY_KERNEL = {"tightly-pack": "fifo_queue_tightly", "distribute-evenly": "fifo_queue_evenly",
                 "minimal-fragmentation": "fifo_queue_min_frag",
                 "single-az-tightly-pack": "fifo_queue_single_az_tightly",
                 "az-aware-tightly-pack": "fifo_queue_single_az_az_aware",
                 "single-az-minimal-fragmentation": "fifo_queue_single_az_min_frag"}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(xs) -> str:
    return f"{statistics.median(xs):.1f} ms (runs {', '.join(f'{x:.1f}' for x in xs)})"


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


def random_queue_large(rng: np.random.RandomState, n: int, a: int):
    """random_queue with values near the int32 range, as GCD-scaled
    quantities reach it: availabilities near 2^31 - 1 (some anywhere in
    int32), large, odd and power-of-two requests, large drivers, and some
    gangs of up to 2^31 - 1 executors, so capacity sums and prefixes wrap."""
    _, rank, exec_ok, _, _, _, valid = random_queue(rng, n, a)
    avail = BIG - rng.randint(0, 2**16, size=(n, 3)).astype(np.int64)
    spread = rng.rand(n, 3) < 0.3
    avail[spread] = rng.randint(-(2**31), BIG, size=int(spread.sum()))
    choices = np.array([1, 2, 3, 7, 2**16, 2**20, 2**30, BIG, BIG - 1, 12345677, 1000003])
    executors = np.where(rng.rand(a, 3) < 0.5, rng.choice(choices, size=(a, 3)),
                         rng.randint(1, BIG, size=(a, 3)))
    executors[rng.rand(a, 3) < 0.1] = 0
    drivers = rng.randint(0, 2**30, size=(a, 3))
    counts = np.where(rng.rand(a) < 0.3, rng.randint(0, BIG, size=a), rng.randint(0, 40, size=a))
    return (avail.astype(np.int32), rank, exec_ok, drivers.astype(np.int32),
            executors.astype(np.int32), counts.astype(np.int32), valid)


def queue_layout(qk, n: int, device) -> str:
    """The queue kernel's launch for n nodes, for the log."""
    lay = qk.layout(n, device)
    where = "in shared memory" if lay.segment_bytes else "in global scratch"
    return (f"cluster of {lay.blocks} blocks of {lay.threads} threads, "
            f"{lay.segment_bytes + lay.static_bytes} shared bytes a block, node planes {where}")


def random_single_az_queue(rng: np.random.RandomState, n: int, a: int, n_zones: int):
    """A raw single-AZ queue: random_queue's problem plus zone ids from -1
    (no zone) to n_zones - 1 and schedulable columns (cpu and gpu in units
    of 1000 milli, memory in scaled units), some nodes gpu-less.  Returns
    (twelve arrays, (scale_cpu, scale_gpu, n_zones))."""
    avail, rank, exec_ok, drivers, executors, counts, valid = random_queue(rng, n, a)
    zone_id = rng.randint(-1, max(n_zones, 1), size=n).astype(np.int32)
    sched = np.maximum(avail, 0) + rng.randint(0, 16, size=(n, 3))
    sched[:, :2] = np.maximum(sched[:, :2], 1)
    s_cpu = (sched[:, 0] * 1000).astype(np.int32)
    s_gpu = np.where(rng.rand(n) < 0.5, sched[:, 2] * 1000, 0).astype(np.int32)
    inv_mem = (1.0 / sched[:, 1].astype(np.float64)).astype(np.float32)
    th_mem = sched[:, 1].astype(np.int32)
    arrays = (avail, rank, exec_ok, zone_id, drivers, executors, counts, valid,
              s_cpu, s_gpu, inv_mem, th_mem)
    return arrays, (1000, 1000, n_zones)


def on(device, arrays):
    return tuple(torch.as_tensor(x, device=device) for x in arrays)


def compare(kernel_out, plain_out) -> int:
    """Max absolute difference over the outputs (booleans as 0/1)."""
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


# -- phase 5: the Filter server -------------------------------------------------

SERVER_POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly")
SERVER_WARMUP_PROBES, SERVER_TIMED_PROBES, SERVER_EXECUTOR_CHECKS = 2, 24, 3
SERVER_SPANS = ("http.read", "serde.decode", "predicate", "fast_path.build_tensor", "fifo_gate",
                "kernel:fifo_queue", "binpack", "serde.encode", "http.request")


def server_objects(seed: int):
    """bench.py's headline HTTP snapshot (bench.py:1533-1562) in the
    port's types, from `seed`: node names, 10,000 nodes in 3 zones with
    allocatable 4–96 CPU / 8–256 Gi, 1,000 queued drivers of 1–32
    executors of 1–8 CPU / 2–16 Gi created a second apart, the probe
    generator's random state and the queue's base creation time."""
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu_torch.types.resources import ZONE_LABEL, Resources

    rng = np.random.RandomState(seed + 5)
    names, nodes = [], []
    for i in range(N_NODES):
        name = f"n{i:05d}"
        names.append(name)
        nodes.append(Node(
            meta=ObjectMeta(name=name, labels={ZONE_LABEL: f"z{i % N_ZONES}",
                                               "resource_channel": "batch-medium-priority"}),
            allocatable=Resources.of(str(int(rng.randint(4, 96))), f"{int(rng.randint(8, 256))}Gi"),
        ))
    base = time.time() - 10_000.0
    queue = [
        Harness.static_allocation_spark_pods(
            f"queue-{i:04d}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
            executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=base + i,
        )[0]
        for i in range(N_APPS)
    ]
    return names, nodes, queue, rng, base


class PortServer:
    """The port's server on its own embedded API server, serving HTTP on
    an ephemeral port."""

    def __init__(self, policy: str, device: str, nodes, queue):
        from k8s_spark_scheduler_tpu_torch.config import Install
        from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
        from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
        from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
        from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

        self.api = APIServer()
        self.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        self.scheduler = init_server_with_clients(
            self.api, Install(binpack_algo=policy, fifo=True), demand_poll_interval=0.5, device=device
        )
        self.http = None
        try:
            for obj in nodes + queue:
                self.api.create(obj.deepcopy())
            self.http = ExtenderHTTPServer(self.scheduler, port=0, host="127.0.0.1")
            self.http.start()
            if not self.scheduler.wait_ready(timeout=600.0):
                raise SystemExit(f"the {device} server did not become ready")
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        if self.http is not None:
            self.http.stop()
        self.scheduler.stop()

    def post(self, pod, names):
        """(ms on the host clock, status, body bytes) of one Filter of the
        pod as this server's API stores it."""
        import urllib.error
        import urllib.request

        from k8s_spark_scheduler_tpu_torch.types import serde

        stored = self.api.get("Pod", pod.namespace, pod.name)
        data = json.dumps({"Pod": serde.pod_to_dict(stored), "NodeNames": names}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.http.port}/predicates", data=data,
                                     headers={"Content-Type": "application/json"}, method="POST")
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as err:
            status, body = err.code, err.read()
        return (time.perf_counter() - t) * 1e3, status, body

    def reserved_node(self, pod) -> str:
        rr = self.scheduler.resource_reservation_cache.get(pod.namespace, pod.labels["spark-app-id"])
        for key, pod_name in rr.status.pods.items():
            if pod_name == pod.name:
                return rr.spec.reservations[key].node
        raise SystemExit(f"no reservation holds {pod.name}")

    def bind(self, pod, node: str) -> None:
        stored = self.api.get("Pod", pod.namespace, pod.name)
        stored.node_name, stored.phase = node, "Running"
        self.api.update(stored)

    def retire(self, pods) -> None:
        """The app-finished flow: delete its pods (owner GC collects the
        reservation) and wait until the reservation cache dropped it."""
        for pod in pods:
            self.api.delete("Pod", pod.namespace, pod.name)
        app_id = pods[0].labels["spark-app-id"]
        deadline = time.monotonic() + 30.0
        while self.scheduler.resource_reservation_cache.get(pods[0].namespace, app_id) is not None:
            if time.monotonic() > deadline:
                raise SystemExit(f"the reservation of {app_id} was not collected")
            time.sleep(0.002)

    def fast_lane_count(self) -> float:
        from k8s_spark_scheduler_tpu_torch.metrics import names as mnames

        return self.scheduler.metrics.get_counter(mnames.TPU_FASTPATH, {"path": "driver", "lane": "fast"})


def span_durations(span: dict, out: dict) -> dict:
    out.setdefault(span["name"], []).append(span["durationMs"])
    for child in span.get("children", ()):
        span_durations(child, out)
    return out


def server_phase(seed: int, smi: str) -> None:
    """Phase 5 (see the module docstring); raises SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        log(f"phase server: snapshot {len(nodes)} nodes in {N_ZONES} zones, {len(queue)} queued drivers "
            f"built in {time.perf_counter() - t0:.2f} s")
        for pi, policy in enumerate(SERVER_POLICIES):
            t0 = time.perf_counter()
            servers = {}
            try:
                for device in ("cuda", "cpu"):
                    servers[device] = PortServer(policy, device, nodes, queue)
                log(f"phase server: {policy}: cuda and cpu servers ready in {time.perf_counter() - t0:.2f} s")
                card = servers["cuda"]
                solver = card.scheduler.extender.binpacker.queue_solver
                kname = "fifo_queue_evenly" if policy.endswith("distribute-evenly") else "fifo_queue_tightly"
                lat_ms, traces, granted, exec_checked = [], [], 0, 0
                n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
                for i in range(n_probes):
                    timed = i >= SERVER_WARMUP_PROBES
                    if i == SERVER_WARMUP_PROBES:
                        qk.reset_launch_counts()  # the timed probes' run starts here
                    pods = Harness.static_allocation_spark_pods(
                        f"probe-{pi}-{i:03d}", int(rng.randint(1, 32)),
                        executor_cpu=str(int(rng.randint(1, 8))),
                        executor_mem=f"{int(rng.randint(2, 16))}Gi",
                        creation_timestamp=base + N_APPS + i,
                    )
                    created = pods[:1]
                    for server in servers.values():
                        server.api.create(pods[0].deepcopy())
                    fast_before = card.fast_lane_count()
                    ms, status, body = card.post(pods[0], names)
                    if timed:
                        lat_ms.append(ms)
                        traces.append(card.scheduler.tracer.traces(limit=1)[0])
                    _, cpu_status, cpu_body = servers["cpu"].post(pods[0], names)
                    if (status, body) != (cpu_status, cpu_body) or status != 200:
                        raise SystemExit(f"{policy} probe {i}: cuda answered {status} {body[:300]!r}, "
                                         f"cpu {cpu_status} {cpu_body[:300]!r}")
                    if card.fast_lane_count() != fast_before + 1 or solver.last_queue_lane != "cuda":
                        raise SystemExit(f"{policy} probe {i} did not take the tensor lane with the CUDA "
                                         f"kernel (queue lane {solver.last_queue_lane!r})")
                    result = json.loads(body)
                    if result["NodeNames"]:
                        granted += 1
                        if timed and exec_checked < SERVER_EXECUTOR_CHECKS:
                            exec_checked += 1
                            for server in servers.values():
                                server.bind(pods[0], result["NodeNames"][0])
                            for pod in pods[1:]:
                                created.append(pod)
                                for server in servers.values():
                                    server.api.create(pod.deepcopy())
                                _, e_status, e_body = card.post(pod, names)
                                _, c_status, c_body = servers["cpu"].post(pod, names)
                                e_nodes = json.loads(e_body).get("NodeNames") if e_status == 200 else None
                                if (e_status, e_body) != (c_status, c_body) or not e_nodes:
                                    raise SystemExit(f"{policy} executor {pod.name}: cuda {e_status} "
                                                     f"{e_body[:300]!r}, cpu {c_status} {c_body[:300]!r}")
                                if e_nodes[0] != card.reserved_node(pod):
                                    raise SystemExit(f"{policy} executor {pod.name} placed on {e_nodes[0]}, "
                                                     f"reserved {card.reserved_node(pod)}")
                            log(f"phase server: {policy}: probe {i} bound on {result['NodeNames'][0]}; "
                                f"its {len(pods) - 1} executors each granted their reserved node, "
                                f"equal on cuda and cpu")
                    for server in servers.values():
                        server.retire(created)
                launches = qk.launch_counts[kname]
                if launches != SERVER_TIMED_PROBES:
                    raise SystemExit(f"{policy}: {launches} {kname} launches for {SERVER_TIMED_PROBES} timed probes")
                if exec_checked < SERVER_EXECUTOR_CHECKS:
                    raise SystemExit(f"{policy}: only {exec_checked} granted probes to check executors on")
                log(f"phase server: {policy}: {n_probes} probes equal on cuda and cpu, {granted} granted, "
                    f"all on lane=fast with the cuda queue kernel; {kname} launches in the timed run "
                    f"{launches} (one a probe)")
                log(f"phase server: {policy}: /predicates at {N_NODES} nodes x {N_APPS} queued drivers: "
                    f"p50 {statistics.median(lat_ms):.3f} ms, p99 {float(np.percentile(lat_ms, 99)):.3f} ms "
                    f"over {len(lat_ms)} probes (runs {', '.join(f'{x:.1f}' for x in lat_ms)}) | {smi}")
                spans = {}
                for trace in traces:
                    span_durations(trace["root"], spans)
                log(f"phase server: {policy}: span medians (ms) " + ", ".join(
                    f"{name} {statistics.median(spans[name]):.3f}" for name in SERVER_SPANS if name in spans
                ) + f" | {smi}")
                missing = [name for name in SERVER_SPANS if name not in spans]
                if missing:
                    raise SystemExit(f"{policy}: the request traces lack spans {missing}")
                pods = Harness.static_allocation_spark_pods(
                    f"probe-{pi}-traced", 4, creation_timestamp=base + N_APPS + n_probes)
                card.api.create(pods[0].deepcopy())
                share = busy_share(lambda: card.post(pods[0], names))
                card.retire(pods[:1])
                log(f"phase server: {policy}: profiler trace of one /predicates request: {share} | {smi}")
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        logging.disable(logging.NOTSET)


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
            zone_label=f"z{i % N_ZONES}",
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


def busy_share(fn) -> str:
    busy_ms, wall_ms = traced_device_time(fn)
    if busy_ms is None:
        return "not measured (no device events in the trace)"
    return f"device busy {busy_ms:.3f} ms of {wall_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.2f} %"


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


def fifo_solvers(device: str):
    """The main path's FIFO solvers by policy name, on `device`."""
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver

    return {
        "tightly-pack": TpuFifoSolver("tightly-pack", device=device),
        "distribute-evenly": TpuFifoSolver("distribute-evenly", device=device),
        "minimal-fragmentation": TpuFifoSolver("minimal-fragmentation", device=device),
        "single-az-tightly-pack": TpuSingleAzFifoSolver(device=device),
        "az-aware-tightly-pack": TpuSingleAzFifoSolver(az_aware=True, device=device),
        "single-az-minimal-fragmentation": TpuSingleAzFifoSolver(
            inner_policy="minimal-fragmentation", device=device
        ),
    }


def small_oracle_check(seed: int) -> int:
    """FIFO decisions on the card against the host oracles on small
    random snapshots, for every policy; returns the number of decisions
    checked."""
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain
    from k8s_spark_scheduler_tpu_torch.ops import packers
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter

    oracles = {
        "tightly-pack": packers.tightly_pack,
        "distribute-evenly": packers.distribute_evenly,
        "minimal-fragmentation": packers.minimal_fragmentation_pack,
        "single-az-tightly-pack": packers.single_az_tightly_pack,
        "az-aware-tightly-pack": packers.az_aware_tightly_pack,
        "single-az-minimal-fragmentation": packers.single_az_minimal_fragmentation,
    }
    rng = random.Random(seed)
    checked = 0
    for policy, solver in fifo_solvers("cuda").items():
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
            want = host_fifo(metadata, driver_order, executor_order, earlier, skip, current, oracles[policy])
            got = outcome_key(
                solver.solve(metadata, driver_order, executor_order, earlier, skip, current)
            )
            if got != want:
                raise SystemExit(f"small-snapshot {policy} decision differs from the host oracle: {got} vs {want}")
            checked += 1
    return checked


def ptxas_report(build_log: str):
    """(kernel<template arguments>, registers, spill stores) for each entry
    function in nvcc's -Xptxas=-v output."""
    out, entry, spills = [], None, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(\d+)(fifo_queue\w*?_kernel)I(\w*?)EEv", line)
        if m:
            entry = f"{m.group(2)}<{','.join(re.findall(r'L[bi](\d+)E', m.group(3) + 'E'))}>"
        elif "spill stores" in line:
            spills = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "Used" in line and "registers" in line and entry:
            out.append((entry, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            entry = None
    return out


def kernel_entry(name, kind, launches, max_err, ms, plain_ms, t_bytes, t_ops):
    return {
        "name": name, "route": "cuda", "source": SOURCES[kind], "replaces": REPLACES[kind],
        "launches": launches, "max_abs_err": max_err,
        "ms": statistics.median(ms), "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2

    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk
    from k8s_spark_scheduler_tpu_torch.ops.batch_adapter import candidate_zone_masks
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import single_az_queue_inputs
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter
    from k8s_spark_scheduler_tpu_torch.ops.registry import TPU_BATCH_NAMES, select_binpacker
    from k8s_spark_scheduler_tpu_torch.ops.tensorize import scale_problem, tensorize_cluster

    dev = torch.device("cuda")
    t_script = time.perf_counter()
    # ---- phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    log(f"phase device: {name} | torch {torch.__version__} | cuda {torch.version.cuda} | {smi}")

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    libraries = {"queue": qk.LIBRARY, "min_frag": mk.LIBRARY, "single_az": sk.LIBRARY}
    with ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib.load) for lib in libraries.values()]:
            future.result()
    log(f"phase build: {len(libraries)} kernels ready in {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: kernel vs plain on the card
    max_err = {"fifo_queue_tightly": 0, "fifo_queue_evenly": 0, "fifo_queue_min_frag": 0}
    max_err.update({kname: 0 for kname in SINGLE_AZ})

    def check(kname, got, want, where):
        torch.cuda.synchronize()
        err = compare(got, want)
        max_err[kname] = max(max_err[kname], err)
        if err:
            raise SystemExit(f"{kname} != plain at {where} (max |diff| {err})")

    def check_min_frag(arrays, where):
        check("fifo_queue_min_frag", mk.fifo_queue_min_frag(*arrays), mk.solve_queue_min_frag_plain(*arrays),
              where)

    def check_single_az(arrays, scalars, where):
        """Every variant, both strict values for min-frag."""
        for kname, (az_aware, minfrag) in SINGLE_AZ.items():
            for strict in ((True, False) if minfrag else (True,)):
                flags = dict(az_aware=az_aware, minfrag=minfrag, strict=strict)
                check(kname, sk.fifo_queue_single_az(*arrays, *scalars, **flags),
                      sk.solve_queue_single_az_plain(*arrays, *scalars, **flags), f"{where} strict={strict}")

    cases = [(2, 5), (31, 17), (100, 40), (129, 64), (300, 100), (1000, 200), (4099, 64),
             (12345, 48), (10240, 1024)]
    for ci, (n, a) in enumerate(cases):
        arrays = on(dev, random_queue(np.random.RandomState(args.seed * 1000 + ci), n, a))
        for evenly in (False, True):
            check("fifo_queue_evenly" if evenly else "fifo_queue_tightly",
                  qk.fifo_queue(*arrays, evenly=evenly), qk.solve_queue_plain(*arrays, evenly=evenly),
                  f"N={n} A={a}")
        check_min_frag(arrays, f"N={n} A={a}")
        log(f"phase kernel-vs-plain: queue and min-frag kernels N={n} A={a} equal "
            f"(queue kernel: {queue_layout(qk, n, dev)})")
    # the queue kernel on fewer nodes than its cluster has blocks, above the
    # cluster's shared memory (global scratch), and near the int32 range
    queue_cases = [("N=7 A=20", random_queue, 7, 20), ("N=100000 A=32", random_queue, 100000, 32),
                   ("large values N=7 A=20", random_queue_large, 7, 20),
                   ("large values N=3000 A=128", random_queue_large, 3000, 128),
                   ("large values N=10240 A=256", random_queue_large, 10240, 256),
                   ("large values N=100000 A=16", random_queue_large, 100000, 16)]
    for ci, (what, make, n, a) in enumerate(queue_cases):
        arrays = on(dev, make(np.random.RandomState(args.seed * 1000 + 900 + ci), n, a))
        for evenly in (False, True):
            check("fifo_queue_evenly" if evenly else "fifo_queue_tightly",
                  qk.fifo_queue(*arrays, evenly=evenly), qk.solve_queue_plain(*arrays, evenly=evenly), what)
        log(f"phase kernel-vs-plain: queue kernel {what} equal ({queue_layout(qk, n, dev)})")
    # min-frag queues whose apps ask for 1-4 executors (the placing pass's
    # largest capacity reaches k) or 100-300 (capacities stay under 64 < k)
    for ci, (n, a) in enumerate([(3000, 256), (10240, 256)]):
        rng = np.random.RandomState(args.seed * 1000 + 300 + ci)
        arrays = random_queue(rng, n, a)
        arrays[4][:] = rng.randint(1, 9, size=(a, 3))
        arrays[5][:] = np.where(rng.rand(a) < 0.5, rng.randint(1, 5, size=a), rng.randint(100, 300, size=a))
        check_min_frag(on(dev, arrays), f"m >= k and m < k, N={n} A={a}")
        log(f"phase kernel-vs-plain: min-frag kernel, k in 1-4 and 100-300, N={n} A={a} equal")
    # 200 and 150 zones: many zones a block; one zone over 12,345 nodes:
    # that block's node planes in global memory; 4,000 zones: the zone
    # table in global memory
    az_cases = [(2, 5, 1), (31, 17, 0), (129, 64, 2), (1000, 200, 3), (4099, 64, 3),
                (12345, 48, 3), (1000, 24, 200), (12345, 8, 150), (10800, 8, 3),
                (12345, 16, 1), (12000, 4, 4000), (10240, 1024, 3)]
    for ci, (n, a, zones) in enumerate(az_cases):
        arrays, scalars = random_single_az_queue(np.random.RandomState(args.seed * 1000 + 500 + ci), n, a, zones)
        arrays = on(dev, arrays)
        check_single_az(arrays, scalars, f"N={n} A={a} zones={zones}")
        log(f"phase kernel-vs-plain: single-AZ kernel, {len(SINGLE_AZ)} variants, N={n} A={a} "
            f"zones={zones} equal (cluster {sk.zone_layout(arrays[3], zones).cluster})")
    # zone layouts the main path does not take: one zone holding every
    # node, an empty zone, more zones than the cluster has blocks
    layouts = {
        "1 zone holds every node": (1, lambda rng, n: np.zeros(n, np.int32)),
        "3 zones, zone 1 empty": (3, lambda rng, n: rng.choice([0, 2], size=n).astype(np.int32)),
        "9 zones": (9, lambda rng, n: rng.randint(0, 9, size=n).astype(np.int32)),
        "17 zones": (17, lambda rng, n: rng.randint(-1, 17, size=n).astype(np.int32)),
    }
    for ci, (what, (zones, zone_ids)) in enumerate(layouts.items()):
        rng = np.random.RandomState(args.seed * 1000 + 700 + ci)
        arrays, scalars = random_single_az_queue(rng, 10240, 64, zones)
        arrays[3][:] = zone_ids(rng, 10240)
        arrays = on(dev, arrays)
        check_single_az(arrays, scalars, f"{what}, N=10240 A=64")
        log(f"phase kernel-vs-plain: single-AZ kernel, {what}, N=10240 A=64 equal "
            f"(cluster {sk.zone_layout(arrays[3], zones).cluster})")
    # an az-aware queue where many apps fit no single zone: 150 zones of
    # about 20 nodes and gangs of 60-150 executors
    rng = np.random.RandomState(args.seed * 1000 + 800)
    arrays, scalars = random_single_az_queue(rng, 3000, 128, 150)
    arrays[5][:] = rng.randint(1, 4, size=(128, 3))
    arrays[6][:] = rng.randint(60, 150, size=128)
    arrays = on(dev, arrays)
    check_single_az(arrays, scalars, "cross-zone queue N=3000 A=128 zones=150")
    az_want = sk.solve_queue_single_az_plain(*arrays, *scalars, az_aware=True)
    n_cross = int(((az_want[1] == 150) & az_want[0]).sum())
    if n_cross < 10:
        raise SystemExit(f"the cross-zone queue sent only {n_cross} apps to the cross-zone solve")
    log(f"phase kernel-vs-plain: single-AZ kernel, az-aware queue with {n_cross} of 128 apps on the "
        f"cross-zone solve, N=3000 zones=150 equal")

    # ---- phase 4: main path at full size
    t0 = time.perf_counter()
    metadata, earlier, skip, currents = build_snapshot(args.seed)
    driver_order, executor_order = NodeSorter().potential_nodes(metadata, list(metadata))
    log(f"phase main-path: snapshot {len(metadata)} nodes in {N_ZONES} zones x {len(earlier)} "
        f"queued apps built in {time.perf_counter() - t0:.2f} s")
    n_checked = small_oracle_check(args.seed)
    log(f"phase main-path: {n_checked} small-snapshot FIFO decisions equal the host oracles")

    solvers, cpu_solvers = fifo_solvers("cuda"), fifo_solvers("cpu")
    n_decisions = {p: DECISIONS if p in ("tightly-pack", "distribute-evenly") else NEW_DECISIONS
                   for p in solvers}
    solve_ms = {p: [] for p in solvers}
    decisions = {p: [] for p in solvers}
    paths = {p: [] for p in solvers}
    launches = {}  # kernel -> launches in the run of its policy's path
    for p, solver in solvers.items():
        # each policy's path is driven with every count at 0 and read just after
        for module in (qk, mk, sk):
            module.reset_launch_counts()
        for current in currents[: n_decisions[p]]:
            t = time.perf_counter()
            out = solver.solve(metadata, driver_order, executor_order, earlier, skip, current)
            torch.cuda.synchronize()
            solve_ms[p].append((time.perf_counter() - t) * 1e3)
            decisions[p].append(outcome_key(out))
            path = getattr(solver, "last_path", None) or solver.last_queue_lane
            paths[p].append(path)
            if path not in ("cuda", "fused", "host"):
                raise SystemExit(f"{p} queue pass ran on {path!r}, not on the card")
        counts = {**qk.launch_counts, **mk.launch_counts, **sk.launch_counts}
        log(f"phase main-path: {p} launches {counts}")
        kname = POLICY_KERNEL[p]
        if counts[kname] < 1:
            raise SystemExit(f"{kname} was not launched on the {p} path")
        launches[kname] = counts[kname]
    cur = currents[0]
    bp_args = (cur.driver_resources, cur.executor_resources, cur.min_executor_count,
               driver_order, executor_order, metadata)
    bp = {}
    for bname in TPU_BATCH_NAMES:
        bp[bname] = select_binpacker(bname, device="cuda").binpack_func(*bp_args)
    torch.cuda.synchronize()
    for p in solvers:
        log(f"phase main-path: {p} last path per decision {paths[p]}")

    # the same decisions on the CPU (the plain versions)
    for p, solver in cpu_solvers.items():
        for i, current in enumerate(currents[: n_decisions[p]]):
            want = outcome_key(solver.solve(metadata, driver_order, executor_order, earlier, skip, current))
            if decisions[p][i] != want:
                raise SystemExit(f"{p} decision {i} on cuda differs from cpu: {decisions[p][i]} vs {want}")
            if not want[1] or not want[2][0]:
                raise SystemExit(f"{p} decision {i} placed nothing: {want}")
        log(f"phase main-path: {p} {n_decisions[p]} decisions equal on cuda and cpu "
            f"(first driver {decisions[p][0][2][1]}, {len(decisions[p][0][2][2])} executors)")
    for bname, got in bp.items():
        want = select_binpacker(bname, device="cpu").binpack_func(*bp_args)
        if (got.has_capacity, got.driver_node, got.executor_nodes) != (
            want.has_capacity, want.driver_node, want.executor_nodes
        ) or not got.has_capacity:
            raise SystemExit(f"{bname} binpack_func on cuda differs from cpu or placed nothing")
        log(f"phase main-path: {bname} binpack_func equal on cuda and cpu (driver {got.driver_node})")

    # each kernel alone, at the main path's shapes and inputs
    cluster = tensorize_cluster(metadata, driver_order, executor_order)
    problem = scale_problem(cluster, solvers["tightly-pack"]._tensorize_with_cache(earlier, currents[0]))
    valid = problem.app_valid.copy()
    valid[len(earlier):] = False
    queue_args = on(dev, (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver,
                          problem.executor, problem.count, valid))
    n_b, a_b = problem.avail.shape[0], problem.driver.shape[0]
    n_valid = int(valid.sum())
    queue_bytes = 4 * (3 * n_b + n_b) + n_b + a_b * (4 * 3 * 2 + 4 + 1) + a_b * (1 + 4) + 4 * 3 * n_b

    def timed(kname, kind, fn, plain, floor_fn, ops, n_bytes):
        ms = [time_cuda(fn, 5) for _ in range(3)]
        plain_ms = time_cuda(plain, 1)
        floor_ms = time_cuda(floor_fn, 5)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        log(f"phase main-path: {kname} N={n_b} A={a_b} ({n_valid} valid): "
            f"{statistics.median(ms):.3f} ms (runs {', '.join(f'{x:.3f}' for x in ms)}), "
            f"plain {plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}), serial floor at N={FLOOR_NODES} {floor_ms:.3f} ms | {smi}")
        return kernel_entry(kname, kind, launches[kname], max_err[kname], ms, plain_ms, t_bytes, t_ops)

    kernels = []
    floor_args = tuple(x[:FLOOR_NODES] for x in queue_args[:3]) + queue_args[3:]
    for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly")):
        got = qk.fifo_queue(*queue_args, evenly=evenly)
        check(kname, got, qk.solve_queue_plain(*queue_args, evenly=evenly), "the main-path inputs")
        n_feasible = int(got[0].sum())
        ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * OPS_PER_NODE_FEASIBLE_APP)
        log(f"phase main-path: {kname}: {n_feasible} feasible; {queue_layout(qk, n_b, dev)}")
        kernels.append(timed(
            kname, "queue", lambda: qk.fifo_queue(*queue_args, evenly=evenly),
            lambda: qk.solve_queue_plain(*queue_args, evenly=evenly),
            lambda: qk.fifo_queue(*floor_args, evenly=evenly), ops, queue_bytes,
        ))

    got = mk.fifo_queue_min_frag(*queue_args)
    check("fifo_queue_min_frag", got, mk.solve_queue_min_frag_plain(*queue_args), "the main-path inputs")
    n_feasible = int(got[0].sum())
    log(f"phase main-path: fifo_queue_min_frag: {n_feasible} feasible; cluster of "
        f"{mk.CLUSTER_BLOCKS} blocks of {mk.THREADS} threads")
    ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * MF_OPS_PER_NODE_FEASIBLE_APP)
    kernels.append(timed(
        "fifo_queue_min_frag", "min_frag", lambda: mk.fifo_queue_min_frag(*queue_args),
        lambda: mk.solve_queue_min_frag_plain(*queue_args),
        lambda: mk.fifo_queue_min_frag(*floor_args), ops, queue_bytes,
    ))

    zones, zone_masks = candidate_zone_masks(driver_order, executor_order, metadata, cluster.node_names, n_b)
    inputs = single_az_queue_inputs(cluster, problem, zone_masks, len(zones), len(earlier))
    if inputs is None:
        raise SystemExit("the main-path snapshot is outside the fused single-AZ lane's bounds")
    az_arrays, az_scalars = on(dev, inputs[0]), inputs[1]
    per_node = (0, 1, 2, 3, 8, 9, 10, 11)  # the single-AZ arguments with a node axis
    az_floor = tuple(x[:FLOOR_NODES] if i in per_node else x for i, x in enumerate(az_arrays))
    az_bytes = 4 * 3 * n_b + 4 * n_b + n_b + n_b + 16 * n_b + a_b * 29 + a_b * 10 + 4 * 3 * n_b
    for kname, (az_aware, minfrag) in SINGLE_AZ.items():
        flags = dict(az_aware=az_aware, minfrag=minfrag, strict=True)
        got = sk.fifo_queue_single_az(*az_arrays, *az_scalars, **flags)
        check(kname, got, sk.solve_queue_single_az_plain(*az_arrays, *az_scalars, **flags),
              "the main-path inputs")
        n_placed, n_uncertain = int(got[0].sum()), int(got[3][: len(earlier)].sum())
        n_cross = int((got[1][: len(earlier)] == len(zones)).sum())
        log(f"phase main-path: {kname}: {n_placed} placed, {n_uncertain} of {len(earlier)} "
            f"queued apps uncertain, {n_cross} on the cross-zone solve; cluster of "
            f"{sk.zone_layout(az_arrays[3], len(zones)).cluster} blocks of {sk.THREADS} threads")
        # every app's zone solves (its zone compare and gang core on every
        # node), the placing zone's fill or drain and the carry update
        work = MF_OPS_PER_NODE_FEASIBLE_APP if minfrag else OPS_PER_NODE_FEASIBLE_APP
        ops = n_b * a_b * (len(zones) + OPS_PER_NODE_VALID_APP) + n_placed * (n_b // len(zones) * work + 3 * n_b)
        kernels.append(timed(
            kname, "single_az", lambda: sk.fifo_queue_single_az(*az_arrays, *az_scalars, **flags),
            lambda: sk.solve_queue_single_az_plain(*az_arrays, *az_scalars, **flags),
            lambda: sk.fifo_queue_single_az(*az_floor, *az_scalars, **flags), ops, az_bytes,
        ))
    for kind, lib in libraries.items():
        for entry, registers, spills in ptxas_report(lib.build_log):
            log(f"phase main-path: ptxas {kind} {entry}: {registers} registers, {spills} bytes spill stores")
    for p in solvers:
        log(f"phase main-path: {p} Filter decision median {median_ms(solve_ms[p])} | {smi}")

    # where a Filter decision's time goes (host clock): tensorizing the
    # cluster, the solve with vectorized efficiency rows, and the solve with
    # exact Quantity efficiencies (what solve() runs), for tightly-pack and
    # minimal-fragmentation; the single-AZ decision against its tensorizing
    for p in ("tightly-pack", "minimal-fragmentation"):
        solver = solvers[p]
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
        log(f"phase main-path: {p} breakdown (median ms) " + ", ".join(
            f"{k} {statistics.median(v):.1f}" for k, v in parts.items()) + f" | {smi}")
    t = time.perf_counter()
    tensorize_cluster(metadata, driver_order, executor_order)
    tensorize_ms = (time.perf_counter() - t) * 1e3
    log(f"phase main-path: single-az-minimal-fragmentation breakdown (ms): decision "
        f"{statistics.median(solve_ms['single-az-minimal-fragmentation']):.1f}, of which "
        f"tensorize_cluster {tensorize_ms:.1f} and the queue kernel "
        f"{kernels[-1]['ms']:.1f} (path {paths['single-az-minimal-fragmentation'][0]}) | {smi}")
    for p in ("tightly-pack", "minimal-fragmentation", "single-az-minimal-fragmentation"):
        share = busy_share(
            lambda: solvers[p].solve(metadata, driver_order, executor_order, earlier, skip, currents[0])
        )
        log(f"phase main-path: profiler trace of one {p} decision: {share} | {smi}")

    log(f"phase main-path: phases 1-4 took {time.perf_counter() - t_script:.1f} s")

    # ---- phase 5: the Filter server on the card
    t = time.perf_counter()
    server_phase(args.seed, smi)
    log(f"phase server: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase 6: results
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
