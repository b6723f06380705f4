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
   its cluster size, threads and shared bytes a block; the queue and
   min-frag kernels also with the refusal explainer's probe flags and
   usage output, and with the delta-solve session's checkpoint buffer
   (the carry before every stride-th queue position, from a nonzero
   queue position, slots past the buffer skipped); outputs are integers
   and must be exactly equal;
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
   and ptxas's registers and spills for each kernel instantiation; the
   explainer's launch at the main path's inputs (1,000 probes interleaved
   with the 1,000 earlier apps) against its plain version, with its time;
   decision breakdowns and the device's busy time in profiler traces of
   single decisions;
5. server: the port's Filter server on the card — ``init_server_with_clients``
   (binpack ``tpu-batch``, then ``tpu-batch-distribute-evenly``, then
   ``tpu-batch-minimal-fragmentation``, fifo, the reference's defaults:
   resilience, provenance and the delta-solve engine) with
   ``ExtenderHTTPServer`` on port 0, bench.py's headline HTTP snapshot
   (10,000 nodes in 3 zones, allocatable 4–96 CPU / 8–256 Gi, 1,000 queued
   drivers of 1–32 executors of 1–8 CPU / 2–16 Gi) rebuilt from ``--seed``;
   2 warmup and 24 timed ``POST /predicates`` probes with all 10,000 node
   names, each retired and settled before the next; every response body
   equal to the same probe on a ``device="cpu"`` server fed the same
   objects, every probe on the tensor lane (``lane=fast``) through the
   delta-solve session on the card (its first, cold pass a launch of the
   checkpointed queue kernel; the retired probes leave the cluster as it
   was, so the timed probes are served warm); for 3
   granted probes the driver is bound and every executor POSTed, each
   granted its reserved node; request latency p50 / p99, the provenance
   work a request does, span medians and the device's idle share in a
   profiler trace of one request; then one probe refused behind the
   queue, explained on the card, its message equal to the cpu server's;
6. cluster: the same server against a Kubernetes API over REST — a cuda
   and a cpu server, each on its own ``FakeKubeAPI`` (a local HTTP
   Kubernetes API) holding phase 5's objects, reached through a
   kubeconfig as the CLI's ``--kubeconfig`` reaches it; the first full
   LIST's time and decode and the time until the informers watch; phase
   5's probe protocol under ``tpu-batch`` (2 warmup and 24 timed probes,
   bodies equal, served by the delta-solve session, 3 granted
   probes' executors), with every pod created, bound and deleted in the
   fake and seen through the watches, and the reservations and demands
   each server wrote back read over REST and equal; the invariant checker
   (I1-I5, I5 at 10,000 nodes) after every 4th driver Filter of the cuda
   server (the other Filters skip it: ~1.5 s a check) and on both servers
   at the end, no violation, and the request latency given without and with its time;
   ``/metrics`` with ``Accept: text/plain`` parsed as Prometheus text,
   its fast-lane counter equal to the probes; ``/convert`` round-tripping
   a v1beta1 reservation; one unschedulable-marker scan of the 1,000
   queued drivers on each server, verdicts equal, with its time;
7. resilience: a cuda and a cpu server under ``tpu-batch`` on phase 5's
   snapshot with the flight recorder keeping 10,240-node bundles; 8
   probes whose gangs fit the cluster but not behind the queue, their
   explanations walking all 1,000 earlier apps, failure messages and
   ``/explain`` bodies equal on cuda and cpu, the refused requests' and
   the explanations' times; a write-back outage (``set_write_fault``):
   the breaker opens, readiness reads ``degraded``, every admitted gang's
   reservation is journaled and none lands, then the journal replays
   and the reservations equal the cpu server's; the bundles the
   ``breaker-open`` trigger persisted replayed through the kernel and
   the plain version, equal to the recorded verdicts, with their times;
   a burst of 32 concurrent ``/predicates`` on the cuda server: each
   answer a grant, a refusal or the shed message, at least one shed,
   the shed requests' wait, and I1-I5 after it;
8. delta: the delta-solve engine (ops/deltasolve.py, its device-resident
   session ops/fifo_session.py) on phase 5's snapshot.  (1) The
   checkpointed launches of ``fifo_queue`` (tightly, evenly) and
   ``fifo_queue_min_frag`` at phase 4's inputs (10,240 x 1,024, 1,000
   valid apps), stride 64: outputs and every checkpoint equal to the plain
   version, a suffix pass from a checkpoint too, a pass resumed from
   every checkpoint equal to the whole-queue pass, with times.  (2) Under
   ``tpu-batch`` and ``tpu-batch-minimal-fragmentation``, a cuda server
   with the engine on, one with it off and a cpu server with it on, the
   1,000 queued drivers behind an enforced driver that fits nowhere;
   three segments of 200 Filters, each posted to the two cuda servers in
   turns: (a) retries of queued drivers in random order, nothing changing
   between them; (b) the same with an unrelated reservation created and
   deleted before each (the change feed moves, the class digest cancels
   back); (c) every 10th Filter an app that is granted and starts (the
   basis changes); segment (a) under ``tpu-batch-distribute-evenly`` too.
   Bodies equal on and off, and on the cpu server for a
   sample; per segment p50 / p99 on and off, the warm-hit share, miss
   reasons, resume depths and span medians; the device's busy share in a
   profiler trace of one warm and one cold request.  (3) The engine's
   warm-captured decisions persisted and replayed cold through the
   kernel and the plain version, and a session stream at the library
   layer (a FifoSession on the card against one on the CPU and the
   stateless pass).  Step (1) also launches the tightly-pack and
   min-frag kernels checkpointed at 20,480 nodes (the main path's
   cluster twice over, the same apps), a whole queue and a 640-app
   suffix, each equal to its plain version and timed;
9. observatory: the capacity observatory and the lifecycle ledger
   (capacity/, lifecycle/) on phase 5's snapshot under ``tpu-batch``: a
   cuda server on the reference's defaults, a cuda server with both
   off and a cpu server on the defaults; after the same 4 Filters on
   each, a sample on the cuda and the cpu server, equal but for the
   fields that name the host (``SAMPLE_HOST_FIELDS``,
   ``QUEUE_HOST_FIELDS``); the sampler's two probe programs (row-level
   over the cluster and its (group, zone) combos, and the class lane)
   by CUDA events at 10,000 nodes × 16 shapes, and a whole sample's
   ``sampleMs`` with each of its parts by the host clock; 100 granted
   probes, each retired, on the on and off cuda servers in blocks in
   turns, each block posted to its own server alone, p50 / p99 of each,
   the samples and drains taken and one ledger drain's time; no probe
   or drain under the predicate lock and no class-lane
   failure; ``/slo`` counting the Filters served, ``/lifecycle`` listing
   the probe apps.  Phases 5 to delta run with both subsystems on too
   (the reference's defaults);
10. the kernels line (times, bounds, launches) and the device result line.

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


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with the seconds since the
    script started (where the time goes, phase by phase)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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

SERVER_POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly", "tpu-batch-minimal-fragmentation")
SERVER_WARMUP_PROBES, SERVER_TIMED_PROBES, SERVER_EXECUTOR_CHECKS = 2, 24, 3
# the policy whose probes also go to a cuda server with provenance off,
# in alternating order: provenance's cost within one run
SERVER_PROVENANCE_OFF = "tpu-batch"
# the kernel (variant) each server policy's Filter launches
SERVER_KERNEL = {"tpu-batch": "fifo_queue_tightly", "tpu-batch-distribute-evenly": "fifo_queue_evenly",
                 "tpu-batch-minimal-fragmentation": "fifo_queue_min_frag"}
# the spans of a Filter the delta-solve session serves warm (a cold one
# adds deltasolve.cold_build with fast_path.build_tensor, tensorize.scale
# and deltasolve.load, and skips deltasolve.scale)
SERVER_SPANS = ("http.read", "serde.decode", "predicate", "fast_path.snapshot", "fast_path.earlier_drivers",
                "deltasolve.lookup", "deltasolve.scale", "fifo_gate", "kernel:fifo_queue", "binpack",
                "serde.encode", "http.request")
# the lane that serves a Filter with the delta-solve engine on (the
# default): the session, on the card
SESSION_LANE = "cuda-session"


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


def server_resilience(device: str):
    """The reference's default resilience, but on a cpu server no request
    deadline short of an hour: the cpu servers are the plain versions'
    oracle for the card's answers, and a host that runs them slowly must
    not turn a decision into a deadline failure."""
    from k8s_spark_scheduler_tpu_torch.config import ResilienceConfig

    return ResilienceConfig(request_deadline_seconds=3600.0) if device == "cpu" else ResilienceConfig()


class PortServer:
    """The port's server on its own embedded API server, serving HTTP on
    an ephemeral port."""

    def __init__(self, policy: str, device: str, nodes, queue, provenance=None, delta_solve: bool = True,
                 observatories: bool = True):
        from k8s_spark_scheduler_tpu_torch.config import CapacityConfig, Install, LifecycleConfig, ProvenanceConfig
        from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
        from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
        from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
        from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

        self.api = APIServer()
        self.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        # the reference's defaults, resilience, provenance, the capacity
        # observatory and the lifecycle ledger included (`observatories`
        # False turns the last two off); the marker's scan is phase 6's,
        # not a load on the timed probes
        install = Install(binpack_algo=policy, fifo=True, provenance=provenance or ProvenanceConfig(),
                          resilience=server_resilience(device), delta_solve=delta_solve,
                          capacity=CapacityConfig(enabled=observatories),
                          lifecycle=LifecycleConfig(enabled=observatories))
        self.scheduler = init_server_with_clients(
            self.api, install, demand_poll_interval=0.5, unschedulable_polling_interval=3600.0,
            device=device,
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
        return self.post_body(self.request_body(pod, names))

    def request_body(self, pod, names) -> bytes:
        """The ExtenderArgs of a Filter of the pod as this server's API
        stores it."""
        from k8s_spark_scheduler_tpu_torch.types import serde

        stored = self.api.get("Pod", pod.namespace, pod.name)
        return json.dumps({"Pod": serde.pod_to_dict(stored), "NodeNames": names}).encode()

    def post_body(self, data: bytes):
        """(ms on the host clock, status, body bytes) of one POST of
        `data` to /predicates."""
        import urllib.error
        import urllib.request

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

    def get(self, path: str, accept: str = None):
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.http.port}{path}",
                                     headers={"Accept": accept} if accept else {})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.headers.get("Content-Type"), resp.read()

    def settle_embedded(self) -> None:
        """Wait until the write-back queues have drained and the caches
        equal the embedded API server's objects."""
        sched = self.scheduler
        wait_for(lambda: not any(sched.resource_reservation_cache.inflight_queue_lengths())
                 and not any(sched.demand_cache.inflight_queue_lengths())
                 and reservations_of(sched.resource_reservation_cache.list())
                 == reservations_of(self.api.list("ResourceReservation")),
                 "the write-back to land in the API server")

    def watch_provenance(self):
        """Wrap this server's provenance hot path to time it and keep the
        last captured solve: returns a dict the wrappers fill
        ({"art": last SolveArtifacts, "ms": [per-decision capture ms],
        "explain_ms": [per-refusal explanation ms]})."""
        tracker = self.scheduler.provenance
        solver = self.scheduler.extender.binpacker.queue_solver
        acc = {"art": None, "ms": [], "explain_ms": [], "open": 0.0}

        def timed(fn, key=None):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    dt = (time.perf_counter() - t) * 1e3
                    if key is None:
                        acc["open"] += dt
                    else:
                        acc[key].append(dt)
            return wrapper

        def keeping(sink):
            def keep(art):
                acc["art"] = art
                sink(art)
            return keep

        # the solve is captured by the delta-solve engine when it serves,
        # else by the solver's cold lane
        solver.capture_sink = keeping(solver.capture_sink)
        solver._capture_solve = timed(solver._capture_solve)
        engine = self.scheduler.extender.delta_engine
        if engine is not None:
            engine.capture_sink = keeping(engine.capture_sink)
            engine._capture = timed(engine._capture)
        tracker.begin_decision = timed(tracker.begin_decision)
        tracker.note_context = timed(tracker.note_context)
        finish = tracker.finish_decision

        def finish_and_close(*a, **kw):
            t = time.perf_counter()
            try:
                return finish(*a, **kw)
            finally:
                acc["ms"].append(acc["open"] + (time.perf_counter() - t) * 1e3)
                acc["open"] = 0.0

        tracker.finish_decision = finish_and_close
        tracker.refusal_detail = timed(tracker.refusal_detail, "explain_ms")
        return acc


def reservations_of(rrs) -> dict:
    return {(rr.namespace, rr.name): (sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                                      sorted(rr.status.pods.items())) for rr in rrs}


# executors of the refused probes: 8 CPU / 16 Gi each
REFUSED_EXECUTOR = (8, 16)


def refused_gang_sizes(art, n: int):
    """n executor counts of 8 CPU / 16 Gi gangs that fit the cluster as it
    stands but not behind the queue (the captured solve `art` of a granted
    probe holds both availabilities): each such refusal's explanation
    walks the whole queue and names the drivers that took the room."""
    scale = np.asarray(art.scale, dtype=np.int64)
    exec_base = np.array([REFUSED_EXECUTOR[0] * 1000, REFUSED_EXECUTOR[1] * 2**30], np.int64)

    def capacity(avail) -> int:
        a = np.asarray(avail, dtype=np.int64)[:, :2] * scale[None, :2]
        cap = np.minimum(a[:, 0] // exec_base[0], a[:, 1] // exec_base[1])
        return int(np.where(art.exec_ok & (a >= 0).all(axis=1), np.maximum(cap, 0), 0).sum())

    before = capacity(art.basis)
    after = capacity(art.avail_after.cpu().numpy() if hasattr(art.avail_after, "cpu") else art.avail_after)
    if before - after < n + 2:
        raise SystemExit(f"the queue takes too little room to refuse behind it ({before} -> {after})")
    return [after + 1 + (before - after) * (j + 1) // (n + 2) for j in range(n)], before, after


def refused_driver(app_id: str, k: int, created: float):
    """A driver whose gang is k executors of REFUSED_EXECUTOR."""
    from k8s_spark_scheduler_tpu_torch.scheduler import labels as L
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    driver = Harness.static_allocation_spark_pods(
        app_id, 0, executor_cpu=str(REFUSED_EXECUTOR[0]), executor_mem=f"{REFUSED_EXECUTOR[1]}Gi",
        creation_timestamp=created,
    )[0]
    driver.meta.annotations[L.EXECUTOR_COUNT] = str(k)
    return driver


# the fields of an /explain body that name the serving server rather than
# the decision: the queue pass's lane, the trace id, the server's clock,
# and the mirror instance in the snapshot's content key
EXPLAIN_SERVER_FIELDS = ("lane", "traceId", "t")


def decision_fields(body: bytes) -> dict:
    record = json.loads(body)
    out = {k: v for k, v in record.items() if k not in EXPLAIN_SERVER_FIELDS}
    if out.get("contentKey"):
        out["contentKey"] = out["contentKey"][1:]
    return out


def span_durations(span: dict, out: dict) -> dict:
    out.setdefault(span["name"], []).append(span["durationMs"])
    for child in span.get("children", ()):
        span_durations(child, out)
    return out


def server_phase(seed: int, smi: str) -> dict:
    """Phase 5 (see the module docstring); returns the launches of each
    policy's checkpointed kernel on its cuda servers' run.  Raises
    SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.config import ProvenanceConfig
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    path_launches = {}
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
                off = None
                if policy == SERVER_PROVENANCE_OFF:
                    off = servers["cuda-provenance-off"] = PortServer(
                        policy, "cuda", nodes, queue, provenance=ProvenanceConfig(enabled=False))
                log(f"phase server: {policy}: {', '.join(servers)} servers ready in "
                    f"{time.perf_counter() - t0:.2f} s")
                card = servers["cuda"]
                solver = card.scheduler.extender.binpacker.queue_solver
                prov = card.watch_provenance()
                kname = SERVER_KERNEL[policy]
                engine = card.scheduler.extender.delta_engine
                lat_ms, off_ms, traces, granted, exec_checked, compared = [], [], [], 0, 0, 0
                n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
                # the path is driven with every count at 0: the first probe's
                # cold session pass launches the checkpointed kernel, and
                # the warm probes after it launch none
                qk.reset_launch_counts()
                mk.reset_launch_counts()
                for i in range(n_probes):
                    timed = i >= SERVER_WARMUP_PROBES
                    if i == SERVER_WARMUP_PROBES:
                        prov["ms"].clear()  # the timed probes' run starts here
                        warm_before = engine.stats()["warm_hits"]
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
                    if off is not None and i % 2:  # the two cuda servers in turns
                        o_ms, o_status, o_body = off.post(pods[0], names)
                    ms, status, body = card.post(pods[0], names)
                    if timed:
                        lat_ms.append(ms)
                        traces.append(card.scheduler.tracer.traces(limit=1)[0])
                    if off is not None:
                        if not i % 2:
                            o_ms, o_status, o_body = off.post(pods[0], names)
                        if (o_status, o_body) != (status, body):
                            raise SystemExit(f"{policy} probe {i}: provenance off answered {o_status} "
                                             f"{o_body[:300]!r}, on {status} {body[:300]!r}")
                        if timed:
                            off_ms.append(o_ms)
                    if status != 200:
                        raise SystemExit(f"{policy} probe {i}: cuda answered {status} {body[:300]!r}")
                    compared += 1
                    _, cpu_status, cpu_body = servers["cpu"].post(pods[0], names)
                    if (status, body) != (cpu_status, cpu_body):
                        raise SystemExit(f"{policy} probe {i}: cuda answered {status} {body[:300]!r}, "
                                         f"cpu {cpu_status} {cpu_body[:300]!r}")
                    if card.fast_lane_count() != fast_before + 1 or solver.last_queue_lane != SESSION_LANE:
                        raise SystemExit(f"{policy} probe {i} did not take the tensor lane with the CUDA "
                                         f"session (queue lane {solver.last_queue_lane!r})")
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
                launches = {**qk.launch_counts, **mk.launch_counts}[kname + "_checkpointed"]
                path_launches[kname + "_checkpointed"] = launches
                warm = engine.stats()["warm_hits"] - warm_before
                cuda_servers = 1 + (off is not None)
                if launches != cuda_servers:  # one cold session pass a server, the rest served warm
                    raise SystemExit(f"{policy}: {kname}_checkpointed launched {launches} times on the "
                                     f"server's path, expected {cuda_servers} (one cold pass a cuda server)")
                if warm != SERVER_TIMED_PROBES:
                    raise SystemExit(f"{policy}: {warm} of the {SERVER_TIMED_PROBES} timed probes served warm")
                if exec_checked < SERVER_EXECUTOR_CHECKS:
                    raise SystemExit(f"{policy}: only {exec_checked} granted probes to check executors on")
                log(f"phase server: {policy}: {n_probes} probes, {compared} of them equal on cuda and cpu, "
                    f"{granted} granted, all on lane=fast with the cuda delta-solve session; "
                    f"{kname}_checkpointed launches {launches} over the probes on {cuda_servers} cuda "
                    f"servers, {warm} of the {SERVER_TIMED_PROBES} timed probes served warm; engine "
                    f"{engine.stats()}")
                log(f"phase server: {policy}: provenance on the request path (begin, context, capture, "
                    f"record) median {statistics.median(prov['ms']):.3f} ms, max {max(prov['ms']):.3f} ms "
                    f"a Filter over the timed run's {len(prov['ms'])} driver and executor Filters")
                log(f"phase server: {policy}: /predicates at {N_NODES} nodes x {N_APPS} queued drivers: "
                    f"p50 {statistics.median(lat_ms):.3f} ms, p99 {float(np.percentile(lat_ms, 99)):.3f} ms "
                    f"over {len(lat_ms)} probes (runs {', '.join(f'{x:.1f}' for x in lat_ms)}) | {smi}")
                if off is not None:
                    log(f"phase server: {policy}: the same probes on a cuda server with provenance off, in "
                        f"turns with it on: p50 {statistics.median(off_ms):.3f} ms, p99 "
                        f"{float(np.percentile(off_ms, 99)):.3f} ms (runs {', '.join(f'{x:.1f}' for x in off_ms)}) "
                        f"against p50 {statistics.median(lat_ms):.3f}, p99 {float(np.percentile(lat_ms, 99)):.3f} "
                        f"ms on, bodies equal | {smi}")
                spans = {}
                for trace in traces:
                    span_durations(trace["root"], spans)
                # the kernel's span is named after the queue solve it profiles
                kernel_span = "kernel:fifo_queue_min_frag" if kname == "fifo_queue_min_frag" else "kernel:fifo_queue"
                wanted = [kernel_span if name == "kernel:fifo_queue" else name for name in SERVER_SPANS]
                log(f"phase server: {policy}: span medians (ms) " + ", ".join(
                    f"{name} {statistics.median(spans[name]):.3f}" for name in wanted if name in spans
                ) + f" | {smi}")
                missing = [name for name in wanted if name not in spans]
                if missing:
                    raise SystemExit(f"{policy}: the request traces lack spans {missing}")
                pods = Harness.static_allocation_spark_pods(
                    f"probe-{pi}-traced", 4, creation_timestamp=base + N_APPS + n_probes)
                card.api.create(pods[0].deepcopy())
                share = busy_share(lambda: card.post(pods[0], names))
                card.retire(pods[:1])
                log(f"phase server: {policy}: profiler trace of one /predicates request: {share} | {smi}")
                # one refused probe behind the queue: its explanation
                # (this policy's queue kernel with probes) on the card,
                # its failure message equal to the cpu server's
                ks, before, after = refused_gang_sizes(prov["art"], 1)
                pod = refused_driver(f"probe-{pi}-refused", ks[0], base + N_APPS + n_probes + 1)
                for server in (card, servers["cpu"]):
                    server.api.create(pod.deepcopy())
                qk.reset_launch_counts()
                mk.reset_launch_counts()
                ms, status, body = card.post(pod, names)
                _, cpu_status, cpu_body = servers["cpu"].post(pod, names)
                explain_launches = {**qk.launch_counts, **mk.launch_counts}
                message = next(iter(json.loads(body).get("FailedNodes", {}).values()), "")
                if (status, body) != (cpu_status, cpu_body) or "blocked by" not in message:
                    raise SystemExit(f"{policy} refused probe: cuda {status} {body[:300]!r}, "
                                     f"cpu {cpu_status} {cpu_body[:300]!r}")
                if explain_launches[kname] != 1:
                    raise SystemExit(f"{policy} refused probe: {explain_launches[kname]} {kname} launches, "
                                     f"want the explanation's")
                log(f"phase server: {policy}: refused probe of {ks[0]} executors (room {before} before the "
                    f"queue, {after} behind it): {ms:.3f} ms, explanation {prov['explain_ms'][-1]:.3f} ms "
                    f"({kname} launches {explain_launches[kname]}: the explanation's; the warm Filter's "
                    f"{kname}_checkpointed {explain_launches[kname + '_checkpointed']}), equal on "
                    f"cuda and cpu: {message[:160]!r} | {smi}")
                for server in (card, servers["cpu"]):
                    server.api.delete("Pod", pod.namespace, pod.name)  # refused: nothing reserved
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        logging.disable(logging.NOTSET)
    return path_launches


# -- phase 6: the server against a cluster over REST ----------------------------

CLUSTER_POLICY = "tpu-batch"
# the invariant checker runs after every CLUSTER_CHECK_EVERY-th driver
# Filter of the cuda server (I5 at 10,000 nodes is ~1.5 s a check), and
# on both servers at the end
CLUSTER_CHECK_EVERY = 4
WAIT_S = 60.0
_PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|summary)$")
_PROM_SERIES = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*",?)*\})? (\S+)$'
)


def wait_for(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit(f"timed out waiting for {what}")
        time.sleep(0.002)


def parse_prometheus(text: str) -> dict:
    """{series line's name and labels: value} of a Prometheus 0.0.4
    exposition; raises SystemExit on a line that is neither a TYPE line
    nor a sample."""
    samples = {}
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("#"):
            if not _PROM_TYPE.match(line):
                raise SystemExit(f"/metrics: bad comment line {line!r}")
            continue
        m = _PROM_SERIES.match(line)
        if m is None:
            raise SystemExit(f"/metrics: bad sample line {line!r}")
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return samples


def identity_free(wire: dict) -> dict:
    """A wire object without what each API server assigns itself (uids,
    resource versions, creation times)."""
    meta = {k: v for k, v in (wire.get("metadata") or {}).items()
            if k not in ("uid", "resourceVersion", "creationTimestamp")}
    meta["ownerReferences"] = [{k: v for k, v in ref.items() if k != "uid"}
                               for ref in meta.get("ownerReferences") or []]
    return dict(wire, metadata=meta)


class ClusterServer(PortServer):
    """The port's server against its own FakeKubeAPI over REST: the fake
    holds the cluster's objects, a kubeconfig names it, and the backend
    is the one the CLI's ``--kubeconfig`` flag builds.  Filters, binds
    and deletes act on the fake's store; the server sees them through its
    watches."""

    def __init__(self, device: str, nodes, queue, workdir: str):
        from k8s_spark_scheduler_tpu_torch.config import Install
        from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
        from k8s_spark_scheduler_tpu_torch.server.__main__ import api_backend
        from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
        from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
        from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI

        self.fake = FakeKubeAPI().start()
        self.scheduler = self.http = self.backend = None
        try:
            self.api = self.fake.api  # the cluster's own store
            self.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
            for obj in nodes + queue:
                self.api.create(obj.deepcopy())
            path = os.path.join(workdir, f"kubeconfig-{device}.json")
            with open(path, "w") as f:
                json.dump({
                    "current-context": "fake",
                    "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
                    "clusters": [{"name": "fake", "cluster": {"server": self.fake.host}}],
                    "users": [{"name": "fake", "user": {}}],
                }, f)
            self.backend, _ = api_backend(path, None, False)
            # the first full LIST of the nodes and pods over REST, and
            # their decode into objects, alone
            from k8s_spark_scheduler_tpu_torch.kube.restbackend import _RESOURCES

            self.list_ms, self.decode_ms, self.list_bytes = {}, {}, {}
            for kind in ("Node", "Pod"):
                res = _RESOURCES[kind]
                t = time.perf_counter()
                data = self.backend.client.request("GET", res.path())
                self.list_ms[kind] = (time.perf_counter() - t) * 1e3
                t = time.perf_counter()
                objs = [res.from_wire(item) for item in data["items"]]
                self.decode_ms[kind] = (time.perf_counter() - t) * 1e3
                self.list_bytes[kind] = len(json.dumps(data))
                if len(objs) != len(self.api.list(kind)):
                    raise SystemExit(f"the {kind} LIST over REST returned {len(objs)} objects")
            t = time.perf_counter()
            self.scheduler = init_server_with_clients(
                self.backend, Install(binpack_algo=CLUSTER_POLICY, fifo=True, resilience=server_resilience(device)),
                demand_poll_interval=0.5,
                unschedulable_polling_interval=3600.0, device=device,
            )
            # every informer has listed its kind over REST, replayed it,
            # and its watch stream has started
            self.watch_start_ms = (time.perf_counter() - t) * 1e3
            self.http = ExtenderHTTPServer(self.scheduler, port=0, host="127.0.0.1")
            self.http.start()
            if not self.scheduler.wait_ready(timeout=600.0):
                raise SystemExit(f"the {device} cluster server did not become ready")
            if len(self.scheduler.node_informer.list()) != len(nodes):
                raise SystemExit(f"the {device} server's informer holds "
                                 f"{len(self.scheduler.node_informer.list())} nodes")
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        if self.http is not None:
            self.http.stop()
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.backend is not None:
            self.backend.stop()
        self.fake.stop()

    def retire(self, pods) -> None:
        """PortServer.retire, then wait until the watch has taken the
        pods out of the server's informer too."""
        super().retire(pods)
        wait_for(lambda: all(self.scheduler.pod_informer.get(p.namespace, p.name) is None for p in pods),
                 "the watch to deliver the deletes")

    def post_json(self, path: str, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.http.port}{path}",
                                     data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def sees(self, pod, node: str = "") -> None:
        """Wait until the server's pod informer holds the pod (bound to
        `node` when given), delivered by its watch."""
        def seen():
            got = self.scheduler.pod_informer.get(pod.namespace, pod.name)
            return got is not None and got.node_name == node
        wait_for(seen, f"the watch to deliver {pod.name}")

    def settle(self) -> None:
        """Wait until the write-backs have landed in the fake over REST:
        queues drained, caches equal to the cluster's objects."""
        sched = self.scheduler

        def rr_content(rrs):
            return {(rr.namespace, rr.name): (sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                                              sorted(rr.status.pods.items())) for rr in rrs}

        wait_for(lambda: not any(sched.resource_reservation_cache.inflight_queue_lengths())
                 and not any(sched.demand_cache.inflight_queue_lengths())
                 and rr_content(sched.resource_reservation_cache.list())
                 == rr_content(self.api.list("ResourceReservation"))
                 and {(d.namespace, d.name) for d in sched.demand_cache.list()}
                 == {(d.namespace, d.name) for d in self.api.list("Demand")},
                 "the write-back to land in the fake")

    def written(self):
        """The reservations and demands in the cluster, read over REST."""
        from k8s_spark_scheduler_tpu_torch.types import serde

        return (sorted(json.dumps(identity_free(serde.rr_to_dict_v1beta2(rr)), sort_keys=True)
                       for rr in self.backend.list("ResourceReservation")),
                sorted(json.dumps(identity_free(serde.demand_to_dict_v1alpha2(d)), sort_keys=True)
                       for d in self.backend.list("Demand")))


def cluster_phase(seed: int, smi: str) -> None:
    """Phase 6 (see the module docstring); raises SystemExit on any failure."""
    import logging
    import tempfile

    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.scheduler import invariants
    from k8s_spark_scheduler_tpu_torch.scheduler.unschedulable import POD_EXCEEDS_CLUSTER_CAPACITY
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types import serde

    # the invariant checker after every CLUSTER_CHECK_EVERY-th driver
    # Filter of the cuda server (the wiring reads SCHED_DEBUG_INVARIANTS
    # when it builds a server), counting its checks, their time and their
    # violations; "on" is set for those Filters only
    checked = {"checks": 0, "violations": [], "ms": [], "on": False}
    real_check = invariants.check

    def counting_check(server, raise_on_violation=True):
        if not checked["on"]:
            return []
        t = time.perf_counter()
        found = real_check(server, raise_on_violation=False)
        checked["ms"].append((time.perf_counter() - t) * 1e3)
        checked["checks"] += 1
        checked["violations"] += found
        return found

    invariants.check = counting_check
    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    servers = {}
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        with tempfile.TemporaryDirectory() as workdir:
            for device in ("cuda", "cpu"):
                if device == "cuda":
                    os.environ["SCHED_DEBUG_INVARIANTS"] = "1"
                try:
                    servers[device] = ClusterServer(device, nodes, queue, workdir)
                finally:
                    os.environ.pop("SCHED_DEBUG_INVARIANTS", None)
        card, host = servers["cuda"], servers["cpu"]
        log(f"phase cluster: {CLUSTER_POLICY}: cuda and cpu servers, each on its own FakeKubeAPI holding "
            f"{len(nodes)} nodes in {N_ZONES} zones and {len(queue)} queued drivers, ready in "
            f"{time.perf_counter() - t0:.2f} s")
        for device, server in servers.items():
            log(f"phase cluster: {device} server: first full LIST over REST: nodes {server.list_ms['Node']:.1f} ms "
                f"({server.list_bytes['Node']} bytes) + decode {server.decode_ms['Node']:.1f} ms, pods "
                f"{server.list_ms['Pod']:.1f} ms ({server.list_bytes['Pod']} bytes) + decode "
                f"{server.decode_ms['Pod']:.1f} ms; informers listed, replayed and watching after "
                f"{server.watch_start_ms:.1f} ms | {smi}")
        solver = card.scheduler.extender.binpacker.queue_solver
        lat_ms, net_ms, check_ms, traces, granted, exec_checked, n_written = [], [], [], [], 0, 0, 0
        n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
        checks_before = checked["checks"]
        engine = card.scheduler.extender.delta_engine
        qk.reset_launch_counts()  # the path's run starts here
        for i in range(n_probes):
            timed = i >= SERVER_WARMUP_PROBES
            if i == SERVER_WARMUP_PROBES:
                warm_before = engine.stats()["warm_hits"]
            pods = Harness.static_allocation_spark_pods(
                f"probe-c-{i:03d}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
                executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=base + N_APPS + i,
            )
            created = pods[:1]
            for server in servers.values():
                server.api.create(pods[0].deepcopy())
                server.sees(pods[0])
                server.settle()
            fast_before, checks_seen = card.fast_lane_count(), checked["checks"]
            checked["on"] = i % CLUSTER_CHECK_EVERY == 0
            try:
                ms, status, body = card.post(pods[0], names)
            finally:
                checked["on"] = False
            if checked["checks"] != checks_seen + (i % CLUSTER_CHECK_EVERY == 0):
                raise SystemExit(f"cluster probe {i}: the invariant checker did not run as planned in the Filter")
            if timed:
                lat_ms.append(ms)
                # the request without the checker, which runs inside it
                check_ms.append(checked["ms"][-1] if i % CLUSTER_CHECK_EVERY == 0 else 0.0)
                net_ms.append(ms - check_ms[-1])
                traces.append(card.scheduler.tracer.traces(limit=1)[0])
            _, cpu_status, cpu_body = host.post(pods[0], names)
            if (status, body) != (cpu_status, cpu_body) or status != 200:
                raise SystemExit(f"cluster probe {i}: cuda answered {status} {body[:300]!r}, "
                                 f"cpu {cpu_status} {cpu_body[:300]!r}")
            if card.fast_lane_count() != fast_before + 1 or solver.last_queue_lane != SESSION_LANE:
                raise SystemExit(f"cluster probe {i} did not take the tensor lane with the CUDA session "
                                 f"(queue lane {solver.last_queue_lane!r})")
            result = json.loads(body)
            if result["NodeNames"]:
                granted += 1
                if timed and exec_checked < SERVER_EXECUTOR_CHECKS:
                    exec_checked += 1
                    for server in servers.values():
                        server.bind(pods[0], result["NodeNames"][0])
                        server.sees(pods[0], result["NodeNames"][0])
                    for pod in pods[1:]:
                        created.append(pod)
                        for server in servers.values():
                            server.api.create(pod.deepcopy())
                            server.sees(pod)
                            server.settle()
                        _, e_status, e_body = card.post(pod, names)
                        _, c_status, c_body = host.post(pod, names)
                        e_nodes = json.loads(e_body).get("NodeNames") if e_status == 200 else None
                        if (e_status, e_body) != (c_status, c_body) or not e_nodes:
                            raise SystemExit(f"cluster executor {pod.name}: cuda {e_status} {e_body[:300]!r}, "
                                             f"cpu {c_status} {c_body[:300]!r}")
                        if e_nodes[0] != card.reserved_node(pod):
                            raise SystemExit(f"cluster executor {pod.name} placed on {e_nodes[0]}, "
                                             f"reserved {card.reserved_node(pod)}")
                    log(f"phase cluster: probe {i} bound on {result['NodeNames'][0]}; its {len(pods) - 1} "
                        f"executors each granted their reserved node, equal on cuda and cpu")
            # what each server wrote back, read from its fake over REST
            for server in servers.values():
                server.settle()
            rrs, demands = card.written()
            if (rrs, demands) != host.written():
                raise SystemExit(f"cluster probe {i}: the reservations / demands written over REST differ")
            n_written += len(rrs) + len(demands)
            for server in servers.values():
                server.retire(created)
        launches = qk.launch_counts["fifo_queue_tightly_checkpointed"]
        warm = engine.stats()["warm_hits"] - warm_before
        if launches != 1:  # the first probe's cold session pass, the rest served warm
            raise SystemExit(f"cluster: fifo_queue_tightly_checkpointed launched {launches} times on the path, "
                             f"expected 1")
        if warm != SERVER_TIMED_PROBES:
            raise SystemExit(f"cluster: {warm} of the {SERVER_TIMED_PROBES} timed probes served warm")
        if exec_checked < SERVER_EXECUTOR_CHECKS or not n_written:
            raise SystemExit(f"cluster: only {exec_checked} granted probes checked, {n_written} objects written")
        log(f"phase cluster: {n_probes} probes equal on cuda and cpu, {granted} granted, all on lane=fast with "
            f"the cuda delta-solve session; fifo_queue_tightly_checkpointed launches {launches}, {warm} of the "
            f"{SERVER_TIMED_PROBES} timed probes served warm; engine {engine.stats()}; "
            f"{n_written} reservations and demands read back over REST equal on both fakes")
        log(f"phase cluster: /predicates over REST at {N_NODES} nodes x {N_APPS} queued drivers, without "
            f"the invariant checker's time: p50 {statistics.median(net_ms):.3f} ms, "
            f"p99 {float(np.percentile(net_ms, 99)):.3f} ms over {len(net_ms)} probes "
            f"(runs {', '.join(f'{x:.1f}' for x in net_ms)}) | {smi}")
        log(f"phase cluster: the same requests with the checker (I1-I5 after every {CLUSTER_CHECK_EVERY}th "
            f"Filter, median {statistics.median(checked['ms']):.1f} ms a check): p50 "
            f"{statistics.median(lat_ms):.3f} ms, p99 {float(np.percentile(lat_ms, 99)):.3f} ms | {smi}")
        spans = {}
        for trace in traces:
            span_durations(trace["root"], spans)
        missing = [name for name in SERVER_SPANS if name not in spans]
        if missing:
            raise SystemExit(f"cluster: the request traces lack spans {missing}")
        # the checker runs inside `predicate` (so inside `http.request`)
        for name in ("predicate", "http.request"):
            spans[name] = [d - c for d, c in zip(spans[name], check_ms)]
        log("phase cluster: span medians (ms; predicate and http.request without the checker) " + ", ".join(
            f"{name} {statistics.median(spans[name]):.3f}" for name in SERVER_SPANS) + f" | {smi}")

        # the invariant checker ran after every CLUSTER_CHECK_EVERY-th
        # driver Filter of the cuda server
        filters = checked["checks"] - checks_before
        if filters < -(-n_probes // CLUSTER_CHECK_EVERY) or checked["violations"]:
            raise SystemExit(f"cluster: {filters} invariant checks, violations {checked['violations'][:5]}")
        for device, server in servers.items():
            if not server.scheduler.tensor_snapshot.snapshot().exact:
                raise SystemExit(f"cluster: the {device} tensor mirror is inexact, so I5 checks nothing")
            found = real_check(server.scheduler, raise_on_violation=False)
            if found:
                raise SystemExit(f"cluster: {device} invariant violations {found[:5]}")
        log(f"phase cluster: invariants I1-I5 (I5 over {N_NODES} mirror rows) checked after {filters} of the "
            f"cuda server's {n_probes} driver Filters, 0 violations, median {statistics.median(checked['ms']):.1f} "
            f"ms a check; both servers hold them at the end | {smi}")

        # Prometheus text, with the fast-lane counter equal to the probes
        ctype, raw = card.get("/metrics", accept="text/plain")
        if not ctype.startswith("text/plain"):
            raise SystemExit(f"cluster: /metrics answered {ctype} to Accept: text/plain")
        samples = parse_prometheus(raw.decode())
        fast = samples.get('foundry_spark_scheduler_tpu_fastpath{lane="fast",path="driver"}')
        if fast != n_probes:
            raise SystemExit(f"cluster: the fast-lane counter reads {fast}, not {n_probes}")
        log(f"phase cluster: /metrics (Accept: text/plain) parses as Prometheus text: {len(samples)} samples, "
            f"lane=fast driver counter {fast:.0f} = {n_probes} probes")

        # /convert round-trips a v1beta1 reservation
        pods = Harness.static_allocation_spark_pods("convert-probe", 2,
                                                    creation_timestamp=base + N_APPS + n_probes)
        card.api.create(pods[0].deepcopy())
        card.sees(pods[0])
        card.settle()
        _, status, body = card.post(pods[0], names)
        if status != 200 or not json.loads(body)["NodeNames"]:
            raise SystemExit(f"cluster: the convert probe was not granted: {status} {body[:300]!r}")
        card.settle()
        v2 = serde.rr_to_dict_v1beta2(card.backend.get("ResourceReservation", "default", "convert-probe"))
        review = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
                  "request": {"uid": "c1", "desiredAPIVersion": "sparkscheduler.palantir.com/v1beta1",
                              "objects": [v2]}}
        v1 = card.post_json("/convert", review)["response"]["convertedObjects"][0]
        review["request"].update(uid="c2", desiredAPIVersion="sparkscheduler.palantir.com/v1beta2", objects=[v1])
        back = card.post_json("/convert", review)["response"]["convertedObjects"][0]
        if not v1["apiVersion"].endswith("v1beta1") or back["spec"] != v2["spec"]:
            raise SystemExit("cluster: /convert did not round-trip a v1beta1 reservation")
        card.retire(pods[:1])
        log(f"phase cluster: /convert round-trips reservation convert-probe v1beta2 -> v1beta1 -> v1beta2 "
            f"({len(v2['spec']['reservations'])} reservations)")

        # one scan of the unschedulable marker over the 1,000-driver backlog
        verdicts, scan_ms = {}, {}
        for device, server in servers.items():
            server.settle()
            t = time.perf_counter()
            server.scheduler.unschedulable_marker.scan_for_unschedulable_pods()
            scan_ms[device] = (time.perf_counter() - t) * 1e3
            conds = {}
            for pod in server.api.list("Pod"):
                cond = pod.conditions.get(POD_EXCEEDS_CLUSTER_CAPACITY)
                if pod.name.startswith("queue-"):
                    conds[pod.name] = None if cond is None else cond.status
            verdicts[device] = conds
        if verdicts["cuda"] != verdicts["cpu"] or None in verdicts["cuda"].values() or len(verdicts["cuda"]) != N_APPS:
            raise SystemExit("cluster: the marker's verdicts differ on cuda and cpu, or a queued driver has none")
        n_exceed = sum(v == "True" for v in verdicts["cuda"].values())
        log(f"phase cluster: unschedulable marker, one scan of {N_APPS} queued drivers: {n_exceed} exceed "
            f"the empty cluster, verdicts equal on cuda and cpu; scan {scan_ms['cuda']:.1f} ms on cuda, "
            f"{scan_ms['cpu']:.1f} ms on cpu (conditions written over REST included) | {smi}")
    finally:
        for server in servers.values():
            server.stop()
        invariants.check = real_check
        logging.disable(logging.NOTSET)


# -- phase 4 snapshot ---------------------------------------------------------


# -- phase 7: resilience and provenance through the server -----------------------

RESILIENCE_POLICY = "tpu-batch"
RESILIENCE_REFUSED, RESILIENCE_OUTAGE, RESILIENCE_BURST = 8, 6, 32
BUNDLE_NODES = 10240  # the flight recorder keeps bundles of the 10,240-node bucket


def resilience_phase(seed: int, smi: str) -> None:
    """Phase 7 (see the module docstring); raises SystemExit on any failure."""
    import logging
    import tempfile
    import threading

    from k8s_spark_scheduler_tpu_torch.config import ProvenanceConfig
    from k8s_spark_scheduler_tpu_torch.kube.errors import APIError
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.provenance.recorder import _replay_solve, replay_bundle
    from k8s_spark_scheduler_tpu_torch.scheduler import invariants
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    def launches() -> dict:
        return {k: v for k, v in {**qk.launch_counts, **mk.launch_counts}.items() if v}

    logging.disable(logging.WARNING)  # the outage logs every failed write
    workdir = tempfile.mkdtemp(prefix="chip-smoke-resilience-")
    servers = {}
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed + 7)
        for device in ("cuda", "cpu"):
            servers[device] = PortServer(
                RESILIENCE_POLICY, device, nodes, queue,
                provenance=ProvenanceConfig(max_bundle_nodes=BUNDLE_NODES,
                                            bundle_dir=os.path.join(workdir, device)),
            )
        card, host = servers["cuda"], servers["cpu"]
        kit = card.scheduler.resilience
        prov = card.watch_provenance()
        log(f"phase resilience: cuda and cpu servers ({RESILIENCE_POLICY}, the reference's default "
            f"resilience and provenance, bundles up to {BUNDLE_NODES} nodes) ready in "
            f"{time.perf_counter() - t0:.2f} s")
        # the path is driven with every count at 0 and read after each step
        qk.reset_launch_counts()
        mk.reset_launch_counts()
        stamp = [base + N_APPS]

        def probe_pods(tag: str):
            stamp[0] += 1
            return Harness.static_allocation_spark_pods(
                f"res-{tag}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
                executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=stamp[0])

        def both(pod, expect_granted=None):
            for server in servers.values():
                server.api.create(pod.deepcopy())
            ms, status, body = card.post(pod, names)
            _, c_status, c_body = host.post(pod, names)
            if (status, body) != (c_status, c_body) or status != 200:
                raise SystemExit(f"{pod.name}: cuda {status} {body[:300]!r}, cpu {c_status} {c_body[:300]!r}")
            result = json.loads(body)
            if expect_granted is not None and bool(result.get("NodeNames")) != expect_granted:
                raise SystemExit(f"{pod.name}: want granted={expect_granted}, got {body[:300]!r}")
            return ms, result

        # -- a granted probe: its captured solve sizes the refused gangs
        warm = probe_pods("warmup")
        both(warm[0], expect_granted=True)
        for server in servers.values():
            server.retire(warm[:1])
        sizes, before, after = refused_gang_sizes(prov["art"], RESILIENCE_REFUSED)
        log(f"phase resilience: 8 CPU / 16 Gi executors: room for {before} before the queue, "
            f"{after} behind it; refused gangs of {sizes[0]}-{sizes[-1]}")

        # -- refused probes: the explanation walks all 1,000 earlier apps
        refused_ms, explain_ms, blockers = [], [], []
        prov["explain_ms"].clear()
        for j, k in enumerate(sizes):
            stamp[0] += 1
            pod = refused_driver(f"res-refused-{j}", k, stamp[0])
            ms, result = both(pod, expect_granted=False)
            refused_ms.append(ms)
            message = next(iter(result["FailedNodes"].values()))
            bodies = [decision_fields(s.get(f"/explain/{pod.namespace}/{pod.name}")[1])
                      for s in (card, host)]
            if bodies[0] != bodies[1]:
                raise SystemExit(f"{pod.name}: /explain differs on cuda and cpu:\n{bodies[0]}\n{bodies[1]}")
            record = bodies[0]
            sf = record["shortfall"]
            if record["outcome"] != "failure-fit" or sf is None or record["queueLength"] != N_APPS \
                    or sf["flipPosition"] < 0 or not sf["blockedBy"] or "blocked by" not in message:
                raise SystemExit(f"{pod.name}: not explained behind the queue: {message!r} {record}")
            blockers.append(sf["blockedByCount"])
            for server in servers.values():
                server.api.delete("Pod", pod.namespace, pod.name)
        explain_ms = prov["explain_ms"][-RESILIENCE_REFUSED:]
        log(f"phase resilience: {RESILIENCE_REFUSED} refused probes explained over all {N_APPS} earlier "
            f"apps, messages and /explain bodies (less {', '.join(EXPLAIN_SERVER_FIELDS)}) equal on cuda "
            f"and cpu; blockers {blockers}; launches {launches()}")
        log(f"phase resilience: refused /predicates (explanation not memoised) p50 "
            f"{statistics.median(refused_ms):.3f} ms, p99 {float(np.percentile(refused_ms, 99)):.3f} ms "
            f"(runs {', '.join(f'{x:.1f}' for x in refused_ms)}); the explanation alone p50 "
            f"{statistics.median(explain_ms):.3f} ms, max {max(explain_ms):.3f} ms | {smi}")
        log(f"phase resilience: first refusal's message: {message[:200]!r}")

        # -- write-back outage: the breaker opens, intents are journaled
        def outage(op, kind, ns, name):
            return APIError(f"injected outage ({op} {kind})") if kind == "ResourceReservation" else None

        for server in servers.values():
            server.settle_embedded()
            server.api.set_write_fault(outage)
        held = []
        for j in range(RESILIENCE_OUTAGE):
            pods = probe_pods(f"outage-{j}")
            _, result = both(pods[0])
            if result.get("NodeNames"):
                held.append(pods[0])
        apps = {("default", p.labels["spark-app-id"]) for p in held}
        for device, server in servers.items():
            sk = server.scheduler.resilience
            wait_for(lambda: sk.journal.pending_keys() == apps
                     and not any(server.scheduler.resource_reservation_cache.inflight_queue_lengths()),
                     f"the {device} server to journal the reservations")
            landed = {(rr.namespace, rr.name) for rr in server.api.list("ResourceReservation")}
            if sk.breaker.state != "open" or landed & apps:
                raise SystemExit(f"{device}: breaker {sk.breaker.state}, landed {landed & apps}")
            cached = {(rr.namespace, rr.name) for rr in server.scheduler.resource_reservation_cache.list()}
            if not apps <= cached:
                raise SystemExit(f"{device}: the cache lost admitted reservations {apps - cached}")
        _, ready = card.get("/status/readiness")
        ready = json.loads(ready)
        if ready["state"] != "degraded" or ready["components"]["journalDepth"] != len(apps):
            raise SystemExit(f"readiness during the outage: {ready}")
        tracker = card.scheduler.provenance
        wait_for(lambda: tracker.recorder.persisted_paths, "the breaker-open bundle file")
        bundle_file = tracker.recorder.persisted_paths[0]
        log(f"phase resilience: outage: {len(apps)} admitted gangs' reservations journaled on both "
            f"servers, none landed, none dropped; breaker open; readiness {ready['state']} "
            f"(components {ready['components']}); breaker-open bundle file "
            f"{os.path.getsize(bundle_file)} bytes")

        # -- recovery: the journal replays, nothing lost
        t = time.perf_counter()
        for server in servers.values():
            server.api.set_write_fault(None)
            server.scheduler.resource_reservation_cache.nudge_recovery(force=True)
        for device, server in servers.items():
            sk = server.scheduler.resilience
            wait_for(lambda: sk.journal.depth() == 0 and sk.breaker.state == "closed",
                     f"the {device} server's journal to replay")
            server.settle_embedded()
        recover_ms = (time.perf_counter() - t) * 1e3
        written = [sorted(json.dumps(identity_free(serde_rr(rr)), sort_keys=True)
                          for rr in s.api.list("ResourceReservation")) for s in (card, host)]
        if written[0] != written[1] or not apps <= {(rr.namespace, rr.name)
                                                    for rr in card.api.list("ResourceReservation")}:
            raise SystemExit("after recovery the reservations differ from the cpu server's or are missing")
        _, ready = card.get("/status/readiness")
        if json.loads(ready)["state"] != "ready":
            raise SystemExit(f"readiness after recovery: {ready!r}")
        log(f"phase resilience: recovery: journals replayed in {recover_ms:.1f} ms, breakers closed, "
            f"{len(written[0])} reservations in the API equal on cuda and cpu; readiness ready")
        for server in servers.values():
            server.retire(held)

        # -- the breaker-open bundles replay through the kernel and the plain version
        with open(bundle_file) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        bundles = [b for b in lines if not b.get("header")]
        if lines[0].get("trigger") != "breaker-open" or not bundles:
            raise SystemExit(f"bad bundle file header {lines[0]}")
        replay_ms, card_ms = [], []
        before_counts = launches()
        for bundle in bundles:
            t = time.perf_counter()
            result = replay_bundle(bundle, device="cuda")
            replay_ms.append((time.perf_counter() - t) * 1e3)
            if not result["ok"] or result["lanes"] != {"cuda": "ok", "torch": "ok"}:
                raise SystemExit(f"bundle {bundle['seq']} replay: {result}")
            rows = np.asarray(bundle["apps8"], dtype=np.int32)[: bundle["nEarlier"]]
            t = time.perf_counter()
            _replay_solve(bundle["policyCode"], np.asarray(bundle["basis"], dtype=np.int32),
                          np.asarray(bundle["driverRank"], dtype=np.int32),
                          np.asarray(bundle["execOk"], dtype=bool), rows, torch.device("cuda"))
            card_ms.append((time.perf_counter() - t) * 1e3)
        replayed = {k: launches().get(k, 0) - before_counts.get(k, 0) for k in launches()}
        log(f"phase resilience: {len(bundles)} breaker-open bundles ({bundles[0]['nb']} nodes x "
            f"{bundles[0]['nEarlier']} earlier apps) replayed byte-identical through the cuda kernel and "
            f"the plain version; replay {statistics.median(replay_ms):.1f} ms a bundle with both lanes, "
            f"the card's lane alone {statistics.median(card_ms):.3f} ms (launches {replayed}) | {smi}")

        # -- a burst over the admission gate
        burst = [probe_pods(f"burst-{j}") for j in range(RESILIENCE_BURST)]
        for pods in burst:
            card.api.create(pods[0].deepcopy())
        answers = [None] * RESILIENCE_BURST
        barrier = threading.Barrier(RESILIENCE_BURST)
        bodies = [card.request_body(pods[0], names) for pods in burst]  # serialised before the burst

        def fire(j):
            barrier.wait()
            answers[j] = card.post_body(bodies[j])

        threads = [threading.Thread(target=fire, args=(j,)) for j in range(RESILIENCE_BURST)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        shed_ms, kinds = [], {"granted": 0, "refused": 0, "shed": 0}
        for ms, status, body in answers:
            result = json.loads(body) if status == 200 else {}
            failed = set((result.get("FailedNodes") or {}).values())
            if status == 200 and result.get("NodeNames"):
                kinds["granted"] += 1
            elif failed == {"scheduler overloaded; retry"}:
                kinds["shed"] += 1
                shed_ms.append(ms)
            elif status == 200 and len(failed) == 1:
                kinds["refused"] += 1
            else:
                raise SystemExit(f"burst answer {status} {body[:300]!r}")
        if not kinds["shed"] or kit.gate.shed_total < kinds["shed"]:
            raise SystemExit(f"the burst of {RESILIENCE_BURST} shed nothing: {kinds}")
        card.settle_embedded()
        t = time.perf_counter()
        violations = invariants.check(card.scheduler, raise_on_violation=False)
        check_ms = (time.perf_counter() - t) * 1e3
        if violations:
            raise SystemExit(f"invariants after the burst: {violations}")
        _, ready = card.get("/status/readiness")
        log(f"phase resilience: burst of {RESILIENCE_BURST} concurrent /predicates: {kinds}; a shed "
            f"request waited p50 {statistics.median(shed_ms):.3f} ms, max {max(shed_ms):.3f} ms; I1-I5 hold "
            f"after it ({check_ms:.0f} ms); readiness {json.loads(ready)['state']} | {smi}")
        counts = launches()
        if counts.get("fifo_queue_tightly", 0) < 1:
            raise SystemExit(f"fifo_queue was not launched on the resilience path: {counts}")
        log(f"phase resilience: launches on the path (Filters, explanations, replays) {counts}")
    finally:
        for server in servers.values():
            server.api.set_write_fault(None)
            server.stop()
        logging.disable(logging.NOTSET)


# -- phase delta: the delta-solve engine on against off ---------------------------

# the policies of phase delta and the segments each runs: segment (a)
# under distribute-evenly too, so the engine is held on against off and
# cuda against cpu under every tensor-lane name
DELTA_POLICIES = {"tpu-batch": "abc", "tpu-batch-minimal-fragmentation": "abc", "tpu-batch-distribute-evenly": "a"}
DELTA_FILTERS = 200  # Filters a segment
DELTA_GRANT_EVERY = 10  # segment (c): every 10th Filter is an app that is granted and starts
# the queued drivers' Filters of segments (a) and (b) the cpu server
# answers too: its warm passes are the plain versions' suffixes, seconds a
# Filter on the host under min-frag
DELTA_CPU_EVERY = {"tpu-batch": 20, "tpu-batch-minimal-fragmentation": 40, "tpu-batch-distribute-evenly": 20}
DELTA_CPU_COLD = 2  # segment (c): queued drivers' Filters the cpu server answers, each a cold pass
DELTA_SEGMENTS = {
    "a": "retries of queued drivers in random order, nothing changes between them",
    "b": "the same, an unrelated reservation created and deleted before each",
    "c": "the same, every 10th Filter an app that is granted and starts",
}
DELTA_SPANS = ("predicate", "fast_path.snapshot", "fast_path.earlier_drivers", "deltasolve.lookup",
               "deltasolve.scale", "deltasolve.cold_build", "fast_path.build_tensor", "tensorize.scale",
               "deltasolve.load", "fifo_gate", "kernel:fifo_queue", "kernel:fifo_queue_min_frag", "binpack")
DELTA_STRIDE = 64  # the session's checkpoint stride (ops/deltasolve.py)


def timed_once(fn):
    """(fn's result, its milliseconds by CUDA events), no warmup."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def delta_kernels(queue_args, n_valid: int, queue_bytes: int, check, smi: str) -> dict:
    """Phase delta, step 1: the checkpointed launches of fifo_queue
    (tightly, evenly) and fifo_queue_min_frag at the main path's inputs
    (the 10,240 x 1,024 bucket, 1,000 valid apps), stride 64: a whole-queue
    pass and a suffix pass from the checkpoint at position 384 against
    their plain versions (outputs and every checkpoint), and a pass
    resumed from every checkpoint against the whole-queue pass.  Then the
    tightly-pack and min-frag launches at 20,480 nodes (the main path's
    cluster twice over, the same 1,000 apps), whole queue and a 640-app
    suffix, against their plain versions and timed: the class-compressed
    stepping question (ROADMAP A.3b) asks what a launch costs at the
    reference's 20,000-node threshold.  Returns {kernel name: (ms runs,
    plain ms, bytes bound ms, operations bound ms)} at the main path's
    inputs."""
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    n_b, a_b = queue_args[0].shape[0], queue_args[3].shape[0]
    k = (a_b - 1) // DELTA_STRIDE
    out = {}
    for kname, policy in (("fifo_queue_tightly", 0), ("fifo_queue_evenly", 1), ("fifo_queue_min_frag", 2)):
        def kernel(args, base, chk):
            if policy == 2:
                return mk.fifo_queue_min_frag(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)
            return qk.fifo_queue(*args, evenly=policy == 1, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)

        def plain(args, base, chk):
            if policy == 2:
                return mk.solve_queue_min_frag_plain(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)
            return qk.solve_queue_plain(*args, evenly=policy == 1, chk_base=base, chk_stride=DELTA_STRIDE,
                                        chk_out=chk)

        name = kname + "_checkpointed"
        blank = torch.full((k, n_b, 3), -7, dtype=torch.int32, device=queue_args[0].device)
        chk = blank.clone()
        got = kernel(queue_args, 0, chk)
        chk_plain = blank.clone()
        want, plain_ms = timed_once(lambda: plain(queue_args, 0, chk_plain))
        check(name, got + (chk,), want + (chk_plain,), "the main-path inputs, every checkpoint")
        r = 6 * DELTA_STRIDE
        suffix = (chk[5].clone(),) + queue_args[1:3] + tuple(x[r:] for x in queue_args[3:])
        s_chk_plain = blank.clone()
        s_want = plain(suffix, r, s_chk_plain)
        s_chk = blank.clone()
        s_got = kernel(suffix, r, s_chk)
        check(name, s_got + (s_chk,), s_want + (s_chk_plain,), f"a suffix pass from position {r}")
        for j in range(k):
            r = (j + 1) * DELTA_STRIDE
            resumed = (chk[j].clone(),) + queue_args[1:3] + tuple(x[r:] for x in queue_args[3:])
            r_chk = blank.clone()
            f, d, after = kernel(resumed, r, r_chk)
            check(name, (f, d, after, r_chk[j:]), (got[0][r:], got[1][r:], got[2], chk[j:]),
                  f"resumed from the checkpoint at position {r}")
        n_feasible = int(got[0].sum())
        per_app = MF_OPS_PER_NODE_FEASIBLE_APP if policy == 2 else OPS_PER_NODE_FEASIBLE_APP
        ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * per_app)
        n_bytes = queue_bytes + k * n_b * 12  # and each checkpoint written once
        ms = [time_cuda(lambda: kernel(queue_args, 0, chk), 5) for _ in range(3)]
        r = 6 * DELTA_STRIDE
        resume_ms = time_cuda(lambda: kernel(suffix, r, s_chk), 5)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        log(f"phase delta: {name} N={n_b} A={a_b} ({n_valid} valid, {k} checkpoints a stride of "
            f"{DELTA_STRIDE}): outputs and every checkpoint equal to the plain version, a suffix pass "
            f"from position {r} too, and a pass resumed from each of the {k} checkpoints equal to the "
            f"whole-queue pass; {statistics.median(ms):.3f} ms (runs {', '.join(f'{x:.3f}' for x in ms)}), "
            f"the suffix of {a_b - r} apps {resume_ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations {t_ops:.4f}) | {smi}")
        out[name] = (ms, plain_ms, t_bytes, t_ops)
    big_args = doubled_cluster(queue_args)
    n_big = big_args[0].shape[0]
    for kname, policy in (("fifo_queue_tightly", 0), ("fifo_queue_min_frag", 2)):
        def kernel(args, base, chk):
            if policy == 2:
                return mk.fifo_queue_min_frag(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)
            return qk.fifo_queue(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)

        def plain(args, base, chk):
            if policy == 2:
                return mk.solve_queue_min_frag_plain(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)
            return qk.solve_queue_plain(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)

        name = kname + "_checkpointed"
        blank = torch.full((k, n_big, 3), -7, dtype=torch.int32, device=big_args[0].device)
        chk, chk_plain = blank.clone(), blank.clone()
        got = kernel(big_args, 0, chk)
        want, plain_ms = timed_once(lambda: plain(big_args, 0, chk_plain))
        check(name, got + (chk,), want + (chk_plain,), f"N={n_big}, every checkpoint")
        r = 6 * DELTA_STRIDE
        suffix = (chk[5].clone(),) + big_args[1:3] + tuple(x[r:] for x in big_args[3:])
        s_chk, s_chk_plain = blank.clone(), blank.clone()
        s_want, s_plain_ms = timed_once(lambda: plain(suffix, r, s_chk_plain))
        check(name, kernel(suffix, r, s_chk) + (s_chk,), s_want + (s_chk_plain,), f"N={n_big}, a suffix from {r}")
        ms = [time_cuda(lambda: kernel(big_args, 0, chk), 5) for _ in range(3)]
        suffix_ms = [time_cuda(lambda: kernel(suffix, r, s_chk), 5) for _ in range(3)]
        n_feasible = int(got[0].sum())
        per_app = MF_OPS_PER_NODE_FEASIBLE_APP if policy == 2 else OPS_PER_NODE_FEASIBLE_APP
        ops = n_big * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * per_app)
        t_ops = ops / INT32_OPS_PER_S * 1e3
        log(f"phase delta: {name} N={n_big} A={a_b} ({n_valid} valid, {n_feasible} feasible, {k} checkpoints): "
            f"outputs and every checkpoint equal to the plain version, a suffix of {a_b - r} apps from "
            f"position {r} too; whole queue {statistics.median(ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in ms)}), suffix {statistics.median(suffix_ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in suffix_ms)}), plain {plain_ms:.1f} / {s_plain_ms:.1f} ms, "
            f"operations bound {t_ops:.4f} ms | {smi}")
    return out


def doubled_cluster(queue_args):
    """The main path's queue with its cluster twice over: every node
    plane repeated, the copies' driver ranks after the originals'."""
    avail, rank, exec_ok = queue_args[:3]
    n = avail.shape[0]
    rank2 = torch.where(rank < BIG, rank + n, rank)
    return (torch.cat([avail, avail]), torch.cat([rank, rank2]), torch.cat([exec_ok, exec_ok])) + tuple(queue_args[3:])


def unrelated_reservation(server, tag: str, created: float, node: str) -> None:
    """A reservation the measured Filters do not ask about: a driver pod
    (younger than every queued one) and its reservation created, seen by
    the mirror, then the pod deleted and the reservation collected."""
    from k8s_spark_scheduler_tpu_torch.scheduler.reservations_manager import new_resource_reservation
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types.resources import Resources

    pod = Harness.static_allocation_spark_pods(tag, 1, creation_timestamp=created)[0]
    stored = server.api.create(pod.deepcopy())
    server.api.create(new_resource_reservation(node, [node], stored, Resources.of("1", "1Gi"),
                                               Resources.of("1", "1Gi")))
    cache = server.scheduler.resource_reservation_cache
    wait_for(lambda: cache.get(pod.namespace, tag) is not None, "the unrelated reservation to reach the cache")
    server.retire([pod])


def delta_phase(seed: int, smi: str) -> dict:
    """Phase delta, steps 2 and 3 (see the module docstring); returns the
    launches of each kernel variant on the engine-on servers' runs.
    Raises SystemExit on any failure."""
    import logging
    import tempfile

    from k8s_spark_scheduler_tpu_torch.config import ProvenanceConfig
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.provenance.recorder import replay_bundle
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    workdir = tempfile.mkdtemp(prefix="chip-smoke-delta-")
    launches = {}
    try:
        names, nodes, queue, rng, base = server_objects(seed)
        # an enforced driver at the head of the queue that fits nowhere (one
        # 97-CPU executor, above every node's allocatable): every queued
        # driver's Filter is refused behind it, so the retries change nothing
        blocker = Harness.static_allocation_spark_pods(
            "delta-blocker", 1, executor_cpu="97", creation_timestamp=base - 1.0)[0]
        stamp = [base + N_APPS + 100.0]
        for pi, policy in enumerate(DELTA_POLICIES):
            t0 = time.perf_counter()
            servers = {}
            try:
                servers["on"] = PortServer(policy, "cuda", nodes, queue + [blocker], provenance=ProvenanceConfig(
                    max_bundle_nodes=BUNDLE_NODES, bundle_dir=os.path.join(workdir, policy)))
                servers["off"] = PortServer(policy, "cuda", nodes, queue + [blocker], delta_solve=False)
                servers["cpu"] = PortServer(policy, "cpu", nodes, queue + [blocker])
                on, off, cpu = servers["on"], servers["off"], servers["cpu"]
                engine = on.scheduler.extender.delta_engine
                if off.scheduler.extender.delta_engine is not None or engine is None:
                    raise SystemExit("the delta-solve switch did not reach the servers")
                depths = []
                record_warm = engine._record_warm

                def note_depth(resume, record_warm=record_warm):
                    depths.append(int(resume))
                    record_warm(resume)

                engine._record_warm = note_depth
                log(f"phase delta: {policy}: servers with delta-solve on (cuda), off (cuda) and on (cpu) "
                    f"ready in {time.perf_counter() - t0:.2f} s; {N_APPS} queued drivers behind an "
                    f"enforced driver that fits nowhere")
                kname = SERVER_KERNEL[policy]
                qk.reset_launch_counts()
                mk.reset_launch_counts()
                n_compared = n_granted = 0
                for seg, what in DELTA_SEGMENTS.items():
                    if seg not in DELTA_POLICIES[policy]:
                        continue
                    lat = {"on": [], "off": []}
                    traces = []
                    stats0, depth0 = engine.stats(), len(depths)
                    cold_compares = 0
                    for f in range(DELTA_FILTERS):
                        grant = seg == "c" and f % DELTA_GRANT_EVERY == DELTA_GRANT_EVERY - 1
                        if grant:
                            # older than the blocker: no earlier drivers, granted
                            pod = Harness.static_allocation_spark_pods(
                                f"delta-{pi}-grant-{f}", int(rng.randint(1, 8)),
                                executor_cpu=str(int(rng.randint(1, 4))), creation_timestamp=base - 10.0 - f)[0]
                            for server in servers.values():
                                server.api.create(pod.deepcopy())
                        else:
                            pod = queue[int(rng.randint(0, N_APPS))]
                            if seg == "b":
                                stamp[0] += 1
                                for side in ("on", "off"):
                                    unrelated_reservation(servers[side], f"delta-{pi}-unrelated-{f}", stamp[0],
                                                          names[int(rng.randint(0, len(names)))])
                        order = ("on", "off") if f % 2 else ("off", "on")
                        answers = {}
                        for side in order:
                            ms, status, body = servers[side].post(pod, names)
                            answers[side] = (status, body)
                            lat[side].append(ms)
                            if side == "on":
                                traces.append(on.scheduler.tracer.traces(limit=1)[0])
                        if answers["on"] != answers["off"] or answers["on"][0] != 200:
                            raise SystemExit(f"{policy} segment {seg} Filter {f}: on {answers['on'][1][:300]!r}, "
                                             f"off {answers['off'][1][:300]!r}")
                        ask_cpu = grant or (seg != "c" and f % DELTA_CPU_EVERY[policy] == 0) or (
                            seg == "c" and not grant and f > DELTA_GRANT_EVERY and cold_compares < DELTA_CPU_COLD)
                        if ask_cpu:
                            cold_compares += seg == "c" and not grant
                            n_compared += 1
                            if cpu.post(pod, names)[1:] != answers["on"]:
                                raise SystemExit(f"{policy} segment {seg} Filter {f}: cuda and cpu differ")
                        granted = bool(json.loads(answers["on"][1]).get("NodeNames"))
                        if granted != grant:
                            raise SystemExit(f"{policy} segment {seg} Filter {f}: granted={granted}, want {grant}: "
                                             f"{answers['on'][1][:300]!r}")
                        if grant:
                            n_granted += 1
                            for server in servers.values():
                                server.bind(pod, json.loads(answers["on"][1])["NodeNames"][0])
                    stats1 = engine.stats()
                    n = DELTA_FILTERS
                    warm = stats1["warm_hits"] - stats0["warm_hits"]
                    digest = stats1["digest_hits"] - stats0["digest_hits"]
                    cold = stats1["cold_solves"] - stats0["cold_solves"]
                    misses = {r: c - stats0["misses"].get(r, 0) for r, c in stats1["misses"].items()
                              if c - stats0["misses"].get(r, 0)}
                    seg_depths = depths[depth0:]
                    spans = {}
                    for trace in traces:
                        span_durations(trace["root"], spans)
                    for side in ("on", "off"):
                        log(f"phase delta: {policy} segment {seg} ({what}): delta-solve {side}: /predicates "
                            f"p50 {statistics.median(lat[side]):.3f} ms, p99 "
                            f"{float(np.percentile(lat[side], 99)):.3f} ms over {n} Filters (the 3 slowest "
                            f"{', '.join(f'{x:.1f}' for x in sorted(lat[side])[-3:])}) | {smi}")
                    log(f"phase delta: {policy} segment {seg}: bodies equal on and off; warm hits {warm} of {n} "
                        f"({100.0 * warm / n:.1f} %; class-digest tier {digest}), cold builds {cold}, misses "
                        f"{misses or 'none'}; resume depth p50 "
                        f"{statistics.median(seg_depths) if seg_depths else 'none'}, min "
                        f"{min(seg_depths) if seg_depths else 'none'}, max {max(seg_depths) if seg_depths else 'none'}"
                        f" of up to {N_APPS + 1} earlier apps")
                    log(f"phase delta: {policy} segment {seg}: span medians on (ms, spans seen / Filters) "
                        + ", ".join(f"{name} {statistics.median(spans[name]):.3f} ({len(spans[name])})"
                                    for name in DELTA_SPANS if name in spans) + f" | {smi}")
                    if seg == "a":
                        if warm < n - 1:
                            raise SystemExit(f"{policy} segment a: only {warm} of {n} Filters served warm")
                        pod = queue[int(rng.randint(0, N_APPS))]
                        log(f"phase delta: {policy}: profiler trace of one warm request (delta-solve on): "
                            f"{busy_share(lambda: on.post(pod, names))} | {smi}")
                        log(f"phase delta: {policy}: profiler trace of one cold request (delta-solve off): "
                            f"{busy_share(lambda: off.post(pod, names))} | {smi}")
                    if seg == "b" and digest < n - 1:
                        raise SystemExit(f"{policy} segment b: only {digest} of {n} Filters warmed by the digest")
                counts = {**qk.launch_counts, **mk.launch_counts}
                launches[kname + "_checkpointed"] = counts[kname + "_checkpointed"]
                log(f"phase delta: {policy}: {len(DELTA_POLICIES[policy]) * DELTA_FILTERS} Filters on each cuda "
                    f"server ({n_granted} "
                    f"granted), {n_compared} of them equal on a cpu server too; launches {counts} (the "
                    f"engine-off server's whole-queue passes count under {kname}, the session's under "
                    f"{kname}_checkpointed; the refusals' explanations under {kname})")
                if counts[kname + "_checkpointed"] < 1 or counts[kname] < 1:
                    raise SystemExit(f"{policy}: a kernel of the path was not launched: {counts}")
                if pi == 0:
                    # step 3: the session's warm-captured decisions, persisted
                    # and replayed through the kernel and the plain version
                    path = on.scheduler.provenance.recorder.persist("delta-phase", "warm captures")
                    with open(path) as fh:
                        bundles = [b for b in (json.loads(line) for line in fh if line.strip())
                                   if not b.get("header")]
                    replay_ms, resumes = [], []
                    for bundle in bundles:
                        if bundle["lane"] != SESSION_LANE:
                            raise SystemExit(f"bundle {bundle['seq']} captured on lane {bundle['lane']!r}")
                        t = time.perf_counter()
                        result = replay_bundle(bundle, device="cuda")
                        replay_ms.append((time.perf_counter() - t) * 1e3)
                        resumes.append(bundle["verdicts"]["resume"])
                        if not result["ok"] or result["lanes"] != {"cuda": "ok", "torch": "ok"}:
                            raise SystemExit(f"warm-captured bundle {bundle['seq']} replay: {result}")
                    if not any(resumes):
                        raise SystemExit(f"no replayed bundle was captured warm: resumes {resumes}")
                    log(f"phase delta: {len(bundles)} decisions captured on lane {SESSION_LANE} (resumed at "
                        f"{resumes}) persisted and replayed cold through the cuda kernel and the plain version, "
                        f"equal to their recorded verdicts; {statistics.median(replay_ms):.1f} ms a bundle with "
                        f"both lanes | {smi}")
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        logging.disable(logging.NOTSET)
    return launches


# -- phase observatory: the capacity observatory and the lifecycle ledger ------

OBSERVATORY_POLICY = "tpu-batch"
OBSERVATORY_WARM = 4  # probes on all three servers before the cuda and cpu samples
OBSERVATORY_PROBES = 100  # granted probes, each retired, on each of the on and off servers
# the probes go in blocks of this many, on and off in turns (on, off, off,
# on, ...), each block's probes posted to its own server alone: all
# servers share one process, so a probe of the off server taken while the
# on server samples would pay the on server's cost, and a probe of the off
# server between two on probes would give the on server's threads time
# outside the timed windows; each block starts once the on server's
# background work has stopped
OBSERVATORY_BLOCK = 25
OBSERVATORY_REPS = 5  # CUDA-event timings of each probe program, and samples timed
# the fields of a capacity sample that name the serving process or the
# host's clock rather than the cluster: the sample's time source read, its
# cost, where the probes ran, the mirror's process-local instance number,
# and the queue entries' ages and forecasts (the host clock's now)
SAMPLE_HOST_FIELDS = ("t", "sampleMs", "probeLane")
QUEUE_HOST_FIELDS = ("ageSeconds", "forecastSeconds")


def sample_fields(sample: dict) -> dict:
    out = {k: v for k, v in sample.items() if k not in SAMPLE_HOST_FIELDS}
    out["contentKey"], out["structureKey"] = sample["contentKey"][1:], sample["structureKey"][1:]
    out["classes"] = {k: v for k, v in sample["classes"].items() if k != "expandMs"}
    out["queue"] = [{k: v for k, v in e.items() if k not in QUEUE_HOST_FIELDS} for e in sample["queue"]]
    return out


def probe_programs_ms(server, sample: dict):
    """The sampler's two device programs as it runs them, on the server's
    current snapshot and the sample's shapes, each timed by CUDA events
    (median of OBSERVATORY_REPS after one warmup) and its headroom held
    to the sample's: the row-level frag report and headroom search over
    the cluster and its (instance-group, zone) combos, and the class lane
    (grouping, weighted frag report and search).  Returns (row ms, class
    ms, segments)."""
    from k8s_spark_scheduler_tpu_torch.capacity.observatory import CapacitySample

    sampler = server.scheduler.capacity
    snap = server.scheduler.tensor_snapshot.snapshot()
    avail, elig = snap.avail, snap.ready & ~snap.unschedulable
    layout = sampler._layout(snap)
    shape_list = []
    for key in sorted(sample["headroom"]):  # d<cpu>.<mem>.<gpu>-e<cpu>.<mem>.<gpu>
        d, e = key[1:].split("-e")
        shape_list.append((key, (tuple(int(x) for x in d.split(".")), tuple(int(x) for x in e.split(".")))))
    shape_rows = np.array([list(d) + list(e) for _, (d, e) in shape_list], dtype=np.int64)

    def row_level():
        out = CapacitySample(seq=0, content_key=(), structure_key=(), t=0.0, trigger="timed")
        sampler._row_level(avail, elig, shape_list, shape_rows, layout, True, out)
        return {key: entry["headroom"] for key, entry in out.headroom.items()}

    def class_lane():
        out = CapacitySample(seq=0, content_key=(), structure_key=(), t=0.0, trigger="timed")
        sampler._class_lane(snap, avail, elig, shape_list, shape_rows, out)
        return out.classes["headroom"]

    out = []
    for fn, want in ((row_level, {k: v["headroom"] for k, v in sample["headroom"].items()}),
                     (class_lane, sample["classes"]["headroom"])):
        if fn() != want:
            raise SystemExit(f"the timed {fn.__name__} program's headroom differs from the sample's")
        out.append(statistics.median(time_cuda(fn, 1) for _ in range(OBSERVATORY_REPS)))
    return out[0], out[1], len(layout.combos) + 1


# the parts of one sample, in the order the sampler runs them: the
# snapshot copy, the pending-driver listing and sort, the gangs' demand
# parse, the (group, zone) layout (cached per structure), the row-level
# programs, the class lane, the tenant sums, the forecast; and the gauges,
# published after sampleMs is taken
SAMPLE_PARTS = ("_pending_drivers", "_gang_rows", "_layout", "_row_level", "_class_lane", "_tenants",
                "_forecast", "_publish")


def sample_split(sampler, reps: int) -> tuple:
    """``reps`` whole samples, each part timed by the host clock around
    the sampler's own method: (sampleMs of each, {part: median ms})."""
    spent = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t) * 1000.0
        return wrapper

    class Cache:
        def __init__(self, cache):
            self._cache = cache
            self.snapshot = timed("snapshot", cache.snapshot)

        def __getattr__(self, name):
            return getattr(self._cache, name)

    cache = sampler._cache
    sampler._cache = Cache(cache)
    for name in SAMPLE_PARTS:
        setattr(sampler, name, timed(name, getattr(sampler, name)))
    runs, parts = [], {}
    try:
        for _ in range(reps):
            spent.clear()
            t = time.perf_counter()
            sample = sampler.sample_now()
            spent["whole call"] = (time.perf_counter() - t) * 1000.0
            runs.append(sample.sample_ms)
            for name, ms in spent.items():
                parts.setdefault(name, []).append(ms)
    finally:
        sampler._cache = cache
        for name in SAMPLE_PARTS:
            delattr(sampler, name)
    return runs, {name: statistics.median(ms) for name, ms in parts.items()}


def observatory_phase(seed: int, smi: str) -> None:
    """Phase observatory (see the module docstring).  Raises SystemExit on
    any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        servers = {}
        try:
            servers["on"] = PortServer(OBSERVATORY_POLICY, "cuda", nodes, queue)
            servers["off"] = PortServer(OBSERVATORY_POLICY, "cuda", nodes, queue, observatories=False)
            servers["cpu"] = PortServer(OBSERVATORY_POLICY, "cpu", nodes, queue)
            on, off, cpu = servers["on"], servers["off"], servers["cpu"]
            if off.scheduler.capacity is not None or on.scheduler.capacity is None:
                raise SystemExit("the observatories' switch did not reach the servers")
            log(f"phase observatory: {OBSERVATORY_POLICY}: servers with the observatories on (cuda), off (cuda) "
                f"and on (cpu) ready in {time.perf_counter() - t0:.2f} s")
            served = {side: 0 for side in servers}

            def probe(tag: str, sides) -> tuple:
                """A small gang that fits: its Filter on each side in order,
                bodies equal, then retired everywhere."""
                pods = Harness.static_allocation_spark_pods(
                    tag, int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 5))),
                    executor_mem=f"{int(rng.randint(2, 9))}Gi", creation_timestamp=base + N_APPS + sum(served.values()))
                for side in sides:
                    servers[side].api.create(pods[0].deepcopy())
                answers, ms = {}, {}
                for side in sides:
                    ms[side], status, body = servers[side].post(pods[0], names)
                    answers[side] = (status, body)
                    served[side] += 1
                first = answers[sides[0]]
                if any(a != first for a in answers.values()) or first[0] != 200:
                    raise SystemExit(f"observatory probe {tag}: " + ", ".join(
                        f"{side} {a[0]} {a[1][:200]!r}" for side, a in answers.items()))
                if not json.loads(first[1]).get("NodeNames"):
                    raise SystemExit(f"observatory probe {tag} was not granted: {first[1][:300]!r}")
                for side in sides:
                    servers[side].retire(pods[:1])
                return ms

            # 1. the same Filters on all three, then a sample on cuda and cpu
            for i in range(OBSERVATORY_WARM):
                probe(f"obs-warm-{i}", ("on", "off", "cpu"))
            for side in ("on", "cpu"):
                servers[side].settle_embedded()
            samples = {side: servers[side].scheduler.capacity.sample_now().to_dict() for side in ("on", "cpu")}
            if sample_fields(samples["on"]) != sample_fields(samples["cpu"]):
                diff = [k for k in samples["on"] if sample_fields(samples["on"]).get(k)
                        != sample_fields(samples["cpu"]).get(k)]
                raise SystemExit(f"phase observatory: the cuda and cpu samples differ in {diff}")
            s = samples["on"]
            if s["probeLane"] != "cuda" or samples["cpu"]["probeLane"] != "torch" or s["nodes"] != N_NODES:
                raise SystemExit(f"phase observatory: lanes {s['probeLane']} / {samples['cpu']['probeLane']}, "
                                 f"{s['nodes']} nodes")
            log(f"phase observatory: after {OBSERVATORY_WARM} Filters on each server, the cuda and cpu samples "
                f"are equal (less {', '.join(SAMPLE_HOST_FIELDS)}, classes.expandMs, the mirror's instance "
                f"number and the queue's {', '.join(QUEUE_HOST_FIELDS)}): seq {s['seq']}, {s['nodes']} nodes, "
                f"{len(s['headroom'])} shapes ({s['shapesDropped']} dropped), {len(s['groups'])} groups, "
                f"{s['classes']['count']} classes, {s['queuedGangs']} queued gangs, pressure {s['pressure']}, "
                f"{s['probeSolves']} probe solves; sampleMs cuda {s['sampleMs']}, cpu "
                f"{samples['cpu']['sampleMs']} (expandMs {s['classes']['expandMs']} / "
                f"{samples['cpu']['classes']['expandMs']})")

            # 2. the probe programs by CUDA events, and whole samples
            row_ms, class_ms, n_segments = probe_programs_ms(on, s)
            sample_ms, parts = sample_split(on.scheduler.capacity, OBSERVATORY_REPS)
            log(f"phase observatory: the sampler's programs at {N_NODES} nodes x {len(s['headroom'])} shapes "
                f"(upload, program, one copy out), CUDA events, median of {OBSERVATORY_REPS}: row-level (frag "
                f"report and headroom search over {n_segments} segments: the cluster and its (group, zone) "
                f"combos) {row_ms:.3f} ms, class lane ({s['classes']['count']} classes: grouping, frag report "
                f"and search) {class_ms:.3f} ms; a whole sample (host clock) median "
                f"{statistics.median(sample_ms):.3f} ms (runs {', '.join(f'{x:.1f}' for x in sample_ms)}) | {smi}")
            inside = sum(parts.get(name, 0.0) for name in ("snapshot",) + SAMPLE_PARTS[:-1])
            log(f"phase observatory: one sample's parts, host clock, median of {OBSERVATORY_REPS} ms: "
                + ", ".join(f"{name.strip('_')} {parts.get(name, 0.0):.3f}" for name in ("snapshot",) + SAMPLE_PARTS)
                + f"; the rest of sampleMs {statistics.median(sample_ms) - inside:.3f}, the whole call "
                f"{parts['whole call']:.3f} | {smi}")

            # 3. granted probes on the on and off cuda servers, in blocks in turns
            def quiet(server) -> None:
                """Until the server's sampler and ledger stop counting."""
                last, deadline = None, time.monotonic() + WAIT_S
                while time.monotonic() < deadline:
                    now = (server.scheduler.capacity.stats()["samples"], server.scheduler.lifecycle.stats()["drains"])
                    if now == last:
                        return
                    last = now
                    time.sleep(0.6)
                raise SystemExit("phase observatory: the on server's background work did not stop")

            cap0, led0 = on.scheduler.capacity.stats(), on.scheduler.lifecycle.stats()
            lat = {"on": [], "off": []}
            blocks = ["on", "off", "off", "on"] * (OBSERVATORY_PROBES // (2 * OBSERVATORY_BLOCK))
            for b, side in enumerate(blocks):
                quiet(on)
                for j in range(OBSERVATORY_BLOCK):
                    lat[side].append(probe(f"obs-probe-{b}-{j:02d}", (side,))[side])
            cap1, led1 = on.scheduler.capacity.stats(), on.scheduler.lifecycle.stats()
            quiet(on)
            ledger = on.scheduler.lifecycle
            drain_ms = []
            for _ in range(OBSERVATORY_REPS):
                t = time.perf_counter()
                ledger.drain(trigger="timed")
                drain_ms.append((time.perf_counter() - t) * 1000.0)
            for side in ("on", "off"):
                log(f"phase observatory: {OBSERVATORY_POLICY} observatories {side}: /predicates p50 "
                    f"{statistics.median(lat[side]):.3f} ms, p99 {float(np.percentile(lat[side], 99)):.3f} ms over "
                    f"{len(lat[side])} granted probes, each retired, in blocks of {OBSERVATORY_BLOCK} in turns "
                    f"({', '.join(blocks)}; the 3 slowest "
                    f"{', '.join(f'{x:.1f}' for x in sorted(lat[side])[-3:])}) | {smi}")
            log(f"phase observatory: over those probes the on server took {cap1['samples'] - cap0['samples']} "
                f"samples ({cap1['skipped_unchanged'] - cap0['skipped_unchanged']} skipped unchanged, "
                f"{cap1['probe_solves'] - cap0['probe_solves']} probe solves) and {led1['drains'] - led0['drains']} "
                f"ledger drains ({led1['skipped_unchanged'] - led0['skipped_unchanged']} skipped); a ledger drain "
                f"with nothing new (host clock, median of {OBSERVATORY_REPS}) "
                f"{statistics.median(drain_ms):.3f} ms | {smi}")

            # 4. no probe or drain under the predicate lock, no class-lane failure
            for side in ("on", "cpu"):
                sched = servers[side].scheduler
                bad = (sched.capacity.lock_violations, sched.lifecycle.lock_violations,
                       sched.capacity.stats()["class_lane_failures"])
                if any(bad):
                    raise SystemExit(f"phase observatory: {side} server lock violations (sampler, ledger) and "
                                     f"class-lane failures {bad}")

            # 5. what an operator reads
            _, body = on.get("/slo")
            card = json.loads(body)
            counted = card["objectives"]["filter_latency"]["total"]
            if counted < served["on"]:
                raise SystemExit(f"/slo counted {counted} Filters, the server served {served['on']}")
            _, body = on.get("/lifecycle")
            listed = {g["app"] for g in json.loads(body)["gangs"]}
            apps = {f"obs-warm-{i}" for i in range(OBSERVATORY_WARM)} | {
                f"obs-probe-{b}-{j:02d}" for b, side in enumerate(blocks) if side == "on"
                for j in range(OBSERVATORY_BLOCK)}
            if apps - listed:
                raise SystemExit(f"/lifecycle lacks {sorted(apps - listed)[:5]}")
            _, body = on.get("/state/capacity")
            latest = json.loads(body)
            if latest["nodes"] != N_NODES or latest["probeLane"] != "cuda":
                raise SystemExit(f"/state/capacity: {body[:300]!r}")
            log(f"phase observatory: /slo filter_latency counted {counted} of the {served['on']} Filters served "
                f"(state {card['objectives']['filter_latency']['state']}), /lifecycle lists all "
                f"{len(apps)} probe apps among {len(listed)} gangs, /state/capacity seq {latest['seq']}; lock "
                f"violations 0 and class-lane failures 0 on the cuda and cpu servers")
        finally:
            for server in servers.values():
                server.stop()
    finally:
        logging.disable(logging.NOTSET)


def session_stream(problem, n_earlier: int, smi: str) -> None:
    """Phase delta, step 3 at the library layer: one FifoSession on the
    card and one on the CPU fed the same stream of queues from the main
    path's snapshot (a whole queue, an identical resubmit, arrivals, one
    app changed mid-queue, the head popped, a cut), every step equal on
    both, resume positions included, and equal to the stateless pass."""
    from k8s_spark_scheduler_tpu_torch.ops.fifo_session import FifoSession, solve_packed_cold

    rows = np.zeros((problem.driver.shape[0], 8), np.int32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7] = (problem.driver, problem.executor, problem.count,
                                                          problem.app_valid)
    queue = rows[:n_earlier]
    changed = queue.copy()
    changed[n_earlier // 2] = queue[7]
    first = 9 * n_earlier // 10
    stream = [("whole queue", queue[:first]), ("identical resubmit", queue[:first]), ("arrivals", queue),
              ("one app changed mid-queue", changed), ("head popped", changed[1:]),
              ("cut", changed[1: 3 * n_earlier // 10])]
    card, host = FifoSession(device="cuda"), FifoSession(device="cpu")
    for s in (card, host):
        s.load(problem.avail, problem.driver_rank, problem.exec_ok, 0, stride=DELTA_STRIDE)
    steps = []
    for what, q in stream:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = card.solve(q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        want = host.solve(q)
        cold = solve_packed_cold(0, card.basis, card.driver_rank, card.exec_ok, q, device="cuda")
        if got[0] != want[0] or not (np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
                                     and torch.equal(got[3].cpu(), want[3])):
            raise SystemExit(f"session stream, {what}: the card's session differs from the cpu session")
        if not (np.array_equal(got[1], cold[0]) and np.array_equal(got[2], cold[1]) and torch.equal(got[3], cold[2])):
            raise SystemExit(f"session stream, {what}: the session differs from the stateless pass")
        steps.append(f"{what} ({len(q)} apps): resume {got[0]}, {ms:.3f} ms")
    log(f"phase delta: session stream at the library layer (tightly-pack, {problem.avail.shape[0]} nodes, "
        f"stride {DELTA_STRIDE}), equal on cuda and cpu and to the stateless pass: " + "; ".join(steps)
        + f"; {card.checkpoints()} live checkpoints, {card.mem_bytes()} bytes | {smi}")


def serde_rr(rr) -> dict:
    from k8s_spark_scheduler_tpu_torch.types import serde

    return serde.rr_to_dict_v1beta2(rr)


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


# each kernel library's launch function, timed by traced_device_time
LAUNCH_FUNCTIONS = {"queue": "fifo_queue_launch", "min_frag": "fifo_queue_min_frag_launch",
                    "single_az": "fifo_queue_single_az_launch"}


def traced_device_time(fn):
    """Run fn once under torch.profiler: (device busy ms, host-clock ms of
    the call with the profiler's overhead, the port's kernel launches in
    the call, those of them the trace holds), or busy None when the call
    left no device work.  The busy time is the union of the trace's device
    intervals other than the port's kernels, plus each launch of the
    port's kernels timed by CUDA events recorded around it on its stream:
    a trace of a server's Filter does not always hold the kernel the
    Filter launched through its ctypes library (PERF.md section 7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk

    launches = []
    patched = []
    for module, kind in ((qk, "queue"), (mk, "min_frag"), (sk, "single_az")):
        lib = module.LIBRARY.load()
        name = LAUNCH_FUNCTIONS[kind]
        launch = getattr(lib, name)

        def timed_launch(*a, _launch=launch):
            stream = torch.cuda.current_stream()
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record(stream)
            err = _launch(*a)
            end.record(stream)
            launches.append((begin, end))
            return err

        setattr(lib, name, timed_launch)
        patched.append((lib, name, launch))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for lib, name, launch in patched:
            setattr(lib, name, launch)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    seen = sum("fifo_queue" in e.name for e in device_events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events if "fifo_queue" not in e.name)
    kernel_ms = sum(begin.elapsed_time(end) for begin, end in launches)
    if not spans and not launches:
        return None, wall_ms, 0, 0
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us / 1e3 + kernel_ms, wall_ms, len(launches), seen


def busy_share(fn) -> str:
    busy_ms, wall_ms, n_launches, seen = traced_device_time(fn)
    if busy_ms is None:
        return "not measured (no device work in the call)"
    return (f"device busy {busy_ms:.3f} ms of {wall_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.2f} % "
            f"({n_launches} kernel launches of the port, timed by events; the profiler's trace holds "
            f"{seen} of them)")


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
    max_err.update({kname + "_checkpointed": 0 for kname in ("fifo_queue_tightly", "fifo_queue_evenly",
                                                             "fifo_queue_min_frag")})

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
    # the explainer's launches: probe flags (a verdict, nothing subtracted)
    # and the per-app usage output, on the queue and min-frag kernels
    for ci, (n, a) in enumerate([(7, 20), (31, 17), (1000, 200), (12345, 48), (10240, 257), (100000, 16)]):
        rng = np.random.RandomState(args.seed * 1000 + 950 + ci)
        arrays = on(dev, random_queue(rng, n, a))
        probe = torch.as_tensor(rng.rand(a) < 0.5, device=dev)
        for evenly in (False, True):
            check("fifo_queue_evenly" if evenly else "fifo_queue_tightly",
                  qk.fifo_queue_explain(*arrays, probe, evenly=evenly),
                  qk.queue_plain(*arrays, evenly=evenly, probe=probe), f"probes and usage, N={n} A={a}")
        if n <= 12345:
            check("fifo_queue_min_frag", mk.fifo_queue_min_frag_explain(*arrays, probe),
                  mk.queue_min_frag_plain(*arrays, probe=probe), f"probes and usage, N={n} A={a}")
        log(f"phase kernel-vs-plain: queue{' and min-frag' if n <= 12345 else ''} kernels with probe "
            f"flags and the usage output, N={n} A={a} equal")
    # the delta-solve session's checkpointed launches: the carry before
    # every stride-th queue position into a [K, N, 3] buffer, from a queue
    # position chk_base on (queue and min-frag kernels; the queue kernel
    # also with its node planes in global scratch), slots past K skipped
    for ci, (n, a, stride, chk_base, slots) in enumerate([(7, 20, 3, 0, 6), (129, 64, 7, 13, 10),
                                                          (3000, 200, 16, 0, 8), (100000, 40, 8, 5, 5)]):
        arrays = on(dev, random_queue(np.random.RandomState(args.seed * 1000 + 970 + ci), n, a))
        chk_args = dict(chk_base=chk_base, chk_stride=stride)
        blank = torch.full((slots, n, 3), -7, dtype=torch.int32, device=dev)
        variants = [(kname, lambda c, evenly=evenly: qk.fifo_queue(*arrays, evenly=evenly, chk_out=c, **chk_args),
                     lambda c, evenly=evenly: qk.solve_queue_plain(*arrays, evenly=evenly, chk_out=c, **chk_args))
                    for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly"))]
        if n <= 12345:
            variants.append(("fifo_queue_min_frag",
                             lambda c: mk.fifo_queue_min_frag(*arrays, chk_out=c, **chk_args),
                             lambda c: mk.solve_queue_min_frag_plain(*arrays, chk_out=c, **chk_args)))
        for kname, kernel, plain in variants:
            got_chk, want_chk = blank.clone(), blank.clone()
            check(kname + "_checkpointed", kernel(got_chk) + (got_chk,), plain(want_chk) + (want_chk,),
                  f"checkpoints N={n} A={a} stride={stride} base={chk_base} slots={slots}")
        log(f"phase kernel-vs-plain: checkpointed launches of the queue{' and min-frag' if n <= 12345 else ''} "
            f"kernels, N={n} A={a} stride {stride} from position {chk_base} into {slots} slots, outputs and "
            f"checkpoints equal")
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

    # the refusal explainer's launch at the main path's inputs: the queue
    # with a probe of the current app before every earlier app and after
    # the last (ops/explain.py), against the plain version on the card
    n_e = len(earlier)

    def explain_args(n_apps):
        idx = np.empty(2 * n_apps + 1, dtype=np.int64)
        idx[0::2], idx[1::2] = n_e, np.arange(n_apps)
        probe = np.zeros(idx.shape[0], dtype=bool)
        probe[0::2] = True
        inter_valid = np.where(probe, True, valid[np.minimum(idx, n_e)])
        return queue_args[:3] + on(dev, (problem.driver[idx], problem.executor[idx], problem.count[idx],
                                          inter_valid, probe))

    ex_args = explain_args(n_e)
    for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly")):
        got = qk.fifo_queue_explain(*ex_args, evenly=evenly)
        check(kname, got, qk.queue_plain(*ex_args[:7], evenly=evenly, probe=ex_args[7]),
              "the explainer's main-path launch")
        ms = [time_cuda(lambda: qk.fifo_queue_explain(*ex_args, evenly=evenly), 3) for _ in range(3)]
        log(f"phase main-path: {kname} explainer launch, {ex_args[3].shape[0]} apps ({n_e} probes of the "
            f"current app between the {n_e} earlier ones): {statistics.median(ms):.3f} ms, equal to the "
            f"plain version | {smi}")
    ex_small = explain_args(256)
    check("fifo_queue_min_frag", mk.fifo_queue_min_frag_explain(*ex_small),
          mk.queue_min_frag_plain(*ex_small[:7], probe=ex_small[7]), "the explainer's launch, 256 earlier apps")
    ms = [time_cuda(lambda: mk.fifo_queue_min_frag_explain(*ex_args), 3) for _ in range(3)]
    log(f"phase main-path: fifo_queue_min_frag explainer launch, {ex_args[3].shape[0]} apps: "
        f"{statistics.median(ms):.3f} ms (equal to the plain version over the first 256 earlier apps) | {smi}")

    # phase delta, steps 1 and 3: the checkpointed launches at these
    # inputs, and a session stream at the library layer
    delta_timing = delta_kernels(queue_args, n_valid, queue_bytes, check, smi)
    session_stream(problem, len(earlier), smi)

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
    server_launches = server_phase(args.seed, smi)
    log(f"phase server: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase 6: the server against a cluster over REST
    t = time.perf_counter()
    cluster_phase(args.seed, smi)
    log(f"phase cluster: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase 7: resilience and provenance through the server
    t = time.perf_counter()
    resilience_phase(args.seed, smi)
    log(f"phase resilience: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase delta: the delta-solve engine on against off through the server
    t = time.perf_counter()
    # the checkpointed launches of the main path: phase delta's engine-on
    # servers (tightly-pack, min-frag), phase 5's (distribute-evenly)
    delta_launches = {**server_launches, **delta_phase(args.seed, smi)}
    for kname, (ms, plain_ms, t_bytes, t_ops) in delta_timing.items():
        kind = "min_frag" if kname.startswith("fifo_queue_min_frag") else "queue"
        kernels.append(kernel_entry(kname, kind, delta_launches.get(kname, 0), max_err[kname], ms, plain_ms,
                                    t_bytes, t_ops))
    missing = [kname for kname in delta_timing if delta_launches.get(kname, 0) < 1]
    if missing:
        raise SystemExit(f"phase delta: {missing} not launched on the engine-on servers' path")
    log(f"phase delta: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase observatory: the capacity observatory and the lifecycle ledger
    t = time.perf_counter()
    observatory_phase(args.seed, smi)
    log(f"phase observatory: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase 10: results
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
