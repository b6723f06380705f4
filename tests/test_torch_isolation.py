"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never move to the CPU on their own."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            # exact names and their submodules; the port's own prefix
            # k8s_spark_scheduler_tpu_torch must stay importable
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    import k8s_spark_scheduler_tpu_torch
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain
    from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter
    from k8s_spark_scheduler_tpu_torch.ops.registry import select_binpacker

    meta = {
        f"n{i}": metadata_from_plain((8, "32Gi", 0), (8, "32Gi", 0), zone_label=f"z{i % 2}")
        for i in range(6)
    }
    d, e = NodeSorter().potential_nodes(meta, list(meta))
    earlier = [app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 4) for _ in range(3)]
    for policy in ("tightly-pack", "distribute-evenly"):
        solver = TpuFifoSolver(assignment_policy=policy, device="cpu")
        out = solver.solve(meta, d, e, earlier, [False] * 3,
                           app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 5))
        assert out.supported and out.earlier_ok and out.result.has_capacity, out
        assert solver.last_queue_lane == "torch"
    from k8s_spark_scheduler_tpu_torch.ops.tensorize import tensorize_apps, tensorize_cluster

    packer = GangPacker(device="cpu")
    q = packer.solve(packer.scale(tensorize_cluster(meta, d, e), tensorize_apps(earlier)))
    assert bool(q.feasible[:3].all())
    bp = select_binpacker("tpu-batch", device="cpu")
    r = bp.binpack_func(earlier[0].driver_resources, earlier[0].executor_resources, 4, d, e, meta)
    assert r.has_capacity

    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuSingleAzFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.registry import available_binpackers

    current = app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 2)
    solver = TpuFifoSolver(assignment_policy="minimal-fragmentation", device="cpu")
    out = solver.solve(meta, d, e, earlier, [False] * 3, current)
    assert out.supported and out.earlier_ok and out.result.has_capacity, out
    assert solver.last_queue_lane == "torch"
    for az_aware, inner in ((False, "tightly-pack"), (True, "tightly-pack"),
                            (False, "minimal-fragmentation")):
        solver = TpuSingleAzFifoSolver(az_aware=az_aware, inner_policy=inner, device="cpu")
        out = solver.solve(meta, d, e, earlier, [False] * 3, current)
        assert out.supported and out.earlier_ok and out.result.has_capacity, out
        assert solver.last_path == "fused"
    assert len(available_binpackers()) == 12
    for name in available_binpackers():
        bp = select_binpacker(name, device="cpu")
        r = bp.binpack_func(current.driver_resources, current.executor_resources, 2, d, e, meta)
        assert r.has_capacity, name
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("ISOLATED-OK")
    """
)


def test_port_runs_with_jax_and_reference_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


_BLOCKED_SERVE = textwrap.dedent(
    """
    import importlib, json, pkgutil, sys, urllib.request

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    import k8s_spark_scheduler_tpu_torch as port

    # every module of the package imports (the server CLI module too)
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(info.name)

    from k8s_spark_scheduler_tpu_torch.config import Install
    from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types import serde

    api = APIServer()
    scheduler = init_server_with_clients(api, Install(fifo=True, binpack_algo="tpu-batch"), device="cpu")
    http = ExtenderHTTPServer(scheduler, port=0, host="127.0.0.1")
    http.start()
    try:
        assert scheduler.wait_ready(60)
        h_nodes = [f"n{i}" for i in range(3)]
        from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
        from k8s_spark_scheduler_tpu_torch.types.resources import ZONE_LABEL, Resources
        for name in h_nodes:
            api.create(Node(meta=ObjectMeta(name=name, labels={ZONE_LABEL: "z1",
                            "resource_channel": "batch-medium-priority"}),
                            allocatable=Resources.of("8", "8Gi", "1")))
        pods = Harness.static_allocation_spark_pods("app-iso", 2)
        api.create(pods[0])
        body = json.dumps({"Pod": serde.pod_to_dict(pods[0]), "NodeNames": h_nodes}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{http.port}/predicates", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            result = json.loads(resp.read())
        assert result["NodeNames"] and result["NodeNames"][0] in h_nodes, result
    finally:
        http.stop()
        scheduler.stop()
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("SERVED-OK")
    """
)


def test_server_imports_and_serves_with_jax_and_reference_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SERVE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SERVED-OK" in proc.stdout


_BLOCKED_CLUSTER = textwrap.dedent(
    """
    import json, sys, time, urllib.request

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the REST / operator slice, each by name
    from k8s_spark_scheduler_tpu_torch.kube.restclient import ClusterConfig, GoneError, RestClient, load_kubeconfig
    from k8s_spark_scheduler_tpu_torch.kube.restbackend import RestAPIServer
    from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI
    from k8s_spark_scheduler_tpu_torch.testing.fake_autoscaler import FakeAutoscaler
    from k8s_spark_scheduler_tpu_torch.metrics import prometheus
    from k8s_spark_scheduler_tpu_torch.metrics.reporters import ReporterSet
    from k8s_spark_scheduler_tpu_torch.metrics.waste import WasteMetricsReporter
    from k8s_spark_scheduler_tpu_torch.scheduler import invariants
    from k8s_spark_scheduler_tpu_torch.scheduler.unschedulable import UnschedulablePodMarker
    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer, convert_review
    from k8s_spark_scheduler_tpu_torch.server.__main__ import main
    from k8s_spark_scheduler_tpu_torch.types.serde import convert_rr, demand_to_dict_v1alpha1

    from k8s_spark_scheduler_tpu_torch.config import Install
    from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types import serde
    from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu_torch.types.resources import ZONE_LABEL, Resources

    fake = FakeKubeAPI().start()
    fake.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
    for i in range(3):
        fake.api.create(Node(meta=ObjectMeta(name=f"n{i}", labels={ZONE_LABEL: "z1",
                             "resource_channel": "batch-medium-priority"}),
                             allocatable=Resources.of("8", "8Gi", "1")))
    backend = fake.client_backend()
    scheduler = init_server_with_clients(backend, Install(fifo=True, binpack_algo="tpu-batch"),
                                         demand_poll_interval=0.02, device="cpu")
    autoscaler = None
    http = ExtenderHTTPServer(scheduler, port=0, host="127.0.0.1")
    http.start()
    try:
        assert scheduler.wait_ready(60) and scheduler.lazy_demand_informer.wait_ready(10)
        autoscaler = FakeAutoscaler(fake.api, scheduler.lazy_demand_informer.informer())

        def post(path, payload):
            req = urllib.request.Request(f"http://127.0.0.1:{http.port}{path}",
                                         data=json.dumps(payload).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        def seen(name):
            deadline = time.monotonic() + 10
            while scheduler.pod_informer.get("default", name) is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)

        pods = Harness.static_allocation_spark_pods("app-rest", 2)
        fake.api.create(pods[0])
        seen(pods[0].name)
        result = post("/predicates", {"Pod": serde.pod_to_dict(pods[0]), "NodeNames": ["n0", "n1", "n2"]})
        assert result["NodeNames"], result
        deadline = time.monotonic() + 10
        while not fake.api.list("ResourceReservation"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        # a gang too large: its demand reaches the fake cluster over REST,
        # the fake autoscaler fulfils it with nodes
        big = Harness.static_allocation_spark_pods("app-big", 12, executor_cpu="4")
        fake.api.create(big[0])
        seen(big[0].name)
        result = post("/predicates", {"Pod": serde.pod_to_dict(big[0]), "NodeNames": ["n0", "n1", "n2"]})
        assert not result.get("NodeNames")
        deadline = time.monotonic() + 10
        while not autoscaler.fulfilled:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert invariants.check(scheduler) == []
        scheduler.reporters.report_once()
        scheduler.unschedulable_marker.scan_for_unschedulable_pods()
        req = urllib.request.Request(f"http://127.0.0.1:{http.port}/metrics", headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            text = resp.read().decode()
        assert "# TYPE foundry_spark_scheduler_requests counter" in text
        assert "foundry_spark_scheduler_cache_objects_count" in text
        review = post("/convert", {"request": {"uid": "u", "desiredAPIVersion": "sparkscheduler.palantir.com/v1beta1",
                                               "objects": [serde.rr_to_dict_v1beta2(fake.api.list("ResourceReservation")[0])]}})
        assert review["response"]["result"]["status"] == "Success", review
    finally:
        http.stop()
        scheduler.stop()
        backend.stop()
        fake.stop()
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("CLUSTER-OK")
    """
)


def test_rest_cluster_slice_runs_with_jax_and_reference_package_blocked():
    """The server over REST against the port's fake API, with the
    operator surface (Prometheus /metrics, /convert, the marker, the
    reporters, the invariant checker, the fake autoscaler), each new
    module imported by name."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CLUSTER],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CLUSTER-OK" in proc.stdout


_BLOCKED_PROVENANCE = textwrap.dedent(
    """
    import importlib, os, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    for name in ("resilience", "resilience.deadline", "resilience.gate", "resilience.breaker",
                 "resilience.journal", "resilience.health", "provenance", "provenance.records",
                 "provenance.explain", "provenance.recorder", "provenance.tracker", "ops.explain"):
        importlib.import_module("k8s_spark_scheduler_tpu_torch." + name)
    from k8s_spark_scheduler_tpu_torch.config import Install, ProvenanceConfig, ResilienceConfig
    from k8s_spark_scheduler_tpu_torch.kube.errors import APIError
    from k8s_spark_scheduler_tpu_torch.provenance import replay_bundle_file
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    tmp = tempfile.mkdtemp()
    install = Install(fifo=True, binpack_algo="tpu-batch",
                      resilience=ResilienceConfig(journal_path=os.path.join(tmp, "j.jsonl"),
                                                  breaker_failure_threshold=1),
                      provenance=ProvenanceConfig(bundle_dir=os.path.join(tmp, "b")))
    h = Harness(extra_install=install, device="cpu")
    try:
        h.new_node("n0", cpu="8", memory="32Gi")
        queued = h.static_allocation_spark_pods("app-q", 1, executor_cpu="4")[0]
        h.create_pod(queued)
        big = h.static_allocation_spark_pods("app-big", 1, executor_cpu="4")[0]
        r = h.schedule(big, ["n0"])
        msg = next(iter(r.failed_nodes.values()))
        assert "blocked by 1 earlier drivers (app-q-driver)" in msg, msg
        h.delete_pod(big)  # refused: it leaves the queue
        h.api.set_write_fault(lambda op, kind, ns, name: APIError("down") if kind == "ResourceReservation" else None)
        assert h.schedule(h.static_allocation_spark_pods("app-ok", 0)[0], ["n0"]).node_names
        kit, tracker = h.server.resilience, h.server.provenance
        assert h.wait_for_api(lambda: kit.journal.depth() == 1 and tracker.recorder.persisted_paths)
        h.api.set_write_fault(None)
        h.server.resource_reservation_cache.nudge_recovery(force=True)
        assert h.wait_for_api(lambda: kit.journal.depth() == 0)
        results = replay_bundle_file(tracker.recorder.persisted_paths[0], device="cpu")
        assert results and all(x["ok"] for x in results), results
    finally:
        h.close()
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("PROVENANCE-OK")
    """
)


def test_resilience_and_provenance_run_with_jax_and_reference_package_blocked():
    """The resilience kit and provenance, each module imported by name:
    a refusal explained, a write-back outage journaled and recovered, the
    breaker-open bundle replayed."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_PROVENANCE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PROVENANCE-OK" in proc.stdout


def test_package_sources_import_neither_jax_nor_reference_package():
    import re

    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|k8s_spark_scheduler_tpu)(\.|\s|$)"
        r"|from\s+(jax|jaxlib|k8s_spark_scheduler_tpu)(\.|\s))",
        re.M,
    )
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "k8s_spark_scheduler_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders


def test_entry_points_default_to_cuda_and_never_fall_back():
    from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker
    from k8s_spark_scheduler_tpu_torch.ops.batch_adapter import TpuBatchBinpacker, TpuSingleAzBinpacker
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.registry import TPU_BATCH_NAMES, select_binpacker

    constructors = (
        TpuFifoSolver,
        TpuBatchBinpacker,
        TpuSingleAzFifoSolver,
        TpuSingleAzBinpacker,
        GangPacker,
        lambda: TpuFifoSolver(device="cuda"),
        lambda: TpuFifoSolver("minimal-fragmentation"),
    ) + tuple(lambda name=name: select_binpacker(name) for name in TPU_BATCH_NAMES)
    for make in constructors:
        if torch.cuda.is_available():
            made = make()
            solver = getattr(made, "queue_solver", made)
            assert solver.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    # the simulator and its CLI: CUDA unless the caller asks for the CPU
    from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation
    from k8s_spark_scheduler_tpu_torch.sim.__main__ import main as sim_main

    smoke = os.path.join(REPO, "examples", "sim", "smoke.json")
    if torch.cuda.is_available():
        assert Simulation(Scenario.from_file(smoke)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation(Scenario.from_file(smoke))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sim_main(["--scenario", smoke, "--quiet"])
    # the world launcher: CUDA unless the caller asks, resolved before any
    # rank is spawned (the fake context records each rank's device and
    # refuses to start it)
    from unittest import mock

    from k8s_spark_scheduler_tpu_torch.parallel import launch

    class Refused(Exception):
        pass

    class Context:
        devices = []

        def Queue(self):
            return None

        def Process(self, target, daemon, args):
            Context.devices.append(args[5])
            raise Refused()

    with mock.patch.object(launch.multiprocessing, "get_context", lambda method: Context()):
        if torch.cuda.is_available():
            with pytest.raises(Refused):
                launch.run_world(print, 1)
            assert Context.devices == ["cuda"]
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                launch.run_world(print, 1)
            assert Context.devices == []
        with pytest.raises(Refused):
            launch.run_world(print, 1, device="cpu")
        assert Context.devices[-1] == "cpu"


def test_backend_must_match_device():
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver

    for solver in (TpuFifoSolver, TpuSingleAzFifoSolver):
        assert solver(backend="torch", device="cpu").backend == "torch"
        with pytest.raises(ValueError):
            solver(backend="cuda", device="cpu")


_BLOCKED_DELTA = textwrap.dedent(
    """
    import sys, time

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the delta-solve slice, each by name
    from k8s_spark_scheduler_tpu_torch.state.classindex import ClassIndex, labels_signature
    from k8s_spark_scheduler_tpu_torch.ops.fifo_session import FifoSession, solve_packed_cold
    from k8s_spark_scheduler_tpu_torch.ops.deltasolve import DeltaSolveEngine
    from k8s_spark_scheduler_tpu_torch.ops.fast_path import build_prep_keyed
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    h = Harness(binpack_algo="tpu-batch-minimal-fragmentation", is_fifo=True, device="cpu")
    try:
        names = [f"n{i}" for i in range(4)]
        for name in names:
            h.new_node(name, cpu="16", memory="32Gi")
        t0 = time.time()
        for i in range(6):
            h.create_pod(h.static_allocation_spark_pods(f"q{i}", 2, creation_timestamp=t0 - 100 + i)[0])
        big = h.static_allocation_spark_pods("big", 200, creation_timestamp=t0)[0]
        h.create_pod(big)
        for _ in range(3):
            assert not h.schedule(big, names).node_names
        stats = h.extender.delta_engine.stats()
        assert stats["cold_solves"] == 1 and stats["warm_hits"] == 2, stats
        assert h.server.tensor_snapshot.snapshot().class_digest[1] != -1
    finally:
        h.close()
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("DELTA-OK")
    """
)


def test_delta_solve_runs_with_jax_and_reference_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_DELTA],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DELTA-OK" in proc.stdout


_BLOCKED_OBSERVATORY = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the observatory slice, each by name
    from k8s_spark_scheduler_tpu_torch.capacity import CapacitySampler, in_predicate_lock
    from k8s_spark_scheduler_tpu_torch.capacity.probe import frag_segments, probe_segments
    from k8s_spark_scheduler_tpu_torch.capacity.observatory import CapacitySample
    from k8s_spark_scheduler_tpu_torch.ops.classes import group_rows
    from k8s_spark_scheduler_tpu_torch.lifecycle import LifecycleLedger, SloEngine, build_scorecard
    from k8s_spark_scheduler_tpu_torch.lifecycle.ledger import GangRecord
    from k8s_spark_scheduler_tpu_torch.lifecycle.slo import Objective
    from k8s_spark_scheduler_tpu_torch.lifecycle.scorecard import scorecard_digest
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    h = Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu")
    try:
        names = [f"n{i}" for i in range(4)]
        for i, name in enumerate(names):
            h.new_node(name, cpu="16", memory="32Gi", zone=f"z{i % 2}")
        pods = h.static_allocation_spark_pods("app", 2)
        for pod in pods:
            assert h.schedule(pod, names).node_names
        h.create_pod(h.static_allocation_spark_pods("queued", 500)[0])
        h.wait_quiesced()
        sample = h.server.capacity.sample_now(trigger="t")
        assert sample.probe_lane == "torch" and sample.pressure == 1 and len(sample.groups) == 2, sample
        assert sample.classes["count"] >= 1
        h.server.lifecycle.drain(trigger="t")
        card = build_scorecard(h.server.lifecycle, h.server.slo)
        assert card["lifecycle"]["gangs"] == 2 and card["digest"] == scorecard_digest(card)
        assert h.server.capacity.stats()["class_lane_failures"] == 0
    finally:
        h.close()
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("OBSERVATORY-OK")
    """
)


def test_observatory_and_lifecycle_run_with_jax_and_reference_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_OBSERVATORY],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OBSERVATORY-OK" in proc.stdout


_BLOCKED_CONTENTION = textwrap.dedent(
    """
    import importlib, os, sys

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the contention slice, each by name
    for name in ("analysis", "analysis.guarded", "analysis.racecheck", "contention",
                 "contention.locktime", "contention.criticalpath"):
        importlib.import_module("k8s_spark_scheduler_tpu_torch." + name)
    from k8s_spark_scheduler_tpu_torch.analysis import racecheck
    from k8s_spark_scheduler_tpu_torch.contention import locktime
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    os.environ[racecheck.ENV_FLAG] = "1"
    h = Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu")
    try:
        names = [f"n{i}" for i in range(3)]
        for name in names:
            h.new_node(name, cpu="16", memory="32Gi")
        for pod in h.static_allocation_spark_pods("app", 2):
            assert h.schedule(pod, names).node_names
        summary = h.server.criticalpath.summary()
        assert summary["requests"] == 3 and summary["dominant"], summary
        plock = locktime.snapshot("extender.predicate")
        assert plock and plock[0]["acquisitions"] == 3, plock
        h.server.capacity.sample_now(trigger="t")
        h.server.lifecycle.drain(trigger="t")
    finally:
        h.close()
        detector = racecheck.disable()
    assert detector.clean(), detector.report_lines()
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("CONTENTION-OK")
    """
)


def test_contention_and_race_detector_run_with_jax_and_reference_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CONTENTION],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CONTENTION-OK" in proc.stdout


_BLOCKED_POLICY = textwrap.dedent(
    """
    import importlib, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the policy and HA slices, each by name
    for name in ("ha", "ha.crashpoint", "ha.fencing", "ha.lease", "ha.reconcile", "ha.crashmatrix",
                 "policy", "policy.classes", "policy.ordering", "policy.drf",
                 "policy.victims", "policy.preempt", "policy.engine"):
        importlib.import_module("k8s_spark_scheduler_tpu_torch." + name)
    from k8s_spark_scheduler_tpu_torch.config import Install, PolicyConfig, ResilienceConfig
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    install = Install(
        fifo=True, binpack_algo="tpu-batch",
        resilience=ResilienceConfig(journal_path=tempfile.mkdtemp() + "/intents.jsonl"),
        policy=PolicyConfig(enabled=True, ordering="priority-then-fifo", backfill=True, preemption_enabled=True),
    )
    h = Harness(extra_install=install, device="cpu")
    try:
        names = ["n1", "n2"]
        for name in names:
            h.new_node(name, cpu="4", memory="4Gi")
        low = h.static_allocation_spark_pods("low", 5)
        for pod in low:
            pod.labels["spark-priority-band"] = "low"
            assert h.schedule(pod, names).node_names
        high = h.static_allocation_spark_pods("high", 4)
        for pod in high:
            pod.labels["spark-priority-band"] = "high"
        result = h.schedule(high[0], names)
        assert "preempting victims: low" in "; ".join(result.failed_nodes.values()), result
        h.wait_quiesced()
        for pod in high:
            assert h.schedule(pod, names).node_names
        state = h.server.policy.state()
        assert state["preemption"]["evictionsTotal"] == 1 and state["preemption"]["journalDepth"] == 0
    finally:
        h.close()
    # the HA fabric's planned handoff between two servers
    from k8s_spark_scheduler_tpu_torch.ha.crashmatrix import CrashMatrix

    report = CrashMatrix(nodes=2, device="cpu").run_handoff()
    assert report["ok"] and report["deposedRefusals"] == 5, report
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("POLICY-OK")
    """
)


def test_policy_engine_runs_with_jax_and_reference_package_blocked():
    """The policy and HA slices (policy/, ha/) import, preempt on the
    port's server and hand off between two servers with jax and the JAX
    package blocked."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_POLICY],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "POLICY-OK" in proc.stdout


_BLOCKED_CONCURRENT = textwrap.dedent(
    """
    import importlib, sys, threading

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the concurrent admission slice, each by name
    for name in ("concurrent", "concurrent.commitgate", "concurrent.speculation", "concurrent.engine"):
        importlib.import_module("k8s_spark_scheduler_tpu_torch." + name)
    from k8s_spark_scheduler_tpu_torch.config import Install
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

    install = Install.from_dict({"fifo": True, "binpack": "tpu-batch", "concurrent": {"enabled": True}})
    h = Harness(extra_install=install, device="cpu")
    try:
        names = ["n1", "n2"]
        for name in names:
            h.new_node(name, cpu="8", memory="16Gi")
        drivers = [h.create_pod(h.static_allocation_spark_pods(f"app-{i}", 1, creation_timestamp=1000.0 + i)[0])
                   for i in range(4)]
        engine = h.server.concurrent
        tickets = [engine.gate.ticket() for _ in drivers]
        results = [None] * len(drivers)

        def run(i):
            results[i] = engine.predicate(ExtenderArgs(pod=drivers[i], node_names=names), ticket=tickets[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(drivers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(r is not None and r.node_names for r in results), results
        stats = engine.stats()
        assert stats["gate"]["committed"] == 4 and sum(stats["commit_results"].values()) == 4, stats
    finally:
        h.close()
    # a crash cell in the speculation→commit window
    from k8s_spark_scheduler_tpu_torch.ha.crashmatrix import CrashMatrix

    report = CrashMatrix(nodes=2, device="cpu").run_point("concurrent.commit-written")
    assert report["ok"] and report["crashed"], report
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("CONCURRENT-OK")
    """
)


def test_concurrent_engine_runs_with_jax_and_reference_package_blocked():
    """The concurrent admission slice (concurrent/) imports, commits four
    drivers from four threads through the engine and runs a crash cell
    of its window with jax and the JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CONCURRENT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CONCURRENT-OK" in proc.stdout


_BLOCKED_SIM = textwrap.dedent(
    """
    import importlib, json, sys

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the simulator slice, each by name
    for name in ("sim", "sim.clock", "sim.workload", "sim.scenario", "sim.manifest", "sim.auditor",
                 "sim.runner", "sim.__main__"):
        importlib.import_module("k8s_spark_scheduler_tpu_torch." + name)
    from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation

    digests = {}
    for name, spec in json.loads(sys.argv[1]).items():
        result = Simulation(Scenario.from_dict(spec), device="cpu").run()
        assert result.violations == [], result.violations[:5]
        digests[name] = result.digest
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("SIM-DIGESTS " + json.dumps(digests, sort_keys=True))
    """
)


def test_simulator_runs_with_jax_and_reference_package_blocked():
    """The simulator slice (sim/) imports and runs ``smoke.json`` and the
    degraded chaos dict under ``tpu-batch`` with jax and the JAX package
    blocked: smoke to the reference's digest, the chaos dict (whose
    kernel fault answers errors in the port) to the port's own digest in
    a process that has both packages."""
    import json

    from k8s_spark_scheduler_tpu.sim import Scenario as JaxScenario
    from k8s_spark_scheduler_tpu.sim import Simulation as JaxSimulation
    from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation

    with open(os.path.join(REPO, "examples", "sim", "smoke.json")) as f:
        smoke = json.load(f)
    chaos = {
        "name": "degraded-smoke", "seed": 23, "duration": 300, "retry_interval": 15, "fifo": True,
        "binpack_algo": "tpu-batch",
        "cluster": {"nodes": 4, "cpu": "16", "memory": "32Gi", "zones": ["zone1", "zone2"]},
        "workload": {"process": "burst", "burst_interval": 60, "burst_size": 2, "executors": {"min": 1, "max": 4},
                     "dynamic_fraction": 0.9, "lifetime": {"min": 60, "max": 150}},
        "autoscaler": {"enabled": True, "delay": 20, "max_nodes": 8},
        "faults": [{"at": 55, "kind": "apiserver_outage", "duration": 60},
                   {"at": 50, "kind": "kernel_fault", "duration": 130},
                   {"at": 170, "kind": "apiserver_latency", "duration": 40},
                   {"at": 230, "kind": "executor_storm", "apps": 1, "fraction": 0.5}],
    }
    specs = {"smoke": smoke, "chaos-tpu-batch": chaos}
    want = {"smoke": JaxSimulation(JaxScenario.from_dict(smoke)).run().digest,
            "chaos-tpu-batch": Simulation(Scenario.from_dict(chaos), device="cpu").run().digest}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SIM, json.dumps(specs)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("SIM-DIGESTS "))
    assert json.loads(line[len("SIM-DIGESTS "):]) == want


_BLOCKED_LAB = textwrap.dedent(
    """
    import importlib, json, os, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    # the modules of the lab slice and its gate, each by name
    for name in ("lab", "lab.spec", "lab.synth", "lab.engine", "lab.report", "lab.runner",
                 "lab.__main__", "tools", "tools.policy_regression"):
        importlib.import_module("k8s_spark_scheduler_tpu_torch." + name)
    from k8s_spark_scheduler_tpu_torch.lab import MatrixSpec, SynthSpec, run_matrix, synthesize
    from k8s_spark_scheduler_tpu_torch.tools.policy_regression import main as gate_main

    with open(os.path.join("examples", "lab", "smoke_synth.json")) as f:
        apps = synthesize(SynthSpec.from_dict(json.load(f)))
    with open(os.path.join("examples", "lab", "smoke_matrix.json")) as f:
        matrix = run_matrix(MatrixSpec.from_dict(json.load(f)), apps=apps)
    path = os.path.join(tempfile.mkdtemp(), "matrix.json")
    with open(path, "w") as f:
        json.dump(matrix, f)
    code = gate_main(["--matrix-current", path])
    assert code == 0, code
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("LAB-DIGESTS " + json.dumps([c["digest"] for c in matrix["cells"]]))
    """
)


def test_lab_and_gate_run_with_jax_and_reference_package_blocked():
    """The lab slice (lab/ and tools/policy_regression) imports and runs
    the committed smoke matrix in-process with jax and the JAX package
    blocked, to the committed baseline's digests, and the port's gate
    passes that document against the baseline."""
    import json

    with open(os.path.join(REPO, "tests", "baselines", "matrix_smoke.json")) as f:
        want = [c["digest"] for c in json.load(f)["cells"]]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_LAB],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "policy-regression(matrix): PASS 3 cells byte-identical" in proc.stdout
    line = next(x for x in proc.stdout.splitlines() if x.startswith("LAB-DIGESTS "))
    assert json.loads(line[len("LAB-DIGESTS "):]) == want
