"""The port's HTTP server held against the JAX package's: both servers
boot their full wiring on their own embedded API server, the same
payload sequence is POSTed to each over the wire (the end-to-end flow of
tests/test_http_server.py), and every /predicates response body must be
byte-for-byte equal.  Also: bad payloads answer 400, readiness, and the
no-fallback rules — a solver error answers 500, and the entry points
raise without CUDA."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.config import ProvenanceConfig as JaxProvenanceConfig
from k8s_spark_scheduler_tpu.kube.apiserver import APIServer as JaxAPIServer
from k8s_spark_scheduler_tpu.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
from k8s_spark_scheduler_tpu.server.http import ExtenderHTTPServer as JaxHTTPServer
from k8s_spark_scheduler_tpu.server.wiring import init_server_with_clients as jax_init
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu_torch import timesource as port_timesource
from k8s_spark_scheduler_tpu_torch.config import Install
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.kube import crd as port_crd
from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
from torch_parity import T0, static_pod_wires

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post_raw(port, path, data: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=data,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, payload):
    return _post_raw(port, path, json.dumps(payload).encode())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture
def both_served():
    """(jax api, jax http, port api, port scheduler, port http) on a
    pinned virtual clock; everything stopped in the finalizer."""
    jax_timesource.set_source(lambda: T0)
    port_timesource.set_source(lambda: T0)
    started = []
    try:
        japi = JaxAPIServer()
        japi.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        jsched = jax_init(
            japi,
            JaxInstall(
                fifo=True, binpack_algo="tpu-batch", delta_solve=False,
                provenance=JaxProvenanceConfig(enabled=False),
            ),
            demand_poll_interval=0.02,
        )
        started.append(jsched)
        jsched.lazy_demand_informer.wait_ready(5)
        jhttp = JaxHTTPServer(jsched, port=0)
        jhttp.start()
        started.append(jhttp)

        papi = APIServer()
        papi.create_crd(port_crd.DEMAND_CRD_NAME, port_crd.demand_crd_spec())
        psched = init_server_with_clients(
            papi, Install(fifo=True, binpack_algo="tpu-batch"),
            demand_poll_interval=0.02, device="cpu",
        )
        started.append(psched)
        psched.lazy_demand_informer.wait_ready(5)
        assert psched.wait_ready(30)
        phttp = ExtenderHTTPServer(psched, port=0)
        phttp.start()
        started.append(phttp)
        yield japi, jhttp, papi, psched, phttp
    finally:
        for thing in reversed(started):
            thing.stop()
        jax_timesource.reset()
        port_timesource.reset()


def _create_both(japi, papi, wire):
    kind = wire.get("kind") or "Pod"
    decode = jax_serde.node_from_dict if kind == "Node" else jax_serde.pod_from_dict
    japi.create(decode(dict(wire)))
    papi.create(object_from_wire(wire))


def _node_wires(count=3):
    from k8s_spark_scheduler_tpu.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu.types.resources import ZONE_LABEL, Resources

    return [
        jax_serde.node_to_dict(
            Node(
                meta=ObjectMeta(
                    name=f"n{i}",
                    labels={ZONE_LABEL: f"z{i % 2}", "resource_channel": "batch-medium-priority"},
                    creation_timestamp=T0,
                ),
                allocatable=Resources.of("8", "8Gi", "1"),
            )
        )
        for i in range(count)
    ]


def _bind(api, wire, node):
    pod = api.get("Pod", "default", wire["metadata"]["name"])
    pod.node_name = node
    pod.phase = "Running"
    api.update(pod)


def test_predicates_response_bytes_equal_the_reference(both_served):
    japi, jhttp, papi, psched, phttp = both_served
    for wire in _node_wires():
        _create_both(japi, papi, wire)
    nodes = ["n0", "n1", "n2"]
    apps = [
        static_pod_wires(f"app-{i}", 3, T0 - 10 * (5 - i), executor_cpu="2", executor_mem="2Gi")
        for i in range(5)
    ]
    for pods in apps:
        _create_both(japi, papi, pods[0])  # the whole queue exists before any Filter
    bodies = []
    for pods in apps:
        payload = {"Pod": pods[0], "NodeNames": nodes}
        jstatus, jbody = _post(jhttp.port, "/predicates", payload)
        pstatus, pbody = _post(phttp.port, "/predicates", payload)
        assert (pstatus, pbody) == (jstatus, jbody)
        assert pstatus == 200
        result = json.loads(pbody)
        bodies.append(result)
        if not result["NodeNames"]:
            continue
        node = result["NodeNames"][0]
        _bind(japi, pods[0], node)
        _bind(papi, pods[0], node)
        for exec_wire in pods[1:]:
            _create_both(japi, papi, exec_wire)
            payload = {"Pod": exec_wire, "NodeNames": nodes}
            jstatus, jbody = _post(jhttp.port, "/predicates", payload)
            pstatus, pbody = _post(phttp.port, "/predicates", payload)
            assert (pstatus, pbody) == (jstatus, jbody)
            assert json.loads(pbody)["NodeNames"]
    assert any(b["NodeNames"] for b in bodies) and not all(b["NodeNames"] for b in bodies)
    # reservations land in the API server asynchronously
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and len(papi.list("ResourceReservation")) != len(
        japi.list("ResourceReservation")
    ):
        time.sleep(0.01)
    assert {rr.name for rr in papi.list("ResourceReservation")} == {
        rr.name for rr in japi.list("ResourceReservation")
    }
    # the request went through the tensor lane, traced
    status, traces = _get(phttp.port, "/traces?limit=1")
    assert status == 200
    root = traces["traces"][0]["root"]
    assert root["name"] == "http.request"
    names = {c["name"] for c in root.get("children", [])}
    assert {"http.read", "serde.decode", "predicate", "serde.encode"} <= names


def test_bad_payloads_answer_400(both_served):
    _, jhttp, _, _, phttp = both_served
    for data in (b"{not json", b"[1, 2]"):
        jstatus, _ = _post_raw(jhttp.port, "/predicates", data)
        pstatus, _ = _post_raw(phttp.port, "/predicates", data)
        assert pstatus == jstatus == 400
    # a pod with no spark role: a failure result, not an error
    payload = {"Pod": {"metadata": {"name": "x", "uid": "u"}}, "NodeNames": ["n0"]}
    assert _post(phttp.port, "/predicates", payload) == _post(jhttp.port, "/predicates", payload)
    assert _post(phttp.port, "/nope", {})[0] == 404


def test_management_endpoints(both_served):
    _, _, _, psched, phttp = both_served
    assert _get(phttp.port, "/status/liveness") == (200, {"status": "up"})
    assert _get(phttp.port, "/status/readiness") == (200, {"ready": True})
    status, metrics = _get(phttp.port, "/metrics")
    assert status == 200 and "counters" in metrics
    assert _get(phttp.port, "/nope")[0] == 404
    # a warmup that failed keeps readiness at 503 and wait_ready raises
    psched._warm_error = RuntimeError("nvcc failed")
    assert _get(phttp.port, "/status/readiness") == (503, {"ready": False})
    with pytest.raises(RuntimeError, match="kernel warmup failed"):
        psched.wait_ready(1)


def test_solver_error_answers_500_and_reaches_the_caller(both_served):
    _, _, papi, psched, phttp = both_served
    for wire in _node_wires(2):
        papi.create(object_from_wire(wire))
    solver = psched.extender.binpacker.queue_solver

    def broken(*args, **kwargs):
        raise RuntimeError("fifo_queue kernel launch failed with CUDA error 719")

    solver.solve_tensor = broken
    pods = static_pod_wires("app-x", 1)
    papi.create(object_from_wire(pods[0]))
    status, body = _post(phttp.port, "/predicates", {"Pod": pods[0], "NodeNames": ["n0", "n1"]})
    assert status == 500
    assert b"CUDA error 719" in body
    # the same error propagates out of predicate for a direct caller
    from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

    pod = psched.pod_informer.get("default", pods[0]["metadata"]["name"])
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        psched.extender.predicate(ExtenderArgs(pod=pod, node_names=["n0", "n1"]))
    assert not papi.list("ResourceReservation")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_server_with_clients(APIServer(), Install(binpack_algo="tpu-batch"))
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Harness(binpack_algo="tpu-batch")
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.server", "--port", "0",
         "--config", os.path.join(REPO, "examples", "install.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_cli_serves_the_example_config_on_cpu():
    """`--device cpu` serves examples/install.json unchanged: readiness
    answers 200, then SIGTERM stops the process cleanly."""
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.server", "--port", "0",
         "--config", os.path.join(REPO, "examples", "install.json"), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert "extender serving on :" in line, proc.stderr.read() if proc.poll() is not None else line
        port = int(line.split(":")[1].split()[0])
        deadline = time.monotonic() + 30
        while _get(port, "/status/readiness")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.returncode == 0


@pytest.mark.parametrize(
    "config, item",
    [
        ({"delta-solve": True}, "A.5"),
        ({"provenance": {}}, "A.8"),
        ({"provenance": {"enabled": True}}, "A.8"),
        ({"policy": {"enabled": True}}, "A.8"),
        ({"lifecycle": {"enabled": True}}, "A.8"),
        ({"ha": {"enabled": True}}, "A.8"),
        ({"concurrent": {"enabled": True}}, "A.5"),
        ({"capacity": {}}, "A.8"),
        ({"contention": {"enabled": True}}, "A.8"),
        ({"classes": {}}, "A.5"),
        ({"resilience": {"request-deadline-seconds": 5}}, "A.8"),
    ],
)
def test_install_refuses_keys_that_enable_unported_subsystems(config, item):
    with pytest.raises(ValueError, match=item):
        Install.from_dict(config)


def test_install_reads_the_reference_keys():
    with open(os.path.join(REPO, "examples", "install.json")) as f:
        raw = json.load(f)
    from k8s_spark_scheduler_tpu.config import Install as JaxInstallCls

    ours, theirs = Install.from_dict(raw), JaxInstallCls.from_dict(raw)
    for name in ("fifo", "qps", "burst", "binpack_algo", "instance_group_label",
                 "unschedulable_pod_timeout_seconds", "strict_reference_parity",
                 "should_schedule_dynamically_allocated_executors_in_same_az"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.fifo_config.__dict__ == theirs.fifo_config.__dict__
    assert ours.async_client.__dict__ == theirs.async_client.__dict__
    assert ours.conversion_webhook.__dict__ == theirs.conversion_webhook.__dict__
    assert ours.delta_solve is False
    # keys that leave an unported subsystem off are accepted
    off = {k: {"enabled": False} for k in ("provenance", "policy", "lifecycle", "ha",
                                            "concurrent", "capacity", "contention", "classes")}
    assert Install.from_dict(dict(off, **{"delta-solve": False})).delta_solve is False
    with pytest.raises(ValueError, match="unknown install key"):
        Install.from_dict({"binpak": "tpu-batch"})
    with pytest.raises(ValueError, match="delta_solve"):
        Install(delta_solve=True)
