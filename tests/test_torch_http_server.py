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
            JaxInstall(fifo=True, binpack_algo="tpu-batch", delta_solve=False),
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
    status, body = _get(phttp.port, "/status/readiness")
    assert status == 200 and body["ready"] is True and body["state"] == "ready"
    assert body["components"]["demotedLanes"] == []
    status, metrics = _get(phttp.port, "/metrics")
    assert status == 200 and "counters" in metrics
    assert _get(phttp.port, "/nope")[0] == 404
    # a warmup that failed keeps readiness at 503 and wait_ready raises
    psched._warm_error = RuntimeError("nvcc failed")
    status, body = _get(phttp.port, "/status/readiness")
    assert status == 503 and body["ready"] is False and body["state"] == "unready"
    with pytest.raises(RuntimeError, match="kernel warmup failed"):
        psched.wait_ready(1)


def test_solver_error_answers_500_and_reaches_the_caller(both_served):
    _, _, papi, psched, phttp = both_served
    for wire in _node_wires(2):
        papi.create(object_from_wire(wire))
    solver = psched.extender.binpacker.queue_solver

    def broken(*args, **kwargs):
        raise RuntimeError("fifo_queue kernel launch failed with CUDA error 719")

    # both tensor lanes: the cold solve and the delta-solve session's pack
    # of the current driver
    solver.solve_tensor = solver._pack_current = broken
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


def _example_config_with_ca(tmp_path) -> str:
    """examples/install.json with its conversion webhook's CA bundle (a
    path of the deployment, /etc/scheduler/ca.crt) at a file that
    exists here; every other key unchanged."""
    with open(os.path.join(REPO, "examples", "install.json")) as f:
        raw = json.load(f)
    ca = tmp_path / "ca.crt"
    ca.write_bytes(b"-----BEGIN CERTIFICATE-----\nMIIB\n-----END CERTIFICATE-----\n")
    raw["conversion-webhook"]["ca-bundle-file"] = str(ca)
    path = tmp_path / "install.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_serves_the_example_config_on_cpu(tmp_path):
    """`--device cpu` serves examples/install.json (its CA bundle at a
    file that exists here): readiness answers 200, then SIGTERM stops
    the process cleanly."""
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.server", "--port", "0",
         "--config", _example_config_with_ca(tmp_path), "--device", "cpu"],
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


# (case id, config).  The id is the one the case had when ROADMAP
# numbered this item A.5.  The provenance and resilience sections
# (config1, config2, config10) load since both subsystems were ported,
# and so do delta-solve and classes (config0, config9), lifecycle and
# capacity (config4, config7; tests/test_torch_config.py), contention
# (config8, test_contention_config_loads_and_serves below), policy
# (config3; tests/test_torch_config.py
# test_policy_section_loads_as_in_the_reference), HA (config5;
# tests/test_torch_config.py test_ha_section_loads_as_in_the_reference)
# and, the last the config refused, concurrent admission (config6;
# tests/test_torch_config.py test_concurrent_section_loads_as_in_the_reference).
_REFUSED = [
    ("config6-A.5", {"concurrent": {"enabled": True}}),
]


@pytest.mark.parametrize("config", [case[1] for case in _REFUSED], ids=[case[0] for case in _REFUSED])
def test_install_refuses_keys_that_enable_unported_subsystems(config):
    """No section turns on a subsystem the port lacks any more: the last
    one the config refused loads, and no section is left to refuse."""
    from k8s_spark_scheduler_tpu_torch import config as config_module

    install = Install.from_dict(config)
    assert install.concurrent.enabled and install.reference_only == ()
    assert config_module._UNPORTED_SECTIONS == {}


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
    assert ours.delta_solve is theirs.delta_solve is True
    assert ours.classes.__dict__ == theirs.classes.__dict__
    assert ours.capacity.__dict__ == theirs.capacity.__dict__
    assert ours.lifecycle.__dict__ == theirs.lifecycle.__dict__
    # keys that leave an unported subsystem off are accepted
    off = {k: {"enabled": False} for k in ("provenance", "policy", "lifecycle", "ha",
                                            "concurrent", "capacity", "contention", "classes")}
    assert Install.from_dict(dict(off, **{"delta-solve": False})).delta_solve is False
    with pytest.raises(ValueError, match="unknown install key"):
        Install.from_dict({"binpak": "tpu-batch"})
    assert Install(delta_solve=True).delta_solve is Install().delta_solve is True


# -- contention observatory (contention/) -------------------------------------


def _serve_queue(japi, jhttp, papi, phttp, apps=3):
    """Nodes and ``apps`` one-executor drivers in both servers, each
    driver Filtered over HTTP by both; the bodies must be equal."""
    for wire in _node_wires(2):
        _create_both(japi, papi, wire)
    for i in range(apps):
        driver = static_pod_wires(f"app-cp-{i}", 1, T0 - 10 * (apps - i))[0]
        _create_both(japi, papi, driver)
        payload = {"Pod": driver, "NodeNames": ["n0", "n1"]}
        assert _post(phttp.port, "/predicates", payload) == _post(jhttp.port, "/predicates", payload)


def test_debug_criticalpath_endpoint(both_served):
    """/debug/criticalpath decomposes served requests into the named
    gating segments, per-request records reconstruct the request total,
    and the body has the reference's keys and request count."""
    japi, jhttp, papi, psched, phttp = both_served
    _serve_queue(japi, jhttp, papi, phttp)

    status, body = _get(phttp.port, "/debug/criticalpath")
    jstatus, jbody = _get(jhttp.port, "/debug/criticalpath")
    assert status == jstatus == 200 and body["enabled"] is True
    assert set(body) == set(jbody) and set(body["segments"]) == set(jbody["segments"])
    assert body["requests"] == jbody["requests"] == 3 and body["window"] == 3
    segs = body["segments"]
    for name in ("gate-queue", "lock-wait", "serde", "solve", "write-back", "other"):
        assert segs[name]["p99Ms"] >= 0.0
    # the solver does the work in this configuration
    assert segs["solve"]["p50Ms"] > 0.0
    assert body["totalMs"]["p99"] > 0.0
    assert 0.0 <= body["coverage"]["p50"] <= 1.0
    assert body["dominant"], "dominant-segment counter empty"

    status, body = _get(phttp.port, "/debug/criticalpath?limit=2")
    jstatus, jbody = _get(jhttp.port, "/debug/criticalpath?limit=2")
    assert status == 200 and len(body["recent"]) == 2
    assert [set(r) for r in body["recent"]] == [set(r) for r in jbody["recent"]]
    for record in body["recent"]:
        total = record["totalMs"]
        assert total > 0.0
        assert abs(sum(record["segments"].values()) - total) / total < 0.10, record
        assert record["traceId"]


def test_debug_contention_endpoint(both_served):
    """/debug/contention serves per-lock wait/hold distributions with
    holder-phase attribution, in the reference's schema; ?lock=
    filters."""
    japi, jhttp, papi, psched, phttp = both_served
    _serve_queue(japi, jhttp, papi, phttp, apps=1)

    status, body = _get(phttp.port, "/debug/contention")
    jstatus, jbody = _get(jhttp.port, "/debug/contention")
    assert status == jstatus == 200 and body["enabled"] is True
    assert set(body) == set(jbody)
    locks = {entry["name"]: entry for entry in body["locks"]}
    plock = locks["extender.predicate"]
    assert set(plock) == set(next(e for e in jbody["locks"] if e["name"] == "extender.predicate"))
    assert plock["acquisitions"] >= 1
    assert plock["sampleEvery"] == 1  # the predicate lock records every acquire
    assert plock["holdMs"]["count"] >= 1 and plock["holdMs"]["max"] > 0.0
    assert "http.request" in plock["byPhase"], plock["byPhase"]
    # the @guarded_by singletons are wrapped too (names = declaration site)
    assert any(name.endswith("._lock") for name in locks), sorted(locks)

    status, body = _get(phttp.port, "/debug/contention?lock=extender.predicate")
    assert status == 200
    assert [entry["name"] for entry in body["locks"]] == ["extender.predicate"]
    status, body = _get(phttp.port, "/debug/contention?lock=no-such-lock")
    assert status == 200 and body["locks"] == []


def _served_port(install):
    api = APIServer()
    api.create_crd(port_crd.DEMAND_CRD_NAME, port_crd.demand_crd_spec())
    scheduler = init_server_with_clients(api, install, demand_poll_interval=0.02, device="cpu")
    http = ExtenderHTTPServer(scheduler, port=0)
    http.start()
    return scheduler, http


def test_contention_endpoints_empty_and_disabled():
    """Empty cluster: both endpoints answer 200 with empty-but-well-formed
    payloads.  A server wired with contention.enabled=false reports
    disabled instead of erroring."""
    from k8s_spark_scheduler_tpu_torch.config import ContentionConfig

    scheduler, http = _served_port(Install(binpack_algo="tightly-pack"))
    try:
        status, body = _get(http.port, "/debug/criticalpath")
        assert status == 200 and body["enabled"] is True
        assert body["requests"] == 0 and body["window"] == 0
        assert body["totalMs"]["p99"] == 0.0
        status, body = _get(http.port, "/debug/contention")
        assert status == 200 and body["enabled"] is True  # locks exist, idle
    finally:
        http.stop()
        scheduler.stop()

    scheduler, http = _served_port(
        Install(binpack_algo="tightly-pack", contention=ContentionConfig(enabled=False))
    )
    try:
        assert _get(http.port, "/debug/contention") == (200, {"enabled": False, "locks": []})
        assert _get(http.port, "/debug/criticalpath") == (200, {"enabled": False, "requests": 0})
    finally:
        http.stop()
        scheduler.stop()


@pytest.mark.parametrize(
    "config, enabled",
    [({"contention": {"enabled": True}}, True), ({"contention": {"enabled": False}}, False)],
    ids=["config8-A.8", "contention-off"],
)
def test_contention_config_loads_and_serves(config, enabled):
    """The reference's ``contention`` section loads (it was refused
    before the observatory was ported) and switches both endpoints:
    ``{"enabled": false}`` answers their disabled forms."""
    install = Install.from_dict(dict(config, binpack="tpu-batch"))
    assert install.contention.enabled is enabled
    assert install.reference_only == ()
    scheduler, http = _served_port(install)
    try:
        assert (scheduler.contention is not None) is enabled
        assert (scheduler.criticalpath is not None) is enabled
        status, body = _get(http.port, "/debug/contention")
        assert status == 200 and body["enabled"] is enabled
        status, body = _get(http.port, "/debug/criticalpath")
        assert status == 200 and body["enabled"] is enabled
        if not enabled:
            assert body == {"enabled": False, "requests": 0}
    finally:
        http.stop()
        scheduler.stop()


def _get_raw(port, path, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, dict(resp.headers), resp.read()


def test_contention_gauges_render_in_plain_and_openmetrics(both_served):
    """The lock / critical-path metrics follow the exposition rules:
    plain 0.0.4 text under every Accept header, and the opt-in
    OpenMetrics flavour stays well-formed."""
    japi, jhttp, papi, psched, phttp = both_served
    _serve_queue(japi, jhttp, papi, phttp, apps=1)
    # reading /debug/contention drains pending lock samples into the registry
    assert _get(phttp.port, "/debug/contention")[0] == 200

    status, headers, raw = _get_raw(phttp.port, "/metrics", {"Accept": "text/plain;version=0.0.4"})
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    plain = raw.decode()
    for series in ("lock_acquire_count", "lock_hold_time",
                   "criticalpath_segment_time", "criticalpath_coverage",
                   "criticalpath_dominant_count"):
        assert f"foundry_spark_scheduler_tpu_{series}" in plain, series
    assert 'lock="extender.predicate"' in plain
    assert 'segment="solve"' in plain
    assert "# EOF" not in plain and "trace_id" not in plain

    status, headers, raw = _get_raw(phttp.port, "/metrics?format=openmetrics", {})
    assert status == 200
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    om = raw.decode()
    assert "foundry_spark_scheduler_tpu_lock_acquire_count" in om
    assert "foundry_spark_scheduler_tpu_criticalpath_segment_time" in om
    assert om.rstrip().endswith("# EOF")

    # strict OpenMetrics Accept still gets plain text
    status, headers, raw = _get_raw(
        phttp.port, "/metrics", {"Accept": "application/openmetrics-text;version=1.0.0"}
    )
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    assert b"foundry_spark_scheduler_tpu_lock_acquire_count" in raw
