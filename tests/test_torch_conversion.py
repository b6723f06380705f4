"""The port's CRD version conversion: the ResourceReservation v1beta1
codecs and ``convert_rr``, the Demand v1alpha1 codecs, and the
``POST /convert`` webhook (``convert_review``), also served alone
(webhook-only mode, CLI ``--webhook-only``).  The reference package's
conversion cases (tests/test_serde.py, tests/test_http_server.py), plus
every codec and every ConversionReview response held equal to the JAX
package's on the same objects, byte for byte."""

import json
import random
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from k8s_spark_scheduler_tpu.server.http import ExtenderHTTPServer as JaxHTTPServer
from k8s_spark_scheduler_tpu.server.http import convert_review as jax_convert_review
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu.types.objects import (
    Demand,
    DemandSpec,
    DemandStatus,
    DemandUnit,
    ObjectMeta,
    Reservation,
    ResourceReservation,
    ResourceReservationSpec,
    ResourceReservationStatus,
)
from k8s_spark_scheduler_tpu.types.resources import Resources
from k8s_spark_scheduler_tpu_torch.config import Install
from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer, convert_review
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types import serde

RR_V1 = "sparkscheduler.palantir.com/v1beta1"
RR_V2 = "sparkscheduler.palantir.com/v1beta2"
DEMAND_V1 = "scaler.palantir.com/v1alpha1"
DEMAND_V2 = "scaler.palantir.com/v1alpha2"


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _post_raw(port, path, payload: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read()


def _random_rr(rng, trial) -> ResourceReservation:
    """A JAX-package reservation: driver + executors, GPU on some."""
    reservations = {}
    for i in range(rng.randint(1, 6)):
        name = "driver" if i == 0 else f"executor-{i}"
        reservations[name] = Reservation.for_resources(
            f"node-{rng.randint(0, 5)}",
            Resources.of(
                rng.choice(["1", "500m", "2500m"]),
                rng.choice(["1Gi", "512Mi", "3Gi"]),
                str(rng.randint(0, 4)),
            ),
        )
    return ResourceReservation(
        meta=ObjectMeta(
            name=f"app-{trial}",
            namespace=rng.choice(["default", "spark"]),
            labels={"spark-app-id": f"app-{trial}"},
            annotations={"team": "compute"} if rng.random() < 0.3 else {},
            resource_version=rng.randint(0, 50),
            uid=f"uid-{trial}" if rng.random() < 0.5 else "",
            creation_timestamp=1_700_000_000.0 + trial,
        ),
        spec=ResourceReservationSpec(reservations=reservations),
        status=ResourceReservationStatus(
            pods={n: f"pod-{n}" for n in list(reservations)[: rng.randint(0, len(reservations))]}
        ),
    )


def _random_demand(rng, trial) -> Demand:
    return Demand(
        meta=ObjectMeta(name=f"demand-pod-{trial}", labels={"spark-app-id": f"app-{trial}"}),
        spec=DemandSpec(
            units=[
                DemandUnit(
                    resources=Resources.of(str(rng.randint(1, 8)), f"{rng.randint(1, 16)}Gi"),
                    count=rng.randint(1, 20),
                    pod_names_by_namespace={"default": [f"p{trial}"]} if rng.random() < 0.5 else {},
                )
                for _ in range(rng.randint(1, 3))
            ],
            instance_group="batch",
            enforce_single_zone_scheduling=rng.random() < 0.5,
            zone=rng.choice([None, "az-a"]),
        ),
        status=DemandStatus(phase=rng.choice(["", "pending", "fulfilled"])),
    )


def test_serde_roundtrip_properties():
    """Randomized round-trips through the port's codecs: obj -> dict ->
    obj -> dict must be stable for reservations (both versions) and
    demands (both versions)."""
    rng = random.Random(2026)
    for trial in range(25):
        rr = serde.rr_from_dict_v1beta2(jax_serde.rr_to_dict_v1beta2(_random_rr(rng, trial)))
        d2 = serde.rr_to_dict_v1beta2(rr)
        assert serde.rr_to_dict_v1beta2(serde.rr_from_dict_v1beta2(d2)) == d2
        # v1beta1 round trip through the hub is lossless on the spec
        d1 = serde.rr_to_dict_v1beta1(rr)
        back = serde.rr_from_dict_v1beta1(d1)
        assert serde.rr_to_dict_v1beta2(back)["spec"] == d2["spec"]
        assert back.status.pods == rr.status.pods

        demand = serde.demand_from_dict_v1alpha2(
            jax_serde.demand_to_dict_v1alpha2(_random_demand(rng, trial))
        )
        da2 = serde.demand_to_dict_v1alpha2(demand)
        assert serde.demand_to_dict_v1alpha2(serde.demand_from_dict_v1alpha2(da2)) == da2
        da1 = serde.demand_to_dict_v1alpha1(demand)
        back_d = serde.demand_from_dict_v1alpha1(da1)
        da2_back = serde.demand_to_dict_v1alpha2(back_d)
        assert da2_back["spec"] == da2["spec"]
        assert da2_back["status"] == da2["status"]


@pytest.mark.parametrize("seed", range(4))
def test_codecs_equal_the_reference(seed):
    rng = random.Random(900 + seed)
    for trial in range(20):
        jrr = _random_rr(rng, trial)
        prr = serde.rr_from_dict_v1beta2(jax_serde.rr_to_dict_v1beta2(jrr))
        j1, p1 = jax_serde.rr_to_dict_v1beta1(jrr), serde.rr_to_dict_v1beta1(prr)
        assert json.dumps(p1) == json.dumps(j1)
        assert json.dumps(serde.rr_to_dict_v1beta2(serde.rr_from_dict_v1beta1(j1))) == json.dumps(
            jax_serde.rr_to_dict_v1beta2(jax_serde.rr_from_dict_v1beta1(j1))
        )
        jd = _random_demand(rng, trial)
        pd = serde.demand_from_dict_v1alpha2(jax_serde.demand_to_dict_v1alpha2(jd))
        ja1, pa1 = jax_serde.demand_to_dict_v1alpha1(jd), serde.demand_to_dict_v1alpha1(pd)
        assert json.dumps(pa1) == json.dumps(ja1)
        assert json.dumps(serde.demand_to_dict_v1alpha2(serde.demand_from_dict_v1alpha1(ja1))) == json.dumps(
            jax_serde.demand_to_dict_v1alpha2(jax_serde.demand_from_dict_v1alpha1(ja1))
        )
    for ts in (0.0, 1.5, 1_700_000_000.0, 4_102_444_800.25):
        assert serde.ts_to_rfc3339(ts) == jax_serde.ts_to_rfc3339(ts)


def _corpus(seed):
    """Wire objects of every served version: RRs v1beta1 / v1beta2,
    Demands v1alpha1 / v1alpha2 (which the RR webhook refuses), and an
    object of no known version."""
    rng = random.Random(seed)
    objs = []
    for trial in range(6):
        rr = _random_rr(rng, trial)
        objs.append(jax_serde.rr_to_dict_v1beta2(rr))
        objs.append(jax_serde.rr_to_dict_v1beta1(rr))
        demand = _random_demand(rng, trial)
        objs.append(jax_serde.demand_to_dict_v1alpha2(demand))
        objs.append(jax_serde.demand_to_dict_v1alpha1(demand))
    objs.append({"apiVersion": "example.com/v9", "kind": "Thing", "metadata": {"name": "t"}})
    return objs


def _reviews(seed):
    rng = random.Random(seed)
    corpus = _corpus(seed)
    reviews = []
    for i, obj in enumerate(corpus):
        for desired in (RR_V1, RR_V2, DEMAND_V1, DEMAND_V2, "", "nonsense/v0"):
            reviews.append(
                {"apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
                 "request": {"uid": f"u{i}", "desiredAPIVersion": desired, "objects": [obj]}}
            )
    # multi-object reviews, a review with no objects, one with no request
    for i in range(6):
        objs = rng.sample(corpus, rng.randint(2, 5))
        reviews.append({"request": {"uid": f"m{i}", "desiredAPIVersion": rng.choice((RR_V1, RR_V2)),
                                    "objects": objs}})
    reviews.append({"request": {"uid": "x", "objects": []}})
    reviews.append({"apiVersion": "apiextensions.k8s.io/v1beta1"})
    return reviews


@pytest.mark.parametrize("seed", range(3))
def test_convert_review_bytes_equal_the_reference(seed):
    for review in _reviews(seed):
        ours = json.dumps(convert_review(json.loads(json.dumps(review))))
        theirs = json.dumps(jax_convert_review(json.loads(json.dumps(review))))
        assert ours == theirs


def test_served_convert_bytes_equal_the_reference():
    """Both packages' webhook-only servers answer the same
    ConversionReview with the same bytes."""
    ours, theirs = ExtenderHTTPServer(None, port=0, webhook_only=True), JaxHTTPServer(None, port=0, webhook_only=True)
    ours.start()
    theirs.start()
    try:
        for review in _reviews(7)[::5]:
            payload = json.dumps(review).encode()
            assert _post_raw(ours.port, "/convert", payload) == _post_raw(theirs.port, "/convert", payload)
    finally:
        ours.stop()
        theirs.stop()


@pytest.fixture
def served():
    api = APIServer()
    api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
    scheduler = init_server_with_clients(
        api, Install(binpack_algo="tightly-pack"), demand_poll_interval=0.02, device="cpu"
    )
    scheduler.lazy_demand_informer.wait_ready(5)
    http = ExtenderHTTPServer(scheduler, port=0)
    http.start()
    yield api, scheduler, http
    http.stop()
    scheduler.stop()


def test_conversion_webhook_roundtrip(served):
    _, _, http = served
    from k8s_spark_scheduler_tpu_torch.scheduler.reservations_manager import (
        new_resource_reservation,
    )
    from k8s_spark_scheduler_tpu_torch.types.resources import Resources as PortResources

    pods = Harness.static_allocation_spark_pods("app-conv", 1, executor_gpu="2")
    rr = new_resource_reservation(
        "n0", ["n1"], pods[0], PortResources.of("1", "1Gi", "1"), PortResources.of("2", "2Gi", "2")
    )
    v2 = serde.rr_to_dict_v1beta2(rr)

    # v1beta2 → v1beta1
    review = {"request": {"uid": "u1", "desiredAPIVersion": RR_V1, "objects": [v2]}}
    status, body = _post(http.port, "/convert", review)
    assert status == 200
    response = body["response"]
    assert response["result"]["status"] == "Success"
    v1 = response["convertedObjects"][0]
    assert v1["apiVersion"].endswith("v1beta1")
    assert v1["spec"]["reservations"]["driver"]["cpu"] == "1"
    assert serde.RESERVATION_SPEC_ANNOTATION_KEY in v1["metadata"]["annotations"]

    # v1beta1 → v1beta2 recovers the GPU dimension from the annotation
    review = {"request": {"uid": "u2", "desiredAPIVersion": RR_V2, "objects": [v1]}}
    status, body = _post(http.port, "/convert", review)
    back = body["response"]["convertedObjects"][0]
    assert back["spec"]["reservations"]["executor-1"]["resources"]["nvidia.com/gpu"] == "2"
    assert serde.RESERVATION_SPEC_ANNOTATION_KEY not in back["metadata"]["annotations"]
    # full round trip is lossless
    assert back["spec"] == v2["spec"]


def test_standalone_webhook_module():
    http = ExtenderHTTPServer(None, port=0, webhook_only=True)
    http.start()
    try:
        status, body = _post(http.port, "/convert", {"request": {"uid": "x", "objects": []}})
        assert status == 200 and body["response"]["result"]["status"] == "Success"
        # predicates must not be served by the standalone webhook
        status, _ = _post(http.port, "/predicates", {"Pod": {}, "NodeNames": []})
        assert status == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{http.port}/status/readiness", timeout=10) as resp:
            assert resp.status == 200
    finally:
        http.stop()


def test_request_tracing_header(served):
    _, _, http = served
    req = urllib.request.Request(
        f"http://127.0.0.1:{http.port}/convert",
        data=b'{"request": {"uid": "t", "objects": []}}',
        headers={"X-Trace-Id": "my-trace-123"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.headers.get("X-Trace-Id") == "my-trace-123"
    # auto-generated when absent
    req = urllib.request.Request(
        f"http://127.0.0.1:{http.port}/convert",
        data=b'{"request": {"uid": "t", "objects": []}}',
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.headers.get("X-Trace-Id")


def test_trace_id_sanitization(served):
    """An unvalidated client header must not flow into response headers
    or log lines: bad charset / oversized ids are replaced."""
    _, _, http = served
    payload = b'{"request": {"uid": "t", "objects": []}}'
    for bad in ("evil\ninjected: header", "x" * 200, 'quo"te', "space id"):
        req = urllib.request.Request(f"http://127.0.0.1:{http.port}/convert", data=payload, method="POST")
        req.add_unredirected_header("X-Trace-Id", bad.replace("\n", ""))
        with urllib.request.urlopen(req, timeout=10) as resp:
            echoed = resp.headers.get("X-Trace-Id")
            assert echoed != bad.replace("\n", "")
            assert echoed and len(echoed) <= 64
    req = urllib.request.Request(
        f"http://127.0.0.1:{http.port}/convert", data=payload,
        headers={"X-Trace-Id": "good-id_123"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.headers.get("X-Trace-Id") == "good-id_123"


def test_cli_webhook_only_serves_convert():
    """`--webhook-only` starts no scheduler and needs no device: it
    answers /convert, refuses /predicates, and stops on SIGTERM."""
    import os
    import signal

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.server", "--port", "0", "--webhook-only"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert "conversion webhook serving on :" in line, proc.stderr.read() if proc.poll() is not None else line
        port = int(line.split(":")[1].split()[0])
        review = {"request": {"uid": "c", "desiredAPIVersion": RR_V1,
                              "objects": [jax_serde.rr_to_dict_v1beta2(_random_rr(random.Random(3), 0))]}}
        status, body = _post(port, "/convert", review)
        assert status == 200 and body == jax_convert_review(review)
        assert _post(port, "/predicates", {"Pod": {}, "NodeNames": []})[0] == 404
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.returncode == 0


def test_webhook_serves_convert_over_tls(tmp_path):
    """The apiserver dials conversion webhooks over HTTPS only: with a
    certificate and key the server answers /convert over TLS."""
    import shutil
    import ssl

    if shutil.which("openssl") is None:
        pytest.skip("no openssl binary to make a test certificate")
    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key), "-out", str(cert),
         "-days", "1", "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True, timeout=60,
    )
    http = ExtenderHTTPServer(None, port=0, webhook_only=True, host="127.0.0.1",
                              tls_cert_file=str(cert), tls_key_file=str(key))
    http.start()
    try:
        assert http.tls
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False
        review = {"request": {"uid": "tls", "desiredAPIVersion": RR_V1,
                              "objects": [jax_serde.rr_to_dict_v1beta2(_random_rr(random.Random(5), 0))]}}
        req = urllib.request.Request(f"https://127.0.0.1:{http.port}/convert",
                                     data=json.dumps(review).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
            assert json.loads(resp.read()) == jax_convert_review(review)
    finally:
        http.stop()
