"""The port's REST backend over the port's recorded-wire fake apiserver:
the k8s protocol semantics the write-back layer depends on (409 taxonomy,
namespace termination, watch resume + 410 relist), and the full scheduler
wiring (``device="cpu"``) running against real HTTP instead of the
embedded store — the reference package's cases."""

import threading
import time

import pytest

from k8s_spark_scheduler_tpu_torch.config import Install
from k8s_spark_scheduler_tpu_torch.kube.apiserver import ADDED, DELETED, MODIFIED
from k8s_spark_scheduler_tpu_torch.kube.crd import (
    DEMAND_CRD_NAME,
    demand_crd_spec,
    ensure_resource_reservations_crd,
)
from k8s_spark_scheduler_tpu_torch.kube.errors import (
    AlreadyExistsError,
    ConflictError,
    NamespaceTerminatingError,
    NotFoundError,
)
from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.objects import (
    Node,
    ObjectMeta,
    Pod,
    PodPhase,
    ResourceReservation,
)
from k8s_spark_scheduler_tpu_torch.types.resources import Resources, ZONE_LABEL


@pytest.fixture()
def fake():
    f = FakeKubeAPI().start()
    yield f
    f.stop()


def _node(name: str, cpu="8", mem="8Gi") -> Node:
    return Node(
        meta=ObjectMeta(
            name=name,
            labels={ZONE_LABEL: "z1", "resource_channel": "batch-medium-priority"},
        ),
        allocatable=Resources.of(cpu, mem, "1"),
        ready=True,
    )


def test_crud_round_trip(fake):
    backend = fake.client_backend()
    try:
        created = backend.create(_node("n1"))
        assert created.meta.resource_version > 0
        assert created.meta.uid

        got = backend.get("Node", "default", "n1")
        assert got.allocatable.cpu == Resources.of("8", "1Gi").cpu
        assert got.ready and not got.unschedulable

        got.unschedulable = True
        updated = backend.update(got)
        assert updated.unschedulable
        assert updated.meta.resource_version > got.meta.resource_version

        assert [n.name for n in backend.list("Node")] == ["n1"]
        backend.delete("Node", "default", "n1")
        with pytest.raises(NotFoundError):
            backend.get("Node", "default", "n1")
    finally:
        backend.stop()


def test_conflict_and_already_exists_taxonomy(fake):
    """The 409 split the async client's retry logic branches on
    (async.go:88-96,111-120)."""
    backend = fake.client_backend()
    try:
        backend.create(_node("n1"))
        with pytest.raises(AlreadyExistsError):
            backend.create(_node("n1"))

        stale = backend.get("Node", "default", "n1")
        fresh = backend.get("Node", "default", "n1")
        fresh.unschedulable = True
        backend.update(fresh)
        stale.unschedulable = False
        with pytest.raises(ConflictError):
            backend.update(stale)
    finally:
        backend.stop()


def test_namespace_terminating_wire_shape(fake):
    """403 + 'because it is being terminated' must map back to the
    namespace-terminating error the write-back drop path keys on."""
    backend = fake.client_backend()
    try:
        fake.api.mark_namespace_terminating("doomed")
        pod = Pod(meta=ObjectMeta(name="p1", namespace="doomed"))
        with pytest.raises(NamespaceTerminatingError):
            backend.create(pod)
    finally:
        backend.stop()


def test_watch_stream_delivers_events(fake):
    backend = fake.client_backend()
    try:
        events = []
        done = threading.Event()

        def handler(event, obj):
            events.append((event, obj.name, obj.meta.resource_version))
            if len(events) >= 3:
                done.set()

        backend.create(_node("n1"))
        backend.watch("Node", handler)  # replays n1 as ADDED
        backend.create(_node("n2"))
        n2 = backend.get("Node", "default", "n2")
        n2.unschedulable = True
        backend.update(n2)
        assert done.wait(5), f"only saw {events}"
        kinds = [(e, n) for e, n, _ in events]
        assert kinds[0] == (ADDED, "n1")
        assert (ADDED, "n2") in kinds
        assert (MODIFIED, "n2") in kinds
        rvs = [rv for _, _, rv in events]
        assert rvs == sorted(rvs)
    finally:
        backend.stop()


def test_watch_delete_event(fake):
    backend = fake.client_backend()
    try:
        deleted = threading.Event()
        seen = []

        def handler(event, obj):
            seen.append((event, obj.name))
            if event == DELETED:
                deleted.set()

        backend.watch("Node", handler)
        backend.create(_node("gone"))
        backend.delete("Node", "default", "gone")
        assert deleted.wait(5), seen
    finally:
        backend.stop()


def test_watch_410_relist_recovers():
    """A tiny history horizon forces 410 Gone mid-stream; the backend
    must relist and resynthesize events without dropping state."""
    fake = FakeKubeAPI(history_limit=4).start()
    backend = fake.client_backend()
    try:
        seen = {}
        lock = threading.Lock()

        def handler(event, obj):
            with lock:
                if event == DELETED:
                    seen.pop(obj.name, None)
                else:
                    seen[obj.name] = obj.meta.resource_version

        backend.watch("Node", handler)
        # age the stream's resume point far past the 4-event horizon
        for i in range(30):
            fake.api.create(_node(f"burst-{i:02d}"))
        deadline = time.time() + 10
        while time.time() < deadline:
            with lock:
                if len(seen) == 30:
                    break
            time.sleep(0.05)
        with lock:
            assert len(seen) == 30, f"saw {len(seen)} nodes"
    finally:
        backend.stop()
        fake.stop()


def test_pod_update_goes_to_status_subresource(fake):
    """The marker's condition write must ride pods/{name}/status and
    must not clobber the spec (on a real apiserver a spec-path PUT
    silently drops status changes; here the fake enforces the inverse:
    a status PUT keeps the stored spec)."""
    from k8s_spark_scheduler_tpu_torch.types.objects import PodCondition

    backend = fake.client_backend()
    try:
        pod = Pod(meta=ObjectMeta(name="p1"), node_name="n1", phase=PodPhase.RUNNING)
        created = fake.api.create(pod)

        seen = backend.get(Pod.KIND, "default", "p1")
        seen.node_name = "SHOULD-NOT-STICK"
        seen.conditions["PodExceedsClusterCapacity"] = PodCondition(
            type="PodExceedsClusterCapacity",
            status="True",
            transition_time=time.time(),
        )
        backend.update(seen)

        after = fake.api.get(Pod.KIND, "default", "p1")
        assert after.node_name == "n1", "status PUT must not touch spec"
        assert "PodExceedsClusterCapacity" in after.conditions
        # and the condition's transition time survived the RFC3339 round
        # trip (a float would 400 on a real server)
        assert after.conditions["PodExceedsClusterCapacity"].transition_time > 0
    finally:
        backend.stop()


def test_crd_lifecycle_over_rest(fake):
    backend = fake.client_backend()
    try:
        ensure_resource_reservations_crd(backend, {"team": "compute"})
        crd = backend.get_crd(
            "resourcereservations.sparkscheduler.palantir.com"
        )
        assert crd is not None
        assert crd["group"] == "sparkscheduler.palantir.com"
        assert {v["name"] for v in crd["versions"]} == {"v1beta1", "v1beta2"}
        assert crd["annotations"].get("team") == "compute"
        assert backend.crd_established(
            "resourcereservations.sparkscheduler.palantir.com"
        )
    finally:
        backend.stop()


def test_full_scheduler_wiring_over_rest():
    """The Harness scenario suite's core flow — gang admission, executor
    binds, reservation write-back, teardown — through the REST backend
    and real HTTP wire instead of the embedded store."""
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

    fake = FakeKubeAPI().start()
    fake.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
    backend = fake.client_backend()
    server = init_server_with_clients(
        backend,
        Install(fifo=True, binpack_algo="tpu-batch"),
        start_background=True,
        demand_poll_interval=0.05,
        device="cpu",
    )
    try:
        server.lazy_demand_informer.wait_ready(10)
        for i in range(3):
            fake.api.create(_node(f"n{i}", cpu="8", mem="8Gi"))
        nodes = [f"n{i}" for i in range(3)]
        # wait for the node informer to see them through the watch
        deadline = time.time() + 5
        while time.time() < deadline and len(server.node_informer.list()) < 3:
            time.sleep(0.02)
        assert len(server.node_informer.list()) == 3

        pods = Harness.static_allocation_spark_pods("app-rest", 2)
        from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

        def schedule(pod):
            existing = server.pod_informer.get(pod.namespace, pod.name)
            if existing is None:
                created = backend.create(pod)
                deadline = time.time() + 5
                while (
                    time.time() < deadline
                    and server.pod_informer.get(pod.namespace, pod.name) is None
                ):
                    time.sleep(0.02)
                pod = created
            result = server.extender.predicate(
                ExtenderArgs(pod=pod, node_names=list(nodes))
            )
            if result.node_names:
                # the BIND is kube-scheduler's job (pods/binding
                # subresource), not the extender's — simulate it
                # cluster-side like the Harness does
                bound = fake.api.get(Pod.KIND, pod.namespace, pod.name)
                bound.node_name = result.node_names[0]
                bound.phase = PodPhase.RUNNING
                fake.api.update(bound)
            return result

        r = schedule(pods[0])
        assert r.node_names, f"driver rejected: {r.failed_nodes}"
        for p in pods[1:]:
            er = schedule(p)
            assert er.node_names, f"executor rejected: {er.failed_nodes}"

        # the async write-back must land the reservation on the (fake)
        # cluster over REST
        deadline = time.time() + 5
        rr = None
        while time.time() < deadline:
            try:
                rr = backend.get(ResourceReservation.KIND, "default", "app-rest")
                if len(rr.status.pods) == 3:
                    break
            except NotFoundError:
                pass
            time.sleep(0.05)
        assert rr is not None, "reservation never written through REST"
        names = set(rr.spec.reservations)
        assert "driver" in names and len(names) == 3, names
        assert sum(1 for n in names if n.startswith("executor-")) == 2
        assert len(rr.status.pods) == 3
    finally:
        server.stop()
        backend.stop()
        fake.stop()


# -- watch-reconnect backoff jitter -------------------------------------------
#
# Both watch error paths (stream drop AND relist-after-410 failure) must
# draw from the same full-jitter distribution with the same cap: a
# jitterless path re-synchronizes a fleet of watchers onto a recovering
# API server exactly when it matters most.


def test_watch_backoff_full_jitter_bounds():
    import random

    from k8s_spark_scheduler_tpu_torch.kube.restbackend import (
        WATCH_BACKOFF_CAP_S,
        WATCH_BACKOFF_INITIAL_S,
        next_watch_backoff,
        watch_backoff_delay,
    )

    rng = random.Random(20260804)
    backoff = WATCH_BACKOFF_INITIAL_S
    windows = []
    for _ in range(12):
        for _ in range(50):
            delay = watch_backoff_delay(backoff, rng=rng)
            # full jitter: uniform over [0, min(backoff, cap)]
            assert 0.0 <= delay <= min(backoff, WATCH_BACKOFF_CAP_S)
        windows.append(backoff)
        backoff = next_watch_backoff(backoff)
    # exponential growth, capped at 30s and pinned there
    assert windows[0] == WATCH_BACKOFF_INITIAL_S
    assert windows[1] == WATCH_BACKOFF_INITIAL_S * 2
    assert max(windows) == WATCH_BACKOFF_CAP_S == 30.0
    assert backoff == WATCH_BACKOFF_CAP_S
    # the draw actually spreads over the window (not pinned to an edge)
    draws = [watch_backoff_delay(30.0, rng=rng) for _ in range(200)]
    assert min(draws) < 5.0 and max(draws) > 25.0


def test_watch_error_paths_share_the_jittered_backoff():
    """Pin that BOTH reconnect paths route through watch_backoff_delay
    (the relist path used to sleep jitterless)."""
    import inspect

    from k8s_spark_scheduler_tpu_torch.kube import restbackend

    src = inspect.getsource(restbackend._KindWatch._run)
    assert src.count("watch_backoff_delay(backoff)") == 2
    assert src.count("next_watch_backoff(backoff)") == 2
    # no raw un-jittered wait on the backoff value remains
    assert "wait(backoff)" not in src.replace("watch_backoff_delay(backoff)", "")


def test_cli_kubeconfig_serves_against_the_fake(tmp_path):
    """`--kubeconfig` at the port's FakeKubeAPI: the CLI server lists and
    watches the fake over REST, answers /predicates on the CPU, writes
    the reservation back to the fake, and stops on SIGTERM."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request

    from k8s_spark_scheduler_tpu_torch.types import serde

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fake = FakeKubeAPI().start()
    fake.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
    for i in range(2):
        fake.api.create(_node(f"n{i}"))
    driver = Harness.static_allocation_spark_pods("app-cli", 1)[0]
    fake.api.create(driver)
    kubeconfig = tmp_path / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "current-context": "fake",
        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
        "clusters": [{"name": "fake", "cluster": {"server": fake.host}}],
        "users": [{"name": "fake", "user": {}}],
    }))
    config = tmp_path / "install.json"
    config.write_text(json.dumps({"fifo": True, "binpack": "tpu-batch"}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.server", "--port", "0", "--device", "cpu",
         "--config", str(config), "--kubeconfig", str(kubeconfig)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert f"backend=kubernetes {fake.host}" in line, proc.stderr.read() if proc.poll() is not None else line
        port = int(line.split(":")[1].split()[0])
        body = json.dumps({"Pod": serde.pod_to_dict(fake.api.get("Pod", "default", driver.name)),
                           "NodeNames": ["n0", "n1"]}).encode()
        deadline = time.time() + 30
        while True:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/status/readiness", timeout=10) as resp:
                ready = json.loads(resp.read())["ready"]
            if ready:
                break
            assert time.time() < deadline
            time.sleep(0.05)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predicates", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            result = json.loads(resp.read())
        assert result["NodeNames"] and result["NodeNames"][0] in ("n0", "n1"), result
        deadline = time.time() + 10
        while not fake.api.list("ResourceReservation"):
            assert time.time() < deadline
            time.sleep(0.02)
        assert fake.api.list("ResourceReservation")[0].name == "app-cli"
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
        fake.stop()
    assert proc.returncode == 0


def test_events_between_an_empty_list_and_the_watch_are_delivered(fake, monkeypatch):
    """A LIST of a store never written reports revision 0; an object
    created and deleted before the watch stream connects must still reach
    the handler (ADDED, then DELETED).  The stream's connect is held back
    here to make that window certain."""
    from k8s_spark_scheduler_tpu_torch.kube.restclient import RestClient

    real_watch = RestClient.watch
    connect = threading.Event()

    def late_watch(self, *args, **kw):
        connect.wait(5)
        return real_watch(self, *args, **kw)

    monkeypatch.setattr(RestClient, "watch", late_watch)
    backend = fake.client_backend()
    try:
        seen = []
        deleted = threading.Event()

        def handler(event, obj):
            seen.append((event, obj.name))
            if event == DELETED:
                deleted.set()

        backend.watch("Node", handler)
        fake.api.create(_node("early"))
        fake.api.delete("Node", "default", "early")
        connect.set()
        assert deleted.wait(5), seen
        assert seen == [(ADDED, "early"), (DELETED, "early")]
    finally:
        backend.stop()
