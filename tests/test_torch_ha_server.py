"""The HA fabric in the port's server against the JAX package's: two
replicas a side on one API server through an election, Filters, a
planned handoff and Filters again (``torch_parity.HATwin``), the
deposed replica's refused write-back diverted to its journal, the race
detector on an HA-on server through a handoff, and the guarded-class
registry with the fabric's two declarations.

Filter bodies are byte-equal; ``/status/ha`` is equal less the fields
that name the replica or the host's clock (``HA_UNCOMPARED``); the
``/lifecycle`` records' ``epochs`` and the summary's ``epochContinuity``
are equal; a standby answers readiness with 503."""

import importlib
import os
import time

import pytest

from k8s_spark_scheduler_tpu.analysis import racecheck as jax_racecheck
from k8s_spark_scheduler_tpu_torch.analysis import guarded, racecheck
from k8s_spark_scheduler_tpu_torch.config import HAConfig, Install, ResilienceConfig
from k8s_spark_scheduler_tpu_torch.ha.fencing import StaleEpochError
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from torch_parity import HATwin, ha_status_body

PORT_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "k8s_spark_scheduler_tpu_torch")
NODES = [f"n{i}" for i in range(4)]


def _ready(twin: HATwin, name: str):
    """(JAX, port) readiness statuses of the replica, once its caches
    synced and its warmup finished."""
    for server in twin.replica(name):
        deadline = time.monotonic() + 30
        while not server.warmup_complete():
            assert time.monotonic() < deadline
            time.sleep(0.01)
    (js, _), (ps, _) = twin.get_on(name, "/status/readiness")
    return js, ps


def _status_equal(twin: HATwin, name: str) -> dict:
    (js, jbody), (ps, pbody) = twin.get_on(name, "/status/ha")
    assert js == ps == 200
    assert ha_status_body(pbody) == ha_status_body(jbody), (pbody, jbody)
    assert pbody["enabled"] is True and pbody["identity"] == name
    return pbody


def _lifecycle_epochs_equal(twin: HATwin, name: str) -> dict:
    (js, jbody), (ps, pbody) = twin.get_on(name, "/lifecycle")
    assert js == ps == 200
    assert pbody["summary"]["epochContinuity"] == jbody["summary"]["epochContinuity"]
    epochs = {}
    for gang in pbody["gangs"]:
        (_, jrec), (_, prec) = twin.get_on(name, f"/lifecycle/{gang['app']}")
        assert prec["epochs"] == jrec["epochs"], (name, gang["app"], prec, jrec)
        epochs[gang["app"]] = prec["epochs"]
    assert {g["app"] for g in pbody["gangs"]} == {g["app"] for g in jbody["gangs"]}
    return {"summary": pbody["summary"]["epochContinuity"], "epochs": epochs}


@pytest.mark.parametrize("binpack", ["tpu-batch", "tightly-pack"])
def test_ha_twin_through_election_and_handoff(binpack):
    twin = HATwin(binpack)
    try:
        for name in NODES:
            twin.add_node(name, cpu="8", memory="16Gi")
        assert twin.step("replica-a") is True
        assert twin.step("replica-b") is False
        assert _ready(twin, "replica-a") == (200, 200)
        assert _ready(twin, "replica-b") == (503, 503)
        a = _status_equal(twin, "replica-a")
        b = _status_equal(twin, "replica-b")
        assert (a["leader"], a["epoch"], b["leader"], b["epoch"], b["highestObservedEpoch"]) == (True, 1, False, 0, 1)

        # epoch 1: replica-a serves a whole gang and one gang's driver
        app1 = twin.static_pods("app-1", 2, age=30)
        for wire in app1:
            assert twin.schedule(wire, NODES)
        app2 = twin.static_pods("app-2", 3, age=20)
        assert twin.schedule(app2[0], NODES)
        twin.assert_state_equal()
        twin.drain()

        # planned handoff: a steps down, b takes epoch 2, a fences itself
        twin.step_down("replica-a")
        assert twin.step("replica-b") is True
        assert twin.step("replica-a") is False
        twin.serving = "replica-b"
        assert _ready(twin, "replica-a") == (503, 503)
        assert _ready(twin, "replica-b") == (200, 200)
        a = _status_equal(twin, "replica-a")
        b = _status_equal(twin, "replica-b")
        assert (a["leader"], a["epoch"], a["highestObservedEpoch"]) == (False, 1, 2)
        assert (b["leader"], b["epoch"]) == (True, 2)
        assert b["reconciliation"]["crdDiffRan"] is True and b["reconciliation"]["epoch"] == 2
        assert [h[:2] for h in b["lease"]["history"]] == [[1, "replica-a"], [2, "replica-b"]]
        # the new leader's delta-solve session was invalidated: its first
        # driver Filter is a cold build on both sides
        if binpack == "tpu-batch":
            before = [s.extender.delta_engine.stats()["cold_solves"] for s in twin.replica("replica-b")]

        # epoch 2: replica-b serves app-2's executors, a new gang and a
        # gang that does not fit
        for wire in app2[1:]:
            assert twin.schedule(wire, NODES)
        app3 = twin.static_pods("app-3", 2, age=10)
        for wire in app3:
            assert twin.schedule(wire, NODES)
        if binpack == "tpu-batch":
            after = [s.extender.delta_engine.stats()["cold_solves"] for s in twin.replica("replica-b")]
            assert after[1] - before[1] == after[0] - before[0] >= 1
        big = twin.static_pods("app-big", 40, age=5)
        assert twin.schedule(big[0], NODES) is None
        twin.delete_pod(app1[0])  # app-1 completes under epoch 2
        twin.assert_state_equal()
        twin.drain()
        lifecycle = {name: _lifecycle_epochs_equal(twin, name) for name in HATwin.REPLICAS}
        # replica-b watched app-1 run as a follower (epoch 0) and complete
        # as the leader; replica-a holds epoch 1 throughout
        assert lifecycle["replica-b"]["epochs"]["app-1"] == [0, 2]
        assert lifecycle["replica-b"]["epochs"]["app-3"] == [2]
        assert lifecycle["replica-a"]["epochs"]["app-1"] == [1]
        assert lifecycle["replica-b"]["summary"] == {"gangsSpanningEpochs": 1, "epochRegressions": 0}
        for name in HATwin.REPLICAS:
            _status_equal(twin, name)
        # the deposed replica's gate refuses every fenced write path
        for server in twin.replica("replica-a"):
            for op in ("writeback.create", "writeback.update", "writeback.delete", "demand.create",
                       "preempt.commit", "journal.ack"):
                with pytest.raises(Exception) as err:
                    server.ha.writer.check(op)
                assert type(err.value).__name__ == "StaleEpochError"
            assert server.ha.fence.stale_commits() == 0
    finally:
        twin.close()


def test_deposed_replica_diverts_its_write_back_to_its_journal(tmp_path):
    """Unplanned failover on the port's server: replica-b takes the lease
    while replica-a has not stepped since; a's next granted Filter's
    reservation create is refused by the read-through fence and diverted
    to a's journal (``journaled_fenced``), never landing in the API, and
    a deposed replica's journal ack is refused.  When a takes the lease
    back, its takeover replays its own intent and the reservation lands
    (the reference acks that intent unwritten: ROADMAP C.5)."""
    from k8s_spark_scheduler_tpu_torch import timesource

    now = [1_700_000_000.0]
    timesource.set_source(lambda: now[0])
    h = b = None
    try:
        def install(identity):
            return Install(
                fifo=True, binpack_algo="tpu-batch",
                resilience=ResilienceConfig(journal_path=str(tmp_path / f"{identity}.jsonl")),
                ha=HAConfig(enabled=True, background=False, identity=identity, lease_duration_seconds=2.0),
            )

        h = Harness(extra_install=install("replica-a"), device="cpu")
        b = init_server_with_clients(h.api, install("replica-b"), demand_poll_interval=0.02, device="cpu")
        for name in NODES:
            h.new_node(name, cpu="8", memory="16Gi")
        assert h.server.ha.step() and not b.ha.step()
        assert h.schedule(h.static_allocation_spark_pods("app-1", 1, creation_timestamp=now[0] - 9)[0],
                          NODES).node_names
        assert h.wait_quiesced()
        now[0] += 3.0  # a stops renewing; its lease lapses
        assert b.ha.step() and b.ha.fence.epoch() == 2
        pods = h.static_allocation_spark_pods("app-2", 1, creation_timestamp=now[0] - 5)
        assert h.schedule(pods[0], NODES).node_names  # a still serves: its Filter is not fenced
        journal = h.server.resilience.journal
        assert h.wait_for_api(lambda: journal.depth() == 1)
        assert [(i["op"], i["name"], i.get("epoch")) for i in journal.pending()] == [("create", "app-2", 1)]
        assert h.server.ha.fence.deposed() and not h.server.ha.is_leader()
        state = h.server.ha.fence.state()
        # app-2's create refused; an ack of app-1's last landed write that
        # ran after b's election is refused too (the ack is fenced even
        # with no intent pending, as in the reference)
        assert state["refusals"].get("writeback.create") == 1 and state["staleCommits"] == 0
        assert set(state["refusals"]) <= {"writeback.create", "journal.ack"}
        assert [rr.name for rr in h.api.list("ResourceReservation")] == ["app-1"]
        with pytest.raises(StaleEpochError):
            journal.ack("create", "default", "app-2")
        # a takes the lease back at epoch 3 and replays its own intent
        now[0] += 3.0
        assert h.server.ha.step() and h.server.ha.fence.epoch() == 3
        report = h.server.ha.status()["reconciliation"]
        assert report["epoch"] == 3 and report["journalReplays"] >= 1 and report["crdDiffRan"]
        assert h.wait_for_api(lambda: journal.depth() == 0 and
                              sorted(rr.name for rr in h.api.list("ResourceReservation")) == ["app-1", "app-2"])
        assert b.ha.fence.stale_commits() == h.server.ha.fence.stale_commits() == 0
    finally:
        if b is not None:
            b.stop()
        if h is not None:
            h.close()
        timesource.reset()


def test_racecheck_on_an_ha_server_through_a_handoff(monkeypatch):
    """Two HA-on port servers built under the race detectors through an
    election, Filters, a planned handoff and Filters on the new leader,
    with every background thread live: 0 lockset races, 0 happens-before
    races, 0 lock-order cycles."""
    assert not jax_racecheck.active()
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    h = b = None

    def install(identity):
        return Install(fifo=True, binpack_algo="tpu-batch",
                       ha=HAConfig(enabled=True, background=False, identity=identity))

    try:
        h = Harness(extra_install=install("replica-a"), device="cpu")
        assert racecheck.active()
        b = init_server_with_clients(h.api, install("replica-b"), demand_poll_interval=0.02, device="cpu")
        for name in NODES:
            h.new_node(name, cpu="8", memory="16Gi")
        assert h.server.ha.step() and not b.ha.step()
        t0 = time.time()
        for k in range(3):
            for pod in h.static_allocation_spark_pods(f"a{k}", 1, creation_timestamp=t0 - 50 + k):
                assert h.schedule(pod, NODES).node_names
        assert h.wait_quiesced()
        h.server.ha.elector.step_down()
        assert b.ha.step() and not h.server.ha.step()
        from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

        for k in range(3):
            for pod in h.static_allocation_spark_pods(f"b{k}", 1, creation_timestamp=t0 - 20 + k):
                created = h.api.create(pod)
                result = b.extender.predicate(ExtenderArgs(pod=created, node_names=list(NODES)))
                assert result.node_names
                bound = h.api.get("Pod", pod.namespace, pod.name)
                bound.node_name, bound.phase = result.node_names[0], "Running"
                h.api.update(bound)
        b.capacity.sample_now(trigger="test")
        b.lifecycle.drain(trigger="test")
        assert b.ha.status()["fence"]["staleCommits"] == 0
    finally:
        if b is not None:
            b.stop()
        if h is not None:
            h.close()
        detector = racecheck.disable()
    assert detector is not None
    assert detector.races == [] and detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], detector.lock_order_violations


def test_guarded_registry_holds_the_fabric_declarations():
    """Every module of the port imported: 48 ``@guarded_by`` classes (the
    concurrent engine's three since it was ported), FenceState and
    LeaderElector among them with the reference's declarations."""
    for root, _, names in os.walk(PORT_PKG):
        for n in names:
            if n.endswith(".py") and n != "__main__.py":
                rel = os.path.relpath(os.path.join(root, n), PORT_PKG)[:-3].replace(os.sep, ".")
                module = "k8s_spark_scheduler_tpu_torch" + ("" if rel == "__init__" else "." + rel.removesuffix(".__init__"))
                importlib.import_module(module)
    ours = {cls: decl for cls, decl in guarded.registry().items()
            if cls.__module__.startswith("k8s_spark_scheduler_tpu_torch.")}
    assert len(ours) == 48, sorted(c.__name__ for c in ours)
    by_name = {cls.__name__: decl for cls, decl in ours.items()}
    assert by_name["FenceState"] == ("_lock", ("_epoch", "_highest", "_refusals", "_commits", "_stale_commits"))
    assert by_name["LeaderElector"] == ("_lock", ("_last_renewal", "_held"))


@pytest.mark.parametrize("ttl, read_back", [(2.0, 2.0), (0.3, 15.0)])
def test_fake_kube_api_serves_the_lease_over_rest(ttl, read_back):
    """Two electors, each over its own REST client to the port's
    FakeKubeAPI: the Lease travels as coordination.k8s.io/v1 ``leases``,
    the CAS renew and acquire go through resourceVersion, a stale
    update answers 409, and the TTL travels as whole seconds (a
    sub-second one reads back as the 15 s default, as in the
    reference)."""
    from k8s_spark_scheduler_tpu_torch.ha.fencing import FenceState
    from k8s_spark_scheduler_tpu_torch.ha.lease import LeaderElector, Lease
    from k8s_spark_scheduler_tpu_torch.kube.errors import ConflictError
    from k8s_spark_scheduler_tpu_torch.kube.restbackend import _RESOURCES
    from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI

    assert _RESOURCES["Lease"].path("default", "x") == "/apis/coordination.k8s.io/v1/namespaces/default/leases/x"
    fake = FakeKubeAPI().start()
    clients = []
    try:
        clients = [fake.client_backend(), fake.client_backend()]
        a, b = (LeaderElector(c, name, FenceState(), duration_seconds=ttl)
                for c, name in zip(clients, ("replica-a", "replica-b")))
        assert a.step() and not b.step()
        lease = b.peek()
        assert (lease.holder, lease.epoch, lease.duration_seconds) == ("replica-a", 1, read_back)
        assert fake.api.get(Lease.KIND, "default", "tpu-gang-scheduler").holder == "replica-a"
        stale = lease.deepcopy()
        assert a.step()  # renewal moves the resourceVersion
        with pytest.raises(ConflictError):
            clients[1].update(stale)
        a.step_down()
        assert b.step() and b.fence.epoch() == 2
        assert not a.step() and a.fence.deposed()
        assert [h[:2] for h in a.peek().history] == [[1, "replica-a"], [2, "replica-b"]]
    finally:
        for c in clients:
            c.stop()
        fake.stop()
