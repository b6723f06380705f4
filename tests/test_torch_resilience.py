"""The port's resilience kit (k8s_spark_scheduler_tpu_torch/resilience/),
case for case the reference's tests/test_resilience.py on the port.

Unit coverage of the components (deadline, gate, breaker, journal) plus
integration acceptance:

- expired deadlines answer fail-fast without touching cluster state;
- a request burst over the admission gate sheds excess requests in
  well under 100ms each while admitted requests complete normally;
- an API-server write outage opens the breaker, diverts reservation
  intents to the journal, reports degraded, and recovery replays the
  journal with nothing lost;
- /status/readiness reports the tri-state health machine.

The reference's kernel-lane health cases (lane demotion, re-probe,
latency blowout, the kernel fault that demotes a lane) have no
counterpart: the port never demotes a kernel lane.  In their place, a
kernel fault answers 500 and leaves the lane in service, and a config
carrying the reference's ``lane-*`` keys loads with one warning.
Journals written by the JAX package replay in the port
(tests/test_torch_provenance.py).
"""

import json
import logging
import threading
import time

import pytest

from k8s_spark_scheduler_tpu_torch import timesource
from k8s_spark_scheduler_tpu_torch.kube.errors import APIError
from k8s_spark_scheduler_tpu_torch.kube.ratelimit import (
    RateLimitedClient,
    RateLimitTimeoutError,
    TokenBucket,
)
from k8s_spark_scheduler_tpu_torch.resilience import (
    AdmissionGate,
    AdmissionShed,
    CircuitBreaker,
    IntentJournal,
    deadline,
)
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs


# -- deadline propagation -----------------------------------------------------


def test_deadline_unbound_is_free_and_never_expires():
    assert deadline.remaining() is None
    assert not deadline.expired()
    deadline.check("anywhere")  # no raise


def test_deadline_bind_expire_and_check():
    with deadline.bind(0.02):
        assert deadline.remaining() <= 0.02
        assert not deadline.expired()
        time.sleep(0.03)
        assert deadline.expired()
        with pytest.raises(deadline.DeadlineExceeded) as err:
            deadline.check("binpack")
        assert err.value.phase == "binpack"
    assert deadline.remaining() is None  # unbound again


def test_deadline_nested_bind_restores_outer():
    with deadline.bind(10.0):
        outer = deadline.remaining()
        with deadline.bind(1.0):
            assert deadline.remaining() < 2.0
        assert deadline.remaining() == pytest.approx(outer, abs=0.5)


# -- admission gate -----------------------------------------------------------


def test_gate_sheds_beyond_capacity_and_recovers():
    gate = AdmissionGate(max_waiters=2)
    assert gate.try_enter() and gate.try_enter()
    assert not gate.try_enter()  # full → shed
    assert gate.shed_total == 1 and gate.shed_recently()
    gate.leave()
    assert gate.try_enter()  # capacity freed
    with pytest.raises(AdmissionShed):
        with gate.admit():
            pass
    gate.leave()
    gate.leave()
    with gate.admit():
        assert gate.in_flight == 1
    assert gate.in_flight == 0


# -- circuit breaker ----------------------------------------------------------


@pytest.fixture
def virtual_clock():
    t = {"now": 1000.0}
    timesource.set_source(lambda: t["now"])
    yield t
    timesource.reset()


def test_breaker_opens_half_opens_and_closes(virtual_clock):
    b = CircuitBreaker(failure_threshold=3, cooloff_seconds=30.0)
    assert b.state == "closed" and b.allow()
    for _ in range(3):
        b.record_failure()
    assert b.state == "open"
    assert not b.allow()  # cooloff not elapsed
    virtual_clock["now"] += 30.0
    assert b.probe_due()
    assert b.allow()  # the half-open probe
    assert b.state == "half-open"
    assert not b.allow()  # only one probe per window
    assert b.record_success() is True  # closed; caller replays the journal
    assert b.state == "closed"


def test_breaker_failed_probe_reopens(virtual_clock):
    b = CircuitBreaker(failure_threshold=1, cooloff_seconds=10.0)
    b.record_failure()
    assert b.state == "open"
    virtual_clock["now"] += 10.0
    assert b.allow()
    b.record_failure()  # probe failed
    assert b.state == "open"
    assert not b.allow()  # cooloff restarted
    b.trip_half_open()  # explicit recovery signal overrides the cooloff
    assert b.allow()


def test_breaker_success_resets_consecutive_count(virtual_clock):
    b = CircuitBreaker(failure_threshold=3)
    b.record_failure()
    b.record_failure()
    assert b.record_success() is False  # was closed all along
    b.record_failure()
    b.record_failure()
    assert b.state == "closed"  # never hit 3 consecutively


def test_breaker_aborted_probe_releases_the_slot(virtual_clock):
    """A write granted as the half-open probe that never reaches the
    server (object deleted while queued) must free the probe slot —
    otherwise the breaker wedges open and the journal never drains."""
    b = CircuitBreaker(failure_threshold=1, cooloff_seconds=10.0)
    b.record_failure()
    virtual_clock["now"] += 10.0
    assert b.allow()  # probe granted...
    b.release_probe()  # ...but aborted before any request was sent
    assert b.probe_due()
    assert b.allow()  # the next write can still probe
    b.record_success()
    assert b.state == "closed"


def test_async_client_aborted_probe_does_not_wedge_breaker(virtual_clock):
    """Worker-level version: _do_update on a key deleted while queued
    releases the probe instead of leaking it."""
    from k8s_spark_scheduler_tpu_torch.state.cache import AsyncClient
    from k8s_spark_scheduler_tpu_torch.state.store import (
        ObjectStore,
        Request,
        ShardedUniqueQueue,
    )

    breaker = CircuitBreaker(failure_threshold=1, cooloff_seconds=10.0)
    client = AsyncClient(
        client=None,  # never reached: the store misses the key first
        queue=ShardedUniqueQueue(1),
        object_store=ObjectStore(),
        breaker=breaker,
        journal=IntentJournal(),
    )
    breaker.record_failure()
    virtual_clock["now"] += 10.0
    assert breaker.allow()  # the worker's gate grants the probe
    client._do_update(Request(("d", "gone"), "update"))  # deleted while queued
    assert breaker.probe_due()  # slot was released, recovery can proceed


def test_update_not_found_is_not_a_breaker_signal():
    """Owner GC deleting an RR at a HEALTHY server while an update is
    queued must not open the write-back breaker (the NotFound response
    proves the server is alive), and must not journal/resurrect the
    deliberately-deleted object."""
    from k8s_spark_scheduler_tpu_torch.kube.errors import NotFoundError
    from k8s_spark_scheduler_tpu_torch.state.cache import AsyncClient
    from k8s_spark_scheduler_tpu_torch.state.store import (
        ObjectStore,
        ShardedUniqueQueue,
        update_request,
    )
    from k8s_spark_scheduler_tpu_torch.types.objects import ObjectMeta, ResourceReservation

    class GoneClient:
        def update(self, obj):
            raise NotFoundError("gone: owner GC beat the update")

    store = ObjectStore()
    # the server acknowledged the object once (its create landed), so a
    # NotFound now means it was deleted there
    rr = ResourceReservation(meta=ObjectMeta(name="a", namespace="d", resource_version=5))
    store.put(rr)
    breaker = CircuitBreaker(failure_threshold=1)
    journal = IntentJournal()
    client = AsyncClient(
        client=GoneClient(),
        queue=ShardedUniqueQueue(1),
        object_store=store,
        max_retry_count=2,
        breaker=breaker,
        journal=journal,
    )
    r = update_request(rr)
    for _ in range(4):  # initial + retries, past max_retry_count
        client._do_update(r)
        r = r.with_incremented_retry_count()
    assert breaker.state == "closed"
    assert journal.depth() == 0  # dropped, never journaled



@pytest.mark.parametrize("with_journal", [True, False], ids=["journal", "no-journal"])
def test_failed_create_collapsed_into_a_queued_update_still_lands(with_journal):
    """A create that fails while an update for the same key is already
    queued has its retry collapsed into that update (the unique queue
    keeps one request a key).  The update then meets NotFound: the
    server never acknowledged the object, so it is created, not dropped
    as an owner GC (the simulator's apiserver_latency fault lost such
    reservations and never quiesced)."""
    from k8s_spark_scheduler_tpu_torch.kube.errors import NotFoundError
    from k8s_spark_scheduler_tpu_torch.state.cache import AsyncClient
    from k8s_spark_scheduler_tpu_torch.state.store import (
        ObjectStore,
        ShardedUniqueQueue,
        create_request,
        update_request,
    )
    from k8s_spark_scheduler_tpu_torch.types.objects import ObjectMeta, ResourceReservation

    class FlakyServer:
        """Every key's first create times out; updates of an object it
        does not hold answer NotFound."""

        def __init__(self):
            self.objects, self.creates = {}, 0

        def create(self, obj):
            self.creates += 1
            if self.creates == 1:
                raise APIError("client timeout (create)")
            obj.meta.resource_version = 7
            self.objects[(obj.meta.namespace, obj.meta.name)] = obj
            return obj

        def update(self, obj):
            if (obj.meta.namespace, obj.meta.name) not in self.objects:
                raise NotFoundError("not found")
            return obj

    store, queue, server = ObjectStore(), ShardedUniqueQueue(1), FlakyServer()
    rr = ResourceReservation(meta=ObjectMeta(name="a", namespace="d"))
    store.put(rr)
    journal = IntentJournal() if with_journal else None
    client = AsyncClient(client=server, queue=queue, object_store=store,
                         breaker=CircuitBreaker(failure_threshold=3), journal=journal)
    # the worker has taken the create; the extender queues an update
    assert queue.try_add_if_absent(update_request(rr))
    client._do_create(create_request(rr))  # times out; its retry collapses
    (pending,) = queue.get_consumers()
    assert pending.qsize() == 1
    client._do_update(pending.get_nowait()())
    assert ("d", "a") in server.objects
    assert store.get(("d", "a")).meta.resource_version == 7
    assert pending.qsize() == 0
    if journal is not None:
        assert journal.depth() == 0


@pytest.mark.parametrize("with_journal", [True, False], ids=["journal", "no-journal"])
def test_landed_create_with_a_lost_response_is_not_recreated_after_owner_gc(with_journal):
    """A create that landed on the server but whose response was lost (a
    client timeout) leaves the local object without a resourceVersion, as
    a create that never landed does.  If the owner pod is then deleted and
    the owner GC deletes the object before the informer's events reach the
    store, the queued update meets NotFound: the owner is gone, so the
    update is dropped, as the reference drops it, and no orphan is
    re-created.  With the owner alive the same update re-creates it."""
    from k8s_spark_scheduler_tpu_torch.kube.errors import NotFoundError
    from k8s_spark_scheduler_tpu_torch.state.cache import AsyncClient
    from k8s_spark_scheduler_tpu_torch.state.store import (
        ObjectStore,
        ShardedUniqueQueue,
        create_request,
        update_request,
    )
    from k8s_spark_scheduler_tpu_torch.types.objects import (
        ObjectMeta,
        OwnerReference,
        Pod,
        ResourceReservation,
    )

    class LossyServer:
        """The first create lands but its response is lost; updates of an
        object it does not hold answer NotFound."""

        def __init__(self):
            self.objects, self.creates = {}, 0

        def create(self, obj):
            self.creates += 1
            obj = obj.deepcopy()
            obj.meta.resource_version = 7
            self.objects[(obj.meta.namespace, obj.meta.name)] = obj
            if self.creates == 1:
                raise APIError("client timeout (create)")
            return obj

        def update(self, obj):
            if (obj.meta.namespace, obj.meta.name) not in self.objects:
                raise NotFoundError("not found")
            return obj

    class Pods:
        def __init__(self, *pods):
            self.pods = {(p.meta.namespace, p.meta.name): p for p in pods}

        def get(self, namespace, name):
            return self.pods.get((namespace, name))

    for owner_gone in (True, False):
        driver = Pod(meta=ObjectMeta(name="drv", namespace="d", uid="uid-drv"))
        owners, server, store, queue = Pods(driver), LossyServer(), ObjectStore(), ShardedUniqueQueue(1)
        rr = ResourceReservation(meta=ObjectMeta(
            name="a", namespace="d", owner_references=[OwnerReference("Pod", "drv", "uid-drv")]))
        store.put(rr)
        client = AsyncClient(client=server, queue=queue, object_store=store,
                             breaker=CircuitBreaker(failure_threshold=3),
                             journal=IntentJournal() if with_journal else None, owners=owners)
        assert queue.try_add_if_absent(update_request(rr))
        client._do_create(create_request(rr))  # lands, but the response is lost
        assert ("d", "a") in server.objects and not store.get(("d", "a")).meta.resource_version
        if owner_gone:
            # the driver finished: its pod is deleted and the owner GC
            # deletes the reservation, before any informer event arrives
            del owners.pods[("d", "drv")]
            del server.objects[("d", "a")]
        (pending,) = queue.get_consumers()
        while pending.qsize():
            client._do_update(pending.get_nowait()())
        if owner_gone:
            assert ("d", "a") not in server.objects and server.creates == 1
        else:
            assert ("d", "a") in server.objects and server.creates == 1  # the update found it


# -- intent journal -----------------------------------------------------------


def test_journal_latest_wins_and_ack_classes():
    j = IntentJournal()
    j.record("create", "ResourceReservation", "default", "a", {"x": 1})
    j.record("update", "ResourceReservation", "default", "a", {"x": 2})
    assert j.depth() == 1
    assert j.pending()[0]["op"] == "update"
    # an upsert ack clears an upsert intent (create/update are one class)
    assert j.ack("create", "default", "a")
    assert j.depth() == 0
    # ... but never a pending delete
    j.record("delete", "ResourceReservation", "default", "b", None)
    assert not j.ack("update", "default", "b")
    assert j.ack("delete", "default", "b")
    assert j.depth() == 0


def test_journal_durable_roundtrip_and_compaction(tmp_path):
    path = str(tmp_path / "intents.jsonl")
    j = IntentJournal(path=path)
    j.record("create", "ResourceReservation", "default", "a", {"spec": 1})
    j.record("create", "ResourceReservation", "default", "b", {"spec": 2})
    j.ack("create", "default", "a")
    j.close()

    reloaded = IntentJournal(path=path)
    assert reloaded.depth() == 1
    assert reloaded.pending_keys() == {("default", "b")}
    assert reloaded.pending()[0]["obj"] == {"spec": 2}
    # compaction rewrote the file to pending-only, every line CRC-framed
    from k8s_spark_scheduler_tpu_torch.resilience.journal import FRAME_MAGIC, _unframe

    with open(path) as f:
        raw = [line.rstrip("\n") for line in f if line.strip()]
    assert all(line.startswith(FRAME_MAGIC + " ") for line in raw)
    lines = [_unframe(line) for line in raw]
    assert len(lines) == 1 and lines[0] is not None and lines[0]["name"] == "b"
    reloaded.close()


# -- rate limit deadline (satellite) ------------------------------------------


def test_token_bucket_acquire_timeout():
    bucket = TokenBucket(qps=1.0, burst=1)
    assert bucket.acquire()  # drains the single token
    t0 = time.monotonic()
    assert bucket.acquire(timeout=0.05) is False
    assert time.monotonic() - t0 < 0.5  # gave up, did not wait ~1s for refill
    assert bucket.acquire(timeout=2.0) is True  # budget covers the refill


def test_rate_limited_client_respects_request_deadline():
    calls = []

    class FakeDelegate:
        def create(self, obj):
            calls.append(obj)
            return obj

    bucket = TokenBucket(qps=0.5, burst=1)
    client = RateLimitedClient(FakeDelegate(), bucket)
    client.create("first")  # takes the burst token
    with deadline.bind(0.05):
        with pytest.raises(RateLimitTimeoutError):
            client.create("second")  # 2s refill cannot fit a 50ms deadline
    assert calls == ["first"]  # nothing reached the delegate


# -- extender integration: deadline fail-fast ---------------------------------


@pytest.fixture
def harness():
    h = Harness(device="cpu")
    yield h
    h.close()


def test_expired_deadline_answers_fail_fast_without_state_changes(harness):
    harness.new_node("n1")
    harness.new_node("n2")
    driver = harness.static_allocation_spark_pods("app-dl", 1)[0]
    harness.create_pod(driver)
    with deadline.bind(-1.0):  # already expired at entry
        result = harness.extender.predicate(
            ExtenderArgs(pod=driver, node_names=["n1", "n2"])
        )
    assert not result.node_names
    assert "deadline" in next(iter(result.failed_nodes.values()))
    # fail-fast means NO reservation and NO demand were created
    assert harness.get_resource_reservation("app-dl") is None
    assert harness.api.list("Demand") == []
    # the same request with a live deadline succeeds (retriable failure)
    with deadline.bind(30.0):
        result = harness.extender.predicate(
            ExtenderArgs(pod=driver, node_names=["n1", "n2"])
        )
    assert result.node_names


# -- write-back breaker + journal + degraded health ---------------------------


def test_writeback_outage_diverts_journals_and_recovers(harness):
    harness.new_node("n1")
    harness.new_node("n2")
    kit = harness.server.resilience
    kit.breaker.failure_threshold = 2  # open fast for the test

    def outage(op, kind, ns, name):
        if kind in ("ResourceReservation", "Demand"):
            return APIError(f"injected outage ({op} {kind})")
        return None

    harness.api.set_write_fault(outage)
    try:
        driver = harness.static_allocation_spark_pods("app-brk", 1)[0]
        result = harness.schedule(driver, ["n1", "n2"])
        assert result.node_names  # decision unaffected: local cache admits
        # the write is diverted, never dropped
        assert harness.wait_for_api(
            lambda: kit.journal.pending_keys() == {("default", "app-brk")}
        )
        assert harness.wait_for_api(
            lambda: not any(
                harness.server.resource_reservation_cache.inflight_queue_lengths()
            )
        )
        assert kit.breaker.state == "open"
        assert kit.health.report()["state"] == "degraded"
        assert harness.api.list("ResourceReservation") == []
    finally:
        harness.api.set_write_fault(None)

    # recovery: explicit nudge (the reporter tick does this in prod)
    harness.server.resource_reservation_cache.nudge_recovery(force=True)
    assert harness.wait_for_api(lambda: kit.journal.depth() == 0)
    assert harness.wait_for_api(
        lambda: len(harness.api.list("ResourceReservation")) == 1
    )
    assert kit.breaker.state == "closed"
    assert harness.wait_for_api(
        lambda: kit.health.report()["state"] == "ready", timeout=5.0
    )
    from k8s_spark_scheduler_tpu_torch.scheduler import invariants

    assert invariants.check(harness.server, raise_on_violation=False) == []


def test_writeback_update_collapsed_onto_unlanded_create_upserts(harness):
    """An RR created AND updated (executor binds) during an outage nets
    to one journaled upsert intent; replay must land the full object."""
    harness.new_node("n1")
    harness.new_node("n2")
    kit = harness.server.resilience
    kit.breaker.failure_threshold = 1

    harness.api.set_write_fault(
        lambda op, kind, ns, name: APIError("down")
        if kind == "ResourceReservation"
        else None
    )
    try:
        pods = harness.static_allocation_spark_pods("app-ups", 1)
        for p in pods:
            harness.assert_success(harness.schedule(p, ["n1", "n2"]))
        assert harness.wait_for_api(
            lambda: kit.journal.pending_keys() == {("default", "app-ups")}
        )
    finally:
        harness.api.set_write_fault(None)
    harness.server.resource_reservation_cache.nudge_recovery(force=True)
    assert harness.wait_for_api(lambda: kit.journal.depth() == 0)
    rrs = harness.api.list("ResourceReservation")
    assert len(rrs) == 1
    # the landed object carries the post-update state (executor bound)
    assert pods[1].name in rrs[0].status.pods.values()


# -- no lane demotion: the port's counterpart of the lane cases ---------------


def test_kernel_fault_answers_500_and_never_demotes():
    """A kernel fault on the tensor lane answers 500 on every request —
    the lane is never demoted to a host path — and readiness stays
    ``ready`` with no demoted lane: the fault is the request's, not a
    degraded mode."""
    import urllib.error
    import urllib.request

    api, scheduler, http = _served_http(_install(binpack_algo="tpu-batch"))
    try:
        _two_nodes(api)
        scheduler.wait_ready(30)
        solver = scheduler.extender.binpacker.queue_solver
        calls = []

        def broken(*args, **kwargs):
            calls.append(1)
            raise RuntimeError("fifo_queue kernel launch failed with CUDA error 719")

        # both tensor lanes: the cold solve and the delta-solve session's
        # pack of the current driver
        solver.solve_tensor = solver._pack_current = broken
        from k8s_spark_scheduler_tpu_torch.types import serde

        for i in range(4):
            pod = Harness.static_allocation_spark_pods(f"app-fault-{i}", 1)[0]
            api.create(pod)
            payload = {"Pod": serde.pod_to_dict(pod), "NodeNames": ["n1", "n2"]}
            with pytest.raises(urllib.error.HTTPError) as err:
                _post_predicates(http.port, payload)
            assert err.value.code == 500
            assert b"CUDA error 719" in err.value.read()
        # every request reached the faulting lane: nothing demoted it
        assert len(calls) == 4
        assert api.list("ResourceReservation") == []
        with urllib.request.urlopen(
            f"http://127.0.0.1:{http.port}/status/readiness", timeout=10
        ) as resp:
            body = json.loads(resp.read())
        assert body["state"] == "ready" and body["components"]["demotedLanes"] == []
    finally:
        http.stop()
        scheduler.stop()


def test_reference_config_with_lane_keys_loads_with_one_warning(caplog):
    from k8s_spark_scheduler_tpu_torch.config import Install
    from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

    section = {
        "request-deadline-seconds": 20,
        "admission-max-waiters": 4,
        "lane-failure-threshold": 2,
        "lane-cooloff-seconds": 10,
    }
    install = Install.from_dict({"binpack": "tpu-batch", "resilience": section})
    assert install.resilience.admission_max_waiters == 4
    assert install.resilience.lane_keys == ("lane-failure-threshold", "lane-cooloff-seconds")
    with pytest.raises(ValueError, match="unknown resilience key"):
        Install.from_dict({"resilience": {"lane-failure-treshold": 2}})
    with caplog.at_level(logging.WARNING, logger="k8s_spark_scheduler_tpu_torch.server.wiring"):
        server = init_server_with_clients(APIServer(), install, start_background=False, device="cpu")
    try:
        warned = [r.getMessage() for r in caplog.records if "never demotes a kernel lane" in r.getMessage()]
        assert len(warned) == 1 and "lane-failure-threshold" in warned[0]
        assert server.resilience.gate.max_waiters == 4
        assert server.resilience.request_timeout == 19.0
    finally:
        server.stop()


# -- HTTP: shedding under burst + tri-state readiness -------------------------


def _install(**kw):
    from k8s_spark_scheduler_tpu_torch.config import Install

    return Install(**kw)


def _two_nodes(api):
    from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu_torch.types.resources import Resources, ZONE_LABEL

    for name in ("n1", "n2"):
        api.create(
            Node(
                meta=ObjectMeta(
                    name=name,
                    labels={
                        ZONE_LABEL: "zone1",
                        "resource_channel": "batch-medium-priority",
                    },
                ),
                allocatable=Resources.of("8", "8Gi", "1"),
            )
        )


def _served_http(install=None):
    from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
    from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

    api = APIServer()
    api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
    scheduler = init_server_with_clients(
        api, install or _install(binpack_algo="tightly-pack"), demand_poll_interval=0.02, device="cpu"
    )
    scheduler.lazy_demand_informer.wait_ready(5)
    http = ExtenderHTTPServer(scheduler, port=0)
    http.start()
    return api, scheduler, http


def _post_predicates(port, payload, timeout=10):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predicates",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_burst_over_admission_gate_sheds_fast_and_serves_the_rest():
    from k8s_spark_scheduler_tpu_torch.config import ResilienceConfig

    install = _install(
        binpack_algo="tightly-pack",
        resilience=ResilienceConfig(admission_max_waiters=2),
    )
    api, scheduler, http = _served_http(install)
    try:
        _two_nodes(api)
        scheduler.wait_ready(30)

        # wedge the extender lock so admitted requests queue behind it
        release = threading.Event()
        entered = threading.Event()

        def hold_lock():
            with scheduler.extender._predicate_lock:
                entered.set()
                release.wait(20)

        holder = threading.Thread(target=hold_lock, daemon=True)
        holder.start()
        assert entered.wait(5)

        from k8s_spark_scheduler_tpu_torch.types import serde

        pods = Harness.static_allocation_spark_pods("app-burst", 0)
        payloads = []
        for i in range(8):
            p = pods[0].deepcopy()
            p.meta.name = f"app-burst-driver-{i}"
            api.create(p)
            payloads.append(
                {"Pod": serde.pod_to_dict(p), "NodeNames": ["n1", "n2"]}
            )

        results = [None] * len(payloads)

        def fire(i):
            t0 = time.perf_counter()
            status, body = _post_predicates(http.port, payloads[i], timeout=30)
            results[i] = (status, body, time.perf_counter() - t0)

        threads = [
            threading.Thread(target=fire, args=(i,)) for i in range(len(payloads))
        ]
        for t in threads:
            t.start()
        time.sleep(1.0)  # everyone is either shed or queued on the gate/lock
        shed_now = [r for r in results if r is not None]
        # with the lock held and 2 admission slots, at least 6 of 8 were
        # shed — and each answered immediately (well under 100ms)
        assert len(shed_now) >= len(payloads) - 2
        for status, body, dt in shed_now:
            assert status == 200
            msg = next(iter(body["FailedNodes"].values()))
            assert "overloaded" in msg
            assert dt < 1.0  # generous CI bound; typical is <10ms

        release.set()
        for t in threads:
            t.join(30)
        assert all(r is not None for r in results)
        # the admitted (non-shed) requests completed with real decisions
        admitted = [
            r for r in results if not r[1].get("FailedNodes")
        ]
        assert len(admitted) >= 1
        for status, body, _ in admitted:
            assert status == 200 and body.get("NodeNames")
        assert scheduler.resilience.gate.shed_total >= len(payloads) - 2
        # a shed leaves a decision record too
        record = scheduler.provenance.explain(
            next(
                p["Pod"]["metadata"]["name"]
                for p, r in zip(payloads, results)
                if r[1].get("FailedNodes")
            )
        )
        assert record["outcome"] == "shed"
    finally:
        http.stop()
        scheduler.stop()


def test_readiness_reports_tri_state_health():
    import urllib.request

    api, scheduler, http = _served_http()
    try:
        scheduler.wait_ready(30)

        def get_readiness():
            with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/status/readiness", timeout=10
            ) as resp:
                return resp.status, json.loads(resp.read())

        status, body = get_readiness()
        assert status == 200
        assert body["ready"] is True and body["state"] == "ready"
        assert body["components"]["writebackBreaker"] == "closed"

        # degraded (breaker open) still answers 200: the replica keeps
        # serving correct decisions and must stay in rotation
        for _ in range(scheduler.resilience.breaker.failure_threshold):
            scheduler.resilience.breaker.record_failure()
        status, body = get_readiness()
        assert status == 200
        assert body["ready"] is True and body["state"] == "degraded"
        assert body["components"]["writebackBreaker"] == "open"
        scheduler.resilience.breaker.record_success()
    finally:
        http.stop()
        scheduler.stop()
