"""The port's scheduling-policy engine (policy/) against the JAX package's.

Both packages keep every policy rule in numpy on the host — the queue
sort keys, the conservative backfill probe, the what-if check and the
DRF accounting — so every comparison here is exact equality, on the
same seeded inputs:

- the reference's tests/test_policy.py on the port's harness: the
  5-seed decision identity of the ``fifo`` engine with no engine,
  whole-gang preemption, no partial eviction, DRF accounting off the
  reservation feed, and ``/policy/state`` over HTTP;
- unit parity, JAX function against port function, on seeded random
  bases that include negative availability, zero-resource executors and
  ties: ``queue_sort_key``, ``gang_feasible``, ``place_gang``,
  ``backfill_cannot_delay``, ``whatif_fits``,
  ``DrfAccountant.dominant_share`` / ``over_share_tenants`` and
  ``VictimSelector.select``;
- the port's numpy ``caps_unclamped`` (policy/ordering.py) against its
  torch ``capacity/probe.caps_unclamped`` on the CPU;
- server parity through ``Twin``: byte-equal Filter sequences under
  ``fifo``, ``priority-then-fifo`` and ``drf`` on a tensor-lane and a
  host-lane binpacker, a backfill case whose probe widens a skip, a
  preemption case, and equal ``/policy/state`` and ``/lifecycle``
  bodies;
- an evict intent (written by either package) replays exactly once
  across a restart;
- the default install builds no engine, and ``/policy/state`` and
  ``/status/ha`` answer ``200 {"enabled": false}`` on both packages;
- a policy-on port server driven under the race detectors reports 0
  races and 0 lock-order cycles.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.analysis import racecheck as jax_racecheck
from k8s_spark_scheduler_tpu.policy import drf as jax_drf
from k8s_spark_scheduler_tpu.policy import ordering as jax_ordering
from k8s_spark_scheduler_tpu.policy import victims as jax_victims
from k8s_spark_scheduler_tpu.types.resources import Resources as JaxResources
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.capacity import probe as torch_probe
from k8s_spark_scheduler_tpu_torch.config import FifoConfig, Install, PolicyConfig, ResilienceConfig
from k8s_spark_scheduler_tpu_torch.kube.errors import NotFoundError
from k8s_spark_scheduler_tpu_torch.metrics import names as M
from k8s_spark_scheduler_tpu_torch.policy import drf, ordering, victims
from k8s_spark_scheduler_tpu_torch.policy.preempt import EVICT_KIND, EVICT_JOURNAL_SUFFIX
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.objects import Pod
from k8s_spark_scheduler_tpu_torch.types.resources import Resources

from torch_parity import Twin, lifecycle_record_body, lifecycle_summary_body

BAND_LABEL = "spark-priority-band"
TENANT_LABEL = "spark-tenant"
SEEDS = range(6)


def _policy_install(**overrides) -> Install:
    """An Install identical to the default Harness wiring except for
    the policy block — the property test depends on everything else
    matching the bare-Harness install exactly."""
    return Install(
        fifo=True,
        fifo_config=FifoConfig(),
        binpack_algo="tightly-pack",
        policy=PolicyConfig(enabled=True, **overrides),
    )


def _pod_gone(h, name: str, namespace: str = "default") -> bool:
    """The pod is gone from ``h``'s API server (either package's)."""
    try:
        h.api.get(Pod.KIND, namespace, name)
        return False
    except Exception as err:
        if type(err).__name__ != "NotFoundError":
            raise
        return True


# -- the reference's tests/test_policy.py on the port's harness ----------------


def _seeded_workload(seed: int):
    rng = np.random.RandomState(seed)
    nodes = [(f"n{i}", str(int(rng.randint(4, 9))), f"{int(rng.randint(4, 9))}Gi") for i in range(3)]
    apps = [(f"app-{seed}-{i}", int(rng.randint(0, 4)), str(int(rng.randint(1, 3)))) for i in range(6)]
    return nodes, apps


def _run_workload(h: Harness, seed: int):
    """Schedule the seeded workload and record every decision verbatim:
    (pod name, granted nodes, full FailedNodes map)."""
    nodes, apps = _seeded_workload(seed)
    for name, cpu, mem in nodes:
        h.new_node(name, cpu=cpu, memory=mem)
    node_names = [n[0] for n in nodes]
    decisions = []
    for i, (app_id, executor_count, executor_cpu) in enumerate(apps):
        pods = h.static_allocation_spark_pods(
            app_id, executor_count, executor_cpu=executor_cpu, creation_timestamp=1000.0 + i
        )
        for pod in pods:
            result = h.schedule(pod, node_names)
            decisions.append(
                (pod.name, tuple(result.node_names or ()), tuple(sorted((result.failed_nodes or {}).items())))
            )
    return decisions


@pytest.mark.parametrize("seed", [11, 23, 37, 41, 59])
def test_policy_fifo_is_decision_identical_to_no_engine(seed):
    """The engine with ordering=fifo gives byte-identical decisions to
    the bare FIFO extender (the default install, which builds no engine)
    over a seeded workload: same granted nodes, same FailedNodes
    messages, pod for pod."""
    bare = Harness(device="cpu")
    try:
        baseline = _run_workload(bare, seed)
        assert bare.server.policy is None
        assert bare.server.extender._policy is None
    finally:
        bare.close()
    with_engine = Harness(extra_install=_policy_install(ordering="fifo"), device="cpu")
    try:
        engine_decisions = _run_workload(with_engine, seed)
        assert with_engine.server.policy is not None
    finally:
        with_engine.close()
    assert engine_decisions == baseline


def test_preemption_evicts_whole_gang_and_admits_preemptor():
    """A refused high-band driver triggers a what-if-validated eviction
    of the WHOLE low-band app (every pod and its reservation), the
    refusal message names the victims, and the retry admits the
    preemptor gang."""
    h = Harness(extra_install=_policy_install(ordering="priority-then-fifo", preemption_enabled=True), device="cpu")
    try:
        h.new_node("n1", cpu="4", memory="4Gi")
        h.new_node("n2", cpu="4", memory="4Gi")
        nodes = ["n1", "n2"]
        low = h.static_allocation_spark_pods("app-low", 5)
        for pod in low:
            pod.labels[BAND_LABEL] = "low"
        for pod in low:
            h.assert_success(h.schedule(pod, nodes))
        h.wait_quiesced()
        assert h.get_resource_reservation("app-low") is not None

        high = h.static_allocation_spark_pods("app-high", 4)
        for pod in high:
            pod.labels[BAND_LABEL] = "high"
        result = h.schedule(high[0], nodes)
        h.assert_failure(result)
        assert "preempting victims: app-low" in "; ".join(result.failed_nodes.values())
        assert h.wait_for_api(lambda: all(_pod_gone(h, p.name) for p in low))
        assert h.wait_for_api(lambda: h.get_resource_reservation("app-low") is None)

        engine = h.server.policy
        assert h.wait_for_api(lambda: engine.coordinator.journal_depth() == 0)
        state = engine.state()
        recent = state["preemption"]["recent"]
        assert [e["app"] for e in recent] == ["app-low"]
        assert recent[0]["pods"] == len(low)
        assert recent[0]["replayed"] is False
        assert state["preemption"]["whatif"]["validated"] >= 1

        h.wait_quiesced()
        for pod in high:
            h.assert_success(h.schedule(pod, nodes))
        assert h.get_resource_reservation("app-high") is not None
    finally:
        h.close()


def test_no_partial_eviction_when_whole_gang_cannot_help():
    """When even evicting the entire low-band app cannot fit the
    preemptor, nothing is evicted."""
    h = Harness(extra_install=_policy_install(ordering="priority-then-fifo", preemption_enabled=True), device="cpu")
    try:
        h.new_node("n1", cpu="4", memory="4Gi")
        h.new_node("n2", cpu="4", memory="4Gi")
        nodes = ["n1", "n2"]
        low = h.static_allocation_spark_pods("app-low", 5)
        for pod in low:
            pod.labels[BAND_LABEL] = "low"
        for pod in low:
            h.assert_success(h.schedule(pod, nodes))
        h.wait_quiesced()
        huge = h.static_allocation_spark_pods("app-huge", 8, driver_cpu="2")
        for pod in huge:
            pod.labels[BAND_LABEL] = "high"
        result = h.schedule(huge[0], nodes)
        h.assert_failure(result)
        assert "preempting victims" not in "; ".join(result.failed_nodes.values())
        time.sleep(0.05)
        for pod in low:
            assert not _pod_gone(h, pod.name)
        assert h.get_resource_reservation("app-low") is not None
        assert h.server.policy.state()["preemption"]["evictionsTotal"] == 0
    finally:
        h.close()


def test_drf_accounting_tracks_tenants_off_rr_feed():
    """Per-tenant dominant shares are booked off the reservation change
    feed; the heavier tenant crosses the equal split, and deleting its
    reservation releases its share."""
    h = Harness(extra_install=_policy_install(ordering="drf"), device="cpu")
    try:
        h.new_node("n1")
        h.new_node("n2")
        nodes = ["n1", "n2"]
        heavy = h.static_allocation_spark_pods("app-heavy", 8)
        for pod in heavy:
            pod.labels[TENANT_LABEL] = "team-a"
        light = h.static_allocation_spark_pods("app-light", 1)
        for pod in light:
            pod.labels[TENANT_LABEL] = "team-b"
        for pod in heavy + light:
            h.assert_success(h.schedule(pod, nodes))
        h.wait_quiesced()
        engine = h.server.policy
        state = engine.drf.state()
        assert set(state) == {"team-a", "team-b"}
        assert state["team-a"]["dominantShare"] == pytest.approx(9 / 16)
        assert state["team-b"]["dominantShare"] == pytest.approx(2 / 16)
        assert state["team-a"]["fairShare"] == pytest.approx(0.5)
        assert set(engine.drf.over_share_tenants()) == {"team-a"}
        h.server.resource_reservation_cache.delete("default", "app-heavy")
        assert h.wait_for_api(lambda: set(engine.drf.state()) == {"team-b"})
        assert engine.drf.over_share_tenants() == {}
    finally:
        h.close()


def test_policy_state_endpoint_over_http():
    """GET /policy/state serves the engine's state when one is wired and
    ``{"enabled": false}`` when it is not."""
    import json
    import urllib.request

    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer

    def get_state(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/policy/state", timeout=10) as resp:
            assert resp.status == 200
            return json.loads(resp.read())

    h = Harness(extra_install=_policy_install(ordering="priority-then-fifo", preemption_enabled=True), device="cpu")
    http = None
    try:
        http = ExtenderHTTPServer(h.server, port=0, host="127.0.0.1")
        http.start()
        h.new_node("n1")
        pods = h.static_allocation_spark_pods("app-state", 1)
        for pod in pods:
            pod.labels[BAND_LABEL] = "high"
            pod.labels[TENANT_LABEL] = "team-a"
        for pod in pods:
            h.assert_success(h.schedule(pod, ["n1"]))
        h.wait_quiesced()
        state = get_state(http.port)
        assert state["enabled"] is True
        assert state["ordering"] == "priority-then-fifo"
        assert state["preemptionEnabled"] is True
        assert state["bands"]["high"] == {"rank": 2, "appsSeen": 1}
        assert set(state["bands"]) == {"low", "normal", "high"}
        assert "team-a" in state["tenants"]
        preemption = state["preemption"]
        assert preemption["journalDepth"] == 0 and preemption["evictionsTotal"] == 0
        assert preemption["recent"] == []
        assert preemption["whatif"] == {"attempts": 0, "validated": 0, "rejected": 0}
    finally:
        if http is not None:
            http.stop()
        h.close()
    bare = Harness(device="cpu")
    http = None
    try:
        http = ExtenderHTTPServer(bare.server, port=0, host="127.0.0.1")
        http.start()
        assert get_state(http.port) == {"enabled": False}
    finally:
        if http is not None:
            http.stop()
        bare.close()


# -- unit parity on seeded random bases ----------------------------------------


def _basis(rng, n=None):
    """(avail [N,3], exec_ok [N], driver_rank [N]) with negative
    availability on some nodes, ineligible nodes and tied rows."""
    n = n or int(rng.integers(4, 24))
    avail = rng.integers(-3, 12, size=(n, 3)).astype(np.int64)
    if n > 3:
        avail[1] = avail[0]  # a tie
    exec_ok = rng.random(n) < 0.85
    rank = np.where(rng.random(n) < 0.8, rng.integers(0, 3, size=n), ordering.INT32_SAFE).astype(np.int64)
    return avail, exec_ok, rank


def _gang(rng):
    """(driver row, executor row, count); zero-resource dimensions and
    zero-executor gangs occur."""
    driver = rng.integers(0, 4, size=3).astype(np.int64)
    executor = rng.integers(0, 4, size=3).astype(np.int64)
    executor[rng.random(3) < 0.3] = 0
    return driver, executor, int(rng.integers(0, 8))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_queue_sort_key_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pods = [
        SimpleNamespace(creation_timestamp=float(rng.integers(0, 4)), name=f"p{int(rng.integers(0, 5))}")
        for _ in range(40)
    ]
    for order in ordering.ORDERINGS:
        for pod in pods:
            rank, share = int(rng.integers(0, 3)), float(rng.integers(0, 3)) / 4
            assert ordering.queue_sort_key(order, rank, share, pod) == jax_ordering.queue_sort_key(
                order, rank, share, pod
            )
    assert ordering.ORDERINGS == jax_ordering.ORDERINGS


@pytest.mark.parametrize("seed", SEEDS)
def test_feasibility_placement_and_backfill_match_reference(seed):
    """gang_feasible, place_gang, backfill_cannot_delay and whatif_fits
    on 40 seeded (basis, gang) draws: equal verdicts and equal
    post-placement bases."""
    rng = np.random.default_rng(seed)
    verdicts = {"feasible": 0, "placed": 0, "backfill": 0, "whatif": 0}
    for _ in range(40):
        avail, exec_ok, rank = _basis(rng)
        head, cand = _gang(rng), _gang(rng)
        ours = ordering.gang_feasible(avail, exec_ok, rank, cand)
        assert ours == jax_ordering.gang_feasible(avail, exec_ok, rank, cand)
        placed = ordering.place_gang(avail, exec_ok, rank, cand)
        assert _same(placed, jax_ordering.place_gang(avail, exec_ok, rank, cand))
        safe = ordering.backfill_cannot_delay(avail, exec_ok, rank, head, cand)
        assert safe == jax_ordering.backfill_cannot_delay(avail, exec_ok, rank, head, cand)
        freed = rng.integers(0, 4, size=avail.shape).astype(np.int64)
        fits = victims.whatif_fits(avail, exec_ok, rank, freed, cand)
        assert fits == jax_victims.whatif_fits(avail, exec_ok, rank, freed, cand)
        verdicts["feasible"] += ours
        verdicts["placed"] += placed is not None
        verdicts["backfill"] += safe
        verdicts["whatif"] += fits
    # the draws reach both verdicts of every rule
    assert all(0 < v < 40 for v in verdicts.values()), verdicts


@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_caps_copy_matches_torch_probe(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        avail, exec_ok, _ = _basis(rng)
        _, executor, _ = _gang(rng)
        ours = ordering.caps_unclamped(avail, exec_ok, executor)
        theirs = torch_probe.caps_unclamped(
            torch.from_numpy(avail), torch.from_numpy(exec_ok), torch.from_numpy(executor)
        )
        assert np.array_equal(ours, theirs.numpy())
        assert np.array_equal(ours, jax_ordering.caps_unclamped(avail, exec_ok, executor))


def _rr(resources_cls, ns, name, rows, created=0.0, pods=()):
    """A stand-in ResourceReservation: ``rows`` is {reservation: (node,
    (cpu, memory, gpu))}."""
    reservations = {
        key: SimpleNamespace(node=node, resources_value=lambda q=q: resources_cls.of(*q))
        for key, (node, q) in rows.items()
    }
    return SimpleNamespace(
        namespace=ns,
        name=name,
        spec=SimpleNamespace(reservations=reservations),
        meta=SimpleNamespace(creation_timestamp=created),
        status=SimpleNamespace(pods={f"p{i}": p for i, p in enumerate(pods)}),
    )


def _seeded_rrs(rng, nodes, n_apps):
    """Per app: (ns, name, rows, created, pods) — plain values both
    packages' stand-ins are built from."""
    out = []
    for k in range(n_apps):
        rows = {}
        for r in range(int(rng.integers(1, 4))):
            q = (str(int(rng.integers(0, 4))), f"{int(rng.integers(0, 4))}Gi", str(int(rng.integers(0, 2))))
            node = nodes[int(rng.integers(0, len(nodes)))] if rng.random() < 0.9 else "gone"
            rows["driver" if r == 0 else f"executor-{r}"] = (node, q)
        ns = f"ns{int(rng.integers(0, 3))}"
        out.append((ns, f"app{k}", rows, float(rng.integers(0, 5)), [f"app{k}-pod{i}" for i in range(len(rows))]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_drf_accountant_matches_reference(seed):
    """The same reservation feed (creates, updates, deletes, tenant
    hints) into both accountants: equal dominant shares, over-share
    sets and state."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(5)]
    snap = SimpleNamespace(
        names=nodes,
        ready=rng.random(5) < 0.9,
        unschedulable=rng.random(5) < 0.1,
        allocatable=rng.integers(0, 20, size=(5, 3)).astype(np.int64) * np.array([1000, 2**30, 1]),
    )
    weights = {"ns0": 2.0, "team-x": 0.5, "bad": 0.0}
    ours = drf.DrfAccountant(weights, snapshot_fn=lambda: snap)
    theirs = jax_drf.DrfAccountant(weights, snapshot_fn=lambda: snap)
    apps = _seeded_rrs(rng, nodes, 10)
    for step in range(30):
        ns, name, rows, created, pods = apps[int(rng.integers(0, len(apps)))]
        action = rng.random()
        if action < 0.15:
            ours.note_app_tenant(ns, name, "team-x")
            theirs.note_app_tenant(ns, name, "team-x")
        else:
            new = action < 0.85
            for acct, res in ((ours, Resources), (theirs, JaxResources)):
                rr = _rr(res, ns, name, rows, created, pods)
                acct.observe(None if new else rr, rr if new else None)
        tenants = {"ns0", "ns1", "ns2", "team-x", "nobody"}
        assert {t: ours.dominant_share(t) for t in tenants} == {t: theirs.dominant_share(t) for t in tenants}
        assert ours.over_share_tenants() == theirs.over_share_tenants()
        assert ours.state() == theirs.state()
        assert ours.tenant_of(ns, name) == theirs.tenant_of(ns, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_victim_selector_matches_reference(seed):
    """VictimSelector.select on seeded running apps, bands, tenants,
    blockers and a session validator: the same victim sets (whole apps,
    in the same order), lanes and stats."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(6)]
    node_index = {n: i for i, n in enumerate(nodes)}
    apps = _seeded_rrs(rng, nodes, 8)
    bands = {name: int(rng.integers(0, 3)) for _, name, *_ in apps}
    band_names = {0: "low", 1: "normal", 2: "high"}
    chosen = []
    for trial in range(12):
        avail = rng.integers(-2, 6, size=(len(nodes), 3)).astype(np.int64)
        exec_ok = rng.random(len(nodes)) < 0.9
        rank = np.where(rng.random(len(nodes)) < 0.9, 0, ordering.INT32_SAFE).astype(np.int64)
        gang = (rng.integers(0, 3, size=3).astype(np.int64), rng.integers(0, 3, size=3).astype(np.int64),
                int(rng.integers(0, 6)))
        over = {"ns1": 0.7} if rng.random() < 0.5 else {}
        blockers = tuple(f"app{int(k)}" for k in rng.integers(0, 8, size=2))
        verdict = (None, True, False)[trial % 3]
        plans = []
        for sel_mod, res in ((victims, Resources), (jax_victims, JaxResources)):
            rrs = [_rr(res, ns, name, rows, created, pods) for ns, name, rows, created, pods in apps]
            selector = sel_mod.VictimSelector(
                list_rrs=lambda rrs=rrs: rrs,
                band_fn=lambda rr: (band_names[bands[rr.name]], bands[rr.name]),
                tenant_fn=lambda ns, name: ns,
                min_band_gap=1,
                max_victims=3,
            )
            for _ in range(trial % 2 + 1):
                plan = selector.select(
                    "pre", "high", 2, gang, avail, exec_ok, rank, node_index,
                    over_share=over, blockers=blockers,
                    session_validate=None if verdict is None else (lambda freed, v=verdict: v),
                )
            plans.append(
                (
                    None
                    if plan is None
                    else (plan.preemptor_app, plan.preemptor_band, plan.lane,
                          [(v.namespace, v.app_id, v.band, v.band_rank, v.tenant, v.created, v.pods,
                            v.freed.tolist()) for v in plan.victims]),
                    selector.stats(),
                )
            )
        assert plans[0] == plans[1]
        chosen.append(plans[0][0] is not None)
    assert any(chosen) and not all(chosen)


# -- server parity through Twin ------------------------------------------------


def _labelled(wires, band=None, tenant=None):
    out = []
    for wire in wires:
        labels = dict(wire["metadata"].get("labels") or {})
        if band:
            labels[BAND_LABEL] = band
        if tenant:
            labels[TENANT_LABEL] = tenant
        out.append(dict(wire, metadata=dict(wire["metadata"], labels=labels)))
    return out


def _assert_policy_bodies_equal(twin, apps):
    (js, jstate), (ps, pstate) = twin.get("/policy/state")
    assert js == ps == 200 and pstate == jstate
    (js, jlist), (ps, plist) = twin.get("/lifecycle")
    assert js == ps == 200 and plist["gangs"] == jlist["gangs"]
    assert lifecycle_summary_body(plist["summary"]) == lifecycle_summary_body(jlist["summary"])
    for app in apps:
        (js, jrec), (ps, prec) = twin.get(f"/lifecycle/{app}")
        assert js == ps == 200
        assert lifecycle_record_body(prec) == lifecycle_record_body(jrec)
    return pstate, plist


LANES = ("tpu-batch", "tightly-pack")


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("order", ordering.ORDERINGS)
def test_twin_filters_equal_under_each_ordering(order, lane):
    """A queue of banded, tenanted drivers behind two running apps:
    under each ordering the granted and refused Filters (messages
    included) are byte-equal, and the orderings decide differently
    where they should."""
    twin = Twin(lane, policy={"enabled": True, "ordering": order})
    try:
        twin.quiet_observatories()
        for i, zone in enumerate(("zone1", "zone1", "zone2", "zone2")):
            twin.add_node(f"n{i}", cpu="8", memory="16Gi", zone=zone)
        names = [f"n{i}" for i in range(4)]
        for pod in _labelled(twin.static_pods("run-a", 10, age=900.0), "normal", "team-a"):
            assert twin.schedule(pod, names)
        for pod in _labelled(twin.static_pods("run-b", 2, age=890.0), "low", "team-b"):
            assert twin.schedule(pod, names)
        # queued, never Filtered: an old low-band gang too large to fit,
        # and a young high-band one that fits
        blocked = _labelled(twin.static_pods("q-low", 30, age=500.0), "low", "team-a")[0]
        twin.create_pod(blocked)
        young = _labelled(twin.static_pods("q-high", 2, age=100.0), "high", "team-b")
        twin.create_pod(young[0])
        current = _labelled(twin.static_pods("cur", 2, age=10.0), "normal", "team-b")
        granted = twin.schedule(current[0], names)
        # fifo: the old low-band gang blocks; the others put it behind
        assert (granted is None) == (order == "fifo")
        # the young high-band gang: behind the blocked one only in fifo
        assert (twin.schedule(young[0], names) is None) == (order == "fifo")
        rng = np.random.default_rng(7)
        for k in range(6):
            band = ("low", "normal", "high")[int(rng.integers(0, 3))]
            tenant = ("team-a", "team-b", "team-c")[int(rng.integers(0, 3))]
            pods = _labelled(twin.static_pods(f"r{k}", int(rng.integers(1, 5)), age=float(rng.integers(0, 50))),
                             band, tenant)
            if twin.schedule(pods[0], names):
                for pod in pods[1:]:
                    assert twin.schedule(pod, names)
            twin.settle()  # demands are stamped when their write-back lands
            twin.advance(5.0)
        twin.schedule(blocked, names)
        twin.assert_state_equal()
        state, _ = _assert_policy_bodies_equal(twin, ["run-a", "q-low", "cur", "q-high"])
        assert state["ordering"] == order
        assert state["bands"]["high"]["appsSeen"] >= 1
        if order == "drf":
            assert {"team-a", "team-b"} <= set(state["tenants"])
        if lane == "tpu-batch":
            assert twin.port_fast_lane_count() > 0
    finally:
        twin.close()


@pytest.mark.parametrize("lane", LANES)
def test_twin_backfill_probe_widens_a_skip(lane):
    """A young queued gang that needs more GPUs than exist blocks the
    queue; the backfill probe proves a CPU-only candidate cannot delay
    it, so the candidate is granted on both sides — and refused once
    the head is older than the starvation age."""
    twin = Twin(lane, policy={"enabled": True, "ordering": "priority-then-fifo", "backfill": True})
    try:
        twin.quiet_observatories()
        twin.add_node("n0", cpu="16", memory="32Gi", gpu="0")
        twin.add_node("n1", cpu="4", memory="8Gi", gpu="2")
        names = ["n0", "n1"]
        head = twin.static_pods("head", 4, age=100.0, executor_gpu="1")[0]
        twin.create_pod(head)
        cand = twin.static_pods("cand", 2, age=50.0)
        for pod in cand:
            assert twin.schedule(pod, names)
        skips = [h.server.metrics.get_counter(M.POLICY_BACKFILL_SKIPS) for h in (twin.jax, twin.port)]
        assert skips[0] == skips[1] >= 1
        # past the starvation age the head may no longer be skipped
        twin.advance(600.0)
        late = twin.static_pods("late", 1, age=10.0)[0]
        assert twin.schedule(late, names) is None
        assert "earlier drivers do not fit" in twin.results[-1]["FailedNodes"]["n0"]
        _assert_policy_bodies_equal(twin, ["head", "cand", "late"])
    finally:
        twin.close()


@pytest.mark.parametrize("lane", LANES)
def test_twin_preemption_evicts_and_admits(lane):
    """The preemption scenario on both packages: the same refusal note,
    the victim's pods gone from both API servers, the retry granted, and
    equal /policy/state and /lifecycle (the victim ``evicted`` with its
    cause)."""
    twin = Twin(lane, policy={"enabled": True, "ordering": "priority-then-fifo", "preemption_enabled": True})
    try:
        twin.quiet_observatories()
        twin.add_node("n1", cpu="4", memory="4Gi")
        twin.add_node("n2", cpu="4", memory="4Gi")
        names = ["n1", "n2"]
        low = _labelled(twin.static_pods("app-low", 5, age=100.0), "low", "team-a")
        for pod in low:
            assert twin.schedule(pod, names)
        high = _labelled(twin.static_pods("app-high", 4, age=10.0), "high", "team-b")
        assert twin.schedule(high[0], names) is None
        assert "preempting victims: app-low" in twin.results[-1]["FailedNodes"]["n1"]
        for h in (twin.jax, twin.port):
            for pod in low:
                assert h.wait_for_api(lambda h=h, pod=pod: _pod_gone(h, pod["metadata"]["name"]))
        for pod in high:
            assert twin.schedule(pod, names)
        twin.assert_state_equal()
        state, listing = _assert_policy_bodies_equal(twin, ["app-low", "app-high"])
        assert [e["app"] for e in state["preemption"]["recent"]] == ["app-low"]
        assert state["preemption"]["journalDepth"] == 0
        assert {g["app"]: g["phase"] for g in listing["gangs"]}["app-low"] == "evicted"
        assert listing["summary"]["evictionsByCause"] == {"preempted": 1}
    finally:
        twin.close()


@pytest.mark.parametrize("path", ["/policy/state", "/status/ha"])
def test_disabled_endpoints_answer_like_the_reference(path):
    twin = Twin("tightly-pack")
    try:
        jax_side, port_side = twin.get(path)
        assert port_side == jax_side == (200, {"enabled": False})
    finally:
        twin.close()


def test_default_install_builds_no_engine():
    """The structural half of the reference's disabled-policy perf
    guard: no engine, so every hook is one ``is None`` check."""
    h = Harness(binpack_algo="tpu-batch", device="cpu")
    try:
        assert h.server.policy is None
        assert h.extender._policy is None
        assert h.server.lifecycle._policy is None
    finally:
        h.close()


# -- failover: the evict journal ------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_evict_journal_replays_exactly_once_across_failover(tmp_path, writer):
    """An evict intent journaled before any delete (a leader that died
    between journal and ack; written by this package or by the
    reference) replays at the next boot: each victim pod is deleted
    exactly once, the journal drains, and a third instance deletes
    nothing."""
    journal_path = str(tmp_path / "intents.jsonl")

    def install():
        return Install(
            fifo=True,
            binpack_algo="tightly-pack",
            resilience=ResilienceConfig(journal_path=journal_path),
            policy=PolicyConfig(enabled=True, ordering="priority-then-fifo", preemption_enabled=True),
        )

    h = Harness(extra_install=install(), device="cpu")
    pod_deletes = {}
    real_delete = h.api.delete

    def counting_delete(kind, namespace, name):
        real_delete(kind, namespace, name)
        if kind == "Pod":
            pod_deletes[name] = pod_deletes.get(name, 0) + 1

    second = third = None
    try:
        h.new_node("n1")
        h.new_node("n2")
        nodes = ["n1", "n2"]
        victims_pods = h.static_allocation_spark_pods("app-victim", 2)
        for p in victims_pods:
            p.labels[BAND_LABEL] = "low"
        for p in victims_pods:
            h.assert_success(h.schedule(p, nodes))
        h.wait_quiesced()
        victim_pods = [p.name for p in victims_pods]
        intent = {
            "pods": victim_pods,
            "reason": "preempted by app-high (band high, numpy what-if)",
            "preemptor": "app-high",
            "band": "low",
            "tenant": "default",
        }
        if writer == "port":
            h.server.policy.coordinator._journal.record("delete", EVICT_KIND, "default", "app-victim", intent)
            h.server.stop()
        else:
            from k8s_spark_scheduler_tpu.policy.preempt import EVICT_KIND as JAX_EVICT_KIND
            from k8s_spark_scheduler_tpu.resilience.journal import IntentJournal as JaxJournal

            h.server.stop()
            journal = JaxJournal(journal_path + EVICT_JOURNAL_SUFFIX)
            journal.record("delete", JAX_EVICT_KIND, "default", "app-victim", intent)
            journal.close()
        assert pod_deletes == {}
        h.api.delete = counting_delete

        second = init_server_with_clients(h.api, install(), demand_poll_interval=0.02, device="cpu")
        assert second.policy.coordinator.journal_depth() == 0
        for name in victim_pods:
            with pytest.raises(NotFoundError):
                h.api.get("Pod", "default", name)
        assert pod_deletes == {name: 1 for name in victim_pods}
        assert h.wait_for_api(lambda: h.api.list("ResourceReservation") == [])
        recent = second.policy.coordinator.state()["recent"]
        assert [(e["app"], e["replayed"]) for e in recent] == [("app-victim", True)]
        assert recent[0]["reason"].startswith("preempted by app-high")
        second.stop()
        deletes_after_second = dict(pod_deletes)

        third = init_server_with_clients(h.api, install(), demand_poll_interval=0.02, device="cpu")
        assert third.policy.coordinator.journal_depth() == 0
        assert third.policy.coordinator.state()["recent"] == []
        time.sleep(0.2)
        assert pod_deletes == deletes_after_second
    finally:
        h.api.delete = real_delete
        for server in (second, third):
            if server is not None:
                server.stop()
        h.close()


# -- race detectors ------------------------------------------------------------


def test_policy_server_runs_clean_under_the_detector(monkeypatch):
    """A policy-on tensor-lane server (priority order, backfill,
    preemption, DRF hints) driven through queued, backfilled, preempting
    and granted Filters with the sampler and the ledger live: 0 lockset
    races, 0 happens-before races, 0 lock-order cycles — the Filter
    takes the mirror's snapshot and then the engine's basis lock under
    the predicate lock."""
    assert not jax_racecheck.active()
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    install = Install(
        fifo=True,
        binpack_algo="tpu-batch",
        policy=PolicyConfig(enabled=True, ordering="priority-then-fifo", backfill=True, preemption_enabled=True),
    )
    h = None
    try:
        h = Harness(extra_install=install, device="cpu")
        assert racecheck.active()
        h.new_node("n0", cpu="8", memory="16Gi", gpu="0")
        h.new_node("n1", cpu="4", memory="8Gi", gpu="2")
        names = ["n0", "n1"]
        t0 = time.time()
        low = h.static_allocation_spark_pods("low", 6, creation_timestamp=t0 - 200)
        for pod in low:
            pod.labels[BAND_LABEL] = "low"
            pod.labels[TENANT_LABEL] = "team-a"
        for pod in low:
            assert h.schedule(pod, names).node_names
        head = h.static_allocation_spark_pods("head", 4, executor_gpu="1", creation_timestamp=t0 - 100)[0]
        h.create_pod(head)
        cand = h.static_allocation_spark_pods("cand", 1, creation_timestamp=t0 - 50)
        for pod in cand:
            assert h.schedule(pod, names).node_names
        high = h.static_allocation_spark_pods("high", 6, creation_timestamp=t0 - 10)
        for pod in high:
            pod.labels[BAND_LABEL] = "high"
        result = h.schedule(high[0], names)
        assert not result.node_names
        assert "preempting victims: low" in "; ".join(result.failed_nodes.values())
        h.wait_quiesced()
        for pod in high:
            assert h.schedule(pod, names).node_names
        h.wait_quiesced()
        h.server.capacity.sample_now(trigger="test")
        h.server.lifecycle.drain(trigger="test")
        assert h.server.policy.state()["preemption"]["evictionsTotal"] == 1
    finally:
        if h is not None:
            h.close()
        detector = racecheck.disable()
    assert detector is not None
    assert detector.races == [] and detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], "\n".join(detector.report_lines())
    assert len(detector._instances) > 30
