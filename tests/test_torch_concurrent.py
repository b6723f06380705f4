"""The port's concurrent admission engine (concurrent/) against the
reference's tests/test_concurrent.py and against the JAX package.

The property test fans the speculate→FIFO-commit engine across 2/4/8
client threads over seeded workloads, for every tpu-batch policy, and
holds its decisions three ways: the port's engine, the port's serial
extender and the JAX package's serial extender on the same workload,
pod for pod (granted nodes and FailedNodes messages).  The unit half
mirrors the reference's CommitGate, stale-epoch intent, shed / revive
and disabled-wires-nothing cases; then the speculation itself: each
verdict against the JAX speculator's on seeded snapshots, every
``consume`` reason, a solve error that propagates instead of declining,
and the race detectors over the 8-thread case, all on ``device="cpu"``,
where the kernels' plain versions serve (the per-thread CUDA streams
against ``device="cpu"`` are in tests/test_torch_concurrent_cuda.py,
which the card's machine can run: it imports no JAX)."""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.analysis import guarded as jax_guarded
from k8s_spark_scheduler_tpu.analysis import racecheck as jax_racecheck
from k8s_spark_scheduler_tpu.config import ConcurrentConfig as JaxConcurrentConfig
from k8s_spark_scheduler_tpu.config import FifoConfig as JaxFifoConfig
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.testing.harness import Harness as JaxHarness
from k8s_spark_scheduler_tpu.types.extenderapi import ExtenderArgs as JaxArgs
from k8s_spark_scheduler_tpu_torch.analysis import guarded as port_guarded
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.concurrent import (
    CommitGate,
    ConcurrentAdmissionEngine,
    SpeculativeVerdict,
)
from k8s_spark_scheduler_tpu_torch.config import (
    ConcurrentConfig,
    FifoConfig,
    Install,
    PolicyConfig,
    ResilienceConfig,
)
from k8s_spark_scheduler_tpu_torch.contention import criticalpath
from k8s_spark_scheduler_tpu_torch.ha.fencing import StaleEpochError
from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
from k8s_spark_scheduler_tpu_torch.ops import fifo_solver
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs
from k8s_spark_scheduler_tpu_torch.types.objects import Pod, PodPhase

POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly", "tpu-batch-minimal-fragmentation")


def _install(policy: str, concurrent: bool = False, jax: bool = False, **conc):
    """An Install identical to the default Harness wiring except for the
    binpack policy and the concurrent block (the property test depends
    on everything else matching the serial install exactly)."""
    if jax:
        kw = {"concurrent": JaxConcurrentConfig(enabled=True, **conc)} if concurrent else {}
        return JaxInstall(fifo=True, fifo_config=JaxFifoConfig(), binpack_algo=policy, **kw)
    kw = {"concurrent": ConcurrentConfig(enabled=True, **conc)} if concurrent else {}
    return Install(fifo=True, fifo_config=FifoConfig(), binpack_algo=policy, **kw)


def _harness(policy: str, concurrent: bool = False, jax: bool = False, **conc):
    install = _install(policy, concurrent, jax, **conc)
    if jax:
        return JaxHarness(extra_install=install)
    return Harness(extra_install=install, device="cpu")


# -- the seeded workload (the reference's: varied sizes so some apps fit,
#    some hit failure-fit, refused ones gate later drivers) -----------------


def _seeded_workload(seed: int):
    rng = np.random.RandomState(seed)
    nodes = [(f"n{i}", str(int(rng.randint(4, 9))), f"{int(rng.randint(4, 9))}Gi") for i in range(3)]
    apps = [(f"app-{seed}-{i}", int(rng.randint(0, 4)), str(int(rng.randint(1, 3)))) for i in range(6)]
    return nodes, apps


def _build_cluster(h, seed: int):
    """Nodes and every pod up front (creation timestamps fix the FIFO
    order, identically for every run); returns the flat scheduling order
    [driver, executors..] app by app and the node names."""
    nodes, apps = _seeded_workload(seed)
    for name, cpu, mem in nodes:
        h.new_node(name, cpu=cpu, memory=mem)
    flat = []
    for i, (app_id, executor_count, executor_cpu) in enumerate(apps):
        for pod in h.static_allocation_spark_pods(
            app_id, executor_count, executor_cpu=executor_cpu, creation_timestamp=1000.0 + i
        ):
            h.create_pod(pod)
            flat.append(pod)
    return flat, [n[0] for n in nodes]


def _decision(pod, result):
    return (pod.name, tuple(result.node_names or ()), tuple(sorted((result.failed_nodes or {}).items())))


def _run_serial(policy: str, seed: int, jax: bool = False):
    h = _harness(policy, jax=jax)
    try:
        assert h.server.concurrent is None
        flat, node_names = _build_cluster(h, seed)
        return [_decision(p, h.schedule(p, node_names)) for p in flat]
    finally:
        h.close()


def _fan_out(h, flat, node_names, n_threads: int):
    """Every pod of ``flat`` through the engine from ``n_threads``
    threads, tickets pre-assigned in workload order and each grant bound
    inside its commit turn; returns the decisions in ticket order."""
    engine = h.server.concurrent
    tickets = [engine.gate.ticket() for _ in flat]
    decisions = [None] * len(flat)
    errors = []

    def bind(result, pod):
        # the deterministic stand-in for the kube bind that follows a
        # granted Filter, inside the commit turn so the next commit sees it
        if result.node_names:
            bound = h.api.get(Pod.KIND, pod.namespace, pod.name)
            bound.node_name = result.node_names[0]
            bound.phase = PodPhase.RUNNING
            h.api.update(bound)

    def worker(idx: int):
        try:
            # each thread owns every n_threads-th request, in increasing
            # ticket order — no cyclic waits
            for j in range(idx, len(flat), n_threads):
                pod = h.server.pod_informer.get(flat[j].namespace, flat[j].name).deepcopy()
                args = ExtenderArgs(pod=pod, node_names=list(node_names))
                result = engine.predicate(args, ticket=tickets[j], post_commit=lambda r, p=pod: bind(r, p))
                decisions[j] = _decision(pod, result)
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors.append((idx, err))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert all(d is not None for d in decisions)
    return decisions


def _run_concurrent(policy: str, seed: int, n_threads: int):
    h = _harness(policy, concurrent=True)
    try:
        assert h.server.concurrent is not None
        flat, node_names = _build_cluster(h, seed)
        decisions = _fan_out(h, flat, node_names, n_threads)
        return decisions, h.server.concurrent.stats(), h.server.metrics.snapshot()
    finally:
        h.close()


def _counted(snapshot, name: str, tag: str) -> float:
    return sum(v for k, v in snapshot["counters"].items() if name in k and tag in k)


# seed × client threads × policy: the reference's five cases
CASES = [
    (11, 2, "tpu-batch"),
    (23, 4, "tpu-batch-distribute-evenly"),
    (37, 8, "tpu-batch-minimal-fragmentation"),
    (41, 4, "tpu-batch"),
    (59, 8, "tpu-batch-distribute-evenly"),
]


@pytest.mark.parametrize("seed,n_threads,policy", CASES)
def test_concurrent_engine_is_decision_identical_to_serial_and_to_the_reference(seed, n_threads, policy):
    theirs = _run_serial(policy, seed, jax=True)
    baseline = _run_serial(policy, seed)
    decisions, stats, snapshot = _run_concurrent(policy, seed, n_threads)
    assert baseline == theirs
    assert decisions == baseline
    # every request committed through the gate, none aborted, and the
    # head drained to the ticket count (no stuck turns)
    gate = stats["gate"]
    assert gate["committed"] == len(baseline)
    assert gate["aborted"] == 0
    assert gate["head"] == gate["issued"] == len(baseline)
    assert sum(stats["commit_results"].values()) == len(baseline)
    # speculation engaged, and at least the uncontended verdicts survived
    # revalidation as seq / memcmp hits
    assert _counted(snapshot, "concurrent.speculation.count", "outcome=solved") > 0, stats
    hits = stats["commit_results"].get("seq-hit", 0) + stats["commit_results"].get("memcmp-hit", 0)
    assert hits > 0, stats["commit_results"]
    assert _counted(snapshot, "concurrent.speculation.count", "outcome=error") == 0


def test_disabled_config_wires_no_engine():
    h = _harness("tpu-batch")
    try:
        assert h.server.concurrent is None
        assert h.extender.speculation_intake is None
    finally:
        h.close()


# -- CommitGate: linearizable FIFO turn-taking ---------------------------------


def test_gate_tickets_are_fifo_and_head_turn_returns_immediately():
    gate = CommitGate()
    assert [gate.ticket() for _ in range(3)] == [0, 1, 2]
    gate.await_turn(0)  # head: no parking
    gate.retire(0, committed=True)
    assert gate.head() == 1
    s = gate.stats()
    assert s["committed"] == 1 and s["aborted"] == 0
    assert s["max_queue_depth"] == 3


def test_gate_parks_until_every_earlier_ticket_retires():
    gate = CommitGate()
    t0, t1 = gate.ticket(), gate.ticket()
    entered = threading.Event()
    done = threading.Event()

    def late():
        entered.set()
        gate.await_turn(t1)
        done.set()

    th = threading.Thread(target=late, daemon=True)
    th.start()
    assert entered.wait(5)
    assert not done.wait(0.1), "ticket 1 committed before ticket 0 retired"
    gate.retire(t0, committed=True)
    assert done.wait(5), "head advance never woke the parked waiter"
    gate.retire(t1, committed=True)
    th.join(5)
    assert gate.depth() == 0


def test_gate_aborts_skip_ahead_without_stalling_fifo():
    gate = CommitGate()
    t0, t1, t2 = gate.ticket(), gate.ticket(), gate.ticket()
    # ticket 1 aborts out of order (deadline expiry before its turn)
    gate.retire(t1, committed=False)
    assert gate.head() == t0
    gate.retire(t0, committed=True)
    # the head skipped the aborted ticket: 2 commits next, immediately
    assert gate.head() == t2
    gate.await_turn(t2)
    gate.retire(t2, committed=True)
    s = gate.stats()
    assert s["committed"] == 2 and s["aborted"] == 1
    assert s["head"] == s["issued"] == 3


# -- multi-active: epoch-fenced commit intents ---------------------------------


def test_stale_epoch_intent_is_refused_before_the_gate():
    h = _harness("tpu-batch")
    try:
        h.new_node("n1", cpu="8", memory="8Gi")
        epoch = [1]
        engine = ConcurrentAdmissionEngine(
            h.extender, ConcurrentConfig(enabled=True), metrics=h.server.metrics, epoch_source=lambda: epoch[0]
        )
        pods = h.static_allocation_spark_pods("app-intent", 0)
        h.create_pod(pods[0])
        args = ExtenderArgs(pod=pods[0], node_names=["n1"])
        intent = engine.make_intent(args, origin="replica-b")
        assert intent.epoch == 1 and intent.pod_name == pods[0].name
        assert isinstance(intent.verdict, SpeculativeVerdict) and intent.verdict.will_commit

        # leadership moved: the forwarded intent is refused before it
        # ever reaches the commit gate
        epoch[0] = 2
        with pytest.raises(StaleEpochError):
            engine.submit_intent(intent)
        snapshot = h.server.metrics.snapshot()
        assert _counted(snapshot, "concurrent.intents.forwarded", "stale-epoch") == 1
        assert engine.gate.stats()["committed"] == 0

        # a fresh intent under the current epoch commits and grants the node
        fresh = engine.make_intent(args, origin="replica-b")
        assert fresh.epoch == 2
        assert engine.submit_intent(fresh).node_names == ["n1"]
        snapshot = h.server.metrics.snapshot()
        assert _counted(snapshot, "concurrent.intents.forwarded", "result=committed") == 1
        assert engine.stats()["commit_results"] == {"seq-hit": 1}
    finally:
        h.close()


# -- AdmissionGate shed: terminal phase + provenance + revival -----------------


def test_shed_leaves_audit_trail_and_revives_on_retry():
    """A shed Filter leaves a refusal's audit trail (a provenance record,
    a lifecycle ``shed`` phase); the retry revives the gang — with the
    engine wired, through it."""
    from k8s_spark_scheduler_tpu_torch.server.http import _Handler

    install = Install(
        fifo=True,
        fifo_config=FifoConfig(),
        binpack_algo="tpu-batch",
        resilience=ResilienceConfig(admission_max_waiters=1),
        concurrent=ConcurrentConfig(enabled=True),
    )
    h = Harness(extra_install=install, device="cpu")
    try:
        h.new_node("n1", cpu="8", memory="8Gi")
        pods = h.static_allocation_spark_pods("app-shed", 0)
        driver = h.create_pod(pods[0])
        args = ExtenderArgs(pod=driver, node_names=["n1"])
        shim = types.SimpleNamespace(scheduler=h.server)
        kit = h.server.resilience
        with kit.gate.admit():  # occupy the only admission slot
            result = _Handler._predicate_guarded(shim, args)
        assert not result.node_names
        assert set(result.failed_nodes) == {"n1"}
        assert "overloaded" in result.failed_nodes["n1"]
        assert h.server.concurrent.gate.stats()["issued"] == 0  # shed before the engine

        rec = h.server.provenance.explain(driver.name, source="test")
        assert rec is not None and rec["outcome"] == "shed" and rec["namespace"] == "default"
        gang = h.server.lifecycle.record("app-shed")
        assert gang is not None and gang["phase"] == "shed"

        retry = _Handler._predicate_guarded(shim, args)
        assert retry.node_names == ["n1"]
        assert h.server.concurrent.gate.stats()["committed"] == 1
        for _ in range(200):
            gang = h.server.lifecycle.record("app-shed")
            if gang["phase"] != "shed":
                break
            time.sleep(0.05)  # the ledger drains on its own thread
        assert gang["phase"] != "shed", gang
    finally:
        h.close()


# -- the speculation against the JAX speculator's -------------------------------


def _speculation_scene(h, seed: int, n_nodes: int = 6, n_queued: int = 5):
    """Seeded nodes in two zones, queued drivers and a current driver in
    one harness; returns (the current driver, node names)."""
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n_nodes):
        name = f"n{i}"
        h.new_node(name, cpu=str(int(rng.randint(4, 17))), memory=f"{int(rng.randint(8, 33))}Gi",
                   zone=f"zone{i % 2}")
        names.append(name)
    for i in range(n_queued):
        h.create_pod(h.static_allocation_spark_pods(
            f"queued-{i}", int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 4))),
            creation_timestamp=1000.0 + i)[0])
    current = h.static_allocation_spark_pods(
        "current", int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 3))),
        creation_timestamp=1000.0 + n_queued)[0]
    return h.create_pod(current), names


def _verdict_fields(verdict):
    o = verdict.outcome
    r = o.result
    art = verdict.artifacts
    n = len(verdict.node_names)
    return {
        "supported": o.supported,
        "earlier_ok": o.earlier_ok,
        "feasible": None if r is None else r.has_capacity,
        "driver": None if r is None else r.driver_node,
        "executors": None if r is None else tuple(r.executor_nodes),
        "zones": dict(verdict.zones),
        "will_commit": verdict.will_commit,
        "skip_allowed": verdict.skip_allowed,
        "node_names": verdict.node_names,
        "queue_feasible": tuple(bool(x) for x in np.asarray(art.feasible)[: art.n_earlier]),
        "avail_after": np.asarray(torch.as_tensor(art.avail_after).cpu() if isinstance(art.avail_after, torch.Tensor)
                                  else art.avail_after)[:n].tolist(),
        "scale": np.asarray(art.scale).tolist(),
    }


@pytest.mark.parametrize("policy", POLICIES)
def test_speculation_verdict_equals_the_reference_speculators(policy):
    """On seeded snapshots the port's verdict and the JAX speculator's
    agree: the outcome (queue verdict, feasibility, the driver's node,
    the executors), the zones, the skip verdicts, the queue's per-app
    feasibility and the availability after the queue (the solve
    artifacts).  Each side speculates on its own harness, the JAX one on
    its CPU backend."""
    for seed in range(4):
        ours, theirs = _harness(policy, concurrent=True), _harness(policy, concurrent=True, jax=True)
        try:
            pod, names = _speculation_scene(ours, seed)
            jpod, jnames = _speculation_scene(theirs, seed)
            v_ours = ours.server.concurrent.speculator.speculate(0, ExtenderArgs(pod=pod, node_names=names))
            v_theirs = theirs.server.concurrent.speculator.speculate(0, JaxArgs(pod=jpod, node_names=jnames))
            assert v_ours is not None and v_theirs is not None, (seed, v_ours, v_theirs)
            assert _verdict_fields(v_ours) == _verdict_fields(v_theirs), seed
        finally:
            ours.close()
            theirs.close()


# -- consume: every revalidation reason -----------------------------------------


def _speculated(h, seed: int = 3):
    pod, names = _speculation_scene(h, seed)
    args = ExtenderArgs(pod=pod, node_names=names)
    verdict = h.server.concurrent.speculator.speculate(0, args)
    assert verdict is not None
    ext = h.extender
    snap = ext._tensor_snapshot.snapshot()
    queued = ext._earlier_drivers(pod)
    from k8s_spark_scheduler_tpu_torch.scheduler.sparkpods import spark_app_demand_cached

    earlier = [spark_app_demand_cached(q)[1] for q in queued]
    return pod, names, verdict, snap, earlier


def _moved(snap, **arrays):
    """The snapshot with its content key moved on (and ``arrays``
    replaced): the mirror absorbed a mutation."""
    key = tuple(snap.content_key)
    return dataclasses.replace(snap, content_key=(key[0], key[1] + 1), **arrays)


CONSUME = {
    "seq-hit": lambda pod, names, v, snap, earlier: (pod, snap, names, earlier, list(v.skip_allowed)),
    "memcmp-hit": lambda pod, names, v, snap, earlier: (
        pod, _moved(snap, usage=snap.usage.copy()), names, earlier, list(v.skip_allowed)),
    "pod-mismatch": lambda pod, names, v, snap, earlier: (
        types.SimpleNamespace(namespace=pod.namespace, name="other"), snap, names, earlier, list(v.skip_allowed)),
    "candidate-drift": lambda pod, names, v, snap, earlier: (pod, snap, names[:-1], earlier, list(v.skip_allowed)),
    "queue-drift": lambda pod, names, v, snap, earlier: (pod, snap, names, earlier[1:], list(v.skip_allowed)[1:]),
    "skip-drift": lambda pod, names, v, snap, earlier: (
        pod, snap, names, earlier, [not s for s in v.skip_allowed]),
    "conflict": lambda pod, names, v, snap, earlier: (
        pod, _moved(snap, usage=snap.usage + 1), names, earlier, list(v.skip_allowed)),
}


@pytest.mark.parametrize("reason", list(CONSUME))
def test_consume_reason(reason):
    h = _harness("tpu-batch", concurrent=True)
    try:
        pod, names, verdict, snap, earlier = _speculated(h)
        assert earlier, "the scene queues earlier drivers"
        served, got = verdict.consume(*CONSUME[reason](pod, names, verdict, snap, earlier))
        assert got == reason
        if reason.endswith("-hit"):
            assert served == (verdict.outcome, verdict.zones)
        else:
            assert served is None
    finally:
        h.close()


def test_moved_basis_re_solves_under_the_lock_with_the_serial_answer():
    """A verdict whose basis moved before its commit (the earlier driver
    granted and bound in between: its queue drifted) is a conflict; the
    serial path re-solves and the decision equals the serial
    extender's."""
    h = _harness("tpu-batch", concurrent=True)
    serial = _harness("tpu-batch")
    try:
        answers = []
        for side in (h, serial):
            for name in ("n0", "n1"):
                side.new_node(name, cpu="4", memory="8Gi")
            a = side.static_allocation_spark_pods("first", 1, creation_timestamp=1000.0)
            b = side.static_allocation_spark_pods("second", 1, creation_timestamp=1001.0)
            for pod in a + b:
                side.create_pod(pod)
            answers.append((side, a, b))
        (_, a, b), (_, sa, sb) = answers
        engine = h.server.concurrent
        args_b = ExtenderArgs(pod=b[0], node_names=["n0", "n1"])
        verdict_b = engine.speculator.speculate(99, args_b)
        engine.speculator.finish(99)
        assert verdict_b is not None
        # the first app's driver commits: the basis moves under b's verdict
        for side, pods in ((h, a), (serial, sa)):
            assert side.schedule(pods[0], ["n0", "n1"]).node_names
        got = engine.predicate(args_b, verdict=verdict_b)
        want = serial.extender.predicate(ExtenderArgs(pod=sb[0], node_names=["n0", "n1"]))
        assert _decision(b[0], got) == _decision(sb[0], want)
        assert engine.stats()["commit_results"].get("queue-drift") == 1
        assert h.server.metrics.get_counter(mnames.CONCURRENT_COMMIT_CONFLICTS) == 1
    finally:
        h.close()
        serial.close()


# -- declines and errors ----------------------------------------------------------


def test_declines_carry_the_reference_reasons():
    """An executor, a replayed driver, a policy-engine server and a
    single-AZ server each decline for the reference's reason."""
    h = _harness("tpu-batch", concurrent=True)
    try:
        pod, names = _speculation_scene(h, 0)
        spec = h.server.concurrent.speculator
        execs = h.static_allocation_spark_pods("current", 1)[1:]
        assert spec.speculate(0, ExtenderArgs(pod=execs[0], node_names=names)) is None
        assert h.schedule(pod, names).node_names  # reserved: a retry is a replay
        assert spec.speculate(1, ExtenderArgs(pod=pod, node_names=names)) is None
        snapshot = h.server.metrics.snapshot()
        assert _counted(snapshot, "concurrent.speculation.count", "outcome=not-driver") == 1
        assert _counted(snapshot, "concurrent.speculation.count", "outcome=replay") == 1
    finally:
        h.close()
    for install, reason in (
        (Install(fifo=True, binpack_algo="tpu-batch", concurrent=ConcurrentConfig(enabled=True),
                 policy=PolicyConfig(enabled=True)), "policy-engine"),
        (Install(fifo=True, binpack_algo="single-az-tightly-pack", concurrent=ConcurrentConfig(enabled=True)),
         "no-tensor-solver"),
    ):
        h = Harness(extra_install=install, device="cpu")
        try:
            pod, names = _speculation_scene(h, 1)
            assert h.server.concurrent.speculator.speculate(0, ExtenderArgs(pod=pod, node_names=names)) is None
            assert h.schedule(pod, names) is not None
            snapshot = h.server.metrics.snapshot()
            assert _counted(snapshot, "concurrent.speculation.count", f"outcome={reason}") == 2, reason
        finally:
            h.close()


def test_solve_error_propagates_and_retires_the_ticket(monkeypatch):
    """A kernel's launch error in a speculation (here the plain solve
    raising a RuntimeError that is no annotation or shape error) leaves
    the request as it would a serial Filter: it is not declined to a
    quiet serial commit, and the ticket retires so the FIFO line moves."""
    h = _harness("tpu-batch", concurrent=True)
    try:
        pod, names = _speculation_scene(h, 2)

        def launch_failed(*a, **kw):
            raise RuntimeError("fifo_queue kernel launch failed with CUDA error 700")

        monkeypatch.setattr(fifo_solver, "fifo_queue", launch_failed)
        engine = h.server.concurrent
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            engine.predicate(ExtenderArgs(pod=pod, node_names=names))
        snapshot = h.server.metrics.snapshot()
        assert _counted(snapshot, "concurrent.speculation.count", "outcome=error") == 0
        assert _counted(snapshot, "concurrent.commit.result", "") == 0
        gate = engine.gate.stats()
        assert gate["head"] == gate["issued"] == 1 and gate["aborted"] == 1
        assert engine.speculator.inflight() == 0
        monkeypatch.undo()
        assert engine.predicate(ExtenderArgs(pod=pod, node_names=names)).node_names
    finally:
        h.close()


def test_threads_parsing_one_pod_version_share_one_demand(monkeypatch):
    """Threads that miss the demand cache for the same pod version at once
    all get the one AppDemand the cache keeps, so a speculation's queue
    identity holds at its commit."""
    from k8s_spark_scheduler_tpu_torch.scheduler import sparkpods

    parse = sparkpods.spark_resources

    def slow_parse(pod):
        time.sleep(0.05)  # every thread misses before any stores
        return parse(pod)

    monkeypatch.setattr(sparkpods, "spark_resources", slow_parse)
    pod = Harness.static_allocation_spark_pods("shared-demand", 2)[0]
    pod.meta.uid, pod.meta.resource_version = "uid-shared-demand", 7
    barrier = threading.Barrier(8)
    got = [None] * 8

    def demand(i):
        barrier.wait()
        got[i] = sparkpods.spark_app_demand_cached(pod)[1]

    threads = [threading.Thread(target=demand, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len({id(d) for d in got}) == 1
    assert sparkpods.spark_app_demand_cached(pod)[1] is got[0]


def test_speculation_span_is_the_critical_path_speculate_segment():
    """The span the speculator opens carries the name the critical-path
    decomposition maps to its ``speculate`` segment."""
    h = _harness("tpu-batch", concurrent=True)
    try:
        pod, names = _speculation_scene(h, 0)
        assert h.schedule(pod, names).node_names
        spans = [t["root"]["name"] for t in h.server.tracer.traces(limit=10)]
        assert "speculation.solve" in spans
        assert criticalpath.SPAN_SEGMENTS["speculation.solve"] == "speculate"
    finally:
        h.close()


# -- the race detectors and the declarations ------------------------------------


def test_eight_threads_run_clean_under_the_detector(monkeypatch):
    """The 8-thread property case under the port's lockset and
    happens-before detectors: 0 races, 0 lock-order cycles."""
    assert not jax_racecheck.active()
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    h = None
    try:
        h = _harness("tpu-batch-minimal-fragmentation", concurrent=True)
        assert racecheck.active()
        flat, node_names = _build_cluster(h, 37)
        _fan_out(h, flat, node_names, 8)
        h.wait_quiesced()
    finally:
        if h is not None:
            h.close()
        detector = racecheck.disable()
    assert detector is not None
    assert detector.races == [] and detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], "\n".join(detector.report_lines())
    instrumented = {name.split("#")[0] for name in detector._instances.values()}
    assert {"CommitGate", "Speculator", "ConcurrentAdmissionEngine"} <= instrumented


def test_concurrent_classes_declare_the_reference_guards():
    import k8s_spark_scheduler_tpu.concurrent  # noqa: F401 - registers the reference's classes

    ours = {cls.__name__: decl for cls, decl in port_guarded.registry().items()
            if cls.__module__.startswith("k8s_spark_scheduler_tpu_torch.concurrent.")}
    theirs = {cls.__name__: decl for cls, decl in jax_guarded.registry().items()
              if cls.__module__.startswith("k8s_spark_scheduler_tpu.concurrent.")}
    assert set(ours) == set(theirs) == {"CommitGate", "Speculator", "ConcurrentAdmissionEngine"}
    assert ours["CommitGate"] == theirs["CommitGate"]
    assert ours["ConcurrentAdmissionEngine"] == theirs["ConcurrentAdmissionEngine"]
    assert ours["Speculator"] == theirs["Speculator"]


# -- HTTP ----------------------------------------------------------------------------


def test_http_predicates_route_through_the_engine():
    """``/predicates`` on a server with ``concurrent`` on goes through the
    engine: the gate counts the request and the speculation's span lies
    in the request's trace, as its ``speculate`` segment."""
    import json
    import urllib.request

    from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
    from k8s_spark_scheduler_tpu_torch.types import serde

    api = APIServer()
    scheduler = init_server_with_clients(
        api, Install.from_dict({"fifo": True, "binpack": "tpu-batch", "concurrent": {"enabled": True}}),
        start_background=False, device="cpu",
    )
    http = ExtenderHTTPServer(scheduler, port=0, host="127.0.0.1")
    http.start()
    try:
        harness_pods = Harness.static_allocation_spark_pods
        from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
        from k8s_spark_scheduler_tpu_torch.types.resources import ZONE_LABEL, Resources

        names = ["n0", "n1"]
        for name in names:
            api.create(Node(meta=ObjectMeta(name=name, labels={ZONE_LABEL: "z1",
                            "resource_channel": "batch-medium-priority"}),
                            allocatable=Resources.of("8", "8Gi", "0")))
        pod = harness_pods("app-http", 2)[0]
        api.create(pod)
        body = json.dumps({"Pod": serde.pod_to_dict(api.get("Pod", pod.namespace, pod.name)),
                           "NodeNames": names}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{http.port}/predicates", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            result = json.loads(resp.read())
        assert result["NodeNames"], result
        assert scheduler.concurrent.gate.stats()["committed"] == 1
        assert scheduler.concurrent.stats()["commit_results"] == {"seq-hit": 1}
        # the request's root span closes after the response is sent
        for _ in range(400):
            if scheduler.criticalpath.recent(1):
                break
            time.sleep(0.025)
        record = scheduler.criticalpath.recent(1)[0]
        assert record["segments"]["speculate"] > 0, record
    finally:
        http.stop()
        scheduler.stop()
