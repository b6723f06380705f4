"""The port's simulator building blocks against the reference's
(tests/test_sim.py and tests/test_scenario_validation.py, case for case):
the virtual clock's event order, same-instant order and past-clamping;
seeded workloads (``AppSpec`` lists as ``to_dict``) for seeds 0-9 under
each arrival process; trace round-trips across the two packages;
scenario parsing and the validation messages on bad dicts; the
timesource's span-duration hook; run manifests; and the fake
autoscaler's knobs the runner relies on."""

import json
import os
import time

import pytest

from k8s_spark_scheduler_tpu.sim import clock as jax_clock
from k8s_spark_scheduler_tpu.sim import manifest as jax_manifest
from k8s_spark_scheduler_tpu.sim import scenario as jax_scenario
from k8s_spark_scheduler_tpu.sim import workload as jax_workload
from k8s_spark_scheduler_tpu_torch import timesource
from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
from k8s_spark_scheduler_tpu_torch.kube.informer import InformerFactory
from k8s_spark_scheduler_tpu_torch.sim import manifest
from k8s_spark_scheduler_tpu_torch.sim.clock import VirtualClock
from k8s_spark_scheduler_tpu_torch.sim.scenario import FAULT_KINDS, Scenario, ScenarioError
from k8s_spark_scheduler_tpu_torch.sim.workload import AppSpec, WorkloadGenerator, dump_trace, load_trace
from k8s_spark_scheduler_tpu_torch.testing.fake_autoscaler import FakeAutoscaler
from k8s_spark_scheduler_tpu_torch.types.objects import Demand, DemandSpec, DemandUnit, ObjectMeta
from k8s_spark_scheduler_tpu_torch.types.resources import Resources

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "sim")
CLOCKS = [VirtualClock, jax_clock.VirtualClock]


# -- clock --------------------------------------------------------------------


def _fire(clock_cls, start, schedule):
    """Run `schedule(clock, fired)` on a fresh clock and drain it."""
    clock = clock_cls(start=start)
    fired = []
    schedule(clock, fired)
    popped = []
    while True:
        out = clock.run_next()
        if out is None:
            break
        popped.append(out)
    return fired, popped, clock.now()


def _mixed(clock, fired):
    clock.schedule(130.0, "c", lambda: fired.append(("c", clock.now())))
    clock.schedule(110.0, "a", lambda: fired.append(("a", clock.now())))
    clock.schedule_in(15.0, "b", lambda: fired.append(("b", clock.now())))
    # a callback that schedules a follow-up at its own instant and one in the past
    clock.schedule(120.0, "d", lambda: (
        fired.append(("d", clock.now())),
        clock.schedule(120.0, "d-same", lambda: fired.append(("d-same", clock.now()))),
        clock.schedule(5.0, "d-past", lambda: fired.append(("d-past", clock.now()))),
    ))


def _same_instant(clock, fired):
    for i in range(5):
        clock.schedule(10.0, f"e{i}", lambda i=i: fired.append(i))


def _past(clock, fired):
    clock.schedule(10.0, "late", lambda: fired.append(("late", clock.now())))
    clock.schedule(50.0, "now", lambda: fired.append(("now", clock.now())))


@pytest.mark.parametrize("schedule, start", [(_mixed, 100.0), (_same_instant, 0.0), (_past, 50.0)])
def test_clock_matches_the_reference(schedule, start):
    ours = _fire(VirtualClock, start, schedule)
    theirs = _fire(jax_clock.VirtualClock, start, schedule)
    assert ours == theirs


@pytest.mark.parametrize("clock_cls", CLOCKS)
def test_virtual_clock_orders_events_and_advances_time(clock_cls):
    fired, popped, now = _fire(clock_cls, 100.0, _mixed)
    assert [f[0] for f in fired] == ["a", "b", "d", "d-same", "d-past", "c"]
    assert fired[4] == ("d-past", 120.0)  # scheduled in the past: clamped to now
    assert now == 130.0 and popped[-1] == (130.0, "c")


def test_virtual_clock_same_instant_fires_in_scheduling_order():
    fired, _, _ = _fire(VirtualClock, 0.0, _same_instant)
    assert fired == [0, 1, 2, 3, 4]


def test_virtual_clock_peek_pending_and_advance():
    clock = VirtualClock(start=5.0)
    assert clock.peek_time() is None and clock.pending() == 0 and clock.run_next() is None
    clock.schedule(9.0, "x", lambda: None)
    clock.schedule_in(1.0, "y", lambda: None)
    assert clock.peek_time() == 6.0 and clock.pending() == 2
    clock.advance_to(7.5)
    clock.advance_to(3.0)  # never backwards
    assert clock.now() == 7.5
    assert clock.run_next() == (6.0, "y") and clock.now() == 7.5


def test_timesource_perf_source_install_and_reset():
    clock = VirtualClock(start=777.0)
    timesource.set_source(clock.now)
    timesource.set_perf_source(clock.now)
    try:
        assert timesource.now() == 777.0 and timesource.perf() == 777.0
        assert timesource.is_virtual()
    finally:
        timesource.reset()
    assert not timesource.is_virtual()
    assert abs(timesource.now() - time.time()) < 1.0
    assert timesource.perf() != 777.0


# -- workload -----------------------------------------------------------------

PROCESSES = {
    "poisson": {"process": "poisson", "rate_per_min": 6, "dynamic_fraction": 0.5},
    "burst": {"process": "burst", "burst_interval": 100.0, "burst_size": 3, "burst_offset": 5.0,
              "executors": {"min": 2, "max": 9}, "dynamic_fraction": 0.3},
    "diurnal": {"process": "diurnal", "rate_per_min": 1, "peak_rate_per_min": 30, "period": 600,
                "lifetime": {"min": 10, "max": 20}},
    "policy-shaped": {"process": "poisson", "rate_per_min": 4, "band_weights": {"high": 1, "low": 3},
                      "tenants": ["t1", "t2", "t3"], "instance_group": "ig-x"},
}


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("process", sorted(PROCESSES))
def test_workload_matches_the_reference(process, seed):
    spec = PROCESSES[process]
    ours = [a.to_dict() for a in WorkloadGenerator(spec, seed).generate(600.0)]
    theirs = [a.to_dict() for a in jax_workload.WorkloadGenerator(spec, seed).generate(600.0)]
    assert ours == theirs
    assert ours, f"{process} seed {seed} generated nothing"


def test_workload_burst_process_shape():
    spec = {"process": "burst", "burst_interval": 100.0, "burst_size": 3, "burst_offset": 5.0}
    apps = WorkloadGenerator(spec, seed=0).generate(250.0)
    assert [a.arrival for a in apps] == [5.0, 5.0, 5.0, 105.0, 105.0, 105.0, 205.0, 205.0, 205.0]


def test_workload_unknown_process_message_matches_the_reference():
    with pytest.raises(ValueError) as ours:
        WorkloadGenerator({"process": "fractal"}, seed=0).generate(10.0)
    with pytest.raises(ValueError) as theirs:
        jax_workload.WorkloadGenerator({"process": "fractal"}, seed=0).generate(10.0)
    assert str(ours.value) == str(theirs.value) == "unknown arrival process 'fractal'"


def test_workload_trace_roundtrip_across_packages(tmp_path):
    apps = WorkloadGenerator({"process": "poisson", "rate_per_min": 4}, seed=9).generate(300.0)
    ours_path, theirs_path = str(tmp_path / "ours.jsonl"), str(tmp_path / "theirs.jsonl")
    dump_trace(apps, ours_path)
    jax_workload.dump_trace(jax_workload.WorkloadGenerator({"process": "poisson", "rate_per_min": 4},
                                                           seed=9).generate(300.0), theirs_path)
    with open(ours_path) as a, open(theirs_path) as b:
        assert a.read() == b.read()
    loaded = load_trace(theirs_path)
    assert [a.to_dict() for a in loaded] == [a.to_dict() for a in apps]
    assert [a.to_dict() for a in jax_workload.load_trace(ours_path)] == [a.to_dict() for a in apps]
    # a scenario workload that names a trace replays it verbatim
    replayed = WorkloadGenerator({"trace": ours_path}, seed=999).generate(300.0)
    assert [a.to_dict() for a in replayed] == [a.to_dict() for a in apps]
    assert AppSpec.from_dict(apps[0].to_dict()) == apps[0]


# -- scenario -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(n[:-5] for n in os.listdir(EXAMPLES) if n.endswith(".json")))
def test_example_scenarios_parse_like_the_reference(name):
    path = os.path.join(EXAMPLES, f"{name}.json")
    ours, theirs = Scenario.from_file(path), jax_scenario.Scenario.from_file(path)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.duration > 0
    again = Scenario.from_dict(json.loads(json.dumps(ours.to_dict())))
    assert again.to_dict() == ours.to_dict()


def test_scenario_defaults_and_fault_order_match_the_reference():
    d = {"name": "t", "seed": 5, "duration": 60, "cluster": {"nodes": 2, "cpu": "8"},
         "faults": [{"at": 30, "kind": "failover"}, {"at": 10, "kind": "node_kill", "count": 1},
                    {"at": 10, "kind": "kernel_fault"}]}
    ours = Scenario.from_dict(d)
    assert ours.to_dict() == jax_scenario.Scenario.from_dict(d).to_dict()
    assert [f.kind for f in ours.faults] == ["kernel_fault", "node_kill", "failover"]
    assert Scenario().to_dict() == jax_scenario.Scenario().to_dict()
    assert FAULT_KINDS == jax_scenario.FAULT_KINDS


def _base():
    return {
        "name": "v", "seed": 1, "duration": 300,
        "cluster": {"nodes": 4, "cpu": "16", "memory": "32Gi"},
        "workload": {"process": "poisson", "rate_per_min": 2, "executors": {"min": 1, "max": 4},
                     "lifetime": {"min": 60, "max": 120}},
        "faults": [{"at": 100, "kind": "node_kill", "count": 1}],
    }


BAD = [
    lambda d: d.update(workloads=d.pop("workload")),
    lambda d: d.update(duration="long"),
    lambda d: d.update(seed=-1),
    lambda d: d["cluster"].update(cpus="16"),
    lambda d: d.update(cluster=["n1"]),
    lambda d: d["cluster"].update(nodes="four"),
    lambda d: d.update(autoscaler={"lag": 30}),
    lambda d: d["workload"].update(arrival={"rate_per_min": 2}),
    lambda d: d["workload"].update(process="weibull"),
    lambda d: d["workload"].update(executors={"lo": 1}),
    lambda d: d["workload"].update(executors={"min": 4, "max": 1}),
    lambda d: d["workload"].update(executors={"min": 0}),
    lambda d: d["workload"].update(lifetime={"min": "60"}),
    lambda d: d["workload"].update(dynamic_fraction=1.5),
    lambda d: d["workload"].update(dynamic_fraction=True),
    lambda d: d["workload"].update(trace=42),
    lambda d: d.update(workload=[1]),
    lambda d: d.update(faults={"at": 1}),
    lambda d: d.update(faults=["node_kill"]),
    lambda d: d.update(faults=[{"at": 1, "kind": "meteor_strike"}]),
    lambda d: d.update(faults=[{"at": 1}]),
    lambda d: d.update(faults=[{"kind": "failover"}]),
    lambda d: d.update(faults=[{"at": 1, "kind": "failover"}, {"at": -5, "kind": "node_kill"}]),
    lambda d: d.update(faults=[{"at": 1, "kind": "node_kill", "nodes": 2}]),
    lambda d: d.update(policy=["priority"]),
    lambda d: d.update(ha=True),
    lambda d: d.update(concurrent="on"),
    lambda d: d.update(classes=0),
]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_validation_messages_match_the_reference(case):
    ours_d, theirs_d = _base(), _base()
    BAD[case](ours_d)
    BAD[case](theirs_d)
    with pytest.raises(ScenarioError) as ours:
        Scenario.from_dict(ours_d)
    with pytest.raises(jax_scenario.ScenarioError) as theirs:
        jax_scenario.Scenario.from_dict(theirs_d)
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith("scenario")


def test_non_dict_scenario_and_fault_spec_messages():
    with pytest.raises(ScenarioError, match="scenario: expected an object, got list"):
        Scenario.from_dict([])
    from k8s_spark_scheduler_tpu_torch.sim.scenario import FaultSpec

    with pytest.raises(ValueError) as ours:
        FaultSpec(at=1, kind="meteor")
    with pytest.raises(ValueError) as theirs:
        jax_scenario.FaultSpec(at=1, kind="meteor")
    assert str(ours.value) == str(theirs.value)


# -- manifest -----------------------------------------------------------------


def test_run_manifest_matches_the_reference(tmp_path):
    for name, body in (("events.jsonl", b'{"seq":0}\n'), ("summary.json", b"{}\n")):
        (tmp_path / name).write_bytes(body)
    (tmp_path / "bundles").mkdir()
    kwargs = dict(kind="sim-run", seed=5, digests={"scenario": "b", "events": "a"}, extra={"scenario": "s"})
    ours = manifest.build_run_manifest(str(tmp_path), **kwargs)
    assert ours == jax_manifest.build_run_manifest(str(tmp_path), **kwargs)
    written = manifest.write_run_manifest(str(tmp_path), **kwargs)
    assert written == ours
    # the manifest never hashes itself
    assert manifest.build_run_manifest(str(tmp_path), **kwargs) == ours
    assert [a["name"] for a in ours["artifacts"]] == ["events.jsonl", "summary.json"]


# -- fake autoscaler knobs ----------------------------------------------------


def _demand_env():
    api = APIServer()
    factory = InformerFactory(api)
    informer = factory.informer(Demand.KIND)
    factory.start()
    return api, informer


def _demand(name: str, cpu: str, count: int) -> Demand:
    return Demand(
        meta=ObjectMeta(name=name),
        spec=DemandSpec(instance_group="ig", units=[DemandUnit(resources=Resources.of(cpu, "1Gi"), count=count)]),
    )


def test_autoscaler_fulfillment_delay():
    api, informer = _demand_env()
    scaler = FakeAutoscaler(api, informer, fulfillment_delay=30.0)
    t0 = time.time()
    api.create(_demand("demand-slow", "4", 2))
    assert [p.name for p in scaler.pending] == ["demand-slow"]
    assert scaler.due_times() and scaler.fulfilled == []
    assert scaler.process_due(t0 + 10.0) == 0
    assert scaler.process_due(t0 + 31.0) == 1
    assert scaler.fulfilled == ["demand-slow"] and scaler.pending == []
    assert [n.name for n in api.list("Node")] == ["scaled-1"]
    assert api.get(Demand.KIND, "default", "demand-slow").status.phase == "fulfilled"


def test_autoscaler_max_nodes_cap_and_per_instance_names():
    api, informer = _demand_env()
    scaler = FakeAutoscaler(api, informer, max_nodes=1, deferred=True)
    api.create(_demand("demand-big", "10", 3))
    api.create(_demand("demand-small", "2", 1))
    assert scaler.process_due(time.time() + 1.0) == 1
    assert scaler.capped == ["demand-big"] and scaler.fulfilled == ["demand-small"]
    assert scaler.created_nodes == 1 and [p.name for p in scaler.pending] == ["demand-big"]
    # a second scaler on its own cluster starts at scaled-1 again
    api2, informer2 = _demand_env()
    FakeAutoscaler(api2, informer2)
    api2.create(_demand("demand-x", "4", 1))
    assert [n.name for n in api2.list("Node")] == ["scaled-1"]
