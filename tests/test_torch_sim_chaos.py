"""Chaos through the port's simulator, held to the reference's
(tests/test_sim_chaos.py, case for case where the figures are
deterministic): ``examples/sim/chaos.json`` under tightly-pack,
``tpu-batch`` and ``tpu-batch-minimal-fragmentation``, ``degraded.json``
and the degraded-mode chaos dict are digest-equal to the reference's; the
journal drains and the run re-converges; the delta-solve engine's session
state stays bounded; the race detectors report nothing.

``kernel_fault`` is the one deliberate difference: the reference demotes
the faulted lane to its host path (``resilience/lanehealth.py``, which
has no port), the port's Filter answers an error.  Under tightly-pack
no device lane meets the fault in the port (the reference's demoted
executor lane serves the same decisions), so the digests stay equal;
under ``tpu-batch`` the log equals the reference's up to the fault's
instant, the Filters inside the window record ``error`` and the refused
drivers are granted after it.  The reference's wall-clock budget
(``test_degraded_decision_latency_stays_bounded``) becomes a check of
the latency summary's shape."""

import pytest

from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.ops import fifo_session
from k8s_spark_scheduler_tpu_torch.ops import registry as ops_registry
from torch_sim_parity import (
    assert_same_log,
    example,
    first_difference,
    parity,
    run_port,
    run_reference,
)

TENSOR_POLICIES = ("tpu-batch", "tpu-batch-minimal-fragmentation")


def chaos_dict(binpack_algo="tightly-pack", faults=True):
    """tests/test_sim_chaos.py's ``_chaos_dict``."""
    d = {
        "name": "degraded-smoke", "seed": 23, "duration": 300, "retry_interval": 15, "fifo": True,
        "binpack_algo": binpack_algo,
        "cluster": {"nodes": 4, "cpu": "16", "memory": "32Gi", "zones": ["zone1", "zone2"]},
        "workload": {"process": "burst", "burst_interval": 60, "burst_size": 2, "executors": {"min": 1, "max": 4},
                     "dynamic_fraction": 0.9, "lifetime": {"min": 60, "max": 150}},
        "autoscaler": {"enabled": True, "delay": 20, "max_nodes": 8},
        "faults": [
            {"at": 55, "kind": "apiserver_outage", "duration": 60},
            {"at": 50, "kind": "kernel_fault", "duration": 130},
            {"at": 170, "kind": "apiserver_latency", "duration": 40},
            {"at": 230, "kind": "executor_storm", "apps": 1, "fraction": 0.5},
        ],
    }
    if not faults:
        d["faults"] = []
    return d


@pytest.mark.parametrize("binpack_algo", ["tightly-pack", *TENSOR_POLICIES])
def test_chaos_example_matches_the_reference(binpack_algo):
    _, result, _ = parity(example("chaos", binpack_algo=binpack_algo))
    kinds = {e["event"] for e in result.event_log}
    assert {"fault:node_kill", "fault:failover", "fault:executor_storm", "fault:node_cordon"} <= kinds


def test_degraded_example_matches_the_reference():
    """tightly-pack: the port's kernel_fault meets no device lane."""
    _, result, _ = parity(example("degraded"))
    assert "error" not in {d["outcome"] for e in result.event_log for d in e["decisions"]}


def test_degraded_chaos_dict_matches_the_reference_and_reproduces():
    _, result, _ = parity(chaos_dict())
    s = result.summary
    assert s["invariant_violations"] == 0 and s["apps"]["arrived"] > 0 and s["decisions"] > 0
    outage = [e for e in result.event_log if 60 <= e["t"] < 120 and e["decisions"]]
    assert outage, "no scheduling activity during the outage window"
    _, again = run_port(chaos_dict())
    assert again.digest == result.digest and again.violations == []


@pytest.mark.parametrize("binpack_algo", TENSOR_POLICIES)
def test_fault_free_chaos_dict_matches_the_reference(binpack_algo):
    parity(chaos_dict(binpack_algo, faults=False))


def test_kernel_fault_under_tpu_batch_answers_error_inside_its_window_only():
    spec = chaos_dict("tpu-batch")
    fault = next(f for f in spec["faults"] if f["kind"] == "kernel_fault")
    start, end = fault["at"], fault["at"] + fault["duration"]
    sim, ours = run_port(spec)
    _, theirs = run_reference(spec)
    assert ours.violations == [] and theirs.violations == []
    # equal up to the fault's instant
    before = [e for e in theirs.event_log if e["t"] < start]
    assert before and ours.event_log[: len(before)] == before
    assert first_difference(ours.event_log, theirs.event_log)[0] >= len(before)
    # inside the window every driver Filter answers error, and only there
    errors = [(e["t"], d["pod"]) for e in ours.event_log for d in e["decisions"] if d["outcome"] == "error"]
    assert errors, "the kernel fault met no Filter"
    assert all(start <= t < end for t, _ in errors), errors
    drivers = {d["pod"] for e in ours.event_log if start <= e["t"] < end
               for d in e["decisions"] if d["role"] == "driver"}
    assert drivers == {pod for _, pod in errors}
    # the drivers refused in the window are granted after it
    granted = {d["pod"] for e in ours.event_log if e["t"] >= end for d in e["decisions"]
               if d["outcome"] == "success"}
    assert {pod for _, pod in errors} <= granted
    # the reference served those Filters on its host path: no error there
    assert "error" not in {d["outcome"] for e in theirs.event_log for d in e["decisions"]}
    assert ops_registry._kernel_fault_hook is None  # disarmed at teardown
    assert sim.harness.server.extender.delta_engine.stats()["cold_solves"] > 0


def test_a_fault_that_is_not_injected_ends_the_run(monkeypatch):
    """The simulator hides no real fault: a queue pass that raises a plain
    RuntimeError (a failed launch) propagates out of ``run``."""

    def failed_launch(*args, **kwargs):
        raise RuntimeError("queue kernel launch failed")

    monkeypatch.setattr(fifo_session, "fifo_queue", failed_launch)
    with pytest.raises(RuntimeError, match="queue kernel launch failed"):
        # smoke.json under tpu-batch queues drivers: the session launches
        run_port(example("smoke", binpack_algo="tpu-batch"))
    assert ops_registry._kernel_fault_hook is None


def test_chaos_recovery_drains_journal_and_reconverges():
    sim, result = run_port(chaos_dict())
    assert result.violations == []
    kit = sim.harness.server.resilience
    assert kit.journal.depth() == 0
    assert kit.breaker.state == "closed"
    counters = sim.harness.server.metrics.snapshot()["counters"]
    appended = sum(v for k, v in counters.items() if "resilience.journal.appended" in k)
    replayed = sum(v for k, v in counters.items() if "resilience.journal.replayed" in k)
    assert appended > 0, "the outage never diverted a write to the journal"
    assert replayed > 0, "recovery never replayed a journaled intent"
    # no lane to demote: no counter names a demoted or fallback lane
    assert not [k for k in counters if "lane.demotion" in k or "fallback" in k]


def test_degraded_decision_latency_summary_has_its_shape():
    """The reference bounds the chaos run's p99 by the fault-free run's
    on the host clock; here the latency summary is checked for presence
    and shape only."""
    _, chaos = run_port(chaos_dict())
    _, clean = run_port(chaos_dict(faults=False))
    for result in (chaos, clean):
        lat = result.summary["decision_latency_ms"]
        assert set(lat) == {"p50", "p95", "p99", "max"}
        assert all(isinstance(v, float) and v >= 0.0 for v in lat.values())
        assert lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
        assert result.summary["decisions"] > 0
        assert result.summary["decisions_per_sec_wall"] > 0


def test_chaos_with_delta_engine_runs_clean_and_bounded():
    """tpu-batch chaos with the kernel fault: the delta-solve engine's
    device sessions stay at its LRU cap and within a session's roof at
    this node scale; provenance and the capacity timeline stay bounded."""
    sim, result = run_port(chaos_dict("tpu-batch"))
    assert result.violations == [] and result.summary["decisions"] > 0
    tracker = sim.harness.server.provenance
    pstats = tracker.stats()
    assert pstats["ring"]["size"] <= pstats["ring"]["capacity"]
    assert pstats["recorder"]["size"] <= pstats["recorder"]["capacity"]
    capsum = result.summary["capacity"]
    assert capsum is not None and capsum["samples"] > 0 and capsum["lock_violations"] == 0
    assert result.capacity_timeline
    assert len(result.capacity_timeline) <= sim.harness.server.capacity.stats()["ring_capacity"]
    assert 0.0 <= capsum["fragmentation_max_dim"]["max"] <= 1.0
    engine = sim.harness.server.extender.delta_engine
    stats = engine.stats()
    assert stats["cold_solves"] + stats["warm_hits"] + sum(stats["misses"].values()) > 0
    assert 0 < stats["sessions"] <= engine.MAX_SESSIONS
    max_nodes = 4096 + 16  # the scenario's cluster and autoscaler cap, under the bucket
    assert stats["session_bytes"] <= engine.MAX_SESSIONS * (30 * max_nodes * 12 + 2**21)


@pytest.mark.parametrize("binpack_algo", ["tightly-pack", "tpu-batch"])
def test_chaos_runs_clean_under_the_race_detectors(monkeypatch, binpack_algo):
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    try:
        _, result = run_port(chaos_dict(binpack_algo))
    finally:
        detector = racecheck.disable()
    assert result.violations == []
    assert detector is not None, "the sim runner never enabled the detector"
    tracked = {name.split("#")[0] for name in detector._instances.values()}
    expected = {"CapacitySampler", "TensorSnapshotCache", "Informer", "MetricsRegistry", "ProvenanceRing",
                "FlightRecorder", "ProvenanceTracker"}
    if binpack_algo == "tpu-batch":
        expected |= {"ChangeFeed", "DeltaSolveEngine"}
    assert expected <= tracked, sorted(expected - tracked)
    assert detector.races == [], "\n".join(detector.report_lines())
    assert detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], "\n".join(detector.report_lines())
    assert detector.clean()


def test_kernel_fault_hook_semantics():
    """The port's hook raises KernelFault (a RuntimeError) at a lane's
    entry; disarmed it costs nothing and raises nothing."""
    ops_registry.check_kernel_fault("tensor_driver")
    ops_registry.set_kernel_fault_hook(lambda lane: ops_registry.KernelFault(f"injected ({lane})"))
    try:
        with pytest.raises(ops_registry.KernelFault, match=r"injected \(device_fifo\)"):
            ops_registry.check_kernel_fault("device_fifo")
    finally:
        ops_registry.set_kernel_fault_hook(None)
    assert issubclass(ops_registry.KernelFault, RuntimeError)
    ops_registry.check_kernel_fault("device_fifo")


def test_logs_name_their_first_difference():
    log = [{"seq": 0, "t": 1.0}, {"seq": 1, "t": 2.0}]
    assert first_difference(log, list(log)) is None
    assert first_difference(log, log[:1])[0] == 1
    with pytest.raises(AssertionError, match="event 1 differs"):
        assert_same_log(log, [log[0], {"seq": 1, "t": 3.0}])


def test_a_write_in_progress_counts_as_in_flight():
    """The sim's quiesce waits on ``inflight_queue_lengths``: a Demand
    write a worker has taken off the queue but not yet made must still
    count, or the event's fingerprint and the autoscaler's pumps can read
    the API before the write lands (the reference counts queued requests
    only, and its property seed 101 drifted under load)."""
    import threading

    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    h = Harness(device="cpu")
    entered, release = threading.Event(), threading.Event()

    def slow_demand_write(op, kind, ns, name):
        if kind == "Demand" and op == "create":
            entered.set()
            release.wait(10)
        return None

    try:
        h.new_node("n1", cpu="2", memory="4Gi")
        h.api.set_write_fault(slow_demand_write)
        driver = h.static_allocation_spark_pods("too-big", 4, executor_cpu="4")[0]
        h.assert_failure(h.schedule(driver, ["n1"]))
        assert entered.wait(10), "no demand write started"
        assert any(h.server.demand_cache.inflight_queue_lengths())
        assert not h.api.list("Demand")
        release.set()
        assert h.wait_for_api(lambda: not any(h.server.demand_cache.inflight_queue_lengths()), timeout=10)
        assert [d.name for d in h.api.list("Demand")] == ["demand-too-big-driver"]
    finally:
        release.set()
        h.api.set_write_fault(None)
        h.close()
