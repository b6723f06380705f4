"""The concurrent admission engine and the HA fabric through the port's
simulator (tests/test_sim_concurrent.py), held to the reference:

- the reference test's chaos dict (``tpu-batch``, two leader crashes'
  worth of faults, a lease partition, a node kill) gives the reference's
  digest, which equals the serial extender's: digest equality is
  decision equality;
- zero I-H violations, a takeover at a higher epoch, speculations that
  engaged and survived revalidation;
- the race detectors report nothing with the engine's guarded state
  instrumented.

``examples/sim/failover.json`` and ``concurrent.json`` are held to the
reference up to the first ``leader_crash``'s clearing event.  There the
reference's re-elected replica may ack a diverted create without writing
it (ROADMAP C.5, fixed in the port's ``recover_from_journal``): the
reference then loses reservations (J1), waits out its 30 s quiesce
timeout at every later event, and its digest differs between runs of one
process (in a fresh process the loss came at the second crash's clearing
event, in later runs at the first).  The port's run is clean to its end
and equal, with and without the engine."""

import pytest

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.sim import Scenario as JaxScenario
from k8s_spark_scheduler_tpu.sim import Simulation as JaxSimulation
from k8s_spark_scheduler_tpu.sim.runner import SIM_EPOCH
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
from torch_sim_parity import assert_same_log, example, parity, run_port


def concurrent_dict():
    """tests/test_sim_concurrent.py's ``_concurrent_dict``."""
    return {
        "name": "concurrent-chaos", "seed": 7, "duration": 420, "retry_interval": 15, "fifo": True,
        "binpack_algo": "tpu-batch",
        "cluster": {"nodes": 6, "cpu": "16", "memory": "32Gi", "zones": ["zone1", "zone2"]},
        "workload": {"process": "poisson", "rate_per_min": 3, "executors": {"min": 1, "max": 6},
                     "dynamic_fraction": 0.3, "lifetime": {"min": 120, "max": 300}},
        "ha": {"lease-duration-seconds": 30, "renew-interval-seconds": 15, "identity": "replica-a"},
        "concurrent": {"speculation": True, "max-inflight-speculations": 8, "multi-active": True},
        "faults": [
            {"at": 120, "kind": "leader_crash", "duration": 45},
            {"at": 250, "kind": "lease_partition", "duration": 60},
            {"at": 330, "kind": "node_kill", "count": 1},
        ],
    }


def serial_dict():
    d = concurrent_dict()
    del d["concurrent"]
    return d


def test_concurrent_chaos_matches_the_reference_with_zero_ih_violations():
    sim, result, _ = parity(concurrent_dict())
    s = result.summary
    assert s["decisions"] > 0 and s["apps"]["arrived"] > 0
    ha = sim.harness.server.ha
    assert ha is not None and ha.fence.epoch() >= 2, "no takeover at a higher epoch"
    assert s["ha"]["epoch"] == ha.fence.epoch()
    engine = sim.harness.server.concurrent
    stats = engine.stats()
    assert sum(stats["commit_results"].values()) > 0
    assert stats["gate"]["committed"] == sum(stats["commit_results"].values())
    counters = sim.harness.server.metrics.snapshot()["counters"]
    solved = sum(v for k, v in counters.items()
                 if mnames.CONCURRENT_SPECULATION_COUNT in k and "outcome=solved" in k)
    assert solved > 0, "speculation never engaged under tpu-batch"
    hits = stats["commit_results"].get("seq-hit", 0) + stats["commit_results"].get("memcmp-hit", 0)
    assert hits > 0, f"no speculative verdict survived revalidation: {stats['commit_results']}"


def test_concurrent_decisions_equal_the_serial_extender_and_reproduce():
    _, engine_on = run_port(concurrent_dict())
    _, serial = parity(serial_dict())[1:]
    assert engine_on.violations == [] and serial.violations == []
    assert_same_log(engine_on.event_log, serial.event_log)
    assert engine_on.digest == serial.digest
    _, again = run_port(concurrent_dict())
    assert again.digest == engine_on.digest


def test_concurrent_chaos_runs_clean_under_the_race_detectors(monkeypatch):
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    try:
        _, result = run_port(concurrent_dict())
    finally:
        detector = racecheck.disable()
    assert result.violations == []
    assert detector is not None, "the sim runner never enabled the detector"
    tracked = {name.split("#")[0] for name in detector._instances.values()}
    assert {"CommitGate", "Speculator", "ConcurrentAdmissionEngine", "FenceState", "LeaderElector"} <= tracked
    assert detector.races == [], "\n".join(detector.report_lines())
    assert detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], "\n".join(detector.report_lines())
    assert detector.clean()


def _reference_until(spec: dict, stop: float) -> list:
    """The reference's event log of ``spec`` for the events before
    ``stop`` virtual seconds (its own loop, cut there: no final drain)."""
    sim = JaxSimulation(JaxScenario.from_dict(spec))
    jax_timesource.set_source(sim.clock.now)
    jax_timesource.set_perf_source(sim.clock.now)
    try:
        sim._build()
        sim._seed_events()
        while True:
            nxt = sim.clock.peek_time()
            if nxt is None or nxt >= SIM_EPOCH + stop:
                break
            sim.clock.run_next()
    finally:
        try:
            sim.harness.api.set_write_fault(None)
            sim.harness.close()
        finally:
            jax_timesource.reset()
    assert sim.auditor.violations == [], sim.auditor.violations[:5]
    return sim._log


@pytest.mark.parametrize("name", ["failover", "concurrent"])
def test_ha_examples_match_the_reference_until_the_first_takeover(name):
    spec = example(name)
    crash = next(f for f in spec["faults"] if f["kind"] == "leader_crash")
    clear = crash["at"] + crash["duration"] + 1.0  # the crash's clearing event
    sim, ours = run_port(spec)
    theirs = _reference_until(spec, clear)
    assert ours.violations == [], ours.violations[:5]
    assert any(e["event"] == "fault:leader_crash" for e in theirs)
    assert_same_log(ours.event_log[: len(theirs)], theirs)
    assert ours.event_log[len(theirs)]["event"] == "fault-clear:leader_crash"
    # the port re-elects after each crash and loses no diverted write
    assert sim.harness.server.ha.fence.epoch() >= 3
    assert ours.summary["ha"]["fence"]["staleCommits"] == 0
    assert sim.harness.server.resilience.journal.depth() == 0


def test_failover_and_concurrent_examples_agree_in_the_port():
    """The two examples differ only by the concurrent block: the engine's
    run is the serial run, decision for decision."""
    _, failover = run_port(example("failover"))
    _, concurrent = run_port(example("concurrent"))
    assert failover.violations == [] and concurrent.violations == []
    assert_same_log(concurrent.event_log, failover.event_log)


def test_concurrent_example_scenario_parses():
    from k8s_spark_scheduler_tpu_torch.sim import Scenario

    sc = Scenario.from_dict(example("concurrent"))
    assert sc.concurrent and sc.concurrent.get("speculation") is True
    assert sc.ha
    kinds = [f.kind for f in sc.faults]
    assert kinds.count("leader_crash") >= 2 and "lease_partition" in kinds
    assert sc.binpack_algo == "tpu-batch"
