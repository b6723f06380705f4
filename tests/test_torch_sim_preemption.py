"""Priority ordering and gang-aware preemption through the port's
simulator (tests/test_sim_preemption.py), held to the reference:
``examples/sim/preemption.json`` (a saturated 4-node cluster of
long-lived low-band apps, a ``priority_storm`` of high-band apps, a
``node_kill``) gives the reference's event log and digest, the same
eviction scorecard and per-band outcomes, with I-P1..I-P4 clean on both
sides; the storm without the policy block stays plain FIFO; the race
detectors report nothing with the policy engine's guarded state."""

from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from torch_sim_parity import example, parity, run_port

POLICY_FIELDS = ("ordering", "backfill", "preemption_enabled", "bands", "band_outcomes", "tenants", "evictions")


def test_priority_storm_matches_the_reference_via_gang_atomic_preemption():
    _, result, theirs = parity(example("preemption"))
    s = result.summary
    pol = s["policy"]
    for key in POLICY_FIELDS:
        assert pol[key] == theirs.summary["policy"][key], key
    assert pol["ordering"] == "priority-then-fifo" and pol["preemption_enabled"] is True
    assert pol["band_outcomes"]["high"]["success"] >= 1
    ev = pol["evictions"]
    assert ev["total"] >= 1 and ev["victims"] >= 1 and s["apps"]["evicted"] >= 1
    for entry in ev["scorecard"]:
        assert entry["band"] == "low"
        assert entry["reason"].startswith("preempted by storm-")
        assert entry["pods"] >= 1
    assert ev["journal_depth"] == 0
    assert ev["whatif"]["validated"] >= 1


def test_preemption_digest_is_reproducible():
    _, first = run_port(example("preemption"))
    _, again = run_port(example("preemption"))
    assert first.violations == [] and again.violations == []
    assert again.digest == first.digest


def test_preemption_runs_clean_under_the_race_detectors(monkeypatch):
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    try:
        _, result = run_port(example("preemption"))
    finally:
        detector = racecheck.disable()
    assert result.violations == []
    assert detector is not None and detector._instances
    tracked = {name.split("#")[0] for name in detector._instances.values()}
    assert {"PriorityLedger", "DrfAccountant", "PreemptionCoordinator"} <= tracked, tracked
    assert detector.races == [], "\n".join(detector.report_lines())
    assert detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], "\n".join(detector.report_lines())
    assert detector.clean()


def test_priority_storm_without_policy_stays_plain_fifo_like_the_reference():
    d = example("preemption")
    d.pop("policy")
    d["faults"] = [f for f in d["faults"] if f["kind"] == "priority_storm"]
    d["duration"] = 420.0
    _, result, _ = parity(d)
    assert "policy" not in result.summary
    assert result.summary["apps"]["evicted"] == 0
    assert [e for e in result.event_log if "storm-" in str(e)], "the storm never submitted its apps"
