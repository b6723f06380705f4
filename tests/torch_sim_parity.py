"""Helpers for the simulator parity tests: run one scenario dict through
the reference's ``Simulation`` and the port's (``device="cpu"``), and
hold the two results to each other."""

import collections
import json
import os

from k8s_spark_scheduler_tpu.sim import Scenario as JaxScenario
from k8s_spark_scheduler_tpu.sim import Simulation as JaxSimulation
from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "sim")

# summary fields both packages compute from the same decisions and state
SUMMARY_FIELDS = ("events_logged", "events_audited", "decisions", "apps", "queue_depth",
                  "packing_efficiency", "nodes", "invariant_violations", "digest", "waste_phases")


def example(name: str, **overrides) -> dict:
    """An ``examples/sim`` scenario as a dict, top-level keys overridden."""
    with open(os.path.join(EXAMPLES, f"{name}.json")) as f:
        d = json.load(f)
    d.update(overrides)
    return d


def run_port(spec: dict, **kwargs):
    sim = Simulation(Scenario.from_dict(spec), device="cpu", **kwargs)
    return sim, sim.run()


def run_reference(spec: dict):
    sim = JaxSimulation(JaxScenario.from_dict(spec))
    return sim, sim.run()


def first_difference(ours: list, theirs: list):
    """(index, our entry, their entry) of the first differing event-log
    entry, or None when the logs are equal."""
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if a != b:
            return i, a, b
    if len(ours) != len(theirs):
        i = min(len(ours), len(theirs))
        return i, ours[i] if i < len(ours) else None, theirs[i] if i < len(theirs) else None
    return None


def assert_same_log(ours: list, theirs: list) -> None:
    diff = first_difference(ours, theirs)
    assert diff is None, f"event {diff[0]} differs:\n port:      {diff[1]}\n reference: {diff[2]}"


def outcome_counts(log: list) -> dict:
    return dict(collections.Counter((d["role"], d["outcome"]) for e in log for d in e["decisions"]))


def assert_same_run(ours, theirs) -> None:
    """Equal event logs (so equal digests), no violation on either side,
    and equal decision and outcome counts in the summaries."""
    assert ours.violations == [], ours.violations[:5]
    assert theirs.violations == [], theirs.violations[:5]
    assert_same_log(ours.event_log, theirs.event_log)
    assert ours.digest == theirs.digest
    for key in SUMMARY_FIELDS:
        assert ours.summary[key] == theirs.summary[key], key
    assert outcome_counts(ours.event_log) == outcome_counts(theirs.event_log)


def parity(spec: dict):
    """Run ``spec`` on both sides and hold them equal; returns (port
    simulation, port result, reference result)."""
    sim, ours = run_port(spec)
    _, theirs = run_reference(spec)
    assert_same_run(ours, theirs)
    return sim, ours, theirs
