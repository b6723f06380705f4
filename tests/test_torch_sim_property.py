"""tests/test_sim_property.py's seeded random scenarios through the
port's simulator, each held to the reference's run of the same dict:
equal event logs and digests, no violation on either side, every fault
executed — under the scenario's own binpack policy (tightly-pack) and
under the two tensor-lane policies, ``tpu-batch`` and
``tpu-batch-minimal-fragmentation``."""

import random

import pytest

from torch_sim_parity import parity, run_port

SEEDS = [101, 202, 303, 404, 505]


def _random_scenario(seed: int) -> dict:
    """tests/test_sim_property.py's ``_random_scenario``, draw for draw."""
    rng = random.Random(seed)
    duration = rng.choice([150, 200, 250])
    process = rng.choice(["poisson", "burst"])
    workload = {
        "process": process,
        "executors": {"min": 1, "max": rng.choice([3, 5])},
        "dynamic_fraction": rng.choice([0.0, 0.3, 0.6]),
        "lifetime": {"min": 40, "max": 120},
    }
    if process == "poisson":
        workload["rate_per_min"] = rng.choice([2, 4])
    else:
        workload["burst_interval"] = rng.choice([50, 80])
        workload["burst_size"] = rng.choice([2, 3])
    fault_menu = [
        {"kind": "node_kill", "count": 1},
        {"kind": "node_cordon", "count": 1},
        {"kind": "executor_storm", "apps": 1, "fraction": 0.5},
        {"kind": "failover"},
    ]
    faults = []
    for fault in rng.sample(fault_menu, rng.randint(1, 3)):
        faults.append(dict(fault, at=rng.randint(30, int(duration * 0.7))))
    return {
        "name": f"prop-{seed}",
        "seed": seed,
        "duration": duration,
        "retry_interval": 15,
        "fifo": rng.choice([True, True, False]),
        "cluster": {
            "nodes": rng.randint(3, 5),
            "cpu": rng.choice(["8", "16"]),
            "memory": "16Gi",
            "zones": rng.choice([["zone1"], ["zone1", "zone2"]]),
        },
        "workload": workload,
        "autoscaler": {
            "enabled": rng.random() < 0.5,
            "delay": rng.choice([0, 25]),
            "max_nodes": rng.choice([4, 8]),
        },
        "faults": faults,
    }


@pytest.mark.parametrize("binpack_algo", [None, "tpu-batch", "tpu-batch-minimal-fragmentation"])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_scenario_matches_the_reference(seed, binpack_algo):
    spec = _random_scenario(seed)
    if binpack_algo is not None:
        spec["binpack_algo"] = binpack_algo
    _, result, _ = parity(spec)
    fault_events = [e for e in result.event_log if e["event"].startswith("fault:")]
    assert len(fault_events) == len(spec["faults"])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_random_scenario_digest_is_stable(seed):
    _, first = run_port(_random_scenario(seed))
    _, again = run_port(_random_scenario(seed))
    assert first.violations == [] and again.violations == []
    assert first.digest == again.digest
