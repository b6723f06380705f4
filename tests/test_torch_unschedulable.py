"""The port's unschedulable-pod marker (scheduler/unschedulable.py): the
reference package's marker cases (tests/test_extender.py, from
unschedulablepods_test.go) on the port's harness, and the marker's
verdicts and pod conditions held equal to the JAX package's through
``tests/torch_parity.Twin`` on a backlog of pending drivers."""

import random
import time

import pytest

from k8s_spark_scheduler_tpu_torch.scheduler.unschedulable import POD_EXCEEDS_CLUSTER_CAPACITY
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from torch_parity import Twin

# a host policy (binpack_func verdicts) and a tensor policy (the
# solver's feasible_tensor verdicts)
HARNESS_POLICIES = ("tightly-pack", "tpu-batch")


@pytest.fixture(params=HARNESS_POLICIES)
def harness(request):
    h = Harness(binpack_algo=request.param, device="cpu")
    yield h
    h.close()


def two_node_cluster(h: Harness):
    h.new_node("n1")
    h.new_node("n2")
    return ["n1", "n2"]


def test_unschedulable_marker_flags_oversized_driver(harness):
    two_node_cluster(harness)
    driver = harness.static_allocation_spark_pods("app-huge", 100)[0]
    driver.meta.creation_timestamp = time.time() - 3600
    harness.create_pod(driver)
    harness.unschedulable_marker.scan_for_unschedulable_pods()
    fresh = harness.api.get("Pod", "default", driver.name)
    cond = fresh.conditions.get(POD_EXCEEDS_CLUSTER_CAPACITY)
    assert cond is not None and cond.status == "True"


def test_unschedulable_marker_gpu_exhaustion(harness):
    # nodes have 1 GPU each; an 8-GPU executor ask can never fit
    two_node_cluster(harness)
    driver = harness.static_allocation_spark_pods("app-gpu", 1, executor_gpu="8")[0]
    driver.meta.creation_timestamp = time.time() - 3600
    harness.create_pod(driver)
    assert harness.unschedulable_marker.does_pod_exceed_cluster_capacity(driver)


def test_unschedulable_marker_clears_when_fits(harness):
    two_node_cluster(harness)
    driver = harness.static_allocation_spark_pods("app-ok", 1)[0]
    driver.meta.creation_timestamp = time.time() - 3600
    harness.create_pod(driver)
    harness.unschedulable_marker.scan_for_unschedulable_pods()
    fresh = harness.api.get("Pod", "default", driver.name)
    cond = fresh.conditions.get(POD_EXCEEDS_CLUSTER_CAPACITY)
    assert cond is not None and cond.status == "False"


def test_unschedulable_scan_memoizes_per_affinity_group(harness):
    """The scan memoization must keep per-group verdicts separate: a
    gang that exceeds its own (small) instance group's capacity is
    flagged even when another group could fit it, and vice versa."""
    for i in range(2):
        harness.new_node(f"big-{i}", cpu="32", memory="64Gi", instance_group="big")
    harness.new_node("small-0", cpu="2", memory="4Gi", instance_group="small")

    old = time.time() - 3600
    fits_big = harness.static_allocation_spark_pods("app-big", 4, instance_group="big", creation_timestamp=old)[0]
    too_big_for_small = harness.static_allocation_spark_pods(
        "app-small", 4, instance_group="small", creation_timestamp=old
    )[0]
    harness.create_pod(fits_big)
    harness.create_pod(too_big_for_small)
    harness.unschedulable_marker.scan_for_unschedulable_pods()

    cond_big = harness.api.get("Pod", "default", fits_big.name).conditions.get(POD_EXCEEDS_CLUSTER_CAPACITY)
    cond_small = harness.api.get("Pod", "default", too_big_for_small.name).conditions.get(
        POD_EXCEEDS_CLUSTER_CAPACITY
    )
    assert cond_big is not None and cond_big.status == "False"
    assert cond_small is not None and cond_small.status == "True"


def test_young_driver_is_not_marked(harness):
    """Only drivers pending longer than the timeout (600 s) are scanned."""
    two_node_cluster(harness)
    driver = harness.static_allocation_spark_pods("app-young", 100)[0]
    driver.meta.creation_timestamp = time.time() - 10
    harness.create_pod(driver)
    harness.unschedulable_marker.scan_for_unschedulable_pods()
    assert POD_EXCEEDS_CLUSTER_CAPACITY not in harness.api.get("Pod", "default", driver.name).conditions


# -- parity with the JAX package's marker --------------------------------------

TWIN_POLICIES = (
    "tpu-batch",
    "tpu-batch-distribute-evenly",
    "tpu-batch-minimal-fragmentation",
    "tightly-pack",
    "tpu-batch-single-az",
)


def _conditions(h, names):
    out = {}
    for name in names:
        cond = h.api.get("Pod", "default", name).conditions.get(POD_EXCEEDS_CLUSTER_CAPACITY)
        out[name] = None if cond is None else (cond.status, cond.transition_time)
    return out


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("policy", TWIN_POLICIES)
def test_marker_verdicts_and_conditions_equal_the_reference(policy, seed):
    rng = random.Random(31 * seed + len(policy))
    twin = Twin(policy)
    try:
        nodes = []
        for i in range(rng.randint(3, 7)):
            twin.add_node(
                f"n{i}", cpu=str(rng.randint(2, 16)), memory=f"{rng.randint(4, 32)}Gi",
                zone=f"zone{rng.randint(0, 2)}",
            )
            nodes.append(f"n{i}")
        twin.overhead_pod("sys-0", "n0", cpu="1", memory="1Gi")
        # a running app holds capacity: the marker ignores usage
        running = twin.static_pods("app-running", 1, age=5000)
        if twin.schedule(running[0], nodes):
            twin.schedule(running[1], nodes)
        drivers = []
        for a in range(rng.randint(8, 16)):
            pods = twin.static_pods(
                f"app-{a}", rng.randint(1, 12), age=rng.choice((30, 900, 5000)),
                executor_cpu=str(rng.randint(1, 6)), executor_mem=f"{rng.randint(1, 8)}Gi",
                executor_gpu=str(rng.choice((0, 0, 1, 2))),
            )
            twin.create_pod(pods[0])
            drivers.append(pods[0]["metadata"]["name"])
        twin.settle()
        twin.jax.unschedulable_marker.scan_for_unschedulable_pods()
        twin.port.unschedulable_marker.scan_for_unschedulable_pods()
        conds = _conditions(twin.port, drivers)
        assert conds == _conditions(twin.jax, drivers)
        assert any(c is not None for c in conds.values()), "the backlog had old drivers"
        for name in drivers:
            jpod = twin.jax.api.get("Pod", "default", name)
            ppod = twin.port.api.get("Pod", "default", name)
            assert twin.port.unschedulable_marker.does_pod_exceed_cluster_capacity(
                ppod
            ) == twin.jax.unschedulable_marker.does_pod_exceed_cluster_capacity(jpod)
        # the cluster grows: a second scan clears what now fits, on both
        for i in range(len(nodes), len(nodes) + 4):
            twin.add_node(f"n{i}", cpu="64", memory="256Gi", gpu="8", zone=f"zone{i % 3}")
        twin.settle()
        twin.advance(60)
        twin.jax.unschedulable_marker.scan_for_unschedulable_pods()
        twin.port.unschedulable_marker.scan_for_unschedulable_pods()
        assert _conditions(twin.port, drivers) == _conditions(twin.jax, drivers)
        twin.assert_state_equal()
    finally:
        twin.close()
