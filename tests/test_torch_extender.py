"""The port's extender, wiring and harness held against the JAX package's:
the same scenario driven through both servers (``tests/torch_parity.Twin``)
must give equal ExtenderFilterResults, reservations, demands and soft
reservations, under every policy family — the tensor lane (tpu-batch,
tpu-batch-distribute-evenly, tpu-batch-minimal-fragmentation), the
metadata lane with the single-AZ kernel (tpu-batch-single-az) and a host
policy (tightly-pack).  Sizes stay small: at most 12 nodes and a few
dozen pods a scenario."""

import random

import pytest

from torch_parity import Twin

POLICIES = (
    "tpu-batch",
    "tpu-batch-distribute-evenly",
    "tpu-batch-minimal-fragmentation",
    "tpu-batch-single-az",
    "tightly-pack",
)


@pytest.fixture
def twin_factory():
    made = []

    def make(*args, **kw):
        twin = Twin(*args, **kw)
        made.append(twin)
        return twin

    yield make
    for twin in made:
        twin.close()


def _nodes(twin, count=4, **kw):
    names = []
    for i in range(count):
        twin.add_node(f"n{i}", zone=f"zone{i % 2}", **kw)
        names.append(f"n{i}")
    return names


def _finish(twin, policy):
    twin.assert_state_equal()
    if policy == "tpu-batch":
        # the driver Filters went through the tensor lane, not the
        # Quantity path
        assert twin.port_fast_lane_count() > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_earlier_driver_blocks(twin_factory, policy):
    twin = twin_factory(policy)
    nodes = _nodes(twin, 2)
    # an older driver that can never fit is queued ahead (pending, never
    # Filtered): it blocks the younger one
    big = twin.static_pods("app-big", 40, age=100)
    twin.create_pod(big[0])
    small = twin.static_pods("app-small", 1, age=10)
    assert twin.schedule(small[0], nodes) is None
    # the blocked driver's own Filter fails on fit and creates a demand
    assert twin.schedule(big[0], nodes) is None
    # room for it: add nodes; the queue head still does not fit 40
    # executors, so the small app stays blocked
    for i in range(2, 4):
        twin.add_node(f"n{i}", zone="zone1")
    assert twin.schedule(small[0], nodes + ["n2", "n3"]) is None
    # the big app goes away: the small one is admitted
    twin.delete_pod(big[0])
    assert twin.schedule(small[0], nodes + ["n2", "n3"]) is not None
    for p in small[1:]:
        assert twin.schedule(p, nodes + ["n2", "n3"]) is not None
    _finish(twin, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_enforce_after_age_skip(twin_factory, policy):
    twin = twin_factory(policy, enforce_after_age=600)
    nodes = _nodes(twin, 2)
    # younger than the enforce-after age: skipped by the FIFO gate
    young = twin.static_pods("app-young", 40, age=60)
    twin.create_pod(young[0])
    a = twin.static_pods("app-a", 1, age=30)
    assert twin.schedule(a[0], nodes) is not None
    # the same driver, once older than the age, blocks
    twin.advance(700)
    b = twin.static_pods("app-b", 1)
    assert twin.schedule(b[0], nodes) is None
    _finish(twin, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_gang_too_large_creates_demand(twin_factory, policy):
    twin = twin_factory(policy)
    nodes = _nodes(twin, 2)
    pods = twin.static_pods("app-huge", 32, executor_cpu="2")
    assert twin.schedule(pods[0], nodes) is None
    twin.assert_state_equal()
    assert twin.port.api.list("Demand"), "a demand for the gang"
    # the cluster grows: the gang fits and its demand is deleted
    for i in range(2, 12):
        twin.add_node(f"n{i}", cpu="16", memory="16Gi", zone=f"zone{i % 2}")
    all_nodes = [f"n{i}" for i in range(12)]
    assert twin.schedule(pods[0], all_nodes) is not None
    _finish(twin, policy)
    assert not twin.port.api.list("Demand")


@pytest.mark.parametrize("policy", POLICIES)
def test_idempotent_driver_replay(twin_factory, policy):
    twin = twin_factory(policy)
    nodes = _nodes(twin)
    pods = twin.static_pods("app-1", 2)
    first = twin.schedule(pods[0], nodes)
    assert first is not None
    assert twin.replay(pods[0], nodes) == first
    # the reserved node is returned even when it is not a candidate
    assert twin.replay(pods[0], [n for n in nodes if n != first]) == first
    _finish(twin, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_bound_reservation_executor_replay(twin_factory, policy):
    twin = twin_factory(policy)
    nodes = _nodes(twin)
    pods = twin.static_pods("app-1", 2)
    assert twin.schedule(pods[0], nodes) is not None
    bound = [twin.schedule(p, nodes) for p in pods[1:]]
    assert all(bound)
    for p, node in zip(pods[1:], bound):
        assert twin.replay(p, nodes) == node
    # an executor beyond the reservation count is refused
    extra = twin.rename(pods[1], "app-1-exec-extra")
    assert twin.schedule(extra, nodes) is None
    _finish(twin, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_dynamic_allocation_soft_reservations(twin_factory, policy):
    twin = twin_factory(policy)
    nodes = _nodes(twin, 3)
    pods = twin.dynamic_pods("app-da", 1, 4)
    assert twin.schedule(pods[0], nodes) is not None
    for p in pods[1:]:
        assert twin.schedule(p, nodes) is not None
    twin.assert_state_equal()
    # the hard-reserved executor dies: compaction moves a soft one into
    # its reservation; a replacement takes the freed soft spot
    twin.delete_pod(pods[1])
    replacement = twin.rename(pods[1], "app-da-exec-replacement")
    twin.schedule(replacement, nodes)
    twin.delete_pod(pods[3])
    twin.schedule(twin.rename(pods[3], "app-da-exec-late"), nodes)
    _finish(twin, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_executor_reschedule_after_node_loss(twin_factory, policy):
    twin = twin_factory(policy)
    nodes = _nodes(twin, 4, cpu="4", memory="4Gi")
    twin.overhead_pod("sys-0", "n1", cpu="1", memory="1Gi")
    pods = twin.static_pods("app-1", 5)
    assert twin.schedule(pods[0], nodes) is not None
    placed = {p["metadata"]["name"]: twin.schedule(p, nodes) for p in pods[1:]}
    assert all(placed.values())
    # the node of one executor goes away with it; its replacement must
    # be rescheduled onto the remaining candidates
    victim = next(p for p in pods[1:] if placed[p["metadata"]["name"]] != placed[pods[1]["metadata"]["name"]]) \
        if len(set(placed.values())) > 1 else pods[1]
    lost = placed[victim["metadata"]["name"]]
    twin.delete_pod(victim)
    twin.delete_node(lost)
    remaining = [n for n in nodes if n != lost]
    twin.schedule(twin.rename(victim, victim["metadata"]["name"] + "-r"), remaining)
    _finish(twin, policy)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", POLICIES)
def test_random_filter_sequence(twin_factory, policy, seed):
    rng = random.Random(1000 * seed + len(policy))
    twin = twin_factory(policy)
    nodes = []
    for i in range(rng.randint(4, 8)):
        twin.add_node(
            f"n{i}",
            cpu=str(rng.randint(4, 16)),
            memory=f"{rng.randint(4, 32)}Gi",
            zone=f"zone{rng.randint(0, 2)}",
        )
        nodes.append(f"n{i}")
    live = []
    for step in range(14):
        action = rng.random()
        if action < 0.55 or not live:
            app_id = f"app-{step}"
            if rng.random() < 0.3:
                pods = twin.dynamic_pods(app_id, 1, rng.randint(2, 3), age=rng.randint(0, 50))
            else:
                pods = twin.static_pods(
                    app_id, rng.randint(1, 4), age=rng.randint(0, 50),
                    executor_cpu=str(rng.randint(1, 3)), executor_mem=f"{rng.randint(1, 4)}Gi",
                )
            if rng.random() < 0.2:
                twin.create_pod(pods[0])  # queued ahead, Filtered later
            if twin.schedule(pods[0], nodes) is not None:
                bound = [pods[0]]
                for p in pods[1:]:
                    if twin.schedule(p, nodes) is not None:
                        bound.append(p)
                live.append(bound)
        elif action < 0.75:
            app = rng.choice(live)
            if len(app) > 1:
                twin.delete_pod(app.pop(rng.randrange(1, len(app))))
        else:
            for p in live.pop(rng.randrange(len(live))):
                twin.delete_pod(p)
            twin.advance(rng.choice((1, 20)))  # 20 s re-arms reconciliation
    _finish(twin, policy)
