"""The port's ``types/resources`` builders held against the JAX package's on
random node sets: ``group_add``, ``group_sub``, ``usage_for_nodes``,
``available_for_nodes`` and ``node_scheduling_metadata_for_nodes`` (the
extender's metadata lane needs them).  Objects cross over as wire dicts;
results are compared as exact quantity strings."""

import random

import pytest

from k8s_spark_scheduler_tpu.types import resources as jr
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu.types.objects import (
    Node,
    ObjectMeta,
    Reservation,
    ResourceReservation,
    ResourceReservationSpec,
)
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.types import resources as pr

QUANTITIES = ["0", "1", "250m", "1.5", "3", "7", "1Gi", "512Mi", "3Gi", "2.5Gi", "12"]


def _plain(group):
    return {name: r.to_dict() for name, r in group.items()}


def _random_case(rng):
    nodes = [
        Node(
            meta=ObjectMeta(
                name=f"n{i}",
                labels={jr.ZONE_LABEL: f"z{rng.randrange(3)}"} if rng.random() < 0.8 else {"pool": "x"},
                creation_timestamp=1000.0 + i,
            ),
            allocatable=jr.Resources.of(rng.choice(QUANTITIES[3:]), rng.choice(QUANTITIES[6:]), rng.choice(["0", "2"])),
            unschedulable=rng.random() < 0.2,
            ready=rng.random() > 0.2,
        )
        for i in range(rng.randint(1, 12))
    ]
    rrs = [
        ResourceReservation(
            meta=ObjectMeta(name=f"app-{k}"),
            spec=ResourceReservationSpec(
                reservations={
                    f"r{j}": Reservation.for_resources(
                        # some reservations point at nodes outside the set
                        f"n{rng.randrange(14)}",
                        jr.Resources.of(rng.choice(QUANTITIES), rng.choice(QUANTITIES)),
                    )
                    for j in range(rng.randint(1, 4))
                }
            ),
        )
        for k in range(rng.randint(0, 6))
    ]
    overhead = {
        f"n{rng.randrange(14)}": jr.Resources.of(rng.choice(QUANTITIES), rng.choice(QUANTITIES))
        for _ in range(rng.randint(0, 5))
    }
    return nodes, rrs, overhead


def _port(objs, encode):
    return [object_from_wire(encode(o)) for o in objs]


def _port_group(group):
    return {name: pr.Resources.from_dict(r.to_dict()) for name, r in group.items()}


@pytest.mark.parametrize("seed", range(6))
def test_builders_equal_the_reference(seed):
    rng = random.Random(seed)
    nodes, rrs, overhead = _random_case(rng)
    pnodes = _port(nodes, jax_serde.node_to_dict)
    prrs = _port(rrs, jax_serde.rr_to_dict_v1beta2)

    jusage, pusage = jr.usage_for_nodes(rrs), pr.usage_for_nodes(prrs)
    assert _plain(pusage) == _plain(jusage)

    for fn in ("group_add", "group_sub"):
        a, b = dict(jusage), _port_group(jusage)
        getattr(jr, fn)(a, overhead)
        getattr(pr, fn)(b, _port_group(overhead))
        assert _plain(b) == _plain(a), fn

    assert _plain(pr.available_for_nodes(pnodes, pusage)) == _plain(jr.available_for_nodes(nodes, jusage))

    jmeta = jr.node_scheduling_metadata_for_nodes(nodes, jusage, overhead)
    pmeta = pr.node_scheduling_metadata_for_nodes(pnodes, pusage, _port_group(overhead))
    assert list(pmeta) == list(jmeta)
    for name, jm in jmeta.items():
        pm = pmeta[name]
        assert pm.available.to_dict() == jm.available.to_dict()
        assert pm.schedulable.to_dict() == jm.schedulable.to_dict()
        assert (pm.creation_timestamp, pm.zone_label, dict(pm.all_labels), pm.unschedulable, pm.ready) == (
            jm.creation_timestamp, jm.zone_label, dict(jm.all_labels), jm.unschedulable, jm.ready
        )
