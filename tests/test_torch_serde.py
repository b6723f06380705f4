"""The port's wire serde (types/serde.py) and ``convert.object_from_wire``
held against the JAX package's: objects built from random seeds round-trip
through the port, and the port's encoding of each equals the JAX
package's encoding of the same object — Pods (affinity shapes, init
containers, conditions, terminated containers), Nodes,
ResourceReservations v1beta2 and Demands v1alpha2; ExtenderArgs decode
and ExtenderFilterResult encode byte for byte; the node-names interner."""

import json
import random

import pytest

from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu.types.extenderapi import ExtenderFilterResult as JaxResult
from k8s_spark_scheduler_tpu.types.objects import (
    Container,
    Demand,
    DemandSpec,
    DemandStatus,
    DemandUnit,
    Node,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodCondition,
    Reservation,
    ResourceReservation,
    ResourceReservationSpec,
    ResourceReservationStatus,
)
from k8s_spark_scheduler_tpu.types.resources import ZONE_LABEL, Resources
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.types import serde as port_serde
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderFilterResult as PortResult

T = 1_700_000_000.0


def _meta(rng, name):
    return ObjectMeta(
        name=name,
        namespace=rng.choice(["default", "spark"]),
        labels={"spark-app-id": f"app-{rng.randrange(9)}", ZONE_LABEL: f"z{rng.randrange(3)}"},
        annotations={"spark-driver-cpu": str(rng.randint(1, 4))} if rng.random() < 0.5 else {},
        creation_timestamp=T + rng.randrange(1000),
        resource_version=rng.randrange(100),
        uid=f"uid-{rng.randrange(10**6)}",
        owner_references=[OwnerReference(kind="Pod", name="owner", uid="u-1")] if rng.random() < 0.3 else [],
    )


def _quantity(rng):
    return rng.choice(["1", "500m", "2.5", "1Gi", "1500Mi", "3", "0", "7k"])


def _pod(rng, i):
    affinity = rng.randrange(3)
    return Pod(
        meta=_meta(rng, f"pod-{i}"),
        scheduler_name=rng.choice(["spark-scheduler", "default-scheduler"]),
        node_name=rng.choice(["", "n1"]),
        node_selector={"pool": "spot"} if rng.random() < 0.3 else {},
        node_affinity={"resource_channel": ["batch"]} if affinity == 1 else {},
        affinity_terms=(
            [[("pool", "NotIn", ["spot"]), ("resource_channel", "In", ["a", "b"])], [("gpu", "Exists", [])]]
            if affinity == 2
            else []
        ),
        containers=[Container(requests=Resources.of(_quantity(rng), _quantity(rng)))],
        init_containers=[Container(requests=Resources.of("2", "1Gi"))] if rng.random() < 0.3 else [],
        phase=rng.choice(["Pending", "Running", "Succeeded"]),
        container_terminated=[rng.random() < 0.5] if rng.random() < 0.5 else [],
        conditions=(
            {"PodScheduled": PodCondition(type="PodScheduled", status="False",
                                          reason="Unschedulable", message="m",
                                          transition_time=T + 5)}
            if rng.random() < 0.4
            else {}
        ),
    )


def _node(rng, i):
    return Node(
        meta=_meta(rng, f"n{i}"),
        allocatable=Resources.of(_quantity(rng), _quantity(rng), rng.choice(["0", "1", "8"])),
        unschedulable=rng.random() < 0.2,
        ready=rng.random() > 0.2,
    )


def _rr(rng, i):
    res = {
        name: Reservation.for_resources(f"n{rng.randrange(4)}", Resources.of(_quantity(rng), _quantity(rng)))
        for name in ["driver"] + [f"executor-{k}" for k in range(1, rng.randint(1, 4))]
    }
    return ResourceReservation(
        meta=_meta(rng, f"app-{i}"),
        spec=ResourceReservationSpec(reservations=res),
        status=ResourceReservationStatus(pods={"driver": f"app-{i}-driver"}),
    )


def _demand(rng, i):
    return Demand(
        meta=_meta(rng, f"demand-{i}"),
        spec=DemandSpec(
            units=[
                DemandUnit(resources=Resources.of(_quantity(rng), _quantity(rng)), count=rng.randint(1, 5),
                           pod_names_by_namespace={"default": [f"p{i}"]})
            ],
            instance_group="batch",
            is_long_lived=rng.random() < 0.5,
            enforce_single_zone_scheduling=rng.random() < 0.5,
            zone=rng.choice([None, "z1"]),
        ),
        status=DemandStatus(phase=rng.choice(["", "pending", "fulfilled"]), last_transition_time=T,
                            fulfilled_zone=rng.choice([None, "z0"])),
    )


CASES = {
    "Pod": (_pod, jax_serde.pod_to_dict, port_serde.pod_to_dict),
    "Node": (_node, jax_serde.node_to_dict, port_serde.node_to_dict),
    "ResourceReservation": (_rr, jax_serde.rr_to_dict_v1beta2, port_serde.rr_to_dict_v1beta2),
    "Demand": (_demand, jax_serde.demand_to_dict_v1alpha2, port_serde.demand_to_dict_v1alpha2),
}


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("seed", range(3))
def test_round_trip_and_encoding_equal_the_reference(kind, seed):
    make, jax_encode, port_encode = CASES[kind]
    rng = random.Random(seed * 97 + len(kind))
    for i in range(12):
        wire = jax_encode(make(rng, i))
        obj = object_from_wire(json.loads(json.dumps(wire)), kind=kind)
        assert type(obj).__name__ == kind
        assert port_encode(obj) == wire
        # and decoding the port's encoding gives the same object again
        assert port_encode(object_from_wire(port_encode(obj), kind=kind)) == wire


def test_object_from_wire_dispatches_on_kind():
    rng = random.Random(3)
    assert type(object_from_wire(jax_serde.node_to_dict(_node(rng, 0)))).__name__ == "Node"
    assert type(object_from_wire(jax_serde.pod_to_dict(_pod(rng, 0)))).__name__ == "Pod"
    with pytest.raises(ValueError):
        object_from_wire({"kind": "ConfigMap"})


def test_extender_args_and_filter_result_equal_the_reference():
    rng = random.Random(11)
    names = [f"n{i}" for i in range(50)]
    for i in range(6):
        body = {"Pod": jax_serde.pod_to_dict(_pod(rng, i)), "NodeNames": names[: rng.randint(0, 50)]}
        jargs = jax_serde.extender_args_from_dict(body)
        pargs = port_serde.extender_args_from_dict(body)
        assert list(pargs.node_names) == list(jargs.node_names)
        assert port_serde.pod_to_dict(pargs.pod) == jax_serde.pod_to_dict(jargs.pod)
        assert isinstance(pargs.node_names, tuple)  # interned
        assert port_serde.extender_args_from_dict(body).node_names is pargs.node_names

        message = f"does not fit {i}"
        jres = JaxResult(failed_nodes={n: message for n in jargs.node_names},
                         uniform_failure=(jargs.node_names, message))
        pres = PortResult(failed_nodes={n: message for n in pargs.node_names},
                          uniform_failure=(pargs.node_names, message))
        assert port_serde.encode_extender_filter_result(pres) == jax_serde.encode_extender_filter_result(jres)
        ok = PortResult(node_names=["n3"])
        assert port_serde.encode_extender_filter_result(ok) == jax_serde.encode_extender_filter_result(
            JaxResult(node_names=["n3"])
        )
        # the reusable buffer is exact: the same pair encodes to the same bytes
        assert port_serde.encode_extender_filter_result(pres) is port_serde.encode_extender_filter_result(pres)


def test_names_interner_is_bounded_and_exact():
    interner = port_serde.NodeNamesInterner()
    base = [f"n{i}" for i in range(10)]
    first = interner.intern(list(base))
    assert interner.intern(list(base)) is first
    # same fingerprint (len, first, last, middle), different interior
    other = list(base)
    other[1] = "x"
    assert interner.intern(other) == tuple(other) and interner.intern(other) is not first
    for k in range(40):
        interner.intern([f"m{k}-{i}" for i in range(5)])
    assert interner.size() <= interner.MAX_ENTRIES * interner.MAX_PER_BUCKET
