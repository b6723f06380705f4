"""The port's tensor mirror (state/tensor_snapshot.py) and its driver-lane
tensor build (ops/fast_path.py) held against the JAX package's: random
node, pod, reservation and soft-reservation mutation sequences go through
both servers (tests/test_tensor_snapshot.py's pattern, on the twin of
tests/torch_parity.py), and after every few steps the two snapshots'
arrays must be equal, and so must ``build_cluster_tensor``'s
ClusterTensor fields and zones and ``executor_reschedule_order``'s
output — with and without label priorities and required node
affinity."""

import random

import numpy as np
import pytest

from k8s_spark_scheduler_tpu.ops import fast_path as jax_fast_path
from k8s_spark_scheduler_tpu.ops.nodesort import LabelPriorityOrder as JaxLPO
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.ops import fast_path as port_fast_path
from k8s_spark_scheduler_tpu_torch.ops.nodesort import LabelPriorityOrder as PortLPO
from k8s_spark_scheduler_tpu_torch.ops.tensorize import ClusterTensor
from torch_parity import Twin

SNAPSHOT_FIELDS = (
    "allocatable", "usage", "overhead", "zone_id", "ready", "unschedulable",
    "res_entries", "name_rank",
)
POOLS = ("reserved", "spot", "other")


def assert_snapshots_equal(jsnap, psnap):
    assert psnap.names == jsnap.names
    assert psnap.zone_names == jsnap.zone_names
    assert psnap.labels == jsnap.labels
    assert psnap.exact == jsnap.exact
    for field in SNAPSHOT_FIELDS:
        a, b = getattr(psnap, field), getattr(jsnap, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(psnap.avail, jsnap.avail)


def _affinity_pod_wire(twin, rng):
    """A driver wire dict with one of the affinity shapes the lane
    handles: the single In-constraint (vectorised), a general
    matchExpressions term (NotIn / Exists), or a nodeSelector."""
    pods = twin.static_pods("probe", 1)
    wire = pods[0]
    spec = dict(wire["spec"])
    shape = rng.randrange(4)
    if shape == 1:
        spec["affinity"] = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [
                {"key": "pool", "operator": "NotIn", "values": ["spot"]},
                {"key": "resource_channel", "operator": "In", "values": ["batch-medium-priority"]},
            ]}]}}}
    elif shape == 2:
        spec["affinity"] = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [
                {"matchExpressions": [{"key": "pool", "operator": "Exists", "values": []}]},
                {"matchExpressions": [{"key": "pool", "operator": "In", "values": ["other"]}]},
            ]}}}
    elif shape == 3:
        spec["nodeSelector"] = {"pool": rng.choice(POOLS)}
    return dict(wire, spec=spec)


def assert_tensor_builds_equal(twin, rng):
    jsnap = twin.jax.server.tensor_snapshot.snapshot()
    psnap = twin.port.server.tensor_snapshot.snapshot()
    assert_snapshots_equal(jsnap, psnap)
    names = list(psnap.names)
    for _ in range(3):
        candidates = [n for n in names if rng.random() < 0.8]
        wire = _affinity_pod_wire(twin, rng)
        prio = rng.random()
        jd = pd = je = pe = None
        if prio < 0.4:
            values = rng.sample(POOLS, 2)
            jd, pd = JaxLPO("pool", values), PortLPO("pool", values)
        if 0.2 < prio < 0.7:
            values = rng.sample(POOLS, 2)
            je, pe = JaxLPO("pool", values), PortLPO("pool", values)
        jbuilt = jax_fast_path.build_cluster_tensor(
            jsnap, jax_serde.pod_from_dict(dict(wire)), candidates, jd, je
        )
        pbuilt = port_fast_path.build_cluster_tensor(
            psnap, object_from_wire(wire), candidates, pd, pe
        )
        assert (jbuilt is None) == (pbuilt is None)
        if pbuilt is None:
            continue
        (jc, jzones), (pc, pzones) = jbuilt, pbuilt
        assert isinstance(pc, ClusterTensor)
        assert pzones == jzones
        assert pc.node_names == jc.node_names
        assert pc.zone_names == jc.zone_names and pc.exact == jc.exact
        for field in ("avail", "sched", "driver_rank", "exec_ok", "zone_id", "valid"):
            a, b = getattr(pc, field), getattr(jc, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)

        zone = rng.choice([None] + list(psnap.zone_names))
        jr = jax_fast_path.executor_reschedule_order(jsnap, candidates, je, zone)
        pr = port_fast_path.executor_reschedule_order(psnap, candidates, pe, zone)
        assert pr[0] == jr[0]
        for a, b in zip(pr[1:], jr[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_mirror_and_tensor_build_track_random_mutations(seed):
    rng = random.Random(4242 + seed)
    twin = Twin("tpu-batch")
    try:
        nodes = []
        for i in range(rng.randint(5, 10)):
            twin.add_node(
                f"n{i:02d}", cpu=str(rng.randint(4, 16)), memory=f"{rng.randint(4, 32)}Gi",
                zone=f"zone{rng.randint(0, 2)}", labels={"pool": rng.choice(POOLS)},
                unschedulable=rng.random() < 0.1, ready=rng.random() > 0.1,
            )
            nodes.append(f"n{i:02d}")
        live, overhead = [], 0
        for step in range(24):
            action = rng.random()
            if action < 0.4 or not live:
                app_id = f"app-{step}"
                pods = (
                    twin.dynamic_pods(app_id, 1, rng.randint(2, 4))
                    if rng.random() < 0.4
                    else twin.static_pods(app_id, rng.randint(1, 3))
                )
                if twin.schedule(pods[0], nodes) is not None:
                    live.append([pods[0]] + [p for p in pods[1:] if twin.schedule(p, nodes)])
            elif action < 0.55:
                twin.overhead_pod(f"sys-{overhead}", rng.choice(nodes), cpu=str(rng.randint(0, 2)))
                overhead += 1
            elif action < 0.7:
                app = rng.choice(live)
                if len(app) > 1:
                    twin.delete_pod(app.pop(rng.randrange(1, len(app))))
            elif action < 0.8 and len(nodes) > 3:
                # a node leaves with whatever it carries, and may come back
                gone = nodes.pop(rng.randrange(len(nodes)))
                twin.delete_node(gone)
                if rng.random() < 0.5:
                    twin.add_node(gone, cpu="12", memory="24Gi", zone="zone1",
                                  labels={"pool": rng.choice(POOLS)})
                    nodes.append(gone)
            else:
                for p in live.pop(rng.randrange(len(live))):
                    twin.delete_pod(p)
            if step % 6 == 5:
                twin.assert_state_equal()
                assert_tensor_builds_equal(twin, rng)
        twin.assert_state_equal()
        assert_tensor_builds_equal(twin, rng)
    finally:
        twin.close()


def test_inexact_node_poisons_both_mirrors():
    """A quantity with no exact base-unit row (a sub-milli CPU) makes both
    snapshots inexact, so both lanes decline the same way."""
    twin = Twin("tpu-batch")
    try:
        twin.add_node("n0")
        twin.add_node("odd", cpu="1001u")
        jsnap = twin.jax.server.tensor_snapshot.snapshot()
        psnap = twin.port.server.tensor_snapshot.snapshot()
        assert psnap.exact is jsnap.exact is False
        wire = twin.static_pods("probe", 1)[0]
        assert port_fast_path.build_cluster_tensor(psnap, object_from_wire(wire), ["n0"]) is None
        assert jax_fast_path.build_cluster_tensor(
            jsnap, jax_serde.pod_from_dict(dict(wire)), ["n0"]
        ) is None
    finally:
        twin.close()
