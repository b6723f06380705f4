"""The JAX server on the JAX package's FakeKubeAPI and the port's server
(``device="cpu"``) on the port's FakeKubeAPI, both over their REST
backends, fed the same objects: their Filter results, and the
reservations and demands they write back over REST, must be equal.

The REST backend delivers watch events on background threads (as the
reference does), so each side is settled before every Filter and every
delete: its informers hold what its fake API holds, and its write-back
queues have drained into the fake.  Sizes stay small: at most 8 nodes
and a few dozen pods a scenario."""

import random
import time

import pytest

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.config import FifoConfig as JaxFifoConfig
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.kube.crd import DEMAND_CRD_NAME as JAX_DEMAND_CRD
from k8s_spark_scheduler_tpu.kube.crd import demand_crd_spec as jax_demand_crd_spec
from k8s_spark_scheduler_tpu.server.wiring import init_server_with_clients as jax_init
from k8s_spark_scheduler_tpu.testing.fake_kube_api import FakeKubeAPI as JaxFakeKubeAPI
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu.types.extenderapi import ExtenderArgs as JaxArgs
from k8s_spark_scheduler_tpu.types.objects import Node, ObjectMeta
from k8s_spark_scheduler_tpu.types.resources import ZONE_LABEL, Resources
from k8s_spark_scheduler_tpu_torch import timesource as port_timesource
from k8s_spark_scheduler_tpu_torch.config import FifoConfig as PortFifoConfig
from k8s_spark_scheduler_tpu_torch.config import Install as PortInstall
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME as PORT_DEMAND_CRD
from k8s_spark_scheduler_tpu_torch.kube.crd import demand_crd_spec as port_demand_crd_spec
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients as port_init
from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI as PortFakeKubeAPI
from k8s_spark_scheduler_tpu_torch.types import serde as port_serde
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs as PortArgs
from torch_parity import GROUP, IG_LABEL, T0, _strip_identity, jax_serde_decode, static_pod_wires

POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly", "tightly-pack")
WAIT_S = 10.0


def _wait(cond, timeout=WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class _Side:
    """One package's server on its own fake API, over REST."""

    def __init__(self, fake, server, decode, args_cls, rr_encode, demand_encode):
        self.fake, self.server = fake, server
        self.decode, self.args_cls = decode, args_cls
        self.rr_encode, self.demand_encode = rr_encode, demand_encode

    @property
    def api(self):
        return self.fake.api  # the cluster's own store, behind the HTTP fake

    def informers_synced(self) -> bool:
        for informer, kind in ((self.server.pod_informer, "Pod"), (self.server.node_informer, "Node")):
            ours = {(o.namespace, o.name): o.meta.resource_version for o in informer.list()}
            theirs = {(o.namespace, o.name): o.meta.resource_version for o in self.api.list(kind)}
            if ours != theirs:
                return False
        return True

    def write_back_settled(self) -> bool:
        def rr_content(rrs):
            return {
                (rr.namespace, rr.name): (
                    sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                    sorted(rr.status.pods.items()),
                )
                for rr in rrs
            }

        server = self.server
        return (
            not any(server.resource_reservation_cache.inflight_queue_lengths())
            and not any(server.demand_cache.inflight_queue_lengths())
            and rr_content(server.resource_reservation_cache.list())
            == rr_content(self.api.list("ResourceReservation"))
            and {(d.namespace, d.name) for d in self.api.list("Demand")}
            == {(d.namespace, d.name) for d in server.demand_cache.list()}
        )

    def settle(self) -> None:
        assert _wait(lambda: self.informers_synced() and self.write_back_settled())

    def reservations(self) -> dict:
        return {(o.namespace, o.name): _strip_identity(self.rr_encode(o))
                for o in self.api.list("ResourceReservation")}

    def demands(self) -> dict:
        return {(o.namespace, o.name): _strip_identity(self.demand_encode(o))
                for o in self.api.list("Demand")}


class RestTwin:
    def __init__(self, policy: str):
        self.now = T0
        jax_timesource.set_source(lambda: self.now)
        port_timesource.set_source(lambda: self.now)
        self.sides = []
        try:
            jfake = JaxFakeKubeAPI().start()
            jfake.api.create_crd(JAX_DEMAND_CRD, jax_demand_crd_spec())
            self._fakes = [jfake]
            jserver = jax_init(
                jfake.client_backend(),
                JaxInstall(
                    fifo=True,
                    fifo_config=JaxFifoConfig(),
                    binpack_algo=policy,
                    instance_group_label=IG_LABEL,
                    delta_solve=False,
                ),
                demand_poll_interval=0.02,
            )
            self.sides.append(_Side(jfake, jserver, jax_serde_decode, JaxArgs,
                                    jax_serde.rr_to_dict_v1beta2, jax_serde.demand_to_dict_v1alpha2))
            pfake = PortFakeKubeAPI().start()
            pfake.api.create_crd(PORT_DEMAND_CRD, port_demand_crd_spec())
            self._fakes.append(pfake)
            pserver = port_init(
                pfake.client_backend(),
                PortInstall(fifo=True, fifo_config=PortFifoConfig(), binpack_algo=policy,
                            instance_group_label=IG_LABEL),
                demand_poll_interval=0.02,
                device="cpu",
            )
            self.sides.append(_Side(pfake, pserver, object_from_wire, PortArgs,
                                    port_serde.rr_to_dict_v1beta2, port_serde.demand_to_dict_v1alpha2))
            for side in self.sides:
                assert side.server.lazy_demand_informer.wait_ready(WAIT_S)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        try:
            for side in self.sides:
                side.server.stop()
                side.server.api.stop()
            for fake in getattr(self, "_fakes", []):
                fake.stop()
        finally:
            jax_timesource.reset()
            port_timesource.reset()

    def settle(self) -> None:
        for side in self.sides:
            side.settle()

    def create(self, wire: dict) -> None:
        for side in self.sides:
            side.api.create(side.decode(wire))

    def add_node(self, name: str, cpu: str, memory: str, zone: str) -> None:
        node = Node(
            meta=ObjectMeta(name=name, labels={ZONE_LABEL: zone, IG_LABEL: GROUP},
                            creation_timestamp=self.now),
            allocatable=Resources.of(cpu, memory, "1"),
        )
        self.create(jax_serde.node_to_dict(node))

    def delete_pod(self, wire: dict) -> None:
        self.settle()
        for side in self.sides:
            side.api.delete("Pod", "default", wire["metadata"]["name"])

    def schedule(self, wire: dict, nodes):
        """Filter + bind on both sides; the results must be equal."""
        name = wire["metadata"]["name"]
        for side in self.sides:
            if side.server.pod_informer.get("default", name) is None:
                side.api.create(side.decode(wire))
        self.settle()
        results = []
        for side in self.sides:
            pod = side.server.pod_informer.get("default", name).deepcopy()
            result = side.server.extender.predicate(side.args_cls(pod=pod, node_names=list(nodes)))
            if result.node_names:
                # the bind is kube-scheduler's (pods/binding), done cluster-side
                bound = side.api.get("Pod", "default", name)
                bound.node_name = result.node_names[0]
                bound.phase = "Running"
                side.api.update(bound)
            results.append(result)
        jr, pr = results
        assert pr.to_dict() == jr.to_dict(), (pr.to_dict(), jr.to_dict())
        assert port_serde.encode_extender_filter_result(pr) == jax_serde.encode_extender_filter_result(jr)
        return pr.node_names[0] if pr.node_names else None

    def assert_state_equal(self) -> None:
        self.settle()
        jax_side, port_side = self.sides
        assert port_side.reservations() == jax_side.reservations()
        assert port_side.demands() == jax_side.demands()


@pytest.fixture
def rest_twin():
    made = []

    def make(policy):
        twin = RestTwin(policy)
        made.append(twin)
        return twin

    yield make
    for twin in made:
        twin.close()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("policy", POLICIES)
def test_rest_servers_agree_on_a_random_sequence(rest_twin, policy, seed):
    rng = random.Random(7000 + 100 * seed + len(policy))
    twin = rest_twin(policy)
    nodes = []
    for i in range(rng.randint(4, 8)):
        twin.add_node(f"n{i}", str(rng.randint(4, 16)), f"{rng.randint(4, 32)}Gi", f"zone{rng.randint(0, 2)}")
        nodes.append(f"n{i}")
    live = []
    for step in range(10):
        if rng.random() < 0.6 or not live:
            pods = static_pod_wires(
                f"app-{step}", rng.randint(1, 4), T0 - rng.randint(0, 50),
                executor_cpu=str(rng.randint(1, 3)), executor_mem=f"{rng.randint(1, 4)}Gi",
            )
            if twin.schedule(pods[0], nodes) is not None:
                bound = [pods[0]]
                for p in pods[1:]:
                    if twin.schedule(p, nodes) is not None:
                        bound.append(p)
                live.append(bound)
        else:
            for p in live.pop(rng.randrange(len(live))):
                twin.delete_pod(p)
    twin.assert_state_equal()
    port_rrs = twin.sides[1].reservations()
    assert port_rrs or not live, "reservations were written over REST"


def test_rest_servers_agree_on_a_demand(rest_twin):
    """A gang too large for the cluster: both servers write the same
    Demand over REST; once nodes arrive it fits and both delete it."""
    twin = rest_twin("tpu-batch")
    twin.add_node("n0", "4", "4Gi", "zone0")
    twin.add_node("n1", "4", "4Gi", "zone1")
    pods = static_pod_wires("app-huge", 12, T0, executor_cpu="2")
    assert twin.schedule(pods[0], ["n0", "n1"]) is None
    twin.assert_state_equal()
    assert twin.sides[1].demands(), "a demand for the gang"
    for i in range(2, 8):
        twin.add_node(f"n{i}", "16", "16Gi", f"zone{i % 2}")
    assert twin.schedule(pods[0], [f"n{i}" for i in range(8)]) is not None
    twin.assert_state_equal()
    assert not twin.sides[1].demands()
