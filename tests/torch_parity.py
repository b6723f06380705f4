"""Shared helper of the port's server-level parity tests: one scenario
driven through the JAX package's harness and the PyTorch port's harness
side by side.

Every cluster object is built once with the JAX package's factories,
serialised with its serde, and the same wire dict is decoded by each
package (the JAX serde, the port's ``convert.object_from_wire``), so
both servers see identical state.  Both packages' time sources are
pinned to one virtual clock, so FIFO ages and reconciliation triggers
agree.  The JAX server runs without the two subsystems the port does not
have and would refuse in its config: delta-solve and provenance.  ``Twin.schedule`` holds every ``ExtenderFilterResult`` equal
and ``Twin.assert_state_equal`` the reservations and demands in both
API servers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.config import FifoConfig as JaxFifoConfig
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.config import ProvenanceConfig as JaxProvenanceConfig
from k8s_spark_scheduler_tpu.testing.harness import Harness as JaxHarness
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu.types.extenderapi import ExtenderArgs as JaxArgs
from k8s_spark_scheduler_tpu.types.objects import Container, Node, ObjectMeta, Pod
from k8s_spark_scheduler_tpu.types.resources import ZONE_LABEL, Resources
from k8s_spark_scheduler_tpu_torch import timesource as port_timesource
from k8s_spark_scheduler_tpu_torch.config import FifoConfig as PortFifoConfig
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.metrics import names as port_names
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness as PortHarness
from k8s_spark_scheduler_tpu_torch.types import serde as port_serde
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs as PortArgs

T0 = 1_700_000_000.0
GROUP = "batch-medium-priority"
IG_LABEL = "resource_channel"


def _strip_identity(wire: dict) -> dict:
    """A wire dict without the fields each API server assigns itself
    (uids, resource versions): what must agree across the two."""
    meta = dict(wire.get("metadata") or {})
    for key in ("uid", "resourceVersion"):
        meta.pop(key, None)
    meta["ownerReferences"] = [
        {k: v for k, v in ref.items() if k != "uid"} for ref in meta.get("ownerReferences") or []
    ]
    return dict(wire, metadata=meta)


def static_pod_wires(app_id: str, executors: int, created: float = T0, **kw) -> List[dict]:
    """[driver, executors...] of a static-allocation app as wire dicts."""
    pods = JaxHarness.static_allocation_spark_pods(
        app_id, executors, instance_group_label=IG_LABEL, creation_timestamp=created, **kw
    )
    return [jax_serde.pod_to_dict(p) for p in pods]


class Twin:
    """The JAX harness and the port harness (``device="cpu"``) on the
    same install, driven in lockstep."""

    def __init__(
        self,
        binpack_algo: str,
        enforce_after_age: float = 0.0,
        dynamic_allocation_single_az: bool = False,
    ):
        self.now = T0
        jax_timesource.set_source(lambda: self.now)
        port_timesource.set_source(lambda: self.now)
        self.jax: Optional[JaxHarness] = None
        self.port: Optional[PortHarness] = None
        try:
            self.jax = JaxHarness(
                extra_install=JaxInstall(
                    fifo=True,
                    fifo_config=JaxFifoConfig(default_enforce_after_pod_age=enforce_after_age),
                    binpack_algo=binpack_algo,
                    instance_group_label=IG_LABEL,
                    should_schedule_dynamically_allocated_executors_in_same_az=(
                        dynamic_allocation_single_az
                    ),
                    # the port has neither (config.py refuses them):
                    # provenance would enrich the reference's failure
                    # messages with a shortfall explanation
                    delta_solve=False,
                    provenance=JaxProvenanceConfig(enabled=False),
                )
            )
            self.port = PortHarness(
                binpack_algo=binpack_algo,
                is_fifo=True,
                fifo_config=PortFifoConfig(default_enforce_after_pod_age=enforce_after_age),
                instance_group_label=IG_LABEL,
                dynamic_allocation_single_az=dynamic_allocation_single_az,
                device="cpu",
            )
        except BaseException:
            self.close()
            raise
        self.results: List[dict] = []

    def close(self) -> None:
        try:
            for h in (self.jax, self.port):
                if h is not None:
                    h.close()
        finally:
            jax_timesource.reset()
            port_timesource.reset()

    def advance(self, seconds: float) -> None:
        self.now += seconds

    # -- cluster objects ------------------------------------------------------

    def _create(self, wire: dict) -> None:
        self.jax.api.create(jax_serde_decode(wire))
        self.port.api.create(object_from_wire(wire))

    def add_node(
        self,
        name: str,
        cpu="8",
        memory="8Gi",
        gpu="1",
        zone: str = "zone1",
        labels: Optional[dict] = None,
        unschedulable: bool = False,
        ready: bool = True,
    ) -> None:
        node = Node(
            meta=ObjectMeta(
                name=name,
                labels={ZONE_LABEL: zone, IG_LABEL: GROUP, **(labels or {})},
                creation_timestamp=self.now,
            ),
            allocatable=Resources.of(cpu, memory, gpu),
            unschedulable=unschedulable,
            ready=ready,
        )
        self._create(jax_serde.node_to_dict(node))

    def delete_node(self, name: str) -> None:
        self.jax.api.delete("Node", "default", name)
        self.port.api.delete("Node", "default", name)

    def overhead_pod(self, name: str, node: str, cpu="1", memory="1Gi") -> None:
        """A running non-spark pod: overhead on its node."""
        pod = Pod(
            meta=ObjectMeta(name=name, namespace="kube-system", creation_timestamp=self.now),
            node_name=node,
            phase="Running",
            containers=[Container(requests=Resources.of(cpu, memory))],
        )
        self._create(jax_serde.pod_to_dict(pod))

    def static_pods(self, app_id: str, executors: int, age: float = 0.0, **kw) -> List[dict]:
        return static_pod_wires(app_id, executors, self.now - age, **kw)

    def dynamic_pods(self, app_id: str, min_count: int, max_count: int, age: float = 0.0, **kw) -> List[dict]:
        pods = JaxHarness.dynamic_allocation_spark_pods(
            app_id, min_count, max_count, instance_group_label=IG_LABEL,
            creation_timestamp=self.now - age, **kw
        )
        return [jax_serde.pod_to_dict(p) for p in pods]

    def create_pod(self, wire: dict) -> None:
        """The pod exists in the cluster (pending) without a Filter."""
        self._create(wire)

    def rename(self, wire: dict, name: str) -> dict:
        return dict(wire, metadata=dict(wire["metadata"], name=name))

    def delete_pod(self, wire: dict) -> None:
        meta = wire["metadata"]
        for h in (self.jax, self.port):
            h.api.delete("Pod", meta.get("namespace", "default"), meta["name"])

    def terminate_pod(self, wire: dict) -> None:
        self.jax.terminate_pod(jax_serde_decode(wire))
        self.port.terminate_pod(object_from_wire(wire))

    # -- Filter ----------------------------------------------------------------

    def schedule(self, wire: dict, node_names: Sequence[str]) -> Optional[str]:
        """Filter + bind on both sides; the results must be equal.
        Returns the chosen node (None on a failure)."""
        jr = self.jax.schedule(jax_serde_decode(wire), node_names)
        pr = self.port.schedule(object_from_wire(wire), node_names)
        self._check(jr, pr)
        return pr.node_names[0] if pr.node_names else None

    def replay(self, wire: dict, node_names: Sequence[str]) -> Optional[str]:
        """A Filter without the bind (kube-scheduler retrying a pod the
        cluster already knows)."""
        jpod = self.jax.server.pod_informer.get(wire["metadata"].get("namespace", "default"), wire["metadata"]["name"])
        ppod = self.port.server.pod_informer.get(wire["metadata"].get("namespace", "default"), wire["metadata"]["name"])
        jr = self.jax.extender.predicate(JaxArgs(pod=jpod.deepcopy(), node_names=list(node_names)))
        pr = self.port.extender.predicate(PortArgs(pod=ppod.deepcopy(), node_names=list(node_names)))
        self._check(jr, pr)
        return pr.node_names[0] if pr.node_names else None

    def _check(self, jr, pr) -> None:
        assert pr.to_dict() == jr.to_dict(), (pr.to_dict(), jr.to_dict())
        assert port_serde.encode_extender_filter_result(pr) == jax_serde.encode_extender_filter_result(jr)
        self.results.append(pr.to_dict())

    # -- state -----------------------------------------------------------------

    def _reservations(self, h, encode) -> dict:
        return {
            (rr.namespace, rr.name): _strip_identity(encode(rr))
            for rr in h.api.list("ResourceReservation")
        }

    def _demands(self, h, encode) -> dict:
        return {
            (d.namespace, d.name): _strip_identity(encode(d))
            for d in h.api.list("Demand")
        }

    def assert_state_equal(self) -> None:
        """Reservations and demands in both API servers are equal once
        the write-back queues have drained (and soft reservations in
        both in-memory stores)."""
        for h in (self.jax, self.port):
            assert h.wait_quiesced(10)
            assert h.wait_for_api(
                lambda h=h: not any(h.server.demand_cache.inflight_queue_lengths())
                and {(d.namespace, d.name) for d in h.api.list("Demand")}
                == {(d.namespace, d.name) for d in h.server.demand_cache.list()},
                timeout=10,
            )
        assert self._reservations(self.port, port_serde.rr_to_dict_v1beta2) == self._reservations(
            self.jax, jax_serde.rr_to_dict_v1beta2
        )
        assert self._demands(self.port, port_serde.demand_to_dict_v1alpha2) == self._demands(
            self.jax, jax_serde.demand_to_dict_v1alpha2
        )
        jsoft = self.jax.server.soft_reservation_store.get_all_soft_reservations_copy()
        psoft = self.port.server.soft_reservation_store.get_all_soft_reservations_copy()
        assert {
            app: (sorted((k, r.node) for k, r in sr.reservations.items()), sorted(sr.status.items()))
            for app, sr in psoft.items()
        } == {
            app: (sorted((k, r.node) for k, r in sr.reservations.items()), sorted(sr.status.items()))
            for app, sr in jsoft.items()
        }

    def port_fast_lane_count(self) -> float:
        return self.port.server.metrics.get_counter(
            port_names.TPU_FASTPATH, {"path": "driver", "lane": "fast"}
        )


def jax_serde_decode(wire: dict):
    kind = wire.get("kind") or "Pod"
    return {
        "Node": jax_serde.node_from_dict,
        "Pod": jax_serde.pod_from_dict,
    }[kind](dict(wire))
