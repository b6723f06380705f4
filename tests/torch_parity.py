"""Shared helper of the port's server-level parity tests: one scenario
driven through the JAX package's harness and the PyTorch port's harness
side by side.

Every cluster object is built once with the JAX package's factories,
serialised with its serde, and the same wire dict is decoded by each
package (the JAX serde, the port's ``convert.object_from_wire``), so
both servers see identical state.  Both packages' time sources are
pinned to one virtual clock, so FIFO ages and reconciliation triggers
agree.  Both servers run the reference's defaults: the resilience kit,
decision provenance (so a refused driver's failure message carries the
shortfall explanation on both sides) and the delta-solve engine (the
JAX server's native session, the port's device-resident one; a driver
Filter is served warm wherever the engine can).  ``Twin.schedule``
holds every ``ExtenderFilterResult`` equal (failure messages included),
``Twin.assert_state_equal`` the reservations and demands in both API
servers, and ``Twin.delta_stats`` reads both engines' counters.  Both
run the contention observatory (each package's own process-wide
timekeeper) and the capacity observatory and the lifecycle ledger too:
``Twin.get`` reads an endpoint of each over HTTP, and
``Twin.quiet_observatories`` stops their background threads so that a
read's sample and drain are the ones it asks for.  ``Twin(policy={...})``
turns on the scheduling-policy engine on both sides with the same
``PolicyConfig`` fields; ``lifecycle_record_body`` and
``lifecycle_summary_body`` drop the fields of a ``/lifecycle`` body that
the serving process or the host's clock decides (``UNCOMPARED``).
``HATwin`` turns on the HA fabric on both sides and builds a second
replica of each package's server on the same API server: elections are
stepped by the test (``background`` off) under the frozen virtual clock,
and ``HATwin.schedule`` sends a Filter to the replica the test names.

Both servers write reservations and demands back on worker threads, and
a Filter or a delete that overtakes a pending write can decide
differently: two harnesses of the SAME package, driven in lockstep under
load, choose different nodes for one Filter.  So ``Twin`` settles both
sides (write-back queues drained, caches equal to their API server)
before every Filter and every delete, and compares only decisions made
on settled state.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.config import FifoConfig as JaxFifoConfig
from k8s_spark_scheduler_tpu.config import HAConfig as JaxHAConfig
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.config import PolicyConfig as JaxPolicyConfig
from k8s_spark_scheduler_tpu.scheduler import invariants as jax_invariants
from k8s_spark_scheduler_tpu.server.http import ExtenderHTTPServer as JaxHTTPServer
from k8s_spark_scheduler_tpu.server.wiring import init_server_with_clients as jax_init_server
from k8s_spark_scheduler_tpu.testing.harness import Harness as JaxHarness
from k8s_spark_scheduler_tpu.types import serde as jax_serde
from k8s_spark_scheduler_tpu.types.extenderapi import ExtenderArgs as JaxArgs
from k8s_spark_scheduler_tpu.types.objects import Container, Node, ObjectMeta, Pod
from k8s_spark_scheduler_tpu.types.resources import ZONE_LABEL, Resources
from k8s_spark_scheduler_tpu_torch import timesource as port_timesource
from k8s_spark_scheduler_tpu_torch.config import FifoConfig as PortFifoConfig
from k8s_spark_scheduler_tpu_torch.config import HAConfig as PortHAConfig
from k8s_spark_scheduler_tpu_torch.config import Install as PortInstall
from k8s_spark_scheduler_tpu_torch.config import PolicyConfig as PortPolicyConfig
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire
from k8s_spark_scheduler_tpu_torch.metrics import names as port_names
from k8s_spark_scheduler_tpu_torch.scheduler import invariants as port_invariants
from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer as PortHTTPServer
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients as port_init_server
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness as PortHarness
from k8s_spark_scheduler_tpu_torch.types import serde as port_serde
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs as PortArgs

T0 = 1_700_000_000.0
GROUP = "batch-medium-priority"
IG_LABEL = "resource_channel"

# Fields of the observatory bodies (/state/capacity, /slo, /lifecycle)
# left out of the Twin comparisons, each because its value names the
# serving process or the host's clock rather than the cluster's state:
# - sampleMs, classes.expandMs: host-clock cost of a sample;
# - probeLane: where the probes ran ("torch" here, the reference's
#   "native" or "numpy");
# - t: the sample's time source read (frozen, but not the cluster's);
# - contentKey[0], structureKey[0]: the tensor mirror's process-local
#   instance number (each package counts its own mirrors);
# - traceIds: random per request;
# - solveTenureSeconds: host-clock span durations of the Filters;
# - the filter_latency objective's good / bad split and everything
#   derived from it (state, budgetRemaining, windows), and the
#   scorecard digest over it: a Filter is good when its host-clock
#   duration is under 0.1 s (its total is compared);
# - the ledger's transitions count: a granted driver's reservation is
#   written back on a worker thread, and whether its informer event
#   lands before the driver's bind (one more transition, "reserved"
#   before "bound") is the host's thread timing, in either package;
#   the phases and their first-arrival times are compared.
UNCOMPARED = {
    "capacity": ("sampleMs", "probeLane", "t"),
    "classes": ("expandMs",),
    "record": ("traceIds", "solveTenureSeconds"),
    "filter_latency": ("good", "bad", "state", "budgetRemaining", "windows"),
    "lifecycle": ("transitions",),
}


def lifecycle_summary_body(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in UNCOMPARED["lifecycle"]}


def lifecycle_record_body(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in UNCOMPARED["record"]}


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

    # HTTP servers over both sides, started by the first ``get``
    _http: tuple = ()

    def __init__(
        self,
        binpack_algo: str,
        enforce_after_age: float = 0.0,
        dynamic_allocation_single_az: bool = False,
        check_invariants: bool = False,
        policy: Optional[dict] = None,
        ha: Optional[dict] = None,
    ):
        """``policy``: ``PolicyConfig`` fields (e.g. ``{"enabled": True,
        "ordering": "drf"}``) set on both sides; None leaves the engine
        off, as the defaults do.  ``ha``: ``HAConfig`` fields, the same."""
        self.now = T0
        jax_timesource.set_source(lambda: self.now)
        port_timesource.set_source(lambda: self.now)
        self.jax: Optional[JaxHarness] = None
        self.port: Optional[PortHarness] = None
        common = dict(
            fifo=True,
            binpack_algo=binpack_algo,
            instance_group_label=IG_LABEL,
            should_schedule_dynamically_allocated_executors_in_same_az=dynamic_allocation_single_az,
        )
        try:
            self.jax = JaxHarness(
                extra_install=JaxInstall(
                    fifo_config=JaxFifoConfig(default_enforce_after_pod_age=enforce_after_age),
                    policy=JaxPolicyConfig(**(policy or {})),
                    ha=JaxHAConfig(**(ha or {})),
                    **common,
                )
            )
            self.port = PortHarness(
                extra_install=PortInstall(
                    fifo_config=PortFifoConfig(default_enforce_after_pod_age=enforce_after_age),
                    policy=PortPolicyConfig(**(policy or {})),
                    ha=PortHAConfig(**(ha or {})),
                    **common,
                ),
                device="cpu",
            )
        except BaseException:
            self.close()
            raise
        self.results: List[dict] = []
        self.invariant_checks = 0
        if check_invariants:
            self._check_invariants_after_each_filter()

    def _check_invariants_after_each_filter(self) -> None:
        """Each side checks I1-I5 (its own scheduler/invariants.py) at
        the end of every Filter, inside its predicate lock, raising on a
        violation (the wiring's SCHED_DEBUG_INVARIANTS hook only logs)."""
        for h, check in ((self.jax, jax_invariants.check), (self.port, port_invariants.check)):
            original = h.extender._predicate_locked

            def checked(args, original=original, server=h.server, check=check):
                result = original(args)
                assert check(server, raise_on_violation=True) == []
                self.invariant_checks += 1
                return result

            h.extender._predicate_locked = checked

    def close(self) -> None:
        try:
            for http in self._http:
                http.stop()
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
        self.settle()
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
        self.settle()
        for h in (self.jax, self.port):
            h.api.delete("Pod", meta.get("namespace", "default"), meta["name"])

    def terminate_pod(self, wire: dict) -> None:
        self.settle()
        self.jax.terminate_pod(jax_serde_decode(wire))
        self.port.terminate_pod(object_from_wire(wire))

    # -- Filter ----------------------------------------------------------------

    def schedule(self, wire: dict, node_names: Sequence[str]) -> Optional[str]:
        """Filter + bind on both sides; the results must be equal.
        Returns the chosen node (None on a failure)."""
        self.settle()
        jr = self.jax.schedule(jax_serde_decode(wire), node_names)
        pr = self.port.schedule(object_from_wire(wire), node_names)
        self._check(jr, pr)
        return pr.node_names[0] if pr.node_names else None

    def replay(self, wire: dict, node_names: Sequence[str]) -> Optional[str]:
        """A Filter without the bind (kube-scheduler retrying a pod the
        cluster already knows)."""
        self.settle()
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

    def settle(self) -> None:
        """Wait until both servers' reservation and demand write-backs
        have drained and each cache agrees with its API server."""
        for h in (self.jax, self.port):
            assert h.wait_quiesced(10)
            assert h.wait_for_api(
                lambda h=h: not any(h.server.demand_cache.inflight_queue_lengths())
                and {(d.namespace, d.name) for d in h.api.list("Demand")}
                == {(d.namespace, d.name) for d in h.server.demand_cache.list()},
                timeout=10,
            )

    def assert_state_equal(self) -> None:
        """Reservations and demands in both API servers are equal once
        the write-back queues have drained (and soft reservations in
        both in-memory stores)."""
        self.settle()
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

    def delta_stats(self) -> tuple:
        """(JAX engine stats, port engine stats): warm hits, cold solves,
        digest hits and misses of each side's delta-solve engine."""
        keys = ("warm_hits", "cold_solves", "digest_hits", "misses")
        return tuple(
            {k: h.extender.delta_engine.stats()[k] for k in keys} for h in (self.jax, self.port)
        )

    def quiet_observatories(self) -> None:
        """Stop both sides' capacity-sampler and lifecycle-ledger
        threads: every later sample and drain is the one an HTTP read
        asks for (the subsystems stay wired and on)."""
        for h in (self.jax, self.port):
            h.server.capacity.stop()
            h.server.lifecycle.stop()

    def get(self, path: str) -> Tuple[Tuple[int, dict], Tuple[int, dict]]:
        """GET ``path`` from each server over HTTP (settled first):
        ((status, body) of the JAX server, (status, body) of the
        port's)."""
        self.settle()
        if not self._http:
            self._http = tuple(cls(h.server, port=0, host="127.0.0.1")
                               for cls, h in ((JaxHTTPServer, self.jax), (PortHTTPServer, self.port)))
            for http in self._http:
                http.start()
        out = []
        for http in self._http:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{http.port}{path}", timeout=30) as resp:
                    out.append((resp.status, json.loads(resp.read())))
            except urllib.error.HTTPError as err:
                out.append((err.code, json.loads(err.read() or b"{}")))
        return out[0], out[1]

    def port_fast_lane_count(self) -> float:
        return self.port.server.metrics.get_counter(
            port_names.TPU_FASTPATH, {"path": "driver", "lane": "fast"}
        )


# fields of a /status/ha body that name the replica or the host's clock:
# its identity, the read's time, the lease's renewal time and the
# takeover report's duration
HA_UNCOMPARED = ("identity", "asOf", "renewedAt", "elapsedSeconds")


def ha_status_body(body: dict) -> dict:
    """A /status/ha body less ``HA_UNCOMPARED``, at any depth."""
    if isinstance(body, dict):
        return {k: ha_status_body(v) for k, v in body.items() if k not in HA_UNCOMPARED}
    if isinstance(body, list):
        return [ha_status_body(v) for v in body]
    return body


class HATwin(Twin):
    """A Twin with the HA fabric on both sides and two replicas a side
    on one API server: ``replica-a`` is the harness's server,
    ``replica-b`` a second server built beside it with the same install.
    Background renewal is off, so elections happen only in ``step`` /
    ``step_down`` (on both sides, results equal), under the Twin's frozen
    clock.  The capacity samplers' and lifecycle ledgers' threads are
    stopped: ``drain`` drains every ledger at a point the test chooses,
    so each transition is stamped with the epoch of that point."""

    REPLICAS = ("replica-a", "replica-b")

    def __init__(self, binpack_algo: str, lease_duration: float = 15.0):
        self._replica_b = None
        self._ha_http = {}
        ha = dict(enabled=True, background=False, lease_duration_seconds=lease_duration)
        super().__init__(binpack_algo, ha=dict(ha, identity="replica-a"))
        try:
            installs = [
                dataclasses.replace(h.server.install, ha=config(**dict(ha, identity="replica-b")))
                for h, config in ((self.jax, JaxHAConfig), (self.port, PortHAConfig))
            ]
            jax_b = jax_init_server(self.jax.api, installs[0], start_background=True, demand_poll_interval=0.02)
            try:
                port_b = port_init_server(self.port.api, installs[1], start_background=True,
                                          demand_poll_interval=0.02, device="cpu")
            except BaseException:
                jax_b.stop()
                raise
            self._replica_b = (jax_b, port_b)
            for server in self.servers():
                server.capacity.stop()
                server.lifecycle.stop()
        except BaseException:
            self.close()
            raise
        self.serving = "replica-a"

    def close(self) -> None:
        try:
            for http in self._ha_http.values():
                http.stop()
            if self._replica_b is not None:
                for server in self._replica_b:
                    server.stop()
        finally:
            super().close()

    def replica(self, name: str) -> tuple:
        """(JAX server, port server) of the replica."""
        return (self.jax.server, self.port.server) if name == "replica-a" else self._replica_b

    def servers(self) -> list:
        return [server for name in self.REPLICAS for server in self.replica(name)]

    def step(self, name: str) -> bool:
        """One election round of the replica on both sides; both must
        agree whether it leads."""
        jax_leader, port_leader = (s.ha.step() for s in self.replica(name))
        assert jax_leader == port_leader, (name, jax_leader, port_leader)
        return port_leader

    def step_down(self, name: str) -> None:
        for server in self.replica(name):
            server.ha.elector.step_down()

    def drain(self) -> None:
        self.settle()
        for server in self.servers():
            server.lifecycle.drain(trigger="test")

    def settle(self) -> None:
        """Every replica's write-back queues drained, and the serving
        replica's caches equal to its API server (a deposed replica's
        cache holds what it reserved, not what its successor updates)."""
        for h, server in ((self.jax, self.replica(self.serving)[0]), (self.port, self.replica(self.serving)[1])):
            others = [s for name in self.REPLICAS for s in self.replica(name)]
            assert h.wait_for_api(
                lambda: not any(n for s in others for n in s.resource_reservation_cache.inflight_queue_lengths())
                and not any(n for s in others for n in s.demand_cache.inflight_queue_lengths())
                and _rr_content(server.resource_reservation_cache.list())
                == _rr_content(h.api.list("ResourceReservation"))
                and {(d.namespace, d.name) for d in h.api.list("Demand")}
                == {(d.namespace, d.name) for d in server.demand_cache.list()},
                timeout=10,
            )

    def schedule(self, wire: dict, node_names: Sequence[str], replica: Optional[str] = None) -> Optional[str]:
        """Filter + bind through ``replica`` (default: the serving one)
        on both sides; the results must be equal."""
        self.settle()
        results = []
        for h, server, decode, args in (
            (self.jax, self.replica(replica or self.serving)[0], jax_serde_decode, JaxArgs),
            (self.port, self.replica(replica or self.serving)[1], object_from_wire, PortArgs),
        ):
            pod = decode(wire)
            existing = server.pod_informer.get(pod.namespace, pod.name)
            pod = h.api.create(pod) if existing is None else existing.deepcopy()
            result = server.extender.predicate(args(pod=pod, node_names=list(node_names)))
            if result.node_names:
                bound = h.api.get("Pod", pod.namespace, pod.name)
                bound.node_name, bound.phase = result.node_names[0], "Running"
                h.api.update(bound)
            results.append(result)
        self._check(*results)
        return results[1].node_names[0] if results[1].node_names else None

    def get_on(self, name: str, path: str) -> Tuple[Tuple[int, dict], Tuple[int, dict]]:
        """GET ``path`` from the replica's server in each package over
        HTTP: ((status, body) JAX, (status, body) port)."""
        out = []
        for server, cls in zip(self.replica(name), (JaxHTTPServer, PortHTTPServer)):
            http = self._ha_http.get(id(server))
            if http is None:
                http = self._ha_http[id(server)] = cls(server, port=0, host="127.0.0.1")
                http.start()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{http.port}{path}", timeout=30) as resp:
                    out.append((resp.status, json.loads(resp.read())))
            except urllib.error.HTTPError as err:
                out.append((err.code, json.loads(err.read() or b"{}")))
        return out[0], out[1]


def _rr_content(rrs) -> dict:
    return {
        (rr.namespace, rr.name): (
            sorted((k, v.node) for k, v in rr.spec.reservations.items()),
            sorted(rr.status.pods.items()),
        )
        for rr in rrs
    }


def jax_serde_decode(wire: dict):
    kind = wire.get("kind") or "Pod"
    return {
        "Node": jax_serde.node_from_dict,
        "Pod": jax_serde.pod_from_dict,
    }[kind](dict(wire))
