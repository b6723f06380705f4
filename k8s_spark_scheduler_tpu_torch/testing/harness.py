"""Test harness (reference
``internal/extender/extendertest/extender_test_utils.go``).

Builds the entire wiring on the embedded API server and exposes
schedule/terminate/assert helpers plus object factories:
``new_node`` (8 CPU / 8Gi / 1 GPU, zone label), static and dynamic
allocation spark-pod builders with correctly-annotated driver/executor
pods and instance-group affinity.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from .. import timesource
from ..analysis import racecheck
from ..config import FifoConfig, Install
from ..device import DeviceLike
from ..kube.apiserver import APIServer
from ..kube.crd import DEMAND_CRD_NAME, demand_crd_spec
from ..scheduler import labels as L
from ..server.wiring import Server, init_server_with_clients
from ..types.extenderapi import ExtenderArgs, ExtenderFilterResult
from ..types.objects import Container, Node, ObjectMeta, Pod, PodPhase
from ..types.resources import ZONE_LABEL, Resources


class Harness:
    """extender_test_utils.go:54-176."""

    def __init__(
        self,
        binpack_algo: str = "tightly-pack",
        is_fifo: bool = True,
        fifo_config: Optional[FifoConfig] = None,
        instance_group_label: str = "resource_channel",
        dynamic_allocation_single_az: bool = False,
        with_demand_crd: bool = True,
        extra_install: Optional[Install] = None,
        driver_prioritized_node_label=None,
        executor_prioritized_node_label=None,
        device: DeviceLike = None,
        delta_solve: bool = True,
        unschedulable_polling_interval: float = 60.0,
    ):
        """`device` is where the tpu-batch* solvers run (None = CUDA);
        `delta_solve` turns the delta-solve engine on (the default, as in
        the reference) or off, unless `extra_install` is given.  With
        SCHEDLINT_RACECHECK=1 the race detectors are enabled before any
        guarded state is built, so every lock the server wires up is
        tracked from birth (``racecheck.disable()`` returns the report)."""
        racecheck.enable_if_env()
        self.api = APIServer()
        if with_demand_crd:
            self.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        install = extra_install or Install(
            fifo=is_fifo,
            fifo_config=fifo_config or FifoConfig(),
            binpack_algo=binpack_algo,
            instance_group_label=instance_group_label,
            should_schedule_dynamically_allocated_executors_in_same_az=dynamic_allocation_single_az,
            driver_prioritized_node_label=driver_prioritized_node_label,
            executor_prioritized_node_label=executor_prioritized_node_label,
            delta_solve=delta_solve,
        )
        self.server: Server = init_server_with_clients(
            self.api,
            install,
            start_background=True,
            demand_poll_interval=0.02,
            unschedulable_polling_interval=unschedulable_polling_interval,
            device=device,
        )
        self.extender = self.server.extender
        self.unschedulable_marker = self.server.unschedulable_marker
        if with_demand_crd:
            self.server.lazy_demand_informer.wait_ready(5)

    def close(self) -> None:
        self.server.stop()

    # -- cluster management --------------------------------------------------

    def add_node(self, node: Node) -> Node:
        return self.api.create(node)

    def new_node(
        self,
        name: str,
        cpu="8",
        memory="8Gi",
        gpu="1",
        zone: str = "zone1",
        instance_group: str = "batch-medium-priority",
        instance_group_label: str = "resource_channel",
        unschedulable: bool = False,
        ready: bool = True,
        labels: Optional[dict] = None,
    ) -> Node:
        """extender_test_utils.go:239-271."""
        node = Node(
            meta=ObjectMeta(
                name=name,
                labels={
                    ZONE_LABEL: zone,
                    instance_group_label: instance_group,
                    **(labels or {}),
                },
            ),
            allocatable=Resources.of(cpu, memory, gpu),
            unschedulable=unschedulable,
            ready=ready,
        )
        return self.add_node(node)

    # -- pod factories -------------------------------------------------------

    @staticmethod
    def static_allocation_spark_pods(
        app_id: str,
        executor_count: int,
        driver_cpu="1",
        driver_mem="1Gi",
        driver_gpu: Optional[str] = None,
        executor_cpu="1",
        executor_mem="1Gi",
        executor_gpu: Optional[str] = None,
        instance_group: str = "batch-medium-priority",
        instance_group_label: str = "resource_channel",
        namespace: str = "default",
        creation_timestamp: Optional[float] = None,
    ) -> List[Pod]:
        """extender_test_utils.go:275-339: [driver, executor-0..n-1]."""
        annotations = {
            L.DRIVER_CPU: driver_cpu,
            L.DRIVER_MEMORY: driver_mem,
            L.EXECUTOR_CPU: executor_cpu,
            L.EXECUTOR_MEMORY: executor_mem,
            L.EXECUTOR_COUNT: str(executor_count),
        }
        if driver_gpu is not None:
            annotations[L.DRIVER_NVIDIA_GPUS] = driver_gpu
        if executor_gpu is not None:
            annotations[L.EXECUTOR_NVIDIA_GPUS] = executor_gpu
        return Harness._spark_pods(
            app_id,
            executor_count,
            annotations,
            instance_group,
            instance_group_label,
            namespace,
            creation_timestamp,
        )

    @staticmethod
    def dynamic_allocation_spark_pods(
        app_id: str,
        min_executor_count: int,
        max_executor_count: int,
        driver_cpu="1",
        driver_mem="1Gi",
        executor_cpu="1",
        executor_mem="1Gi",
        executor_gpu: Optional[str] = None,
        instance_group: str = "batch-medium-priority",
        instance_group_label: str = "resource_channel",
        namespace: str = "default",
        creation_timestamp: Optional[float] = None,
    ) -> List[Pod]:
        """extender_test_utils.go:342-423: driver + max_executor_count
        executor pods (the extras only get soft reservations)."""
        annotations = {
            L.DRIVER_CPU: driver_cpu,
            L.DRIVER_MEMORY: driver_mem,
            L.EXECUTOR_CPU: executor_cpu,
            L.EXECUTOR_MEMORY: executor_mem,
            L.DYNAMIC_ALLOCATION_ENABLED: "true",
            L.DA_MIN_EXECUTOR_COUNT: str(min_executor_count),
            L.DA_MAX_EXECUTOR_COUNT: str(max_executor_count),
        }
        if executor_gpu is not None:
            annotations[L.EXECUTOR_NVIDIA_GPUS] = executor_gpu
        return Harness._spark_pods(
            app_id,
            max_executor_count,
            annotations,
            instance_group,
            instance_group_label,
            namespace,
            creation_timestamp,
        )

    @staticmethod
    def _spark_pods(
        app_id: str,
        executor_count: int,
        annotations: dict,
        instance_group: str,
        instance_group_label: str,
        namespace: str,
        creation_timestamp: Optional[float],
    ) -> List[Pod]:
        ts = creation_timestamp if creation_timestamp is not None else timesource.now()
        driver = Pod(
            meta=ObjectMeta(
                name=f"{app_id}-driver",
                namespace=namespace,
                labels={L.SPARK_ROLE_LABEL: L.DRIVER, L.SPARK_APP_ID_LABEL: app_id},
                annotations=dict(annotations),
                creation_timestamp=ts,
            ),
            scheduler_name=L.SPARK_SCHEDULER_NAME,
            node_affinity={instance_group_label: [instance_group]},
            containers=[Container(requests=Resources.of(annotations[L.DRIVER_CPU], annotations[L.DRIVER_MEMORY]))],
        )
        pods = [driver]
        for i in range(executor_count):
            pods.append(
                Pod(
                    meta=ObjectMeta(
                        name=f"{app_id}-exec-{i + 1}",
                        namespace=namespace,
                        labels={L.SPARK_ROLE_LABEL: L.EXECUTOR, L.SPARK_APP_ID_LABEL: app_id},
                        annotations=dict(annotations),
                        creation_timestamp=ts,
                    ),
                    scheduler_name=L.SPARK_SCHEDULER_NAME,
                    node_affinity={instance_group_label: [instance_group]},
                    containers=[
                        Container(
                            requests=Resources.of(
                                annotations[L.EXECUTOR_CPU], annotations[L.EXECUTOR_MEMORY]
                            )
                        )
                    ],
                )
            )
        return pods

    # -- scheduling simulation ----------------------------------------------

    def create_pod(self, pod: Pod) -> Pod:
        return self.api.create(pod)

    def schedule(self, pod: Pod, node_names: Sequence[str]) -> ExtenderFilterResult:
        """Simulate the kube-scheduler callback AND the bind
        (extender_test_utils.go:179-193): on success sets nodeName, phase
        Running, and updates the store."""
        existing = self.server.pod_informer.get(pod.namespace, pod.name)
        if existing is None:
            pod = self.api.create(pod)
        else:
            pod = existing.deepcopy()
        # route through the concurrent admission engine when wired —
        # exactly what the HTTP layer does (server/http.py), so harness
        # scheduling exercises the same speculate→commit path
        engine = self.server.concurrent
        predicate = engine.predicate if engine is not None else self.extender.predicate
        result = predicate(ExtenderArgs(pod=pod, node_names=list(node_names)))
        if result.node_names:
            bound = self.api.get(Pod.KIND, pod.namespace, pod.name)
            bound.node_name = result.node_names[0]
            bound.phase = PodPhase.RUNNING
            self.api.update(bound)
        return result

    def terminate_pod(self, pod: Pod) -> None:
        """extender_test_utils.go:196-209: phase Succeeded + terminated
        container statuses."""
        fresh = self.api.get(Pod.KIND, pod.namespace, pod.name)
        fresh.phase = PodPhase.SUCCEEDED
        fresh.container_terminated = [True] * max(1, len(fresh.containers))
        self.api.update(fresh)

    def delete_pod(self, pod: Pod) -> None:
        self.api.delete(Pod.KIND, pod.namespace, pod.name)

    # -- assertions ----------------------------------------------------------

    @staticmethod
    def assert_success(result: ExtenderFilterResult) -> str:
        assert result.node_names, f"expected success, got failure: {result.failed_nodes}"
        return result.node_names[0]

    @staticmethod
    def assert_failure(result: ExtenderFilterResult) -> None:
        assert not result.node_names, f"expected failure, got node {result.node_names}"

    def get_resource_reservation(self, app_id: str, namespace: str = "default"):
        return self.server.resource_reservation_cache.get(namespace, app_id)

    def wait_quiesced(self, timeout: float = 5.0) -> bool:
        """Wait until async write-back queues drain and the local
        reservation cache agrees with the API server — makes
        timing-sensitive scenario tests deterministic (the transient
        divergence is reference-equivalent but nondeterministic).

        Keys with a pending intent-journal entry are excluded from the
        comparison: while the write-back breaker is open (API-server
        outage) the local cache legitimately leads the API server by
        exactly the journaled intents — that divergence IS the quiesced
        state, and the simulator's lost-intent audit covers it."""
        def rr_content(rrs, exclude):
            return {
                (rr.namespace, rr.name): (
                    sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                    sorted(rr.status.pods.items()),
                )
                for rr in rrs
                if (rr.namespace, rr.name) not in exclude
            }

        def settled():
            if any(self.server.resource_reservation_cache.inflight_queue_lengths()):
                return False
            # compare full content (a popped-but-unapplied write has equal
            # key sets but differing specs)
            kit = getattr(self.server, "resilience", None)
            pending = kit.journal.pending_keys() if kit is not None else set()
            local = rr_content(self.server.resource_reservation_cache.list(), pending)
            remote = rr_content(self.api.list("ResourceReservation"), pending)
            return local == remote
        return self.wait_for_api(settled, timeout=timeout)

    def wait_for_api(self, cond, timeout: float = 5.0, tick: float = 0.01) -> bool:
        """waitForCondition (cmd/integration common.go:119-136).

        Deadline on the REAL monotonic clock, never the (possibly
        virtual, frozen) timesource, so bounded waits stay bounded."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(tick)
        return False
