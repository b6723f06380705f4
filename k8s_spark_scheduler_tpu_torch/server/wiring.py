"""Server wiring (reference ``cmd/server.go`` InitServerWithClients).

Builds the whole scheduler bottom-up on an API server (the embedded
``kube/apiserver.py`` or ``kube/restbackend.RestAPIServer`` over a real
cluster): informers, the write-back reservation and demand caches, soft
reservations, the reservation manager, the tensor mirror of the
cluster, the extender around the configured binpacker, the waste and
periodic metric reporters, the unschedulable-pod marker, the resilience
kit (admission gate, write-back breaker and intent journal, tri-state
health), decision provenance (the record ring, the refusal explainer
and the flight recorder), the capacity observatory (a sampler thread
probing headroom on ``device``) and the lifecycle ledger with its SLO
engine.  The
``tpu-batch*`` binpackers run their queue solvers on ``device`` (None =
CUDA, which raises on a host without CUDA); ``start_background`` also
starts the kernel warmup, which builds the binpacker's CUDA library and
launches its kernel once at the common shape buckets, and readiness
waits for it.  With ``SCHED_DEBUG_INVARIANTS=1`` every Filter ends with
the invariant check (scheduler/invariants.py) inside the predicate lock.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..config import Install
from ..demands.manager import DemandManager
from ..device import DeviceLike, resolve_device
from ..events.events import EventLog
from ..kube import crd
from ..kube.apiserver import APIServer
from ..kube.informer import Informer, InformerFactory
from ..kube.ratelimit import TokenBucket
from ..metrics.registry import MetricsRegistry
from ..metrics.reporters import ReporterSet
from ..metrics.waste import WasteMetricsReporter
from ..ops.nodesort import NodeSorter
from ..ops.registry import Binpacker, select_binpacker
from ..resilience import ResilienceKit, build_kit
from ..scheduler.demand_gc import start_demand_gc
from ..scheduler.extender import SparkSchedulerExtender
from ..scheduler.overhead import OverheadComputer
from ..scheduler.reservations_manager import ResourceReservationManager
from ..scheduler.sparkpods import SparkPodLister
from ..scheduler.unschedulable import UnschedulablePodMarker
from ..state.softreservations import SoftReservationStore
from ..state.tensor_snapshot import TensorSnapshotCache
from ..state.typed_caches import (
    LazyDemandInformer,
    ResourceReservationCache,
    SafeDemandCache,
)
from ..tracing import Tracer
from ..tracing import profiling as kernel_profiling
from ..types import serde
from ..types.objects import Node, Pod, ResourceReservation

logger = logging.getLogger(__name__)


def warm_queue_kernel(binpacker: Binpacker, stop: threading.Event) -> None:
    """Build the CUDA library of the binpacker's queue kernel and launch
    the kernel once at each of the common node buckets (the smallest app
    bucket), synchronising after each launch so a fault surfaces here.
    Does nothing for a binpacker without a queue solver or one on the
    CPU.  Raises on a build or launch error."""
    from ..ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver
    from ..ops.minfrag_kernel import fifo_queue_min_frag
    from ..ops.queue_kernel import fifo_queue
    from ..ops.single_az_kernel import fifo_queue_single_az
    from ..ops.tensorize import APP_BUCKETS, NODE_BUCKETS

    solver = binpacker.queue_solver
    if solver is None or solver.device.type != "cuda":
        return
    dev = solver.device
    ab = APP_BUCKETS[0]
    for nb in NODE_BUCKETS[:3]:  # the shapes real clusters hit first
        if stop.is_set():
            return
        i32 = dict(dtype=torch.int32, device=dev)
        queue_args = (
            torch.zeros((nb, 3), **i32),
            torch.full((nb,), 2**31 - 1, **i32),
            torch.zeros((nb,), dtype=torch.bool, device=dev),
        )
        apps = (
            torch.zeros((ab, 3), **i32),
            torch.zeros((ab, 3), **i32),
            torch.zeros((ab,), **i32),
            torch.zeros((ab,), dtype=torch.bool, device=dev),
        )
        if isinstance(solver, TpuSingleAzFifoSolver):
            warm_zones = 3  # 3 AZs is typical
            fifo_queue_single_az(
                *queue_args,
                torch.zeros((nb,), **i32),
                *apps,
                torch.zeros((nb,), **i32),
                torch.zeros((nb,), **i32),
                torch.zeros((nb,), dtype=torch.float32, device=dev),
                torch.zeros((nb,), **i32),
                1,
                1,
                warm_zones,
                az_aware=solver.az_aware,
                minfrag=solver.inner_policy == "minimal-fragmentation",
                strict=solver.strict_reference_parity,
            )
        elif isinstance(solver, TpuFifoSolver) and solver.assignment_policy == "minimal-fragmentation":
            fifo_queue_min_frag(*queue_args, *apps)
        else:
            fifo_queue(*queue_args, *apps, evenly=solver.assignment_policy == "distribute-evenly")
        torch.cuda.synchronize(dev)


@dataclass
class Server:
    """Everything InitServerWithClients wires up."""

    api: APIServer
    install: Install
    device: torch.device
    informer_factory: InformerFactory
    pod_informer: Informer
    node_informer: Informer
    rr_informer: Informer
    resource_reservation_cache: ResourceReservationCache
    lazy_demand_informer: LazyDemandInformer
    demand_cache: SafeDemandCache
    demand_manager: DemandManager
    soft_reservation_store: SoftReservationStore
    pod_lister: SparkPodLister
    resource_reservation_manager: ResourceReservationManager
    overhead_computer: OverheadComputer
    extender: SparkSchedulerExtender
    tensor_snapshot: TensorSnapshotCache
    unschedulable_marker: UnschedulablePodMarker
    metrics: MetricsRegistry
    event_log: EventLog
    tracer: Tracer
    waste_reporter: WasteMetricsReporter
    reporters: Optional[ReporterSet] = None
    resilience: Optional[ResilienceKit] = None
    provenance: object = None  # ProvenanceTracker (provenance/tracker.py)
    capacity: object = None  # CapacitySampler (capacity/observatory.py)
    lifecycle: object = None  # LifecycleLedger (lifecycle/ledger.py)
    slo: object = None  # SloEngine (lifecycle/slo.py)
    _warm_done: threading.Event = field(default_factory=threading.Event)
    _warm_stop: threading.Event = field(default_factory=threading.Event)
    _warm_error: Optional[BaseException] = None
    _threads: List[threading.Thread] = field(default_factory=list)

    def start_background(self) -> None:
        """Start async writers, periodic loops and the kernel warmup
        (cmd/server.go:221-230)."""
        self.resource_reservation_cache.run()
        self.lazy_demand_informer.start()
        self.unschedulable_marker.start()
        if self.reporters is not None:
            self.reporters.start()
        if self.capacity is not None:
            self.capacity.start()
        if self.lifecycle is not None:
            self.lifecycle.start()
        self._start_warmup()

    def warmup_complete(self) -> bool:
        """True once the kernel warmup has finished without error.
        Readiness gates on this: traffic admitted before the kernel is
        built pays the build (tens of seconds of nvcc) on the request
        path."""
        return self._warm_done.is_set() and self._warm_error is None

    def wait_ready(self, timeout: float = 300.0) -> bool:
        """Block until caches are synced AND the kernel warmup finished
        (the readiness condition).  Re-raises the warmup's error: a
        kernel that fails to build or launch is never served around."""
        deadline = time.monotonic() + timeout  # real wall time: bounds the probe
        if not self.informer_factory.wait_for_cache_sync():
            return False
        if not self._warm_done.wait(max(0.0, deadline - time.monotonic())):
            return False
        if self._warm_error is not None:
            raise RuntimeError("kernel warmup failed") from self._warm_error
        return True

    def _start_warmup(self) -> None:
        def warm():
            try:
                warm_queue_kernel(self.extender.binpacker, self._warm_stop)
            except Exception as err:  # handed to wait_ready(), which re-raises
                logger.exception("kernel warmup failed")
                self._warm_error = err
            finally:
                self._warm_done.set()

        thread = threading.Thread(target=warm, daemon=True, name="kernel-warmup")
        self._threads.append(thread)
        thread.start()

    def stop(self) -> None:
        self._warm_stop.set()
        if self.reporters is not None:
            self.reporters.stop()
        if self.capacity is not None:
            self.capacity.stop()
        if self.lifecycle is not None:
            self.lifecycle.stop()
        self.unschedulable_marker.stop()
        self.resource_reservation_cache.stop()
        self.demand_cache.stop()
        if self.resilience is not None:
            # the journal keeps its pending (unlanded) intents on disk
            # for the next instance's boot-time replay
            self.resilience.journal.close()
        self.lazy_demand_informer.stop()
        for thread in self._threads:
            # a kernel build is bounded by nvcc; joining it keeps a CUDA
            # launch from racing interpreter teardown
            thread.join()


def init_server_with_clients(
    api: APIServer,
    install: Install,
    start_background: bool = True,
    demand_poll_interval: float = 1.0,
    unschedulable_polling_interval: float = 60.0,
    device: DeviceLike = None,
) -> Server:
    """cmd/server.go:65-237, bottom-up.  `device` is where the tpu-batch*
    queue solvers run: None means CUDA and raises without it."""
    device = resolve_device(device)
    # the reference would run these on this config; say so rather than
    # run fewer subsystems without a word
    for subsystem, item in install.reference_only:
        logger.warning(
            "the reference package runs %s on this config; this server does not (%s)",
            subsystem,
            item,
        )
    if install.resilience.lane_keys:
        logger.warning(
            "resilience keys %s configure the reference's kernel-lane demotion; this server "
            "never demotes a kernel lane (a kernel fault answers 500)",
            ", ".join(install.resilience.lane_keys),
        )
    metrics = MetricsRegistry()
    event_log = EventLog()
    # request tracing + kernel profiling sinks.  The profiler is a
    # module-level singleton (solvers are built without wiring access);
    # rebinding it here points kernel metrics/spans at THIS server —
    # correct for the one-server-per-process production shape.
    tracer = Tracer(capacity=256, metrics=metrics)
    kernel_profiling.default_profiler.configure(metrics=metrics, tracer=tracer, enabled=True)
    # node-name interning counters land in THIS server's registry (the
    # interner is module-level for the same reason the profiler is)
    serde.names_interner.metrics = metrics

    # CRD ensure (cmd/server.go:83-85)
    crd.ensure_resource_reservations_crd(
        api,
        install.resource_reservation_crd_annotations,
        conversion_webhook=install.conversion_webhook,
    )

    # informer factories + sync (cmd/server.go:91-127)
    factory = InformerFactory(api)
    pod_informer = factory.informer(Pod.KIND, index_labels=("spark-app-id", "spark-role"))
    node_informer = factory.informer(Node.KIND)
    rr_informer = factory.informer(ResourceReservation.KIND)
    factory.start()

    # caches (cmd/server.go:129-155); one shared write-rate bucket per
    # process, like the kube clientsets' QPS/Burst (cmd/clients.go:53-54)
    # overload protection: admission gate, write-back breaker + intent
    # journal, tri-state readiness (resilience/)
    resilience_kit = build_kit(install.resilience, metrics=metrics)

    rate_bucket = TokenBucket(install.qps, install.burst) if install.qps > 0 else None
    rr_cache = ResourceReservationCache(
        api,
        rr_informer,
        install.async_client.max_retry_count,
        rate_bucket=rate_bucket,
        breaker=resilience_kit.breaker,
        journal=resilience_kit.journal,
        registry=metrics,
    )
    # intents journaled by a previous instance (durable journal-path)
    # replay through the idempotent write path before any scheduling
    # decision reads the cache
    rr_cache.recover_from_journal()
    lazy_demand_informer = LazyDemandInformer(api, factory, poll_interval=demand_poll_interval)
    binpacker = select_binpacker(
        install.binpack_algo,
        strict_reference_parity=install.strict_reference_parity,
        device=device,
    )
    demand_cache = SafeDemandCache(
        lazy_demand_informer,
        api,
        install.async_client.max_retry_count,
        rate_bucket=rate_bucket,
        registry=metrics,
    )
    demand_manager = DemandManager(demand_cache, binpacker, install.instance_group_label, event_log)
    start_demand_gc(pod_informer, demand_manager)

    # stores + managers (cmd/server.go:157-167)
    soft_store = SoftReservationStore(pod_informer)
    pod_lister = SparkPodLister(pod_informer, install.instance_group_label)
    rrm = ResourceReservationManager(
        rr_cache, soft_store, pod_lister, pod_informer, metrics=metrics, tracer=tracer
    )
    overhead = OverheadComputer(pod_informer, rrm)

    # event-driven integer snapshot for the tpu-batch fast path
    tensor_snapshot = TensorSnapshotCache(node_informer, pod_informer, rr_cache, soft_store)

    # waste reporter (cmd/server.go:171-191 NewWasteMetricsReporter)
    waste_reporter = WasteMetricsReporter(metrics, install.instance_group_label)
    waste_reporter.start(pod_informer, lazy_demand_informer)

    # decision provenance: unschedulability explainer + shortfall
    # telemetry + anomaly flight recorder (provenance/)
    provenance_tracker = None
    if install.provenance.enabled:
        from ..provenance.tracker import ProvenanceTracker

        provenance_tracker = ProvenanceTracker(
            enabled=True,
            ring_size=install.provenance.ring_size,
            recorder_size=install.provenance.recorder_size,
            bundle_dir=install.provenance.bundle_dir,
            max_bundle_nodes=install.provenance.max_bundle_nodes,
            metrics=metrics,
            trigger_min_interval=install.provenance.trigger_min_interval_seconds,
        )
        # write-back breaker opening is a flight-recorder trigger: the
        # recent decisions leading into an open breaker are exactly the
        # forensic record an operator wants
        resilience_kit.breaker.on_open = lambda name: provenance_tracker.on_trigger(
            "breaker-open", f"breaker {name} opened"
        )

    # capacity observatory: fragmentation/headroom analytics + the
    # /state/capacity timeline, sampled off-lock on ChangeFeed triggers,
    # its probes on this server's device
    capacity_sampler = None
    if install.capacity.enabled:
        from ..capacity import CapacitySampler

        capacity_sampler = CapacitySampler(
            tensor_snapshot,
            pod_lister=pod_lister,
            waste_reporter=waste_reporter,
            metrics=metrics,
            instance_group_label=install.instance_group_label,
            ring_size=install.capacity.ring_size,
            debounce_seconds=install.capacity.debounce_seconds,
            interval_seconds=install.capacity.interval_seconds,
            max_shapes=install.capacity.max_shapes,
            max_group_zones=install.capacity.max_group_zones,
            max_queue=install.capacity.max_queue,
            device=device,
        )

    # gang lifecycle ledger + SLO engine (lifecycle/): per-application
    # state machine fed off informer threads and drain cursors — never
    # under the predicate lock.  The waste reporter's slo_sink makes
    # WasteMetricsReporter the single source of truth for the
    # eviction_waste objective.  No policy engine (its evictions and
    # DRF probe) and no HA epoch source exist here yet.
    lifecycle_ledger = None
    slo_engine = None
    if install.lifecycle.enabled:
        from ..lifecycle import LifecycleLedger, SloEngine

        slo_engine = SloEngine(
            metrics=metrics,
            window_scale=install.lifecycle.window_scale,
            sample_cap=install.lifecycle.sample_cap,
            overrides=install.lifecycle.objectives,
        )
        waste_reporter.slo_sink = slo_engine.waste_sample
        lifecycle_ledger = LifecycleLedger(
            event_log=event_log,
            tracer=tracer,
            feed=tensor_snapshot.feed,
            slo=slo_engine,
            metrics=metrics,
            ring_size=install.lifecycle.ring_size,
            debounce_seconds=install.lifecycle.debounce_seconds,
            interval_seconds=install.lifecycle.interval_seconds,
        )
        lifecycle_ledger.wire_informers(pod_informer=pod_informer, rr_informer=rr_informer)

    # extender (cmd/server.go:171-191)
    node_sorter = NodeSorter(
        install.driver_prioritized_node_label, install.executor_prioritized_node_label
    )
    extender = SparkSchedulerExtender(
        node_informer=node_informer,
        pod_lister=pod_lister,
        resource_reservation_cache=rr_cache,
        soft_reservation_store=soft_store,
        resource_reservation_manager=rrm,
        demands_manager=demand_manager,
        is_fifo=install.fifo,
        fifo_config=install.fifo_config,
        binpacker=binpacker,
        should_schedule_dynamically_allocated_executors_in_same_az=(
            install.should_schedule_dynamically_allocated_executors_in_same_az
        ),
        overhead_computer=overhead,
        instance_group_label=install.instance_group_label,
        node_sorter=node_sorter,
        metrics=metrics,
        event_log=event_log,
        waste_reporter=waste_reporter,
        tensor_snapshot_cache=tensor_snapshot,
        strict_reference_parity=install.strict_reference_parity,
        tracer=tracer,
        delta_solve=install.delta_solve,
        provenance=provenance_tracker,
    )
    if slo_engine is not None:
        # decision traces carry the active SLO alert states (one
        # precomputed-attribute read; never a burn-rate computation on
        # the Filter path — evaluate() runs at ledger drain time)
        extender.slo_alert_source = lambda: slo_engine.alert_tag
    if provenance_tracker is not None and extender.delta_engine is not None:
        # warm≠cold parity guard: every Nth warm hit re-proves the
        # session verdicts against the stateless cold pass and fires
        # the flight recorder on divergence (0 = off)
        extender.delta_engine.parity_interval = install.provenance.parity_check_interval
        extender.delta_engine.parity_hooks = (
            provenance_tracker.on_parity_ok,
            provenance_tracker.on_parity_mismatch,
        )
    if extender.delta_engine is not None:
        # equivalence-class aggregation (Install.classes): the O(1)
        # digest warm tier
        extender.delta_engine.classes_enabled = install.classes.enabled
        extender.delta_engine.classes_min_nodes = install.classes.min_nodes

    marker = UnschedulablePodMarker(
        api,
        node_informer,
        pod_informer,
        overhead,
        binpacker,
        timeout_seconds=install.unschedulable_pod_timeout_seconds,
        polling_interval_seconds=unschedulable_polling_interval,
    )

    server = Server(
        api=api,
        install=install,
        device=device,
        informer_factory=factory,
        pod_informer=pod_informer,
        node_informer=node_informer,
        rr_informer=rr_informer,
        resource_reservation_cache=rr_cache,
        lazy_demand_informer=lazy_demand_informer,
        demand_cache=demand_cache,
        demand_manager=demand_manager,
        soft_reservation_store=soft_store,
        pod_lister=pod_lister,
        resource_reservation_manager=rrm,
        overhead_computer=overhead,
        extender=extender,
        tensor_snapshot=tensor_snapshot,
        unschedulable_marker=marker,
        metrics=metrics,
        event_log=event_log,
        tracer=tracer,
        waste_reporter=waste_reporter,
        resilience=resilience_kit,
        provenance=provenance_tracker,
        capacity=capacity_sampler,
        lifecycle=lifecycle_ledger,
        slo=slo_engine,
    )
    server.reporters = ReporterSet(server)

    from ..scheduler import invariants

    if invariants.enabled():
        # wrap INSIDE the predicate lock so the check always sees
        # quiesced post-predicate state (no races with a concurrent
        # Filter call mid-mutation)
        original = extender._predicate_locked

        def checked_predicate_locked(args):
            result = original(args)
            invariants.check(server, raise_on_violation=False)
            return result

        extender._predicate_locked = checked_predicate_locked
    if start_background:
        server.start_background()
    return server
