"""The discrete-event simulation engine; a copy of the reference
package's ``sim/runner.py`` that runs the port's wiring on a device.

Builds the REAL wiring (testing/harness.py → server/wiring.py → embedded
API server + full extender stack), installs a :class:`~.clock.VirtualClock`
as the process time source, and replays a :class:`~.scenario.Scenario`:
app arrivals from the workload generator, retry ticks (the
kube-scheduler requeue analog), fault injections, delayed autoscaler
fulfillment, and app completions — auditing invariants after every
event and appending each event to a replayable log whose SHA-256 digest
is byte-identical for identical (scenario, seed).

Determinism contract (what the digest covers and why it is stable):

- virtual times only — wall-clock never enters the log (latencies go to
  the summary, which is NOT digested);
- object names from per-instance counters (harness/autoscaler) and the
  seeded workload;
- every event quiesces the async write-back queues before the state
  fingerprint is taken, so thread interleavings inside an event window
  cannot reorder observable state (a write counts as in flight until
  its worker has handled it, not only until it leaves the queue);
- the fingerprint excludes uids and resourceVersions (assigned in
  write-back-thread arrival order) but covers every scheduling-relevant
  field: bindings, reservations (hard + soft), demands, node state.

``Simulation(scenario, device=None)`` builds the harness on ``device``
(None = CUDA, raising where CUDA is missing, as every entry point of this
package does): the ``tpu-batch*`` queue solvers and the capacity
sampler's probe programs run there, so the same scenario and seed give
the same digest on the card and on the CPU.

One deliberate difference from the reference: ``kernel_fault``.  The
reference demotes the faulted lane to its host path
(``resilience/lanehealth.py``) and its decisions stay those of a clean
run.  This package has no lane to demote to (a kernel fault answers 500,
see ``resilience/__init__.py``): the hook raises
``ops.registry.KernelFault`` at the extender's two device lanes, the
fault propagates as a failed launch does, and ``_round`` records that
Filter's outcome as ``error`` — kube-scheduler's view of a 500: the pod
stays pending and is retried next round.  Any other exception out of a
Filter ends the run.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import timesource
from ..analysis import racecheck
from ..device import DeviceLike, resolve_device
from ..metrics import names as mnames
from ..ops import registry as ops_registry
from ..scheduler import labels as L
from ..scheduler.failover import sync_resource_reservations_and_demands
from ..testing.fake_autoscaler import FakeAutoscaler
from ..testing.harness import Harness
from ..types.objects import Demand, Node, Pod, ResourceReservation
from ..types.resources import Resources, usage_for_nodes
from .auditor import Auditor, Decision
from .clock import VirtualClock
from .scenario import FaultSpec, Scenario
from .workload import AppSpec, WorkloadGenerator

# virtual epoch: away from 0 so no timestamp is falsy (ensure_identity
# treats 0.0 as unset) and clearly not a real epoch in logs
SIM_EPOCH = 1_000_000.0


@dataclass
class _App:
    spec: AppSpec
    state: str = "pending"  # pending | running | done | dead
    driver_name: str = ""
    executor_template: Optional[Pod] = None
    next_exec_idx: int = 1
    executor_names: List[str] = field(default_factory=list)
    completion_scheduled: bool = False


@dataclass
class SimulationResult:
    digest: str
    summary: Dict
    event_log: List[Dict]
    violations: List[str]
    # capacity-observatory timeline (oldest first, JSON dicts) — the
    # chaos-CI artifact written as capacity.jsonl next to events.jsonl
    capacity_timeline: List[Dict] = field(default_factory=list)


class Simulation:
    def __init__(
        self,
        scenario: Scenario,
        bundle_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.scenario = scenario
        # where the harness runs its queue solvers and capacity probes
        self.device = resolve_device(device)
        # where the extender's flight recorder persists decision bundles
        # when a sim trigger fires (invariant violation); None keeps the
        # bundle ring in memory only
        self.bundle_dir = bundle_dir
        self._violations_seen = 0
        self.clock = VirtualClock(start=SIM_EPOCH)
        self._rng = random.Random(scenario.seed ^ 0xFA17)
        self._apps: Dict[str, _App] = {}
        self._log: List[Dict] = []
        self._latencies: List[float] = []
        self._queue_depths: List[int] = []
        self._efficiencies: List[float] = []
        self._seq = 0
        self._killed_nodes = 0
        self._scaler: Optional[FakeAutoscaler] = None
        self._capacity_samples: List = []
        self._pumps_scheduled: set = set()
        self.harness: Optional[Harness] = None
        self.auditor: Optional[Auditor] = None
        # policy engine bookkeeping (sc.policy non-empty): resolved
        # config, storm-app counter, evictions mirrored into _App
        # state, per-band driver decision counts
        self._policy_cfg = None
        self._storm_idx = 0
        self._evictions_reaped = 0
        self._band_outcomes: Dict[str, Dict[str, int]] = {}
        # SLO scorecard snapshotted at end-of-run while the virtual
        # clock is still installed (None when lifecycle is disabled)
        self._scorecard: Optional[Dict] = None

    # -- lifecycle ------------------------------------------------------------

    def run(self) -> SimulationResult:
        sc = self.scenario
        t_wall0 = time.perf_counter()
        timesource.set_source(self.clock.now)
        # span durations too: a sim trace is virtual end to end (the
        # clock never advances inside a handler, so sim span durations
        # are exactly 0 unless an event fires mid-span)
        timesource.set_perf_source(self.clock.now)
        try:
            self._build()
            self._seed_events()
            horizon = SIM_EPOCH + sc.duration
            while True:
                nxt = self.clock.peek_time()
                if nxt is None or nxt > horizon:
                    break
                self.clock.run_next()
            # drain: one final round + audit so the log always ends on
            # quiesced, audited state
            self._process("end", self._round("end"))
            self._snapshot_scorecard()
        finally:
            try:
                if self.harness is not None:
                    # disarm chaos hooks before teardown: they must never
                    # leak into the next in-process simulation/test
                    ops_registry.set_kernel_fault_hook(None)
                    self.harness.api.set_write_fault(None)
                    self.harness.close()
            finally:
                timesource.reset()
        wall_s = time.perf_counter() - t_wall0
        return self._result(wall_s)

    def _build(self) -> None:
        sc = self.scenario
        # under SCHEDLINT_RACECHECK=1 the sim doubles as a race hunt:
        # the harness enables the detector before wiring the server, and
        # chaos tests assert zero reports after the run
        racecheck.enable_if_env()
        extra_install = None
        if sc.policy or sc.ha or sc.concurrent or sc.classes:
            # thread the scenario's policy/ha/concurrent blocks into the
            # REAL wiring: the harness builds the same Install it would
            # by default, plus the policy engine / HA fabric /
            # concurrent admission engine (server/wiring.py)
            from ..config import (
                ClassesConfig,
                ConcurrentConfig,
                FifoConfig,
                HAConfig,
                Install,
                PolicyConfig,
            )

            kwargs = {}
            if sc.policy:
                self._policy_cfg = PolicyConfig.from_dict(sc.policy)
                kwargs["policy"] = self._policy_cfg
            if sc.ha:
                ha_cfg = HAConfig.from_dict(sc.ha)
                # presence of the block is the opt-in, and the sim owns
                # the election cadence: a wall-clock renewal thread
                # would race the virtual event stream
                ha_cfg.enabled = True
                ha_cfg.background = False
                kwargs["ha"] = ha_cfg
            if sc.concurrent:
                conc_cfg = ConcurrentConfig.from_dict(sc.concurrent)
                # presence of the block is the opt-in, mirroring ha
                conc_cfg.enabled = True
                kwargs["concurrent"] = conc_cfg
            if sc.classes:
                kwargs["classes"] = ClassesConfig.from_dict(sc.classes)
            extra_install = Install(
                fifo=sc.fifo,
                fifo_config=FifoConfig(),
                binpack_algo=sc.binpack_algo,
                **kwargs,
            )
        self.harness = Harness(
            binpack_algo=sc.binpack_algo,
            is_fifo=sc.fifo,
            extra_install=extra_install,
            # the marker thread would mutate pod conditions at wall-clock
            # instants (nondeterministic vs the event stream); scans are
            # sim-driven via unschedulable_scan_interval instead
            unschedulable_polling_interval=1e9,
            device=self.device,
        )
        sampler = getattr(self.harness.server, "capacity", None)
        if sampler is not None:
            # stopped BEFORE the first node event lands: capacity
            # sampling is driven by the event loop (post-quiesce,
            # seq-gated), never by the wall-clock background thread —
            # the summary's capacity columns and the timeline ring must
            # be a pure function of (scenario, seed)
            sampler.stop()
        ledger = getattr(self.harness.server, "lifecycle", None)
        if ledger is not None:
            # same contract as the capacity sampler: the lifecycle
            # ledger drains per sim event (seq-gated), never from its
            # wall-clock background thread
            ledger.stop()
        for i in range(sc.cluster.nodes):
            zone = sc.cluster.zones[i % len(sc.cluster.zones)]
            self.harness.new_node(
                f"node-{i + 1:03d}",
                cpu=sc.cluster.cpu,
                memory=sc.cluster.memory,
                gpu=sc.cluster.gpu,
                zone=zone,
                instance_group=sc.cluster.instance_group,
            )
        if sc.autoscaler.enabled:
            informer = self.harness.server.lazy_demand_informer.informer()
            self._scaler = FakeAutoscaler(
                self.harness.api,
                informer,
                node_cpu=sc.autoscaler.node_cpu,
                node_memory=sc.autoscaler.node_memory,
                node_gpu=sc.autoscaler.node_gpu,
                default_zone=sc.cluster.zones[0],
                fulfillment_delay=sc.autoscaler.delay,
                max_nodes=sc.autoscaler.max_nodes,
                deferred=True,  # determinism: fulfill only at virtual pumps
            )
        self.auditor = Auditor(self.harness.server)
        # first election at t0: prod wiring elects on its renewal thread
        # before traffic arrives; the sim's single replica must likewise
        # hold the lease (epoch 1) before the first write-back, or every
        # fenced write would refuse as never-elected
        self._step_ha()
        tracker = getattr(self.harness.server, "provenance", None)
        if tracker is not None and self.bundle_dir:
            tracker.recorder.out_dir = self.bundle_dir

    def _seed_events(self) -> None:
        sc = self.scenario
        apps = WorkloadGenerator(sc.workload, sc.seed).generate(sc.duration)
        self.workload = apps
        for app in apps:
            self.clock.schedule(
                SIM_EPOCH + app.arrival,
                f"arrival:{app.app_id}",
                lambda a=app: self._on_arrival(a),
            )
        for fault in sc.faults:
            self.clock.schedule(
                SIM_EPOCH + fault.at,
                f"fault:{fault.kind}",
                lambda f=fault: self._on_fault(f),
            )
        interval = max(sc.retry_interval, 0.5)
        t = interval
        while t < sc.duration:
            self.clock.schedule(SIM_EPOCH + t, "tick", self._on_tick)
            t += interval
        if sc.unschedulable_scan_interval > 0:
            t = sc.unschedulable_scan_interval
            while t < sc.duration:
                self.clock.schedule(SIM_EPOCH + t, "unschedulable-scan", self._on_unschedulable_scan)
                t += sc.unschedulable_scan_interval

    # -- event handlers -------------------------------------------------------

    def _on_arrival(self, spec: AppSpec) -> None:
        self._submit_app(spec)
        self._process(f"arrival:{spec.app_id}", self._round(f"arrival:{spec.app_id}"))

    def _submit_app(self, spec: AppSpec) -> None:
        h = self.harness
        if spec.dynamic:
            pods = h.dynamic_allocation_spark_pods(
                spec.app_id,
                spec.min_executor_count,
                spec.executor_count,
                driver_cpu=spec.driver_cpu,
                driver_mem=spec.driver_mem,
                executor_cpu=spec.executor_cpu,
                executor_mem=spec.executor_mem,
                instance_group=spec.instance_group,
                namespace=spec.namespace,
                creation_timestamp=self.clock.now(),
            )
        else:
            pods = h.static_allocation_spark_pods(
                spec.app_id,
                spec.executor_count,
                driver_cpu=spec.driver_cpu,
                driver_mem=spec.driver_mem,
                executor_cpu=spec.executor_cpu,
                executor_mem=spec.executor_mem,
                instance_group=spec.instance_group,
                namespace=spec.namespace,
                creation_timestamp=self.clock.now(),
            )
        driver, executors = pods[0], pods[1:]
        if self._policy_cfg is not None:
            # policy inputs ride on labels, exactly as production pods
            # would carry them (executor template keeps them so
            # replacements stay attributable)
            for pod in pods:
                pod.labels[self._policy_cfg.band_label] = spec.band
                if spec.tenant:
                    pod.labels[self._policy_cfg.tenant_label] = spec.tenant
        app = _App(spec=spec, driver_name=driver.name)
        app.executor_template = executors[0].deepcopy() if executors else None
        self._apps[spec.app_id] = app
        h.create_pod(driver)

    def _on_tick(self) -> None:
        # lease renewal rides the tick cadence (the sim's stand-in for
        # the prod renewal thread, on the virtual clock)
        self._step_ha()
        fulfilled = self._pump_autoscaler()
        decisions = self._round("tick")
        # empty ticks (no decisions, no scale-up) are audited but not
        # logged: the log stays a record of activity, and an idle tail
        # can't pad the digest
        if decisions or fulfilled:
            self._process("tick", decisions)
        else:
            self._audit_only("tick")

    def _on_scaler_pump(self, due: float) -> None:
        # NOTE: due stays in _pumps_scheduled — a capped demand keeps its
        # (now past) due time forever, and re-scheduling it would replay
        # the same instant endlessly (a virtual-time livelock).  Capped
        # demands are retried by the regular tick pump instead.
        fulfilled = self._pump_autoscaler()
        decisions = self._round("scale-up")
        if decisions or fulfilled:
            self._process("scale-up", decisions)

    def _on_unschedulable_scan(self) -> None:
        self.harness.server.unschedulable_marker.scan_for_unschedulable_pods()
        self._process("unschedulable-scan", [])

    def _on_complete(self, app_id: str) -> None:
        app = self._apps.get(app_id)
        if app is None or app.state != "running":
            return
        h = self.harness
        # executors terminate first, driver last (Spark teardown order);
        # deleting the driver cascades the RR + demands via owner GC
        names = [n for n in app.executor_names] + [app.driver_name]
        for name in names:
            pod = h.server.pod_informer.get(app.spec.namespace, name)
            if pod is None:
                continue
            if pod.node_name:
                h.terminate_pod(pod)
            h.api.delete(Pod.KIND, pod.namespace, pod.name)
        app.state = "done"
        self._process(f"complete:{app_id}", self._round(f"complete:{app_id}"))

    # -- faults ---------------------------------------------------------------

    def _on_fault(self, fault: FaultSpec) -> None:
        label = f"fault:{fault.kind}"
        if fault.kind == "node_kill":
            self._fault_node_kill(fault)
        elif fault.kind == "node_cordon":
            self._fault_cordon(fault, cordon=True)
        elif fault.kind == "node_uncordon":
            self._fault_cordon(fault, cordon=False)
        elif fault.kind == "executor_storm":
            self._fault_executor_storm(fault)
        elif fault.kind == "failover":
            self._fault_failover()
        elif fault.kind == "apiserver_outage":
            self._fault_apiserver(fault, mode="outage")
        elif fault.kind == "apiserver_latency":
            self._fault_apiserver(fault, mode="latency")
        elif fault.kind == "kernel_fault":
            self._fault_kernel(fault)
        elif fault.kind == "priority_storm":
            self._fault_priority_storm(fault)
        elif fault.kind == "leader_crash":
            self._fault_leader_crash(fault)
        elif fault.kind == "lease_partition":
            self._fault_lease_partition(fault)
        self._process(label, self._round(label))

    def _fault_node_kill(self, fault: FaultSpec) -> None:
        h = self.harness
        names = sorted(n.name for n in h.api.list(Node.KIND))
        victims = self._rng.sample(names, min(fault.count, len(names)))
        for victim in sorted(victims):
            # driver deaths tear whole apps down first
            for pod in sorted(h.api.list(Pod.KIND), key=lambda p: p.name):
                if pod.node_name != victim:
                    continue
                if pod.labels.get(L.SPARK_ROLE_LABEL) == L.DRIVER:
                    self._kill_app(pod.labels.get(L.SPARK_APP_ID_LABEL, ""))
            # surviving pods on the node are executor deaths
            for pod in sorted(h.api.list(Pod.KIND), key=lambda p: p.name):
                if pod.node_name != victim:
                    continue
                if pod.labels.get(L.SPARK_ROLE_LABEL) == L.EXECUTOR:
                    self._kill_executor(pod, replace=True)
            h.api.delete(Node.KIND, "default", victim)
            self._killed_nodes += 1

    def _fault_cordon(self, fault: FaultSpec, cordon: bool) -> None:
        h = self.harness
        candidates = sorted(
            n.name for n in h.api.list(Node.KIND) if n.unschedulable != cordon
        )
        victims = self._rng.sample(candidates, min(fault.count, len(candidates)))
        for name in sorted(victims):
            fresh = h.api.get(Node.KIND, "default", name)
            fresh.unschedulable = cordon
            h.api.update(fresh)

    def _fault_executor_storm(self, fault: FaultSpec) -> None:
        h = self.harness
        running = sorted(
            app_id for app_id, a in self._apps.items() if a.state == "running"
        )
        targets = self._rng.sample(running, min(fault.apps, len(running)))
        for app_id in sorted(targets):
            app = self._apps[app_id]
            bound = [
                p
                for name in sorted(app.executor_names)
                if (p := h.server.pod_informer.get(app.spec.namespace, name)) is not None
                and p.node_name
            ]
            if not bound:
                continue
            k = max(1, int(len(bound) * fault.fraction))
            victims = self._rng.sample([p.name for p in bound], k)
            # simultaneous deaths, then simultaneous replacements — the
            # tombstone race shape in state/softreservations.py
            for name in sorted(victims):
                pod = h.server.pod_informer.get(app.spec.namespace, name)
                if pod is not None:
                    self._kill_executor(pod, replace=False)
            for _ in sorted(victims):
                self._spawn_replacement_executor(app)

    def _fault_failover(self) -> None:
        """A leader change: the in-memory (intentionally unpersisted)
        soft-reservation state is lost; the new leader's first act is
        failover reconciliation rebuilding it from cluster state."""
        server = self.harness.server
        extender = server.extender
        soft = server.soft_reservation_store
        for app_id in sorted(soft.get_all_soft_reservations_copy()):
            soft.remove_driver_reservation(app_id)
        with extender._predicate_lock:
            sync_resource_reservations_and_demands(extender)

    # faulted kinds: the scheduler's OWN write-back traffic (CRDs).  The
    # runner's Node/Pod mutations and server-side owner GC stay up — the
    # fault models the scheduler's client losing the API server, not the
    # cluster's control plane disappearing wholesale
    _FAULTED_KINDS = frozenset({"ResourceReservation", "Demand"})

    def _fault_apiserver(self, fault: FaultSpec, mode: str) -> None:
        """Start an API-server write-fault window; the clearing event is
        a scheduled clock event so recovery is deterministic."""
        from ..kube.errors import APIError

        kinds = self._FAULTED_KINDS
        if mode == "outage":

            def inject(op, kind, ns, name):
                if kind in kinds:
                    return APIError(f"injected apiserver outage ({op} {kind} {ns}/{name})")
                return None

        else:
            # latency spike as the client observes it: every key's FIRST
            # write attempt times out, the retry lands.  Per-key (not a
            # global counter) so the failing set is independent of worker
            # thread interleaving — the digest stays reproducible.
            seen: set = set()

            def inject(op, kind, ns, name):
                if kind in kinds and (op, kind, ns, name) not in seen:
                    seen.add((op, kind, ns, name))
                    return APIError(
                        f"injected apiserver latency: client timeout ({op} {kind})"
                    )
                return None

        self.harness.api.set_write_fault(inject)
        self.clock.schedule(
            self.clock.now() + fault.duration,
            f"fault-clear:apiserver_{mode}",
            lambda m=mode: self._on_apiserver_fault_clear(m),
        )

    def _on_apiserver_fault_clear(self, mode: str) -> None:
        self.harness.api.set_write_fault(None)
        self._recover_writeback()
        label = f"fault-clear:apiserver_{mode}"
        self._process(label, self._round(label))

    def _recover_writeback(self) -> None:
        """Deterministic recovery: force the breaker's probe window open
        and replay the intent journal until it drains (the first probe's
        success closes the breaker, which re-enqueues the rest)."""
        cache = self.harness.server.resource_reservation_cache
        h = self.harness
        for _ in range(6):
            if cache.journal_depth() == 0:
                break
            cache.nudge_recovery(force=True)
            h.wait_for_api(
                lambda: not any(cache.inflight_queue_lengths()), timeout=10.0
            )

    def _fault_kernel(self, fault: FaultSpec) -> None:
        """Arm the kernel chaos hook for the window: every device-lane
        entry raises ``KernelFault``, which propagates out of the Filter
        as a failed launch does; ``_round`` records it as ``error``."""
        until = self.clock.now() + fault.duration

        def inject(lane):
            if self.clock.now() < until:
                return ops_registry.KernelFault(f"injected kernel fault ({lane})")
            return None

        ops_registry.set_kernel_fault_hook(inject)
        self.clock.schedule(
            until,
            "fault-clear:kernel_fault",
            lambda: ops_registry.set_kernel_fault_hook(None),
        )

    def _fault_priority_storm(self, fault: FaultSpec) -> None:
        """Burst of ``count`` fresh applications in the fault's band at
        the fault instant: on a saturated cluster, the queue-jump +
        gang-atomic-preemption pressure shape the policy engine exists
        for.  Shapes draw from the scenario's workload ranges off the
        fault rng, so the storm is deterministic under the seed."""
        sc = self.scenario
        wl = sc.workload
        exec_lo = int(wl.get("executors", {}).get("min", 1))
        exec_hi = int(wl.get("executors", {}).get("max", 4))
        life_lo = float(wl.get("lifetime", {}).get("min", 60.0))
        life_hi = float(wl.get("lifetime", {}).get("max", 600.0))
        for _ in range(max(fault.count, 1)):
            self._storm_idx += 1
            count = self._rng.randint(exec_lo, exec_hi)
            spec = AppSpec(
                app_id=f"storm-{self._storm_idx:03d}",
                arrival=self.clock.now() - SIM_EPOCH,
                executor_count=count,
                min_executor_count=count,
                lifetime=round(self._rng.uniform(life_lo, life_hi), 3),
                instance_group=wl.get("instance_group", sc.cluster.instance_group),
                band=fault.band,
            )
            self._submit_app(spec)

    # -- HA faults (ha/) ------------------------------------------------------

    def _step_ha(self) -> None:
        """One election/renewal round on the virtual clock (no-op when
        the scenario carries no ``ha`` block)."""
        fabric = getattr(self.harness.server, "ha", None)
        if fabric is not None:
            fabric.step()

    def _fault_leader_crash(self, fault: FaultSpec) -> None:
        """A rival replica CAS-steals the lease at epoch+1: the resident
        fabric observes its deposition on the next step and every fenced
        write refuses (intents divert to the journal, unacked).  The
        rival's lease runs for ``duration``; at the clearing event it
        has expired, the resident re-acquires at epoch+2 — running full
        takeover reconciliation — and the diverted intents replay."""
        from ..ha.lease import HISTORY_LIMIT

        fabric = getattr(self.harness.server, "ha", None)
        if fabric is None:
            return
        lease = fabric.elector.peek()
        if lease is None:
            return
        now = self.clock.now()
        rival = lease.deepcopy()
        rival.holder = "chaos-rival"
        rival.epoch = lease.epoch + 1
        rival.acquired_at = now
        rival.renewed_at = now
        rival.duration_seconds = fault.duration
        rival.history.append([rival.epoch, rival.holder, now])
        del rival.history[:-HISTORY_LIMIT]
        self.harness.api.update(rival)
        # deposition is observed here, not at the next tick: the crash
        # instant and the refusal window start at the same virtual time
        self._step_ha()
        self.clock.schedule(
            now + fault.duration + 1.0,
            "fault-clear:leader_crash",
            self._on_leader_crash_clear,
        )

    def _on_leader_crash_clear(self) -> None:
        # the rival's lease has expired: this step re-acquires at
        # epoch+2, which runs takeover reconciliation (journal replay +
        # CRD/pod diff) via the fabric's on_elected hook — then the
        # write-back drain replays whatever the fenced window diverted
        self._step_ha()
        self._recover_writeback()
        label = "fault-clear:leader_crash"
        self._process(label, self._round(label))

    def _fault_lease_partition(self, fault: FaultSpec) -> None:
        """The replica loses the coordination API for ``duration``:
        every Lease write fails, so renewals lapse and ``is_leader()``
        self-demotes on TTL (readiness drops) before any rival is even
        observed.  Fenced writes still read-through the (unchanged)
        lease and keep landing at the held epoch — fencing, not the TTL,
        is the split-brain guard.  Heals at the window's end."""
        from ..kube.errors import APIError

        if getattr(self.harness.server, "ha", None) is None:
            return

        def inject(op, kind, ns, name):
            if kind == "Lease":
                return APIError(f"injected lease partition ({op} {ns}/{name})")
            return None

        self.harness.api.set_write_fault(inject)
        self.clock.schedule(
            self.clock.now() + fault.duration,
            "fault-clear:lease_partition",
            self._on_lease_partition_clear,
        )

    def _on_lease_partition_clear(self) -> None:
        self.harness.api.set_write_fault(None)
        # renewal works again: re-assert leadership at the same epoch
        # (no rival ran, so no takeover) and drain any diverted intents
        self._step_ha()
        self._recover_writeback()
        label = "fault-clear:lease_partition"
        self._process(label, self._round(label))

    def _kill_app(self, app_id: str) -> None:
        app = self._apps.get(app_id)
        h = self.harness
        if app is None:
            return
        for name in [app.driver_name] + list(app.executor_names):
            pod = h.server.pod_informer.get(app.spec.namespace, name)
            if pod is not None:
                try:
                    h.api.delete(Pod.KIND, pod.namespace, pod.name)
                except Exception:
                    pass
        app.state = "dead"

    def _kill_executor(self, pod: Pod, replace: bool) -> None:
        h = self.harness
        app = self._apps.get(pod.labels.get(L.SPARK_APP_ID_LABEL, ""))
        try:
            h.api.delete(Pod.KIND, pod.namespace, pod.name)
        except Exception:
            return
        if app is not None:
            if pod.name in app.executor_names:
                app.executor_names.remove(pod.name)
            if replace and app.state == "running":
                self._spawn_replacement_executor(app)

    def _spawn_replacement_executor(self, app: _App) -> None:
        """Spark submits a fresh executor pod (new name) to replace a
        dead one; the extender must re-claim the now-unbound reservation
        (or a soft spot for DA extras)."""
        if app.executor_template is None:
            return
        idx = app.spec.executor_count + app.next_exec_idx
        app.next_exec_idx += 1
        pod = app.executor_template.deepcopy()
        pod.meta.name = f"{app.spec.app_id}-exec-{idx}"
        pod.meta.creation_timestamp = self.clock.now()
        pod.meta.resource_version = 0
        pod.meta.uid = ""
        pod.node_name = ""
        self.harness.create_pod(pod)
        app.executor_names.append(pod.meta.name)

    # -- scheduling rounds ----------------------------------------------------

    def _pump_autoscaler(self) -> int:
        if self._scaler is None:
            return 0
        return self._scaler.process_due(self.clock.now())

    def _round(self, label: str) -> List[Decision]:
        """One kube-scheduler requeue pass: pending drivers oldest-first
        (the queue order FIFO assumes), then pending executors."""
        h = self.harness
        decisions: List[Decision] = []
        node_names = sorted(n.name for n in h.api.list(Node.KIND))
        if not node_names:
            return decisions

        ig_label = h.server.install.instance_group_label

        def attempt(pod: Pod, role: str) -> str:
            t0 = time.perf_counter()
            try:
                result = h.schedule(pod, node_names)
            except ops_registry.KernelFault:
                # the Filter answered 500: nothing bound, retried next round
                result = None
            dt = time.perf_counter() - t0
            self._latencies.append(dt)
            h.server.metrics.histogram(mnames.SIM_DECISION_LATENCY, dt)
            if result is None:
                outcome = "error"
            elif result.node_names:
                outcome = "success"
            else:
                outcome = "failure"
            if result is not None and not result.node_names and result.failed_nodes:
                # all failed_nodes share one message; surface its outcome class
                msg = next(iter(result.failed_nodes.values()))
                outcome = self._classify_failure(msg)
            group = pod.node_affinity.get(ig_label) or [""]
            band, band_rank = "", 0
            if self._policy_cfg is not None and role == "driver":
                band = pod.labels.get(
                    self._policy_cfg.band_label, self._policy_cfg.default_band
                )
                band_rank = self._policy_cfg.bands.get(band, 0)
                bucket = self._band_outcomes.setdefault(
                    band, {"success": 0, "refused": 0}
                )
                bucket["success" if outcome == "success" else "refused"] += 1
            decisions.append(
                Decision(
                    pod_name=pod.name,
                    role=role,
                    instance_group=group[0],
                    created=pod.creation_timestamp,
                    outcome=outcome,
                    node=result.node_names[0] if result is not None and result.node_names else "",
                    band=band,
                    band_rank=band_rank,
                )
            )
            return outcome

        pending_drivers = sorted(
            (
                p
                for p in h.api.list(Pod.KIND)
                if p.labels.get(L.SPARK_ROLE_LABEL) == L.DRIVER
                and not p.node_name
                and p.meta.deletion_timestamp is None
            ),
            key=lambda p: (p.creation_timestamp, p.name),
        )
        for driver in pending_drivers:
            outcome = attempt(driver, "driver")
            app = self._apps.get(driver.labels.get(L.SPARK_APP_ID_LABEL, ""))
            if outcome == "success" and app is not None and app.state == "pending":
                self._materialize_executors(app)

        pending_executors = sorted(
            (
                p
                for p in h.api.list(Pod.KIND)
                if p.labels.get(L.SPARK_ROLE_LABEL) == L.EXECUTOR
                and not p.node_name
                and p.meta.deletion_timestamp is None
            ),
            key=lambda p: (p.creation_timestamp, p.name),
        )
        for executor in pending_executors:
            attempt(executor, "executor")

        self._check_completions()
        return decisions

    def _materialize_executors(self, app: _App) -> None:
        """Driver bound → Spark starts requesting executors (fresh pods
        stamped at the bind instant, not app arrival)."""
        h = self.harness
        app.state = "running"
        spec = app.spec
        count = spec.executor_count
        if app.executor_template is None:
            return
        for i in range(count):
            pod = app.executor_template.deepcopy()
            pod.meta.name = f"{spec.app_id}-exec-{i + 1}"
            pod.meta.creation_timestamp = self.clock.now()
            pod.meta.resource_version = 0
            pod.meta.uid = ""
            pod.node_name = ""
            h.create_pod(pod)
            app.executor_names.append(pod.meta.name)

    def _check_completions(self) -> None:
        h = self.harness
        for app_id in sorted(self._apps):
            app = self._apps[app_id]
            if app.state != "running" or app.completion_scheduled:
                continue
            driver = h.server.pod_informer.get(app.spec.namespace, app.driver_name)
            if driver is None or not driver.node_name:
                continue
            bound = sum(
                1
                for name in app.executor_names
                if (p := h.server.pod_informer.get(app.spec.namespace, name)) is not None
                and p.node_name
            )
            need = app.spec.min_executor_count if app.spec.dynamic else app.spec.executor_count
            if bound >= need:
                app.completion_scheduled = True
                self.clock.schedule_in(
                    app.spec.lifetime,
                    f"complete:{app_id}",
                    lambda a=app_id: self._on_complete(a),
                )

    @staticmethod
    def _classify_failure(message: str) -> str:
        m = message.lower()
        if "earlier" in m:
            from ..scheduler.extender import FAILURE_EARLIER_DRIVER

            return FAILURE_EARLIER_DRIVER
        if "fit" in m or "capacity" in m or "reserve" in m:
            return "failure-fit"
        return "failure"

    # -- audit + log ----------------------------------------------------------

    def _process(self, label: str, decisions: List[Decision]) -> None:
        """Quiesce → audit → append one event-log entry."""
        self._quiesce(label)
        self.auditor.check_round(decisions, label)
        self.auditor.check_state(label)
        self._reap_evictions()
        self._fire_invariant_trigger(label)
        self._schedule_scaler_pumps()
        self._sample_capacity(label)
        self._drain_ledger(label)
        # one API listing per kind per event, shared by the depth gauge,
        # the log entry, and the fingerprint (APIServer.list deepcopies
        # every object — repeating it per consumer multiplied the sim's
        # dominant per-event cost)
        pods = self.harness.api.list(Pod.KIND)
        nodes = self.harness.api.list(Node.KIND)
        depth = sum(
            1
            for p in pods
            if p.labels.get(L.SPARK_ROLE_LABEL) == L.DRIVER and not p.node_name
        )
        self._queue_depths.append(depth)
        self.harness.server.metrics.gauge(mnames.SIM_QUEUE_DEPTH, float(depth))
        eff = self._packing_efficiency()
        if eff is not None:
            self._efficiencies.append(eff)
        entry = {
            "seq": self._seq,
            "t": round(self.clock.now() - SIM_EPOCH, 6),
            "event": label,
            "decisions": [
                {"pod": d.pod_name, "role": d.role, "outcome": d.outcome, "node": d.node}
                for d in decisions
            ],
            "queue_depth": depth,
            "nodes": len(nodes),
            "state": self._state_fingerprint(pods, nodes),
        }
        if eff is not None:
            entry["packing_efficiency"] = round(eff, 6)
        self._seq += 1
        self._log.append(entry)

    def _reap_evictions(self) -> None:
        """Mirror policy evictions into the sim's app bookkeeping: the
        coordinator already deleted the victim's bound pods + RR; clean
        up its still-pending pods and mark the app evicted so
        completions and later rounds track post-eviction truth.  Runs
        AFTER the auditor's policy checks — the reap must never mask a
        partial-gang eviction from I-P1."""
        engine = getattr(self.harness.server, "policy", None)
        if engine is None or engine.coordinator is None:
            return
        st = engine.coordinator.state()
        fresh = st["evictionsTotal"] - self._evictions_reaped
        if fresh <= 0:
            return
        self._evictions_reaped = st["evictionsTotal"]
        for ev in list(st["recent"])[-fresh:]:
            app_id = ev["app"]
            self._kill_app(app_id)
            app = self._apps.get(app_id)
            if app is not None:
                app.state = "evicted"

    def _audit_only(self, label: str) -> None:
        self._quiesce(label)
        self.auditor.check_state(label)
        self._fire_invariant_trigger(label)
        self._schedule_scaler_pumps()
        self._sample_capacity(label)
        self._drain_ledger(label)

    def _drain_ledger(self, label: str) -> None:
        """One lifecycle-ledger drain per state-changing event
        (seq-gated inside the ledger, so idle events are O(1)) —
        always post-quiesce and never under the predicate lock."""
        ledger = getattr(self.harness.server, "lifecycle", None)
        if ledger is None:
            return
        ledger.maybe_drain(trigger=f"sim:{label}")

    def _snapshot_scorecard(self) -> None:
        """Build the SLO scorecard at end-of-run, while the virtual
        clock is still the process time source — ``_result`` runs after
        ``timesource.reset()``, when burn-rate windows would evaluate
        against wall-clock and every virtual sample would look ancient."""
        ledger = getattr(self.harness.server, "lifecycle", None)
        slo = getattr(self.harness.server, "slo", None)
        if ledger is None or slo is None:
            return
        from ..lifecycle import build_scorecard

        ledger.maybe_drain(trigger="sim:scorecard")
        self._scorecard = build_scorecard(
            ledger,
            slo,
            meta={
                "source": "sim",
                "scenario": self.scenario.name,
                "seed": self.scenario.seed,
            },
            now=self.clock.now(),
        )

    def _sample_capacity(self, label: str) -> None:
        """One capacity-observatory sample per state-changing event
        (seq-gated inside the sampler, so idle events are O(1)) —
        always post-quiesce and never under the predicate lock."""
        sampler = getattr(self.harness.server, "capacity", None)
        if sampler is None:
            return
        sample = sampler.maybe_sample(trigger=f"sim:{label}")
        if sample is not None:
            self._capacity_samples.append(sample)

    def _fire_invariant_trigger(self, label: str) -> None:
        """An invariant violation is a flight-recorder trigger: persist
        the recent decision bundles so the violating decision replays
        outside the sim (provenance/recorder.py)."""
        n = len(self.auditor.violations)
        if n <= self._violations_seen:
            return
        fresh = self.auditor.violations[self._violations_seen:n]
        self._violations_seen = n
        tracker = getattr(self.harness.server, "provenance", None)
        if tracker is not None:
            tracker.on_trigger("sim-invariant", f"{label}: {fresh[0]}")

    def _quiesce(self, label: str) -> None:
        h = self.harness
        ok = h.wait_quiesced(timeout=30.0)
        demand_cache = h.server.demand_cache
        ok2 = h.wait_for_api(
            lambda: not any(demand_cache.inflight_queue_lengths()), timeout=30.0
        )
        if not (ok and ok2):
            self.auditor.violations.append(
                f"Q0[{label}]: async write-back failed to quiesce"
            )

    def _schedule_scaler_pumps(self) -> None:
        """Turn pending delayed demands into clock events at their due
        instants (checked post-quiesce so the pending set is stable)."""
        if self._scaler is None:
            return
        for due in self._scaler.due_times():
            # each due instant gets exactly ONE pump event, ever (the set
            # is never drained): zero-delay demands fire as the very next
            # event (clock.schedule clamps past instants to now), and a
            # capped demand whose due has passed waits for the next tick
            # pump rather than respinning the same virtual instant
            if due not in self._pumps_scheduled:
                self._pumps_scheduled.add(due)
                self.clock.schedule(due, "scale-up", lambda d=due: self._on_scaler_pump(d))

    def _packing_efficiency(self) -> Optional[float]:
        """Mean over occupied nodes of the max-dimension
        reserved/allocatable ratio (hard + soft reservations) — the
        sim-level packing signal the summary reports."""
        h = self.harness
        usage = usage_for_nodes(h.server.resource_reservation_cache.list())
        for node, res in h.server.soft_reservation_store.used_soft_reservation_resources().items():
            usage[node] = usage.get(node, Resources.zero()).add(res)
        nodes = {n.name: n for n in h.server.node_informer.list()}
        ratios = []
        for name, used in sorted(usage.items()):
            node = nodes.get(name)
            if node is None:
                continue
            dims = []
            for dim in ("cpu", "memory", "nvidia_gpu"):
                alloc = getattr(node.allocatable, dim).exact
                if alloc > 0:
                    dims.append(float(getattr(used, dim).exact / alloc))
            if dims:
                ratios.append(max(dims))
        if not ratios:
            return None
        return sum(ratios) / len(ratios)

    def _state_fingerprint(self, pods: List[Pod], nodes: List[Node]) -> str:
        """SHA-256 over the canonical serialization of every
        scheduling-relevant field of quiesced cluster state."""
        api = self.harness.api
        soft = self.harness.server.soft_reservation_store.get_all_soft_reservations_copy()
        state = {
            "nodes": sorted(
                [
                    n.name,
                    sorted(n.labels.items()),
                    [str(n.allocatable.cpu.exact), str(n.allocatable.memory.exact), str(n.allocatable.nvidia_gpu.exact)],
                    bool(n.unschedulable),
                    bool(n.ready),
                ]
                for n in nodes
            ),
            "pods": sorted(
                [p.namespace, p.name, p.labels.get(L.SPARK_ROLE_LABEL, ""), p.node_name, p.phase]
                for p in pods
            ),
            "reservations": sorted(
                [
                    rr.namespace,
                    rr.name,
                    sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                    sorted(rr.status.pods.items()),
                ]
                for rr in api.list(ResourceReservation.KIND)
            ),
            "soft": sorted(
                [app_id, sorted((name, r.node) for name, r in sr.reservations.items()),
                 sorted(sr.status.items())]
                for app_id, sr in soft.items()
            ),
            "demands": sorted(
                [
                    d.namespace,
                    d.name,
                    d.status.phase,
                    [[str(u.resources.cpu.exact), str(u.resources.memory.exact), u.count] for u in d.spec.units],
                ]
                for d in api.list(Demand.KIND)
            ),
        }
        blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- results --------------------------------------------------------------

    def _result(self, wall_s: float) -> SimulationResult:
        blob = "\n".join(
            json.dumps(e, sort_keys=True, separators=(",", ":")) for e in self._log
        )
        digest = hashlib.sha256(blob.encode()).hexdigest()
        lat = sorted(self._latencies)

        def pct(q: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(q * len(lat)))] * 1000.0

        states = [a.state for a in self._apps.values()]
        summary = {
            "scenario": self.scenario.name,
            "seed": self.scenario.seed,
            "sim_duration_s": self.scenario.duration,
            "wall_duration_s": round(wall_s, 3),
            "sim_speedup": round(self.scenario.duration / wall_s, 1) if wall_s > 0 else None,
            "events_logged": len(self._log),
            "events_audited": self.auditor.events_audited if self.auditor else 0,
            "decisions": len(self._latencies),
            "decisions_per_sec_wall": round(len(self._latencies) / wall_s, 1) if wall_s > 0 else None,
            "decision_latency_ms": {
                "p50": round(pct(0.50), 3),
                "p95": round(pct(0.95), 3),
                "p99": round(pct(0.99), 3),
                "max": round(lat[-1] * 1000.0, 3) if lat else 0.0,
            },
            "apps": {
                "arrived": len(self._apps),
                "completed": states.count("done"),
                "running_at_end": states.count("running"),
                "pending_at_end": states.count("pending"),
                "killed": states.count("dead"),
                "evicted": states.count("evicted"),
            },
            "queue_depth": {
                "max": max(self._queue_depths, default=0),
                "mean": round(sum(self._queue_depths) / len(self._queue_depths), 2)
                if self._queue_depths
                else 0.0,
                "final": self._queue_depths[-1] if self._queue_depths else 0,
            },
            "packing_efficiency": {
                "mean": round(sum(self._efficiencies) / len(self._efficiencies), 4)
                if self._efficiencies
                else None,
                "final": round(self._efficiencies[-1], 4) if self._efficiencies else None,
            },
            "nodes": {
                "initial": self.scenario.cluster.nodes,
                "scaled_up": self._scaler.created_nodes if self._scaler else 0,
                "killed": self._killed_nodes,
                "capped_demands": len(self._scaler.capped) if self._scaler else 0,
            },
            "invariant_violations": len(self.auditor.violations) if self.auditor else -1,
            "digest": digest,
        }
        summary["capacity"] = self._capacity_summary()
        summary["waste_phases"] = self._waste_summary()
        summary["contention"] = self._contention_summary()
        policy = self._policy_summary()
        if policy is not None:
            summary["policy"] = policy
        ha = self._ha_summary()
        if ha is not None:
            summary["ha"] = ha
        if self._scorecard is not None:
            summary["slo"] = self._scorecard
        sampler = getattr(self.harness.server, "capacity", None) if self.harness else None
        timeline = (
            [s.to_dict() for s in sampler.timeline()] if sampler is not None else []
        )
        return SimulationResult(
            digest=digest,
            summary=summary,
            event_log=self._log,
            violations=list(self.auditor.violations) if self.auditor else [],
            capacity_timeline=timeline,
        )

    def _ha_summary(self) -> Optional[Dict]:
        """Failover scorecard: the ``/status/ha`` payload at quiesce
        (terminal epoch, fence refusal/stale-commit counters, full lease
        succession history).  Summary-only, like the policy scorecard."""
        fabric = (
            getattr(self.harness.server, "ha", None)
            if self.harness is not None
            else None
        )
        if fabric is None:
            return None
        return fabric.status()

    def _policy_summary(self) -> Optional[Dict]:
        """Eviction scorecard: who got evicted and why, per-band driver
        decision counts, DRF tenant shares — the policy/ columns of the
        sim summary.  Summary-only; the digest never sees it (whatif
        timings are wall-clock in production runs)."""
        engine = (
            getattr(self.harness.server, "policy", None)
            if self.harness is not None
            else None
        )
        if engine is None:
            return None
        st = engine.state()
        out: Dict = {
            "ordering": st["ordering"],
            "backfill": st["backfill"],
            "preemption_enabled": st["preemptionEnabled"],
            "bands": st["bands"],
            "band_outcomes": {
                b: dict(c) for b, c in sorted(self._band_outcomes.items())
            },
            "tenants": st["tenants"],
        }
        pre = st.get("preemption")
        if pre is not None:
            out["evictions"] = {
                "total": pre["evictionsTotal"],
                "victims": pre["victimsTotal"],
                "journal_depth": pre["journalDepth"],
                "whatif": pre.get("whatif", {}),
                "scorecard": [
                    {
                        "app": ev["app"],
                        "band": ev["band"],
                        "tenant": ev["tenant"],
                        "pods": ev["pods"],
                        "reason": ev["reason"],
                        "replayed": ev["replayed"],
                        "at": round(ev["at"] - SIM_EPOCH, 3),
                    }
                    for ev in pre["recent"]
                ],
            }
        return out

    def _contention_summary(self) -> Optional[Dict]:
        """Contention scorecard columns: the extender predicate lock's
        wait/hold distributions plus the per-request critical-path ring.
        Read straight off the harness server's own instances (never the
        process-global lock registry — parallel tests would cross-bleed).
        Wait/hold numbers are real wall-clock, so they live in the
        summary only — the digest never sees them."""
        if self.harness is None:
            return None
        lock = getattr(self.harness.server.extender, "_predicate_lock", None)
        analyzer = getattr(self.harness.server, "criticalpath", None)
        if lock is None and analyzer is None:
            return None
        out: Dict = {}
        if lock is not None and hasattr(lock, "snapshot"):
            snap = lock.snapshot()
            out["predicate_lock"] = {
                "acquisitions": snap["acquisitions"],
                "contended": snap["contended"],
                "wait_ms_p95": snap["waitMs"]["p95"],
                "wait_ms_max": snap["waitMs"]["max"],
                "hold_ms_p95": snap["holdMs"]["p95"],
                "top_blockers": snap["topBlockers"][:3],
            }
        if analyzer is not None:
            out["criticalpath"] = analyzer.summary()
        return out or None

    def _capacity_summary(self) -> Optional[Dict]:
        """Fragmentation / headroom / queue-pressure percentiles over the
        event-driven capacity samples — the first ROADMAP-5 scorecard
        columns.  Virtual-time-deterministic: every input is integer
        state math on post-quiesce snapshots."""
        samples = self._capacity_samples
        if not samples:
            return None

        def pct(values, q):
            if not values:
                return 0.0
            ordered = sorted(values)
            return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

        frag = [max(s.frag_index) for s in samples]
        headroom = [
            max((i["headroom"] for i in s.headroom.values()), default=0)
            for s in samples
        ]
        pressure = [s.pressure for s in samples]
        sampler = getattr(self.harness.server, "capacity", None)
        stats = sampler.stats() if sampler is not None else {}
        return {
            "samples": len(samples),
            "probe_lane": samples[-1].probe_lane,
            "probe_solves": sum(s.probe_solves for s in samples),
            "lock_violations": stats.get("lock_violations", 0),
            "timeline_ring": stats.get("ring", len(samples)),
            "fragmentation_max_dim": {
                "p50": round(pct(frag, 0.50), 6),
                "p95": round(pct(frag, 0.95), 6),
                "max": round(max(frag), 6),
                "final": round(frag[-1], 6),
            },
            "headroom_executors": {
                "p50": pct(headroom, 0.50),
                "p95": pct(headroom, 0.95),
                "min": min(headroom),
                "final": headroom[-1],
            },
            "queue_pressure": {
                "p50": pct(pressure, 0.50),
                "max": max(pressure),
                "final": pressure[-1],
            },
        }

    def _waste_summary(self) -> Dict:
        """WasteMetricsReporter phase durations (virtual-time seconds)
        folded in next to the capacity columns."""
        registry = self.harness.server.metrics
        out = {}
        for waste_type in (
            "before-demand-creation",
            "after-demand-fulfilled",
            "total-time-no-demand",
        ):
            snap = registry.get_histogram(
                mnames.SCHEDULING_WASTE, {mnames.TAG_WASTE_TYPE: waste_type}
            )
            if snap["count"]:
                out[waste_type] = {
                    "count": snap["count"],
                    "mean_s": round(snap["mean"], 6),
                    "p50_s": round(snap["p50"], 6),
                    "max_s": round(snap["max"], 6),
                }
        return out
