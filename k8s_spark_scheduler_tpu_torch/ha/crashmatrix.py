"""Crash-point matrix (the reference package's ``ha/crashmatrix.py``):
kill the scheduler at every registered crash point, cold-restart a
successor on the same API server + journal files, and prove recovery
restores every invariant.

One matrix cell = one full lifecycle:

1. fresh embedded API server + durable journal dir; incarnation A boots
   with the HA fabric enabled and wins the lease (epoch 1);
2. the cell's scenario drives real traffic through the path the crash
   point lives on (write-back create, journal divert, journal ack,
   whole-app preemption, lease renewal) with the point armed — the
   point fires :class:`~.crashpoint.SimulatedCrash` (a BaseException,
   so no ``except Exception`` handler can save the incarnation: the
   thread it fires on is dead, exactly like ``kill -9`` landing
   mid-instruction);
3. incarnation A is hard-killed — background threads reaped, **no**
   graceful lease step-down, no journal flush beyond what already hit
   the file line-by-line;
4. incarnation B boots on the same API server and journal path: boot
   replay runs unfenced, the lease TTL lapses, B acquires epoch+1 and
   runs full takeover reconciliation (:mod:`.reconcile`);
5. the audit: scheduler invariants I1–I5 green, both journals drained,
   the victim of a mid-preemption crash fully evicted (never
   half-evicted), zero stale-epoch commits.

Exactly-once is the point: whatever instant the process died, each
reservation intent and each eviction lands exactly once across the
restart — replayed if the ack was lost, never doubled if the write
already landed.

Every incarnation's server runs on ``device`` (None = CUDA, which
raises on a host without it; ``--device cpu`` from the command line)
under ``binpack_algo`` (the reference's ``tightly-pack`` by default;
``tpu-batch`` serves every cell's driver Filter through the delta-solve
session on ``device``).
The reference's cells also run its concurrent admission engine; this
package does not have one yet (ROADMAP A.4), so its cells run the serial
extender and the three ``concurrent.*`` points are refused.  Sweep the
other ten against the failover scenario's cluster shape::

    python -m k8s_spark_scheduler_tpu_torch.ha.crashmatrix --device cpu \\
        --scenario examples/sim/failover.json --json report.json

``--handoff`` runs the complementary *planned* chaos cell instead: two
live replicas on one API server, the leader steps down (rolling
restart), the standby takes over at epoch+1 and the deposed replica's
fenced write paths must refuse 100% of writes.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import HAConfig, Install, PolicyConfig, ResilienceConfig
from ..device import DeviceLike
from ..kube.apiserver import APIServer
from ..kube.crd import DEMAND_CRD_NAME, demand_crd_spec
from ..kube.errors import APIError
from ..policy.victims import VictimCandidate, VictimPlan
from ..scheduler import invariants
from ..server.wiring import init_server_with_clients
from ..testing.harness import Harness
from ..types.extenderapi import ExtenderArgs
from ..types.objects import Node, ObjectMeta, Pod, PodPhase, ResourceReservation
from ..types.resources import ZONE_LABEL, Resources
from . import crashpoint
from .crashpoint import SimulatedCrash
from .fencing import StaleEpochError

# lease TTL for matrix incarnations: short so the successor's takeover
# wait is bounded (the TTL is wall-clock by contract)
_LEASE_TTL_S = 0.3

_PREEMPT_POINTS = {
    crashpoint.PREEMPT_POST_JOURNAL,
    crashpoint.PREEMPT_MID_EXECUTE,
    crashpoint.PREEMPT_PRE_ACK,
}
# points that need a divert first (write failures push the intent into
# the journal, which is where the append points live)
_DIVERT_POINTS = {
    crashpoint.JOURNAL_PRE_APPEND,
    crashpoint.JOURNAL_POST_APPEND,
}
# the reference's speculation→commit window points (its concurrent
# admission engine, not in this package yet): refused here
_CONCURRENT_POINTS = {
    crashpoint.CONCURRENT_SPECULATION_SOLVED,
    crashpoint.CONCURRENT_COMMIT_REVALIDATED,
    crashpoint.CONCURRENT_COMMIT_WRITTEN,
}
# the points this package's cells run: every registered one but those
PORTED_POINTS = tuple(p for p in crashpoint.registered_points() if p not in _CONCURRENT_POINTS)


def _wait(cond, timeout: float = 10.0, tick: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)  # cells run on real threads and a wall-clock lease TTL
    return False


class CrashMatrix:
    """Runs the cells; one instance per matrix sweep."""

    def __init__(
        self,
        nodes: int = 3,
        node_cpu: str = "16",
        node_memory: str = "32Gi",
        lease_name: str = "tpu-gang-scheduler",
        device: DeviceLike = None,
        binpack_algo: str = "tightly-pack",
    ):
        self.nodes = nodes
        self.node_cpu = node_cpu
        self.node_memory = node_memory
        self.lease_name = lease_name
        self.device = device
        self.binpack_algo = binpack_algo

    # -- incarnation lifecycle -------------------------------------------

    def _install(self, identity: str, journal_path: str) -> Install:
        return Install(
            fifo=True,
            binpack_algo=self.binpack_algo,
            resilience=ResilienceConfig(journal_path=journal_path),
            policy=PolicyConfig(enabled=True, preemption_enabled=True),
            ha=HAConfig(
                enabled=True,
                background=False,
                lease_name=self.lease_name,
                lease_duration_seconds=_LEASE_TTL_S,
                identity=identity,
            ),
        )

    def _boot(self, api: APIServer, identity: str, journal_path: str):
        server = init_server_with_clients(
            api,
            self._install(identity, journal_path),
            start_background=True,
            demand_poll_interval=0.02,
            unschedulable_polling_interval=1e9,
            device=self.device,
        )
        server.lazy_demand_informer.wait_ready(5)
        return server

    @staticmethod
    def _hard_kill(server) -> None:
        """kill -9 analog: reap the background threads so the dead
        incarnation cannot keep mutating the shared API server from
        beyond the grave, but NO graceful lease step-down and no
        journal housekeeping — the successor finds exactly what a real
        crash leaves behind."""
        server.ha = None  # skip stop()'s graceful step_down/handoff
        server.stop()

    # -- scenario primitives ---------------------------------------------

    def _seed_nodes(self, api: APIServer) -> None:
        for i in range(self.nodes):
            api.create(
                Node(
                    meta=ObjectMeta(
                        name=f"node-{i + 1:03d}",
                        labels={
                            ZONE_LABEL: "zone1",
                            "resource_channel": "batch-medium-priority",
                        },
                    ),
                    allocatable=Resources.of(self.node_cpu, self.node_memory, "0"),
                    ready=True,
                )
            )

    @staticmethod
    def _schedule_app(server, api: APIServer, app_id: str, executors: int = 2) -> List[str]:
        """Submit + schedule one gang through the real extender; binds
        successes exactly as the kube-scheduler would.  Returns bound
        pod names."""
        pods = Harness.static_allocation_spark_pods(app_id, executors)
        for pod in pods:
            api.create(pod)
        node_names = sorted(n.name for n in api.list(Node.KIND))
        bound = []
        for pod in pods:
            fresh = api.get(Pod.KIND, pod.namespace, pod.name)
            result = server.extender.predicate(
                ExtenderArgs(pod=fresh, node_names=list(node_names))
            )
            if result.node_names:
                landed = api.get(Pod.KIND, pod.namespace, pod.name)
                landed.node_name = result.node_names[0]
                landed.phase = PodPhase.RUNNING
                api.update(landed)
                bound.append(landed.name)
        return bound

    @staticmethod
    def _drain(server, timeout: float = 10.0) -> bool:
        """Drive the write-back + journal to empty (post-recovery)."""
        cache = server.resource_reservation_cache

        def settled():
            if any(cache.inflight_queue_lengths()):
                return False
            if cache.journal_depth() != 0:
                cache.nudge_recovery(force=True)
                return False
            return True

        return _wait(settled, timeout=timeout)

    # -- one matrix cell -------------------------------------------------

    def run_point(self, point: str) -> Dict:
        if point in _CONCURRENT_POINTS:
            raise ValueError(
                f"crash point {point!r} lies in the concurrent admission engine, which this "
                "package does not have yet: ROADMAP A.4"
            )
        journal_dir = tempfile.mkdtemp(prefix="crashmatrix-")
        journal_path = f"{journal_dir}/intents.jsonl"
        api = APIServer()
        api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        report: Dict = {"point": point, "crashed": False, "ok": False}
        server_a = server_b = None
        try:
            server_a = self._boot(api, "replica-a", journal_path)
            self._seed_nodes(api)
            server_a.ha.step()  # epoch 1
            report["crashed"] = self._drive(server_a, api, point, report)
            # the lease must lapse before B can steal it; A never
            # steps down (it is dead)
            kill_at = time.monotonic()
            self._hard_kill(server_a)
            server_a = None
            remaining = _LEASE_TTL_S + 0.2 - (time.monotonic() - kill_at)
            if remaining > 0:
                time.sleep(remaining)  # waiting out the dead leader's wall-clock lease TTL

            server_b = self._boot(api, "replica-b", journal_path)
            elected = _wait(server_b.ha.step, timeout=5.0, tick=0.05)
            report["recovered"] = elected
            report["recoveredEpoch"] = server_b.ha.fence.epoch()
            self._drain(server_b)
            self._audit(server_b, api, point, report)
        finally:
            crashpoint.disarm()
            api.set_write_fault(None)
            for server in (server_a, server_b):
                if server is not None:
                    try:
                        server.stop()
                    except Exception:
                        pass
            shutil.rmtree(journal_dir, ignore_errors=True)
        return report

    def _drive(self, server, api: APIServer, point: str, report: Dict) -> bool:
        """Arm the point and push traffic through its path; returns
        whether the crash actually fired."""
        if point in _PREEMPT_POINTS:
            # a running victim whose whole-gang eviction will crash
            # mid-commit; the successor must finish it exactly once
            victim_pods = self._schedule_app(server, api, "victim-app")
            report["victimPods"] = victim_pods
            self._drain(server)
            crashpoint.arm(point)
            plan = VictimPlan(
                preemptor_app="matrix-preemptor",
                preemptor_band="high",
                victims=[
                    VictimCandidate(
                        namespace="default",
                        app_id="victim-app",
                        band="low",
                        band_rank=0,
                        tenant="",
                        created=0.0,
                        freed=np.zeros((self.nodes, 3), dtype=np.int64),
                        pods=victim_pods,
                    )
                ],
                whatif_ms=0.0,
                lane="matrix",
            )
            try:
                server.policy.coordinator.commit(plan)
            except SimulatedCrash:
                return True
            return False

        if point == crashpoint.LEASE_PRE_RENEW:
            self._schedule_app(server, api, "app-001")
            self._drain(server)
            crashpoint.arm(point)
            try:
                server.ha.step()
            except SimulatedCrash:
                return True
            return False

        if point in _DIVERT_POINTS or point == crashpoint.JOURNAL_POST_ACK:
            # the append points live on the divert path: fail the RR
            # writes so the worker journals the intent (and dies there).
            # post-ack needs one more beat — ack() only reaches it when
            # a journaled intent actually lands, so the crash is armed
            # for the REPLAY's ack, not the divert
            def inject(op, kind, ns, name):
                if kind == ResourceReservation.KIND:
                    return APIError(f"injected write failure ({op} {ns}/{name})")
                return None

            if point in _DIVERT_POINTS:
                crashpoint.arm(point)
            api.set_write_fault(inject)
            self._schedule_app(server, api, "app-001")
            cache = server.resource_reservation_cache
            fired = _wait(
                lambda: crashpoint.armed() is None
                if point in _DIVERT_POINTS
                else cache.journal_depth() > 0
            )
            api.set_write_fault(None)
            if point == crashpoint.JOURNAL_POST_ACK:
                if not fired:
                    return False
                crashpoint.arm(point)
                cache.nudge_recovery(force=True)
                fired = _wait(lambda: crashpoint.armed() is None)
            return fired

        # write-back commit and journal-ack points fire on the worker
        # thread during the very first reservation write
        crashpoint.arm(point)
        self._schedule_app(server, api, "app-001")
        return _wait(lambda: crashpoint.armed() is None)

    def _audit(self, server, api: APIServer, point: str, report: Dict) -> None:
        violations = [str(v) for v in invariants.check(server, raise_on_violation=False)]
        cache = server.resource_reservation_cache
        report["journalDepth"] = cache.journal_depth()
        coord = server.policy.coordinator if server.policy is not None else None
        report["evictJournalDepth"] = coord.journal_depth() if coord is not None else 0
        report["staleCommits"] = server.ha.fence.stale_commits()
        if point in _PREEMPT_POINTS:
            # exactly-once eviction: no half-evicted gang survives the
            # crash — reservation gone AND every victim pod gone
            if cache.get("default", "victim-app") is not None:
                violations.append("victim-app still holds a reservation")
            from ..kube.errors import NotFoundError

            for name in report.get("victimPods", ()):
                try:
                    api.get(Pod.KIND, "default", name)
                except NotFoundError:
                    continue
                violations.append(f"victim pod {name} still exists")
        if report["journalDepth"] != 0:
            violations.append(f"{report['journalDepth']} write intents still pending")
        if report["evictJournalDepth"] != 0:
            violations.append(f"{report['evictJournalDepth']} evict intents still pending")
        if report["staleCommits"] != 0:
            violations.append(f"{report['staleCommits']} stale-epoch commits")
        if not report.get("recovered"):
            violations.append("successor failed to acquire leadership")
        report["violations"] = violations
        report["ok"] = report["crashed"] and not violations

    # -- two-replica graceful handoff ------------------------------------

    def run_handoff(self) -> Dict:
        """Chaos cell for the *planned* path: two live replicas share
        one API server; the leader steps down (rolling restart), the
        standby must take over at epoch+1 and the deposed replica's
        write paths must refuse 100% of writes with zero stale-epoch
        commits.  The unplanned (kill -9) path is :meth:`run_point`."""
        journal_dir = tempfile.mkdtemp(prefix="crashmatrix-handoff-")
        api = APIServer()
        api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        report: Dict = {"cell": "two-replica-handoff", "ok": False}
        violations: List[str] = []
        server_a = server_b = None
        try:
            server_a = self._boot(api, "replica-a", f"{journal_dir}/a.jsonl")
            self._seed_nodes(api)
            server_a.ha.step()  # replica-a wins epoch 1
            if not server_a.ha.is_leader():
                violations.append("replica-a failed to win the initial election")
            self._schedule_app(server_a, api, "app-pre-handoff")
            self._drain(server_a)

            server_b = self._boot(api, "replica-b", f"{journal_dir}/b.jsonl")
            server_b.ha.step()  # standby: observes epoch 1, stays follower
            if server_b.ha.is_leader():
                violations.append("standby replica-b claimed leadership under a live lease")

            # planned handoff: a releases, b acquires epoch 2, a's next
            # step observes the newer epoch and fences itself
            server_a.ha.elector.step_down()
            if not server_b.ha.step():
                violations.append("replica-b failed to take over after step-down")
            server_a.ha.step()
            report["handoffEpoch"] = server_b.ha.fence.epoch()
            if report["handoffEpoch"] != 2:
                violations.append(f"expected takeover at epoch 2, got {report['handoffEpoch']}")
            if server_a.ha.is_leader():
                violations.append("deposed replica-a still reports leadership")

            # the deposed replica must refuse every fenced write path
            refusals_before = sum(server_a.ha.fence.state()["refusals"].values())
            for op in ("writeback.create", "writeback.update", "writeback.delete",
                       "demand.create", "preempt.commit"):
                try:
                    server_a.ha.writer.check(op)
                    violations.append(f"deposed replica-a write {op!r} was NOT fenced")
                except StaleEpochError:
                    pass
            refused = sum(server_a.ha.fence.state()["refusals"].values()) - refusals_before
            report["deposedRefusals"] = refused

            # the new leader schedules real work on the shared cluster
            bound = self._schedule_app(server_b, api, "app-post-handoff")
            if not bound:
                violations.append("new leader replica-b failed to schedule")
            if not self._drain(server_b):
                violations.append("replica-b write-back did not drain")
            violations.extend(
                str(v) for v in invariants.check(server_b, raise_on_violation=False)
            )
            report["staleCommits"] = {}
            for name, server in (("replica-a", server_a), ("replica-b", server_b)):
                stale = server.ha.fence.stale_commits()
                report["staleCommits"][name] = stale
                if stale:
                    violations.append(f"{name}: {stale} stale-epoch commits")
        finally:
            for server in (server_a, server_b):
                if server is not None:
                    try:
                        server.stop()
                    except Exception:
                        pass
            shutil.rmtree(journal_dir, ignore_errors=True)
        report["violations"] = violations
        report["ok"] = not violations
        return report

    # -- the sweep -------------------------------------------------------

    def run_matrix(self, points: Optional[List[str]] = None) -> Dict:
        points = list(points or PORTED_POINTS)
        cells = [self.run_point(p) for p in points]
        return {
            "points": {c["point"]: c for c in cells},
            "ok": all(c["ok"] for c in cells),
        }


def matrix_for(scenario_path: Optional[str] = None, device: DeviceLike = None) -> CrashMatrix:
    """The matrix for a sim scenario: the cluster shape and lease name
    from its ``cluster`` / ``ha`` blocks (at most 6 nodes), so the sweep
    exercises the topology the chaos scenario runs; the defaults
    without one."""
    nodes, cpu, memory = 3, "16", "32Gi"
    lease_name = "tpu-gang-scheduler"
    if scenario_path:
        with open(scenario_path) as f:
            sc = json.load(f)
        cluster = sc.get("cluster", {})
        nodes = min(int(cluster.get("nodes", nodes)), 6)
        cpu = str(cluster.get("cpu", cpu))
        memory = str(cluster.get("memory", memory))
        lease_name = sc.get("ha", {}).get("lease-name", lease_name)
    return CrashMatrix(
        nodes=nodes, node_cpu=cpu, node_memory=memory, lease_name=lease_name, device=device
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Sweep the HA crash-point matrix and audit recovery."
    )
    parser.add_argument("--scenario", default=None, help="sim scenario JSON (cluster shape + lease name)")
    parser.add_argument("--json", dest="json_out", default=None, help="write the full report here")
    parser.add_argument("--points", default=None, help="comma-separated subset of crash points")
    parser.add_argument("--device", default=None, help="where the servers run (default: cuda)")
    parser.add_argument(
        "--handoff",
        action="store_true",
        help="run the two-replica graceful-handoff chaos cell instead of the crash matrix",
    )
    args = parser.parse_args(argv)
    matrix = matrix_for(args.scenario, args.device)
    if args.handoff:
        report = matrix.run_handoff()
        report["scenario"] = args.scenario or "builtin"
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        status = "ok" if report["ok"] else "FAILED"
        detail = "" if report["ok"] else f"  {'; '.join(report['violations'])}"
        print(f"handoff: {status} epoch={report.get('handoffEpoch', '?')} "
              f"refusals={report.get('deposedRefusals', '?')}{detail}")
        return 0 if report["ok"] else 1
    points = args.points.split(",") if args.points else None
    report = matrix.run_matrix(points)
    report["scenario"] = args.scenario or "builtin"
    for name, cell in sorted(report["points"].items()):
        status = "ok" if cell["ok"] else "FAIL"
        detail = "" if cell["ok"] else f"  {'; '.join(cell.get('violations', []))}"
        print(f"{name:24s} crash={'yes' if cell['crashed'] else 'NO':3s} "
              f"epoch={cell.get('recoveredEpoch', '?')} {status}{detail}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    print(f"matrix: {'ok' if report['ok'] else 'FAILED'} "
          f"({len(report['points'])} points)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
