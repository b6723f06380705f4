"""Per-event invariant auditing; a copy of the reference package's
``sim/auditor.py``.

After every simulated event (post-quiesce, so async write-back has
drained and the local caches agree with the API server) the auditor
runs:

1. the full ``scheduler/invariants.py`` suite (I1–I5: reservation⇄pod
   consistency, no double-binding, soft-reservation hygiene, **no node
   over-commit**, tensor-mirror exactness);
2. FIFO-order checks over the scheduling round's decisions: the runner
   attempts pending drivers in strict (creation, app_id) order — the
   order kube-scheduler's queue would present them — and a round where
   an earlier same-instance-group driver was refused with
   ``failure-earlier-driver`` while a LATER driver succeeded is an
   order inversion (a later driver succeeding after an earlier one
   fails ``failure-fit`` is legitimate: the FIFO feasibility pass
   reserves the earlier gang's space, it doesn't hard-block the queue);
3. demand hygiene: after quiesce, every Demand's owner pod must still
   exist and still be unscheduled — a demand surviving its pod's
   scheduling means the inline delete AND DemandGC both missed it, a
   demand for a deleted pod means owner GC missed it (the "demands
   created/deleted exactly when the reference would" check in
   observable terms).

When the server carries a policy engine (``Install.policy.enabled``)
the audit widens to the policy invariants:

- **I-P1** — no partial-gang eviction: an app the preemption
  coordinator reports evicted must hold no ResourceReservation and no
  still-bound pod (the victim unit is the whole application);
- **I-P2** — bounded priority inversion: with a priority ordering and
  backfill disabled, a lower-band driver never succeeds in a round
  after a higher-band driver was refused ``failure-earlier-driver``;
- **I-P3** — starvation freedom: backfill never jumps past a refused
  driver older than ``starvation_age_seconds``;
- **I-P4** — every eviction journaled: the evict journal is empty
  post-quiesce (each committed eviction was journaled, executed, and
  acked — a pending intent after quiesce is a lost/unacked eviction);

and the FIFO F1 check becomes band-aware: within a band the queue is
still FIFO, across bands priority order replaces arrival order.

When the server carries an HA fabric (``Install.ha.enabled``) the
audit widens again:

- **I-H1** — at most one fenced writer per epoch: the lease history's
  epochs are strictly increasing with one holder each, the live fence
  never holds an epoch above the lease's (a self-granted token), and a
  replica claiming leadership is the lease's recorded holder;
- **I-H2** — no acked intent lost across takeover: journaled intents
  never carry an epoch the fabric has not observed (a future-stamped
  record would replay against the wrong leadership term; the
  exactly-once replay itself is J1/J2 plus the crash matrix);
- **I-H3** — no write committed with a stale epoch: the fence's
  stale-commit witness counter is zero (by construction; nonzero means
  a fenced write landed after a newer epoch was observed).

Violations accumulate in ``violations`` (the run fails its acceptance
bar when non-empty) and are counted into the PR 1 metrics registry
under the catalog name ``…tpu.sim.audit.violations.count``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .. import timesource
from ..demands.manager import pod_name_from_demand
from ..metrics import names as mnames
from ..scheduler import invariants
from ..scheduler import labels as L
from ..scheduler.extender import FAILURE_EARLIER_DRIVER
from ..types.objects import Demand, Pod, ResourceReservation


@dataclass
class Decision:
    """One predicate outcome inside a scheduling round."""

    pod_name: str
    role: str  # "driver" | "executor"
    instance_group: str
    created: float
    outcome: str  # success | the failure-* outcomes
    node: str = ""
    # policy runs only: the driver's priority band (policy/classes.py)
    band: str = ""
    band_rank: int = 0


class Auditor:
    def __init__(self, server, metrics=None):
        self._server = server
        self._metrics = metrics if metrics is not None else server.metrics
        self._policy = getattr(server, "policy", None)
        self.violations: List[str] = []
        self.events_audited = 0

    # -- per-round decision checks -------------------------------------------

    def check_round(self, decisions: List[Decision], label: str) -> None:
        """FIFO-order audit over one scheduling round's driver decisions."""
        drivers = [d for d in decisions if d.role == "driver"]
        # the runner must present drivers oldest-first (per group the
        # arrival order IS the FIFO order); a mis-sorted round would
        # make every downstream FIFO conclusion vacuous, so audit it
        by_group: dict = {}
        for d in drivers:
            by_group.setdefault(d.instance_group, []).append(d)
        for group, ds in by_group.items():
            keys = [(d.created, d.pod_name) for d in ds]
            if keys != sorted(keys):
                self._violate(
                    f"F0[{label}]: round attempted {group} drivers out of arrival order: {keys}"
                )
            ordering = (
                self._policy.config.ordering if self._policy is not None else "fifo"
            )
            if ordering != "fifo":
                self._check_policy_round(group, ds, label)
                continue
            blocked_behind_earlier = None
            for d in ds:
                if d.outcome == FAILURE_EARLIER_DRIVER and blocked_behind_earlier is None:
                    blocked_behind_earlier = d
                elif blocked_behind_earlier is not None and d.outcome == "success":
                    self._violate(
                        f"F1[{label}]: driver {d.pod_name} succeeded after earlier "
                        f"driver {blocked_behind_earlier.pod_name} (same group "
                        f"{group}) was refused with failure-earlier-driver"
                    )

    def _check_policy_round(self, group: str, ds: List[Decision], label: str) -> None:
        """Band-aware ordering audit for non-FIFO policy orderings.
        Within a band the queue is still FIFO; across bands a
        higher-band success after a lower-band refusal is the POINT of
        priority ordering, while the reverse is an inversion — legal
        only through the conservative backfill probe (I-P2), and never
        past the refused driver's starvation age (I-P3)."""
        cfg = self._policy.config
        refused: List[Decision] = []
        for d in ds:
            if d.outcome == FAILURE_EARLIER_DRIVER:
                refused.append(d)
                continue
            if d.outcome != "success":
                continue
            for r in refused:
                if d.band_rank > r.band_rank:
                    continue  # priority order doing its job
                if not cfg.backfill:
                    kind = "F1" if d.band_rank == r.band_rank else "I-P2"
                    self._violate(
                        f"{kind}[{label}]: driver {d.pod_name} (band {d.band}) "
                        f"succeeded after driver {r.pod_name} (band {r.band}, "
                        f"group {group}) was refused failure-earlier-driver "
                        f"with backfill disabled"
                    )
                elif timesource.now() - r.created >= cfg.starvation_age_seconds:
                    self._violate(
                        f"I-P3[{label}]: backfill admitted {d.pod_name} (band "
                        f"{d.band}) past {r.pod_name} (band {r.band}), which has "
                        f"been starving for >= {cfg.starvation_age_seconds}s"
                    )

    # -- per-event state checks ----------------------------------------------

    def check_state(self, label: str) -> None:
        """Invariants I1–I5 + demand hygiene against quiesced state."""
        self.events_audited += 1
        for v in invariants.check(self._server, raise_on_violation=False):
            self._violate(f"{v} [{label}]")
        self._check_demand_hygiene(label)
        self._check_lost_intents(label)
        self._check_policy_state(label)
        self._check_ha(label)
        self._metrics.gauge(mnames.SIM_AUDIT_EVENTS, float(self.events_audited))

    def _check_demand_hygiene(self, label: str) -> None:
        api = self._server.api
        pods = {(p.namespace, p.name): p for p in api.list(Pod.KIND)}
        for demand in api.list(Demand.KIND):
            pod_name = pod_name_from_demand(demand)
            pod = pods.get((demand.namespace, pod_name))
            if pod is None:
                self._violate(
                    f"D1[{label}]: demand {demand.name} outlives its pod {pod_name}"
                )
            elif pod.node_name:
                self._violate(
                    f"D2[{label}]: demand {demand.name} still present after pod "
                    f"{pod_name} was scheduled to {pod.node_name}"
                )

    def _check_lost_intents(self, label: str) -> None:
        """Zero-lost-reservation-intents (resilience/): after quiesce,
        every reservation the scheduler admitted against must either be
        at the API server or be covered by a pending intent-journal
        entry (J1) — and symmetrically, a reservation the scheduler
        deleted locally must be gone from the API server or have its
        delete journaled (J2).  A key in neither place is an intent the
        write-back layer silently lost."""
        server = self._server
        kit = getattr(server, "resilience", None)
        pending = kit.journal.pending_keys() if kit is not None else set()
        api_keys = {
            (rr.namespace, rr.name)
            for rr in server.api.list(ResourceReservation.KIND)
        }
        local_keys = {
            (rr.namespace, rr.name)
            for rr in server.resource_reservation_cache.list()
        }
        for key in sorted(local_keys - api_keys - pending):
            self._violate(
                f"J1[{label}]: reservation {key} admitted locally but neither "
                f"written to the API server nor journaled (lost intent)"
            )
        for key in sorted(api_keys - local_keys - pending):
            self._violate(
                f"J2[{label}]: reservation {key} deleted locally but still at "
                f"the API server with no journaled delete (lost intent)"
            )

    def _check_policy_state(self, label: str) -> None:
        """I-P1 + I-P4 against quiesced state.  Runs BEFORE the
        runner's eviction reap, so a partial eviction cannot be masked
        by the sim's own cleanup."""
        engine = self._policy
        if engine is None or engine.coordinator is None:
            return
        st = engine.coordinator.state()
        if st["journalDepth"] != 0:
            self._violate(
                f"I-P4[{label}]: {st['journalDepth']} evict intents still "
                f"pending post-quiesce (eviction executed without ack, or "
                f"journaled and never executed)"
            )
        evicted = {(e["namespace"], e["app"]) for e in st["recent"]}
        if not evicted:
            return
        rr_keys = {
            (rr.namespace, rr.name)
            for rr in self._server.resource_reservation_cache.list()
        }
        for key in sorted(evicted & rr_keys):
            self._violate(
                f"I-P1[{label}]: evicted app {key} still holds a "
                f"ResourceReservation (partial-gang eviction)"
            )
        evicted_apps = {app for _, app in evicted}
        for pod in self._server.api.list(Pod.KIND):
            app = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
            if app in evicted_apps and pod.node_name:
                self._violate(
                    f"I-P1[{label}]: pod {pod.name} of evicted app {app} is "
                    f"still bound to {pod.node_name} (partial-gang eviction)"
                )

    def _check_ha(self, label: str) -> None:
        """I-H1..I-H3 against the HA fabric (see module docstring)."""
        fabric = getattr(self._server, "ha", None)
        if fabric is None:
            return
        lease = fabric.elector.peek()
        if lease is not None:
            epochs = [h[0] for h in lease.history]
            if any(b <= a for a, b in zip(epochs, epochs[1:])):
                self._violate(
                    f"I-H1[{label}]: lease history epochs not strictly "
                    f"increasing: {epochs}"
                )
            if epochs and lease.epoch != epochs[-1]:
                self._violate(
                    f"I-H1[{label}]: lease epoch {lease.epoch} != last "
                    f"history epoch {epochs[-1]}"
                )
            if fabric.fence.epoch() > lease.epoch:
                self._violate(
                    f"I-H1[{label}]: fence holds epoch {fabric.fence.epoch()} "
                    f"above the lease's {lease.epoch} (self-granted token)"
                )
            if fabric.is_leader() and lease.holder != fabric.elector.identity:
                self._violate(
                    f"I-H1[{label}]: replica {fabric.elector.identity!r} "
                    f"claims leadership but the lease is held by "
                    f"{lease.holder!r}"
                )
        kit = getattr(self._server, "resilience", None)
        if kit is not None:
            highest = fabric.fence.highest_observed()
            for rec in kit.journal.pending():
                epoch = rec.get("epoch")
                if epoch is not None and epoch > highest:
                    self._violate(
                        f"I-H2[{label}]: journaled intent {rec['ns']}/"
                        f"{rec['name']} stamped epoch {epoch} above any "
                        f"observed epoch ({highest})"
                    )
        stale = fabric.fence.stale_commits()
        if stale:
            self._violate(
                f"I-H3[{label}]: {stale} write(s) committed with a stale "
                f"epoch"
            )

    def _violate(self, message: str) -> None:
        self.violations.append(message)
        self._metrics.counter(mnames.SIM_AUDIT_VIOLATIONS)
