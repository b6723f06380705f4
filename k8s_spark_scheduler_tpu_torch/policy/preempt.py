"""Journaled eviction commit: evict-intents persisted BEFORE any
delete, replayed exactly-once across failover (the reference package's
``policy/preempt.py``).

The coordinator owns a dedicated intent journal (``<journal>.evict`` —
same JSONL format as the write-back journal, separate file so RR
recovery and eviction recovery never ack each other's intents; a
journal the reference package wrote replays here).  Commit
order per victim application:

1. journal the evict intent (pods + reason + preemptor) — durable
   before the first delete;
2. delete every bound pod of the victim (NotFound tolerated: a pod
   already gone is an eviction already half-landed — replay-safe);
3. delete the victim's ResourceReservation through the write-back
   cache (which journals its own delete in the RR journal);
4. ack the evict intent.

A crash between 1 and 4 leaves the intent pending; the standby's
:meth:`PreemptionCoordinator.recover` replays it idempotently — every
step tolerates "already done" — and acks, so each eviction lands
exactly once across a mid-eviction failover (tests/test_torch_policy.py,
tests/test_torch_ha_crashpoints.py).  With HA on, wiring installs the
fencing gate (``install_fence``): a deposed leader's commit is refused
before it journals, and its journal's acks are fenced too.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional

from .. import timesource
from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..ha import crashpoint
from ..kube.errors import NotFoundError
from ..resilience.journal import IntentJournal
from ..types.objects import Pod
from .victims import VictimPlan

EVICT_KIND = "PolicyEviction"
EVICT_JOURNAL_SUFFIX = ".evict"


@guarded_by("_lock", "_recent", "_evicted_total", "_victims_total")
class PreemptionCoordinator:
    """Commits validated victim plans through the evict journal and
    keeps the bounded recent-evictions ring for ``/policy/state``."""

    def __init__(
        self,
        api,
        rr_cache,
        journal_path: Optional[str] = None,
        metrics=None,
        provenance=None,
        recent_limit: int = 64,
    ):
        self._api = api
        self._rr_cache = rr_cache
        self._metrics = metrics
        self._provenance = provenance
        path = journal_path + EVICT_JOURNAL_SUFFIX if journal_path else None
        self._journal = IntentJournal(path, metrics=None)
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=max(int(recent_limit), 1))
        self._evicted_total = 0
        self._victims_total = 0
        # HA fencing gate (ha/fencing.FencedWriter), installed by server
        # wiring: a deposed leader may not journal, execute, or ack
        # evictions
        self.fence_gate = None

    def install_fence(self, gate) -> None:
        self.fence_gate = gate
        self._journal.fence_gate = gate
        self._journal.epoch_source = gate.fence.epoch

    # -- commit ---------------------------------------------------------

    def commit(self, plan: VictimPlan) -> List[str]:
        """Evict every victim in ``plan``; returns the app ids actually
        evicted.  Intents for ALL victims are journaled before the
        first delete, so a crash at any point leaves a replayable
        record of the full plan — never a half-planned preemption."""
        gate = self.fence_gate
        if gate is not None:
            # refuse the whole plan up front: a deposed leader must not
            # even journal evict intents (the successor plans its own)
            gate.check("preempt.commit")
        reason = (
            f"preempted by {plan.preemptor_app} "
            f"(band {plan.preemptor_band}, {plan.lane} what-if)"
        )
        for v in plan.victims:
            self._journal.record(
                "delete",
                EVICT_KIND,
                v.namespace,
                v.app_id,
                {
                    "pods": list(v.pods),
                    "reason": reason,
                    "preemptor": plan.preemptor_app,
                    "band": v.band,
                    "tenant": v.tenant,
                },
            )
        crashpoint.maybe_crash(crashpoint.PREEMPT_POST_JOURNAL)
        evicted = []
        for v in plan.victims:
            self._execute(v.namespace, v.app_id, v.pods)
            crashpoint.maybe_crash(crashpoint.PREEMPT_PRE_ACK)
            self._journal.ack("delete", v.namespace, v.app_id)
            if gate is not None:
                gate.commit()
            evicted.append(v.app_id)
            self._note_eviction(
                ns=v.namespace,
                app_id=v.app_id,
                band=v.band,
                tenant=v.tenant,
                pods=len(v.pods),
                reason=reason,
                replayed=False,
            )
        self._stamp(plan, evicted)
        return evicted

    def _execute(self, ns: str, app_id: str, pods: List[str]) -> None:
        """Idempotent eviction of one whole application: every step
        tolerates already-done, which is what makes replay exactly-once
        in effect."""
        for pod in pods:
            try:
                self._api.delete(Pod.KIND, ns, pod)
            except NotFoundError:
                pass
        # the half-evicted-gang window: pods gone, reservation still
        # present — exactly what takeover reconciliation must finish
        crashpoint.maybe_crash(crashpoint.PREEMPT_MID_EXECUTE)
        try:
            self._rr_cache.delete(ns, app_id)
        except NotFoundError:
            pass

    # -- failover replay ------------------------------------------------

    def recover(self) -> int:
        """Replay pending evict intents (crash between journal and
        ack).  Called at wiring boot on the active AND by the standby
        after takeover; idempotent execution + ack = exactly-once."""
        gate = self.fence_gate
        if gate is not None:
            # replay executes deletes: a deposed replica must not
            # re-drive evictions the successor may have superseded.
            # Boot-time recover runs before the fence is installed
            # (gate is None); post-takeover recover runs after the
            # lease grant, so a live leader always passes.
            gate.check("preempt.recover")
        replayed = 0
        for intent in self._journal.pending():
            if intent.get("kind") != EVICT_KIND or intent.get("op") != "delete":
                continue
            obj = intent.get("obj") or {}
            ns, app_id = intent["ns"], intent["name"]
            self._execute(ns, app_id, list(obj.get("pods", ())))
            self._journal.ack("delete", ns, app_id)
            self._note_eviction(
                ns=ns,
                app_id=app_id,
                band=obj.get("band", ""),
                tenant=obj.get("tenant", ""),
                pods=len(obj.get("pods", ())),
                reason=obj.get("reason", "replayed evict intent"),
                replayed=True,
            )
            replayed += 1
        return replayed

    def journal_depth(self) -> int:
        return self._journal.depth()

    def close(self) -> None:
        self._journal.close()

    # -- bookkeeping ----------------------------------------------------

    def _note_eviction(self, ns, app_id, band, tenant, pods, reason, replayed):
        with self._lock:
            racecheck.note_access(self, "_recent")
            racecheck.note_access(self, "_evicted_total")
            self._evicted_total += 1
            self._recent.append(
                {
                    "namespace": ns,
                    "app": app_id,
                    "band": band,
                    "tenant": tenant,
                    "pods": pods,
                    "reason": reason,
                    "replayed": replayed,
                    # timesource so the sim's virtual clock stamps these
                    "at": timesource.now(),
                }
            )

    def _stamp(self, plan: VictimPlan, evicted: List[str]) -> None:
        with self._lock:
            racecheck.note_access(self, "_victims_total")
            self._victims_total += len(evicted)
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(mnames.POLICY_PREEMPTION_COUNT)
            self._metrics.counter(
                mnames.POLICY_PREEMPTION_VICTIMS, inc=float(len(evicted))
            )
            self._metrics.histogram(mnames.POLICY_WHATIF_MS, plan.whatif_ms)
        if self._provenance is not None:
            try:
                self._provenance.on_trigger(
                    "policy-preemption",
                    json.dumps(
                        {
                            "preemptor": plan.preemptor_app,
                            "band": plan.preemptor_band,
                            "victims": evicted,
                            "whatifMs": round(plan.whatif_ms, 3),
                            "lane": plan.lane,
                        },
                        sort_keys=True,
                    ),
                )
            except Exception:
                pass

    def state(self) -> Dict[str, object]:
        with self._lock:
            racecheck.note_access(self, "_recent")
            racecheck.note_access(self, "_evicted_total")
            racecheck.note_access(self, "_victims_total")
            return {
                "evictionsTotal": self._evicted_total,
                "victimsTotal": self._victims_total,
                "journalDepth": self._journal.depth(),
                "recent": list(self._recent),
            }
