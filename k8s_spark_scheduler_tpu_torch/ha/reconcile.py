"""Full state reconciliation at leadership takeover (the reference
package's ``ha/reconcile.py``).

A replica that wins the lease inherits whatever the deposed leader left
behind: unlanded write-back intents in the RR journal, half-committed
eviction plans in the evict journal, ResourceReservations that no
longer match pod reality (the predecessor crashed between binding and
write-back), and a delta-solve session whose warm basis describes the
OLD replica's view of the cluster.  :class:`Reconciler.run` repairs all
four, in dependency order, before the new leader serves its first
decision:

1. **journal replay** — RR intents recorded by the predecessor replay
   through the idempotent write path (create → AlreadyExists folds,
   delete → NotFound is success), evict intents finish their
   half-evicted gangs (pods deleted, reservation still present);
2. **CRD-vs-pod diff** — the extender's failover sync
   (scheduler/failover.py) rebuilds reservations for scheduled pods
   missing from every RR and garbage-collects demands of now-scheduled
   pods, run under the predicate lock so no Filter call observes the
   half-repaired state;
3. **solver reset** — the delta-solve session is invalidated (its warm
   basis is the predecessor's world) and a takeover delta is published
   on the ChangeFeed so every seq-caching consumer (capacity sampler,
   snapshot mirrors) re-verifies.

The report dict is served verbatim at ``/status/ha`` and summarized by
``tpu.ha.reconcile.*`` metrics.
"""

from __future__ import annotations

import logging
import time

from ..metrics import names as mnames

logger = logging.getLogger(__name__)


class Reconciler:
    """Bound to one Server; ``run(epoch)`` executes a full takeover
    reconciliation and returns the report."""

    def __init__(self, server, metrics=None):
        self._server = server
        self._metrics = metrics

    def run(self, epoch: int) -> dict:
        server = self._server
        t0 = time.perf_counter()
        report: dict = {"epoch": epoch}

        # 1a. RR write-back intents the predecessor journaled but never
        # landed.  recover_from_journal handles the cold-boot case
        # (store seeded by the lister); nudge_recovery(force) covers a
        # warm standby whose own breaker was open at takeover.
        replayed = 0
        try:
            replayed += server.resource_reservation_cache.recover_from_journal()
            replayed += server.resource_reservation_cache.nudge_recovery(force=True)
        except Exception:
            logger.exception("ha: reservation journal replay failed")
        report["journalReplays"] = replayed

        # 1b. evict intents: finish half-evicted gangs exactly once
        evictions = 0
        policy = getattr(server, "policy", None)
        if policy is not None:
            try:
                evictions = policy.recover()
            except Exception:
                logger.exception("ha: evict journal replay failed")
        report["evictionReplays"] = evictions

        # 2. diff reservations/demands against pod reality, under the
        # predicate lock so no concurrent Filter sees half-repaired
        # state (same discipline as the extender's idle reconcile)
        try:
            from ..scheduler.failover import (
                sync_resource_reservations_and_demands,
            )

            with server.extender._predicate_lock:
                sync_resource_reservations_and_demands(server.extender)
            report["crdDiffRan"] = True
        except Exception:
            logger.exception("ha: CRD-vs-pod reconciliation failed")
            report["crdDiffRan"] = False

        # 3. the warm solver basis and every seq-caching mirror
        # describe the predecessor's world: invalidate + publish a
        # takeover delta so they all re-verify
        delta_engine = getattr(server.extender, "delta_engine", None)
        if delta_engine is not None:
            try:
                delta_engine.invalidate()
            except Exception:
                logger.exception("ha: delta-solve invalidate failed")
        snapshot = getattr(server, "tensor_snapshot", None)
        if snapshot is not None:
            try:
                snapshot.feed.publish("ha-takeover")
            except Exception:
                logger.exception("ha: takeover feed publish failed")

        elapsed = time.perf_counter() - t0
        report["elapsedSeconds"] = round(elapsed, 6)
        repairs = replayed + evictions
        report["repairs"] = repairs
        if self._metrics is not None:
            self._metrics.histogram(mnames.HA_RECONCILE_TIME, elapsed)
            if repairs:
                self._metrics.counter(
                    mnames.HA_RECONCILE_REPAIRS, inc=float(repairs)
                )
        logger.info(
            "ha: takeover reconciliation at epoch %d: %d journal replays, "
            "%d eviction replays, %.1fms",
            epoch,
            replayed,
            evictions,
            elapsed * 1e3,
        )
        return report
