"""The policy facade the extender and wiring consume (the reference
package's ``policy/engine.py``).

Every extender hook is a single method call behind an ``is None``
check, so with ``policy.enabled = false`` (the default) no engine
exists and the Filter path is byte-identical to pre-policy behavior:

- :meth:`PolicyEngine.earlier_queue` — replaces
  ``SparkPodLister.list_earlier_drivers`` with the configured order's
  queue-ahead set.  Under the ``fifo`` ordering it delegates to
  ``list_earlier_drivers`` verbatim (decision identity is structural,
  not just tested);
- :meth:`PolicyEngine.skip_allowed` — the enforce-after-age skip
  verdict, optionally widened by the conservative backfill probe;
- :meth:`PolicyEngine.on_driver_refusal` — fires on a FIT /
  EARLIER_DRIVER refusal: selects + what-if-validates a whole-app
  victim set, commits it through the evict journal, and returns the
  victim-set note the extender stamps into the FailedNodes message
  (the kube-scheduler's retry then admits into the freed capacity).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import timesource
from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..config import PolicyConfig
from ..scheduler import labels as L
from .classes import PriorityLedger
from .drf import DrfAccountant
from .ordering import (
    ORDER_DRF,
    ORDER_FIFO,
    INT32_SAFE,
    Gang,
    backfill_cannot_delay,
    queue_sort_key,
)
from .preempt import PreemptionCoordinator
from .victims import VictimSelector

logger = logging.getLogger(__name__)

# outcome strings the refusal hook reacts to (mirrors extender.py; not
# imported from there — the extender imports nothing from policy, and
# policy must not import the extender back)
_FAILURE_FIT = "failure-fit"
_FAILURE_EARLIER_DRIVER = "failure-earlier-driver"


@guarded_by("_lock", "_basis_cache")
class PolicyEngine:
    """Priority ordering + backfill + gang-aware preemption + DRF."""

    def __init__(
        self,
        config: PolicyConfig,
        pod_lister,
        tensor_snapshot=None,
        rr_cache=None,
        api=None,
        journal_path: Optional[str] = None,
        metrics=None,
        provenance=None,
        delta_engine=None,
    ):
        self.config = config
        self._pod_lister = pod_lister
        self._tensor_snapshot = tensor_snapshot
        self._metrics = metrics
        self._provenance = provenance
        self._delta_engine = delta_engine
        self.ledger = PriorityLedger(
            config.bands, config.default_band, config.band_label
        )
        self.drf = DrfAccountant(
            config.tenant_weights, snapshot_fn=self._snapshot_or_none
        )
        if rr_cache is not None:
            # observer registration replays existing contents, so the
            # accounting is correct from boot and across failover
            rr_cache.add_change_observer(self.drf.observe)
        self.selector: Optional[VictimSelector] = None
        self.coordinator: Optional[PreemptionCoordinator] = None
        if config.preemption_enabled and rr_cache is not None and api is not None:
            self.selector = VictimSelector(
                list_rrs=rr_cache.list,
                band_fn=self._band_of_rr,
                tenant_fn=self.drf.tenant_of,
                min_band_gap=config.preemption_min_band_gap,
                max_victims=config.max_victims,
            )
            self.coordinator = PreemptionCoordinator(
                api=api,
                rr_cache=rr_cache,
                journal_path=journal_path,
                metrics=metrics,
                provenance=provenance,
                recent_limit=config.recent_evictions,
            )
        self._lock = threading.Lock()
        # content_key → (avail, exec_ok, driver_rank, node_index)
        self._basis_cache: Tuple[object, tuple] = (None, ())

    # -- queue ordering -------------------------------------------------

    def earlier_queue(self, driver) -> List:
        """The queue-ahead set this driver must prove before admitting,
        in the configured order."""
        app_id = driver.labels.get(L.SPARK_APP_ID_LABEL, driver.name)
        band, rank = self.ledger.observe(driver, app_id)
        self._note_tenant(driver, app_id)
        if self.config.ordering == ORDER_FIFO:
            # structural identity with the pre-policy comparator
            return self._pod_lister.list_earlier_drivers(driver)
        pending = self._pod_lister.list_pending_drivers(driver)
        keyed = []
        self_key = None
        for p in pending:
            pid = p.labels.get(L.SPARK_APP_ID_LABEL, p.name)
            _, prank = self.ledger.observe(p, pid)
            share = 0.0
            if self.config.ordering == ORDER_DRF:
                tenant = self._note_tenant(p, pid)
                share = self.drf.dominant_share(tenant)
            key = queue_sort_key(self.config.ordering, prank, share, p)
            if p.namespace == driver.namespace and p.name == driver.name:
                self_key = key
                continue
            keyed.append((key, p))
        if self_key is None:
            # driver not in the pending view (informer lag): order
            # against its own freshly computed key
            share = 0.0
            if self.config.ordering == ORDER_DRF:
                tenant = self._note_tenant(driver, app_id)
                share = self.drf.dominant_share(tenant)
            self_key = queue_sort_key(self.config.ordering, rank, share, driver)
        keyed.sort(key=lambda kv: kv[0])
        return [p for key, p in keyed if key < self_key]

    def skip_allowed(self, queued, driver, base: bool) -> bool:
        """May the blocked queue-ahead app ``queued`` be skipped so that
        ``driver`` can still admit?  ``base`` is the pre-policy verdict
        (enforce-after-age); backfill can only WIDEN it, and never for a
        head past the starvation age (I-P3)."""
        if base:
            return True
        if not self.config.backfill:
            return False
        age = timesource.now() - queued.creation_timestamp
        if age >= self.config.starvation_age_seconds:
            return False
        try:
            basis = self._basis()
            if basis is None:
                return False
            avail, exec_ok, driver_rank, _ = basis
            verdict = backfill_cannot_delay(
                avail, exec_ok, driver_rank,
                head=self._gang_of(queued),
                candidate=self._gang_of(driver),
            )
        except Exception:
            logger.exception("backfill probe failed; refusing backfill")
            return False
        if verdict and self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(mnames.POLICY_BACKFILL_SKIPS)
        return verdict

    # -- preemption -----------------------------------------------------

    def on_driver_refusal(self, driver, app_resources, outcome: str) -> Optional[str]:
        """Called at the extender's refusal sites; returns a message
        note describing the committed eviction, or None when no
        preemption happened (the common case)."""
        if self.selector is None or self.coordinator is None:
            return None
        if outcome not in (_FAILURE_FIT, _FAILURE_EARLIER_DRIVER):
            return None
        app_id = driver.labels.get(L.SPARK_APP_ID_LABEL, driver.name)
        band, rank = self.ledger.band_of(driver)
        try:
            basis = self._basis()
            if basis is None:
                return None
            avail, exec_ok, driver_rank, node_index = basis
            gang = self._gang_of_resources(app_resources)
            blockers: Tuple[str, ...] = ()
            if self._provenance is not None:
                info = self._provenance.pending_shortfall()
                if info is not None:
                    blockers = tuple(info.blockers)
            over_share: Dict[str, float] = {}
            if self.config.ordering == ORDER_DRF:
                over_share = self.drf.over_share_tenants()
            plan = self.selector.select(
                preemptor_app=app_id,
                preemptor_band=band,
                preemptor_rank=rank,
                gang=gang,
                avail=avail,
                exec_ok=exec_ok,
                driver_rank=driver_rank,
                node_index=node_index,
                over_share=over_share,
                blockers=blockers,
                session_validate=self._session_validator(gang),
            )
            if plan is None:
                return None
            evicted = self.coordinator.commit(plan)
        except Exception:
            logger.exception("preemption attempt failed; refusal stands as-is")
            return None
        if not evicted:
            return None
        return "preempting victims: " + ", ".join(sorted(evicted))

    def _session_validator(self, gang: Gang):
        """What-if validation against the warm delta-solve session basis
        (the availability the last queue solve actually ran against);
        None when no engine/session — the numpy verdict then stands."""
        if self._delta_engine is None:
            return None
        basis = self._delta_engine.latest_basis()
        if basis is None:
            return None
        names, avail, exec_ok, driver_rank = basis
        index = {n: i for i, n in enumerate(names)}

        def validate(freed_snapshot_order: np.ndarray) -> Optional[bool]:
            snap_basis = self._basis()
            if snap_basis is None:
                return None
            _, _, _, node_index = snap_basis
            # remap the freed matrix from snapshot row order into the
            # session's cluster row order; capacity on nodes the
            # session does not know is dropped (conservative)
            freed = np.zeros_like(avail)
            for name, si in node_index.items():
                di = index.get(name)
                if di is not None:
                    freed[di] = freed_snapshot_order[si]
            from .victims import whatif_fits

            return whatif_fits(avail, exec_ok, driver_rank, freed, gang)

        return validate

    # -- basis + gang helpers -------------------------------------------

    def _snapshot_or_none(self):
        if self._tensor_snapshot is None:
            return None
        try:
            return self._tensor_snapshot.snapshot()
        except Exception:
            return None

    def _basis(self):
        """(avail [N,3] int64, exec_ok [N] bool, driver_rank [N] int64,
        node_index {name: row}) from the current tensor snapshot, cached
        per content_key."""
        snap = self._snapshot_or_none()
        if snap is None or not len(snap.names):
            return None
        with self._lock:
            racecheck.note_access(self, "_basis_cache")
            ckey, cached = self._basis_cache
            if ckey == snap.content_key:
                return cached
        eligible = np.asarray(snap.ready, dtype=bool) & ~np.asarray(
            snap.unschedulable, dtype=bool
        )
        avail = np.asarray(snap.avail, dtype=np.int64)
        driver_rank = np.where(eligible, np.int64(0), np.int64(INT32_SAFE))
        node_index = {n: i for i, n in enumerate(snap.names)}
        basis = (avail, eligible, driver_rank, node_index)
        with self._lock:
            racecheck.note_access(self, "_basis_cache")
            self._basis_cache = (snap.content_key, basis)
        return basis

    @staticmethod
    def _gang_of_resources(app_resources) -> Gang:
        from ..ops.tensorize import _resources_to_base

        drow, _ = _resources_to_base(app_resources.driver_resources)
        erow, _ = _resources_to_base(app_resources.executor_resources)
        return (
            np.asarray(drow, dtype=np.int64),
            np.asarray(erow, dtype=np.int64),
            int(app_resources.min_executor_count),
        )

    def _gang_of(self, pod) -> Gang:
        from ..scheduler.sparkpods import spark_app_demand_cached

        _, demand = spark_app_demand_cached(pod)
        return self._gang_of_resources(demand)

    def _band_of_rr(self, rr) -> Tuple[str, int]:
        """Band of a RUNNING app = its driver pod's band label; an app
        whose driver pod is gone falls back to the default band."""
        driver = self._pod_lister.get_driver_pod(rr.name, rr.namespace)
        if driver is None:
            return self.ledger.default_band, self.ledger.bands[
                self.ledger.default_band
            ]
        return self.ledger.band_of(driver)

    def _note_tenant(self, pod, app_id: str) -> str:
        tenant = pod.labels.get(self.config.tenant_label) or pod.namespace
        self.drf.note_app_tenant(pod.namespace, app_id, tenant)
        return tenant

    # -- lifecycle + operator surface -----------------------------------

    def recover(self) -> int:
        """Replay pending evict intents (wiring boot + failover)."""
        if self.coordinator is None:
            return 0
        return self.coordinator.recover()

    def close(self) -> None:
        if self.coordinator is not None:
            self.coordinator.close()

    def publish_gauges(self) -> None:
        """Per-tenant dominant-share gauges (called by the capacity
        sampler's tick alongside its own gauges)."""
        if self._metrics is None:
            return
        from ..metrics import names as mnames

        for tenant, info in self.drf.state().items():
            self._metrics.gauge(
                mnames.POLICY_DRF_SHARE,
                info["dominantShare"],
                {"tenant": tenant},
            )

    def state(self) -> Dict[str, object]:
        """``GET /policy/state``: bands, tenant shares, recent
        evictions with reasons."""
        out: Dict[str, object] = {
            "enabled": True,
            "ordering": self.config.ordering,
            "backfill": self.config.backfill,
            "preemptionEnabled": self.config.preemption_enabled,
            "bands": self.ledger.state(),
            "tenants": self.drf.state(),
        }
        if self.coordinator is not None:
            out["preemption"] = self.coordinator.state()
            if self.selector is not None:
                out["preemption"]["whatif"] = self.selector.stats()
        return out
