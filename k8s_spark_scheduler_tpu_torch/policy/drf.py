"""Dominant Resource Fairness accounting (Ghodsi et al., NSDI'11); the
reference package's ``policy/drf.py``.

The accountant mirrors the ResourceReservation cache through its change
observer (an observer registered with
:meth:`..state.typed_caches.ResourceReservationCache.add_change_observer`
first replays existing contents, so the accounting is restart-safe) and
keeps one reserved-resource vector per tenant.  A tenant's *dominant
share* is ``max_j reserved_j / capacity_j`` over the three base
dimensions, divided by the tenant's weight — the quantity DRF equalizes
via progressive filling.

Tenant attribution: the reservation's namespace by default, overridden
by a tenant-label hint the engine registers from the driver pod at
ordering time (``note_app_tenant``) — an RR carries no tenant label of
its own, so hints re-attribute any vector already booked under the
namespace default.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..analysis import racecheck
from ..analysis.guarded import guarded_by


@guarded_by("_lock", "_by_key", "_tenants", "_hints")
class DrfAccountant:
    """Per-tenant dominant-share accounting off the RR change feed.

    ``snapshot_fn`` (optional) returns the current tensor snapshot;
    cluster capacity for the share denominator is read from it at query
    time so shares track node churn without another observer."""

    def __init__(self, tenant_weights: Dict[str, float] = None,
                 snapshot_fn: Callable[[], object] = None):
        self._weights = {t: float(w) for t, w in (tenant_weights or {}).items()
                         if float(w) > 0.0}
        self._snapshot_fn = snapshot_fn
        self._lock = threading.Lock()
        # (ns, name) -> (tenant, reserved vec[3])
        self._by_key: Dict[Tuple[str, str], Tuple[str, np.ndarray]] = {}
        # tenant -> summed reserved vec[3]
        self._tenants: Dict[str, np.ndarray] = {}
        # (ns, app_id) -> tenant hint from the driver pod's tenant label
        self._hints: Dict[Tuple[str, str], str] = {}

    # -- change-feed plumbing -------------------------------------------

    def observe(self, old, new) -> None:
        """Change observer for the ResourceReservation cache
        (``fn(old, new)``; new None = delete): keeps the per-tenant
        vectors in sync with every semantic content change."""
        obj = new if new is not None else old
        if obj is None:
            return
        ns = obj.namespace
        name = obj.name
        key = (ns, name)
        if new is None:
            with self._lock:
                racecheck.note_access(self, "_by_key")
                racecheck.note_access(self, "_tenants")
                self._remove_locked(key)
            return
        vec = self._reserved_vec(new)
        with self._lock:
            racecheck.note_access(self, "_by_key")
            racecheck.note_access(self, "_tenants")
            racecheck.note_access(self, "_hints")
            tenant = self._hints.get(key, ns)
            self._remove_locked(key)
            self._by_key[key] = (tenant, vec)
            self._tenants[tenant] = self._tenants.get(
                tenant, np.zeros(3, dtype=np.int64)) + vec

    def note_app_tenant(self, ns: str, app_id: str, tenant: str) -> None:
        """Register a tenant-label hint for an app; re-attributes any
        vector already booked under the namespace default."""
        if not tenant:
            return
        key = (ns, app_id)
        with self._lock:
            racecheck.note_access(self, "_hints")
            racecheck.note_access(self, "_by_key")
            racecheck.note_access(self, "_tenants")
            self._hints[key] = tenant
            booked = self._by_key.get(key)
            if booked is not None and booked[0] != tenant:
                _, vec = booked
                self._remove_locked(key)
                self._by_key[key] = (tenant, vec)
                self._tenants[tenant] = self._tenants.get(
                    tenant, np.zeros(3, dtype=np.int64)) + vec

    def _remove_locked(self, key: Tuple[str, str]) -> None:
        booked = self._by_key.pop(key, None)
        if booked is None:
            return
        tenant, vec = booked
        left = self._tenants.get(tenant)
        if left is None:
            return
        left = left - vec
        if (left <= 0).all():
            self._tenants.pop(tenant, None)  # schedlint: disable=LK001 -- _remove_locked is only called with _lock held (see callers)
        else:
            self._tenants[tenant] = np.maximum(left, 0)  # schedlint: disable=LK001 -- _remove_locked is only called with _lock held (see callers)

    @staticmethod
    def _reserved_vec(rr) -> np.ndarray:
        from ..ops.tensorize import _resources_to_base

        total = np.zeros(3, dtype=np.int64)
        for res in rr.spec.reservations.values():
            row, _exact = _resources_to_base(res.resources_value())
            total += np.asarray(row, dtype=np.int64)
        return total

    # -- queries --------------------------------------------------------

    def _capacity(self) -> Optional[np.ndarray]:
        if self._snapshot_fn is None:
            return None
        snap = self._snapshot_fn()
        if snap is None or not len(snap.names):
            return None
        eligible = snap.ready & ~snap.unschedulable
        cap = np.asarray(snap.allocatable, dtype=np.int64)[eligible].sum(axis=0)
        return cap if (cap > 0).any() else None

    def dominant_share(self, tenant: str) -> float:
        """Weighted dominant share in [0, inf); 0.0 for a tenant with
        no reservations or when cluster capacity is unknown."""
        cap = self._capacity()
        with self._lock:
            racecheck.note_access(self, "_tenants")
            vec = self._tenants.get(tenant)
            vec = None if vec is None else vec.copy()
        if vec is None or cap is None:
            return 0.0
        shares = vec[cap > 0] / cap[cap > 0]
        if not len(shares):
            return 0.0
        return float(shares.max()) / self._weights.get(tenant, 1.0)

    def tenant_of(self, ns: str, app_id: str) -> str:
        with self._lock:
            racecheck.note_access(self, "_hints")
            racecheck.note_access(self, "_by_key")
            booked = self._by_key.get((ns, app_id))
            if booked is not None:
                return booked[0]
            return self._hints.get((ns, app_id), ns)

    def over_share_tenants(self) -> Dict[str, float]:
        """Tenants whose weighted dominant share exceeds the equal
        split (1/number-of-active-tenants) — the DRF preemption
        eligibility set: a tenant above its share is preemptible by one
        below."""
        with self._lock:
            racecheck.note_access(self, "_tenants")
            tenants = list(self._tenants)
        if not tenants:
            return {}
        fair = 1.0 / len(tenants)
        out = {}
        for t in tenants:
            share = self.dominant_share(t)
            if share > fair:
                out[t] = share
        return out

    def state(self) -> Dict[str, dict]:
        with self._lock:
            racecheck.note_access(self, "_tenants")
            tenants = list(self._tenants)
        fair = 1.0 / len(tenants) if tenants else 0.0
        return {
            t: {
                "dominantShare": round(self.dominant_share(t), 6),
                "weight": self._weights.get(t, 1.0),
                "fairShare": round(fair, 6),
            }
            for t in sorted(tenants)
        }
