"""Lease-based leader election with monotone fencing epochs (a copy of
the reference package's ``ha/lease.py``).

One coordination Lease object is the election ground truth: the holder
renews ``renewed_at`` within ``duration_seconds``; a candidate acquires
by CAS-updating an expired (or absent) lease with ``epoch + 1``.  The
API server's optimistic concurrency (resourceVersion → 409 Conflict)
makes the CAS atomic — exactly client-go's ``leaderelection`` resource
lock, reproduced over our embedded/REST API-server interface.

Every successful acquisition appends ``(epoch, holder, at)`` to the
lease's bounded ``history``, which is the I-H1 audit witness: at most
one fenced writer per epoch, epochs strictly increasing.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .. import timesource
from ..analysis.guarded import guarded_by
from ..kube.errors import AlreadyExistsError, ConflictError, NotFoundError
from ..types.objects import APIObject, ObjectMeta

logger = logging.getLogger(__name__)

# bounded so a long-lived cluster's lease object stays small
HISTORY_LIMIT = 64


@dataclass
class Lease(APIObject):
    """Coordination lease (coordination.k8s.io/v1 Lease analog)."""

    KIND = "Lease"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    epoch: int = 0
    acquired_at: float = 0.0
    renewed_at: float = 0.0
    duration_seconds: float = 15.0
    # [[epoch, holder, acquired_at], ...] — the I-H1 audit trail
    history: List[list] = field(default_factory=list)

    def expired(self, now: float) -> bool:
        return now - self.renewed_at > self.duration_seconds

    def deepcopy(self) -> "Lease":
        return Lease(
            meta=self.meta.copy(),
            holder=self.holder,
            epoch=self.epoch,
            acquired_at=self.acquired_at,
            renewed_at=self.renewed_at,
            duration_seconds=self.duration_seconds,
            history=[list(h) for h in self.history],
        )


def lease_to_wire(lease: Lease) -> dict:
    """coordination.k8s.io/v1 wire form; the epoch rides on
    leaseTransitions (monotone, like client-go's) and the history on an
    annotation so real-cluster deployments keep the audit trail."""
    import json

    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {
            "name": lease.name,
            "namespace": lease.namespace,
            "resourceVersion": str(lease.meta.resource_version),
            "annotations": {"tpu.ha/history": json.dumps(lease.history)},
        },
        "spec": {
            "holderIdentity": lease.holder,
            "leaseDurationSeconds": int(lease.duration_seconds),
            "acquireTime": lease.acquired_at,
            "renewTime": lease.renewed_at,
            "leaseTransitions": lease.epoch,
        },
    }


def lease_from_wire(wire: dict) -> Lease:
    import json

    meta = wire.get("metadata") or {}
    spec = wire.get("spec") or {}
    try:
        history = json.loads((meta.get("annotations") or {}).get("tpu.ha/history", "[]"))
    except (ValueError, TypeError):
        history = []
    rv = meta.get("resourceVersion") or "0"
    try:
        rv_int = int(rv)
    except ValueError:
        rv_int = 0
    return Lease(
        meta=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            resource_version=rv_int,
        ),
        holder=spec.get("holderIdentity", "") or "",
        epoch=int(spec.get("leaseTransitions", 0) or 0),
        acquired_at=float(spec.get("acquireTime", 0.0) or 0.0),
        renewed_at=float(spec.get("renewTime", 0.0) or 0.0),
        duration_seconds=float(spec.get("leaseDurationSeconds", 15.0) or 15.0),
        history=history if isinstance(history, list) else [],
    )


@guarded_by("_lock", "_last_renewal", "_held")
class LeaderElector:
    """Drives one replica's acquire/renew/step-down over the lease.

    ``step()`` is one round: create-or-read the lease, renew if ours,
    acquire if free/expired, observe the epoch otherwise.  All writes
    go through the API server's CAS, so two electors stepping
    concurrently resolve to exactly one holder per epoch.
    """

    def __init__(
        self,
        api,
        identity: str,
        fence,
        namespace: str = "default",
        name: str = "tpu-gang-scheduler",
        duration_seconds: float = 15.0,
        on_elected: Optional[Callable[[int], None]] = None,
        on_deposed: Optional[Callable[[int], None]] = None,
    ):
        self._api = api
        self.identity = identity
        self.fence = fence
        self._namespace = namespace
        self._name = name
        self._duration = duration_seconds
        self.on_elected = on_elected
        self.on_deposed = on_deposed
        self._lock = threading.Lock()
        self._last_renewal = float("-inf")
        self._held = False

    # -- lease access --------------------------------------------------------

    def peek(self) -> Optional[Lease]:
        """Read the lease without mutating (the fence's read-through)."""
        try:
            lease = self._api.get(Lease.KIND, self._namespace, self._name)
        except NotFoundError:
            return None
        except Exception:
            logger.exception("ha: lease read failed")
            return None
        return lease if isinstance(lease, Lease) else None

    def is_leader(self) -> bool:
        """Held, not deposed, and the lease TTL has not lapsed since our
        last successful renewal — a partitioned leader stops claiming
        leadership (and readiness) once its own lease could have been
        taken, even before it observes the taker."""
        with self._lock:
            held, last = self._held, self._last_renewal
        return (
            held
            and not self.fence.deposed()
            and timesource.now() - last <= self._duration
        )

    # -- the election round --------------------------------------------------

    def step(self) -> bool:
        now = timesource.now()
        lease = self.peek()
        if lease is None:
            return self._try_create(now)
        if lease.holder == self.identity and lease.epoch == self.fence.epoch():
            return self._try_renew(lease, now)
        # someone else's lease (or our own from a previous incarnation):
        # observe its epoch, acquire if expired
        deposed = self.fence.observe(lease.epoch)
        if deposed and self._was_leader():
            self._mark_follower()
            if self.on_deposed is not None:
                self.on_deposed(lease.epoch)
        if lease.expired(now):
            return self._try_acquire(lease, now)
        return False

    def step_down(self) -> None:
        """Voluntary handoff: expire our lease immediately so a standby
        acquires on its next step without waiting out the TTL."""
        lease = self.peek()
        if lease is None or lease.holder != self.identity:
            return
        lease = lease.deepcopy()
        lease.renewed_at = timesource.now() - lease.duration_seconds - 1.0
        try:
            self._api.update(lease)
        except (ConflictError, NotFoundError):
            pass
        self._mark_follower()

    # -- internals -----------------------------------------------------------

    def _was_leader(self) -> bool:
        with self._lock:
            return self._held

    def _mark_follower(self) -> None:
        with self._lock:
            self._held = False
            self._last_renewal = float("-inf")

    def _mark_leader(self, now: float) -> None:
        with self._lock:
            self._held = True
            self._last_renewal = now

    def _try_create(self, now: float) -> bool:
        lease = Lease(
            meta=ObjectMeta(name=self._name, namespace=self._namespace),
            holder=self.identity,
            epoch=1,
            acquired_at=now,
            renewed_at=now,
            duration_seconds=self._duration,
            history=[[1, self.identity, now]],
        )
        try:
            self._api.create(lease)
        except AlreadyExistsError:
            return False  # lost the race; next step observes the winner
        except Exception:
            logger.exception("ha: lease create failed")
            return False
        return self._won(1, now)

    def _try_renew(self, lease: Lease, now: float) -> bool:
        lease = lease.deepcopy()
        lease.renewed_at = now
        try:
            self._api.update(lease)
        except ConflictError:
            return False  # a rival CAS won; next step observes it
        except Exception:
            logger.exception("ha: lease renew failed")
            return self.is_leader()
        self._mark_leader(now)
        return True

    def _try_acquire(self, lease: Lease, now: float) -> bool:
        lease = lease.deepcopy()
        new_epoch = lease.epoch + 1
        lease.holder = self.identity
        lease.epoch = new_epoch
        lease.acquired_at = now
        lease.renewed_at = now
        lease.history.append([new_epoch, self.identity, now])
        del lease.history[:-HISTORY_LIMIT]
        try:
            self._api.update(lease)
        except ConflictError:
            return False
        except Exception:
            logger.exception("ha: lease acquire failed")
            return False
        return self._won(new_epoch, now)

    def _won(self, epoch: int, now: float) -> bool:
        self.fence.grant(epoch)
        self._mark_leader(now)
        if self.on_elected is not None:
            self.on_elected(epoch)
        return True
