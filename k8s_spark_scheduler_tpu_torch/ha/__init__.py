"""HA failover fabric: lease-fenced multi-replica operation (the
reference package's ``ha/``).

Two or more replicas run behind leader election over one coordination
Lease; an elected leader's write paths are fenced by a monotone epoch,
and a new leader reconciles the cluster state before it serves:

- :mod:`.lease` — lease-based leader election over a coordination
  Lease object (the embedded API server in tests, coordination.k8s.io/v1
  over REST against a cluster), issuing a **monotone fencing epoch** per
  leadership grant;
- :mod:`.fencing` — the :class:`~.fencing.FencedWriter` gate every
  state-mutating write path (reservation write-back, demand CRD writes,
  preemption deletes, journal acks) consults; once a newer epoch is
  observed every write is refused with
  :class:`~.fencing.StaleEpochError`;
- :mod:`.crashpoint` — named crash-injection points threaded through
  the write-back pipeline, both journals, preemption commit, and lease
  renewal, swept as a matrix by :mod:`.crashmatrix`;
- :mod:`.reconcile` — full state reconciliation at takeover: replay
  both journals, diff CRDs against pod reality, finish half-evicted
  gangs, reset the delta-solve session and ChangeFeed (so the new
  leader's first Filter is a cold launch of the queue kernel).

The fabric is host code; the card's part is the Filter path it fences
and takeover resets.  :class:`HAFabric` below is the facade wiring owns:
it glues elector → fence → reconciler and serves ``/status/ha``.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .. import timesource
from ..metrics import names as mnames
from .crashpoint import maybe_crash
from .fencing import FenceState, FencedWriter, StaleEpochError  # noqa: F401
from .lease import LeaderElector, Lease  # noqa: F401

logger = logging.getLogger(__name__)


class HAFabric:
    """Facade over elector + fence + reconciler for one replica.

    ``step()`` drives one election/renewal round; wiring runs it on a
    background thread (``start()``) when ``ha.background`` is set, tests
    and the crash matrix call it explicitly so elections stay
    deterministic.
    """

    def __init__(
        self,
        elector: LeaderElector,
        fence: FenceState,
        reconciler=None,
        metrics=None,
        renew_interval_seconds: float = 5.0,
        writer=None,
    ):
        self.elector = elector
        self.fence = fence
        self.reconciler = reconciler
        # the shared FencedWriter gate installed on the write paths;
        # kept here so probes (readiness, chaos cells) can exercise the
        # exact gate production writes go through
        self.writer = writer
        self._metrics = metrics
        self._renew_interval = renew_interval_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_report: dict = {}
        elector.on_elected = self._on_elected
        elector.on_deposed = self._on_deposed

    # -- election callbacks --------------------------------------------------

    def _on_elected(self, epoch: int) -> None:
        logger.info("ha: elected leader at epoch %d", epoch)
        if self._metrics is not None:
            self._metrics.counter(mnames.HA_TRANSITIONS, {"to": "leader"})
        if self.reconciler is not None:
            try:
                self._last_report = self.reconciler.run(epoch)
            except Exception:
                logger.exception("ha: takeover reconciliation failed")

    def _on_deposed(self, epoch: int) -> None:
        logger.warning(
            "ha: deposed (observed epoch %d > held %d); all fenced writes "
            "will refuse with stale-epoch until re-elected",
            epoch,
            self.fence.epoch(),
        )
        if self._metrics is not None:
            self._metrics.counter(mnames.HA_TRANSITIONS, {"to": "follower"})

    # -- driving -------------------------------------------------------------

    def step(self) -> bool:
        """One election/renewal round; returns is_leader.  Refuses to
        run inside the extender's predicate lock (same in-lock refusal
        pattern as the capacity sampler): leader election does I/O and
        must never stretch a scheduling decision's lock hold."""
        # imported here, not at module top: capacity pulls the torch/
        # ops stack, and resilience/journal.py imports this package
        from ..capacity import in_predicate_lock

        if in_predicate_lock():
            return self.elector.is_leader()
        maybe_crash("lease.pre-renew")
        leader = self.elector.step()
        if self._metrics is not None:
            self._metrics.gauge(mnames.HA_LEADER_STATE, 1.0 if leader else 0.0)
            self._metrics.gauge(mnames.HA_EPOCH, float(self.fence.epoch()))
        return leader

    def is_leader(self) -> bool:
        return self.elector.is_leader()

    def start(self) -> None:
        """Background renewal loop (``ha.background``; tests and the
        crash matrix step manually)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="ha-elector", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                logger.exception("ha: election step failed")
            # real-time wait: the renewal cadence is wall-clock by
            # nature (the lease TTL is wall-clock)
            self._stop.wait(self._renew_interval)

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    # -- observability -------------------------------------------------------

    def status(self) -> dict:
        """The ``/status/ha`` payload."""
        lease = self.elector.peek()
        return {
            "identity": self.elector.identity,
            "leader": self.elector.is_leader(),
            "epoch": self.fence.epoch(),
            "highestObservedEpoch": self.fence.highest_observed(),
            "fence": self.fence.state(),
            "lease": {
                "holder": lease.holder if lease is not None else "",
                "epoch": lease.epoch if lease is not None else 0,
                "renewedAt": lease.renewed_at if lease is not None else 0.0,
                "durationSeconds": (
                    lease.duration_seconds if lease is not None else 0.0
                ),
                "history": list(lease.history) if lease is not None else [],
            },
            "reconciliation": dict(self._last_report),
            "asOf": timesource.now(),
        }
