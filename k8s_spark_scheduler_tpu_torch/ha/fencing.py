"""Fencing tokens: the write-side half of leader election (a copy of
the reference package's ``ha/fencing.py``).

Leases alone cannot stop a paused leader that wakes up mid-write after
its lease expired (the classic GC-pause split-brain).  The fix is the
fencing-token pattern: every leadership grant carries a **monotone
epoch**; every state-mutating write path checks the epoch at the write
boundary and refuses with :class:`StaleEpochError` once a newer epoch
exists.  The refusal is *deterministic*, not probabilistic: the
:class:`FencedWriter` gate re-reads the lease (read-through) before
each fenced write, so a deposed leader's very first post-pause write is
refused — there is no window where a stale write can land.

The read-through costs one lease ``get`` per write-back operation; the
write paths this guards are the async worker threads and the
preemption executor, never the Filter hot path (Filter only mutates
local caches).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from ..analysis import racecheck
from ..analysis.guarded import guarded_by

logger = logging.getLogger(__name__)


class StaleEpochError(Exception):
    """A fenced write was refused: this writer's epoch is stale."""

    def __init__(self, op: str, held_epoch: int, observed_epoch: int):
        super().__init__(
            f"fenced write refused: {op!r} at epoch {held_epoch} but epoch "
            f"{observed_epoch} has been observed (deposed leader)"
        )
        self.op = op
        self.held_epoch = held_epoch
        self.observed_epoch = observed_epoch


@guarded_by("_lock", "_epoch", "_highest", "_refusals", "_commits", "_stale_commits")
class FenceState:
    """This replica's view of the fencing epoch: the epoch it holds (0 =
    never elected) and the highest epoch it has observed anywhere."""

    def __init__(self, metrics=None):
        self._lock = threading.Lock()
        self._metrics = metrics
        self._epoch = 0
        self._highest = 0
        self._refusals: Dict[str, int] = {}
        self._commits = 0
        # I-H3 witness: commits that went through while a newer epoch
        # was already observed.  By construction always 0; the auditor
        # asserts it.
        self._stale_commits = 0

    def grant(self, epoch: int) -> None:
        with self._lock:
            racecheck.note_access(self, "_epoch")
            self._epoch = epoch
            self._highest = max(self._highest, epoch)

    def observe(self, epoch: int) -> bool:
        """Note an epoch seen on the lease; returns True if this writer
        is now deposed (a newer epoch exists)."""
        with self._lock:
            racecheck.note_access(self, "_highest")
            if epoch > self._highest:
                self._highest = epoch
            return self._highest > self._epoch

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def highest_observed(self) -> int:
        with self._lock:
            return self._highest

    def deposed(self) -> bool:
        with self._lock:
            return self._highest > self._epoch

    # -- accounting (FencedWriter calls these) -------------------------------

    def note_refusal(self, op: str) -> None:
        with self._lock:
            racecheck.note_access(self, "_refusals")
            self._refusals[op] = self._refusals.get(op, 0) + 1
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(mnames.HA_FENCE_REFUSALS, {"op": op})

    def note_commit(self) -> None:
        with self._lock:
            racecheck.note_access(self, "_commits")
            self._commits += 1
            if self._highest > self._epoch:
                self._stale_commits += 1
        if self._stale_commits and self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.counter(mnames.HA_FENCE_STALE_COMMITS)

    def stale_commits(self) -> int:
        with self._lock:
            return self._stale_commits

    def refusals(self) -> int:
        with self._lock:
            return sum(self._refusals.values())

    def state(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "highestObserved": self._highest,
                "commits": self._commits,
                "staleCommits": self._stale_commits,
                "refusals": dict(self._refusals),
            }


class FencedWriter:
    """The gate installed at every state-mutating write boundary.

    ``check(op)`` must be called immediately before the API-server
    mutation (or journal ack); it raises :class:`StaleEpochError` when
    this replica is not the current leader.  ``commit()`` is called
    after the mutation lands, closing the I-H3 accounting loop.

    ``lease_reader`` is the read-through hook (the elector's ``peek``):
    when set, every check re-reads the lease so deposition is observed
    on the write path itself, not only at the next renewal tick.
    """

    def __init__(
        self,
        fence: FenceState,
        lease_reader: Optional[Callable[[], object]] = None,
        metrics=None,
    ):
        self.fence = fence
        self._lease_reader = lease_reader

    def check(self, op: str) -> int:
        """Refuse-or-pass; returns the epoch to stamp on the write."""
        fence = self.fence
        if fence.deposed():
            fence.note_refusal(op)
            raise StaleEpochError(op, fence.epoch(), fence.highest_observed())
        reader = self._lease_reader
        if reader is not None:
            lease = reader()
            if lease is not None and fence.observe(lease.epoch):
                fence.note_refusal(op)
                logger.warning(
                    "ha: fenced write %s refused — lease moved to epoch %d "
                    "(held %d)",
                    op,
                    lease.epoch,
                    fence.epoch(),
                )
                raise StaleEpochError(op, fence.epoch(), lease.epoch)
        epoch = fence.epoch()
        if epoch == 0:
            # never elected: a replica that has not held the lease may
            # not mutate shared state at all
            fence.note_refusal(op)
            raise StaleEpochError(op, 0, fence.highest_observed())
        return epoch

    def commit(self) -> None:
        self.fence.note_commit()
