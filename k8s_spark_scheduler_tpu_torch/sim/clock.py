"""Virtual clock + event heap for discrete-event simulation; a copy of
the reference package's ``sim/clock.py``.

The clock is a plain float the runner advances to each popped event's
instant; ``now`` is installed as the process-wide
:mod:`..timesource` so every semantic clock read in the control plane
(object creation timestamps, the failover idle trigger, FIFO
enforce-after ages, demand-waste attribution, the unschedulable-pod
timeout) observes simulated time.

Events are ``(time, seq, label, callback)``; ``seq`` is a monotone
tiebreaker so same-instant events fire in scheduling order — a
requirement for byte-identical event-log digests.  The heap is
lock-protected because watch handlers (which may enqueue follow-up
events) run on async write-back threads.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, List, Optional, Tuple

from ..analysis.guarded import guarded_by


@guarded_by("_lock", "_heap", "_now")
class VirtualClock:
    def __init__(self, start: float = 0.0):
        self._now = start
        self._seq = itertools.count()
        self._heap: List[Tuple[float, int, str, Callable[[], None]]] = []
        self._lock = threading.Lock()

    # -- time source ----------------------------------------------------------

    def now(self) -> float:
        return self._now

    # -- event heap -----------------------------------------------------------

    def schedule(self, at: float, label: str, fn: Callable[[], None]) -> None:
        """Enqueue ``fn`` to run at virtual instant ``at``.  Scheduling
        in the past is clamped to now (the event fires next)."""
        with self._lock:
            heapq.heappush(self._heap, (max(at, self._now), next(self._seq), label, fn))

    def schedule_in(self, delay: float, label: str, fn: Callable[[], None]) -> None:
        self.schedule(self._now + delay, label, fn)

    def peek_time(self) -> Optional[float]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def pending(self) -> int:
        with self._lock:
            return len(self._heap)

    def run_next(self) -> Optional[Tuple[float, str]]:
        """Pop the earliest event, advance virtual time to it, run its
        callback.  Returns (time, label), or None when the heap is
        empty.  Callbacks may schedule further events."""
        with self._lock:
            if not self._heap:
                return None
            at, _, label, fn = heapq.heappop(self._heap)
            # never move backwards (events scheduled "in the past" were
            # clamped at insert, but be safe against float edge cases)
            self._now = max(self._now, at)
        fn()
        return at, label

    def advance_to(self, t: float) -> None:
        """Advance the clock to ``t`` without running events (the runner
        uses run_next(); this is for tests that only need time to pass,
        e.g. aging a driver past a FIFO enforce-after threshold)."""
        with self._lock:
            self._now = max(self._now, t)
