"""Admission gate: bounded load shedding in front of the extender lock.

``ThreadingHTTPServer`` spawns a thread per connection; the extender
serializes every ``/predicates`` decision behind one lock.  Under a
request burst (kube-scheduler retry storm, a second scheduler instance
misrouted, a probe loop gone wild) threads pile up on that lock without
bound — each one holding a socket, a stack, and a caller that has long
since timed out.  The gate caps how many requests may sit in front of
the lock; excess requests are *shed* immediately with a retriable
failure instead of queueing, so the server's decision latency for the
admitted requests stays bounded and shed callers learn to back off in
milliseconds rather than at their own timeout.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..analysis import racecheck
from ..analysis.guarded import guarded_by


class AdmissionShed(Exception):
    """Request shed by the admission gate; immediately retriable."""


@guarded_by("_lock", "_in_flight", "_shed_total", "_last_shed_monotonic")
class AdmissionGate:
    def __init__(self, max_waiters: int = 16, metrics=None):
        # max_waiters counts every admitted-but-unfinished request: the
        # one holding the extender lock plus those queued behind it
        self.max_waiters = max(int(max_waiters), 1)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._in_flight = 0
        self._shed_total = 0
        self._last_shed_monotonic: Optional[float] = None

    # -- admission -----------------------------------------------------------

    def try_enter(self) -> bool:
        """Admit the caller, or return False (shed) when the wait queue
        is full.  Never blocks."""
        with self._lock:
            racecheck.note_access(self, "_in_flight")
            if self._in_flight >= self.max_waiters:
                self._shed_total += 1
                self._last_shed_monotonic = time.monotonic()
                if self._metrics is not None:
                    from ..metrics import names as mnames

                    self._metrics.counter(mnames.RESILIENCE_SHED_COUNT)
                return False
            self._in_flight += 1
            return True

    def leave(self) -> None:
        with self._lock:
            racecheck.note_access(self, "_in_flight")
            self._in_flight = max(self._in_flight - 1, 0)

    def admit(self) -> "_Admission":
        """Context manager: raises :class:`AdmissionShed` when full."""
        if not self.try_enter():
            raise AdmissionShed(
                f"admission gate full ({self.max_waiters} requests in flight)"
            )
        return _Admission(self)

    # -- introspection -------------------------------------------------------

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self._shed_total

    def shed_recently(self, window_s: float = 30.0) -> bool:
        """True when a request was shed within the last ``window_s``
        real seconds — the health monitor's overload signal."""
        with self._lock:
            last = self._last_shed_monotonic
        return last is not None and (time.monotonic() - last) < window_s


class _Admission:
    def __init__(self, gate: AdmissionGate):
        self._gate = gate

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._gate.leave()
        return False
