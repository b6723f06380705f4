"""Circuit breaker for the API-server write-back path.

The async write-back client retries each request a bounded number of
times and then *drops* it — correct for transient blips, catastrophic
during a real API-server outage: every queued reservation write burns
its retries against a dead server and the intent is lost (the local
cache then lies until the next reconcile).  The breaker turns repeated
write failures into a state the rest of the system can react to:

- ``closed``  — healthy; writes flow.
- ``open``    — ``failure_threshold`` consecutive failures seen; writes
  are diverted to the intent journal instead of burning retries.
- ``half-open`` — the cooloff elapsed; exactly one probe write is let
  through per cooloff window.  Success closes the breaker (and triggers
  journal replay); failure re-opens it.

Time flows through :func:`..timesource.now` so the simulator's virtual
clock drives cooloffs deterministically; production reads the wall
clock through the same hook.
"""

from __future__ import annotations

import threading

from .. import timesource

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        cooloff_seconds: float = 30.0,
        metrics=None,
        name: str = "writeback",
    ):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.cooloff_seconds = cooloff_seconds
        self._metrics = metrics
        self._name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        # optional observer invoked (OUTSIDE the breaker lock — it may
        # do file I/O) when the breaker transitions to open; wiring
        # points it at the provenance flight recorder
        self.on_open = None

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a write be attempted now?  While open, exactly one probe
        is allowed per elapsed cooloff window (half-open)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = timesource.now()
            if (
                not self._probe_in_flight
                and now - self._opened_at >= self.cooloff_seconds
            ):
                self._set_state(HALF_OPEN)
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> bool:
        """Returns True when this success CLOSED a previously-open
        breaker — the caller's signal to replay the intent journal."""
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != CLOSED:
                self._set_state(CLOSED)
                return True
            return False

    def release_probe(self) -> None:
        """A write granted by :meth:`allow` ended with neither success
        nor failure (e.g. its object was deleted while queued, so no
        request was sent).  Free the probe slot so the next write can
        probe — without this, an aborted half-open probe would wedge the
        breaker open (and the journal undrained) forever."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._consecutive_failures += 1
            self._probe_in_flight = False
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = timesource.now()
                opened = True  # this branch only runs CLOSED/HALF_OPEN → OPEN
                self._set_state(OPEN)
            elif self._state == OPEN:
                # a straggler failure while already open refreshes nothing:
                # the cooloff runs from the instant the breaker opened
                pass
        if opened and self.on_open is not None:
            try:
                self.on_open(self._name)
            except Exception:  # observers must never break the write path
                import logging

                logging.getLogger(__name__).exception(
                    "breaker on_open observer failed"
                )

    def is_open(self) -> bool:
        with self._lock:
            return self._state == OPEN

    def probe_due(self) -> bool:
        """Read-only: would :meth:`allow` admit a write right now?  Used
        by recovery nudges to decide whether re-enqueueing a journaled
        intent has any chance of landing."""
        with self._lock:
            if self._state == CLOSED:
                return True
            return (
                not self._probe_in_flight
                and timesource.now() - self._opened_at >= self.cooloff_seconds
            )

    def trip_half_open(self) -> None:
        """Make the next write attempt a probe immediately, overriding
        the cooloff — the explicit recovery signal ('the API server is
        back') from an operator drain or the simulator's fault-clear."""
        with self._lock:
            if self._state != CLOSED:
                self._opened_at = timesource.now() - self.cooloff_seconds
                self._probe_in_flight = False

    def _set_state(self, state: str) -> None:
        # caller holds the lock
        if state == self._state:
            return
        self._state = state
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.gauge(
                mnames.RESILIENCE_BREAKER_STATE,
                _STATE_VALUE[state],
                {"breaker": self._name},
            )
            self._metrics.counter(
                mnames.RESILIENCE_BREAKER_TRANSITIONS,
                {"breaker": self._name, "to": state},
            )
