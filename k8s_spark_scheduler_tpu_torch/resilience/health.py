"""Tri-state health: ready / degraded / unready.

The readiness probe's old boolean answer hid the most operationally
interesting state: *serving, but in a degraded mode* — writes diverted
to the journal, the admission gate actively shedding.  Kubernetes must
NOT pull a degraded replica out of rotation (it is still making correct
decisions; pulling it would turn overload into an outage), but operators
need to see it.  So:

- ``ready``    — everything healthy; probe answers 200.
- ``degraded`` — serving with reduced machinery; probe answers 200 with
  the component breakdown in the body (and the metrics gauge flips).
- ``unready``  — not serving (caches unsynced, warmup incomplete);
  probe answers 503.  The unready inputs live in the HTTP layer (they
  gate on server wiring state); this monitor owns the ready/degraded
  distinction.

The reference package's monitor also reads a kernel-lane health table
(demoted lanes).  This package never demotes a kernel lane — a kernel
fault answers 500 — so the body keeps the reference's shape with
``demotedLanes`` always empty.
"""

from __future__ import annotations

READY = "ready"
DEGRADED = "degraded"
UNREADY = "unready"

_STATE_VALUE = {READY: 0.0, DEGRADED: 1.0, UNREADY: 2.0}


class HealthMonitor:
    def __init__(self, gate, breaker, journal, metrics=None):
        self._gate = gate
        self._breaker = breaker
        self._journal = journal
        self._metrics = metrics

    def state(self, serving: bool = True) -> str:
        """Current health state; ``serving=False`` (caches unsynced /
        warmup incomplete) forces ``unready``."""
        state = UNREADY if not serving else self._degraded_or_ready()
        if self._metrics is not None:
            from ..metrics import names as mnames

            self._metrics.gauge(mnames.RESILIENCE_HEALTH_STATE, _STATE_VALUE[state])
        return state

    def _degraded_or_ready(self) -> str:
        if self._breaker.state != "closed":
            return DEGRADED
        if self._journal.depth() > 0:
            return DEGRADED
        if self._gate.shed_recently():
            return DEGRADED
        return READY

    def report(self, serving: bool = True) -> dict:
        """The /status/readiness body: state plus per-component detail."""
        return {
            "state": self.state(serving),
            "components": {
                "writebackBreaker": self._breaker.state,
                "journalDepth": self._journal.depth(),
                "demotedLanes": [],
                "admissionInFlight": self._gate.in_flight,
                "shedTotal": self._gate.shed_total,
                "shedRecently": self._gate.shed_recently(),
            },
        }
