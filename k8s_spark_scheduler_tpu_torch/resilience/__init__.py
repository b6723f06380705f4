"""Overload protection and degraded-mode operation for the scheduling
control plane (the reference package's ``resilience/``).

The extender's one hard guarantee — a driver is admitted only when the
whole gang fits — survives crashes via reconciliation, but a correct
scheduler can still *fail open under pressure*: requests that outlive
their caller keep burning the extender lock, and API-server write
failures drop reservation intents after bounded retries.  This package
is the cross-cutting resilience layer:

- :mod:`.deadline` — per-request deadline propagation (contextvar),
  checked at phase boundaries so expired requests answer fail-fast;
- :mod:`.gate` — a bounded admission gate in front of the extender lock
  that sheds excess concurrency with an immediately-retriable response;
- :mod:`.breaker` — a circuit breaker for API-server write-back;
- :mod:`.journal` — a durable JSONL intent journal that captures
  reservation writes while the breaker is open (or retries exhaust) and
  replays them idempotently on recovery and at boot;
- :mod:`.health` — the tri-state (ready/degraded/unready) health state
  machine behind ``/status/readiness``.

The reference's kernel-lane health table (``lanehealth``), which demotes
a faulting device lane to a host lane, has no counterpart: this package
has no host lane to demote to, and a kernel fault answers 500.  The
``lane-*`` keys of a reference config's ``resilience`` section still
load; the wiring logs that they configure nothing here.

Everything is wired by :func:`build_kit` into a :class:`ResilienceKit`,
constructed once per server by ``server/wiring.py`` and threaded through
the HTTP layer, the extender, and the reservation write-back cache.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import deadline
from .breaker import CircuitBreaker
from .gate import AdmissionGate, AdmissionShed
from .health import DEGRADED, READY, UNREADY, HealthMonitor
from .journal import IntentJournal


@dataclass
class ResilienceKit:
    """The per-server resilience components, wired together."""

    gate: AdmissionGate
    breaker: CircuitBreaker
    journal: IntentJournal
    health: HealthMonitor
    # seconds a /predicates request may run before answering fail-fast;
    # derived from kube-scheduler's httpTimeout minus a safety margin so
    # the response reaches a caller that is still listening
    request_timeout: float = 29.0


def build_kit(config, metrics=None) -> ResilienceKit:
    """Construct a kit from a ``config.ResilienceConfig``."""
    gate = AdmissionGate(max_waiters=config.admission_max_waiters, metrics=metrics)
    journal = IntentJournal(path=config.journal_path, metrics=metrics)
    breaker = CircuitBreaker(
        failure_threshold=config.breaker_failure_threshold,
        cooloff_seconds=config.breaker_cooloff_seconds,
        metrics=metrics,
    )
    health = HealthMonitor(gate=gate, breaker=breaker, journal=journal, metrics=metrics)
    return ResilienceKit(
        gate=gate,
        breaker=breaker,
        journal=journal,
        health=health,
        request_timeout=max(
            config.request_deadline_seconds - config.deadline_margin_seconds, 1.0
        ),
    )


__all__ = [
    "AdmissionGate",
    "AdmissionShed",
    "CircuitBreaker",
    "IntentJournal",
    "HealthMonitor",
    "ResilienceKit",
    "build_kit",
    "deadline",
    "READY",
    "DEGRADED",
    "UNREADY",
]
