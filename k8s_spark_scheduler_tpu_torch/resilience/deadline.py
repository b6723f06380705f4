"""Per-request deadline propagation.

kube-scheduler gives the extender a hard ``httpTimeout`` (30s in
``examples/extender.yml``); past it the Filter call has already failed
on the caller's side and any work we keep doing for it — most damagingly
holding the single extender lock — is pure overload amplification.  The
HTTP layer binds a deadline into a contextvar at request entry; the
extender checks it at phase boundaries (predicate entry → FIFO gate →
binpack → reservation write-back) and answers fail-fast once expired.

Deadlines ride the *real* monotonic clock, never the (possibly virtual,
frozen) :mod:`..timesource`: they bound wall latency as the HTTP caller
experiences it, and a simulator's frozen clock must never turn a bounded
request into an unbounded one (or spuriously expire one).

The no-deadline fast path — background threads, tests, the simulator
calling ``predicate`` directly — is one contextvar read.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from typing import Iterator, Optional

# absolute time.monotonic() instant the current request expires at
_deadline: ContextVar[Optional[float]] = ContextVar("request_deadline", default=None)


class DeadlineExceeded(Exception):
    """The request outlived its caller's timeout."""

    def __init__(self, phase: str, overrun_s: float):
        super().__init__(
            f"request deadline expired {overrun_s * 1000.0:.0f}ms ago at {phase}"
        )
        self.phase = phase
        self.overrun_s = overrun_s


@contextlib.contextmanager
def bind(timeout_s: Optional[float]) -> Iterator[None]:
    """Bind a deadline ``timeout_s`` from now for the enclosed work.
    ``None`` binds nothing (and clears any inherited deadline)."""
    token = _deadline.set(
        time.monotonic() + timeout_s if timeout_s is not None else None
    )
    try:
        yield
    finally:
        _deadline.reset(token)


def remaining() -> Optional[float]:
    """Seconds until the bound deadline (may be negative), or None when
    no deadline is bound."""
    at = _deadline.get()
    if at is None:
        return None
    return at - time.monotonic()


def expired() -> bool:
    at = _deadline.get()
    return at is not None and time.monotonic() >= at


def check(phase: str) -> None:
    """Raise :class:`DeadlineExceeded` when the bound deadline passed."""
    at = _deadline.get()
    if at is not None:
        now = time.monotonic()
        if now >= at:
            raise DeadlineExceeded(phase, now - at)
