"""Pluggable wall-clock source for the control plane.

Every *semantic* "what time is it" read in the scheduler — object
creation timestamps, the failover idle-reconcile trigger, FIFO
enforce-after ages, demand-waste attribution, the unschedulable-pod
timeout — goes through :func:`now` instead of ``time.time``.  In
production it IS ``time.time``; a test or the discrete-event simulator
(:mod:`.sim`) swaps in a virtual clock so timers fire at chosen
instants, deterministically.

Span *durations* go through the separate :func:`perf` hook (default
``time.perf_counter``): a trace must not mix virtual start instants
with wall-clock durations, so the simulator installs its clock for both
and a completed sim trace is virtual end to end.  Lock wait/hold
telemetry and harness/infrastructure deadlines (``time.monotonic``
waits) stay on the real clock on purpose: a frozen virtual clock must
never turn a bounded wait into an infinite one.
"""

from __future__ import annotations

import time
from typing import Callable

_source: Callable[[], float] = time.time
_perf: Callable[[], float] = time.perf_counter


def now() -> float:
    """Current semantic wall-clock time (seconds since epoch, or
    virtual seconds when a virtual clock is installed)."""
    return _source()


def set_source(fn: Callable[[], float]) -> None:
    """Install a replacement time source (e.g. a VirtualClock's
    ``now``).  Affects every thread in the process — callers own the
    responsibility to :func:`reset` when done (in a ``finally``)."""
    global _source
    _source = fn


def perf() -> float:
    """Monotonic instant for span durations (seconds; no defined
    epoch): ``perf_counter`` unless a simulator installed its clock."""
    return _perf()


def set_perf_source(fn: Callable[[], float]) -> None:
    """Install a replacement duration source for spans.  Same process-
    wide scope and reset obligation as :func:`set_source`."""
    global _perf
    _perf = fn


def is_virtual() -> bool:
    """True while a replacement time source is installed."""
    return _source is not time.time


def reset() -> None:
    """Restore the real wall clock (both sources)."""
    global _source, _perf
    _source = time.time
    _perf = time.perf_counter
