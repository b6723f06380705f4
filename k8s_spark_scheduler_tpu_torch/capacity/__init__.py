"""Capacity observatory: cluster-state analytics as first-class
scheduler outputs (fragmentation, headroom, pending-work pressure)
built on the same exact integer math as the solver itself; a copy of
the reference package's ``capacity/``.

- :mod:`.probe` — what-if feasibility probes: the largest admissible
  gang per resource shape (bisection over the monotone feasibility
  rule) and a per-dimension fragmentation report, each ONE batched
  PyTorch program on the server's device over every shape and every
  (instance-group, zone) segment at once.
- :mod:`.observatory` — the background :class:`CapacitySampler`:
  triggered by the state layer's ChangeFeed sequence (sample only on
  state change, debounced), NEVER under the extender lock, producing a
  bounded queryable timeline (``GET /state/capacity*``), Prometheus
  gauges, and time-to-admit forecasts for queued drivers.

Everything here is read-only diagnostics: no scheduling decision ever
consumes an observatory output.
"""

from __future__ import annotations

import threading

# -- extender-lock flag -------------------------------------------------------
#
# The sampler runs ZERO probes while the extender (predicate) lock is
# held: sampling must never stretch lock hold time, directly or by
# running inside a decision.  threading.Lock has no owner
# introspection, so the extender marks lock tenure in a thread-local and
# the sampler (and the lifecycle ledger's drain) refuses to run, and
# counts the violation, when invoked from a lock-holding thread.
#
# Defined BEFORE the submodule imports below: observatory.py reads
# in_predicate_lock from this partially-initialized package.

_tenure = threading.local()


def enter_predicate_lock() -> None:
    _tenure.depth = getattr(_tenure, "depth", 0) + 1


def exit_predicate_lock() -> None:
    _tenure.depth = max(getattr(_tenure, "depth", 0) - 1, 0)


def in_predicate_lock() -> bool:
    return getattr(_tenure, "depth", 0) > 0


from .observatory import CapacitySample, CapacitySampler  # noqa: E402,F401
from .probe import frag_segments, probe_segments  # noqa: E402,F401
