"""Contention observatory: lock wait/hold telemetry, critical-path
latency decomposition, and the data behind ``GET /debug/contention`` /
``GET /debug/criticalpath``; a copy of the reference package's
``contention/``, on by default as there (``Install.contention``).

- :mod:`.locktime` — ``TimedLock`` + the process-wide
  :class:`~.locktime.LockTimekeeper` switchboard: per-lock wait/hold
  reservoirs, span-phase holder attribution, top-blocker tables.
- :mod:`.criticalpath` — span-tree walker that decomposes each request
  into gate-queue / lock-wait / serde / solve / write-back / other.
"""

from .criticalpath import CriticalPathAnalyzer, decompose  # noqa: F401
from .locktime import LockTimekeeper, TimedLock  # noqa: F401
