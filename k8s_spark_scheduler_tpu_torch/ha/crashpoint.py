"""Named crash-point injection for failover testing; a copy of the
reference package's ``ha/crashpoint.py``.

``maybe_crash("journal.post-append")`` sits at every point where a
process death would leave interesting partial state: around the async
write-back's API calls, both journals' append/ack, preemption commit,
and lease renewal.  The registry below is the reference's whole sweep
set; the three ``concurrent.*`` points belong to the concurrent
admission engine, which this package does not have yet (ROADMAP A.4),
so nothing here traverses them.  The crash-matrix harness
(:mod:`.crashmatrix`) sweeps the others: scenario → crash at point k →
cold-restart recovery → invariant audit.

The disabled cost is ONE module-attribute read (``_ARMED is None``).
Arming is one-shot: the first traversal of the armed point raises and
disarms, so recovery after the simulated death cannot re-crash at the
same instruction.

:class:`SimulatedCrash` derives from **BaseException**, not Exception:
a real ``kill -9`` does not flow through ``except Exception`` recovery
handlers (the async worker loop catches Exception to keep draining),
and neither may the simulated one.
"""

from __future__ import annotations

import threading
from typing import List, Optional

# the armed point name, or None.  Read unsynchronized on every
# traversal (module-attr read; GIL-atomic), written under _ARM_LOCK.
_ARMED: Optional[str] = None
_ARM_LOCK = threading.Lock()
# every point name ever declared via register(); the crash matrix
# sweeps this
_POINTS: set = set()


class SimulatedCrash(BaseException):
    """The process 'died' at a crash point.  BaseException so recovery
    code's ``except Exception`` cannot accidentally survive it."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


def register(name: str) -> str:
    """Declare a crash point (module import time).  Returns the name so
    call sites can do ``PT = register("x.y")`` and pass the constant."""
    _POINTS.add(name)
    return name


def registered_points() -> List[str]:
    return sorted(_POINTS)


def arm(name: str) -> None:
    """Arm one point; the next traversal raises SimulatedCrash once."""
    global _ARMED
    if name not in _POINTS:
        raise ValueError(f"unknown crash point {name!r}; known: {registered_points()}")
    with _ARM_LOCK:
        _ARMED = name


def disarm() -> None:
    global _ARMED
    with _ARM_LOCK:
        _ARMED = None


def armed() -> Optional[str]:
    return _ARMED


def maybe_crash(name: str) -> None:
    """The hot-path check: one module-attr read when disabled."""
    if _ARMED is None:
        return
    _maybe_crash_slow(name)


def _maybe_crash_slow(name: str) -> None:
    global _ARMED
    with _ARM_LOCK:
        if _ARMED != name:
            return
        _ARMED = None  # one-shot: recovery must not re-die here
    raise SimulatedCrash(name)


# -- the registry ------------------------------------------------------------
# Declared here (not at the call sites) so ``registered_points()`` is
# complete after importing this module alone.

# async write-back pipeline (state/cache.py): around each API call
WRITEBACK_PRE_COMMIT = register("writeback.pre-commit")
WRITEBACK_POST_COMMIT = register("writeback.post-commit")
# intent journal (resilience/journal.py): divert + ack, both journals
JOURNAL_PRE_APPEND = register("journal.pre-append")
JOURNAL_POST_APPEND = register("journal.post-append")
JOURNAL_PRE_ACK = register("journal.pre-ack")
JOURNAL_POST_ACK = register("journal.post-ack")
# preemption commit (policy/preempt.py)
PREEMPT_POST_JOURNAL = register("preempt.post-journal")
PREEMPT_MID_EXECUTE = register("preempt.mid-execute")
PREEMPT_PRE_ACK = register("preempt.pre-ack")
# lease renewal (ha/__init__.py step loop)
LEASE_PRE_RENEW = register("lease.pre-renew")
# concurrent admission engine (concurrent/engine.py): the
# speculation→commit window — after the speculative solve, after the
# commit gate admits the revalidated verdict, and after the reservation
# write-back returned but before the response leaves
CONCURRENT_SPECULATION_SOLVED = register("concurrent.speculation-solved")
CONCURRENT_COMMIT_REVALIDATED = register("concurrent.commit-revalidated")
CONCURRENT_COMMIT_WRITTEN = register("concurrent.commit-written")
