"""Concurrent admission: optimistic speculative solves + FIFO commits
(the reference package's ``concurrent/``).

The extender's critical path is solver tenure held under the single
predicate lock.  This package moves that tenure out from under the lock,
Borg/Omega style: independent Filter requests are solved *speculatively*
in parallel against ChangeFeed-seq-stamped snapshot bases — on the card,
each speculation's queue kernel on its request thread's own CUDA stream
— then committed through a **FIFO-ordered commit gate** that revalidates
each speculative verdict against the then-current basis (O(1) seq check
→ exact memcmp rescue → bounded re-solve on conflict) before the
reservation write-back.

The safety argument is by construction:

- commits execute strictly in ticket (arrival) order, one at a time,
  through the *unchanged* serial extender — the concurrent engine never
  emits a decision the serial FIFO scheduler would not have made;
- a speculative verdict is consumed only when the commit-time basis is
  *identical* to the speculation basis (same snapshot content key, or a
  byte-equal availability/schedulability memcmp, same earlier-drivers
  queue, same skip verdicts); anything else is a conflict and the
  normal warm delta-solve runs under the lock (the bounded re-solve);
- the speculative solve uses the stateless cold tensor lane on a
  per-thread solver clone on the shared solver's device, and warm ≡
  cold decision parity is pinned by the delta-solve parity guard — so a
  consumed verdict equals what the serial path would have computed on
  the identical basis.

Multi-active operation: standby replicas from the HA fabric serve
speculative solves against their own warm bases and forward
:class:`~.commitgate.CommitIntent`\\ s to the epoch-fenced committer,
which refuses intents formed under a stale leadership epoch
(:class:`~..ha.fencing.FencedWriter` already refuses the write-back
itself by construction).

Proof burden lives in the 5-seed byte-identity property test
(``tests/test_torch_concurrent.py``) and the crash matrix's three crash
points in the speculation→commit window.  The matrix's default cells
run the policy engine, as the reference's do, so their speculations
decline and they prove exactly-once recovery of serial commits; its
``policy=False`` cells die with a solved verdict in flight, or after a
commit consumed one (``tests/test_torch_ha_crashpoints.py``).
"""

from __future__ import annotations

from .commitgate import CommitGate, CommitIntent
from .engine import ConcurrentAdmissionEngine
from .speculation import SpeculativeVerdict, Speculator

__all__ = [
    "CommitGate",
    "CommitIntent",
    "ConcurrentAdmissionEngine",
    "SpeculativeVerdict",
    "Speculator",
]
