"""Scheduling-policy engine (the reference package's ``policy/``):
priority classes, pluggable queue ordering, gang-aware preemption, and
DRF fair share.

The subsystem turns the FIFO gate into a pluggable ordering+preemption
engine while keeping the default byte-identical to plain FIFO:

- :mod:`.classes` — priority-band parsing from pod labels into ranked
  bands (Borg's priority bands, Verma et al. EuroSys'15);
- :mod:`.ordering` — pluggable queue comparators (fifo,
  priority-then-fifo, DRF deficit) plus the conservative backfill
  probe (EASY-style: a lower-band app may fill current holes only if
  it provably cannot delay the blocked queue head);
- :mod:`.drf` — per-tenant dominant-share accounting off the state
  layer's change observers (Ghodsi et al. NSDI'11);
- :mod:`.victims` — whole-application victim selection with what-if
  validation (never partial gangs);
- :mod:`.preempt` — journaled eviction commit with exactly-once
  failover replay (the write-back intent journal's format);
- :mod:`.engine` — the facade the extender and wiring consume.

Every rule here is numpy on the host, as in the reference: the policy
decides which queued drivers count as earlier, in what order, and which
may be skipped; the queue kernels on the device then solve that queue.

With ``Install.policy.enabled = false`` (the default) no engine is
constructed and every extender hook is a single ``is None`` check —
decisions are byte-identical to pre-policy behavior (pinned by the
5-seed property test in tests/test_torch_policy.py).
"""

from .engine import PolicyEngine  # noqa: F401
