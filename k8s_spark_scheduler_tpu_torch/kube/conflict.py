"""Unified 409-Conflict discipline: get → refresh resourceVersion → retry.

Every optimistic-concurrency write in the scheduler resolves a 409 the
same way the reference does (async.go:111-120): re-read the object,
rebase the mutation on the server's resourceVersion, and retry.  Before
this module each write site hand-rolled that loop (the async
write-back's inline recursion, the unschedulable marker's swallow-all);
they now share :func:`run_with_conflict_retry`, which adds two things
the ad-hoc sites lacked:

- **capped full jitter** between attempts, because N replicas' workers
  re-colliding on the same object need desynchronizing;
- a ``tpu.kube.conflict.retry.count`` metric, so dashboards see
  conflict churn (a rising rate means two writers think they own a
  key).

Only :class:`~.errors.ConflictError` is handled here; every other
error propagates to the caller's taxonomy (NotFound, namespace
terminating, breaker accounting) unchanged.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, TypeVar

from .errors import ConflictError

logger = logging.getLogger(__name__)

T = TypeVar("T")

# conflicts resolve in milliseconds (one competing write), so the
# window starts small and caps low: full jitter over a doubling window
CONFLICT_BACKOFF_INITIAL_S = 0.02
CONFLICT_BACKOFF_CAP_S = 1.0
DEFAULT_MAX_ATTEMPTS = 5


def conflict_backoff_delay(backoff: float, rng=random) -> float:
    """One full-jitter delay draw: uniform over [0, min(backoff, cap)]."""
    return rng.uniform(0.0, min(backoff, CONFLICT_BACKOFF_CAP_S))


def next_conflict_backoff(backoff: float) -> float:
    return min(backoff * 2, CONFLICT_BACKOFF_CAP_S)


def run_with_conflict_retry(
    attempt: Callable[[], T],
    refresh: Callable[[], bool],
    *,
    kind: str = "",
    metrics=None,
    max_attempts: int = DEFAULT_MAX_ATTEMPTS,
    rng=random,
    sleep: Callable[[float], None] = time.sleep,
) -> Optional[T]:
    """Run ``attempt()``; on 409, ``refresh()`` then retry with jitter.

    ``attempt`` performs the write and may abort by returning None (the
    object vanished locally).  ``refresh`` re-reads the server copy and
    rebases — returning False aborts the loop (the key is gone or no
    longer ours to write).  Exhausted attempts re-raise the last
    ConflictError so callers see the failure through their normal error
    taxonomy.
    """
    backoff = CONFLICT_BACKOFF_INITIAL_S
    for i in range(max_attempts):
        try:
            return attempt()
        except ConflictError:
            if metrics is not None:
                from ..metrics import names as mnames

                metrics.counter(mnames.KUBE_CONFLICT_RETRIES, {"kind": kind})
            if i == max_attempts - 1:
                raise
            if not refresh():
                return None
            if i > 0:
                # first retry is immediate (the rebase alone resolves
                # the single-competitor case); later ones jitter so
                # replica herds spread out
                sleep(conflict_backoff_delay(backoff, rng))
                backoff = next_conflict_backoff(backoff)
    return None
