"""Pluggable queue orders + the conservative backfill probe.

Orders map each pending driver to a sort key; the queue solve itself is
untouched — the policy only changes *which* drivers count as "earlier"
and in what sequence they are proved, so the gang-atomicity guarantee
(every queue-ahead app fits before this one admits) is preserved under
every ordering.

Backfill (EASY-style, conservative): a lower-band app may admit into
current holes past a blocked queue head only when a what-if placement
probe proves it cannot delay the head's earliest start — the candidate
consumes only capacity the head could not have used anyway.  The probe
reuses the solver's own admission rule (``step_app_plain`` semantics,
as the capacity probe), so a "safe" verdict is a statement about the
real solver, not a heuristic twin.

The reference package's ``policy/ordering.py``.  Its probe rule comes
from the reference's numpy ``capacity/probe.py``; this package's
``capacity/probe.py`` is a batched torch program, so the two numpy
functions the policy needs are copied here under the reference's names
(``caps_unclamped``, ``_feasible``; tests/test_torch_policy.py holds
``caps_unclamped`` to the torch one).  The policy's verdicts stay this
numpy rule, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_BIG = np.int64(2**62)
INT32_SAFE = 2**31 - 1


def caps_unclamped(
    avail: np.ndarray, exec_ok: np.ndarray, executor: np.ndarray
) -> np.ndarray:
    """Per-node executor capacity, UNCLAMPED (values ≤ 0 = ineligible):
    exact floor division per nonzero requirement dimension, a
    zero-requirement dimension binds only when its availability is
    overdrawn — capacity.go:36-75 semantics, the mf_cap_one formula."""
    caps = np.full(avail.shape[0], _BIG, dtype=np.int64)
    for j in range(3):
        e = int(executor[j])
        if e == 0:
            caps = np.where(avail[:, j] >= 0, caps, np.int64(-1))
        else:
            caps = np.minimum(
                caps, np.floor_divide(avail[:, j], max(e, 1))
            )
    return np.where(np.asarray(exec_ok, dtype=bool), caps, np.int64(0))


def _feasible(
    avail: np.ndarray,
    exec_ok: np.ndarray,
    cand_mask: np.ndarray,
    caps: np.ndarray,
    driver: np.ndarray,
    executor: np.ndarray,
    k: int,
) -> bool:
    """step_app_plain's admission rule at queue position 0."""
    if k <= 0:
        # a zero-executor gang admits iff some candidate covers the
        # driver row (total ≥ 0 is vacuous)
        return bool((cand_mask & (avail >= driver).all(axis=1)).any())
    ck = np.clip(caps, 0, k)
    total = int(ck.sum())
    if total < k:
        return False
    idx = np.flatnonzero(cand_mask & (avail >= driver).all(axis=1))
    if not len(idx):
        return False
    cwd = np.clip(
        caps_unclamped(avail[idx] - driver, exec_ok[idx], executor), 0, k
    )
    return bool((total - ck[idx] + cwd >= k).any())


ORDER_FIFO = "fifo"
ORDER_PRIORITY = "priority-then-fifo"
ORDER_DRF = "drf"
ORDERINGS = (ORDER_FIFO, ORDER_PRIORITY, ORDER_DRF)

# (driver_row[3], executor_row[3], count) in base units
Gang = Tuple[np.ndarray, np.ndarray, int]


def queue_sort_key(ordering: str, band_rank: int, dominant_share: float, pod):
    """Sort key for one pending driver.  Ties always break
    (creation_timestamp, name) so every ordering is a total order and
    the fifo ordering is EXACTLY the pre-policy comparator."""
    if ordering == ORDER_PRIORITY:
        return (-band_rank, pod.creation_timestamp, pod.name)
    if ordering == ORDER_DRF:
        # DRF deficit order: the tenant furthest BELOW its dominant
        # share goes first (Ghodsi et al. NSDI'11, progressive filling)
        return (dominant_share, pod.creation_timestamp, pod.name)
    return (pod.creation_timestamp, pod.name)


def gang_feasible(
    avail: np.ndarray, exec_ok: np.ndarray, driver_rank: np.ndarray, gang: Gang
) -> bool:
    """The solver's admission rule for one gang at queue position 0."""
    driver, executor, count = gang
    cand_mask = np.asarray(driver_rank, dtype=np.int64) < INT32_SAFE
    caps = caps_unclamped(avail, exec_ok, executor)
    return _feasible(avail, exec_ok, cand_mask, caps, driver, executor, int(count))


def place_gang(
    avail: np.ndarray, exec_ok: np.ndarray, driver_rank: np.ndarray, gang: Gang
) -> Optional[np.ndarray]:
    """Greedy deterministic placement: driver on the best-ranked fitting
    candidate, executors packed onto highest-capacity nodes.  Returns
    the availability AFTER placement, or None when the gang does not
    fit.  The placement is a lower bound on how much capacity any real
    placement would consume — sufficient for the conservative backfill
    verdict, which only compares before/after headroom."""
    driver, executor, count = gang
    if not gang_feasible(avail, exec_ok, driver_rank, gang):
        return None
    rank = np.asarray(driver_rank, dtype=np.int64)
    fits = (rank < INT32_SAFE) & (avail >= driver).all(axis=1)
    idx = np.flatnonzero(fits)
    if not len(idx):
        return None
    after = avail.copy()
    dnode = idx[np.argmin(rank[idx])]
    after[dnode] -= driver
    remaining = int(count)
    if remaining > 0:
        caps = np.clip(caps_unclamped(after, exec_ok, executor), 0, remaining)
        order = np.argsort(-caps, kind="stable")
        for i in order:
            if remaining <= 0:
                break
            k = int(min(caps[i], remaining))
            if k <= 0:
                break
            after[i] -= executor * k
            remaining -= k
        if remaining > 0:
            # greedy packing failed even though the admission rule
            # passed (cannot happen for step_app_plain semantics, but
            # fail closed rather than report a bogus placement)
            return None
    return after


def backfill_cannot_delay(
    avail: np.ndarray,
    exec_ok: np.ndarray,
    driver_rank: np.ndarray,
    head: Gang,
    candidate: Gang,
) -> bool:
    """True iff admitting ``candidate`` now provably cannot delay the
    blocked queue head's earliest start.

    Conservative rule: after the candidate's greedy placement, the
    head's feasibility verdict AND its clamped capacity total AND its
    driver-fitting candidate count must be unchanged — the candidate
    consumed only capacity the head could not have used.  Any probe
    failure (candidate infeasible, head capacity moved) refuses the
    backfill; refusing is always safe (the queue just stays FIFO).
    """
    after = place_gang(avail, exec_ok, driver_rank, candidate)
    if after is None:
        return False
    h_driver, h_executor, h_count = head
    rank = np.asarray(driver_rank, dtype=np.int64)
    cand_mask = rank < INT32_SAFE

    def head_view(basis: np.ndarray):
        caps = np.clip(
            caps_unclamped(basis, exec_ok, h_executor), 0, max(int(h_count), 1)
        )
        feasible = _feasible(
            basis, exec_ok, cand_mask, caps_unclamped(basis, exec_ok, h_executor),
            h_driver, h_executor, int(h_count),
        )
        driver_fit = int((cand_mask & (basis >= h_driver).all(axis=1)).sum())
        return feasible, int(caps.sum()), driver_fit

    before_view = head_view(avail)
    after_view = head_view(after)
    return before_view == after_view
