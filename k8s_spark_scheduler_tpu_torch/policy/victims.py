"""Gang-aware victim selection: whole-application victim sets, never
partial gangs, each set validated by a what-if solve (the reference
package's ``policy/victims.py``; the what-if check stays its numpy
rule).

Candidates are running applications (one ResourceReservation each) in
the preemptor's instance group whose band rank sits at least
``preemption_min_band_gap`` below the preemptor's — optionally widened
by DRF over-share tenants — seeded/ordered so that apps the explainer
already named as blockers are tried first.  Scoring follows Borg's
eviction order (Verma et al., EuroSys'15): lowest band first, then
youngest first (least work lost), then largest footprint first (fewest
gangs disturbed).

Victim sets accumulate greedily a WHOLE application at a time (the
I-P1 invariant — partial-gang eviction is impossible by construction:
the unit of selection is the app, and every pod of a selected app is
evicted together).  Each accumulated set is validated by
:func:`whatif_fits` — the solver's own admission rule on
``avail + freed`` — before it is ever offered to the committer.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import timesource
from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from .ordering import Gang, gang_feasible


def whatif_fits(
    avail: np.ndarray,
    exec_ok: np.ndarray,
    driver_rank: np.ndarray,
    freed: np.ndarray,
    gang: Gang,
) -> bool:
    """Would the preemptor's gang admit after the victims' capacity is
    returned?  Exactly the solver's admission rule on the post-eviction
    basis ``avail + freed`` — a True verdict is a statement about the
    real solver, not a heuristic."""
    return gang_feasible(avail + freed, exec_ok, driver_rank, gang)


@dataclass
class VictimCandidate:
    """One whole running application, with everything the committer
    needs: the pods to delete and the capacity its eviction returns."""

    namespace: str
    app_id: str
    band: str
    band_rank: int
    tenant: str
    created: float
    # [N,3] base-unit capacity this app's reservations return per node
    freed: np.ndarray
    # bound pod names (driver + executors) — evicted together or not at all
    pods: List[str] = field(default_factory=list)

    @property
    def footprint(self) -> int:
        return int(self.freed.sum())


@dataclass
class VictimPlan:
    """A validated eviction plan for one preemptor."""

    preemptor_app: str
    preemptor_band: str
    victims: List[VictimCandidate]
    whatif_ms: float
    lane: str  # "session" when validated against the warm delta-solve basis

    @property
    def victim_apps(self) -> List[str]:
        return [v.app_id for v in self.victims]


@guarded_by("_lock", "_stats")
class VictimSelector:
    """Selects and what-if-validates whole-application victim sets.

    Pure function of its inputs apart from the stats ledger; the engine
    supplies ``list_rrs`` (live ResourceReservations), ``band_fn`` (rr →
    (band, rank) via the driver pod's label) and ``tenant_fn``."""

    def __init__(
        self,
        list_rrs: Callable[[], list],
        band_fn: Callable[[object], Tuple[str, int]],
        tenant_fn: Callable[[str, str], str],
        min_band_gap: int = 1,
        max_victims: int = 4,
    ):
        self._list_rrs = list_rrs
        self._band_fn = band_fn
        self._tenant_fn = tenant_fn
        self._min_band_gap = max(int(min_band_gap), 0)
        self._max_victims = max(int(max_victims), 1)
        self._lock = threading.Lock()
        self._stats = {"attempts": 0, "validated": 0, "rejected": 0}

    # -- candidate enumeration ------------------------------------------

    def candidates(
        self,
        preemptor_rank: int,
        node_index: Dict[str, int],
        n_nodes: int,
        over_share: Dict[str, float] = None,
        blockers: Tuple[str, ...] = (),
    ) -> List[VictimCandidate]:
        """Running apps eligible as victims, best-victim-first.  An app
        qualifies by band gap OR (when DRF preemption is active) by its
        tenant being over fair share; apps named in the explainer's
        blocker set sort ahead of equal-scored peers."""
        from ..ops.tensorize import _resources_to_base

        over_share = over_share or {}
        blocker_set = set(blockers)
        out: List[VictimCandidate] = []
        for rr in self._list_rrs():
            band, rank = self._band_fn(rr)
            tenant = self._tenant_fn(rr.namespace, rr.name)
            by_gap = rank <= preemptor_rank - self._min_band_gap
            by_share = tenant in over_share
            if not (by_gap or by_share):
                continue
            freed = np.zeros((n_nodes, 3), dtype=np.int64)
            touched = False
            for res in rr.spec.reservations.values():
                idx = node_index.get(res.node)
                if idx is None:
                    continue
                row, _exact = _resources_to_base(res.resources_value())
                freed[idx] += np.asarray(row, dtype=np.int64)
                touched = True
            if not touched:
                # app holds nothing on any live node — evicting it
                # frees nothing, never a useful victim
                continue
            out.append(
                VictimCandidate(
                    namespace=rr.namespace,
                    app_id=rr.name,
                    band=band,
                    band_rank=rank,
                    tenant=tenant,
                    created=float(rr.meta.creation_timestamp),
                    freed=freed,
                    pods=sorted(set(rr.status.pods.values())),
                )
            )
        out.sort(
            key=lambda c: (
                c.app_id not in blocker_set,  # blockers first
                c.band_rank,                  # lowest band first
                -c.created,                   # youngest first
                -c.footprint,                 # largest footprint first
                c.app_id,
            )
        )
        return out

    # -- selection + what-if validation ---------------------------------

    def select(
        self,
        preemptor_app: str,
        preemptor_band: str,
        preemptor_rank: int,
        gang: Gang,
        avail: np.ndarray,
        exec_ok: np.ndarray,
        driver_rank: np.ndarray,
        node_index: Dict[str, int],
        over_share: Dict[str, float] = None,
        blockers: Tuple[str, ...] = (),
        session_validate: Callable[[np.ndarray], Optional[bool]] = None,
    ) -> Optional[VictimPlan]:
        """Greedy whole-app accumulation up to ``max_victims``, what-if
        validating after each addition; returns the first (smallest)
        validated set, or None when no eligible set makes the gang fit.

        ``session_validate(freed)`` — when supplied — re-proves the
        winning set against the warm delta-solve session basis; None
        (session unavailable) falls back to the numpy verdict."""
        with self._lock:
            racecheck.note_access(self, "_stats")
            self._stats["attempts"] += 1
        t0 = timesource.perf()
        cands = self.candidates(
            preemptor_rank, node_index, avail.shape[0], over_share, blockers
        )
        chosen: List[VictimCandidate] = []
        freed = np.zeros_like(avail)
        plan = None
        for cand in cands:
            if len(chosen) >= self._max_victims:
                break
            chosen.append(cand)
            freed = freed + cand.freed
            if not whatif_fits(avail, exec_ok, driver_rank, freed, gang):
                continue
            lane = "numpy"
            if session_validate is not None:
                verdict = session_validate(freed)
                if verdict is False:
                    continue
                if verdict is True:
                    lane = "session"
            plan = VictimPlan(
                preemptor_app=preemptor_app,
                preemptor_band=preemptor_band,
                victims=list(chosen),
                whatif_ms=(timesource.perf() - t0) * 1e3,
                lane=lane,
            )
            break
        with self._lock:
            racecheck.note_access(self, "_stats")
            self._stats["validated" if plan else "rejected"] += 1
        return plan

    def stats(self) -> Dict[str, int]:
        with self._lock:
            racecheck.note_access(self, "_stats")
            return dict(self._stats)
