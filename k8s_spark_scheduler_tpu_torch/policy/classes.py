"""Priority classes: band parsing from pod labels into ranked bands
(the reference package's ``policy/classes.py``).

A *band* is a named priority class with an integer rank (higher rank =
more important), configured via ``Install.policy.bands`` and read from
the driver pod's ``Install.policy.band_label`` label.  Unknown or
missing labels fall back to ``default_band`` — an unlabeled cluster
degenerates to one band, which under every ordering reduces to plain
FIFO.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from ..analysis import racecheck
from ..analysis.guarded import guarded_by

# the label a driver pod carries to select its priority band
DEFAULT_BAND_LABEL = "spark-priority-band"
DEFAULT_BANDS = {"low": 0, "normal": 1, "high": 2}
DEFAULT_BAND = "normal"


@guarded_by("_lock", "_seen")
class PriorityLedger:
    """Band lookup + per-band observation counts for ``/policy/state``.

    The parse itself is a dict lookup; the guarded state is only the
    observation ledger (band → distinct app ids seen), kept so the
    operator surface can answer "which bands exist in this cluster"
    without a full pod scan."""

    def __init__(self, bands: Dict[str, int] = None, default_band: str = DEFAULT_BAND,
                 band_label: str = DEFAULT_BAND_LABEL):
        self.bands = dict(bands) if bands else dict(DEFAULT_BANDS)
        if default_band not in self.bands:
            # a config typo must not make every pod unparseable: fall
            # back to the lowest-ranked configured band
            default_band = min(self.bands, key=lambda b: self.bands[b])
        self.default_band = default_band
        self.band_label = band_label
        self._lock = threading.Lock()
        self._seen: Dict[str, set] = {}

    def band_of(self, pod) -> Tuple[str, int]:
        """(band name, rank) for a pod; unknown labels get the default
        band (never an error — policy misconfiguration must not refuse
        admission)."""
        name = pod.labels.get(self.band_label, self.default_band)
        rank = self.bands.get(name)
        if rank is None:
            name = self.default_band
            rank = self.bands[name]
        return name, rank

    def rank_of(self, pod) -> int:
        return self.band_of(pod)[1]

    def observe(self, pod, app_id: str) -> Tuple[str, int]:
        """band_of + ledger update (called on queue ordering, so the
        state endpoint reflects what the ordering actually saw)."""
        name, rank = self.band_of(pod)
        with self._lock:
            racecheck.note_access(self, "_seen")
            self._seen.setdefault(name, set()).add(app_id or pod.name)
        return name, rank

    def state(self) -> Dict[str, dict]:
        with self._lock:
            racecheck.note_access(self, "_seen")
            seen = {band: len(apps) for band, apps in self._seen.items()}
        return {
            band: {"rank": rank, "appsSeen": seen.get(band, 0)}
            for band, rank in sorted(self.bands.items(), key=lambda kv: -kv[1])
        }
