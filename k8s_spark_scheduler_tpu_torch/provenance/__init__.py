"""Decision provenance: the WHY behind every scheduling verdict.

The extender's answer to kube-scheduler is a bare fit/no-fit; the
span tree says where the time went but not why a driver was refused.
This package closes that gap end to end:

- :mod:`.records` — bounded per-decision records (snapshot content-key,
  change-feed seq, queue slice, verdicts, shortfall) in a ring the
  ``GET /explain/<pod>`` endpoint serves;
- :mod:`.explain` — the unschedulability explainer over the queue
  walk's shortfall vectors and blocker sets (``ops/explain.py``, one
  launch of the queue kernel): tightest dimension, magnitude,
  nearest-fit node, and which earlier FIFO drivers consumed the
  capacity this app needed;
- :mod:`.recorder` — the anomaly flight recorder: a bounded ring of
  replayable decision bundles persisted as JSONL when a trigger fires
  (deadline exceeded, circuit breaker open), replayed byte-for-byte
  through the queue kernel and its plain version with
  :func:`replay_bundle_file`;
- :mod:`.tracker` — the per-extender facade wiring it all together.

Everything here is diagnostic: provenance never feeds a decision, and
with ``provenance.enabled = false`` no capture code runs at all.
"""

from .explain import DIM_NAMES, ShortfallInfo, shortfall_message  # noqa: F401
from .records import DecisionRecord, ProvenanceRing  # noqa: F401
from .recorder import (  # noqa: F401
    DecisionBundle,
    FlightRecorder,
    replay_bundle,
    replay_bundle_file,
)
from .tracker import ProvenanceTracker, SolveArtifacts  # noqa: F401
