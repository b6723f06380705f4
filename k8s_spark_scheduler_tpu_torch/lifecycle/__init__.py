"""Gang lifecycle ledger + SLO burn-rate engine (the reference
package's ``lifecycle/``).

The ledger tracks every application through
submitted → … → completed/evicted/expired off the change feed and the
event log — never under the predicate lock; the SLO engine judges the
stream against declarative objectives with multi-window multi-burn-rate
alerting; the scorecard renders both into the one schema the reference
shares between ``GET /slo``, its simulator and its policy-regression
gate.
"""

from .ledger import PHASES, TERMINAL, GangRecord, LifecycleLedger
from .scorecard import (
    SCHEMA_NAME,
    SCHEMA_VERSION,
    build_scorecard,
    scorecard_diff,
    scorecard_digest,
)
from .slo import DEFAULT_ALERT_POLICY, DEFAULT_OBJECTIVES, Objective, SloEngine

__all__ = [
    "PHASES",
    "TERMINAL",
    "GangRecord",
    "LifecycleLedger",
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "build_scorecard",
    "scorecard_diff",
    "scorecard_digest",
    "DEFAULT_ALERT_POLICY",
    "DEFAULT_OBJECTIVES",
    "Objective",
    "SloEngine",
]
