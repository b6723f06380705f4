"""Scorecard: the one schema judged by operators and CI.

``build_scorecard`` renders the JSON document ``GET /slo`` serves, in
the schema of the reference package's scorecard (its server and its
simulator emit the same one), so dashboards and the policy-regression
gate never fork on source.  ``scorecard_digest`` hashes the
deterministic subset — schema, objective outcomes, lifecycle counts —
with floats rounded and the free-form ``meta`` block excluded, so a
re-run on a virtual clock yields a byte-identical digest and a policy
change that shifts any outcome shows up as a digest mismatch.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

from .. import timesource

SCHEMA_NAME = "tpu-gang-scheduler-scorecard"
SCHEMA_VERSION = 1

# operational health counters in the lifecycle summary: how often the
# drain loop ran, not what the scheduler decided.  They depend on thread
# timing (a background drain racing shutdown shifts them by one), so the
# policy digest excludes them — they stay visible in the document
_OPERATIONAL_LIFECYCLE_KEYS = ("drains", "lockViolations")


def _digest_lifecycle(lifecycle: Any) -> Any:
    if not isinstance(lifecycle, dict):
        return lifecycle
    return {
        k: v
        for k, v in lifecycle.items()
        if k not in _OPERATIONAL_LIFECYCLE_KEYS
    }


def build_scorecard(
    ledger,
    slo,
    meta: Optional[Dict[str, Any]] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """One scorecard document.  ``meta`` (source, scenario, seed,
    asOf…) is display-only and excluded from the digest."""
    now = timesource.now() if now is None else now
    card: Dict[str, Any] = {
        "schema": {"name": SCHEMA_NAME, "version": SCHEMA_VERSION},
        "meta": dict(meta or {}),
        "objectives": slo.status(now=now) if slo is not None else {},
        "lifecycle": ledger.summary() if ledger is not None else {},
    }
    card["digest"] = scorecard_digest(card)
    return card


def scorecard_digest(card: Dict[str, Any]) -> str:
    """sha256 over the canonical deterministic subset of a scorecard
    (everything except ``meta`` and the digest itself)."""
    body = {
        "schema": card.get("schema", {}),
        "objectives": card.get("objectives", {}),
        "lifecycle": _digest_lifecycle(card.get("lifecycle", {})),
    }
    canonical = json.dumps(
        _canonical(body), sort_keys=True, separators=(",", ":")
    )
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


def scorecard_diff(a: Dict[str, Any], b: Dict[str, Any]) -> list:
    """Leaf-level differences between two scorecards' digested bodies:
    ``(path, a_value, b_value)`` tuples, for actionable gate output."""
    out: list = []
    _walk_diff(
        {
            "schema": a.get("schema"),
            "objectives": a.get("objectives"),
            "lifecycle": _digest_lifecycle(a.get("lifecycle")),
        },
        {
            "schema": b.get("schema"),
            "objectives": b.get("objectives"),
            "lifecycle": _digest_lifecycle(b.get("lifecycle")),
        },
        "",
        out,
    )
    return out


def _walk_diff(a: Any, b: Any, path: str, out: list) -> None:
    # a whole nested block added/removed on one side: descend so every
    # sub-leaf is reported against "<absent>" (actionable paths), rather
    # than one opaque dict-valued tuple
    if a == "<absent>" and isinstance(b, dict) and b:
        a = {}
    if b == "<absent>" and isinstance(a, dict) and a:
        b = {}
    if isinstance(a, dict) and isinstance(b, dict):
        for key in sorted(set(a) | set(b)):
            _walk_diff(
                a.get(key, "<absent>"),
                b.get(key, "<absent>"),
                f"{path}.{key}" if path else str(key),
                out,
            )
        return
    if _canonical(a) != _canonical(b):
        out.append((path, a, b))


def _canonical(value: Any) -> Any:
    """Round floats (exposition noise must not churn digests) and
    normalize containers for stable JSON."""
    if isinstance(value, float):
        return round(value, 9)
    if isinstance(value, dict):
        return {str(k): _canonical(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_canonical(v) for v in value]
    return value
