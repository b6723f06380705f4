"""Declarative matrix experiment specs; a copy of the reference
package's ``lab/spec.py`` (the same cell ids and spec digests).

A matrix spec is a reviewable JSON document: one shared trace + cluster
shape, and an ``axes`` block whose cross product is the cell set.  The
spec layer owns validation (up front, with actionable dotted-path
messages — same contract satellite 1 adds to ``sim/scenario.py``) and
deterministic expansion: cell ids are derived from axis values, the
expansion order is the sorted cross product, and the spec digest covers
the canonicalized document so a matrix baseline can say exactly which
experiment it gates.
"""

from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_KNOWN_KEYS = {
    "name",
    "trace",
    "cluster",
    "axes",
    "horizon",
    "bands",
    "min_band_gap",
    "max_victims",
    "backfill_depth",
    "window_scale",
    "slo_overrides",
    "arrival_limit",
}
_KNOWN_CLUSTER = {"nodes", "node_cpu", "node_memory", "max_extra_nodes"}
_KNOWN_AXES = {
    "ordering",
    "preemption",
    "backfill",
    "drf_weights",
    "autoscaler_lag",
    "chaos",
}
_ORDERINGS = {"fifo", "priority-then-fifo", "drf"}


class SpecError(ValueError):
    """Actionable matrix-spec validation failure."""


def _axis_token(name: str, value) -> str:
    """Stable short token naming one axis value inside a cell id."""
    if name == "ordering":
        return {"fifo": "fifo", "priority-then-fifo": "prio", "drf": "drf"}[value]
    if name == "preemption":
        return "pre" if value else "nopre"
    if name == "backfill":
        return "bf" if value else "nobf"
    if name == "drf_weights":
        if not value:
            return "w-flat"
        blob = json.dumps(value, sort_keys=True, separators=(",", ":"))
        return "w-" + hashlib.sha256(blob.encode()).hexdigest()[:6]
    if name == "autoscaler_lag":
        return "as-off" if value is None else f"as{int(value)}"
    if name == "chaos":
        return "chaos" if value else "calm"
    return str(value)


@dataclass
class MatrixCell:
    """One expanded cell: id + the full engine configuration."""

    cell_id: str
    axes: Dict
    cfg: Dict


@dataclass
class MatrixSpec:
    name: str = "matrix"
    trace: str = ""
    cluster: Dict = field(
        default_factory=lambda: {"nodes": 16, "node_cpu": "16", "node_memory": "64Gi"}
    )
    axes: Dict = field(default_factory=dict)
    horizon: float = 0.0
    bands: Optional[Dict[str, int]] = None
    min_band_gap: int = 1
    max_victims: int = 4
    backfill_depth: int = 32
    window_scale: float = 1.0
    slo_overrides: Optional[Dict] = None
    arrival_limit: int = 0  # 0 = replay the whole trace

    @staticmethod
    def from_dict(d: Dict) -> "MatrixSpec":
        if not isinstance(d, dict):
            raise SpecError(f"matrix spec: expected an object, got {type(d).__name__}")
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise SpecError(
                f"matrix spec: unknown keys {sorted(unknown)} (known: {sorted(_KNOWN_KEYS)})"
            )
        cluster = d.get("cluster", {})
        if not isinstance(cluster, dict):
            raise SpecError(
                f"matrix.cluster: expected an object, got {type(cluster).__name__}"
            )
        unknown = set(cluster) - _KNOWN_CLUSTER
        if unknown:
            raise SpecError(
                f"matrix.cluster: unknown keys {sorted(unknown)} "
                f"(known: {sorted(_KNOWN_CLUSTER)})"
            )
        axes = d.get("axes", {})
        if not isinstance(axes, dict):
            raise SpecError(f"matrix.axes: expected an object, got {type(axes).__name__}")
        unknown = set(axes) - _KNOWN_AXES
        if unknown:
            raise SpecError(
                f"matrix.axes: unknown axes {sorted(unknown)} (known: {sorted(_KNOWN_AXES)})"
            )
        spec = MatrixSpec(
            name=str(d.get("name", "matrix")),
            trace=str(d.get("trace", "")),
            cluster={**MatrixSpec().cluster, **cluster},
            axes={k: list(v) for k, v in axes.items()},
            horizon=float(d.get("horizon", 0.0)),
            bands=d.get("bands"),
            min_band_gap=int(d.get("min_band_gap", 1)),
            max_victims=int(d.get("max_victims", 4)),
            backfill_depth=int(d.get("backfill_depth", 32)),
            window_scale=float(d.get("window_scale", 1.0)),
            slo_overrides=d.get("slo_overrides"),
            arrival_limit=int(d.get("arrival_limit", 0)),
        )
        spec.validate()
        return spec

    def validate(self) -> None:
        for name, values in self.axes.items():
            if not isinstance(values, list) or not values:
                raise SpecError(
                    f"matrix.axes.{name}: expected a non-empty list of values"
                )
            if name == "ordering":
                for v in values:
                    if v not in _ORDERINGS:
                        raise SpecError(
                            f"matrix.axes.ordering: unknown ordering {v!r} "
                            f"(known: {sorted(_ORDERINGS)})"
                        )
            elif name in ("preemption", "backfill"):
                for v in values:
                    if not isinstance(v, bool):
                        raise SpecError(
                            f"matrix.axes.{name}: expected booleans, got {v!r}"
                        )
            elif name == "drf_weights":
                for v in values:
                    if v is not None and not isinstance(v, dict):
                        raise SpecError(
                            f"matrix.axes.drf_weights: expected null or "
                            f"tenant->weight objects, got {v!r}"
                        )
            elif name == "autoscaler_lag":
                for v in values:
                    if v is not None and (
                        isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0
                    ):
                        raise SpecError(
                            f"matrix.axes.autoscaler_lag: expected null or "
                            f"seconds >= 0, got {v!r}"
                        )
            elif name == "chaos":
                for v in values:
                    if v is not None and not isinstance(v, dict):
                        raise SpecError(
                            f"matrix.axes.chaos: expected null or "
                            f"{{at, duration[, every]}} objects, got {v!r}"
                        )
        nodes = self.cluster.get("nodes", 16)
        if isinstance(nodes, bool) or not isinstance(nodes, int) or nodes < 1:
            raise SpecError(f"matrix.cluster.nodes: expected a positive int, got {nodes!r}")

    def digest(self) -> str:
        """Canonical digest of the spec document (cells + config)."""
        blob = json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "trace": self.trace,
            "cluster": self.cluster,
            "axes": self.axes,
            "horizon": self.horizon,
            "bands": self.bands,
            "min_band_gap": self.min_band_gap,
            "max_victims": self.max_victims,
            "backfill_depth": self.backfill_depth,
            "window_scale": self.window_scale,
            "slo_overrides": self.slo_overrides,
            "arrival_limit": self.arrival_limit,
        }

    def expand(self) -> List[MatrixCell]:
        """Cross product of the axes, in deterministic order.  Axes not
        named in the spec take the single default value."""
        defaults = {
            "ordering": ["fifo"],
            "preemption": [False],
            "backfill": [False],
            "drf_weights": [None],
            "autoscaler_lag": [None],
            "chaos": [None],
        }
        axis_names = list(defaults)
        values = [self.axes.get(n, defaults[n]) for n in axis_names]
        cells: List[MatrixCell] = []
        for combo in itertools.product(*values):
            axes = dict(zip(axis_names, combo))
            tokens = [
                _axis_token(n, axes[n])
                for n in axis_names
                if n in self.axes  # only spec-varied axes name the cell
            ]
            cell_id = "-".join(tokens) if tokens else "cell"
            cfg = {
                "cell_id": cell_id,
                "ordering": axes["ordering"],
                "preemption": axes["preemption"],
                "backfill": axes["backfill"],
                "drf_weights": axes["drf_weights"],
                "autoscaler_lag": axes["autoscaler_lag"],
                "chaos": axes["chaos"],
                "nodes": self.cluster.get("nodes", 16),
                "node_cpu": self.cluster.get("node_cpu", "16"),
                "node_memory": self.cluster.get("node_memory", "64Gi"),
                "max_extra_nodes": self.cluster.get(
                    "max_extra_nodes", self.cluster.get("nodes", 16)
                ),
                "horizon": self.horizon,
                "min_band_gap": self.min_band_gap,
                "max_victims": self.max_victims,
                "backfill_depth": self.backfill_depth,
                "window_scale": self.window_scale,
                "slo_overrides": self.slo_overrides,
            }
            if self.bands:
                cfg["bands"] = self.bands
            cells.append(MatrixCell(cell_id=cell_id, axes=axes, cfg=cfg))
        ids = [c.cell_id for c in cells]
        if len(set(ids)) != len(ids):
            raise SpecError("matrix spec: duplicate cell ids after expansion")
        return cells
