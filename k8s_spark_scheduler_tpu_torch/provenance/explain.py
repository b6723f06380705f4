"""The unschedulability explainer: shortfall vectors + blocker sets.

Wraps the queue walk of :func:`..ops.explain.explain_queue` (one launch
of the queue kernel on the solver's device; the reference's is the
native ``fifo_explain_queue``) and translates its scaled-integer
decomposition back into operator vocabulary: resource dimension names,
base-unit magnitudes, node names and zones, and earlier-driver pod
names.  Diagnostic only — explain output never feeds a decision.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DIM_NAMES = ("cpu", "memory", "nvidia.com/gpu")
# base units per dimension (ops/tensorize._to_base_units): milli-cpu,
# bytes, milli-gpu
DIM_UNITS = ("milli-cpu", "bytes", "milli-gpu")


@dataclass
class ShortfallInfo:
    """One refused gang's decomposed verdict, in operator units."""

    kind: str                 # "capacity" | "driver-placement"
    tightest_dim: int         # index into DIM_NAMES; -1 = driver-blocked
    dim_name: str             # "" when driver-blocked
    shortfall_execs: int      # executors short in the tightest dimension
    shortfall_base: int       # same, in base units of that dimension
    unit: str
    cap_total: int            # cluster-wide executor capacity (clamped)
    gang_size: int
    dim_totals: Tuple[int, int, int]  # per-dim-alone capacity totals
    nearest_node: str         # best single node ("" = none)
    nearest_zone: str
    nearest_cap: int
    driver_fit: int           # candidates whose availability covers the driver
    flip: int                 # queue position that flipped feasibility
    blockers: List[str] = field(default_factory=list)  # earlier driver pods

    @property
    def blocker_count(self) -> int:
        return len(self.blockers)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "tightestDimension": self.dim_name or None,
            "shortfallExecutors": self.shortfall_execs,
            "shortfallBaseUnits": self.shortfall_base,
            "unit": self.unit if self.dim_name else None,
            "capacityTotal": self.cap_total,
            "gangSize": self.gang_size,
            "dimensionTotals": {
                DIM_NAMES[j]: int(self.dim_totals[j]) for j in range(3)
            },
            "nearestFitNode": self.nearest_node or None,
            "nearestFitZone": self.nearest_zone or None,
            "nearestFitCapacity": self.nearest_cap,
            "driverCandidatesFitting": self.driver_fit,
            "flipPosition": self.flip,
            "blockedByCount": self.blocker_count,
            "blockedBy": list(self.blockers),
        }


def shortfall_message(info: ShortfallInfo) -> str:
    """The actionable one-liner threaded into FailedNodes messages:
    ``short 12 executors (24000 milli-cpu) in cpu, zone az-b; blocked by
    3 earlier drivers``."""
    if info.kind == "driver-placement":
        if info.driver_fit == 0:
            msg = "gang capacity sufficient but no candidate node fits the driver row"
        else:
            msg = (
                "gang capacity sufficient only without the driver placed: "
                f"hosting it on any of the {info.driver_fit} fitting "
                "candidates drops executor capacity below the gang size"
            )
    else:
        where = f" near {info.nearest_node}" if info.nearest_node else ""
        zone = f" (zone {info.nearest_zone})" if info.nearest_zone else ""
        msg = (
            f"short {info.shortfall_execs} executors"
            f" ({info.shortfall_base} {info.unit}) in {info.dim_name}"
            f"{where}{zone}"
        )
    if info.blocker_count:
        names = ", ".join(info.blockers[:3])
        more = "…" if info.blocker_count > 3 else ""
        msg += f"; blocked by {info.blocker_count} earlier drivers ({names}{more})"
    elif info.flip == -2:
        msg += "; not blocked by the pending queue — current capacity is short"
    return msg


def explain_refusal(artifacts, target: int) -> Optional[ShortfallInfo]:
    """Run the explainer for the app at queue position ``target`` of a
    captured solve on the solve's device, translating indices back to
    names.  None when the target is feasible."""
    from ..ops.explain import explain_queue

    res = explain_queue(
        artifacts.basis,
        artifacts.driver_rank,
        artifacts.exec_ok,
        artifacts.packed,
        artifacts.policy_code,
        target,
        device=artifacts.device,
    )
    if res is None or res.feasible:
        return None

    names = artifacts.node_names
    nearest_node = ""
    nearest_zone = ""
    if 0 <= res.max_node < len(names):
        nearest_node = names[res.max_node]
        nearest_zone = artifacts.zone_of(res.max_node)

    gang = int(artifacts.packed[target, 6])
    if res.tightest_dim >= 0:
        j = res.tightest_dim
        # scaled units × the tensorize scale vector = base units
        per_exec = int(artifacts.packed[target, 3 + j]) * int(
            artifacts.scale[j]
        )
        info = ShortfallInfo(
            kind="capacity",
            tightest_dim=j,
            dim_name=DIM_NAMES[j],
            shortfall_execs=res.shortfall_execs,
            shortfall_base=res.shortfall_execs * per_exec,
            unit=DIM_UNITS[j],
            cap_total=res.cap_total,
            gang_size=gang,
            dim_totals=res.dim_totals,
            nearest_node=nearest_node,
            nearest_zone=nearest_zone,
            nearest_cap=res.max_cap,
            driver_fit=res.driver_fit,
            flip=res.flip,
        )
    else:
        info = ShortfallInfo(
            kind="driver-placement",
            tightest_dim=-1,
            dim_name="",
            shortfall_execs=0,
            shortfall_base=0,
            unit="",
            cap_total=res.cap_total,
            gang_size=gang,
            dim_totals=res.dim_totals,
            nearest_node=nearest_node,
            nearest_zone=nearest_zone,
            nearest_cap=res.max_cap,
            driver_fit=res.driver_fit,
            flip=res.flip,
        )
    qnames = artifacts.queue_names
    info.blockers = [
        (qnames[i] if i < len(qnames) else f"queue-position-{i}")
        for i in range(min(len(res.blockers), artifacts.n_earlier))
        if res.blockers[i]
    ]
    return info
