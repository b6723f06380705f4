"""Build the port's state from plain values.

A snapshot that another implementation also holds (the JAX package, a
test, a benchmark) is carried into this package's own types through plain
Python and numpy values, so both sides see identical state without this
package importing the other.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .ops.sparkapp import AppDemand
from .ops.tensorize import ScaledProblem
from .types.resources import ZONE_LABEL_PLACEHOLDER, NodeSchedulingMetadata, Resources
from .utils.quantity import QuantityLike


def resources_from_plain(values: Sequence[QuantityLike]) -> Resources:
    """(cpu, memory, gpu) as quantity strings, ints or Fractions."""
    cpu, memory, gpu = values
    return Resources.of(cpu, memory, gpu)


def metadata_from_plain(
    available: Sequence[QuantityLike],
    schedulable: Sequence[QuantityLike],
    zone_label: str = ZONE_LABEL_PLACEHOLDER,
    labels: Optional[Mapping[str, str]] = None,
    unschedulable: bool = False,
    ready: bool = True,
    creation_timestamp: float = 0.0,
) -> NodeSchedulingMetadata:
    return NodeSchedulingMetadata(
        available=resources_from_plain(available),
        schedulable=resources_from_plain(schedulable),
        creation_timestamp=creation_timestamp,
        zone_label=zone_label,
        all_labels=dict(labels or {}),
        unschedulable=unschedulable,
        ready=ready,
    )


def app_from_plain(
    driver: Sequence[QuantityLike], executor: Sequence[QuantityLike], min_executor_count: int
) -> AppDemand:
    return AppDemand(resources_from_plain(driver), resources_from_plain(executor), int(min_executor_count))


def problem_from_numpy(
    avail, driver_rank, exec_ok, driver, executor, count, app_valid, scale, ok: bool = True
) -> ScaledProblem:
    """A ScaledProblem from the numpy fields of another implementation's
    scaled problem (copied, with this package's dtypes)."""
    return ScaledProblem(
        avail=np.array(avail, dtype=np.int32),
        driver_rank=np.array(driver_rank, dtype=np.int32),
        exec_ok=np.array(exec_ok, dtype=bool),
        driver=np.array(driver, dtype=np.int32),
        executor=np.array(executor, dtype=np.int32),
        count=np.array(count, dtype=np.int32),
        app_valid=np.array(app_valid, dtype=bool),
        scale=np.array(scale, dtype=np.int64),
        ok=ok,
    )
