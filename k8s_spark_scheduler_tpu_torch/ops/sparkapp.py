"""Tiny adapter type so ops/ doesn't depend on scheduler/."""

from __future__ import annotations

from dataclasses import dataclass

from ..types.resources import Resources


@dataclass
class AppDemand:
    driver_resources: Resources
    executor_resources: Resources
    min_executor_count: int
