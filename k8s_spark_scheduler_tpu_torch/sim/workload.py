"""Seeded workload generation + JSONL trace replay; a copy of the
reference package's ``sim/workload.py`` (same seed, same apps).

An app spec is everything the simulator needs to play one Spark
application against the extender: arrival instant, gang shape (executor
count, static vs dynamic allocation), per-pod resources, and lifetime
(virtual seconds between the gang becoming fully bound and the app
terminating).

Arrival processes (all driven by one ``random.Random(seed)`` so a seed
fully determines the workload):

- ``poisson``: exponential inter-arrivals at ``rate_per_min``;
- ``burst``: ``burst_size`` simultaneous arrivals every
  ``burst_interval`` seconds (thundering-herd onboarding);
- ``diurnal``: inhomogeneous Poisson via thinning, rate swinging
  sinusoidally between ``rate_per_min`` and ``peak_rate_per_min`` with
  period ``period`` (daily load curve compressed into the sim horizon).

Traces dump/load as JSONL (one app per line) so a generated workload —
or one distilled from production — replays bit-identically.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass
from typing import Dict, List


@dataclass
class AppSpec:
    app_id: str
    arrival: float
    executor_count: int
    lifetime: float
    dynamic: bool = False
    min_executor_count: int = 0  # dynamic only; == executor_count when static
    driver_cpu: str = "1"
    driver_mem: str = "1Gi"
    executor_cpu: str = "1"
    executor_mem: str = "1Gi"
    instance_group: str = "batch-medium-priority"
    namespace: str = "default"
    # policy-engine inputs (policy/): priority band + fair-share tenant.
    # Defaults keep pre-policy traces replaying bit-identically.
    band: str = "normal"
    tenant: str = ""

    def to_dict(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "AppSpec":
        return AppSpec(**d)


# resource shapes drawn for generated apps: (driver_cpu, driver_mem,
# executor_cpu, executor_mem) — small menu so packing stays interesting
# without exploding the tensorizer's shape buckets
_SIZE_MENU = [
    ("1", "1Gi", "1", "1Gi"),
    ("1", "2Gi", "2", "2Gi"),
    ("2", "2Gi", "1", "4Gi"),
    ("1", "1Gi", "4", "4Gi"),
]


class WorkloadGenerator:
    """Seeded generator; ``spec`` is the scenario's ``workload`` dict."""

    def __init__(self, spec: Dict, seed: int):
        self.spec = dict(spec)
        self.seed = seed

    def generate(self, duration: float) -> List[AppSpec]:
        spec = self.spec
        if spec.get("trace"):
            return load_trace(spec["trace"])
        rng = random.Random(self.seed)
        arrivals = self._arrivals(rng, duration, spec)
        exec_lo = int(spec.get("executors", {}).get("min", 1))
        exec_hi = int(spec.get("executors", {}).get("max", 4))
        dyn_frac = float(spec.get("dynamic_fraction", 0.0))
        life_lo = float(spec.get("lifetime", {}).get("min", 60.0))
        life_hi = float(spec.get("lifetime", {}).get("max", 600.0))
        instance_group = spec.get("instance_group", "batch-medium-priority")
        # optional policy-shape knobs: "band_weights" {band: weight}
        # draws a band per app, "tenants" [name, ...] draws a tenant —
        # both off the same seeded rng so the trace stays deterministic
        band_weights = dict(spec.get("band_weights", {}))
        band_names = sorted(band_weights)
        tenants = list(spec.get("tenants", []))
        apps: List[AppSpec] = []
        for i, t in enumerate(arrivals):
            count = rng.randint(exec_lo, exec_hi)
            dynamic = rng.random() < dyn_frac
            min_count = rng.randint(max(1, count // 2), count) if dynamic else count
            sizes = rng.choice(_SIZE_MENU)
            band = spec.get("band", "normal")
            if band_names:
                band = rng.choices(
                    band_names, weights=[band_weights[b] for b in band_names]
                )[0]
            tenant = rng.choice(tenants) if tenants else spec.get("tenant", "")
            apps.append(
                AppSpec(
                    app_id=f"app-{i:04d}",
                    arrival=round(t, 3),
                    executor_count=count,
                    min_executor_count=min_count if dynamic else count,
                    dynamic=dynamic,
                    lifetime=round(rng.uniform(life_lo, life_hi), 3),
                    driver_cpu=sizes[0],
                    driver_mem=sizes[1],
                    executor_cpu=sizes[2],
                    executor_mem=sizes[3],
                    instance_group=instance_group,
                    band=band,
                    tenant=tenant,
                )
            )
        return apps

    @staticmethod
    def _arrivals(rng: random.Random, duration: float, spec: Dict) -> List[float]:
        process = spec.get("process", "poisson")
        rate = float(spec.get("rate_per_min", 2.0)) / 60.0  # per second
        out: List[float] = []
        if process == "poisson":
            t = 0.0
            while True:
                t += rng.expovariate(rate) if rate > 0 else duration + 1
                if t >= duration:
                    break
                out.append(t)
        elif process == "burst":
            interval = float(spec.get("burst_interval", 300.0))
            size = int(spec.get("burst_size", 5))
            t = float(spec.get("burst_offset", 1.0))
            while t < duration:
                out.extend([t] * size)
                t += interval
        elif process == "diurnal":
            peak = float(spec.get("peak_rate_per_min", 6.0)) / 60.0
            period = float(spec.get("period", duration or 1.0))
            lam_max = max(rate, peak)
            t = 0.0
            while True:  # Lewis-Shedler thinning
                t += rng.expovariate(lam_max) if lam_max > 0 else duration + 1
                if t >= duration:
                    break
                lam_t = rate + (peak - rate) * 0.5 * (1.0 - math.cos(2.0 * math.pi * t / period))
                if rng.random() <= lam_t / lam_max:
                    out.append(t)
        else:
            raise ValueError(f"unknown arrival process {process!r}")
        return out


# -- trace (de)serialization --------------------------------------------------


def dump_trace(apps: List[AppSpec], path: str) -> None:
    with open(path, "w") as f:
        for app in apps:
            f.write(json.dumps(app.to_dict(), sort_keys=True) + "\n")


def load_trace(path: str) -> List[AppSpec]:
    apps: List[AppSpec] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                apps.append(AppSpec.from_dict(json.loads(line)))
    apps.sort(key=lambda a: (a.arrival, a.app_id))
    return apps
