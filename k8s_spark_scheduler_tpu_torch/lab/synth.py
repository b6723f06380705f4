"""Production-shaped workload synthesis (Borg-trace lineage); a copy of
the reference package's ``lab/synth.py`` (the same seed dumps the same
trace bytes).

A synth spec is a plain dict (reviewable JSON) describing the three
properties production traces have that hand-written scenarios never do
(EuroSys '15):

- **heavy-tailed gang sizes** — executor counts drawn lognormal or
  Pareto, so most gangs are small and a fat tail is enormous;
- **diurnal arrival intensity** — an inhomogeneous arrival process
  whose rate swings sinusoidally over a daily period;
- **multi-tenant mixes** — every app belongs to a tenant with its own
  arrival share, DRF weight hint, and priority-band profile.

``synthesize`` draws exactly ``arrivals`` apps from one
``random.Random(seed)`` — a Poisson process conditioned on its count
has i.i.d. arrival instants with density proportional to the intensity,
so rejection-sampling against the diurnal curve gives an exact-count,
seed-reproducible trace.  Every float is rounded before it lands in an
``AppSpec`` so traces (and every digest computed downstream) are
byte-identical across platforms and libm builds.

The output is a list of :class:`~..sim.workload.AppSpec`, dumped via
``sim/workload.py::dump_trace`` — the SAME JSONL format the full sim's
``{"workload": {"trace": path}}`` replay path consumes.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List

from ..sim.workload import AppSpec, _SIZE_MENU

_KNOWN_KEYS = {
    "name",
    "seed",
    "arrivals",
    "horizon",
    "gang_size",
    "lifetime",
    "diurnal",
    "tenants",
    "dynamic_fraction",
    "instance_group",
    "namespace",
}
_GANG_DISTS = {"lognormal", "pareto", "uniform"}
_LIFETIME_DISTS = {"lognormal", "uniform"}


class SynthError(ValueError):
    """Actionable synth-spec validation failure."""


def _require_number(spec_path: str, value, lo=None, hi=None) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise SynthError(f"{spec_path}: expected a number, got {value!r}")
    if lo is not None and value < lo:
        raise SynthError(f"{spec_path}: must be >= {lo}, got {value!r}")
    if hi is not None and value > hi:
        raise SynthError(f"{spec_path}: must be <= {hi}, got {value!r}")
    return float(value)


@dataclass
class TenantProfile:
    name: str
    share: float = 1.0  # arrival-mix weight (relative)
    weight: float = 1.0  # DRF weight hint carried into matrix specs
    bands: Dict[str, float] = field(default_factory=lambda: {"normal": 1.0})


@dataclass
class SynthSpec:
    """Validated synthesizer parameters (see module docstring)."""

    name: str = "synth"
    seed: int = 0
    arrivals: int = 100_000
    horizon: float = 604_800.0  # one week of cluster life
    # gang-size distribution: lognormal {mu, sigma}, pareto {alpha,
    # minimum}, uniform {minimum, maximum}; all clamped to [1, maximum]
    gang_size: Dict = field(
        default_factory=lambda: {"dist": "lognormal", "mu": 1.1, "sigma": 0.9, "maximum": 64}
    )
    # lifetime seconds: lognormal {median, sigma}, uniform — clamped to
    # [minimum, maximum]
    lifetime: Dict = field(
        default_factory=lambda: {
            "dist": "lognormal",
            "median": 600.0,
            "sigma": 1.0,
            "minimum": 30.0,
            "maximum": 21_600.0,
        }
    )
    # intensity(t) = 1 + (peak_ratio - 1) * (1 - cos(2*pi*t/period))/2
    diurnal: Dict = field(
        default_factory=lambda: {"peak_ratio": 3.0, "period": 86_400.0}
    )
    tenants: List[TenantProfile] = field(default_factory=list)
    dynamic_fraction: float = 0.2
    instance_group: str = "batch-medium-priority"
    namespace: str = "default"

    @staticmethod
    def from_dict(d: Dict) -> "SynthSpec":
        if not isinstance(d, dict):
            raise SynthError(f"synth spec: expected an object, got {type(d).__name__}")
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise SynthError(
                f"synth spec: unknown keys {sorted(unknown)} (known: {sorted(_KNOWN_KEYS)})"
            )
        spec = SynthSpec(
            name=str(d.get("name", "synth")),
            seed=int(_require_number("synth.seed", d.get("seed", 0))),
            arrivals=int(_require_number("synth.arrivals", d.get("arrivals", 100_000), lo=1)),
            horizon=_require_number("synth.horizon", d.get("horizon", 604_800.0), lo=1.0),
            gang_size=dict(d.get("gang_size", SynthSpec().gang_size)),
            lifetime=dict(d.get("lifetime", SynthSpec().lifetime)),
            diurnal=dict(d.get("diurnal", SynthSpec().diurnal)),
            tenants=_parse_tenants(d.get("tenants", {})),
            dynamic_fraction=_require_number(
                "synth.dynamic_fraction", d.get("dynamic_fraction", 0.2), lo=0.0, hi=1.0
            ),
            instance_group=str(d.get("instance_group", "batch-medium-priority")),
            namespace=str(d.get("namespace", "default")),
        )
        spec.validate()
        return spec

    def validate(self) -> None:
        dist = self.gang_size.get("dist", "lognormal")
        if dist not in _GANG_DISTS:
            raise SynthError(
                f"synth.gang_size.dist: unknown distribution {dist!r} (known: {sorted(_GANG_DISTS)})"
            )
        _require_number("synth.gang_size.maximum", self.gang_size.get("maximum", 64), lo=1)
        if dist == "pareto":
            _require_number("synth.gang_size.alpha", self.gang_size.get("alpha", 1.5), lo=0.1)
        ldist = self.lifetime.get("dist", "lognormal")
        if ldist not in _LIFETIME_DISTS:
            raise SynthError(
                f"synth.lifetime.dist: unknown distribution {ldist!r} "
                f"(known: {sorted(_LIFETIME_DISTS)})"
            )
        lo = _require_number("synth.lifetime.minimum", self.lifetime.get("minimum", 30.0), lo=0.0)
        hi = _require_number("synth.lifetime.maximum", self.lifetime.get("maximum", 21_600.0))
        if hi < lo:
            raise SynthError(f"synth.lifetime: maximum {hi} < minimum {lo}")
        _require_number("synth.diurnal.peak_ratio", self.diurnal.get("peak_ratio", 3.0), lo=1.0)
        _require_number("synth.diurnal.period", self.diurnal.get("period", 86_400.0), lo=1.0)
        for t in self.tenants:
            if not t.bands:
                raise SynthError(f"synth.tenants.{t.name}: empty band profile")
            for band, w in t.bands.items():
                _require_number(f"synth.tenants.{t.name}.bands.{band}", w, lo=0.0)

    def drf_weights(self) -> Dict[str, float]:
        """The per-tenant DRF weight hints, for matrix-spec plumbing."""
        return {t.name: t.weight for t in self.tenants}


def _parse_tenants(block) -> List[TenantProfile]:
    if not isinstance(block, dict):
        raise SynthError(
            f"synth.tenants: expected an object of name -> profile, got {type(block).__name__}"
        )
    out: List[TenantProfile] = []
    for name in sorted(block):
        profile = block[name]
        if not isinstance(profile, dict):
            raise SynthError(f"synth.tenants.{name}: expected an object, got {profile!r}")
        unknown = set(profile) - {"share", "weight", "bands"}
        if unknown:
            raise SynthError(
                f"synth.tenants.{name}: unknown keys {sorted(unknown)} "
                "(known: ['bands', 'share', 'weight'])"
            )
        out.append(
            TenantProfile(
                name=name,
                share=_require_number(f"synth.tenants.{name}.share", profile.get("share", 1.0), lo=0.0),
                weight=_require_number(
                    f"synth.tenants.{name}.weight", profile.get("weight", 1.0), lo=0.0
                ),
                bands=dict(profile.get("bands", {"normal": 1.0})),
            )
        )
    return out


# -- draws ---------------------------------------------------------------------


def _draw_gang_size(rng: random.Random, cfg: Dict) -> int:
    dist = cfg.get("dist", "lognormal")
    cap = int(cfg.get("maximum", 64))
    if dist == "lognormal":
        raw = rng.lognormvariate(float(cfg.get("mu", 1.1)), float(cfg.get("sigma", 0.9)))
        size = 1 + int(raw)
    elif dist == "pareto":
        raw = float(cfg.get("minimum", 1)) * rng.paretovariate(float(cfg.get("alpha", 1.5)))
        size = max(1, int(raw))
    else:  # uniform
        size = rng.randint(int(cfg.get("minimum", 1)), cap)
    return min(size, cap)


def _draw_lifetime(rng: random.Random, cfg: Dict) -> float:
    dist = cfg.get("dist", "lognormal")
    lo = float(cfg.get("minimum", 30.0))
    hi = float(cfg.get("maximum", 21_600.0))
    if dist == "lognormal":
        raw = rng.lognormvariate(math.log(float(cfg.get("median", 600.0))), float(cfg.get("sigma", 1.0)))
    else:
        raw = rng.uniform(lo, hi)
    return round(min(max(raw, lo), hi), 3)


def _draw_arrivals(rng: random.Random, spec: SynthSpec) -> List[float]:
    """Exactly ``spec.arrivals`` instants with density proportional to
    the diurnal intensity (rejection sampling; acceptance >= 1/peak)."""
    peak = float(spec.diurnal.get("peak_ratio", 3.0))
    period = float(spec.diurnal.get("period", 86_400.0))
    horizon = spec.horizon
    out: List[float] = []
    if peak <= 1.0:
        out = [rng.uniform(0.0, horizon) for _ in range(spec.arrivals)]
    else:
        lam_max = peak
        two_pi = 2.0 * math.pi
        while len(out) < spec.arrivals:
            t = rng.uniform(0.0, horizon)
            lam_t = 1.0 + (peak - 1.0) * 0.5 * (1.0 - math.cos(two_pi * t / period))
            if rng.random() * lam_max <= lam_t:
                out.append(t)
    out.sort()
    return [round(t, 3) for t in out]


def synthesize(spec: SynthSpec, metrics=None) -> List[AppSpec]:
    """Generate the trace (see module docstring).  One rng, fixed draw
    order per app — the trace is a pure function of the spec."""
    rng = random.Random(spec.seed)
    arrivals = _draw_arrivals(rng, spec)
    tenants = spec.tenants or [TenantProfile(name="", share=1.0)]
    tenant_weights = [t.share for t in tenants]
    band_choices = {
        t.name: (sorted(t.bands), [t.bands[b] for b in sorted(t.bands)]) for t in tenants
    }
    apps: List[AppSpec] = []
    for i, t in enumerate(arrivals):
        tenant = rng.choices(tenants, weights=tenant_weights)[0]
        band_names, band_ws = band_choices[tenant.name]
        band = rng.choices(band_names, weights=band_ws)[0]
        count = _draw_gang_size(rng, spec.gang_size)
        dynamic = rng.random() < spec.dynamic_fraction
        min_count = rng.randint(max(1, count // 2), count) if dynamic else count
        sizes = rng.choice(_SIZE_MENU)
        apps.append(
            AppSpec(
                app_id=f"app-{i:06d}",
                arrival=t,
                executor_count=count,
                min_executor_count=min_count,
                dynamic=dynamic,
                lifetime=_draw_lifetime(rng, spec.lifetime),
                driver_cpu=sizes[0],
                driver_mem=sizes[1],
                executor_cpu=sizes[2],
                executor_mem=sizes[3],
                instance_group=spec.instance_group,
                namespace=spec.namespace,
                band=band,
                tenant=tenant.name,
            )
        )
    if metrics is not None:
        from ..metrics import names as mnames

        metrics.counter(mnames.LAB_TRACE_APPS, inc=float(len(apps)))
    return apps
