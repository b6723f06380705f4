"""The port's trace synthesizer (``k8s_spark_scheduler_tpu_torch/lab/
synth.py``), case for case the reference's tests/test_lab_synth.py, and
the port against the reference: for the committed smoke and week specs
the bytes ``dump_trace`` writes are the reference's.

The reference's docstring, which every case below keeps:

The synthesizer's whole value is determinism at scale: the same spec +
seed must yield byte-identical traces on any platform, arrivals must
follow the diurnal curve with an exact count, and the output must be
the SAME JSONL dialect ``sim/workload.py`` replays — so these tests pin
spec validation messages, draw clamps, ordering, and the round-trip.
"""

import json
import pathlib

import pytest

from k8s_spark_scheduler_tpu.lab.synth import SynthSpec as JaxSynthSpec
from k8s_spark_scheduler_tpu.lab.synth import synthesize as jax_synthesize
from k8s_spark_scheduler_tpu.sim.workload import dump_trace as jax_dump_trace
from k8s_spark_scheduler_tpu_torch.lab.synth import (
    SynthError,
    SynthSpec,
    synthesize,
)
from k8s_spark_scheduler_tpu_torch.sim.workload import dump_trace, load_trace

REPO = pathlib.Path(__file__).resolve().parents[1]

_TENANTS = {
    "ads": {"share": 2.0, "weight": 2.0, "bands": {"normal": 0.8, "high": 0.2}},
    "etl": {"share": 1.0, "weight": 1.0, "bands": {"low": 0.5, "normal": 0.5}},
}


def _spec(**over):
    d = {
        "name": "t",
        "seed": 7,
        "arrivals": 400,
        "horizon": 86_400.0,
        "tenants": _TENANTS,
    }
    d.update(over)
    return SynthSpec.from_dict(d)


# -- validation: actionable dotted-path messages ------------------------------


@pytest.mark.parametrize(
    "mutation, fragment",
    [
        ({"bogus": 1}, "unknown keys ['bogus']"),
        ({"arrivals": 0}, "synth.arrivals: must be >= 1"),
        ({"arrivals": "many"}, "synth.arrivals: expected a number"),
        ({"horizon": 0}, "synth.horizon: must be >= 1.0"),
        ({"dynamic_fraction": 1.5}, "synth.dynamic_fraction: must be <= 1"),
        ({"gang_size": {"dist": "zipf"}}, "synth.gang_size.dist: unknown distribution 'zipf'"),
        ({"lifetime": {"dist": "pareto"}}, "synth.lifetime.dist: unknown distribution"),
        (
            {"lifetime": {"minimum": 100, "maximum": 10}},
            "synth.lifetime: maximum 10",
        ),
        ({"diurnal": {"peak_ratio": 0.5}}, "synth.diurnal.peak_ratio: must be >= 1.0"),
        ({"tenants": ["ads"]}, "synth.tenants: expected an object"),
        (
            {"tenants": {"ads": {"quota": 3}}},
            "synth.tenants.ads: unknown keys ['quota']",
        ),
        (
            {"tenants": {"ads": {"bands": {}}}},
            "synth.tenants.ads: empty band profile",
        ),
        (
            {"tenants": {"ads": {"share": -1}}},
            "synth.tenants.ads.share: must be >= 0",
        ),
    ],
)
def test_spec_validation_is_actionable(mutation, fragment):
    base = {"name": "t", "seed": 7, "arrivals": 10, "tenants": _TENANTS}
    base.update(mutation)
    with pytest.raises(SynthError) as exc:
        SynthSpec.from_dict(base)
    assert fragment in str(exc.value)


def test_spec_rejects_non_dict():
    with pytest.raises(SynthError, match="expected an object, got list"):
        SynthSpec.from_dict([])


# -- determinism + distribution shape -----------------------------------------


def test_same_seed_same_trace_bytes(tmp_path):
    a = synthesize(_spec())
    b = synthesize(_spec())
    assert a == b  # dataclass equality over every field
    pa, pb = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    dump_trace(a, str(pa))
    dump_trace(b, str(pb))
    assert pa.read_bytes() == pb.read_bytes()
    assert synthesize(_spec(seed=8)) != a


def test_exact_count_sorted_and_rounded():
    apps = synthesize(_spec())
    assert len(apps) == 400
    arrivals = [a.arrival for a in apps]
    assert arrivals == sorted(arrivals)
    for a in apps:
        assert 0.0 <= a.arrival <= 86_400.0
        # 3-dp rounding is the cross-platform determinism contract
        assert a.arrival == round(a.arrival, 3)
        assert a.lifetime == round(a.lifetime, 3)
        assert a.app_id.startswith("app-")


def test_gang_size_clamped_to_maximum():
    apps = synthesize(_spec(gang_size={"dist": "pareto", "alpha": 0.8, "maximum": 6}))
    sizes = [a.executor_count for a in apps]
    assert max(sizes) <= 6
    assert min(sizes) >= 1
    # pareto at alpha 0.8 is heavy enough that the cap must actually bind
    assert sizes.count(6) > 0


def test_lognormal_sizes_are_heavy_tailed():
    apps = synthesize(
        _spec(arrivals=2000, gang_size={"dist": "lognormal", "mu": 1.1, "sigma": 0.9, "maximum": 64})
    )
    sizes = sorted(a.executor_count for a in apps)
    p50 = sizes[len(sizes) // 2]
    p99 = sizes[int(len(sizes) * 0.99)]
    assert p99 >= 4 * p50  # fat tail: most gangs small, a few enormous


def test_diurnal_intensity_shapes_arrivals():
    """More arrivals must land in the peak half-period than the trough
    half-period (peak_ratio 5 ⇒ expected ~3.67x; assert a safe 1.5x)."""
    spec = _spec(
        arrivals=4000,
        horizon=86_400.0,
        diurnal={"peak_ratio": 5.0, "period": 86_400.0},
    )
    apps = synthesize(spec)
    # intensity 1+(p-1)(1-cos 2πt/T)/2 peaks at t=T/2, troughs at t=0/T
    peak = sum(1 for a in apps if 86_400.0 * 0.25 < a.arrival < 86_400.0 * 0.75)
    trough = len(apps) - peak
    assert peak > 1.5 * trough


def test_tenant_and_band_mix():
    apps = synthesize(_spec(arrivals=1000))
    by_tenant = {}
    for a in apps:
        by_tenant.setdefault(a.tenant, []).append(a)
        assert a.band in _TENANTS[a.tenant]["bands"]
    assert set(by_tenant) == {"ads", "etl"}
    # share 2:1 — allow generous sampling slack
    assert len(by_tenant["ads"]) > len(by_tenant["etl"])
    dyn = [a for a in apps if a.dynamic]
    for a in dyn:
        assert 1 <= a.min_executor_count <= a.executor_count
    assert 0.05 < len(dyn) / len(apps) < 0.5  # dynamic_fraction 0.2


def test_trace_roundtrip_through_sim_workload(tmp_path):
    """The dumped trace must replay through the SAME loader the full
    sim's ``{"workload": {"trace": ...}}`` path uses, unchanged."""
    apps = synthesize(_spec())
    path = tmp_path / "trace.jsonl"
    dump_trace(apps, str(path))
    assert load_trace(str(path)) == apps
    # and each line is a flat JSON object (reviewable artifact)
    first = json.loads(path.read_text().splitlines()[0])
    assert first["app_id"] == "app-000000"
    assert {"arrival", "executor_count", "band", "tenant"} <= set(first)


def test_drf_weight_hints():
    assert _spec().drf_weights() == {"ads": 2.0, "etl": 1.0}


def test_committed_smoke_spec_parses():
    """The spec CI synthesizes from must stay valid."""
    for name in ("smoke_synth.json", "week_synth.json"):
        raw = json.loads((REPO / "examples" / "lab" / name).read_text())
        spec = SynthSpec.from_dict(raw)
        assert spec.arrivals >= 5000
        assert spec.tenants


def test_flat_intensity_when_peak_ratio_one():
    spec = _spec(arrivals=1000, diurnal={"peak_ratio": 1.0, "period": 86_400.0})
    apps = synthesize(spec)
    assert len(apps) == 1000
    halves = [
        sum(1 for a in apps if a.arrival < 43_200.0),
        sum(1 for a in apps if a.arrival >= 43_200.0),
    ]
    assert abs(halves[0] - halves[1]) < 250  # uniform, no diurnal skew


def test_metrics_hook_counts_apps():
    class _Reg:
        def __init__(self):
            self.counters = {}

        def counter(self, name, inc=1.0, tags=None):
            self.counters[name] = self.counters.get(name, 0.0) + inc

    reg = _Reg()
    synthesize(_spec(arrivals=50), metrics=reg)
    from k8s_spark_scheduler_tpu_torch.metrics import names as M

    assert reg.counters[M.LAB_TRACE_APPS] == 50.0


# -- the port against the reference ------------------------------------------


@pytest.mark.parametrize("name", ["smoke_synth.json", "week_synth.json"])
def test_trace_bytes_equal_the_reference(name, tmp_path):
    """The same committed spec dumps the same trace bytes through both
    packages (5,000 and 100,000 arrivals)."""
    raw = json.loads((REPO / "examples" / "lab" / name).read_text())
    port, ref = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    dump_trace(synthesize(SynthSpec.from_dict(raw)), str(port))
    jax_dump_trace(jax_synthesize(JaxSynthSpec.from_dict(raw)), str(ref))
    assert port.read_bytes() == ref.read_bytes()
    assert len(port.read_bytes().splitlines()) == raw["arrivals"]
