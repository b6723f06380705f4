"""The port's config against the reference's on the subsystems a config
turns on: ``Install.reference_only`` names exactly the subsystems the
JAX package runs on the same config and the port does not have (all but
resilience, provenance, delta-solve, class aggregation, the capacity
observatory, the lifecycle ledger, the contention observatory, the policy
engine, the HA fabric and the concurrent admission engine, which the port
has: since then none), and the server logs one warning for each at start: none
on examples/install.json, since every subsystem the reference runs by
default is ported.  ``delta-solve`` (default true, as in the reference) and
``classes`` load and reach the engine, with
``provenance.parity-check-interval``; ``capacity`` and ``lifecycle``
load with the reference's keys and defaults and reach the sampler and
the ledger; ``policy`` loads into a ``PolicyConfig`` equal to the
reference's and reaches the engine; ``ha`` loads into an ``HAConfig``
equal to the reference's and, enabled, wires the fabric; ``concurrent``
loads into a ``ConcurrentConfig`` equal to the reference's and, enabled,
wires the engine (stamped with the fence's epoch under HA).  Also the two settings that now configure something:
``conversion-webhook`` (the CRD's conversion stanza) and
``unschedulable-pod-timeout-seconds`` (the marker)."""

import json
import logging
import os

import pytest

from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.kube import crd as jax_crd
from k8s_spark_scheduler_tpu_torch.config import Install
from k8s_spark_scheduler_tpu_torch.kube import crd
from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("provenance", "capacity", "contention", "policy", "ha", "lifecycle", "concurrent", "classes")
# the reference's subsystems the port has too
PORTED = {"resilience", "provenance", "delta-solve", "classes", "capacity", "lifecycle", "contention", "policy",
          "ha", "concurrent"}


def _example() -> dict:
    with open(os.path.join(REPO, "examples", "install.json")) as f:
        return json.load(f)


def _reference_runs(d: dict) -> set:
    """The subsystems the JAX package runs on config ``d``."""
    jax = JaxInstall.from_dict(d)
    running = {"resilience"}  # no switch in the reference (config.py:403)
    if jax.delta_solve:
        running.add("delta-solve")
    running.update(key for key in SECTIONS if getattr(jax, key).enabled)
    return running


CONFIGS = {
    "example": _example(),
    "empty": {},
    "some-off": {"delta-solve": False, "provenance": {"enabled": False}, "classes": {"enabled": False}},
    "all-off": dict({k: {"enabled": False} for k in SECTIONS}, **{"delta-solve": False}),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_reference_only_names_what_the_reference_runs(config):
    d = CONFIGS[config]
    ours = Install.from_dict(d)
    assert {name for name, _ in ours.reference_only} == _reference_runs(d) - PORTED
    for name, item in ours.reference_only:
        assert item.startswith("ROADMAP A."), (name, item)


def test_example_config_warns_once_per_missing_subsystem(tmp_path, caplog):
    d = _example()
    ca = tmp_path / "ca.crt"
    ca.write_bytes(b"-----BEGIN CERTIFICATE-----\nMIIB\n-----END CERTIFICATE-----\n")
    d["conversion-webhook"]["ca-bundle-file"] = str(ca)
    install = Install.from_dict(d)
    with caplog.at_level(logging.WARNING, logger="k8s_spark_scheduler_tpu_torch.server.wiring"):
        server = init_server_with_clients(APIServer(), install, start_background=False, device="cpu")
    warned = [r.getMessage() for r in caplog.records if "the reference package runs" in r.getMessage()]
    expected = _reference_runs(_example()) - PORTED
    assert len(warned) == len(expected) == 0
    for name in expected:
        assert sum(f" runs {name} on this config" in w for w in warned) == 1, name
    # the two settings configure something now: the marker's timeout,
    # and the CRD's conversion webhook, equal to the reference's stanza
    assert server.unschedulable_marker._timeout == 600
    ours = server.api.get_crd(crd.RESOURCE_RESERVATION_CRD_NAME)
    theirs = jax_crd.resource_reservation_crd_spec(
        JaxInstall.from_dict(d).resource_reservation_crd_annotations, JaxInstall.from_dict(d).conversion_webhook
    )
    assert ours["conversion"] == theirs["conversion"]
    assert ours["versions"] == [dict(v) for v in theirs["versions"]]
    server.stop()


def test_example_config_without_its_ca_file_fails_like_the_reference():
    """examples/install.json names /etc/scheduler/ca.crt, a path of the
    deployment: both packages refuse to build the CRD without it."""
    d = _example()
    if os.path.exists(d["conversion-webhook"]["ca-bundle-file"]):
        pytest.skip("this host has the deployment's CA bundle")
    with pytest.raises(FileNotFoundError):
        jax_crd.resource_reservation_crd_spec({}, JaxInstall.from_dict(d).conversion_webhook)
    with pytest.raises(FileNotFoundError):
        crd.resource_reservation_crd_spec({}, Install.from_dict(d).conversion_webhook)


def test_background_loops_start_and_stop():
    server = init_server_with_clients(
        APIServer(), Install(binpack_algo="tpu-batch"), unschedulable_polling_interval=0.01, device="cpu"
    )
    try:
        assert server.unschedulable_marker._thread.is_alive()
        assert server.reporters._thread.is_alive()
        sampler, ledger = server.capacity._thread, server.lifecycle._thread
        assert sampler.is_alive() and ledger.is_alive()
    finally:
        server.stop()
    assert not server.unschedulable_marker._thread.is_alive()
    assert not server.reporters._thread.is_alive()
    assert not sampler.is_alive() and not ledger.is_alive()


@pytest.mark.parametrize(
    "d,delta,classes,parity",
    [
        ({}, True, (True, 20000), 0),
        ({"delta-solve": True, "classes": {"enabled": True, "min-nodes": 5000}}, True, (True, 5000), 0),
        ({"delta-solve": False, "classes": {"enabled": False}, "provenance": {"parity-check-interval": 7}},
         False, (False, 20000), 7),
        ({"provenance": {"parity-check-interval": 3}}, True, (True, 20000), 3),
    ],
)
def test_delta_solve_and_classes_load_as_in_the_reference(d, delta, classes, parity):
    ours, theirs = Install.from_dict(d), JaxInstall.from_dict(d)
    assert ours.delta_solve is theirs.delta_solve is delta
    assert (ours.classes.enabled, ours.classes.min_nodes) == (theirs.classes.enabled, theirs.classes.min_nodes) == classes
    assert ours.provenance.parity_check_interval == theirs.provenance.parity_check_interval == parity
    server = init_server_with_clients(APIServer(), Install(**{
        "binpack_algo": "tpu-batch", "fifo": True, "delta_solve": ours.delta_solve,
        "classes": ours.classes, "provenance": ours.provenance,
    }), start_background=False, device="cpu")
    try:
        engine = server.extender.delta_engine
        if not delta:
            assert engine is None
            return
        assert (engine.classes_enabled, engine.classes_min_nodes) == classes
        assert engine.parity_interval == parity
        assert engine.parity_hooks == (server.provenance.on_parity_ok, server.provenance.on_parity_mismatch)
        assert engine.capture_sink == server.provenance.capture
    finally:
        server.stop()


def test_classes_section_refuses_unknown_keys():
    with pytest.raises(ValueError):
        Install.from_dict({"classes": {"enabled": True, "min_nodes": 5}})


@pytest.mark.parametrize(
    "d",
    [
        {},
        {"capacity": {"enabled": False}, "lifecycle": {"enabled": False}},
        {"capacity": {"ring-size": 8, "debounce-seconds": 0.5, "interval-seconds": 3.0, "max-shapes": 4,
                      "max-group-zones": 2, "max-queue": 7}},
        {"lifecycle": {"ring-size": 16, "debounce-seconds": 0.2, "interval-seconds": 1.0, "window-scale": 0.01,
                       "sample-cap": 64, "objectives": {"filter_latency": {"threshold": 0.05}}}},
    ],
)
def test_capacity_and_lifecycle_load_as_in_the_reference(d):
    """The reference's keys and defaults, on when a config omits them, and
    the values reach the sampler, the SLO engine and the ledger."""
    from dataclasses import asdict

    ours, theirs = Install.from_dict(d), JaxInstall.from_dict(d)
    assert asdict(ours.capacity) == asdict(theirs.capacity)
    assert asdict(ours.lifecycle) == asdict(theirs.lifecycle)
    server = init_server_with_clients(APIServer(), Install(
        binpack_algo="tpu-batch", capacity=ours.capacity, lifecycle=ours.lifecycle,
    ), start_background=False, device="cpu")
    try:
        if not ours.capacity.enabled:
            assert server.capacity is None and server.lifecycle is None and server.slo is None
            assert server.waste_reporter.slo_sink is None
            return
        sampler, ledger, slo = server.capacity, server.lifecycle, server.slo
        assert (sampler._ring.maxlen, sampler.debounce_seconds, sampler.interval_seconds, sampler.max_shapes,
                sampler.max_group_zones, sampler.max_queue) == (
            ours.capacity.ring_size, ours.capacity.debounce_seconds, ours.capacity.interval_seconds,
            ours.capacity.max_shapes, ours.capacity.max_group_zones, ours.capacity.max_queue)
        assert sampler.device.type == "cpu"
        assert (ledger.ring_size, ledger.debounce_seconds, ledger.interval_seconds, slo.window_scale) == (
            ours.lifecycle.ring_size, ours.lifecycle.debounce_seconds, ours.lifecycle.interval_seconds,
            ours.lifecycle.window_scale)
        threshold = ours.lifecycle.objectives.get("filter_latency", {}).get("threshold", 0.1)
        assert slo.status(now=0.0)["filter_latency"]["threshold"] == threshold
        assert server.waste_reporter.slo_sink == slo.waste_sample
        assert server.extender.slo_alert_source() == ""
    finally:
        server.stop()


@pytest.mark.parametrize("section", ["capacity", "lifecycle"])
def test_capacity_and_lifecycle_sections_refuse_unknown_keys(section):
    with pytest.raises(ValueError, match=section):
        Install.from_dict({section: {"enabled": True, "ring_size": 5}})


@pytest.mark.parametrize(
    "section",
    [
        {},
        {"enabled": False},
        {"enabled": True},
        {"enabled": True, "ordering": "priority-then-fifo", "backfill": True, "preemption-enabled": True},
        {"enabled": True, "ordering": "drf", "band-label": "band", "bands": {"bulk": 0, "prod": 5},
         "default-band": "nope", "tenant-label": "team", "preemption-min-band-gap": 2, "max-victims": 1,
         "starvation-age-seconds": 30.0, "tenant-weights": {"a": 2.0}, "recent-evictions": 8},
    ],
)
def test_policy_section_loads_as_in_the_reference(section):
    """``{"policy": {...}}`` loads into a PolicyConfig equal to the
    reference's, and an enabled one builds the engine with it."""
    ours, theirs = Install.from_dict({"policy": section}), JaxInstall.from_dict({"policy": section})
    assert ours.policy.__dict__ == theirs.policy.__dict__
    server = init_server_with_clients(
        APIServer(), Install(fifo=True, binpack_algo="tpu-batch", policy=ours.policy),
        start_background=False, device="cpu",
    )
    try:
        engine = server.policy
        assert (engine is not None) == ours.policy.enabled
        assert server.extender._policy is engine and server.lifecycle._policy is engine
        if engine is not None:
            assert engine.config is ours.policy
            assert (engine.coordinator is not None) == ours.policy.preemption_enabled
            # a default band the bands lack falls back to the lowest, as in the reference
            assert engine.ledger.default_band in ours.policy.bands
    finally:
        server.stop()


_HA_FULL = {
    "enabled": True, "lease-namespace": "kube-system", "lease-name": "sched-lease",
    "lease-duration-seconds": 2, "renew-interval-seconds": 0.5, "identity": "replica-7",
    "background": False,
}


@pytest.mark.parametrize(
    "d",
    [{}, _example(), {"ha": {"enabled": True}}, {"ha": _HA_FULL}],
    ids=["default", "example", "enabled", "full-keys"],
)
def test_ha_section_loads_as_in_the_reference(d):
    """``{"ha": {...}}`` loads into an HAConfig equal to the reference's
    (its keys and defaults); an enabled one wires the fabric, its fence
    on the write paths and the epoch sources, a disabled one nothing."""
    ours, theirs = Install.from_dict(d), JaxInstall.from_dict(d)
    assert ours.ha.__dict__ == theirs.ha.__dict__
    install = Install(fifo=True, binpack_algo="tpu-batch", ha=ours.ha)
    server = init_server_with_clients(APIServer(), install, start_background=False, device="cpu")
    try:
        fabric = server.ha
        assert (fabric is not None) == ours.ha.enabled
        if fabric is not None:
            assert server.extender.epoch_source == fabric.fence.epoch
            assert server.lifecycle.epoch_source == fabric.fence.epoch
            assert server.resource_reservation_cache._async.fence_gate is fabric.writer
            assert server.resilience.journal.fence_gate is fabric.writer
            assert fabric.elector._duration == ours.ha.lease_duration_seconds
            if ours.ha.identity:
                assert fabric.elector.identity == ours.ha.identity
            assert fabric.status()["epoch"] == 0 and not fabric.is_leader()
        else:
            assert server.extender.epoch_source is None
    finally:
        server.stop()


_CONCURRENT_FULL = {"enabled": True, "speculation": False, "max-inflight-speculations": 3, "multi-active": True}


@pytest.mark.parametrize(
    "d",
    [{}, _example(), {"concurrent": {"enabled": True}}, {"concurrent": {"enabled": False}},
     {"concurrent": _CONCURRENT_FULL}, {"concurrent": {"enabled": True}, "ha": {"enabled": True}}],
    ids=["default", "example", "enabled", "disabled", "full-keys", "with-ha"],
)
def test_concurrent_section_loads_as_in_the_reference(d):
    """``{"concurrent": {...}}`` loads into a ConcurrentConfig equal to
    the reference's (its keys and defaults); an enabled one wires the
    engine with its knobs (the fence's epoch as its epoch source when
    HA is on), a disabled one nothing."""
    ours, theirs = Install.from_dict(d), JaxInstall.from_dict(d)
    assert ours.concurrent.__dict__ == theirs.concurrent.__dict__
    assert ours.reference_only == ()
    install = Install(fifo=True, binpack_algo="tpu-batch", ha=ours.ha, concurrent=ours.concurrent)
    server = init_server_with_clients(APIServer(), install, start_background=False, device="cpu")
    try:
        engine = server.concurrent
        assert (engine is not None) == ours.concurrent.enabled
        if engine is not None:
            assert engine._config is ours.concurrent
            assert engine.speculator._max_inflight == ours.concurrent.max_inflight_speculations
            assert engine._epoch_source == (server.ha.fence.epoch if server.ha is not None else None)
        assert server.extender.speculation_intake is None
    finally:
        server.stop()


def test_concurrent_section_refuses_unknown_keys():
    with pytest.raises(ValueError, match="concurrent"):
        Install.from_dict({"concurrent": {"enabled": True, "max_inflight_speculations": 2}})


def test_ha_section_refuses_unknown_keys():
    with pytest.raises(ValueError, match="ha"):
        Install.from_dict({"ha": {"enabled": True, "lease_name": "x"}})
