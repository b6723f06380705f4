"""The port's gang lifecycle ledger and SLO engine (``lifecycle/``), case
for case the reference's tests/test_lifecycle.py, and the port against
the reference:

- the EventLog's indexed ring at capacity rollover and its
  ``events_since`` cursor;
- the SLO engine's multi-window multi-burn-rate evaluation (the
  Google-SRE alert policy), each status equal to the JAX engine's on the
  same observations;
- the ledger's state machine through the port's real wiring, the
  in-lock drain refusal, the waste reporter's ``slo_sink``;
- ``GET /slo`` and ``GET /lifecycle`` on the port's server;
- the scorecard digest and leaf diff;
- a Twin sequence on the reference's defaults: the bodies of
  ``/state/capacity`` (and its history and diff), ``/slo`` and
  ``/lifecycle`` from both servers on one frozen clock are equal, with
  the fields named in ``UNCOMPARED`` (tests/torch_parity.py) left out.

The reference's simulator case (``test_lifecycle.py:344``) is in
tests/test_torch_sim_observatory.py; its policy-regression-gate cases
(``:414``, ``:496``, ``:582``) are in tests/test_torch_lab_gate.py, run
through the port's gate (``k8s_spark_scheduler_tpu_torch/tools/
policy_regression.py``) and the reference's.
"""

import json
import urllib.error
import urllib.request

import pytest

from k8s_spark_scheduler_tpu.lifecycle import SloEngine as JaxSloEngine
from k8s_spark_scheduler_tpu_torch.events.events import EventLog
from k8s_spark_scheduler_tpu_torch.lifecycle import (
    DEFAULT_OBJECTIVES,
    SCHEMA_NAME,
    SloEngine,
    build_scorecard,
    scorecard_diff,
    scorecard_digest,
)
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.tracing import Tracer

from torch_parity import UNCOMPARED, Twin
from torch_parity import lifecycle_record_body as _record_body
from torch_parity import lifecycle_summary_body as _summary_body


def _harness() -> Harness:
    return Harness(device="cpu")


# -- event log: indexed ring at capacity rollover -----------------------------


def test_eventlog_secondary_indexes_evict_in_lockstep_with_ring():
    """by_name/by_trace_id never return an event the capacity-bounded
    ring already dropped, and lookups are served from the index buckets
    (O(matches)), not a ring scan."""
    log = EventLog(capacity=4)
    tracer = Tracer()
    for i in range(6):
        with tracer.span("root", trace_id=f"tr-{i % 2}"):
            log.emit("evt.even" if i % 2 == 0 else "evt.odd", i=i)

    assert log.seq == 6
    retained = log.all()
    assert [e.values["i"] for e in retained] == [2, 3, 4, 5]

    # evicted events (i=0, i=1) are gone from BOTH indexes
    assert [e.values["i"] for e in log.by_name("evt.even")] == [2, 4]
    assert [e.values["i"] for e in log.by_name("evt.odd")] == [3, 5]
    assert [e.values["i"] for e in log.by_trace_id("tr-0")] == [2, 4]
    assert [e.values["i"] for e in log.by_trace_id("tr-1")] == [3, 5]

    # a name whose every event rolled out leaves no empty bucket behind
    log2 = EventLog(capacity=2)
    log2.emit("gone.name")
    log2.emit("other.a")
    log2.emit("other.b")
    assert log2.by_name("gone.name") == []
    assert "gone.name" not in log2._by_name


def test_eventlog_events_since_cursor_across_rollover():
    log = EventLog(capacity=4)
    for i in range(3):
        log.emit("e", i=i)
    fresh, cursor = log.events_since(0)
    assert [e.values["i"] for e in fresh] == [0, 1, 2]
    assert cursor == 3

    # idempotent at the cursor
    fresh, cursor = log.events_since(cursor)
    assert fresh == [] and cursor == 3

    # emit 5 more: the ring (capacity 4) can only reach the tail
    for i in range(3, 8):
        log.emit("e", i=i)
    fresh, cursor = log.events_since(3)
    assert [e.values["i"] for e in fresh] == [4, 5, 6, 7]
    assert cursor == 8


# -- SLO engine: multi-window multi-burn-rate ---------------------------------


def _twin_engines():
    return SloEngine(), JaxSloEngine()


def test_slo_engine_reports_all_default_objectives():
    engine, ref = _twin_engines()
    status = engine.status(now=1000.0)
    assert status == ref.status(now=1000.0)
    assert set(status) == {name for name, *_ in DEFAULT_OBJECTIVES}
    assert len(status) >= 4
    for body in status.values():
        # no samples → no data → never an alert
        assert body["state"] == "ok"
        assert body["total"] == 0
        assert set(body["windows"]) == {"page", "warn"}
        for win in body["windows"].values():
            assert win["longBurnRate"] is None
            assert win["shortBurnRate"] is None


def test_slo_fast_burn_pages_and_tags():
    """All-bad traffic inside both page windows (1h AND 5m) burns at
    1/(1-0.99) = 100x ≥ 14.4 → page, and the precomputed alert tag
    carries it for decision-trace tagging."""
    engines = _twin_engines()
    now = 100_000.0
    for engine in engines:
        for k in range(10):
            engine.observe("time_to_admit", 900.0, t=now - 10.0 * k)
    status, ref = (e.evaluate(now=now) for e in engines)
    assert status == ref
    body = status["time_to_admit"]
    assert body["state"] == "page"
    assert body["windows"]["page"]["longBurnRate"] == pytest.approx(100.0)
    assert body["windows"]["page"]["shortBurnRate"] == pytest.approx(100.0)
    assert "time_to_admit:page" in engines[0].alert_tag
    assert engines[0].alert_tag == engines[1].alert_tag

    # good traffic flushes the short window first: once the 5m window
    # is clean the page alert must drop (multi-window = fast recovery)
    later = now + 400.0
    for engine in engines:
        for k in range(20):
            engine.observe("time_to_admit", 1.0, t=later - 10.0 * k)
    status, ref = (e.evaluate(now=later) for e in engines)
    assert status == ref
    assert status["time_to_admit"]["state"] != "page"


def test_slo_slow_burn_warns_without_paging():
    """Bad samples older than the page short window (5m) but inside the
    warn windows (6h AND 30m): the 5m window has no data, so the page
    condition cannot fire, while the warn condition does."""
    engines = _twin_engines()
    now = 1_000_000.0
    for engine in engines:
        for k in range(10):
            engine.observe("filter_latency", 5.0, t=now - 600.0 - 30.0 * k)
    status, ref = (e.evaluate(now=now) for e in engines)
    assert status == ref
    body = status["filter_latency"]
    assert body["state"] == "warn"
    assert body["windows"]["page"]["shortBurnRate"] is None
    assert body["windows"]["warn"]["longBurnRate"] == pytest.approx(100.0)
    assert engines[0].alert_tag == "filter_latency:warn"


def test_slo_good_defaults_to_threshold_and_budget_tracks():
    engines = _twin_engines()
    now = 50_000.0
    for engine in engines:
        engine.observe("filter_latency", 0.05, t=now)  # ≤ 0.1s → good
        engine.observe("filter_latency", 5.0, t=now)  # > 0.1s → bad
    body, ref = (e.evaluate(now=now)["filter_latency"] for e in engines)
    assert body == ref
    assert body["good"] == 1 and body["bad"] == 1 and body["total"] == 2
    assert 0.0 <= body["budgetRemaining"] < 1.0


# -- ledger: state machine through the real wiring ----------------------------


def test_ledger_tracks_gang_lifecycle_end_to_end():
    h = _harness()
    try:
        h.new_node("n1")
        h.new_node("n2")
        pods = h.static_allocation_spark_pods("app-lc", 2)
        h.assert_success(h.schedule(pods[0], ["n1", "n2"]))
        for ex in pods[1:]:
            h.assert_success(h.schedule(ex, ["n1", "n2"]))
        h.wait_quiesced()

        ledger = h.server.lifecycle
        assert ledger is not None
        ledger.drain(trigger="test")

        rec = ledger.record("app-lc")
        assert rec is not None
        assert rec["phase"] == "running"
        # every non-terminal phase got a first-arrival stamp, including
        # "solving" (drained off the event log AFTER bound happened
        # live — the pass-through stamp, not a backward transition)
        for phase in ("submitted", "queued", "solving", "reserved", "bound", "running"):
            assert phase in rec["phaseTimes"], (phase, rec["phaseTimes"])
        assert rec["queueWaitSeconds"] is not None
        assert rec["solveCount"] >= 1
        assert rec["executorsBound"] == 2
        assert rec["traceIds"], "scheduling traces not correlated"

        # driver deletion after running → completed
        h.delete_pod(pods[0])
        h.wait_quiesced()
        ledger.drain(trigger="test")
        assert ledger.record("app-lc")["phase"] == "completed"

        summary = ledger.summary()
        assert summary["gangs"] == 1
        assert summary["phases"].get("completed") == 1
        assert summary["queueWait"]["count"] == 1
        assert summary["lockViolations"] == 0
    finally:
        h.close()


def test_ledger_drain_refused_under_predicate_lock():
    """The ledger runs ZERO work under the predicate lock — an in-lock
    drain is refused and counted, never served."""
    from k8s_spark_scheduler_tpu_torch import capacity as cap_pkg

    h = _harness()
    try:
        h.new_node("n1")
        ledger = h.server.lifecycle
        ledger.stop()
        cap_pkg.enter_predicate_lock()
        try:
            assert ledger.drain(trigger="in-lock") is None
        finally:
            cap_pkg.exit_predicate_lock()
        assert ledger.lock_violations == 1
        # off-lock drains work again immediately
        assert ledger.drain(trigger="off-lock") is not None
        assert ledger.lock_violations == 1
    finally:
        h.close()


def test_eviction_waste_flows_reporter_to_slo_engine():
    """WasteMetricsReporter is the single source of truth for
    eviction-waste — every waste phase it marks (including the
    failed-scheduling-attempt split) lands as one eviction_waste sample
    in the SLO engine via the slo_sink hook."""
    from k8s_spark_scheduler_tpu_torch.types.objects import DemandPhase

    h = _harness()
    try:
        h.new_node("n1")
        h.new_node("n2")
        slo = h.server.slo
        assert slo is not None
        assert h.server.waste_reporter.slo_sink == slo.waste_sample
        before = slo.status()["eviction_waste"]["total"]

        big = h.static_allocation_spark_pods("app-waste", 40)[0]
        h.assert_failure(h.schedule(big, ["n1", "n2"]))
        assert h.wait_for_api(lambda: len(h.api.list("Demand")) == 1)
        demand = h.api.list("Demand")[0]
        demand.status.phase = DemandPhase.FULFILLED
        h.api.update(demand)
        # a failed attempt AFTER fulfillment → the failure-outcome split
        h.assert_failure(h.schedule(big, ["n1", "n2"]))
        h.new_node("n3", cpu="64", memory="64Gi")
        h.assert_success(h.schedule(big, ["n1", "n2", "n3"]))
        h.wait_quiesced()

        # before-demand-creation + after-demand-fulfilled +
        # failure-<outcome> + since-last-failure = 4 samples
        body = slo.status()["eviction_waste"]
        assert body["total"] - before >= 4
    finally:
        h.close()


def test_decision_traces_carry_the_slo_alert_tag():
    """With an objective burning, a Filter's trace carries the
    precomputed alert tag (one attribute read on the Filter's path)."""
    h = _harness()
    try:
        h.new_node("n1")
        slo = h.server.slo
        for k in range(10):
            slo.observe("time_to_admit", 900.0)
        slo.evaluate()
        driver = h.static_allocation_spark_pods("app-alert", 1)[0]
        h.assert_success(h.schedule(driver, ["n1"]))
        trace = h.server.tracer.find_by_tag("pod", driver.name)
        assert trace["root"]["tags"]["sloAlert"] == slo.alert_tag == "time_to_admit:page"
        assert h.server.tracer.find_by_trace_id(trace["traceId"]) is trace
    finally:
        h.close()


# -- HTTP surface -------------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_http_slo_and_lifecycle_endpoints():
    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer

    h = _harness()
    http = None
    try:
        h.new_node("n1")
        h.new_node("n2")
        pods = h.static_allocation_spark_pods("app-http", 1)
        h.assert_success(h.schedule(pods[0], ["n1", "n2"]))
        h.assert_success(h.schedule(pods[1], ["n1", "n2"]))
        h.wait_quiesced()

        http = ExtenderHTTPServer(h.server, port=0)
        http.start()
        port = http.port

        # GET /slo: the scorecard with burn-rate status for ≥4 objectives
        status, card = _get(port, "/slo")
        assert status == 200
        assert card["schema"]["name"] == SCHEMA_NAME
        assert card["meta"]["source"] == "server"
        assert len(card["objectives"]) >= 4
        for body in card["objectives"].values():
            assert body["state"] in ("ok", "warn", "page")
            assert set(body["windows"]) == {"page", "warn"}
        assert card["lifecycle"]["gangs"] >= 1
        assert card["digest"] == scorecard_digest(card)

        # GET /lifecycle: summary + per-gang briefs
        status, listing = _get(port, "/lifecycle")
        assert status == 200
        assert listing["summary"]["gangs"] >= 1
        assert any(g["app"] == "app-http" for g in listing["gangs"])

        # GET /lifecycle/<app>: the full record
        status, rec = _get(port, "/lifecycle/app-http")
        assert status == 200
        assert rec["app"] == "app-http"
        assert rec["phase"] in ("bound", "running")

        status, _ = _get(port, "/lifecycle/no-such-app")
        assert status == 404
    finally:
        if http is not None:
            http.stop()
        h.close()


def test_http_endpoints_answer_404_when_disabled():
    """The reference's bodies when a subsystem is off."""
    from k8s_spark_scheduler_tpu_torch.config import CapacityConfig, Install, LifecycleConfig
    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer

    h = Harness(device="cpu", extra_install=Install(
        binpack_algo="tpu-batch", fifo=True,
        capacity=CapacityConfig(enabled=False), lifecycle=LifecycleConfig(enabled=False),
    ))
    http = ExtenderHTTPServer(h.server, port=0)
    http.start()
    try:
        assert (h.server.capacity, h.server.lifecycle, h.server.slo) == (None, None, None)
        assert _get(http.port, "/state/capacity") == (404, {"error": "capacity observatory not enabled"})
        assert _get(http.port, "/slo") == (404, {"error": "slo engine not enabled"})
        assert _get(http.port, "/lifecycle") == (404, {"error": "lifecycle ledger not enabled"})
        assert h.server.extender.slo_alert_source is None
    finally:
        http.stop()
        h.close()


# -- scorecard ----------------------------------------------------------------


def test_scorecard_digest_ignores_meta_and_operational_counters():
    engine = SloEngine()
    card = build_scorecard(None, engine, meta={"source": "a"}, now=10.0)
    twin = build_scorecard(None, engine, meta={"source": "b", "extra": 1}, now=10.0)
    assert card["digest"] == twin["digest"]

    drift = json.loads(json.dumps(card))
    drift["lifecycle"] = {"gangs": 0, "drains": 99, "lockViolations": 0}
    base = json.loads(json.dumps(card))
    base["lifecycle"] = {"gangs": 0, "drains": 1, "lockViolations": 0}
    # drain-loop cadence is operational, not policy: no digest churn
    assert scorecard_digest(drift) == scorecard_digest(base)
    assert scorecard_diff(base, drift) == []
    # a policy-visible count DOES churn the digest
    drift["lifecycle"]["gangs"] = 5
    assert scorecard_digest(drift) != scorecard_digest(base)
    assert scorecard_diff(base, drift) == [("lifecycle.gangs", 0, 5)]
    # the reference computes the same digest for the same document
    from k8s_spark_scheduler_tpu.lifecycle import build_scorecard as jax_build_scorecard

    assert jax_build_scorecard(None, JaxSloEngine(), meta={"source": "a"}, now=10.0)["digest"] == card["digest"]


def test_scorecard_diff_edge_cases():
    """Leaf-walk robustness: missing leaves, type changes, and nested
    additions each surface as explicit (path, a, b) tuples — not crash,
    not vanish."""
    base = build_scorecard(None, SloEngine(), meta={"source": "a"}, now=10.0)
    objective = next(iter(base["objectives"]))

    # missing leaf: one side lost a nested key entirely
    lost = json.loads(json.dumps(base))
    removed = lost["objectives"][objective].pop("target")
    diffs = scorecard_diff(base, lost)
    assert (f"objectives.{objective}.target", removed, "<absent>") in diffs

    # type change: scalar leaf became an object — reported as one leaf
    typed = json.loads(json.dumps(base))
    typed["objectives"][objective]["target"] = {"value": removed, "unit": "s"}
    diffs = scorecard_diff(base, typed)
    assert (f"objectives.{objective}.target", removed, {"value": removed, "unit": "s"}) in diffs

    # nested addition: a whole new objective appears on one side
    grown = json.loads(json.dumps(base))
    grown["objectives"]["gpu_wait"] = {"target": 0.99, "state": "ok"}
    diffs = scorecard_diff(base, grown)
    assert ("objectives.gpu_wait.target", "<absent>", 0.99) in diffs
    assert ("objectives.gpu_wait.state", "<absent>", "ok") in diffs
    # and the walk is symmetric
    assert ("objectives.gpu_wait.target", 0.99, "<absent>") in scorecard_diff(grown, base)

    # float exposition noise below the canonical rounding is NOT a diff
    noisy = json.loads(json.dumps(base))
    noisy["objectives"][objective]["target"] = removed + 1e-12
    assert scorecard_diff(base, noisy) == []


# -- the Twin: both servers' observatory bodies on one frozen clock ------------

def _capacity_body(sample: dict) -> dict:
    out = {k: v for k, v in sample.items() if k not in UNCOMPARED["capacity"]}
    out["contentKey"] = sample["contentKey"][1:]
    out["structureKey"] = sample["structureKey"][1:]
    out["classes"] = {k: v for k, v in sample["classes"].items() if k not in UNCOMPARED["classes"]}
    return out


def _slo_body(card: dict) -> dict:
    out = {k: v for k, v in card.items() if k != "digest"}
    out["objectives"] = dict(card["objectives"])
    out["objectives"]["filter_latency"] = {
        k: v for k, v in card["objectives"]["filter_latency"].items() if k not in UNCOMPARED["filter_latency"]
    }
    out["lifecycle"] = _summary_body(card["lifecycle"])
    return out


def test_twin_observatory_bodies_equal_on_the_defaults():
    twin = Twin("tpu-batch")
    try:
        twin.quiet_observatories()
        for i, zone in enumerate(("zone1", "zone1", "zone2")):
            twin.add_node(f"n{i}", cpu="16", memory="32Gi", zone=zone)
        names = ["n0", "n1", "n2"]
        granted = twin.static_pods("app-a", 2, age=60.0)
        for pod in granted:
            assert twin.schedule(pod, names)
        big = twin.static_pods("app-big", 80, age=30.0)[0]
        assert twin.schedule(big, names) is None  # refused: a demand and a queued gang
        small = twin.static_pods("app-small", 1)[0]
        twin.create_pod(small)
        twin.advance(30.0)

        (js, jbody), (ps, pbody) = twin.get("/state/capacity")
        assert js == ps == 200
        assert _capacity_body(pbody) == _capacity_body(jbody)
        assert pbody["probeLane"] == "torch" and pbody["queuedGangs"] == 2 and pbody["pressure"] == 1
        first = pbody["seq"]

        # the granted app finishes; a later sample, the ring and a diff
        twin.delete_pod(granted[0])
        twin.advance(30.0)
        (_, jbody), (_, pbody) = twin.get("/state/capacity?group=batch-medium-priority&zone=zone1&ns=default")
        assert _capacity_body(pbody) == _capacity_body(jbody)
        assert list(pbody["groups"]) == ["batch-medium-priority|zone1"]
        (_, jhist), (_, phist) = twin.get("/state/capacity/history?limit=5")
        assert [_capacity_body(s) for s in phist["samples"]] == [_capacity_body(s) for s in jhist["samples"]]
        assert (phist["ring"], phist["ringCapacity"]) == (jhist["ring"], jhist["ringCapacity"]) == (2, 256)
        last = phist["samples"][0]["seq"]
        jdiff, pdiff = twin.get(f"/state/capacity/diff?from={first}&to={last}")
        assert pdiff == jdiff and pdiff[0] == 200
        assert twin.get("/state/capacity/diff?from=x") == (
            (400, {"error": "usage: /state/capacity/diff?from=<seq>&to=<seq>"}),) * 2

        (js, jcard), (ps, pcard) = twin.get("/slo")
        assert js == ps == 200
        assert _slo_body(pcard) == _slo_body(jcard)
        assert pcard["digest"] == scorecard_digest(pcard) and jcard["digest"] == scorecard_digest(jcard)
        assert pcard["objectives"]["filter_latency"]["total"] >= 4

        (js, jlist), (ps, plist) = twin.get("/lifecycle")
        assert js == ps == 200 and plist["gangs"] == jlist["gangs"]
        assert _summary_body(plist["summary"]) == _summary_body(jlist["summary"])
        assert {g["app"]: g["phase"] for g in plist["gangs"]} == {
            "app-a": "completed", "app-big": "queued", "app-small": "queued"}
        for app in ("app-a", "app-big", "app-small"):
            (js, jrec), (ps, prec) = twin.get(f"/lifecycle/{app}")
            assert js == ps == 200
            assert _record_body(prec) == _record_body(jrec)
        assert twin.get("/lifecycle/no-such-app") == (
            (404, {"error": "no lifecycle record for app 'no-such-app'"}),) * 2
    finally:
        twin.close()
