"""The port's metrics reporters + waste reporter, histogram reservoir
sampling, and the Prometheus text exposition — the reference package's
cases (harness on ``device="cpu"``), plus the exposition held byte-equal
to the JAX package's on registries with the same contents."""

import re
import time

import pytest

from k8s_spark_scheduler_tpu_torch.metrics import names
from k8s_spark_scheduler_tpu_torch.metrics import prometheus as prom
from k8s_spark_scheduler_tpu_torch.metrics.registry import Histogram, MetricsRegistry
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.objects import DemandPhase


@pytest.fixture
def harness():
    h = Harness(device="cpu")
    yield h
    h.close()


def test_reporters_run_and_emit(harness):
    harness.new_node("n1")
    harness.new_node("n2")
    pods = harness.static_allocation_spark_pods("app-m", 1)
    harness.assert_success(harness.schedule(pods[0], ["n1", "n2"]))

    # a pending driver for lifecycle metrics
    pending = harness.static_allocation_spark_pods("app-pending", 50)[0]
    harness.create_pod(pending)

    harness.server.reporters.report_once()
    m = harness.server.metrics

    # reserved usage on the driver's node
    rr = harness.get_resource_reservation("app-m")
    node = rr.spec.reservations["driver"].node
    tags = {names.TAG_HOST: node, names.TAG_INSTANCE_GROUP: "batch-medium-priority"}
    assert m.get_gauge(names.RESOURCE_USAGE_CPU, tags) >= 1.0

    # one pending pod in the queue lifecycle
    assert m.get_gauge(names.LIFECYCLE_COUNT, {names.TAG_LIFECYCLE: "queued"}) == 1.0

    # unbound executor reservation (executor not yet scheduled)
    assert m.get_gauge(names.UNBOUND_CPU_RESERVATIONS) == 1.0

    # cache drift should be zero after the write-back drains
    harness.wait_for_api(lambda: len(harness.api.list("ResourceReservation")) == 1)
    harness.server.reporters.report_once()
    assert m.get_gauge(names.CACHED_OBJECT_COUNT + ".drift") == 0.0


def test_schedule_outcome_metrics(harness):
    harness.new_node("n1")
    harness.new_node("n2")
    driver = harness.static_allocation_spark_pods("app-1", 1)[0]
    harness.assert_success(harness.schedule(driver, ["n1", "n2"]))
    m = harness.server.metrics
    assert (
        m.get_counter(
            names.REQUEST_COUNTER,
            {"instanceGroup": "batch-medium-priority", "role": "driver", "outcome": "success"},
        )
        == 1.0
    )


def test_waste_reporter_phases(harness):
    harness.new_node("n1")
    harness.new_node("n2")
    m = harness.server.metrics

    # path 1: scheduled without a demand
    ok = harness.static_allocation_spark_pods("app-fast", 1)[0]
    harness.assert_success(harness.schedule(ok, ["n1", "n2"]))
    h = m.get_histogram(names.SCHEDULING_WASTE, {names.TAG_WASTE_TYPE: "total-time-no-demand"})
    assert h["count"] == 1

    # path 2: demand created, fulfilled, then scheduled
    big = harness.static_allocation_spark_pods("app-slow", 40)[0]
    harness.assert_failure(harness.schedule(big, ["n1", "n2"]))
    assert harness.wait_for_api(lambda: len(harness.api.list("Demand")) == 1)

    demand = harness.api.list("Demand")[0]
    demand.status.phase = DemandPhase.FULFILLED
    harness.api.update(demand)

    # another failed attempt AFTER fulfillment (capacity not yet visible)
    harness.assert_failure(harness.schedule(big, ["n1", "n2"]))

    harness.new_node("n3", cpu="64", memory="64Gi")
    harness.assert_success(harness.schedule(big, ["n1", "n2", "n3"]))

    for waste_type in (
        "before-demand-creation",
        "after-demand-fulfilled",
        "after-demand-fulfilled-since-last-failure",
        "after-demand-fulfilled-failure-failure-fit",
    ):
        h = m.get_histogram(names.SCHEDULING_WASTE, {names.TAG_WASTE_TYPE: waste_type})
        assert h["count"] == 1, waste_type


def test_registry_timer_and_snapshot():
    m = MetricsRegistry()
    with m.timer("op.time", {"t": "x"}):
        time.sleep(0.01)
    snap = m.snapshot()
    assert any(k.startswith("op.time") for k in snap["histograms"])
    assert m.get_histogram("op.time", {"t": "x"})["count"] == 1


def test_time_to_first_bind_metric(harness):
    m = harness.server.metrics
    harness.new_node("n1")
    harness.new_node("n2")
    before = m.get_histogram(names.TIME_TO_FIRST_BIND)["count"]
    pods = harness.static_allocation_spark_pods("app-ttfb", 1)
    harness.assert_success(harness.schedule(pods[0], ["n1", "n2"]))
    harness.assert_success(harness.schedule(pods[1], ["n1", "n2"]))
    after = m.get_histogram(names.TIME_TO_FIRST_BIND)["count"]
    assert after == before + 1
    assert m.get_gauge(names.TIME_TO_FIRST_BIND_MEDIAN) is not None
    # a rebind of the same reservation must not re-count
    harness.terminate_pod(pods[1])
    replacement = harness.static_allocation_spark_pods("app-ttfb", 1)[1]
    replacement.meta.name = "app-ttfb-exec-r"
    harness.assert_success(harness.schedule(replacement, ["n1", "n2"]))
    assert m.get_histogram(names.TIME_TO_FIRST_BIND)["count"] == after


# -- histogram reservoir sampling -------------------------------------------


def test_histogram_reservoir_is_unbiased_over_the_whole_stream():
    """Algorithm R keeps a uniform sample of ALL updates.  The previous
    ``count % cap`` overwrite kept only the last ~cap values, so a burst
    at the end of the stream dragged every quantile to the burst value."""
    h = Histogram(cap=512)
    # 20k uniform values in [0, 1), then a 512-value burst at 100.0 —
    # exactly one reservoir's worth, which the modulo scheme would have
    # kept wholesale (p50 would report 100.0)
    for i in range(20000):
        h.update((i * 7919 % 20000) / 20000.0)
    for _ in range(512):
        h.update(100.0)
    snap = h.snapshot()
    assert snap["count"] == 20512
    # the burst is ~2.5% of the stream: the median must stay in-body
    assert snap["p50"] < 1.0, snap
    assert abs(snap["p50"] - 0.5) < 0.1, snap
    # true max is tracked exactly, not sampled
    assert snap["max"] == 100.0


def test_histogram_reservoir_is_deterministic():
    def fill():
        h = Histogram(cap=64)
        for i in range(5000):
            h.update(float(i % 997))
        return h.snapshot()

    assert fill() == fill()


def test_histogram_small_stream_is_exact():
    h = Histogram(cap=2048)
    for v in (1.0, 2.0, 3.0, 4.0):
        h.update(v)
    snap = h.snapshot()
    assert snap["count"] == 4 and snap["p50"] == 2.0 and snap["max"] == 4.0


# -- prometheus exposition ---------------------------------------------------

_SERIES_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$"
)


def _assert_valid_exposition(text):
    for line in text.strip().split("\n"):
        if line.startswith("#"):
            assert re.match(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|summary)$", line), line
        else:
            assert _SERIES_RE.match(line), line


def test_prometheus_rendering_counter_gauge_histogram():
    m = MetricsRegistry()
    m.counter("foundry.spark.scheduler.requests", {"outcome": "success"}, inc=3)
    m.counter("foundry.spark.scheduler.requests", {"outcome": "failure-fit"})
    m.gauge("foundry.spark.scheduler.packing.efficiency", 0.75)
    for v in (0.001, 0.002, 0.003):
        m.histogram("foundry.spark.scheduler.schedule.time", v, {"role": "driver"})

    text = prom.render(m)
    _assert_valid_exposition(text)
    assert "# TYPE foundry_spark_scheduler_requests counter" in text
    assert 'foundry_spark_scheduler_requests{outcome="success"} 3' in text
    assert 'foundry_spark_scheduler_requests{outcome="failure-fit"} 1' in text
    assert "foundry_spark_scheduler_packing_efficiency 0.75" in text
    assert "# TYPE foundry_spark_scheduler_schedule_time summary" in text
    assert 'foundry_spark_scheduler_schedule_time{role="driver",quantile="0.5"} 0.002' in text
    assert 'foundry_spark_scheduler_schedule_time_count{role="driver"} 3' in text
    assert 'foundry_spark_scheduler_schedule_time_sum{role="driver"}' in text
    assert 'foundry_spark_scheduler_schedule_time_max{role="driver"} 0.003' in text


def test_prometheus_label_and_name_escaping():
    m = MetricsRegistry()
    m.counter(
        "foundry.spark.scheduler.resource.usage.nvidia.com/gpu",
        {"node-name": 'weird"quote\\slash\nnewline'},
    )
    text = prom.render(m)
    _assert_valid_exposition(text)
    # '/' and '.' sanitized out of the metric name; '-' out of the label
    assert "foundry_spark_scheduler_resource_usage_nvidia_com_gpu{" in text
    assert 'node_name="weird\\"quote\\\\slash\\nnewline"' in text


def test_prometheus_empty_registry():
    assert prom.render(MetricsRegistry()) == ""


# -- OpenMetrics flavour (exemplars + EOF + content negotiation) --------------


def _registry_with_all_families():
    from k8s_spark_scheduler_tpu_torch.tracing import Tracer

    m = MetricsRegistry()
    m.counter("foundry.spark.scheduler.requests", {"outcome": "success"}, inc=2)
    m.gauge("foundry.spark.scheduler.packing.efficiency", 0.5)
    tracer = Tracer()
    with tracer.span("root", trace_id="tr-ex"):
        m.histogram("foundry.spark.scheduler.schedule.time", 0.004, {"role": "driver"})
    m.histogram("foundry.spark.scheduler.wait.time", 0.2)  # untraced: no exemplar
    return m


def test_openmetrics_exemplars_only_on_counterlike_lines():
    """ISSUE satellite: exemplars may ride only on counter-like series
    (the summary ``_count`` lines here) — never on gauges, quantiles,
    ``_sum``, or the ``_max`` gauge family."""
    text = prom.render(_registry_with_all_families(), openmetrics=True)
    exemplar_lines = [l for l in text.split("\n") if " # {" in l]
    assert exemplar_lines, "traced histogram observation produced no exemplar"
    for line in exemplar_lines:
        family = line.split("{", 1)[0]
        assert family.endswith("_count"), line
    assert 'trace_id="tr-ex"' in exemplar_lines[0]
    # the untraced histogram's _count carries none
    assert not any(
        " # {" in l for l in text.split("\n")
        if l.startswith("foundry_spark_scheduler_wait_time_count")
    )
    # plain mode: byte-identical exposition, zero exemplars, no EOF
    plain = prom.render(_registry_with_all_families())
    assert " # {" not in plain and "# EOF" not in plain


def test_openmetrics_terminates_with_eof():
    text = prom.render(_registry_with_all_families(), openmetrics=True)
    assert text.endswith("# EOF\n")
    assert text.count("# EOF") == 1
    # mandatory even before the first recorded metric: a scrape of an
    # idle registry must still parse as OpenMetrics
    assert prom.render(MetricsRegistry(), openmetrics=True) == "# EOF\n"


def test_metrics_content_negotiation(harness):
    """?format=openmetrics is the ONLY route to the exemplar flavour
    (with its content-type); any Accept header — openmetrics included —
    gets the plain 0.0.4 text, per the documented policy that the
    pragmatic exemplar flavour would fail a strict OpenMetrics parser."""
    import urllib.request

    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer

    http = ExtenderHTTPServer(harness.server, port=0)
    http.start()
    try:
        base = f"http://127.0.0.1:{http.port}/metrics"

        def fetch(url, accept=None):
            req = urllib.request.Request(url)
            if accept:
                req.add_header("Accept", accept)
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.headers.get("Content-Type"), resp.read().decode()

        ctype, body = fetch(base + "?format=openmetrics")
        assert ctype == prom.CONTENT_TYPE_OPENMETRICS
        assert body.endswith("# EOF\n")

        for accept in ("application/openmetrics-text", "text/plain"):
            ctype, body = fetch(base, accept=accept)
            assert ctype == prom.CONTENT_TYPE, accept
            assert "# EOF" not in body, accept

        ctype, body = fetch(base)  # no Accept → JSON snapshot
        assert ctype.startswith("application/json")
    finally:
        http.stop()


# -- byte parity with the JAX package's exposition -----------------------------


def _fill(registry_cls, tracer_cls, seed):
    """A registry with the same random contents in either package:
    counters, gauges, traced and untraced histograms, names and labels
    that need sanitizing or escaping."""
    import random

    rng = random.Random(seed)
    m = registry_cls()
    tracer = tracer_cls()
    metric_names = [
        names.REQUEST_COUNTER, names.RESOURCE_USAGE_NVIDIA_GPUS, "9starts.with-digit",
        "a/b.c-d", names.SCHEDULING_WASTE, names.TRACE_SPAN_TIME,
    ]
    label_values = ["x", 'q"uote', "back\\slash", "new\nline", "", "ünïcode"]
    for i in range(rng.randint(5, 40)):
        name = rng.choice(metric_names)
        tags = {rng.choice(["outcome", "node-name", "0lead", "a.b"]): rng.choice(label_values)
                for _ in range(rng.randint(0, 3))}
        kind = rng.random()
        value = rng.choice([0, 1, 2.5, 1e-7, 123456789.0, 1e20, float("inf"), -3.25])
        if kind < 0.35:
            m.counter(name + ".c", tags, inc=abs(value) if value == value else 1)
        elif kind < 0.6:
            m.gauge(name + ".g", value, tags)
        elif kind < 0.8:
            with tracer.span("root", trace_id=f"tr-{i}"):
                m.histogram(name + ".h", abs(value), tags)
        else:
            m.histogram(name + ".h", abs(value), tags)
    return m


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_render_bytes_equal_the_reference(seed, openmetrics):
    from k8s_spark_scheduler_tpu.metrics import prometheus as jax_prom
    from k8s_spark_scheduler_tpu.metrics.registry import MetricsRegistry as JaxRegistry
    from k8s_spark_scheduler_tpu.tracing import Tracer as JaxTracer
    from k8s_spark_scheduler_tpu_torch.tracing import Tracer

    ours = prom.render(_fill(MetricsRegistry, Tracer, seed), openmetrics=openmetrics)
    theirs = jax_prom.render(_fill(JaxRegistry, JaxTracer, seed), openmetrics=openmetrics)
    assert ours.encode() == theirs.encode()
    assert ours  # never the empty exposition
    if openmetrics:
        assert ours.endswith("# EOF\n")
    else:
        _assert_valid_exposition(ours)
    assert prom.render(MetricsRegistry(), openmetrics=openmetrics) == jax_prom.render(
        JaxRegistry(), openmetrics=openmetrics
    )
    for raw in ("a.b/c", "9x", "", "ok_name:sub", "ü"):
        assert prom.sanitize_metric_name(raw) == jax_prom.sanitize_metric_name(raw)
        assert prom.sanitize_label_name(raw) == jax_prom.sanitize_label_name(raw)
        assert prom.escape_label_value(raw + '"\\\n') == jax_prom.escape_label_value(raw + '"\\\n')


def test_metrics_prometheus_negotiation(harness):
    """After a Filter, /metrics stays JSON by default; Accept: text/plain
    and ?format=prometheus give the exposition, with the request counter."""
    import json
    import urllib.request

    from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer

    harness.new_node("n1")
    harness.new_node("n2")
    driver = harness.static_allocation_spark_pods("app-prom", 1)[0]
    harness.assert_success(harness.schedule(driver, ["n1", "n2"]))
    http = ExtenderHTTPServer(harness.server, port=0)
    http.start()
    try:
        def fetch(path, accept=None):
            req = urllib.request.Request(f"http://127.0.0.1:{http.port}{path}")
            if accept:
                req.add_header("Accept", accept)
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, resp.headers.get("Content-Type"), resp.read()

        status, ctype, raw = fetch("/metrics")
        assert status == 200 and "counters" in json.loads(raw)
        status, ctype, raw = fetch("/metrics", accept="text/plain;version=0.0.4")
        assert status == 200 and ctype.startswith("text/plain")
        text = raw.decode()
        _assert_valid_exposition(text)
        assert "# TYPE foundry_spark_scheduler_requests counter" in text
        assert 'outcome="success"' in text
        status, _, raw2 = fetch("/metrics?format=prometheus")
        assert status == 200 and b"# TYPE" in raw2
    finally:
        http.stop()
