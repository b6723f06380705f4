"""The port's contention observatory (contention/) against the JAX
package's: TimedLock wait/hold telemetry with holder/blocker
attribution, the critical-path decomposition and its analyzer, the
layering with the port's race detector (timing innermost, detector
outermost), and the tracer's observer hook.  The cases of the
reference's tests/test_contention.py run on the port's modules; the
decomposition and the analyzer are held equal to the JAX package's on
span trees built from a seed with numpy, and the two TimedLocks to each
other on the same acquire sequence."""

import gc
import os
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from k8s_spark_scheduler_tpu.analysis import guarded as jax_guarded
from k8s_spark_scheduler_tpu.contention import criticalpath as jax_cp
from k8s_spark_scheduler_tpu.contention import locktime as jax_locktime
from k8s_spark_scheduler_tpu_torch.analysis import guarded as port_guarded
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by
from k8s_spark_scheduler_tpu_torch.contention import criticalpath as port_cp
from k8s_spark_scheduler_tpu_torch.contention import locktime
from k8s_spark_scheduler_tpu_torch.contention.criticalpath import (
    SEGMENT_NAMES,
    CriticalPathAnalyzer,
    decompose,
)
from k8s_spark_scheduler_tpu_torch.contention.locktime import LockTimekeeper, TimedLock
from k8s_spark_scheduler_tpu_torch.metrics import names as M
from k8s_spark_scheduler_tpu_torch.metrics.registry import MetricsRegistry
from torch_parity import Twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def keeper():
    """A fresh port keeper for the duration of the test, restoring
    whatever switchboard state the process had before (server fixtures
    in the same process enable one globally)."""
    prev = locktime.get()
    kp = LockTimekeeper()
    locktime.enable(kp)
    try:
        yield kp
    finally:
        if prev is not None:
            locktime.enable(prev)
        else:
            locktime.disable()


@pytest.fixture
def fixed_phase():
    """Pin the port's phase attribution to a deterministic fake span."""
    span = SimpleNamespace(name="test-phase", tags={})

    prev = locktime._current_span
    locktime._current_span = lambda: span
    try:
        yield span
    finally:
        locktime._current_span = prev


# -- TimedLock ----------------------------------------------------------------


def test_wait_hold_and_blocker_attribution(keeper, fixed_phase):
    lock = TimedLock(threading.Lock(), "t.contended", sample_every=1)
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=holder, name="holder-thread")
    t.start()
    entered.wait(5.0)
    time.sleep(0.01)
    releaser = threading.Timer(0.05, release.set)
    releaser.start()
    t0 = time.perf_counter()
    with lock:
        waited_s = time.perf_counter() - t0
    t.join(5.0)
    releaser.join(5.0)

    snap = lock.snapshot()
    assert snap["acquisitions"] == 2
    assert snap["contended"] == 1
    # the contended wait is recorded and is of the right magnitude
    assert snap["waitMs"]["count"] >= 1
    assert snap["waitMs"]["max"] >= 30.0
    assert snap["waitMs"]["max"] <= waited_s * 1000.0 + 1.0
    # both holds recorded (sample_every=1), attributed to the phase
    assert snap["holdMs"]["count"] == 2
    assert snap["holdMs"]["max"] >= 40.0
    assert snap["byPhase"]["test-phase"]["holds"] == 2
    # blame: the wait is charged to the holder's phase
    assert snap["topBlockers"][0]["holderPhase"] == "test-phase"
    assert snap["topBlockers"][0]["totalWaitMs"] >= 30.0


def test_uncontended_sampling_stride(keeper):
    lock = TimedLock(threading.Lock(), "t.sampled", sample_every=4)
    for _ in range(100):
        with lock:
            pass
    snap = lock.snapshot()
    assert snap["acquisitions"] == 100
    assert snap["contended"] == 0
    # 1-in-4 uncontended acquires record (wait=0 point + a hold)
    assert snap["waitMs"]["count"] == 25
    assert snap["holdMs"]["count"] == 25
    assert snap["waitMs"]["max"] == 0.0


def test_reentrant_only_outermost_timed(keeper):
    lock = TimedLock(threading.RLock(), "t.reentrant", sample_every=1)
    assert lock.locked() is False
    with lock:
        assert lock.locked() is True
        with lock:
            assert lock.locked() is True
        assert lock.locked() is True  # inner release keeps the hold
    assert lock.locked() is False
    snap = lock.snapshot()
    assert snap["acquisitions"] == 1  # only the outermost acquire counts
    assert snap["holdMs"]["count"] == 1


def test_failed_probe_records_nothing(keeper):
    lock = TimedLock(threading.Lock(), "t.probe", sample_every=1)
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    entered.wait(5.0)
    try:
        assert lock.acquire(blocking=False) is False
        assert lock.locked() is True
    finally:
        release.set()
        t.join(5.0)
    snap = lock.snapshot()
    assert snap["acquisitions"] == 1  # the holder's, not the probe's
    assert snap["contended"] == 0


def test_disabled_lock_still_works_and_records_nothing():
    prev = locktime.get()
    locktime.disable()
    try:
        lock = TimedLock(threading.Lock(), "t.disabled", sample_every=1)
        for _ in range(10):
            with lock:
                pass
        assert lock.acquire(blocking=False) is True
        lock.release()
        rlock = TimedLock(threading.RLock(), "t.disabled.r", sample_every=1)
        with rlock:
            with rlock:
                assert rlock.locked() is True
        assert rlock.locked() is False
        assert lock.snapshot()["acquisitions"] == 0
        assert locktime.snapshot() == []
    finally:
        if prev is not None:
            locktime.enable(prev)


def test_tag_waits_stamps_active_span(keeper, fixed_phase):
    lock = TimedLock(threading.Lock(), "t.tagged", sample_every=1, tag_waits=True)
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    entered.wait(5.0)
    releaser = threading.Timer(0.03, release.set)
    releaser.start()
    with lock:
        pass
    t.join(5.0)
    releaser.join(5.0)
    assert fixed_phase.tags.get("lockWaitMs", 0.0) >= 15.0
    # accumulates across acquires rather than overwriting
    first = fixed_phase.tags["lockWaitMs"]
    with lock:
        pass
    assert fixed_phase.tags["lockWaitMs"] >= first


def test_keeper_snapshot_merges_instances_and_publishes(keeper, fixed_phase):
    a = TimedLock(threading.Lock(), "t.shared", sample_every=1)
    b = TimedLock(threading.Lock(), "t.shared", sample_every=1)
    for lk in (a, b):
        for _ in range(3):
            with lk:
                pass
    merged = {s["name"]: s for s in keeper.snapshot(name_filter="t.shared")}
    assert merged["t.shared"]["instances"] == 2
    assert merged["t.shared"]["acquisitions"] == 6

    registry = MetricsRegistry()
    keeper.publish(registry)
    gauges = registry.snapshot()["gauges"]
    assert [k for k in gauges if M.LOCK_ACQUIRE_COUNT in k and "t.shared" in k], sorted(gauges)
    tags = {M.TAG_LOCK: "t.shared", M.TAG_PHASE: "test-phase"}
    assert registry.get_histogram(M.LOCK_HOLD_TIME, tags)["count"] == 6
    # pending buffers drained: publishing twice adds nothing
    keeper.publish(registry)
    assert registry.get_histogram(M.LOCK_HOLD_TIME, tags)["count"] == 6


def test_timed_locks_of_both_packages_count_alike(keeper):
    """One seeded acquire sequence (plain and reentrant locks, sampling
    strides, failed probes) through both packages' TimedLocks, each
    under its own keeper: equal counters and distribution counts."""
    jax_prev = jax_locktime.get()
    jax_locktime.enable(jax_locktime.LockTimekeeper())
    try:
        snaps = []
        for mod in (jax_locktime, locktime):
            r = np.random.default_rng(7)
            plain = mod.TimedLock(threading.Lock(), "t.parity", sample_every=3)
            rlock = mod.TimedLock(threading.RLock(), "t.parity.r", sample_every=2)
            for _ in range(200):
                op = int(r.integers(0, 4))
                if op == 0:
                    with plain:
                        pass
                elif op == 1:
                    with rlock:
                        for _ in range(int(r.integers(0, 3))):
                            with rlock:
                                pass
                elif op == 2:
                    assert plain.acquire(blocking=False)
                    plain.release()
                else:
                    with plain:
                        assert not rlock.locked()
            snaps.append([lk.snapshot() for lk in (plain, rlock)])
        for jax_snap, port_snap in zip(*snaps):
            for key in ("name", "acquisitions", "contended", "sampleEvery"):
                assert port_snap[key] == jax_snap[key], key
            for dist in ("waitMs", "holdMs"):
                assert port_snap[dist]["count"] == jax_snap[dist]["count"], dist
            assert {p: v["holds"] for p, v in port_snap["byPhase"].items()} == {
                p: v["holds"] for p, v in jax_snap["byPhase"].items()
            }
    finally:
        if jax_prev is not None:
            jax_locktime.enable(jax_prev)
        else:
            jax_locktime.disable()


# -- layering with racecheck ---------------------------------------------------


def test_guarded_by_wraps_timed_then_tracked():
    @guarded_by("_lock", "value")
    class Guarded:
        def __init__(self):
            self._lock = threading.Lock()
            self.value = 0

    plain = Guarded()
    assert isinstance(plain._lock, TimedLock)
    assert isinstance(plain._lock._inner, type(threading.Lock()))
    assert plain._lock.name == "Guarded._lock"

    det = racecheck.enable(racecheck.RaceDetector())
    try:
        layered = Guarded()
        # detector outermost, timing innermost, raw lock at the core
        assert isinstance(layered._lock, racecheck.TrackedLock)
        assert isinstance(layered._lock._inner, TimedLock)
        with layered._lock:
            racecheck.note_access(layered, "value")
            layered.value += 1
        assert det.races == []
    finally:
        racecheck.disable()


# -- critical-path decomposition ----------------------------------------------


def _span(name, duration_s, tags=None, children=()):
    return SimpleNamespace(
        name=name,
        duration=duration_s,
        tags=tags or {},
        children=list(children),
        trace_id="trace-1",
        start_time=123.0,
    )


def _request_trace(total_s=0.100):
    return _span(
        "http.request",
        total_s,
        tags={"path": "/predicates", "gateWaitMs": 5.0, "lockWaitMs": 10.0},
        children=[
            _span("http.read", 0.004),
            _span("serde.decode", 0.006),
            _span(
                "predicate",
                0.060,
                children=[
                    _span("binpack", 0.030, children=[_span("kernel:fifo_queue", 0.020)]),
                    _span(
                        "reservation.writeback",
                        0.010,
                        children=[_span("state.writeback.enqueue", 0.002)],
                    ),
                ],
            ),
            _span("serde.encode", 0.005),
        ],
    )


def test_decompose_exclusive_attribution():
    record = decompose(_request_trace())
    assert record is not None
    seg = record["segments"]
    assert record["totalMs"] == pytest.approx(100.0)
    # serde: read 4 + decode 6 + encode 5
    assert seg["serde"] == pytest.approx(15.0)
    # solve: predicate self 20 + binpack self 10 + kernel 20 = 50
    assert seg["solve"] == pytest.approx(50.0)
    # write-back: writeback self 8 + enqueue 2
    assert seg["write-back"] == pytest.approx(10.0)
    assert seg["gate-queue"] == pytest.approx(5.0)
    assert seg["lock-wait"] == pytest.approx(10.0)
    # root self-time 25 minus the two synthetic gaps
    assert seg["other"] == pytest.approx(10.0)
    # exclusive attribution reconstructs the root exactly
    assert sum(seg.values()) == pytest.approx(record["totalMs"])
    assert record["coverage"] == pytest.approx(0.9)
    assert record["dominant"] == "solve"


def test_decompose_skips_non_request_and_virtual_traces():
    assert decompose(_span("reconcile", 0.05)) is None
    other_path = _span("http.request", 0.05, tags={"path": "/metrics"})
    assert decompose(other_path) is None
    # traces whose clock never advanced: no measurable duration
    assert decompose(_request_trace(total_s=0.0)) is None
    # a bare predicate trace (no HTTP wrapper) still decomposes
    bare = _span("predicate", 0.05, children=[_span("binpack", 0.03)])
    assert decompose(bare) is not None


# span names the random trees draw from: every classified name, the
# port's own unclassified spans under predicate, and the non-request roots
_NAMES = sorted(port_cp.SPAN_SEGMENTS) + [
    "deltasolve.lookup", "deltasolve.scale", "deltasolve.cold_build", "deltasolve.load",
    "kernel:fifo_queue", "fast_path.snapshot", "fast_path.earlier_drivers", "tensorize.scale",
]


def _random_trace(rng, depth=0):
    """A span tree from ``rng``: durations in ms drawn so children may
    overrun their parent (the decomposition clamps self-time at 0)."""
    if depth == 0:
        root_name = ["http.request", "http.request", "predicate", "reconcile"][int(rng.integers(0, 4))]
        tags = {}
        if root_name == "http.request":
            tags["path"] = "/predicates" if rng.random() < 0.85 else "/metrics"
            if rng.random() < 0.6:
                tags["gateWaitMs"] = round(float(rng.uniform(0, 4)), 4)
            if rng.random() < 0.6:
                tags["lockWaitMs"] = round(float(rng.uniform(0, 6)), 4)
        if rng.random() < 0.5:
            tags["outcome"] = ["success", "failure-fit"][int(rng.integers(0, 2))]
        duration = 0.0 if rng.random() < 0.1 else float(rng.uniform(5, 80)) / 1000.0
        span = _span(root_name, duration, tags)
    else:
        span = _span(_NAMES[int(rng.integers(0, len(_NAMES)))], float(rng.uniform(0, 20)) / 1000.0)
    if depth < 3:
        span.children = [_random_trace(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    span.trace_id = f"t{int(rng.integers(0, 1 << 30))}"
    return span


@pytest.mark.parametrize("seed", range(6))
def test_decompose_equals_the_reference_on_seeded_trees(seed):
    rng = np.random.default_rng(seed)
    decomposed = 0
    for _ in range(60):
        root = _random_trace(rng)
        ours, theirs = decompose(root), jax_cp.decompose(root)
        assert ours == theirs
        decomposed += ours is not None
    assert decomposed >= 20


def test_analyzer_ring_summary_and_metrics():
    registry = MetricsRegistry()
    analyzer = CriticalPathAnalyzer(metrics=registry, capacity=4)
    for _ in range(10):
        analyzer.on_trace(_request_trace())
    analyzer.on_trace(_span("reconcile", 0.05))  # ignored

    assert len(analyzer.recent()) == 4  # ring bound
    assert analyzer.recent(limit=2) == analyzer.recent()[:2]
    summary = analyzer.summary()
    assert summary["requests"] == 10 and summary["window"] == 4
    assert set(summary["segments"]) == set(SEGMENT_NAMES)
    assert summary["segments"]["solve"]["p50Ms"] == pytest.approx(50.0)
    assert summary["totalMs"]["p99"] == pytest.approx(100.0)
    assert summary["dominant"] == {"solve": 10}

    hist = registry.get_histogram(M.CRITICALPATH_SEGMENT_TIME, {M.TAG_SEGMENT: "solve"})
    assert hist["count"] == 10
    assert registry.get_histogram(M.CRITICALPATH_COVERAGE)["count"] == 10


@pytest.mark.parametrize("seed", range(3))
def test_analyzer_equals_the_reference_on_seeded_traces(seed):
    rng = np.random.default_rng(100 + seed)
    ours = CriticalPathAnalyzer(capacity=16)
    theirs = jax_cp.CriticalPathAnalyzer(capacity=16)
    for _ in range(50):
        root = _random_trace(rng)
        ours.on_trace(root)
        theirs.on_trace(root)
    assert ours.summary() == theirs.summary()
    assert ours.recent(limit=5) == theirs.recent(limit=5)


def test_span_segment_table_matches_the_reference_and_the_port():
    """The same segment table as the reference, and every classified
    span name is one the port opens (the concurrent engine's
    ``speculation.solve`` too, since the port has the engine)."""
    assert port_cp.SPAN_SEGMENTS == jax_cp.SPAN_SEGMENTS
    assert port_cp.SEGMENT_NAMES == jax_cp.SEGMENT_NAMES
    source = []
    for root, _, names in os.walk(os.path.join(REPO, "k8s_spark_scheduler_tpu_torch")):
        for n in names:
            if n.endswith(".py") and "contention" not in root:
                with open(os.path.join(root, n)) as f:
                    source.append(f.read())
    source = "\n".join(source)
    opened = [name for name in port_cp.SPAN_SEGMENTS if re.search(rf'"{re.escape(name)}"', source)]
    assert sorted(set(port_cp.SPAN_SEGMENTS) - set(opened)) == []
    assert len(opened) == 12


def test_analyzer_observer_never_breaks_requests():
    """A tracer observer raising must not propagate into the request
    path (spans.py swallows observer exceptions)."""
    from k8s_spark_scheduler_tpu_torch.tracing.spans import Tracer

    tracer = Tracer(metrics=None)
    seen = []

    def bad_observer(root):
        seen.append(root.name)
        raise RuntimeError("observer bug")

    tracer.add_observer(bad_observer)
    # a span with no active parent opens a new root trace; closing it
    # fires the observers
    with tracer.span("http.request", {"path": "/predicates"}):
        pass
    assert seen == ["http.request"]
    assert len(tracer.traces()) == 1  # trace still landed in the ring


# -- the Twin, with contention on for both sides ------------------------------

REST_AND_FAKES = {"RestAPIServer", "_KindWatch", "RestClient", "TokenBucket", "FakeKubeAPI", "FakeAutoscaler"}


def test_twin_contention_bodies_agree():
    """Both servers on the reference's defaults, contention included:
    the decisions stay byte-equal (Twin.schedule), both
    /debug/criticalpath bodies have the same keys and request count, and
    both /debug/contention bodies name the same locks for the guarded
    classes both packages have."""
    twin = Twin("tpu-batch")
    try:
        assert twin.jax.server.criticalpath is not None and twin.port.server.criticalpath is not None
        for i, zone in enumerate(("zone1", "zone1", "zone2")):
            twin.add_node(f"n{i}", cpu="16", memory="32Gi", zone=zone)
        names = ["n0", "n1", "n2"]
        filters = 0
        for app in ("app-a", "app-b"):
            for pod in twin.static_pods(app, 2, age=60.0):
                assert twin.schedule(pod, names)
                filters += 1
        big = twin.static_pods("app-big", 80, age=30.0)[0]
        assert twin.schedule(big, names) is None
        filters += 1

        (js, jbody), (ps, pbody) = twin.get("/debug/criticalpath?limit=50")
        assert js == ps == 200
        assert set(pbody) == set(jbody) and set(pbody["segments"]) == set(jbody["segments"])
        assert pbody["requests"] == jbody["requests"] == filters
        assert [set(r) for r in pbody["recent"]] == [set(r) for r in jbody["recent"]]
        assert [r["outcome"] for r in pbody["recent"]] == [r["outcome"] for r in jbody["recent"]]

        gc.collect()  # instances left by earlier tests in this process
        (js, jbody), (ps, pbody) = twin.get("/debug/contention")
        assert js == ps == 200 and set(pbody) == set(jbody)
        # the guarded classes both packages have (not the tests' own),
        # less those only the REST backend and the fakes build (an
        # earlier test in the process may have left one alive on one
        # side)
        def classes(registry, package):
            return {cls.__name__ for cls in registry() if cls.__module__.startswith(package + ".")}

        both = (classes(jax_guarded.registry, "k8s_spark_scheduler_tpu")
                & classes(port_guarded.registry, "k8s_spark_scheduler_tpu_torch")) - REST_AND_FAKES

        def served(body):
            return {
                e["name"] for e in body["locks"]
                if e["name"] == "extender.predicate" or e["name"].split(".")[0] in both
            }

        # each keeper lists every lock of its package in the process;
        # the locks this twin's two servers built are the ones both list
        ours, theirs = served(pbody), served(jbody)
        assert {"extender.predicate", "ObjectStore._lock", "ChangeFeed._lock", "Tracer._lock",
                "CriticalPathAnalyzer._lock", "DeltaSolveEngine._lock"} <= ours
        assert ours == theirs, (sorted(ours - theirs), sorted(theirs - ours))
    finally:
        twin.close()
