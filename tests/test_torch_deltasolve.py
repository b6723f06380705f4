"""The port's delta-solve engine (``ops/deltasolve.py`` with the
device-resident session of ``ops/fifo_session.py``), case for case the
reference's tests/test_deltasolve.py, and the engine against the JAX
package's ``DeltaSolveEngine`` on its native lane (the JAX harness on
the CPU selects it):

- warm == cold: the same scripts and random delta streams through a
  server with the engine and one without give the same decisions, and
  the JAX server with its engine the same again;
- the invalidation rules and their miss reasons (structure churn,
  cancelling content churn and the row compare, scale, failover and
  journal replay), session eviction at MAX_SESSIONS, each held to the
  JAX engine's ``stats()`` counts for the same request stream;
- the warm≠cold parity guard, clean and with a mismatch forced through a
  corrupted session (the flight recorder persists the diverging solve);
- a warm decision is captured, and its bundle replays cold;
- single-AZ names miss ``unsupported`` in both packages;
- a Twin sequence of many Filters of queued drivers between state
  changes, both sides serving warm, bytes equal.

The reference's serde satellites (node-name interning, the uniform
failure buffer) are tests/test_torch_serde.py's.
"""

import time

import numpy as np
import pytest

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.native.fifo import native_session_available
from k8s_spark_scheduler_tpu.testing.harness import Harness as JaxHarness
from k8s_spark_scheduler_tpu_torch import timesource as port_timesource
from k8s_spark_scheduler_tpu_torch.config import Install
from k8s_spark_scheduler_tpu_torch.ops.deltasolve import DeltaSolveEngine
from k8s_spark_scheduler_tpu_torch.state.store import DELTA_NODE_STRUCTURE, DELTA_RESERVATION, ChangeFeed
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

from torch_parity import Twin

needs_native = pytest.mark.skipif(not native_session_available(), reason="native session unavailable")

RANDOM_STREAM_T0 = 1_700_000_000.0

STAT_KEYS = ("warm_hits", "cold_solves", "digest_hits", "misses")


def _stats(h):
    s = h.extender.delta_engine.stats()
    return {k: s[k] for k in STAT_KEYS}


def _port(binpack="tpu-batch", delta_solve=True):
    return Harness(binpack_algo=binpack, is_fifo=True, device="cpu", delta_solve=delta_solve)


def _jax(binpack="tpu-batch", delta_solve=True):
    if delta_solve:
        return JaxHarness(binpack_algo=binpack, is_fifo=True)
    return JaxHarness(extra_install=JaxInstall(fifo=True, binpack_algo=binpack, delta_solve=False))


def _run(make, script):
    h = make()
    try:
        out = script(h)
        stats = _stats(h) if h.extender.delta_engine is not None else None
        full = h.extender.delta_engine.stats() if h.extender.delta_engine is not None else None
        return out, stats, full
    finally:
        h.close()


def _cluster(h, n=8):
    names = []
    for i in range(n):
        nm = f"n{i:02d}"
        h.new_node(nm, cpu="16", memory="32Gi")
        names.append(nm)
    return names


def _queue(h, count, t0):
    for i in range(count):
        h.create_pod(h.static_allocation_spark_pods(f"q-{i:03d}", 2, creation_timestamp=t0 - 1000 + i)[0])


def _wait_released(h, pod):
    rr = h.server.resource_reservation_cache
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rr.get("default", pod.labels.get("spark-app-id", "")) is None:
            return
        time.sleep(0.005)


# -- change feed ---------------------------------------------------------------


def test_change_feed_sequence_and_kinds():
    feed = ChangeFeed(capacity=8)
    assert feed.seq == 0
    s1 = feed.publish(DELTA_RESERVATION, "r1")
    s2 = feed.publish(DELTA_NODE_STRUCTURE, "n1")
    assert (s1, s2) == (1, 2)
    assert feed.kinds_since(0) == {DELTA_RESERVATION, DELTA_NODE_STRUCTURE}
    assert feed.kinds_since(1) == {DELTA_NODE_STRUCTURE}
    assert feed.kinds_since(2) == frozenset()
    for i in range(20):  # overflow the ring
        feed.publish(DELTA_RESERVATION, f"x{i}")
    assert feed.kinds_since(1) is None  # fell off: treat as everything
    assert feed.kinds_since(feed.seq) == frozenset()


def test_snapshot_content_key_tracks_mutations():
    h = _port()
    try:
        h.new_node("n1")
        k0 = h.server.tensor_snapshot.snapshot().content_key
        assert h.server.tensor_snapshot.snapshot().content_key == k0
        h.new_node("n2")
        k1 = h.server.tensor_snapshot.snapshot().content_key
        assert k1 != k0 and k1[0] == k0[0] and k1[1] > k0[1]
    finally:
        h.close()


# -- engine-level: warm hits, invalidation, decision parity --------------------


@needs_native
def test_engine_warm_hits_on_unchanged_state_and_depth_recorded():
    def script(h):
        names = _cluster(h)
        t0 = time.time()
        _queue(h, 12, t0)
        big = h.static_allocation_spark_pods("big", 500, creation_timestamp=t0)[0]
        h.create_pod(big)
        return [tuple(h.schedule(big, names).node_names or ()) for _ in range(3)]

    out, stats, full = _run(_port, script)
    jout, jstats, _ = _run(_jax, script)
    assert out == jout == [()] * 3  # failures create demands, never reservations
    assert stats == jstats
    assert full["cold_solves"] == 1 and full["warm_hits"] == 2
    assert full["resume_depth_p50"] == 12.0  # whole queue served from cache
    assert full["sessions"] == 1 and full["session_bytes"] > 0


def _cancelling_churn(h):
    names = _cluster(h)
    t0 = time.time()
    _queue(h, 10, t0)
    out = []
    for i in range(3):
        p = h.static_allocation_spark_pods(f"probe-{i}", 2, creation_timestamp=t0 + i)[0]
        h.create_pod(p)
        out.append(tuple(h.schedule(p, names).node_names or ()))
        h.api.delete("Pod", "default", p.name)
        _wait_released(h, p)
    return out


@needs_native
def test_engine_memcmp_rescue_after_cancelling_churn():
    """A reservation created then released bumps the change feed but
    restores the exact availability basis: the class digest (or, with
    classes off, the row compare) rescues the warm path."""
    out, stats, _ = _run(_port, _cancelling_churn)
    jout, jstats, _ = _run(_jax, _cancelling_churn)
    assert out == jout and all(out)
    assert stats == jstats
    assert stats["cold_solves"] == 1 and stats["warm_hits"] == 2


@needs_native
def test_engine_row_compare_tier_when_the_digest_tier_is_off():
    def script(h):
        h.extender.delta_engine.classes_enabled = False
        return _cancelling_churn(h)

    out, stats, _ = _run(_port, script)
    jout, jstats, _ = _run(_jax, script)
    assert out == jout and stats == jstats
    assert stats["cold_solves"] == 1 and stats["warm_hits"] == 2 and stats["digest_hits"] == 0


def _structure_churn(h):
    names = _cluster(h)
    out = []
    t0 = time.time()
    _queue(h, 8, t0)
    p1 = h.static_allocation_spark_pods("s-a", 2, creation_timestamp=t0)[0]
    h.create_pod(p1)
    out.append(tuple(h.schedule(p1, names).node_names or ()))
    node = h.api.get("Node", "default", names[0])
    node.unschedulable = True
    h.api.update(node)
    p2 = h.static_allocation_spark_pods("s-b", 2, creation_timestamp=t0 + 1)[0]
    h.create_pod(p2)
    out.append(tuple(h.schedule(p2, names).node_names or ()))
    node = h.api.get("Node", "default", names[0])
    node.unschedulable = False
    h.api.update(node)
    p3 = h.static_allocation_spark_pods("s-c", 2, creation_timestamp=t0 + 2)[0]
    h.create_pod(p3)
    out.append(tuple(h.schedule(p3, names).node_names or ()))
    return out


@needs_native
def test_engine_structure_churn_misses_session_but_decisions_match():
    """Cordoning a node changes the structure revision: the session key
    misses (cold rebuild), and decisions equal an engine-less run of the
    identical script and the JAX engine's."""
    on, stats, _ = _run(_port, _structure_churn)
    off, none, _ = _run(lambda: _port(delta_solve=False), _structure_churn)
    jon, jstats, _ = _run(_jax, _structure_churn)
    assert none is None
    assert on == off == jon and all(on)
    assert stats == jstats
    # every cordon/uncordon forced a fresh session build
    assert stats["cold_solves"] >= 3


def test_engine_invalidates_across_failover_and_journal_replay():
    """A new instance (failover) starts with an empty session map and
    serves decisions; reservation writes replayed into the mirror
    invalidate by content (the feed sequence moves)."""
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

    h = _port()
    try:
        names = _cluster(h, n=4)
        t0 = time.time()
        _queue(h, 6, t0)
        p = h.static_allocation_spark_pods("pre", 2, creation_timestamp=t0)[0]
        h.create_pod(p)
        assert h.schedule(p, names).node_names
        assert h.extender.delta_engine.stats()["sessions"] == 1
        h.server.stop()

        new_server = init_server_with_clients(
            h.api, Install(fifo=True, binpack_algo="tpu-batch"), demand_poll_interval=0.02, device="cpu"
        )
        try:
            engine = new_server.extender.delta_engine
            assert engine is not None and engine.stats()["sessions"] == 0
            probe = Harness.static_allocation_spark_pods("post", 2, creation_timestamp=t0 + 5)[0]
            h.api.create(probe)
            assert new_server.extender.predicate(ExtenderArgs(pod=probe, node_names=names)).node_names
            assert engine.stats()["cold_solves"] >= 1

            # a replayed/external reservation write invalidates by
            # content: the next decision cold-solves against it
            feed_before = new_server.tensor_snapshot.snapshot().content_key
            assert new_server.resource_reservation_cache.get("default", "pre") is not None
            new_server.resource_reservation_cache.delete("default", "pre")
            assert new_server.tensor_snapshot.snapshot().content_key != feed_before
            cold_before = engine.stats()["cold_solves"]
            probe2 = Harness.static_allocation_spark_pods("post2", 2, creation_timestamp=t0 + 6)[0]
            h.api.create(probe2)
            assert new_server.extender.predicate(ExtenderArgs(pod=probe2, node_names=names)).node_names
            assert engine.stats()["cold_solves"] == cold_before + 1
        finally:
            new_server.stop()
    finally:
        try:
            h.close()
        except Exception:
            pass


def _random_stream(seed):
    """The stream's apps are stamped t0 + step while both packages'
    clocks stand still at t0: whether an earlier gang that cannot fit is
    young enough to be skipped (FIFO enforce-after age) then depends on
    the script alone, never on how fast it runs."""

    def script(h):
        rng = np.random.RandomState(seed)
        decisions = []
        names = _cluster(h, n=6)
        t0 = RANDOM_STREAM_T0
        _queue(h, int(rng.randint(3, 9)), t0)
        live = []
        for step in range(14):
            op = rng.randint(0, 4)
            if op == 0:  # schedule a fitting app
                p = h.static_allocation_spark_pods(
                    f"a-{seed}-{step}", int(rng.randint(1, 4)), creation_timestamp=t0 + step
                )[0]
                h.create_pod(p)
                r = h.schedule(p, names)
                decisions.append(("s", tuple(r.node_names or ()), len(r.failed_nodes)))
                if r.node_names:
                    live.append(p)
            elif op == 1:  # an impossible gang: failure path
                p = h.static_allocation_spark_pods(f"x-{seed}-{step}", 400, creation_timestamp=t0 + step)[0]
                h.create_pod(p)
                r = h.schedule(p, names)
                decisions.append(("f", tuple(r.node_names or ()), len(r.failed_nodes)))
            elif op == 2 and live:  # app finishes
                p = live.pop(int(rng.randint(0, len(live))))
                h.api.delete("Pod", "default", p.name)
                _wait_released(h, p)
                decisions.append(("d",))
            else:  # cordon flip: structure churn
                node = h.api.get("Node", "default", names[int(rng.randint(0, len(names)))])
                node.unschedulable = not node.unschedulable
                h.api.update(node)
                decisions.append(("c",))
        return decisions

    return script


@needs_native
@pytest.mark.parametrize(
    "binpack,seed",
    [("tpu-batch", s) for s in (101, 102, 103, 104, 105)]
    + [("tpu-batch-distribute-evenly", 106), ("tpu-batch-minimal-fragmentation", 107)],
)
def test_engine_random_stream_decisions_match_engineless_twin(binpack, seed):
    """Seeded random delta streams through the whole extender: schedule
    / fail / delete / cordon interleaved.  The engine-on run makes the
    decisions of the engine-off run, and of the JAX engine's."""
    port_timesource.set_source(lambda: RANDOM_STREAM_T0)
    jax_timesource.set_source(lambda: RANDOM_STREAM_T0)
    try:
        on, stats, _ = _run(lambda: _port(binpack), _random_stream(seed))
        off, _, _ = _run(lambda: _port(binpack, delta_solve=False), _random_stream(seed))
        jon, jstats, _ = _run(lambda: _jax(binpack), _random_stream(seed))
    finally:
        port_timesource.reset()
        jax_timesource.reset()
    assert on == off == jon, f"seed {seed}"
    assert stats == jstats


def _scale_fallback(h):
    names = _cluster(h, n=4)
    t0 = time.time()
    # commensurate queue: whole-Gi memory, whole-cpu rows
    _queue(h, 4, t0)
    # created LAST (t0+10) so it never sits in odd's earlier queue — its
    # failed solve only warms the session
    big = h.static_allocation_spark_pods("bigx", 300, creation_timestamp=t0 + 10)[0]
    h.create_pod(big)
    assert not h.schedule(big, names).node_names  # cold session
    # a current app with 1.5Gi executors: indivisible by the cached
    # Gi-scale — the engine must rescale, not round
    odd = h.static_allocation_spark_pods("odd", 2, executor_mem="1536Mi", creation_timestamp=t0 + 1)[0]
    h.create_pod(odd)
    return tuple(h.schedule(odd, names).node_names or ())


@needs_native
def test_engine_scale_fallback_stays_exact():
    """A warm session whose cached scale can't represent a new demand
    exactly must rebuild (cold), never truncate."""
    on, stats, _ = _run(_port, _scale_fallback)
    off, _, _ = _run(lambda: _port(delta_solve=False), _scale_fallback)
    jon, jstats, _ = _run(_jax, _scale_fallback)
    assert on == off == jon and on
    assert stats == jstats and stats["cold_solves"] >= 2


@needs_native
def test_engine_evicts_the_least_recent_of_five_sessions():
    """Five candidate sets key five sessions; the engine keeps
    MAX_SESSIONS and the evicted one cold-builds again, as the JAX
    engine's does."""

    def script(h):
        names = _cluster(h, n=6)
        t0 = time.time()
        _queue(h, 3, t0)
        big = h.static_allocation_spark_pods("big", 300, creation_timestamp=t0)[0]
        h.create_pod(big)
        out = []
        subsets = [names[i:] for i in range(5)] + [names]
        for subset in subsets:
            out.append(tuple(h.schedule(big, subset).node_names or ()))
        out.append(h.extender.delta_engine.stats()["sessions"])
        return out

    out, stats, full = _run(_port, script)
    jout, jstats, _ = _run(_jax, script)
    assert DeltaSolveEngine.MAX_SESSIONS == 4
    assert out == jout and out[-1] == 4
    assert stats == jstats and stats["cold_solves"] == 6 and stats["warm_hits"] == 0


@needs_native
def test_engine_miss_reasons_match_the_reference():
    """A driver whose affinity shape has no exact key (a node selector
    beside its affinity) misses ``affinity-shape`` and is served cold."""

    def script(h):
        names = _cluster(h, n=4)
        t0 = time.time()
        _queue(h, 2, t0)
        pod = h.static_allocation_spark_pods("sel", 1, creation_timestamp=t0)[0]
        pod.node_selector = {"resource_channel": "batch-medium-priority"}
        h.create_pod(pod)
        return tuple(h.schedule(pod, names).node_names or ())

    out, stats, _ = _run(_port, script)
    jout, jstats, _ = _run(_jax, script)
    assert out == jout and out
    assert stats == jstats and stats["misses"] == {"affinity-shape": 1}


@needs_native
@pytest.mark.parametrize("binpack", ["tpu-batch-single-az", "tpu-batch-single-az-minimal-fragmentation"])
def test_single_az_names_miss_unsupported_on_both_packages(binpack):
    """The engine serves no single-AZ solver, as in the reference: asked
    directly, the port's engine declines with ``unsupported`` (the
    reference's engine is never asked: its extender hands a single-AZ
    solver, which has no tensor lane, to the metadata lane before the
    engine, and so does the port's).  Through the servers, neither engine
    runs a solve, and both packages' metadata lanes agree byte for
    byte."""
    from k8s_spark_scheduler_tpu_torch.ops.sparkapp import AppDemand
    from k8s_spark_scheduler_tpu_torch.types.resources import Resources

    h = _port(binpack)
    try:
        names = _cluster(h, n=3)
        pod = h.static_allocation_spark_pods("az", 1)[0]
        engine = DeltaSolveEngine()
        app = AppDemand(Resources.of("1", "1Gi"), Resources.of("1", "1Gi"), 1)
        served = engine.solve(
            h.server.tensor_snapshot.snapshot(), pod, names, h.extender._node_sorter, [], [], app,
            h.extender.binpacker.queue_solver,
        )
        assert served is None
        assert engine.stats()["misses"] == {"unsupported": 1}
    finally:
        h.close()
    twin = Twin(binpack)
    try:
        names = [f"n{i}" for i in range(4)]
        for i, name in enumerate(names):
            twin.add_node(name, cpu="16", memory="32Gi", zone=f"zone{i % 2}")
        twin.advance(1)
        for j in range(3):
            twin.create_pod(twin.static_pods(f"queued-{j}", 2, age=50 - j)[0])
        big = twin.static_pods("big", 100)[0]
        twin.create_pod(big)
        for _ in range(3):
            assert twin.replay(big, names) is None
        fits = twin.static_pods("fits", 2)[0]
        twin.create_pod(fits)
        assert twin.schedule(fits, names) is not None
        jax_stats, port_stats = twin.delta_stats()
        assert port_stats == jax_stats
        assert port_stats["warm_hits"] == port_stats["cold_solves"] == 0
        twin.assert_state_equal()
    finally:
        twin.close()


# -- parity guard and capture ----------------------------------------------------


def _unschedulable_retries(h, n_retries=3):
    h.new_node("node-0", cpu="16", memory="64Gi", zone="az-a")
    driver = h.static_allocation_spark_pods("app-parity", 1)[0]
    h.create_pod(driver)
    # an unschedulable driver never gets a reservation, so each retry
    # re-runs the queue solve (the idempotent replay would skip it)
    big = h.static_allocation_spark_pods(
        "app-parity-big", 8, driver_cpu="8", executor_cpu="8", driver_mem="32Gi", executor_mem="32Gi",
    )[0]
    h.create_pod(big)
    args = ExtenderArgs(pod=big, node_names=["node-0"])
    return [h.extender.predicate(args) for _ in range(n_retries)]


def test_engine_parity_guard_runs_clean():
    """The warm≠cold guard on a healthy engine: warm hits verify against
    the cold pass and report ok."""
    h = _port()
    try:
        engine = h.server.extender.delta_engine
        calls = {"ok": 0, "bad": 0}
        engine.parity_interval = 1
        engine.parity_hooks = (
            lambda: calls.__setitem__("ok", calls["ok"] + 1),
            lambda d: calls.__setitem__("bad", calls["bad"] + 1),
        )
        _unschedulable_retries(h)
        assert calls["bad"] == 0
        assert calls["ok"] == engine.stats()["warm_hits"] == 2
    finally:
        h.close()


def test_parity_mismatch_through_a_corrupted_session_persists_the_diverging_solve(tmp_path):
    """A session whose cached verdicts were corrupted serves them warm;
    the guard (wired to the provenance tracker, as the server wires it)
    catches the divergence, and the persisted bundle holds the diverging
    solve, whose cold replay disagrees with its recorded verdicts."""
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
    from k8s_spark_scheduler_tpu_torch.provenance.recorder import replay_bundle_file

    h = _port()
    try:
        tracker = h.server.provenance
        tracker.recorder.out_dir = str(tmp_path)
        engine = h.server.extender.delta_engine
        assert engine.parity_hooks == (tracker.on_parity_ok, tracker.on_parity_mismatch)
        engine.parity_interval = 1
        _unschedulable_retries(h, 2)  # cold, then one clean warm check
        assert tracker.parity_mismatches == 0
        (sess,) = list(engine._sessions.values())
        sess.native._didx[:] = sess.native._didx + 1  # corrupt the cached driver indices
        big = h.server.pod_informer.get("default", "app-parity-big-driver")
        h.extender.predicate(ExtenderArgs(pod=big, node_names=["node-0"]))
        assert tracker.parity_mismatches == 1
        metrics = h.server.metrics
        assert metrics.get_counter(mnames.PROVENANCE_PARITY_CHECKS, {"result": "mismatch"}) == 1
        assert metrics.get_counter(mnames.PROVENANCE_PARITY_CHECKS, {"result": "ok"}) == 1
        (path,) = tracker.recorder.persisted_paths
        results = replay_bundle_file(path, device="cpu")
        parity = [r for r in results if r["pod"] == "parity-check"]
        assert parity and not parity[0]["ok"]
        assert any("driver indices" in m for m in parity[0]["mismatches"])
    finally:
        h.close()


def test_warm_decision_is_captured_and_its_bundle_replays_cold(tmp_path):
    from k8s_spark_scheduler_tpu_torch.provenance.recorder import replay_bundle_file

    h = _port()
    try:
        tracker = h.server.provenance
        tracker.recorder.out_dir = str(tmp_path)
        names = _cluster(h, n=4)
        t0 = time.time()
        _queue(h, 5, t0)
        big = h.static_allocation_spark_pods("big", 300, creation_timestamp=t0)[0]
        h.create_pod(big)
        for _ in range(3):
            assert not h.schedule(big, names).node_names
        assert h.extender.delta_engine.stats()["warm_hits"] == 2
        record = tracker.explain(big.name)
        assert record["lane"] == "torch-session" and record["bundleSeq"] is not None
        assert record["shortfall"] is not None
        path = tracker.recorder.persist("test-trigger", "warm capture")
        results = replay_bundle_file(path, device="cpu")
        assert len(results) == 3 and all(r["ok"] for r in results), results
        import json

        with open(path) as f:
            bundles = [json.loads(line) for line in f][1:]
        assert [b["verdicts"]["resume"] for b in bundles] == [0, 5, 5]
        assert {b["lane"] for b in bundles} == {"torch-session"}
    finally:
        h.close()


def test_engine_stats_latest_basis_and_invalidate():
    h = _port()
    try:
        engine = h.extender.delta_engine
        assert engine.latest_basis() is None
        names = _cluster(h, n=3)
        big = h.static_allocation_spark_pods("big", 300)[0]
        h.create_pod(big)
        h.schedule(big, names)
        node_names, avail, exec_ok, rank = engine.latest_basis()
        assert sorted(node_names) == names and avail.shape == (3, 3) and exec_ok.all()
        assert h.server.metrics.get_gauge(
            "foundry.spark.scheduler.tpu.deltasolve.sessions", {}
        ) == 1.0
        engine.invalidate()
        assert engine.stats()["sessions"] == 0 and engine.latest_basis() is None
        h.schedule(big, names)
        assert engine.stats()["cold_solves"] == 2
    finally:
        h.close()


def test_session_lane_spans_tag_the_gate():
    """The Filter's trace shows the spans where delta-solve saves time
    and the gate's lane, warm flag and resume position."""
    h = _port()
    try:
        names = _cluster(h, n=3)
        t0 = time.time()
        _queue(h, 4, t0)
        big = h.static_allocation_spark_pods("big", 300, creation_timestamp=t0)[0]
        h.create_pod(big)
        for _ in range(2):
            h.schedule(big, names)
        trace = next(t["root"] for t in h.server.tracer.traces() if t["root"]["name"] == "predicate")

        def walk(span, out):
            out.append(span)
            for child in span.get("children", ()):
                walk(child, out)
            return out

        spans = {s["name"]: s for s in walk(trace, [])}
        for name in ("fast_path.snapshot", "fast_path.earlier_drivers", "deltasolve.lookup", "deltasolve.scale"):
            assert name in spans, (name, sorted(spans))
        gate = spans["fifo_gate"]["tags"]
        assert gate["lane"] == "torch-session" and gate["warm"] is True and gate["resumeFrom"] == 4
        assert spans["deltasolve.lookup"]["tags"]["tier"] == "content-key"
    finally:
        h.close()


# -- the Twin: many Filters of queued drivers between state changes --------------


@needs_native
@pytest.mark.parametrize("policy", ["tpu-batch", "tpu-batch-distribute-evenly", "tpu-batch-minimal-fragmentation"])
def test_twin_many_filters_between_state_changes_serve_warm_on_both_sides(policy):
    """kube-scheduler retries every pending driver; between two state
    changes both servers see the same queue again and again.  Both
    engines serve those Filters warm (their counts equal), and every
    response is byte-equal."""
    twin = Twin(policy)
    try:
        rng = np.random.RandomState(7)
        names = [f"n{i}" for i in range(6)]
        for i, name in enumerate(names):
            twin.add_node(name, cpu="16", memory="32Gi", zone=f"zone{i % 3}")
        twin.advance(1)
        queue = []
        for j in range(8):
            # gangs of 100-140 cpu against 96: the queue stays pending
            wire = twin.static_pods(f"queued-{j}", int(rng.randint(50, 71)), age=100 - j, executor_cpu="2")[0]
            twin.create_pod(wire)
            queue.append(wire)
        for round_ in range(3):
            # the retry stream of the pending queue, in random order
            for k in rng.permutation(len(queue))[:6]:
                twin.replay(queue[k], names)
            # a state change: one new app, older than the queue, scheduled
            app = twin.static_pods(f"new-{round_}", 1, age=500)[0]
            twin.create_pod(app)
            assert twin.schedule(app, names) is not None
        jax_stats, port_stats = twin.delta_stats()
        assert port_stats == jax_stats
        assert port_stats["warm_hits"] >= 10 and jax_stats["warm_hits"] >= 10
        twin.assert_state_equal()
    finally:
        twin.close()
