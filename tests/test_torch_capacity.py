"""The port's capacity observatory (``capacity/``), case for case the
reference's tests/test_capacity.py, and the port against the reference:

- probe/solver AGREEMENT: every gang the headroom search calls feasible
  is admitted by the port's own FIFO pass (``fifo_session.
  solve_packed_cold``: the queue kernels' plain versions at queue
  position 0) on the same state, and headroom + 1 is refused, across
  tightly-pack, distribute-evenly and minimal-fragmentation — and the
  search's headroom, usable capacity and per-shape probe counts equal
  the JAX package's (its native lane where it builds, its numpy twin);
- the fragmentation report against the JAX package's, both lanes;
- the ChangeFeed-triggered sampler on the port's harness (``device=
  "cpu"``): sequence gating, the ring, diffs, the predicate-lock
  refusal, forecasts, truncation, the departure-rate window, concurrent
  samples, the label-cardinality caps, the registry-series canary, the
  feed's wakeup, and the waste reporter's virtual-clock cleanup.

The reference's simulator case (``test_capacity.py:572``) waits for the
simulator's port (ROADMAP A.7).  The server-level Twin sequence over
``/state/capacity``, ``/slo`` and ``/lifecycle`` is in
tests/test_torch_lifecycle.py.
"""

import concurrent.futures
import threading

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.capacity.probe import frag_report as jax_frag_report
from k8s_spark_scheduler_tpu.capacity.probe import probe_headroom as jax_probe_headroom
from k8s_spark_scheduler_tpu.capacity.probe import probe_headroom_numpy as jax_probe_headroom_numpy
from k8s_spark_scheduler_tpu.native.fifo import native_probe_available, probe_headroom_native
from k8s_spark_scheduler_tpu_torch import capacity as cap_pkg
from k8s_spark_scheduler_tpu_torch import timesource
from k8s_spark_scheduler_tpu_torch.capacity import CapacitySampler
from k8s_spark_scheduler_tpu_torch.capacity.probe import (
    DEFAULT_K_MAX,
    caps_unclamped,
    frag_segments,
    probe_segments,
)
from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
from k8s_spark_scheduler_tpu_torch.metrics.registry import MetricsRegistry
from k8s_spark_scheduler_tpu_torch.ops.fifo_session import solve_packed_cold
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

POLICIES = (0, 1, 2)  # tightly-pack, distribute-evenly, min-frag


def _t(x):
    return torch.as_tensor(np.asarray(x))


def probe_headroom(avail, rank, exec_ok, shapes, k_max=DEFAULT_K_MAX):
    """(headroom [S], usable [S, 3], probes [S]) over all rows: one
    segment, unit multiplicities, a rank below 2^31 - 1 marks a driver
    candidate (the reference's ``probe_headroom`` less its lane)."""
    n = avail.shape[0]
    out = probe_segments(
        avail, torch.ones(n, dtype=torch.int64), exec_ok, rank.to(torch.int64) < 2**31 - 1, [0, n], shapes, k_max
    )
    return tuple(x[0] for x in out)


def frag_report(avail, exec_ok):
    """The reference's ``frag_report`` over all rows: one segment, unit
    multiplicities."""
    n = avail.shape[0]
    return tuple(x[0] for x in frag_segments(avail, torch.ones(n, dtype=torch.int64), exec_ok, [0, n]))


def _random_problem(seed, n=400, n_shapes=6):
    rng = np.random.RandomState(seed)
    avail = rng.randint(-5, 300, size=(n, 3)).astype(np.int32)
    rank = np.arange(n, dtype=np.int32)
    rng.shuffle(rank)
    # some nodes are driver-only / executor-ineligible
    rank[rng.rand(n) < 0.2] = 2**31 - 1
    exec_ok = rng.rand(n) > 0.15
    shapes = np.hstack(
        [rng.randint(0, 5, size=(n_shapes, 3)), rng.randint(1, 7, size=(n_shapes, 3))]
    ).astype(np.int32)
    return avail, rank, exec_ok, shapes


@pytest.mark.parametrize("seed", range(5))
def test_probe_solver_agreement_5_seeds_x_3_policies(seed):
    """For each seed × 3 policies, every (shape, count ≤ probed headroom)
    gang admits and every (shape, headroom+1) gang is refused by the
    port's FIFO pass on the same snapshot; the search equals the JAX
    package's, probe counts included."""
    K = 100_000
    avail, rank, exec_ok, shapes = _random_problem(20260804 + seed)
    headroom, usable, probes = probe_headroom(_t(avail), _t(rank), _t(exec_ok), _t(shapes), K)
    want = jax_probe_headroom(avail.astype(np.int64), rank, exec_ok, shapes.astype(np.int64), K)
    for got, ref in zip((headroom, usable, probes), want[:3]):
        np.testing.assert_array_equal(got.numpy(), ref)
    headroom = headroom.numpy()
    rng = np.random.RandomState(seed)
    for policy in POLICIES:
        for s in range(shapes.shape[0]):
            h = int(headroom[s])
            checks = []
            if h > 0:
                checks.append((h, True))
                checks.append((rng.randint(1, h + 1), True))
            if h < K:
                checks.append((h + 1, False))
            if h == 0:
                checks.append((1, False))
            for k, expect in checks:
                app = np.concatenate([shapes[s], [k, 1]]).astype(np.int32).reshape(1, 8)
                feasible, _, _ = solve_packed_cold(policy, avail, rank, exec_ok, app, device="cpu")
                assert bool(feasible[0]) == expect, (seed, policy, s, k, h, expect)
    # bisection cost stays a handful of solves per shape
    assert int(probes.max()) <= 2 + int(np.ceil(np.log2(K))) + 1


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_probe_matches_the_reference_twin_and_native(seed):
    """One program on the device against both of the reference's lanes
    (the numpy twin, and the native lane where its toolchain builds)."""
    avail, rank, exec_ok, shapes = _random_problem(seed, n=200)
    got = probe_headroom(_t(avail.astype(np.int64)), _t(rank), _t(exec_ok), _t(shapes.astype(np.int64)), 50_000)
    twin = jax_probe_headroom_numpy(avail.astype(np.int64), rank, exec_ok, shapes.astype(np.int64), 50_000)
    lanes = [twin]
    if native_probe_available():
        lanes.append(probe_headroom_native(avail, rank, exec_ok, shapes, 50_000))
    for ref in lanes:
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_array_equal(got[1].numpy(), ref[1])
        np.testing.assert_array_equal(got[2].numpy(), ref[2])


def test_probe_dispatcher_scales_base_units():
    """The probe runs on base-unit int64 rows (milli-cpu / bytes):
    headroom is exact and usable comes back in base units."""
    avail = np.array([[8000, 8 << 30, 0], [8000, 8 << 30, 0]], dtype=np.int64)
    rank = np.zeros(2, dtype=np.int64)
    exec_ok = np.ones(2, dtype=bool)
    # driver 1cpu/1Gi, executor 1cpu/1Gi
    shapes = np.array([[1000, 1 << 30, 0, 1000, 1 << 30, 0]], dtype=np.int64)
    headroom, usable, probes = probe_headroom(_t(avail), _t(rank), _t(exec_ok), _t(shapes), DEFAULT_K_MAX)
    # 16 executor slots total, driver consumes one slot's worth on its
    # node: the solver admits at most 15 executors alongside the driver
    assert int(headroom[0]) == 15
    assert int(usable[0][0]) == 16000  # base milli-cpu reachable
    want = jax_probe_headroom(avail, rank, exec_ok, shapes, DEFAULT_K_MAX)
    assert (int(headroom[0]), usable[0].tolist(), int(probes[0])) == (
        int(want[0][0]), want[1][0].tolist(), int(want[2][0])
    )
    # no rows: no headroom and no probe, as the reference's "empty" lane
    empty = probe_headroom(_t(avail[:0]), _t(rank[:0]), _t(exec_ok[:0]), _t(shapes))
    assert [x.tolist() for x in empty] == [[0], [[0, 0, 0]], [0]]


@pytest.mark.parametrize("seed", range(4))
def test_caps_unclamped_matches_the_reference(seed):
    """The per-node capacity, negative (overdrawn) values included, for a
    single executor row and for all shapes at once."""
    from k8s_spark_scheduler_tpu.capacity.probe import caps_unclamped as jax_caps_unclamped

    rng = np.random.RandomState(seed)
    avail = rng.randint(-50, 300, size=(64, 3)).astype(np.int64)
    exec_ok = rng.rand(64) > 0.2
    executors = rng.randint(0, 4, size=(8, 3)).astype(np.int64)  # zero dimensions included
    batched = caps_unclamped(_t(avail), _t(exec_ok), _t(executors)).numpy()
    for s, e in enumerate(executors):
        want = jax_caps_unclamped(avail, exec_ok, e)
        np.testing.assert_array_equal(caps_unclamped(_t(avail), _t(exec_ok), _t(e)).numpy(), want)
        np.testing.assert_array_equal(batched[s], want)


def test_frag_report_matches_both_reference_lanes():
    """frag_report's one program equals the JAX package's dispatcher
    (native lane on GCD-scaled int32 rows where it builds) and its numpy
    twin on base-unit int64 rows."""
    rng = np.random.RandomState(7)
    for _ in range(5):
        n = 50
        avail = rng.randint(-3, 40, size=(n, 3)).astype(np.int64) * (1 << 28)
        mask = rng.rand(n) > 0.2
        got = frag_report(_t(avail), _t(mask))
        for a, b in zip(got, jax_frag_report(avail, mask)):
            np.testing.assert_array_equal(a.numpy(), b)
        rows = avail[mask]
        pos = np.maximum(rows, 0)
        np.testing.assert_array_equal(got[0].numpy(), pos.sum(axis=0))
        np.testing.assert_array_equal(got[1].numpy(), pos.max(axis=0))
        np.testing.assert_array_equal(got[2].numpy(), (rows > 0).sum(axis=0))
        np.testing.assert_array_equal(got[3].numpy(), (rows < 0).sum(axis=0))


def test_frag_report_math():
    avail = np.array([[10, 100, 0], [5, 50, 0], [-3, 0, 0]], dtype=np.int64)
    exec_ok = np.array([True, True, True])
    total, largest, free_nodes, overdrawn, frag = frag_report(_t(avail), _t(exec_ok))
    assert total.tolist() == [15, 150, 0]
    assert largest.tolist() == [10, 100, 0]
    assert free_nodes.tolist() == [2, 2, 0]
    assert overdrawn.tolist() == [1, 0, 0]
    assert float(frag[0]) == pytest.approx(1.0 - 10 / 15)
    assert float(frag[2]) == 0.0
    # ineligible rows don't count
    total2, _, _, _, _ = frag_report(_t(avail), _t(np.array([True, False, True])))
    assert total2.tolist() == [10, 100, 0]
    # nothing eligible: zeros
    empty = frag_report(_t(avail), _t(np.zeros(3, dtype=bool)))
    assert [x.tolist() for x in empty] == [[0, 0, 0]] * 4 + [[0.0, 0.0, 0.0]]


# -- sampler ------------------------------------------------------------------


def _harness(**kw) -> Harness:
    return Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu", **kw)


def test_sampler_seq_gating_ring_bounds_and_diff():
    h = _harness()
    try:
        h.server.capacity.stop()  # drive sampling explicitly
        sampler = CapacitySampler(
            h.server.tensor_snapshot,
            pod_lister=h.server.pod_lister,
            waste_reporter=h.server.waste_reporter,
            metrics=h.server.metrics,
            instance_group_label=h.server.install.instance_group_label,
            ring_size=4,
            device="cpu",
        )
        h.new_node("n1", zone="z1")
        h.new_node("n2", zone="z2")
        first = sampler.maybe_sample(trigger="t")
        assert first is not None and first.nodes == 2
        # unchanged feed → O(1) skip
        assert sampler.maybe_sample(trigger="t") is None
        assert sampler.stats()["skipped_unchanged"] == 1
        # two zones → two (group, zone) combos with their own frag
        assert len(first.groups) == 2
        # ring stays bounded under node churn
        for i in range(10):
            h.new_node(f"extra-{i}", zone="z1")
            sampler.maybe_sample(trigger="churn")
        assert sampler.stats()["ring"] <= 4
        history = sampler.history(limit=2)
        assert len(history) == 2
        # newest first
        assert history[0].seq >= history[1].seq
        # diff across a node-structure change
        d = sampler.diff(history[1].seq, history[0].seq)
        assert d is not None and d["structureChanged"] is True
        assert d["nodes"] == history[0].nodes - history[1].nodes
        # unknown seqs → None
        assert sampler.diff(-1, history[0].seq) is None
        assert sampler.stats()["class_lane_failures"] == 0
    finally:
        h.close()


def _fleet_snapshot(rng, n, seq, structure, relabel=0):
    """A snapshot of ``n`` nodes in base units: availability from a small
    menu (so classes compress) and at random, negative values included;
    unready, unschedulable and zoneless nodes; 6 instance groups (one
    the empty label) over 3 zones, more (group, zone) combos than the
    samplers keep; ``relabel`` nodes moved to another group."""
    from types import SimpleNamespace

    menu = np.array([[16000, 64 << 30, 0], [8000, 32 << 30, 1000], [-1500, 4 << 30, 0],
                     [4000, -(1 << 30), 0], [31500, 120 << 30, 2000], [0, 0, 0]], dtype=np.int64)
    avail = menu[rng.randint(0, len(menu), size=n)]
    wild = rng.rand(n) < 0.5
    avail[wild] = np.stack([rng.randint(-2000, 40000, size=n), rng.randint(-2, 96, size=n).astype(np.int64) << 30,
                            rng.choice([0, 0, 1000, -1000], size=n)], axis=1)[wild]
    groups = rng.choice(["g0", "g1", "g2", "g3", "g4", ""], size=n)
    if relabel:
        groups[:relabel] = "g-moved"
    labels = [{"resource_channel": g} if g else {} for g in groups]
    return SimpleNamespace(
        names=[f"n{i:04d}" for i in range(n)],
        avail=avail,
        allocatable=rng.randint(0, 64000, size=(n, 3)).astype(np.int64),
        usage=rng.randint(-100, 20000, size=(n, 3)).astype(np.int64),
        zone_names=["z-a", "z-b", "z-c"],
        zone_id=rng.choice([-1, 0, 1, 2], size=n, p=[0.05, 0.35, 0.35, 0.25]).astype(np.int32),
        ready=rng.rand(n) > 0.1,
        unschedulable=rng.rand(n) < 0.05,
        labels=labels,
        content_key=(7, seq),
        structure_key=(7, structure),
    )


@pytest.mark.parametrize("seed", (11, 12, 13))
def test_sampler_matches_the_reference_sampler_on_a_seeded_fleet(seed):
    """The port's whole sample against the JAX package's sampler on the
    same snapshots and queue, a few hundred nodes: cluster, per-(group,
    zone) and class-lane frag and headroom over many uneven segments,
    the max-group-zones cut, tenants, the shape cap, the queue cap and
    the forecast's departure rate; three samples (a first, one on
    changed availability with the same structure, one after a relabel
    changes the structure).  Left out: sampleMs and classes.expandMs
    (host-clock cost) and probeLane (where the probes ran)."""
    from types import SimpleNamespace

    from k8s_spark_scheduler_tpu import timesource as jax_timesource
    from k8s_spark_scheduler_tpu.capacity.observatory import CapacitySampler as JaxCapacitySampler

    rng = np.random.RandomState(seed)
    n = int(rng.randint(250, 400))
    snaps = [_fleet_snapshot(rng, n, 100, 1), _fleet_snapshot(rng, n, 101, 1),
             _fleet_snapshot(rng, n, 102, 2, relabel=int(rng.randint(5, 40)))]
    for snap in snaps[1:]:  # one fleet: the node table of the first sample
        snap.names, snap.zone_id, snap.ready, snap.unschedulable = (
            snaps[0].names, snaps[0].zone_id, snaps[0].ready, snaps[0].unschedulable)
    snaps[1].labels = snaps[0].labels
    shapes = [((int(rng.choice([500, 1000, 2000])), int(rng.choice([1, 2, 4])) << 30, 0),
               (int(rng.choice([1000, 2000, 4000])), int(rng.choice([2, 4, 8])) << 30, int(rng.choice([0, 0, 1000]))))
              for _ in range(9)]
    pods, rows = [], {}
    for i in range(16):
        pod = SimpleNamespace(name=f"d{i:02d}", namespace="ns", creation_timestamp=1000.0 + i)
        pods.append(pod)
        shape = shapes[int(rng.randint(0, len(shapes)))]
        rows[pod.name] = None if i % 7 == 3 else (shape[0], shape[1], int(rng.randint(1, 40)))
    queues = [pods, pods[3:], pods[3:]]  # three gangs leave between the first two samples

    def sampler(cls, **kw):
        current = {"i": 0}
        s = cls(SimpleNamespace(snapshot=lambda: snaps[current["i"]]), instance_group_label="resource_channel",
                max_shapes=6, max_group_zones=8, max_queue=10, **kw)
        s._pending_drivers = lambda: list(queues[current["i"]])
        s._gang_rows = lambda pod: rows[pod.name]
        return s, current

    port, port_at = sampler(CapacitySampler, device="cpu")
    ref, ref_at = sampler(JaxCapacitySampler)
    clock = {"t": 5000.0}
    timesource.set_source(lambda: clock["t"])
    jax_timesource.set_source(lambda: clock["t"])
    try:
        for i in range(len(snaps)):
            port_at["i"] = ref_at["i"] = i
            got, want = port.sample_now().to_dict(), ref.sample_now().to_dict()
            for body in (got, want):
                del body["sampleMs"], body["probeLane"]
                body["classes"].pop("expandMs")
            assert got == want, i
            assert got["groupsDropped"] > 0 and got["shapesDropped"] > 0 and got["queueTruncated"] > 0
            clock["t"] += 30.0
        assert any(e.get("forecastSeconds") for e in got["queue"])  # the departure rate reached the forecast
        assert port.stats()["class_lane_failures"] == 0
    finally:
        timesource.reset()
        jax_timesource.reset()


def test_sampler_refuses_to_probe_under_predicate_lock():
    """The sampler runs ZERO probes while the extender lock is held — an
    in-lock invocation is refused and counted, never served."""
    h = Harness(device="cpu")
    try:
        h.new_node("n1")
        sampler = h.server.capacity
        sampler.stop()
        cap_pkg.enter_predicate_lock()
        try:
            assert sampler.sample_now(trigger="in-lock") is None
        finally:
            cap_pkg.exit_predicate_lock()
        assert sampler.lock_violations == 1
        # off-lock sampling works again immediately
        assert sampler.sample_now(trigger="off-lock") is not None
        assert sampler.lock_violations == 1
    finally:
        h.close()


def test_sampler_lock_flag_is_set_during_predicates():
    """The extender actually marks lock tenure: a probe attempted from
    inside a Filter decision must hit the refusal path."""
    h = Harness(device="cpu")
    seen = []
    try:
        h.new_node("n1")
        h.new_node("n2")
        sampler = h.server.capacity
        sampler.stop()
        extender = h.server.extender
        original = extender._predicate_locked

        def probing_predicate(args):
            seen.append(cap_pkg.in_predicate_lock())
            assert sampler.sample_now(trigger="inside") is None
            return original(args)

        extender._predicate_locked = probing_predicate
        driver = h.static_allocation_spark_pods("app-lockflag", 1)[0]
        h.assert_success(h.schedule(driver, ["n1", "n2"]))
        assert seen == [True]
        assert sampler.lock_violations >= 1
        assert not cap_pkg.in_predicate_lock()
    finally:
        h.close()


def test_sampler_queue_forecast_states_and_pressure():
    h = _harness()
    try:
        sampler = h.server.capacity
        sampler.stop()
        h.new_node("n1", cpu="8", memory="8Gi")
        h.new_node("n2", cpu="8", memory="8Gi")

        # a gang that cannot fit (32 cpu of executors on a 16-cpu
        # cluster) stays pending and creates a demand
        big = h.static_allocation_spark_pods("app-big", 8, executor_cpu="4", executor_mem="1Gi")[0]
        result = h.schedule(big, ["n1", "n2"])
        assert result.failed_nodes
        sample = sampler.sample_now(trigger="test")
        assert sample is not None
        assert sample.queued_gangs == 1
        assert sample.pressure == 1
        (entry,) = sample.queue
        assert entry["pod"] == big.name
        assert entry["state"] == "needs-scaleup"
        assert entry["fitsNow"] is False
        assert entry["forecastSeconds"] is None
        assert entry["gangSize"] == 8
        assert entry["headroom"] < 8
        # the waste reporter has seen the failed attempt + demand
        assert entry.get("demandState") in ("demand-pending", "demand-fulfilled", "no-demand")

        # a fitting gang forecasts admission
        small = h.static_allocation_spark_pods("app-small", 1)[0]
        h.create_pod(small)
        sample2 = sampler.sample_now(trigger="test2")
        by_pod = {e["pod"]: e for e in sample2.queue}
        assert by_pod[small.name]["fitsNow"] is True
        assert by_pod[small.name]["state"] in ("admitting-next", "queued-behind")
        # no admissions observed yet: a queued-behind wait is UNKNOWN
        # (null), never 0.0 — only admitting-next forecasts 0.0
        if by_pod[small.name]["state"] == "queued-behind":
            assert by_pod[small.name]["forecastSeconds"] is None
        assert sample2.pressure == 1  # still only the big gang
    finally:
        h.close()


def test_sampler_queue_truncation_is_counted():
    """Pending drivers beyond max_queue are dropped from the forecast
    list but counted (queueTruncated), never silently — and pressure
    still covers ALL pending gangs, not just the emitted entries."""
    h = _harness()
    try:
        h.server.capacity.stop()
        sampler = CapacitySampler(
            h.server.tensor_snapshot,
            pod_lister=h.server.pod_lister,
            instance_group_label=h.server.install.instance_group_label,
            max_queue=2,
            device="cpu",
        )
        h.new_node("n1", cpu="8", memory="8Gi")
        for i in range(5):
            # 16-cpu executors can never fit the 8-cpu node: all five
            # gangs are backlog
            h.create_pod(h.static_allocation_spark_pods(f"app-q{i}", 1, executor_cpu="16")[0])
        sample = sampler.sample_now(trigger="test")
        assert sample.queued_gangs == 5
        assert len(sample.queue) == 2
        assert sample.queue_truncated == 3
        assert sample.to_dict()["queueTruncated"] == 3
        # the autoscaler-facing signal must NOT cap at max_queue
        assert sample.pressure == 5
    finally:
        h.close()


def test_forecast_rate_spans_the_departure_interval():
    """The admission rate divides departures by the inter-sample
    interval they happened in, not by the instant since they were
    observed — a single departure batch must not make every queued gang
    forecast ~0 seconds."""
    h = _harness()
    t = [1000.0]
    timesource.set_source(lambda: t[0])
    try:
        h.server.capacity.stop()
        sampler = CapacitySampler(
            h.server.tensor_snapshot,
            pod_lister=h.server.pod_lister,
            instance_group_label=h.server.install.instance_group_label,
            device="cpu",
        )
        h.new_node("n1", cpu="32", memory="64Gi")
        first = h.static_allocation_spark_pods("app-r0", 1)[0]
        h.create_pod(first)
        pods = [h.static_allocation_spark_pods(f"app-r{i}", 1)[0] for i in range(1, 4)]
        for p in pods:
            h.create_pod(p)
        sampler.sample_now(trigger="t0")  # anchors the interval at t=1000

        # one gang departs over a 50s interval...
        t[0] = 1050.0
        h.delete_pod(first)
        sample = sampler.sample_now(trigger="t1")
        by_pos = {e["queuePosition"]: e for e in sample.queue}
        # ...so rate = 1/50 gangs/s and position 1 forecasts ~50s — an
        # observation-time anchoring would have given ~0s
        f = by_pos[1]["forecastSeconds"]
        assert f is not None and f >= 25.0, sample.queue
    finally:
        timesource.reset()
        h.close()


def test_concurrent_samples_keep_ring_ordered():
    """An HTTP freshen racing the background thread must not interleave
    ring appends: whole samples are serialized, so seqs stay
    nondecreasing and newest-last."""
    h = _harness()
    try:
        sampler = h.server.capacity
        sampler.stop()
        h.new_node("n0")

        def churn_and_sample(i):
            h.new_node(f"cc-{i}")
            return sampler.sample_now(trigger=f"t{i}")

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            list(ex.map(churn_and_sample, range(8)))
        seqs = [s.seq for s in sampler.timeline()]
        assert seqs == sorted(seqs)
        assert len(seqs) == len(set(seqs))
    finally:
        h.close()


def test_capacity_label_cardinality_budget():
    """The per-(instance-group, zone, shape) capacity labels stay under
    a configured budget — the sampler truncates (and counts) instead of
    exploding the registry."""
    h = _harness()
    try:
        h.server.capacity.stop()
        metrics = MetricsRegistry()
        sampler = CapacitySampler(
            h.server.tensor_snapshot,
            pod_lister=h.server.pod_lister,
            metrics=metrics,
            instance_group_label="zone-group",
            max_shapes=4,
            max_group_zones=6,
            device="cpu",
        )
        # 12 distinct (group, zone) combos, 6 queued gang shapes
        for i in range(12):
            h.new_node(f"n{i:02d}", zone=f"z{i % 12}", cpu="32", memory="64Gi")
        for i in range(6):
            pod = h.static_allocation_spark_pods(f"app-shape-{i}", 1, executor_cpu=str(i + 1))[0]
            h.create_pod(pod)
        sample = sampler.sample_now(trigger="test")
        assert sample.groups_dropped == 6
        assert sample.shapes_dropped >= 1
        assert len(sample.groups) == 6
        assert len(sample.headroom) <= 4
        series = metrics.series_stats()
        budget = (6 + 1) * 4  # (combos + cluster-wide) × shapes
        assert series.get(mnames.CAPACITY_HEADROOM, 0) <= budget
        # fragmentation gauges are per-dim only — never per group
        assert series.get(mnames.CAPACITY_FRAGMENTATION, 0) == 3

        # shapes churn: once the queue drains, the next sample PRUNES
        # the vanished (shape, group, zone) series instead of exporting
        # their last values forever
        for pod in list(h.api.list("Pod")):
            h.delete_pod(pod)
        sample2 = sampler.sample_now(trigger="drained")
        assert len(sample2.headroom) == 1  # the default canary shape
        series2 = metrics.series_stats()
        assert series2.get(mnames.CAPACITY_HEADROOM, 0) == 1 + len(sample2.groups)
    finally:
        h.close()


def test_registry_series_gauge_reports_cardinality():
    """…tpu.metrics.registry.series reports per-metric label-set
    cardinality (the label-explosion canary)."""
    h = Harness(device="cpu")
    try:
        h.new_node("n1")
        metrics = h.server.metrics
        metrics.counter("foundry.spark.scheduler.requests", {"outcome": "a"})
        metrics.counter("foundry.spark.scheduler.requests", {"outcome": "b"})
        h.server.reporters.report_registry_series()
        g = metrics.get_gauge(mnames.METRICS_REGISTRY_SERIES, {"metric": "foundry.spark.scheduler.requests"})
        assert g is not None and g >= 2
        # the canary never counts itself (it would ratchet forever)
        assert metrics.get_gauge(mnames.METRICS_REGISTRY_SERIES, {"metric": mnames.METRICS_REGISTRY_SERIES}) is None
        # a vanished metric name stops exporting its stale series count
        with metrics._lock:
            for k in [k for k in metrics._counters if k[0] == "foundry.spark.scheduler.requests"]:
                del metrics._counters[k]
        h.server.reporters.report_registry_series()
        assert metrics.get_gauge(mnames.METRICS_REGISTRY_SERIES, {"metric": "foundry.spark.scheduler.requests"}) is None
    finally:
        h.close()


def test_changefeed_wakeup_event_fires_on_publish():
    h = Harness(device="cpu")
    try:
        wake = threading.Event()
        h.server.tensor_snapshot.feed.attach_wakeup(wake)
        assert not wake.is_set()
        h.new_node("n-wake")
        assert wake.wait(timeout=5.0)
    finally:
        h.close()


def test_sampler_runs_on_the_device_it_was_given():
    """The sampler's probes run where the server runs: None is CUDA,
    which raises on a host without it (no move to the CPU)."""
    h = Harness(device="cpu")
    try:
        assert h.server.capacity.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                CapacitySampler(h.server.tensor_snapshot)
        h.new_node("n1")
        assert h.server.capacity.sample_now(trigger="t").probe_lane == "torch"
    finally:
        h.close()


# -- waste phases under the virtual clock --------------------------------------


def test_waste_cleanup_fires_on_virtual_time_not_wall_time():
    """The 6h DEMAND_FULFILLED_AGE_CLEANUP_SECONDS horizon is measured in
    semantic (virtual) time: entries created at virtual t0 survive
    cleanup until the virtual clock passes t0+6h, regardless of wall
    time; ``scheduling_info`` (the forecast's read-out) follows them."""
    from k8s_spark_scheduler_tpu_torch.metrics.waste import (
        DEMAND_FULFILLED_AGE_CLEANUP_SECONDS,
        WasteMetricsReporter,
    )
    from k8s_spark_scheduler_tpu_torch.types.objects import ObjectMeta, Pod

    t = [1_000_000.0]
    timesource.set_source(lambda: t[0])
    try:
        reporter = WasteMetricsReporter(MetricsRegistry(), "zone-group")
        pod = Pod(meta=ObjectMeta(name="w-driver", namespace="ns"))
        reporter.mark_failed_scheduling_attempt(pod, "failure-fit")
        info = reporter.scheduling_info("ns", "w-driver")
        assert info is not None and info["lastFailureOutcome"] == "failure-fit"

        # wall time passes, virtual time doesn't: nothing is cleaned
        reporter.cleanup_metric_cache()
        assert reporter.scheduling_info("ns", "w-driver") is not None

        # just before the virtual horizon: still retained
        t[0] += DEMAND_FULFILLED_AGE_CLEANUP_SECONDS - 1.0
        reporter.cleanup_metric_cache()
        assert reporter.scheduling_info("ns", "w-driver") is not None

        # past the virtual horizon: cleaned
        t[0] += 2.0
        reporter.cleanup_metric_cache()
        assert reporter.scheduling_info("ns", "w-driver") is None
    finally:
        timesource.reset()
