"""Class-compressed stepping in the port (``ops/class_kernel.py``, the
session's class mode in ``ops/fifo_session.py``, the engine's rule in
``ops/deltasolve.py``) against the reference package's native class
solver, case for case tests/test_class_compression.py:

- stateless: the port's ``solve_packed_classes`` against the reference's
  ``solve_packed_classes`` (decisions, planes and all four evidence
  values) and ``solve_packed_cold`` on fleet-shaped inputs with
  near-duplicates and single-node classes, 5 seeds x 3 policies; the
  degenerate partitions (every node unique, every node identical); a
  queue long enough that the overlay outgrows its bound and the
  partition is rebuilt mid-queue;
- sessions: a class-mode port ``FifoSession`` against the reference's
  class-mode ``NativeFifoSession`` on one random delta stream, resume
  positions, decisions, planes and ``class_stats`` equal at every step;
- the engine: at ``classes_min_nodes=0`` its sessions step by class and
  count rebuilds into ``…tpu.classes.rebuild.count``; below the
  threshold ``set_classes(False)`` is called;
- end to end: the port's harness with classes forced on
  (``min_nodes=0``) against class mode off, and against the reference's
  harness: Filter verdicts, FailedNodes messages (which carry the
  explain shortfall) byte-equal.

Here the class kernels run as their plain version, through the same
wrappers, on the CPU.
"""

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.config import ClassesConfig as JaxClassesConfig
from k8s_spark_scheduler_tpu.config import FifoConfig as JaxFifoConfig
from k8s_spark_scheduler_tpu.config import Install as JaxInstall
from k8s_spark_scheduler_tpu.native.fifo import (
    NativeFifoSession,
    native_classes_available,
    native_session_available,
)
from k8s_spark_scheduler_tpu.native.fifo import solve_packed_classes as native_classes
from k8s_spark_scheduler_tpu.native.fifo import solve_packed_cold as native_cold
from k8s_spark_scheduler_tpu.testing.harness import Harness as JaxHarness
from k8s_spark_scheduler_tpu_torch.config import ClassesConfig, FifoConfig, Install
from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
from k8s_spark_scheduler_tpu_torch.ops.fifo_session import FifoSession, solve_packed_classes
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

needs_classes = pytest.mark.skipif(not native_classes_available(), reason="native class solver unavailable")
needs_session = pytest.mark.skipif(not native_session_available(), reason="native session unavailable")

POLICIES = [0, 1, 2]  # tightly-pack, distribute-evenly, minimal fragmentation
SEEDS = [101, 102, 103, 104, 105]


def _fleet(rng, n, n_shapes=12):
    """tests/test_class_compression.py's fleet: repeated machine shapes,
    near-duplicates one unit off, single-node classes."""
    shapes = rng.randint(10, 120, size=(n_shapes, 3)).astype(np.int32)
    avail = shapes[rng.randint(0, n_shapes, size=n)].copy()
    near = rng.choice(n, size=max(1, n // 10), replace=False)
    avail[near, rng.randint(0, 3, size=len(near))] += 1
    singles = rng.choice(n, size=max(1, n // 20), replace=False)
    avail[singles] = rng.randint(1000, 2000, size=(len(singles), 3))
    rank = np.arange(n, dtype=np.int32)
    rng.shuffle(rank)
    eok = rng.rand(n) > 0.1
    return avail, rank, eok


def _queue(rng, a):
    drv = rng.randint(0, 3, size=(a, 3)).astype(np.int32)
    exe = rng.randint(1, 5, size=(a, 3)).astype(np.int32)
    cnt = rng.randint(1, 8, size=a).astype(np.int32)
    return drv, exe, cnt, np.ones(a, dtype=bool)


def _packed(drv, exe, cnt, val):
    return np.hstack([drv, exe, cnt[:, None], val.astype(np.int32)[:, None]]).astype(np.int32)


def _assert_stateless(policy, avail, rank, eok, packed):
    """The port's class pass equals the reference's class pass and its
    row-level cold pass; returns the evidence."""
    got_f, got_d, got_a, got_ev = solve_packed_classes(policy, avail, rank, eok, packed, device="cpu")
    ref_f, ref_d, ref_a, ref_ev = native_classes(policy, avail, rank, eok, packed)
    np.testing.assert_array_equal(got_f, ref_f)
    np.testing.assert_array_equal(got_d, ref_d)
    np.testing.assert_array_equal(got_a.numpy(), ref_a)
    assert got_ev == ref_ev
    cold_f, cold_d, cold_a = native_cold(policy, avail, rank, eok, packed)
    np.testing.assert_array_equal(got_f, cold_f)
    np.testing.assert_array_equal(got_d, cold_d)
    np.testing.assert_array_equal(got_a.numpy(), cold_a)
    return got_ev


# -- stateless -------------------------------------------------------------------


@needs_classes
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_stateless_class_pass_matches_the_reference(policy, seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(300, 900))
    avail, rank, eok = _fleet(rng, n)
    packed = _packed(*_queue(rng, int(rng.randint(20, 120))))
    ev = _assert_stateless(policy, avail, rank, eok, packed)
    assert 1 <= ev["classes_initial"] < n // 2
    assert ev["rebuilds"] == 1


@needs_classes
@pytest.mark.parametrize("policy", POLICIES)
def test_degenerate_partitions_all_unique_and_all_identical(policy):
    rng = np.random.RandomState(7)
    n = 120
    avail = (np.arange(n * 3, dtype=np.int32).reshape(n, 3) % 97) + np.arange(n, dtype=np.int32)[:, None] * 3
    rank = np.arange(n, dtype=np.int32)
    eok = np.ones(n, dtype=bool)
    packed = _packed(*_queue(rng, 30))
    assert _assert_stateless(policy, avail, rank, eok, packed)["classes_initial"] == n
    avail1 = np.full((n, 3), 50, dtype=np.int32)
    assert _assert_stateless(policy, avail1, rank, eok, packed)["classes_initial"] == 1


@needs_classes
@pytest.mark.parametrize("policy", POLICIES)
def test_rebuilds_mid_queue_match_the_reference(policy):
    """Small machine shapes and gangs of up to 11: the queue writes more
    than 512 distinct nodes, so the overlay outgrows its bound and the
    partition is rebuilt from the carried planes mid-queue; odd inputs
    ride along (k = 0, zero requests, invalid apps, non-candidates,
    negative availability)."""
    rng = np.random.RandomState(31 + policy)
    n = 1000
    shapes = rng.randint(8, 14, size=(6, 3)).astype(np.int32)
    avail = shapes[rng.randint(0, 6, size=n)].copy()
    avail[rng.rand(n) < 0.02] = rng.randint(-4, 3, size=3)
    rank = np.arange(n, dtype=np.int32)
    rng.shuffle(rank)
    rank[rng.rand(n) < 0.2] = ck.BIG
    eok = rng.rand(n) > 0.05
    a = 800
    drv, exe, cnt, val = _queue(rng, a)
    cnt = rng.randint(0, 12, size=a).astype(np.int32)
    exe[rng.rand(a, 3) < 0.05] = 0
    val = rng.rand(a) > 0.03
    ev = _assert_stateless(policy, avail, rank, eok, _packed(drv, exe, cnt, val))
    assert ev["rebuilds"] >= 2 and ev["overlay_peak"] > 512


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    n = 16
    avail = torch.full((n, 3), 10, dtype=torch.int32)
    rank = torch.arange(n, dtype=torch.int32)
    eok = torch.ones(n, dtype=torch.bool)
    apps = torch.tensor([[1, 1, 1, 2, 2, 2, 3, 1]], dtype=torch.int32)
    st = ck.ClassState(n, "cpu")
    ck.reset_launch_counts()
    f, d, after = ck.fifo_queue_classes(avail, ck.candidates(rank), eok, apps, st, True)
    want = qk.fifo_queue(avail, rank, eok, apps[:, 0:3], apps[:, 3:6], apps[:, 6].contiguous(), apps[:, 7] != 0)
    assert f.tolist() == want[0].tolist() == [True] and d.tolist() == want[1].tolist()
    assert torch.equal(after, want[2])
    assert sum(ck.launch_counts.values()) == 0  # the plain version counts no launch
    with pytest.raises(ValueError):
        ck.fifo_queue_classes(avail, ck.candidates(rank), eok, apps, ck.ClassState(n + 1, "cpu"), True)


# -- sessions --------------------------------------------------------------------


@needs_session
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_class_session_stream_matches_the_reference(policy, seed):
    """tests/test_class_compression.py's delta stream (pops of the head,
    appends, executor edits, availability churn with a reload) through a
    class-mode port session and a class-mode native session: resume,
    decisions, planes and class_stats equal at every step."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(200, 600))
    avail, rank, eok = _fleet(rng, n)
    drv, exe, cnt, val = _queue(rng, int(rng.randint(10, 40)))
    port = FifoSession(device="cpu")
    ref = NativeFifoSession()
    try:
        assert port.set_classes(True) and ref.set_classes(True)
        assert port.class_stats() == ref.class_stats()
        port.load(avail, rank, eok, policy, stride=8)
        ref.load(avail, rank, eok, policy, stride=8)
        for step in range(10):
            op = rng.randint(0, 5)
            if op == 0 and len(cnt) > 1:
                drv, exe, cnt, val = drv[1:], exe[1:], cnt[1:], val[1:]
            elif op == 1:
                k = int(rng.randint(1, 4))
                drv = np.vstack([drv, rng.randint(0, 3, size=(k, 3))]).astype(np.int32)
                exe = np.vstack([exe, rng.randint(1, 5, size=(k, 3))]).astype(np.int32)
                cnt = np.concatenate([cnt, rng.randint(1, 8, size=k)]).astype(np.int32)
                val = np.concatenate([val, np.ones(k, bool)])
            elif op == 2 and len(cnt) > 0:
                exe[int(rng.randint(0, len(cnt)))] = rng.randint(1, 5, size=3)
            elif op == 3:
                delta = rng.randint(-20, 21, size=(n, 3)).astype(np.int32)
                avail = np.maximum(avail + delta, 0).astype(np.int32)
                port.load(avail, rank, eok, policy, stride=8)
                ref.load(avail, rank, eok, policy, stride=8)
            packed = _packed(drv, exe, cnt, val)
            r0, f0, d0, a0 = ref.solve(packed)
            r1, f1, d1, a1 = port.solve(packed)
            label = f"step {step} op {op}"
            assert r1 == r0, label
            np.testing.assert_array_equal(f1, f0, err_msg=label)
            np.testing.assert_array_equal(d1, d0, err_msg=label)
            np.testing.assert_array_equal(a1.numpy(), a0, err_msg=label)
            assert port.class_stats() == ref.class_stats(), label
        assert port.class_stats()["classes_last"] >= 1
    finally:
        ref.close()


@needs_session
def test_set_classes_resets_the_partition_as_the_reference_does():
    """Class mode toggled mid-stream (the partition is dropped and rebuilt
    on the next class-mode launch), a resubmit with nothing to step and a
    cut back to a checkpoint: class_stats equal the native session's."""
    rng = np.random.RandomState(9)
    n = 300
    avail, rank, eok = _fleet(rng, n)
    packed = _packed(*_queue(rng, 40))
    port = FifoSession(device="cpu")
    ref = NativeFifoSession()
    try:
        for s in (port, ref):
            s.set_classes(True)
            s.load(avail, rank, eok, 0, stride=8)
        steps = [("solve", packed), ("solve", packed), ("classes", False), ("solve", packed[:30]),
                 ("classes", True), ("solve", packed[:30]), ("solve", packed[:20]), ("solve", packed)]
        for i, (what, arg) in enumerate(steps):
            if what == "classes":
                assert port.set_classes(arg) and ref.set_classes(arg)
                continue
            want, got = ref.solve(arg), port.solve(arg)
            assert got[0] == want[0], i
            np.testing.assert_array_equal(got[3].numpy(), want[3])
            assert port.class_stats() == ref.class_stats(), i
    finally:
        ref.close()


# -- the engine ------------------------------------------------------------------


def _port_harness(binpack="tpu-batch", enabled=True, min_nodes=0):
    return Harness(
        device="cpu",
        extra_install=Install(
            fifo=True, fifo_config=FifoConfig(), binpack_algo=binpack,
            instance_group_label="resource_channel",
            classes=ClassesConfig(enabled=enabled, min_nodes=min_nodes),
        ),
    )


def _queued_cluster(h, n_nodes=10, queued=6, t0=1_700_000_000.0):
    names = []
    for i in range(n_nodes):
        h.new_node(f"n{i:02d}", cpu="16" if i % 3 else "9", memory="32Gi")
        names.append(f"n{i:02d}")
    for i in range(queued):
        h.create_pod(h.static_allocation_spark_pods(f"q-{i:02d}", 2 + i % 3, creation_timestamp=t0 - 1000 + i)[0])
    return names


def _jax_harness(binpack="tpu-batch", min_nodes=0):
    return JaxHarness(extra_install=JaxInstall(
        fifo=True, fifo_config=JaxFifoConfig(), binpack_algo=binpack,
        instance_group_label="resource_channel", classes=JaxClassesConfig(enabled=True, min_nodes=min_nodes),
    ))


def _engine_script(h):
    """Queued drivers, two new drivers' Filters; returns the rebuild counter."""
    names = _queued_cluster(h)
    for i in range(2):
        pod = h.static_allocation_spark_pods(f"new-{i}", 2, creation_timestamp=1_700_000_100.0 + i)[0]
        h.schedule(h.create_pod(pod), names)
    return h.server.metrics.get_counter(mnames.CLASSES_REBUILD_COUNT)


def test_engine_steps_by_class_at_min_nodes_and_counts_rebuilds(monkeypatch):
    ref = _jax_harness()
    try:
        want_rebuilds = _engine_script(ref)
    finally:
        ref.close()
    assert want_rebuilds >= 1
    calls = []
    real = FifoSession.set_classes
    monkeypatch.setattr(FifoSession, "set_classes", lambda self, on: calls.append(on) or real(self, on))
    for min_nodes, want in ((0, True), (10**6, False)):
        calls.clear()
        h = _port_harness(min_nodes=min_nodes)
        try:
            rebuilds = _engine_script(h)
            engine = h.extender.delta_engine
            sessions = list(engine._sessions.values())
            assert sessions and all(s.use_classes is want for s in sessions)
            assert calls and all(on is want for on in calls)
            per_session = [s.native.class_stats()["rebuilds"] for s in sessions]
            if want:
                # the reference's count, a reloaded session's earlier rebuilds included
                assert rebuilds == want_rebuilds
                assert min(per_session) >= 1 and [s.last_rebuilds for s in sessions] == per_session
            else:
                assert not rebuilds and per_session == [0] * len(sessions)
        finally:
            h.close()


# -- end to end ------------------------------------------------------------------


def _run_workload(h, queued: bool):
    """tests/test_class_compression.py's workload (one gang that fits, one
    that cannot), optionally behind queued drivers so that the Filters'
    FIFO passes step a queue: every verdict, bound node names and the
    FailedNodes messages."""
    names = []
    for i in range(6):
        h.new_node(f"node-{i}", cpu="8", memory="8Gi", gpu="0")
        names.append(f"node-{i}")
    h.new_node("node-odd", cpu="9", memory="8Gi", gpu="0")
    names.append("node-odd")
    t0 = 1_700_000_000.0
    if queued:
        for i in range(4):
            h.create_pod(h.static_allocation_spark_pods(
                f"q-{i}", 1 + i % 2, executor_cpu="1", executor_mem="1Gi", creation_timestamp=t0 - 100 + i,
            )[0])
    out = {}
    pods = h.static_allocation_spark_pods(
        "app-fit", 4, driver_cpu="1", driver_mem="1Gi", executor_cpu="2", executor_mem="2Gi",
        creation_timestamp=t0,
    )
    r = h.schedule(pods[0], names)
    out["fit_driver"] = list(r.node_names or [])
    out["fit_failed"] = dict(r.failed_nodes or {})
    for p in pods[1:]:
        r = h.schedule(p, names)
        out.setdefault("fit_execs", []).append(list(r.node_names or []))
    pods = h.static_allocation_spark_pods(
        "app-toobig", 64, driver_cpu="1", driver_mem="1Gi", executor_cpu="4", executor_mem="4Gi",
        creation_timestamp=t0 + 1,
    )
    r = h.schedule(pods[0], names)
    out["big_nodes"] = list(r.node_names or [])
    out["big_failed"] = dict(r.failed_nodes or {})
    return out


@pytest.mark.parametrize("binpack,queued", [("tightly-pack", False), ("tpu-batch", True)])
def test_end_to_end_filter_and_failed_nodes_parity(binpack, queued):
    """Classes forced on (min_nodes=0) vs disabled, and the reference's
    harness with classes on: byte-identical Filter output, including the
    FailedNodes map whose messages embed the explain shortfall.  Under
    ``tpu-batch`` behind queued drivers the Filters' FIFO passes step by
    class through the delta-solve session."""
    results = []
    for enabled in (True, False):
        h = _port_harness(binpack=binpack, enabled=enabled)
        try:
            results.append(_run_workload(h, queued))
            if enabled and queued:
                sessions = list(h.extender.delta_engine._sessions.values())
                assert sessions and all(s.use_classes for s in sessions)
                assert sessions[0].native.class_stats()["rebuilds"] >= 1
        finally:
            h.close()
    ref = _jax_harness(binpack=binpack)
    try:
        results.append(_run_workload(ref, queued))
    finally:
        ref.close()
    on, off, want = results
    assert on == off == want
    assert on["fit_driver"] and not on["big_nodes"] and on["big_failed"]
