"""The port's device-resident solver session (``ops/fifo_session.py``)
against the JAX package's ``NativeFifoSession`` (the reference's native
C++ session) on the same random packed-queue streams: appends, a popped
head, one row changed mid-queue, identical resubmits, availability churn
(a reload), and growth past stride × 24, where the stride doubles.  At
every step the port's (resume, feasible, driver_idx, avail_after) equals
the native session's, resume positions included, and equals the port's
own stateless whole-queue pass (``solve_packed_cold``).  Here the session
runs on the CPU: the kernels' plain versions through the same wrappers.
"""

import random

import numpy as np
import pytest

from k8s_spark_scheduler_tpu.native.fifo import NativeFifoSession, native_session_available
from k8s_spark_scheduler_tpu.ops.tensorize import scale_problem, tensorize_apps, tensorize_cluster
from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
from k8s_spark_scheduler_tpu_torch.ops.fifo_session import (
    MAX_CHECKPOINTS,
    FifoSession,
    solve_packed_cold,
)

from test_batch_parity import orders_for, random_app, random_cluster

needs_native = pytest.mark.skipif(not native_session_available(), reason="native session unavailable")


def problem_rows(seed, n_nodes, pool):
    """(basis, driver_rank, exec_ok, rows [pool, 8]) of a snapshot and a
    pool of apps from the shared generators, in the snapshot's units."""
    rng = random.Random(seed)
    metadata = random_cluster(rng, n_nodes)
    apps = [random_app(rng) for _ in range(pool)]
    driver_order, executor_order = orders_for(metadata, rng)
    problem = scale_problem(tensorize_cluster(metadata, driver_order, executor_order), tensorize_apps(apps))
    assert problem.ok
    rows = np.zeros((pool, 8), np.int32)
    rows[:, 0:3] = problem.driver[:pool]
    rows[:, 3:6] = problem.executor[:pool]
    rows[:, 6] = problem.count[:pool]
    rows[:, 7] = 1
    return problem.avail, problem.driver_rank, problem.exec_ok, rows


def assert_same(port, native, label):
    r, f, d, a = port
    nr, nf, nd, na = native
    assert r == nr, f"{label}: resume {r} vs native {nr}"
    assert np.array_equal(f, nf), f"{label}: feasible"
    assert np.array_equal(d, nd), f"{label}: driver_idx"
    assert np.array_equal(a.numpy(), na), f"{label}: avail_after"


def assert_cold(port, policy, basis, rank, eok, queue, label):
    _, f, d, a = port
    cf, cd, ca = solve_packed_cold(policy, basis, rank, eok, queue, device="cpu")
    assert np.array_equal(f, cf) and np.array_equal(d, cd) and np.array_equal(a.numpy(), ca.numpy()), label


@needs_native
@pytest.mark.parametrize("policy", [0, 1, 2])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_session_random_delta_stream_matches_native_session(policy, seed):
    rng = np.random.RandomState(seed)
    basis, rank, eok, pool = problem_rows(seed + 100 * policy, int(rng.randint(30, 120)), 200)
    queue = pool[: int(rng.randint(5, 40))].copy()
    port, native = FifoSession(device="cpu"), NativeFifoSession()
    port.load(basis, rank, eok, policy, stride=8)
    native.load(basis, rank, eok, policy, stride=8)
    try:
        for step in range(14):
            op = rng.randint(0, 5)
            if op == 0 and len(queue) > 1:  # the head was scheduled
                queue = queue[1:]
            elif op == 1:  # arrivals
                k = int(rng.randint(1, 5))
                queue = np.vstack([queue, pool[rng.randint(0, len(pool), size=k)]])
            elif op == 2 and len(queue):  # one app's demand changed mid-queue
                queue = queue.copy()
                queue[rng.randint(0, len(queue))] = pool[rng.randint(0, len(pool))]
            elif op == 3:  # availability churn: both sessions reload
                delta = rng.randint(-3, 4, size=basis.shape).astype(np.int32)
                basis = np.maximum(basis + delta, 0).astype(np.int32)
                port.load(basis, rank, eok, policy, stride=8)
                native.load(basis, rank, eok, policy, stride=8)
            # op == 4: an identical resubmit
            got = port.solve(queue)
            assert_same(got, native.solve(queue), f"step {step} op {op}")
            assert_cold(got, policy, basis, rank, eok, queue, f"step {step} op {op}")
        got = port.solve(queue)
        assert got[0] == len(queue)  # a pure retry resumes past the whole queue
        assert_same(got, native.solve(queue), "retry")
    finally:
        native.close()


@needs_native
@pytest.mark.parametrize("policy", [0, 2])
def test_session_stride_doubling_matches_native_and_stays_bounded(policy):
    """Growth past stride × 24 doubles the stride (twice here) and drops
    the odd checkpoints; resumes after it equal the native session's."""
    basis, rank, eok, pool = problem_rows(7 + policy, 40, 230)
    port, native = FifoSession(device="cpu"), NativeFifoSession()
    port.load(basis, rank, eok, policy, stride=2)
    native.load(basis, rank, eok, policy, stride=2)
    try:
        for na in (20, 60, 130, 230):
            queue = pool[:na]
            got = port.solve(queue)
            assert_same(got, native.solve(queue), f"grow to {na}")
            assert port.checkpoints() == (na - 1) // port.stride <= MAX_CHECKPOINTS
        assert port.stride == 16  # 2 → 4 → 8 → 16 as the queue grew past 48, 96, 192
        changed = pool[:230].copy()
        changed[150] = pool[3]
        got = port.solve(changed)
        assert 0 < got[0] <= 150 and got[0] % port.stride == 0
        assert_same(got, native.solve(changed), "mid-queue change after doubling")
        assert_cold(got, policy, basis, rank, eok, changed, "after doubling")
        nb = basis.shape[0]
        # basis, tail, ranks, eligibility, MAX_CHECKPOINTS checkpoints, the row cache
        assert port.mem_bytes() <= (MAX_CHECKPOINTS + 2) * nb * 12 + nb * 5 + 230 * (32 + 5)
    finally:
        native.close()


@needs_native
def test_session_truncated_queue_resumes_at_a_checkpoint_like_native():
    """A queue cut back to a checkpointed position is served from that
    checkpoint with no pass at all; a cut between checkpoints resumes at
    the one below it."""
    basis, rank, eok, pool = problem_rows(21, 50, 100)
    port, native = FifoSession(device="cpu"), NativeFifoSession()
    port.load(basis, rank, eok, 0, stride=8)
    native.load(basis, rank, eok, 0, stride=8)
    try:
        for queue in (pool[:100], pool[:64], pool[:61], pool[:0], pool[:30]):
            got = port.solve(queue)
            assert_same(got, native.solve(queue), f"cut to {len(queue)}")
            assert_cold(got, 0, basis, rank, eok, queue, f"cut to {len(queue)}")
        got = port.solve(pool[:64])
        assert got[0] == 30  # growth resumes at the tail
        assert_same(got, native.solve(pool[:64]), "grown back")
    finally:
        native.close()


def test_unchanged_queue_runs_no_pass_and_reload_drops_the_cache(monkeypatch):
    basis, rank, eok, pool = problem_rows(3, 30, 40)
    calls = []
    real = qk.solve_queue_plain

    def counted(*args, **kw):
        calls.append(args[3].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(qk, "solve_queue_plain", counted)
    sess = FifoSession(device="cpu")
    sess.load(basis, rank, eok, 1, stride=4)
    first = sess.solve(pool)
    assert first[0] == 0 and calls == [40]
    again = sess.solve(pool)
    assert again[0] == 40 and calls == [40]  # served from the cache: no pass
    assert again[3] is first[3]
    longer = np.vstack([pool, pool[:3]])
    assert sess.solve(longer)[0] == 40 and calls == [40, 3]
    sess.load(basis, rank, eok, 1, stride=4)
    assert sess.solve(pool)[0] == 0 and sess.checkpoints() == 9


def test_session_device_state_and_cpu_launch_counts():
    qk.reset_launch_counts()
    mk.reset_launch_counts()
    basis, rank, eok, pool = problem_rows(5, 20, 30)
    for policy in (0, 1, 2):
        sess = FifoSession(device="cpu")
        sess.load(basis, rank, eok, policy, stride=4)
        _, _, _, after = sess.solve(pool)
        assert after.device.type == "cpu" and sess.basis.device.type == "cpu"
        assert sess.checkpoints() == 7
    assert set(qk.launch_counts.values()) == {0} and set(mk.launch_counts.values()) == {0}
    with pytest.raises(RuntimeError):
        FifoSession(device="cpu").solve(pool)
    with pytest.raises(ValueError):
        FifoSession(device="cpu").load(basis, rank, eok, 0, stride=0)
