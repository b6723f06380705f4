"""The port's whole-queue solve (``k8s_spark_scheduler_tpu_torch.ops.
queue_kernel``) against the JAX package: the plain PyTorch version on the
CPU must equal ``pallas_solve_queue`` (interpret mode) and
``batch_solver.solve_queue`` exactly, for tightly-pack and
distribute-evenly.  The CUDA kernel itself is held against the plain
version on the card (``cuda`` marker; skipped without a GPU)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.ops.batch_solver import solve_queue as jax_solve_queue
from k8s_spark_scheduler_tpu.ops.pallas_queue import pallas_solve_queue
from k8s_spark_scheduler_tpu.ops.sparkapp import AppDemand as JaxAppDemand
from k8s_spark_scheduler_tpu.ops.tensorize import (
    scale_problem,
    tensorize_apps,
    tensorize_cluster,
)
from k8s_spark_scheduler_tpu.types.resources import NodeSchedulingMetadata, Resources
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
from k8s_spark_scheduler_tpu_torch.ops.batch_solver import node_capacity

from test_batch_parity import orders_for, random_app, random_cluster

BIG = 2**31 - 1


def random_queue(rng, n, a):
    """A raw queue: negative availability, ranks a permutation with
    non-candidates at BIG, zero-requirement dims, k = 0, invalid apps."""
    avail = rng.randint(-4, 40, size=(n, 3)).astype(np.int32)
    avail[rng.rand(n) < 0.3, 2] = 0
    rank = rng.permutation(n).astype(np.int32)
    rank[rng.rand(n) < 0.3] = BIG
    exec_ok = rng.rand(n) < 0.85
    drivers = rng.randint(0, 4, size=(a, 3)).astype(np.int32)
    executors = rng.randint(0, 9, size=(a, 3)).astype(np.int32)
    executors[rng.rand(a) < 0.15] = 0
    counts = rng.randint(0, 30, size=a).astype(np.int32)
    valid = rng.rand(a) < 0.85
    return avail, rank, exec_ok, drivers, executors, counts, valid


def jax_reference(arrays, evenly):
    args = tuple(jnp.asarray(x) for x in arrays)
    pallas = pallas_solve_queue(*args, evenly=evenly, interpret=True)
    scan = jax_solve_queue(*args, evenly=evenly, with_placements=False)
    return (
        tuple(np.asarray(x) for x in pallas),
        (np.asarray(scan.feasible), np.asarray(scan.driver_idx), np.asarray(scan.avail_after)),
    )


def port_plain(arrays, evenly):
    out = qk.fifo_queue(*(torch.as_tensor(x) for x in arrays), evenly=evenly)
    return tuple(x.numpy() for x in out)


def assert_same(got, want, label):
    names = ("feasible", "driver_idx", "avail_after")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, f"{label}: {name} shape {g.shape} vs {w.shape}"
        assert (g == w).all(), f"{label}: {name} differs"


@pytest.mark.parametrize("n", [2, 5, 31, 64, 127, 128, 129, 200, 300])
@pytest.mark.parametrize("evenly", [False, True])
def test_plain_queue_matches_pallas_and_scan(n, evenly):
    rng = np.random.RandomState(1000 + n)
    for trial in range(2):
        arrays = random_queue(rng, n, 12)
        got = port_plain(arrays, evenly)
        pallas, scan = jax_reference(arrays, evenly)
        assert_same(got, pallas, f"n={n} trial {trial} vs pallas")
        assert_same(got, scan, f"n={n} trial {trial} vs solve_queue")
        assert got[0].dtype == np.bool_ and got[1].dtype == got[2].dtype == np.int32


def _metadata(**nodes):
    return {
        name: NodeSchedulingMetadata(available=avail, schedulable=Resources.of(8, "8Gi"))
        for name, avail in nodes.items()
    }


def _edge_problems():
    one = _metadata(a=Resources.of(1, "1Gi"))
    neg = _metadata(neg=Resources.of(4, "4Gi").sub(Resources.of(8, "8Gi")), ok=Resources.of(4, "4Gi"))
    neg_zero_dim = {
        "n1": NodeSchedulingMetadata(
            available=Resources.of("4", "1Gi"), schedulable=Resources.of(64, "64Gi")
        ),
        "n0": NodeSchedulingMetadata(
            available=Resources.of("-1", "8Gi"), schedulable=Resources.of(64, "64Gi")
        ),
    }
    drv = Resources.of(1, "1Gi")
    return {
        "zero_executor_gang": (one, ["a"], [JaxAppDemand(drv, Resources.of(1, "1Gi"), 0)]),
        "zero_resource_executors": (one, ["a"], [JaxAppDemand(drv, Resources.zero(), 5)]),
        "negative_availability": (neg, ["neg", "ok"], [JaxAppDemand(drv, Resources.of(1, "1Gi"), 2)] * 3),
        "negative_availability_zero_requirement_dim": (
            neg_zero_dim,
            ["n1", "n0"],
            [JaxAppDemand(Resources.of(1, "512Mi"), Resources.of(0, "1Gi"), 4),
             JaxAppDemand(Resources.of(1, "512Mi"), Resources.of(0, "1Gi"), 1)],
        ),
    }


@pytest.mark.parametrize("case", sorted(_edge_problems()))
@pytest.mark.parametrize("evenly", [False, True])
def test_plain_queue_edge_cases(case, evenly):
    metadata, order, apps = _edge_problems()[case]
    problem = scale_problem(tensorize_cluster(metadata, order, order), tensorize_apps(apps))
    assert problem.ok
    arrays = (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver,
              problem.executor, problem.count, problem.app_valid)
    got = port_plain(arrays, evenly)
    pallas, scan = jax_reference(arrays, evenly)
    assert_same(got, pallas, f"{case} vs pallas")
    assert_same(got, scan, f"{case} vs solve_queue")
    # padded apps are invalid: infeasible, driver index N, nothing subtracted
    assert not got[0][len(apps):].any()
    assert (got[1][len(apps):] == problem.avail.shape[0]).all()


@pytest.mark.parametrize("evenly", [False, True])
def test_plain_queue_on_tensorized_snapshots(evenly):
    rng = random.Random(77 + evenly)
    for trial in range(4):
        metadata = random_cluster(rng, rng.randint(2, 40))
        apps = [random_app(rng) for _ in range(rng.randint(1, 20))]
        driver_order, executor_order = orders_for(metadata, rng)
        problem = scale_problem(
            tensorize_cluster(metadata, driver_order, executor_order), tensorize_apps(apps)
        )
        assert problem.ok
        arrays = (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver,
                  problem.executor, problem.count, problem.app_valid)
        pallas, scan = jax_reference(arrays, evenly)
        got = port_plain(arrays, evenly)
        assert_same(got, pallas, f"trial {trial} vs pallas")
        assert_same(got, scan, f"trial {trial} vs solve_queue")


def test_all_infeasible_queue_leaves_availability():
    rng = np.random.RandomState(5)
    arrays = list(random_queue(rng, 50, 8))
    arrays[1] = np.full(50, BIG, dtype=np.int32)  # no driver candidates
    feasible, didx, avail_after = port_plain(arrays, evenly=False)
    assert not feasible.any() and (didx == 50).all()
    assert (avail_after == arrays[0]).all()


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    qk.reset_launch_counts()
    arrays = tuple(torch.as_tensor(x) for x in random_queue(np.random.RandomState(3), 40, 6))
    for evenly in (False, True):
        got = qk.fifo_queue(*arrays, evenly=evenly)
        want = qk.solve_queue_plain(*arrays, evenly=evenly)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert set(qk.launch_counts.values()) == {0}


def test_wrapper_refuses_other_devices():
    arrays = [torch.as_tensor(x).to("meta") for x in random_queue(np.random.RandomState(4), 8, 2)]
    with pytest.raises(ValueError):
        qk.fifo_queue(*arrays)


def random_queue_large(rng, n, a):
    """random_queue with values near the int32 range, as GCD-scaled
    quantities reach it: availabilities near 2^31 - 1 (some anywhere in
    int32), large, odd and power-of-two requests, large drivers, and some
    gangs of up to 2^31 - 1 executors, so capacity sums and prefixes wrap."""
    _, rank, exec_ok, _, _, _, valid = random_queue(rng, n, a)
    avail = BIG - rng.randint(0, 2**16, size=(n, 3)).astype(np.int64)
    spread = rng.rand(n, 3) < 0.3
    avail[spread] = rng.randint(-(2**31), BIG, size=int(spread.sum()))
    choices = np.array([1, 2, 3, 7, 2**16, 2**20, 2**30, BIG, BIG - 1, 12345677, 1000003])
    executors = np.where(rng.rand(a, 3) < 0.5, rng.choice(choices, size=(a, 3)),
                         rng.randint(1, BIG, size=(a, 3)))
    executors[rng.rand(a, 3) < 0.1] = 0
    drivers = rng.randint(0, 2**30, size=(a, 3))
    counts = np.where(rng.rand(a) < 0.3, rng.randint(0, BIG, size=a), rng.randint(0, 40, size=a))
    return (avail.astype(np.int32), rank, exec_ok, drivers.astype(np.int32),
            executors.astype(np.int32), counts.astype(np.int32), valid)


# -- the kernel's integer division: a multiply-high by a per-app divisor ------


def device_divisor(req):
    """csrc/queue_kernel.cu make_divisor, step by step in Python integers:
    (mul, shift) with shift -1 for a zero request."""
    if req == 0:
        return 0, -1
    d = req if req > 1 else 1  # max(req, 1)
    l = (d - 1).bit_length()  # 32 - __clz(d - 1): ceil(log2 d)
    return ((1 << (32 + l)) + d - 1) // d % 2**32, l  # the cast to 32 bits


def device_quot(avail, divisor):
    """csrc/queue_kernel.cu dim_quot on numpy int64 arrays: 0 for a
    negative availability, BIG for a zero request, else
    (umulhi(n, mul) + n) >> shift in uint32 arithmetic."""
    mul, shift = divisor
    n = np.asarray(avail, dtype=np.int64)
    if shift < 0:
        return np.where(n < 0, 0, BIG)
    un = np.where(n < 0, 0, n).astype(np.uint64)
    hi = (un * np.uint64(mul)) >> np.uint64(32)
    q = ((hi + un) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)
    return np.where(n < 0, 0, q.astype(np.int64))


DIV_REQUESTS = sorted({1, 2, 3, 5, 7, 9, 10, 1000, 12345, 1000003, 12345677, BIG - 1, BIG}
                      | {2**j for j in range(31)} | {2**j - 1 for j in range(2, 31)}
                      | {2**j + 1 for j in range(1, 31)})


@pytest.mark.parametrize("group", ["edges", "random"])
def test_device_division_equals_truncating_division(group):
    rng = np.random.RandomState(11)
    reqs = DIV_REQUESTS if group == "edges" else [int(x) for x in rng.randint(1, BIG, size=3000)]
    for req in reqs:
        ns = np.array([0, 1, req - 1, req, req + 1, 2 * req - 1, 2 * req, 2**30, BIG - 1, BIG,
                       BIG // req * req, BIG // req * req - 1], dtype=np.int64)
        ns = np.concatenate([ns, rng.randint(0, 2**31, size=64)])
        ns = ns[(ns >= 0) & (ns <= BIG)]
        got = device_quot(ns, device_divisor(req))
        assert (got == ns // req).all(), f"req={req}: {ns[got != ns // req][:5]}"
        assert 0 <= device_divisor(req)[0] < 2**32


def test_device_division_small_divisors_exhaustive():
    ns = np.concatenate([np.arange(0, 1 << 16), BIG - np.arange(0, 1 << 12)]).astype(np.int64)
    for req in range(1, 1025):
        assert (device_quot(ns, device_divisor(req)) == ns // req).all(), req


def test_device_capacity_equals_plain_capacity():
    """A node's capacity from device_quot equals the plain one
    (batch_solver.node_capacity: torch's floor division), zero and
    negative requests, negative availabilities and k = 0 included."""
    rng = np.random.RandomState(12)
    for trial in range(60):
        n = 400
        avail = rng.randint(-(2**31), BIG, size=(n, 3)).astype(np.int64)
        avail[: n // 2] = rng.randint(-50, 5000, size=(n // 2, 3))
        ex = rng.choice([0, -3, 1, 2, 3, 7, 64, 2**20, BIG, int(rng.randint(1, BIG))], size=3)
        k = int(rng.choice([0, 5, 40, 2**20, BIG]))
        q = [device_quot(avail[:, d], device_divisor(int(ex[d]))) for d in range(3)]
        got = np.minimum(np.minimum(np.minimum(q[0], q[1]), q[2]), k)
        want = node_capacity(torch.as_tensor(avail.astype(np.int32)),
                             torch.as_tensor(ex.astype(np.int32)), k)
        assert (got == want.numpy()).all(), f"trial {trial}: requests {ex}, k {k}"


# -- the kernel's two-exchange formulation ------------------------------------


def _wrap(x):
    """int64 values wrapped to int32, as the reference's int32 arrays wrap."""
    return (np.asarray(x, dtype=np.int64) + 2**31) % 2**32 - 2**31


def two_exchange_queue(arrays, evenly, seen=None):
    """The whole-queue solve as csrc/queue_kernel.cu formulates it, app by
    app in numpy: capacities with the device's division, the total S and
    the exclusive prefix P of x (x = cap, or cap > 0 for evenly) from one
    pass, the (rank, node) minimum driver d with its x'_d - x_d, then the
    fill from P'_i = P_i + [i > d] (x'_d - x_d) with no second prefix.
    `seen` (a set) collects the cases the queue exercised."""
    avail, rank, exec_ok, drivers, executors, counts, valid = (np.asarray(x) for x in arrays)
    n = avail.shape[0]
    carry = avail.astype(np.int64)
    node = np.arange(n)
    feasible, driver_idx = [], []
    seen = set() if seen is None else seen

    def caps(av, divs, k):
        q = [device_quot(av[:, d], divs[d]) for d in range(3)]
        return np.where(exec_ok, np.minimum(np.minimum(np.minimum(q[0], q[1]), q[2]), k), 0)

    for a in range(drivers.shape[0]):
        dr, ex, k = drivers[a].astype(np.int64), executors[a].astype(np.int64), int(counts[a])
        if not valid[a]:
            seen.add("invalid app")
            feasible.append(False)
            driver_idx.append(n)
            continue
        divs = [device_divisor(int(e)) for e in ex]
        cap = caps(carry, divs, k)
        x = (cap > 0).astype(np.int64) if evenly else cap
        total = int(_wrap(cap.sum()))
        prefix = _wrap(np.cumsum(x) - x)
        fits = (rank < BIG) & (carry >= dr).all(axis=1)
        cap_d = caps(_wrap(carry - dr), divs, k)
        cand = fits & (_wrap(_wrap(total - cap) + cap_d) >= k)
        if not cand.any():
            feasible.append(False)
            driver_idx.append(n)
            continue
        d = int(node[cand][np.lexsort((node[cand], rank[cand]))[0]])
        x_d = int(cap_d[d] > 0) if evenly else int(cap_d[d])
        delta = int(_wrap(x_d - x[d]))
        prefix_after = _wrap(prefix + np.where(node > d, delta, 0))
        cap_after = cap.copy()
        cap_after[d] = cap_d[d]
        if evenly:
            filled = (cap_after > 0) & (prefix_after < k)
        else:
            filled = (cap_after > 0) & (_wrap(k - prefix_after) > 0)
        usage = np.where(filled[:, None], ex, np.where((node == d)[:, None], dr, 0))
        carry = _wrap(carry - usage)
        feasible.append(True)
        driver_idx.append(d)
        seen.update(
            name for name, hit in (
                ("driver on the first node", d == 0),
                ("driver on the last node", d == n - 1),
                ("driver's node loses all capacity", cap_d[d] == 0 < cap[d]),
                ("k = 0", k == 0),
                ("zero-resource executors", not ex.any()),
                ("prefix wraps", (np.cumsum(x) > BIG).any()),
            ) if hit
        )
    return (np.array(feasible, dtype=bool), np.array(driver_idx, dtype=np.int32),
            carry.astype(np.int32))


def _two_exchange_cases():
    """Queues built so that every case of the formulation occurs."""
    rng = np.random.RandomState(21)
    cases = {}
    # node 0 the best-ranked candidate
    arrays = list(random_queue(rng, 40, 10))
    arrays[1] = np.arange(40, dtype=np.int32)
    arrays[0][0] = 60
    cases["driver on the first node"] = arrays
    # only the last node is a candidate
    arrays = list(random_queue(rng, 40, 10))
    arrays[1] = np.full(40, BIG, dtype=np.int32)
    arrays[1][-1] = 3
    arrays[0][-1] = 200
    cases["driver on the last node"] = arrays
    # node 0, the only candidate, holds one driver and one executor exactly;
    # the gang fits on the nodes after it
    n = 12
    avail = np.full((n, 3), 8, dtype=np.int32)
    avail[0] = (2, 2, 0)
    rank = np.full(n, BIG, dtype=np.int32)
    rank[0] = 0
    apps = 4
    cases["driver's node loses all capacity"] = [
        avail, rank, np.ones(n, dtype=bool), np.tile(np.int32([1, 1, 0]), (apps, 1)),
        np.tile(np.int32([2, 2, 0]), (apps, 1)), np.full(apps, 5, dtype=np.int32),
        np.ones(apps, dtype=bool)]
    # k = 0, zero-resource executors and invalid apps in one queue
    arrays = list(random_queue(rng, 30, 12))
    arrays[5][:4] = 0
    arrays[4][4:8] = 0
    arrays[6][8:] = False
    arrays[6][:8] = True
    cases["k = 0, zero-resource executors, invalid apps"] = arrays
    # five nodes of capacity k = 2^30 + 1: S wraps to 2^30 + 5 >= k, and the
    # tightly prefix wraps past 2^31, so int32 arithmetic fills node 3 too
    n, apps = 5, 2
    cases["prefix wraps"] = [
        np.full((n, 3), BIG, dtype=np.int32), np.arange(n, dtype=np.int32), np.ones(n, dtype=bool),
        np.ones((apps, 3), dtype=np.int32), np.ones((apps, 3), dtype=np.int32),
        np.full(apps, 2**30 + 1, dtype=np.int32), np.ones(apps, dtype=bool)]
    return cases


def _check_two_exchange(arrays, evenly, label, seen):
    got = two_exchange_queue(arrays, evenly, seen)
    plain = port_plain(arrays, evenly)
    pallas, _ = jax_reference(arrays, evenly)
    assert_same(got, plain, f"{label} vs solve_queue_plain")
    assert_same(got, pallas, f"{label} vs pallas")


@pytest.mark.parametrize("evenly", [False, True])
def test_two_exchange_formulation_on_edge_queues(evenly):
    seen = set()
    for label, arrays in _two_exchange_cases().items():
        _check_two_exchange(arrays, evenly, label, seen)
    want = {"driver on the first node", "driver on the last node",
            "driver's node loses all capacity", "k = 0", "zero-resource executors", "invalid app"}
    if not evenly:
        want.add("prefix wraps")
    assert want <= seen, f"not exercised: {want - seen}"


@pytest.mark.parametrize("n", [3, 64, 129, 300])
@pytest.mark.parametrize("evenly", [False, True])
def test_two_exchange_formulation_on_random_queues(n, evenly):
    rng = np.random.RandomState(3000 + n)
    seen = set()
    for trial in range(2):
        _check_two_exchange(random_queue(rng, n, 16), evenly, f"n={n} trial {trial}", seen)
    _check_two_exchange(random_queue_large(rng, n, 16), evenly, f"n={n} large values", seen)


@pytest.mark.cuda
@pytest.mark.parametrize("n,a", [(2, 5), (7, 20), (129, 64), (4099, 64), (12345, 16), (10240, 1024),
                                 (100000, 32)])
def test_cuda_kernel_matches_plain(n, a):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the queue kernel has no CPU mode")
    arrays = tuple(
        torch.as_tensor(x, device="cuda") for x in random_queue(np.random.RandomState(n), n, a)
    )
    for evenly in (False, True):
        before = dict(qk.launch_counts)
        got = qk.fifo_queue(*arrays, evenly=evenly)
        want = qk.solve_queue_plain(*arrays, evenly=evenly)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"n={n} a={a} evenly={evenly}"
        name = "fifo_queue_evenly" if evenly else "fifo_queue_tightly"
        assert qk.launch_counts[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,a", [(7, 20), (3000, 128), (100000, 16)])
def test_cuda_kernel_matches_plain_at_large_values(n, a):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the queue kernel has no CPU mode")
    arrays = tuple(
        torch.as_tensor(x, device="cuda") for x in random_queue_large(np.random.RandomState(n), n, a)
    )
    for evenly in (False, True):
        got = qk.fifo_queue(*arrays, evenly=evenly)
        want = qk.solve_queue_plain(*arrays, evenly=evenly)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"n={n} a={a} evenly={evenly}"
