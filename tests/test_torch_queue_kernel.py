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
    assert qk.launch_counts == {"fifo_queue_tightly": 0, "fifo_queue_evenly": 0}


def test_wrapper_refuses_other_devices():
    arrays = [torch.as_tensor(x).to("meta") for x in random_queue(np.random.RandomState(4), 8, 2)]
    with pytest.raises(ValueError):
        qk.fifo_queue(*arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("n,a", [(2, 5), (129, 64), (4099, 64), (12345, 16), (10240, 1024)])
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
