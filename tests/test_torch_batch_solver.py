"""The port's host layers and gang-solve programs against the JAX package
on identical snapshots: quantities, node ordering, tensorization and
scaling, capacity and efficiency math, and ``batch_solver``'s
``solve_app`` / ``solve_single`` / ``solve_queue`` (with placements).
Equality is exact.  The JAX side is built with the JAX package's types
and the port's side through ``k8s_spark_scheduler_tpu_torch.convert``."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.ops import batch_solver as jax_bs
from k8s_spark_scheduler_tpu.ops import capacity as jax_capacity
from k8s_spark_scheduler_tpu.ops import efficiency as jax_efficiency
from k8s_spark_scheduler_tpu.ops import tensorize as jax_tensorize
from k8s_spark_scheduler_tpu.ops.nodesort import NodeSorter as JaxNodeSorter
from k8s_spark_scheduler_tpu_torch import convert
from k8s_spark_scheduler_tpu_torch.ops import batch_solver as bs
from k8s_spark_scheduler_tpu_torch.ops import capacity
from k8s_spark_scheduler_tpu_torch.ops import efficiency
from k8s_spark_scheduler_tpu_torch.ops import tensorize
from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter

from test_batch_parity import orders_for, random_app, random_cluster


def _plain(r):
    return (r.cpu.exact, r.memory.exact, r.nvidia_gpu.exact)


def port_metadata(jax_metadata):
    """The JAX package's NodeGroupSchedulingMetadata in the port's types
    (exact Fractions carried through plain values)."""
    return {
        name: convert.metadata_from_plain(
            available=_plain(md.available),
            schedulable=_plain(md.schedulable),
            zone_label=md.zone_label,
            labels=md.all_labels,
            unschedulable=md.unschedulable,
            ready=md.ready,
            creation_timestamp=md.creation_timestamp,
        )
        for name, md in jax_metadata.items()
    }


def port_app(jax_app):
    return convert.app_from_plain(
        _plain(jax_app.driver_resources), _plain(jax_app.executor_resources),
        jax_app.min_executor_count,
    )


def random_snapshot(rng, max_nodes=24, max_apps=10, fractional=False):
    """(jax_metadata, port_metadata, driver_order, executor_order,
    jax_apps, port_apps) from the parity suite's generators."""
    metadata = random_cluster(rng, rng.randint(1, max_nodes), fractional=fractional)
    driver_order, executor_order = orders_for(metadata, rng)
    apps = [random_app(rng) for _ in range(rng.randint(1, max_apps))]
    return (
        metadata, port_metadata(metadata), driver_order, executor_order,
        apps, [port_app(a) for a in apps],
    )


def problem_pair(rng, **kw):
    jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, **kw)
    jp = jax_tensorize.scale_problem(
        jax_tensorize.tensorize_cluster(jmeta, dorder, eorder), jax_tensorize.tensorize_apps(japps)
    )
    pp = tensorize.scale_problem(
        tensorize.tensorize_cluster(pmeta, dorder, eorder), tensorize.tensorize_apps(papps)
    )
    return jp, pp


FIELDS = ("avail", "driver_rank", "exec_ok", "driver", "executor", "count", "app_valid", "scale")


@pytest.mark.parametrize("fractional", [False, True])
def test_tensorize_and_scale_match(fractional):
    rng = random.Random(11 + fractional)
    for trial in range(15):
        jp, pp = problem_pair(rng, fractional=fractional)
        assert jp.ok == pp.ok, f"trial {trial}"
        for f in FIELDS:
            a, b = getattr(jp, f), getattr(pp, f)
            assert a.dtype == b.dtype and (a == b).all(), f"trial {trial}: {f}"
        # the carry-across path gives the same problem
        cp = convert.problem_from_numpy(*(getattr(jp, f) for f in FIELDS), ok=jp.ok)
        for f in FIELDS:
            assert (getattr(cp, f) == getattr(pp, f)).all()


def test_inexact_snapshot_is_not_ok():
    meta = {"a": convert.metadata_from_plain(("100u", "1Gi", 0), ("8", "8Gi", 0))}
    app = convert.app_from_plain(("50u", "1Mi", 0), ("10u", "1Mi", 0), 2)
    pp = tensorize.scale_problem(
        tensorize.tensorize_cluster(meta, ["a"], ["a"]), tensorize.tensorize_apps([app])
    )
    assert not pp.ok


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1024, 1025, 4097, 10000])
def test_bucket_size_matches(n):
    assert tensorize.bucket_size(n) == jax_tensorize.bucket_size(n)
    assert tensorize.bucket_size(n, tensorize.APP_BUCKETS) == jax_tensorize.bucket_size(
        n, jax_tensorize.APP_BUCKETS
    )


def test_node_order_and_capacity_match():
    rng = random.Random(23)
    for trial in range(20):
        jmeta, pmeta, *_ = random_snapshot(rng)
        names = list(jmeta)
        assert NodeSorter().potential_nodes(pmeta, names) == JaxNodeSorter().potential_nodes(
            jmeta, names
        ), f"trial {trial}"
        app = random_app(rng)
        papp = port_app(app)
        for name in names:
            assert capacity.get_node_capacity(
                pmeta[name].available, papp.driver_resources, papp.executor_resources
            ) == jax_capacity.get_node_capacity(
                jmeta[name].available, app.driver_resources, app.executor_resources
            )
        reserved_j = {names[0]: app.executor_resources}
        reserved_p = {names[0]: papp.executor_resources}
        assert efficiency.compute_packing_efficiencies(pmeta, reserved_p) == {
            k: efficiency.PackingEfficiency(v.node_name, v.cpu, v.memory, v.gpu)
            for k, v in jax_efficiency.compute_packing_efficiencies(jmeta, reserved_j).items()
        }


def _torch_args(p):
    return (
        torch.as_tensor(p.avail), torch.as_tensor(p.driver_rank), torch.as_tensor(p.exec_ok),
        torch.as_tensor(p.driver), torch.as_tensor(p.executor), torch.as_tensor(p.count),
        torch.as_tensor(p.app_valid),
    )


def _jax_args(p):
    return (
        jnp.asarray(p.avail), jnp.asarray(p.driver_rank), jnp.asarray(p.exec_ok),
        jnp.asarray(p.driver), jnp.asarray(p.executor), jnp.asarray(p.count),
        jnp.asarray(p.app_valid),
    )


def _assert_equal(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{label}: shape {got.shape} vs {want.shape}"
    assert (got == want).all(), f"{label} differs"


@pytest.mark.parametrize("fractional", [False, True])
def test_solve_app_and_single_match(fractional):
    rng = random.Random(31 + fractional)
    for trial in range(20):
        jp, pp = problem_pair(rng, fractional=fractional)
        if not pp.ok:
            continue
        pa = _torch_args(pp)
        ja = _jax_args(jp)
        for a in range(min(3, pp.driver.shape[0])):
            for fn, jfn in ((bs.solve_app, jax_bs.solve_app), (bs.solve_single, jax_bs.solve_single)):
                got = fn(pa[0], pa[1], pa[2], pa[3][a], pa[4][a], pa[5][a])
                want = jfn(ja[0], ja[1], ja[2], ja[3][a], ja[4][a], ja[5][a])
                for f in got._fields:
                    _assert_equal(getattr(got, f), getattr(want, f), f"trial {trial} app {a} {f}")
                assert got.exec_counts.dtype == got.exec_capacity.dtype == torch.int32


@pytest.mark.parametrize("with_placements", [True, False])
@pytest.mark.parametrize("evenly", [False, True])
def test_solve_queue_matches(evenly, with_placements):
    rng = random.Random(41 + 2 * evenly + with_placements)
    for trial in range(8):
        jp, pp = problem_pair(rng)
        assert pp.ok
        got = bs.solve_queue(*_torch_args(pp), evenly=evenly, with_placements=with_placements)
        want = jax_bs.solve_queue(*_jax_args(jp), evenly=evenly, with_placements=with_placements)
        for f in got._fields:
            _assert_equal(getattr(got, f), getattr(want, f), f"trial {trial} {f}")


def test_node_capacity_floors_and_zero_requirement():
    avail = torch.tensor([[-3, 5, 0], [7, -1, 2], [9, 9, 9]], dtype=torch.int32)
    ex = torch.tensor([2, 0, 1], dtype=torch.int32)
    got = bs.node_capacity(avail, ex, 4)
    want = jax_bs.node_capacity(jnp.asarray(avail.numpy()), jnp.asarray(ex.numpy()), jnp.int32(4))
    _assert_equal(got, want, "node_capacity")
