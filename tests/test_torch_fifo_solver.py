"""The port's Filter decision against the JAX package on random snapshots:
``TpuFifoSolver(device="cpu").solve`` vs the JAX ``TpuFifoSolver(backend=
"xla").solve``, the ``tpu-batch`` / ``tpu-batch-distribute-evenly``
binpackers, and ``GangPacker``.  Decisions are equal exactly; packing
efficiencies agree to 1e-12 in float64."""

import random

import numpy as np
import pytest

from k8s_spark_scheduler_tpu.models.gang_packer import GangPacker as JaxGangPacker
from k8s_spark_scheduler_tpu.models.gang_packer import GangPackerConfig as JaxGangPackerConfig
from k8s_spark_scheduler_tpu.ops import tensorize as jax_tensorize
from k8s_spark_scheduler_tpu.ops.fifo_solver import TpuFifoSolver as JaxFifoSolver
from k8s_spark_scheduler_tpu.ops.registry import available_binpackers as jax_available_binpackers
from k8s_spark_scheduler_tpu.ops.registry import select_binpacker as jax_select_binpacker
from k8s_spark_scheduler_tpu.types.resources import copy_metadata as jax_copy_metadata
from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker, GangPackerConfig
from k8s_spark_scheduler_tpu_torch.ops import packers, tensorize
from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import LazyEfficiencies, TpuFifoSolver
from k8s_spark_scheduler_tpu_torch.ops.registry import available_binpackers, select_binpacker
from k8s_spark_scheduler_tpu_torch.types.resources import copy_metadata

from test_batch_parity import random_app
from test_torch_batch_solver import port_app, random_snapshot

POLICIES = ["tightly-pack", "distribute-evenly"]


def _effs_close(got, want, label):
    assert list(got) == list(want), f"{label}: efficiency keys"
    for name in want:
        g, w = got[name], want[name]
        for dim in ("cpu", "memory", "gpu"):
            assert abs(getattr(g, dim) - getattr(w, dim)) <= 1e-12, f"{label}: {name}.{dim}"


def _assert_outcome(got, want, label):
    assert got.supported == want.supported, f"{label}: supported"
    assert got.earlier_ok == want.earlier_ok, f"{label}: earlier_ok"
    assert (got.result is None) == (want.result is None), f"{label}: result"
    if want.result is None:
        return
    g, w = got.result, want.result
    assert g.has_capacity == w.has_capacity, f"{label}: has_capacity"
    assert g.driver_node == w.driver_node, f"{label}: driver_node"
    assert g.executor_nodes == w.executor_nodes, f"{label}: executor_nodes"
    _effs_close(g.packing_efficiencies, w.packing_efficiencies, label)
    if w.max_avg_efficiency is None:
        assert g.max_avg_efficiency is None
    else:
        assert abs(g.max_avg_efficiency - w.max_avg_efficiency) <= 1e-12, f"{label}: avg"


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_fifo_solve_matches_jax(policy, fractional):
    rng = random.Random(100 * POLICIES.index(policy) + fractional)
    port = TpuFifoSolver(assignment_policy=policy, device="cpu")
    ref = JaxFifoSolver(assignment_policy=policy, backend="xla")
    for trial in range(15):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(
            rng, max_apps=9, fractional=fractional
        )
        skip = [rng.random() < 0.3 for _ in japps[:-1]]
        want = ref.solve(jax_copy_metadata(jmeta), dorder, eorder, japps[:-1], skip, japps[-1])
        got = port.solve(copy_metadata(pmeta), dorder, eorder, papps[:-1], skip, papps[-1])
        _assert_outcome(got, want, f"trial {trial}")
        if want.supported and len(japps) > 1:
            assert port.last_queue_lane == "torch"


@pytest.mark.parametrize("policy", POLICIES)
def test_fifo_solve_tensor_rows_efficiencies_match_jax(policy):
    """solve_tensor without metadata: the vectorized efficiency rows and
    the Neumaier-compensated average."""
    rng = random.Random(505 + len(policy))
    port = TpuFifoSolver(assignment_policy=policy, device="cpu")
    ref = JaxFifoSolver(assignment_policy=policy, backend="xla")
    for trial in range(12):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_apps=8)
        skip = [True] * (len(japps) - 1)
        want = ref.solve_tensor(
            jax_tensorize.tensorize_cluster(jmeta, dorder, eorder), japps[:-1], skip, japps[-1]
        )
        got = port.solve_tensor(
            tensorize.tensorize_cluster(pmeta, dorder, eorder), papps[:-1], skip, papps[-1]
        )
        _assert_outcome(got, want, f"trial {trial}")
        if got.result is not None and got.result.has_capacity:
            assert isinstance(got.result.packing_efficiencies, LazyEfficiencies)


def test_fifo_feasible_tensor_and_cache_match_jax():
    rng = random.Random(77)
    port = TpuFifoSolver(device="cpu")
    ref = JaxFifoSolver(backend="xla")
    for trial in range(10):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng)
        jc = jax_tensorize.tensorize_cluster(jmeta, dorder, eorder)
        pc = tensorize.tensorize_cluster(pmeta, dorder, eorder)
        for ja, pa in zip(japps, papps):
            assert port.feasible_tensor(pc, pa) == ref.feasible_tensor(jc, ja), f"trial {trial}"
        # the same earlier list twice: the second tensorization is a cache hit
        first = port._tensorize_with_cache(papps[:-1], papps[-1])
        cached = port._earlier_tensor_cache
        second = port._tensorize_with_cache(papps[:-1], papps[-1])
        assert port._earlier_tensor_cache is cached
        assert (first.driver == second.driver).all() and (first.count == second.count).all()


def test_min_frag_policy_is_unsupported_until_ported():
    """Minimal fragmentation is ported: a sentinel-safe snapshot is served
    by the min-frag queue pass; only an unknown policy stays unsupported
    (test_torch_min_frag.py covers the sentinel-unsafe snapshot)."""
    rng = random.Random(3)
    _, pmeta, dorder, eorder, _, papps = random_snapshot(rng, max_apps=6)
    papps = papps + papps[:1]  # at least one earlier driver
    skip = [True] * (len(papps) - 1)
    solver = TpuFifoSolver(assignment_policy="minimal-fragmentation", device="cpu")
    out = solver.solve(pmeta, dorder, eorder, papps[:-1], skip, papps[-1])
    assert out.supported and solver.last_queue_lane == "torch"
    unknown = TpuFifoSolver(assignment_policy="no-such-policy", device="cpu")
    assert not unknown.solve(pmeta, dorder, eorder, papps[:-1], skip, papps[-1]).supported


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("name", ["tpu-batch", "tpu-batch-distribute-evenly"])
def test_tpu_batch_binpack_func_matches_jax(name, fractional):
    rng = random.Random(200 + 10 * len(name) + fractional)
    port = select_binpacker(name, device="cpu")
    ref = jax_select_binpacker(name)
    assert port.name == ref.name and port.is_single_az == ref.is_single_az
    for trial in range(20):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(
            rng, max_apps=2, fractional=fractional
        )
        ja, pa = japps[0], papps[0]
        want = ref.binpack_func(
            ja.driver_resources, ja.executor_resources, ja.min_executor_count,
            dorder, eorder, jax_copy_metadata(jmeta),
        )
        got = port.binpack_func(
            pa.driver_resources, pa.executor_resources, pa.min_executor_count,
            dorder, eorder, copy_metadata(pmeta),
        )
        assert got.has_capacity == want.has_capacity, f"trial {trial}"
        assert got.driver_node == want.driver_node, f"trial {trial}"
        assert got.executor_nodes == want.executor_nodes, f"trial {trial}"
        _effs_close(got.packing_efficiencies, want.packing_efficiencies, f"trial {trial}")


def test_inexact_snapshot_uses_host_oracle():
    from k8s_spark_scheduler_tpu_torch import convert

    meta = {"a": convert.metadata_from_plain(("100u", "1Gi", 0), ("8", "8Gi", 0))}
    drv, ex = convert.resources_from_plain(("50u", "1Mi", 0)), convert.resources_from_plain(
        ("10u", "1Mi", 0)
    )
    got = select_binpacker("tpu-batch", device="cpu").binpack_func(drv, ex, 2, ["a"], ["a"], meta)
    want = packers.tightly_pack(drv, ex, 2, ["a"], ["a"], copy_metadata(meta))
    assert (got.has_capacity, got.executor_nodes) == (want.has_capacity, want.executor_nodes)
    out = TpuFifoSolver(device="cpu").solve(
        meta, ["a"], ["a"], [], [], convert.app_from_plain(("50u", "1Mi", 0), ("10u", "1Mi", 0), 2)
    )
    assert not out.supported


@pytest.mark.parametrize("policy", POLICIES)
def test_gang_packer_matches_jax(policy):
    rng = random.Random(900 + len(policy))
    port = GangPacker(GangPackerConfig(assignment_policy=policy), device="cpu")
    ref = JaxGangPacker(JaxGangPackerConfig(assignment_policy=policy, backend="xla"))
    for trial in range(6):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_apps=12)
        jp = ref.scale(
            jax_tensorize.tensorize_cluster(jmeta, dorder, eorder),
            jax_tensorize.tensorize_apps(japps),
        )
        pp = port.scale(tensorize.tensorize_cluster(pmeta, dorder, eorder), tensorize.tensorize_apps(papps))
        want = ref.solve(jp)
        got = port.solve(pp)
        for f in ("feasible", "driver_idx", "avail_after"):
            assert (getattr(got, f).numpy() == np.asarray(getattr(want, f))).all(), f"trial {trial} {f}"
        assert got.exec_counts.numel() == 0


def test_registry_names():
    """The port serves every name of the JAX registry, with the same
    single-AZ flag; unknown names fall back to distribute-evenly."""
    assert select_binpacker("tightly-pack").binpack_func is packers.tightly_pack
    assert select_binpacker("no-such-policy").binpack_func is packers.distribute_evenly
    assert available_binpackers() == jax_available_binpackers()
    assert len(available_binpackers()) == 12
    for name in available_binpackers():
        for strict in (True, False):
            got = select_binpacker(name, strict_reference_parity=strict, device="cpu")
            want = jax_select_binpacker(name, strict_reference_parity=strict)
            assert (got.name, got.is_single_az) == (want.name, want.is_single_az), name
            assert (got.queue_solver is None) == (want.queue_solver is None), name


def test_fifo_decisions_match_host_oracle_loop():
    """The port's FIFO decision equals the reference's earlier-drivers
    loop on the port's own host oracles (the JAX package's
    test_fifo_solver_parity_random, on the port)."""
    from test_fifo_solver import host_fifo_oracle

    rng = random.Random(31337)
    for policy, packer in (("tightly-pack", packers.tightly_pack),
                           ("distribute-evenly", packers.distribute_evenly)):
        solver = TpuFifoSolver(assignment_policy=policy, device="cpu")
        for trial in range(10):
            jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_apps=9)
            skip = [rng.random() < 0.3 for _ in papps[:-1]]
            ok, expected = host_fifo_oracle(
                pmeta, dorder, eorder, papps[:-1], skip, papps[-1], packer=packer
            )
            out = solver.solve(pmeta, dorder, eorder, papps[:-1], skip, papps[-1])
            assert out.supported and out.earlier_ok == ok, f"{policy} trial {trial}"
            if ok:
                assert out.result.has_capacity == expected.has_capacity
                assert out.result.driver_node == expected.driver_node
                assert out.result.executor_nodes == expected.executor_nodes


def test_port_app_roundtrip():
    rng = random.Random(8)
    for _ in range(20):
        app = random_app(rng)
        p = port_app(app)
        assert p.min_executor_count == app.min_executor_count
        assert p.driver_resources.cpu.exact == app.driver_resources.cpu.exact
        assert p.executor_resources.memory.exact == app.executor_resources.memory.exact
