"""The port's single-AZ slice against the JAX package: the whole-queue
single-AZ solve (``single_az_kernel``'s plain version vs
``pallas_solve_queue_single_az`` in interpret mode and the XLA
``solve_queue_single_az``), ``batch_solver``'s single-AZ programs, the
``TpuSingleAzFifoSolver`` Filter decision (fused lane, the uncertainty
valve to the host lane, the az-aware fallback) and the three
``tpu-batch-single-az*`` / ``tpu-batch-az-aware`` binpackers (vs the JAX
package and the host oracles).  Integer outputs (feasible, zone_idx,
driver_idx, uncertain, avail_after) and decisions are equal exactly.  The
CUDA kernel is held against the plain version on the card (``cuda``
marker; skipped without a GPU)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.ops import batch_solver as jax_bs
from k8s_spark_scheduler_tpu.ops.batch_adapter import candidate_zone_masks as jax_zone_masks
from k8s_spark_scheduler_tpu.ops.fifo_solver import TpuSingleAzFifoSolver as JaxSingleAzSolver
from k8s_spark_scheduler_tpu.ops.fifo_solver import _fused_efficiency_inputs as jax_fused_inputs
from k8s_spark_scheduler_tpu.ops.pallas_queue import pallas_solve_queue_single_az
from k8s_spark_scheduler_tpu.ops.registry import select_binpacker as jax_select_binpacker
from k8s_spark_scheduler_tpu.ops.tensorize import scale_problem, tensorize_apps, tensorize_cluster
from k8s_spark_scheduler_tpu.types.resources import copy_metadata as jax_copy_metadata
from k8s_spark_scheduler_tpu_torch import convert
from k8s_spark_scheduler_tpu_torch.ops import batch_adapter, packers
from k8s_spark_scheduler_tpu_torch.ops import batch_solver as bs
from k8s_spark_scheduler_tpu_torch.ops import fifo_solver as fs
from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk
from k8s_spark_scheduler_tpu_torch.ops import tensorize
from k8s_spark_scheduler_tpu_torch.ops.registry import select_binpacker
from k8s_spark_scheduler_tpu_torch.types.resources import copy_metadata

from test_batch_parity import orders_for, random_app, random_cluster
from test_fifo_solver import _byte_app as jax_byte_app
from test_fifo_solver import _two_zone_cluster as jax_two_zone_cluster
from test_fifo_solver import host_fifo_oracle
from test_torch_batch_solver import port_app, port_metadata, random_snapshot
from test_torch_fifo_solver import _assert_outcome, _effs_close

BIG = 2**31 - 1
# (az_aware, minfrag, strict) of each kernel variant
VARIANTS = {
    "tightly": (False, False, True),
    "az_aware": (True, False, True),
    "min_frag": (False, True, False),
    "min_frag_strict": (False, True, True),
}
OUT_FIELDS = ("feasible", "zone_idx", "driver_idx", "uncertain", "avail_after")


def random_single_az_queue(rng, n, a, n_zones):
    """A raw single-AZ queue in scaled units (cpu and gpu in whole units of
    1000 milli, memory in GiB): negative availability, zone ids -1 (no
    zone) to n_zones - 1, non-candidate ranks, zero-requirement dims,
    k = 0, invalid apps, gpu-less nodes."""
    avail = rng.randint(-4, 40, size=(n, 3)).astype(np.int32)
    avail[rng.rand(n) < 0.3, 2] = 0
    rank = rng.permutation(n).astype(np.int32)
    rank[rng.rand(n) < 0.3] = BIG
    exec_ok = rng.rand(n) < 0.85
    zone_id = rng.randint(-1, max(n_zones, 1), size=n).astype(np.int32)
    drivers = rng.randint(0, 4, size=(a, 3)).astype(np.int32)
    executors = rng.randint(0, 9, size=(a, 3)).astype(np.int32)
    executors[rng.rand(a) < 0.1] = 0
    counts = rng.randint(0, 30, size=a).astype(np.int32)
    valid = rng.rand(a) < 0.85
    sched = np.maximum(avail, 0) + rng.randint(0, 16, size=(n, 3))
    sched[:, :2] = np.maximum(sched[:, :2], 1)
    s_cpu = (sched[:, 0] * 1000).astype(np.int32)
    s_gpu = np.where(rng.rand(n) < 0.5, sched[:, 2] * 1000, 0).astype(np.int32)
    inv_mem = (1.0 / sched[:, 1].astype(np.float64)).astype(np.float32)
    th_mem = sched[:, 1].astype(np.int32)
    return (avail, rank, exec_ok, zone_id, drivers, executors, counts, valid,
            s_cpu, s_gpu, inv_mem, th_mem, 1000, 1000, n_zones)


def port_single_az(arrays, variant):
    az_aware, minfrag, strict = VARIANTS[variant]
    tensors = tuple(torch.as_tensor(x) for x in arrays[:12])
    out = sk.fifo_queue_single_az(*tensors, *arrays[12:], az_aware=az_aware, minfrag=minfrag, strict=strict)
    return tuple(x.numpy() for x in out)


def pallas_single_az(arrays, variant):
    az_aware, minfrag, strict = VARIANTS[variant]
    args = tuple(jnp.asarray(x) for x in arrays[:12])
    scales = tuple(jnp.asarray(np.array([s], np.int32)) for s in arrays[12:14])
    out = pallas_solve_queue_single_az(
        *args, *scales, n_zones=arrays[14], az_aware=az_aware, interpret=True,
        minfrag=minfrag, strict=strict,
    )
    return tuple(np.asarray(x) for x in out)


def assert_same(got, want, label):
    for name, g, w in zip(OUT_FIELDS, got, want):
        assert g.shape == w.shape, f"{label}: {name} shape {g.shape} vs {w.shape}"
        assert (g == w).all(), f"{label}: {name} differs"


# zone counts per node count: no zone (the az-aware cross-zone fallback
# alone), one zone, and several
ZONES_FOR_N = {2: (0, 1), 31: (3, 3), 129: (2, 2), 300: (3, 3)}


@pytest.mark.parametrize("n", sorted(ZONES_FOR_N))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_single_az_queue_matches_pallas(variant, n):
    rng = np.random.RandomState(3000 + n)
    for n_zones in ZONES_FOR_N[n]:
        arrays = random_single_az_queue(rng, n, 10, n_zones)
        got = port_single_az(arrays, variant)
        assert_same(got, pallas_single_az(arrays, variant), f"n={n} zones={n_zones} vs pallas")
        assert got[0].dtype == got[3].dtype == np.bool_
        assert got[1].dtype == got[2].dtype == got[4].dtype == np.int32


def _snapshot_problems(rng, trials, max_nodes, max_apps):
    """Tensorized random snapshots inside the fused lane's bounds:
    (problem, efficiency inputs, candidate zones, zone masks)."""
    out = []
    for _ in range(trials):
        metadata = random_cluster(rng, rng.randint(2, max_nodes))
        apps = [random_app(rng) for _ in range(rng.randint(1, max_apps))]
        driver_order, executor_order = orders_for(metadata, rng)
        cluster = tensorize_cluster(metadata, driver_order, executor_order)
        problem = scale_problem(cluster, tensorize_apps(apps))
        if not problem.ok:
            continue
        eff = jax_fused_inputs(cluster, problem)
        if eff is None:
            continue
        zones, masks = jax_zone_masks(driver_order, executor_order, metadata, cluster.node_names, problem.avail.shape[0])
        out.append((problem, eff, zones, masks))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_single_az_queue_matches_pallas_and_scan(variant):
    """test_pallas_queue.py::test_pallas_single_az_matches_xla and
    ::test_pallas_single_az_min_frag_matches_xla on the port: the plain
    version equals the Pallas kernel (interpret mode), the JAX XLA scan and
    the port's batch_solver.solve_queue_single_az."""
    az_aware, minfrag, strict = VARIANTS[variant]
    rng = random.Random(777 + sorted(VARIANTS).index(variant))
    compared = 0
    for problem, eff, zones, masks in _snapshot_problems(rng, 8, 30, 16):
        s_cpu, s_gpu, inv_m, th_m, scale_c, scale_g = eff
        zone_vec = np.full(problem.avail.shape[0], -1, np.int32)
        for zi in range(len(zones)):
            zone_vec[masks[zi]] = zi
        arrays = (problem.avail, problem.driver_rank, problem.exec_ok, zone_vec, problem.driver,
                  problem.executor, problem.count, problem.app_valid, s_cpu, s_gpu, inv_m, th_m,
                  scale_c, scale_g, len(zones))
        got = port_single_az(arrays, variant)
        assert_same(got, pallas_single_az(arrays, variant), "vs pallas")

        queue = (problem.avail, problem.driver_rank, problem.exec_ok, masks, problem.driver,
                 problem.executor, problem.count, problem.app_valid, s_cpu, s_gpu, inv_m, th_m)
        flags = dict(az_aware=az_aware, minfrag=minfrag, strict=strict)
        scan = jax_bs.solve_queue_single_az(
            *(jnp.asarray(x) for x in queue), jnp.int32(scale_c), jnp.int32(scale_g), **flags
        )
        port_scan = bs.solve_queue_single_az(*(torch.as_tensor(x) for x in queue), scale_c, scale_g, **flags)
        for i, field in enumerate(OUT_FIELDS):
            want = np.asarray(getattr(scan, field))
            assert (port_scan[i].numpy() == want).all(), f"batch_solver {field}"
            if field != "zone_idx" or zones:  # the cross-zone marker differs when Z == 0
                assert (got[i] == want).all(), f"plain vs scan {field}"
        compared += 1
    assert compared >= 5, f"only {compared} snapshots were comparable"


def test_batch_solver_solve_zones_and_score_match_jax():
    rng = random.Random(4321)
    for problem, eff, zones, masks in _snapshot_problems(rng, 6, 24, 4):
        s_cpu, s_gpu, inv_m, th_m, scale_c, scale_g = eff
        node = (problem.avail, problem.driver_rank, problem.exec_ok, masks)
        app = (problem.driver[0], problem.executor[0])
        got = bs.solve_zones(*(torch.as_tensor(x) for x in node + app), int(problem.count[0]))
        want = jax_bs.solve_zones_jit(*(jnp.asarray(x) for x in node + app), jnp.int32(problem.count[0]))
        for f in got._fields:
            assert (getattr(got, f).numpy() == np.asarray(getattr(want, f))).all(), f
        solve = bs.solve_app(*(torch.as_tensor(x) for x in node[:3] + app), int(problem.count[0]))
        jsolve = jax_bs.solve_app(*(jnp.asarray(x) for x in node[:3] + app), jnp.int32(problem.count[0]))
        cols = (s_cpu, s_gpu, inv_m, th_m)
        score = bs._zone_score(
            torch.as_tensor(problem.avail), solve, *(torch.as_tensor(x) for x in app),
            *(torch.as_tensor(x) for x in cols), scale_c, scale_g,
        )
        jscore = jax_bs._zone_score(
            jnp.asarray(problem.avail), jsolve, *(jnp.asarray(x) for x in app),
            *(jnp.asarray(x) for x in cols), jnp.int32(scale_c), jnp.int32(scale_g),
        )
        assert int(score[0]) == int(jscore[0]) and bool(score[1]) == bool(jscore[1])


def test_fused_efficiency_inputs_match_jax():
    from k8s_spark_scheduler_tpu.ops import tensorize as jax_tensorize

    rng = random.Random(55)
    checked = 0
    for trial in range(12):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, fractional=trial % 2 == 1)
        jc = jax_tensorize.tensorize_cluster(jmeta, dorder, eorder)
        pc = tensorize.tensorize_cluster(pmeta, dorder, eorder)
        want = jax_fused_inputs(jc, jax_tensorize.scale_problem(jc, jax_tensorize.tensorize_apps(japps)))
        got = fs._fused_efficiency_inputs(pc, tensorize.scale_problem(pc, tensorize.tensorize_apps(papps)))
        assert (got is None) == (want is None), f"trial {trial}"
        if want is not None:
            checked += 1
            for g, w in zip(got, want):
                assert np.array_equal(np.asarray(g), np.asarray(w)), f"trial {trial}"
    assert checked >= 4


def host_single_az_fifo(pmeta, dorder, eorder, earlier, skip, current, packer):
    return host_fifo_oracle(pmeta, dorder, eorder, earlier, skip, current, packer=packer)


def _oracle_for(az_aware, inner_policy, strict):
    if inner_policy == "minimal-fragmentation":
        return packers.make_single_az_minimal_fragmentation(strict)
    return packers.az_aware_tightly_pack if az_aware else packers.single_az_tightly_pack


SOLVER_CASES = [
    (False, "tightly-pack", True),
    (True, "tightly-pack", True),
    (False, "minimal-fragmentation", True),
    (False, "minimal-fragmentation", False),
]


@pytest.mark.parametrize("az_aware,inner_policy,strict", SOLVER_CASES)
def test_single_az_fifo_solver_matches_host_oracle_and_jax(az_aware, inner_policy, strict):
    """test_fifo_solver.py::test_single_az_fifo_solver_parity and
    ::test_single_az_min_frag_fifo_solver_parity on the port: decisions
    equal the host loop on the port's single-AZ oracles, and the JAX
    solver's on a subset; the fused lane serves most queues."""
    rng = random.Random(60606 + az_aware + 2 * (inner_policy != "tightly-pack") + 4 * strict)
    solver = fs.TpuSingleAzFifoSolver(
        az_aware=az_aware, inner_policy=inner_policy, strict_reference_parity=strict, device="cpu"
    )
    ref = JaxSingleAzSolver(
        az_aware=az_aware, backend="xla", inner_policy=inner_policy, strict_reference_parity=strict
    )
    oracle = _oracle_for(az_aware, inner_policy, strict)
    fused = 0
    for trial in range(16):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_nodes=18, max_apps=7)
        skip = [rng.random() < 0.3 for _ in papps[:-1]]
        ok, expected = host_single_az_fifo(pmeta, dorder, eorder, papps[:-1], skip, papps[-1], oracle)
        out = solver.solve(copy_metadata(pmeta), dorder, eorder, papps[:-1], skip, papps[-1])
        assert out.supported and out.earlier_ok == ok, f"trial {trial}"
        fused += solver.last_path == "fused"
        if ok:
            assert out.result.has_capacity == expected.has_capacity, f"trial {trial}"
            assert out.result.driver_node == expected.driver_node, f"trial {trial}"
            assert out.result.executor_nodes == expected.executor_nodes, f"trial {trial}"
        if trial < 6:
            want = ref.solve(jax_copy_metadata(jmeta), dorder, eorder, japps[:-1], skip, japps[-1])
            assert solver.last_path == ref.last_path, f"trial {trial}"
            _assert_outcome(out, want, f"trial {trial} vs jax")
    assert fused >= 8, f"fused lane served only {fused}/16 queues"


def _two_zone_cluster(mem_a, mem_b, sched_mem="1000000"):
    return {
        "a0": convert.metadata_from_plain(("64", str(mem_a), 0), ("64", sched_mem, 0), zone_label="z0"),
        "a1": convert.metadata_from_plain(("64", str(mem_b), 0), ("64", sched_mem, 0), zone_label="z1"),
    }


def _byte_app(k=1, mem="100000"):
    return convert.app_from_plain(("1", mem, 0), ("1", mem, 0), k)


def test_single_az_fused_symmetric_tie_keeps_first_zone():
    """Mathematically equal zone scores stay on the fused lane and pick
    the earlier zone, like the float64 oracle's strict-improvement rule."""
    metadata = _two_zone_cluster(600000, 600000)
    order = ["a0", "a1"]
    solver = fs.TpuSingleAzFifoSolver(device="cpu")
    out = solver.solve(metadata, order, order, [_byte_app()], [False], _byte_app())
    assert solver.last_path == "fused"
    ok, expected = host_single_az_fifo(
        metadata, order, order, [_byte_app()], [False], _byte_app(), packers.single_az_tightly_pack
    )
    assert out.supported and out.earlier_ok == ok
    assert (out.result.driver_node, out.result.executor_nodes) == (expected.driver_node, expected.executor_nodes)
    assert out.result.driver_node == "a0"


def test_single_az_fused_near_tie_falls_back_to_host():
    """Zone scores distinct but inside the fixed-point margin flag
    `uncertain`; the queue re-solves on the exact host lane and still
    matches the oracle."""
    metadata = _two_zone_cluster(600000, 600005)
    order = ["a0", "a1"]
    solver = fs.TpuSingleAzFifoSolver(device="cpu")
    out = solver.solve(metadata, order, order, [_byte_app()], [False], _byte_app())
    assert solver.last_path == "host"
    ok, expected = host_single_az_fifo(
        metadata, order, order, [_byte_app()], [False], _byte_app(), packers.single_az_tightly_pack
    )
    assert out.supported and out.earlier_ok == ok
    assert (out.result.driver_node, out.result.executor_nodes) == (expected.driver_node, expected.executor_nodes)


@pytest.mark.parametrize("az_aware", [False, True])
def test_single_az_valve_solves_only_the_uncertain_app_on_the_host(az_aware, monkeypatch):
    """A near tie at the queue's head flags that app `uncertain`; the valve
    solves it alone on the host lane and the fused lane resumes after it
    (the apps behind it are certain), so the host lane's per-zone solves
    run for that app and the current one only.  The decision, the earlier
    verdict and the lane equal the JAX solver's (which re-solves the whole
    queue on its host lane) and the host oracle's."""
    metadata = _two_zone_cluster(600000, 600005)
    order = ["a0", "a1"]
    earlier = [_byte_app() for _ in range(4)]
    skip = [False] * len(earlier)
    host_solves, launches = [], []
    solve_zones, fused = fs.solve_zones, fs.fifo_queue_single_az
    monkeypatch.setattr(fs, "solve_zones", lambda *a, **k: host_solves.append(1) or solve_zones(*a, **k))
    monkeypatch.setattr(fs, "fifo_queue_single_az", lambda *a, **k: launches.append(a[4].shape[0]) or fused(*a, **k))
    solver = fs.TpuSingleAzFifoSolver(az_aware=az_aware, device="cpu")
    out = solver.solve(copy_metadata(metadata), order, order, earlier, skip, _byte_app())
    assert solver.last_path == "host"
    assert len(host_solves) == 2, host_solves  # the uncertain head and the current app
    assert launches == [4, 3], launches  # the whole queue, then the apps behind the head
    oracle = packers.az_aware_tightly_pack if az_aware else packers.single_az_tightly_pack
    ok, expected = host_single_az_fifo(metadata, order, order, earlier, skip, _byte_app(), oracle)
    assert out.supported and out.earlier_ok == ok
    assert (out.result.driver_node, out.result.executor_nodes) == (expected.driver_node, expected.executor_nodes)
    ref = JaxSingleAzSolver(az_aware=az_aware, backend="xla")
    want = ref.solve(jax_two_zone_cluster(600000, 600005), order, order, [jax_byte_app() for _ in earlier], skip,
                     jax_byte_app())
    assert ref.last_path == solver.last_path
    _assert_outcome(out, want, "near tie at the head")


@pytest.mark.parametrize("az_aware", [False, True])
def test_single_az_huge_current_gang_leaves_the_queue_fused(az_aware, monkeypatch):
    """A current gang past the fused score's count bound (4,095
    executors) is packed on the host lane, as every current app is; the
    earlier apps, the only ones the kernel scores, stay on the fused lane
    (the reference sends the whole queue to its host lane).  The decision
    equals the JAX solver's and the host oracle's."""
    metadata = _two_zone_cluster(600000, 900000)
    order = ["a0", "a1"]
    earlier = [_byte_app() for _ in range(3)]
    skip = [False] * len(earlier)
    host_solves = []
    solve_zones = fs.solve_zones
    monkeypatch.setattr(fs, "solve_zones", lambda *a, **k: host_solves.append(1) or solve_zones(*a, **k))
    solver = fs.TpuSingleAzFifoSolver(az_aware=az_aware, device="cpu")
    out = solver.solve(copy_metadata(metadata), order, order, earlier, skip, _byte_app(k=5000))
    assert solver.last_path == "fused"
    assert len(host_solves) == 1, host_solves  # the current app's
    oracle = packers.az_aware_tightly_pack if az_aware else packers.single_az_tightly_pack
    ok, expected = host_single_az_fifo(metadata, order, order, earlier, skip, _byte_app(k=5000), oracle)
    assert out.supported and out.earlier_ok == ok and not expected.has_capacity
    assert out.result.has_capacity == expected.has_capacity
    ref = JaxSingleAzSolver(az_aware=az_aware, backend="xla")
    want = ref.solve(jax_two_zone_cluster(600000, 900000), order, order, [jax_byte_app() for _ in earlier], skip,
                     jax_byte_app(k=5000))
    assert ref.last_path == "host"
    _assert_outcome(out, want, "a current gang of 5,000 executors")


@pytest.mark.parametrize("az_aware", [False, True])
def test_single_az_fused_matches_forced_host_lane(az_aware, monkeypatch):
    """The fused lane and the per-driver host lane agree on every decision
    where the fused lane is certain (deeper random queues)."""
    rng = random.Random(424242 + az_aware)
    compared = 0
    for trial in range(8):
        metadata = port_metadata(random_cluster(rng, rng.randint(4, 16)))
        driver_order, executor_order = orders_for(metadata, rng)
        earlier = [port_app(random_app(rng)) for _ in range(rng.randint(1, 10))]
        skip = [rng.random() < 0.3 for _ in earlier]
        current = port_app(random_app(rng))
        args = (metadata, driver_order, executor_order, earlier, skip, current)
        solver = fs.TpuSingleAzFifoSolver(az_aware=az_aware, device="cpu")
        fused = solver.solve(*args)
        if solver.last_path != "fused":
            continue
        with monkeypatch.context() as m:
            m.setattr(fs, "_fused_efficiency_inputs", lambda *a, **k: None)
            host_solver = fs.TpuSingleAzFifoSolver(az_aware=az_aware, device="cpu")
            host = host_solver.solve(*args)
            assert host_solver.last_path == "host"
        compared += 1
        assert fused.earlier_ok == host.earlier_ok, f"trial {trial}"
        if fused.earlier_ok:
            assert fused.result.has_capacity == host.result.has_capacity, f"trial {trial}"
            assert fused.result.driver_node == host.result.driver_node, f"trial {trial}"
            assert fused.result.executor_nodes == host.result.executor_nodes, f"trial {trial}"
    assert compared >= 4


def test_single_az_min_frag_sentinel_unsafe_takes_host_lane():
    """A min-frag snapshot whose scaled availability could reach MF_SENT
    skips the fused lane (its drain uses the int32 sentinel) and is
    decided exactly on the host lane."""
    huge = str(2**31 - 2)
    metadata = {
        "a": convert.metadata_from_plain(("8", huge, 0), ("8", huge, 0), zone_label="z0"),
        "b": convert.metadata_from_plain(("4", huge, 0), ("8", huge, 0), zone_label="z1"),
    }
    order = ["a", "b"]
    app = convert.app_from_plain(("1", "1", 0), ("1", "1", 0), 2)
    assert not bs.mf_sentinel_safe(
        tensorize.scale_problem(tensorize.tensorize_cluster(metadata, order, order),
                                tensorize.tensorize_apps([app])).avail
    )
    solver = fs.TpuSingleAzFifoSolver(inner_policy="minimal-fragmentation", device="cpu")
    out = solver.solve(metadata, order, order, [app], [False], app)
    assert solver.last_path == "host"
    ok, expected = host_single_az_fifo(
        metadata, order, order, [app], [False], app, packers.single_az_minimal_fragmentation
    )
    assert out.supported and out.earlier_ok == ok
    assert (out.result.driver_node, out.result.executor_nodes) == (expected.driver_node, expected.executor_nodes)


MANY_ZONES = 140  # more zones than an int8 zone id holds


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_single_az_queue_many_zones_matches_scan(variant):
    """More zones than int8 holds: the plain version equals the JAX XLA
    scan (the kernel's int32 zone-id mode is held against the plain
    version on the card).  The scan runs op by op: compiled, its zone
    choice unrolls over every zone and XLA takes minutes."""
    az_aware, minfrag, strict = VARIANTS[variant]
    arrays = random_single_az_queue(np.random.RandomState(140), 200, 6, MANY_ZONES)
    got = port_single_az(arrays, variant)
    zone_id = arrays[3]
    masks = zone_id[None, :] == np.arange(MANY_ZONES, dtype=np.int32)[:, None]
    queue = arrays[:3] + (masks,) + arrays[4:12]
    with jax.disable_jit():
        scan = jax_bs.solve_queue_single_az(
            *(jnp.asarray(x) for x in queue), jnp.int32(arrays[12]), jnp.int32(arrays[13]),
            az_aware=az_aware, minfrag=minfrag, strict=strict,
        )
    assert_same(got, tuple(np.asarray(getattr(scan, f)) for f in OUT_FIELDS), "vs scan")
    assert got[0].any() and (got[1][got[0]] < MANY_ZONES).any()


def _zone_walk(f, nz, q, band):
    """The Pallas kernel's zone choice as it walks the zones in order."""
    best_q, best_zone, uncertain = 0, -1, False
    for z in range(len(q)):
        first = best_zone < 0
        if f[z] and not first and q[z] != best_q and abs(q[z] - best_q) <= band:
            uncertain = True
        if f[z] and (nz[z] if first else q[z] > best_q):
            best_q, best_zone = q[z], z
    return best_zone, uncertain


@pytest.mark.parametrize("seed", range(4))
def test_pick_zone_closed_form_matches_the_zone_walk(seed):
    """The plain version's closed-form zone choice equals the kernel's
    walk over the zones: the opening zone needs a nonzero score, later
    zones a strictly higher one (ties keep the earlier zone), and a
    near score flags uncertain; with no zones, no choice."""
    rng = random.Random(seed)
    for _ in range(500):
        n_zones = rng.randint(0, 9)
        f = [rng.random() < 0.6 for _ in range(n_zones)]
        nz = [rng.random() < 0.6 for _ in range(n_zones)]
        q = [rng.randint(0, 12) for _ in range(n_zones)]
        band = rng.randint(0, 5)
        zone, uncertain = sk._pick_zone(
            torch.tensor(f, dtype=torch.bool), torch.tensor(nz, dtype=torch.bool),
            torch.tensor(q, dtype=torch.int32), torch.tensor(band, dtype=torch.int32), n_zones,
        )
        assert (int(zone), bool(uncertain)) == _zone_walk(f, nz, q, band), (f, nz, q, band)


def many_zone_snapshot(rng, n_nodes=MANY_ZONES + 40):
    """random_snapshot's cluster and apps with the nodes spread over
    MANY_ZONES zone labels."""
    import dataclasses

    metadata = {
        name: dataclasses.replace(md, zone_label=f"z{i % MANY_ZONES:03d}")
        for i, (name, md) in enumerate(random_cluster(rng, n_nodes).items())
    }
    driver_order, executor_order = orders_for(metadata, rng)
    apps = [random_app(rng) for _ in range(5)]
    return (metadata, port_metadata(metadata), driver_order, executor_order, apps,
            [port_app(a) for a in apps])


def _many_zone_decision(solver, ref, oracle, rng):
    jmeta, pmeta, dorder, eorder, japps, papps = many_zone_snapshot(rng)
    skip = [False] * (len(papps) - 1)
    out = solver.solve(copy_metadata(pmeta), dorder, eorder, papps[:-1], skip, papps[-1])
    with jax.disable_jit():  # as in test_plain_single_az_queue_many_zones_matches_scan
        want = ref.solve(jax_copy_metadata(jmeta), dorder, eorder, japps[:-1], skip, japps[-1])
    ok, expected = host_single_az_fifo(pmeta, dorder, eorder, papps[:-1], skip, papps[-1], oracle)
    assert out.supported and out.earlier_ok == ok
    if ok:
        assert (out.result.has_capacity, out.result.driver_node, out.result.executor_nodes) == (
            expected.has_capacity, expected.driver_node, expected.executor_nodes)
    _assert_outcome(out, want, "vs jax")
    return out


@pytest.mark.parametrize("az_aware,inner_policy,strict", SOLVER_CASES)
def test_single_az_fifo_solver_many_zones_stays_fused(az_aware, inner_policy, strict):
    """A cluster in more zones than int8 holds is served by the fused lane,
    as in the JAX package, and decides as the JAX solver and the host
    oracle do."""
    solver = fs.TpuSingleAzFifoSolver(
        az_aware=az_aware, inner_policy=inner_policy, strict_reference_parity=strict, device="cpu"
    )
    ref = JaxSingleAzSolver(
        az_aware=az_aware, backend="xla", inner_policy=inner_policy, strict_reference_parity=strict
    )
    _many_zone_decision(solver, ref, _oracle_for(az_aware, inner_policy, strict), random.Random(140 + strict))
    assert solver.last_path == ref.last_path == "fused"


BINPACKERS = [
    ("tpu-batch-single-az", True),
    ("tpu-batch-az-aware", True),
    ("tpu-batch-single-az-minimal-fragmentation", True),
    ("tpu-batch-single-az-minimal-fragmentation", False),
]


@pytest.mark.parametrize("name,strict", BINPACKERS)
def test_tpu_batch_single_az_binpack_func_matches_jax_and_oracle(name, strict):
    """test_batch_parity.py::test_single_az_device_parity_random and
    test_fifo_solver.py::test_single_az_min_frag_single_app_parity on the
    port, and the JAX binpacker of the same name."""
    rng = random.Random(4242 + len(name) + strict)
    port = select_binpacker(name, strict_reference_parity=strict, device="cpu")
    ref = jax_select_binpacker(name, strict_reference_parity=strict)
    assert (port.name, port.is_single_az) == (ref.name, ref.is_single_az) == (name, True)
    az_aware = name == "tpu-batch-az-aware"
    inner = "minimal-fragmentation" if "minimal" in name else "tightly-pack"
    assert (port.queue_solver.az_aware, port.queue_solver.inner_policy) == (az_aware, inner)
    oracle = _oracle_for(az_aware, inner, strict)
    placed = 0
    for trial in range(20):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_apps=2)
        ja, pa = japps[0], papps[0]
        args = (pa.driver_resources, pa.executor_resources, pa.min_executor_count, dorder, eorder)
        got = port.binpack_func(*args, copy_metadata(pmeta))
        want = ref.binpack_func(
            ja.driver_resources, ja.executor_resources, ja.min_executor_count, dorder, eorder,
            jax_copy_metadata(jmeta),
        )
        expected = oracle(*args, copy_metadata(pmeta))
        for other, label in ((want, "jax"), (expected, "oracle")):
            assert got.has_capacity == other.has_capacity, f"trial {trial} vs {label}"
            assert got.driver_node == other.driver_node, f"trial {trial} vs {label}"
            assert got.executor_nodes == other.executor_nodes, f"trial {trial} vs {label}"
        _effs_close(got.packing_efficiencies, want.packing_efficiencies, f"trial {trial}")
        placed += got.has_capacity
    assert placed >= 5


def test_az_aware_zero_efficiency_fallback():
    """_choose_best_result returns the empty result when every zone's avg
    efficiency is 0.0; az-aware must still take the cross-zone fallback
    exactly like the oracle, and plain single-AZ stays infeasible."""
    metadata = {
        "a": convert.metadata_from_plain((4, "4Gi", 0), (4, "4Gi", 0), zone_label="z1"),
        "b": convert.metadata_from_plain((4, "4Gi", 0), (4, "4Gi", 0), zone_label="z2"),
    }
    order = ["a", "b"]
    zero = convert.resources_from_plain((0, 0, 0))
    expected = packers.az_aware_tightly_pack(zero, zero, 1, order, order, copy_metadata(metadata))
    actual = batch_adapter.TpuSingleAzBinpacker(az_aware=True, device="cpu")(
        zero, zero, 1, order, order, copy_metadata(metadata)
    )
    assert expected.has_capacity
    assert (actual.has_capacity, actual.driver_node, actual.executor_nodes) == (
        expected.has_capacity, expected.driver_node, expected.executor_nodes
    )
    expected_saz = packers.single_az_tightly_pack(zero, zero, 1, order, order, copy_metadata(metadata))
    actual_saz = batch_adapter.TpuSingleAzBinpacker(az_aware=False, device="cpu")(
        zero, zero, 1, order, order, copy_metadata(metadata)
    )
    assert actual_saz.has_capacity == expected_saz.has_capacity == False  # noqa: E712

    # the FIFO solver takes the same fallback for the current driver
    app = convert.app_from_plain((0, 0, 0), (0, 0, 0), 1)
    for az_aware in (True, False):
        out = fs.TpuSingleAzFifoSolver(az_aware=az_aware, device="cpu").solve(
            metadata, order, order, [], [], app
        )
        assert out.result.has_capacity == az_aware


def test_single_az_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    sk.reset_launch_counts()
    arrays = random_single_az_queue(np.random.RandomState(8), 40, 6, 3)
    for variant in VARIANTS:
        az_aware, minfrag, strict = VARIANTS[variant]
        tensors = tuple(torch.as_tensor(x) for x in arrays[:12])
        got = sk.fifo_queue_single_az(*tensors, *arrays[12:], az_aware=az_aware, minfrag=minfrag, strict=strict)
        want = sk.solve_queue_single_az_plain(*tensors, *arrays[12:], az_aware=az_aware, minfrag=minfrag, strict=strict)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert set(sk.launch_counts.values()) == {0}
    with pytest.raises(ValueError):
        sk.fifo_queue_single_az(*tensors, *arrays[12:], az_aware=True, minfrag=True)
    with pytest.raises(ValueError):
        fs.TpuSingleAzFifoSolver(az_aware=True, inner_policy="minimal-fragmentation", device="cpu")


def skewed_zone_ids(rng, n, n_zones):
    """Zone ids with skewed zone sizes (zone z drawn with weight 2^-z,
    floored), zone 1 left empty when there are at least 3 zones, and some
    nodes of no zone (-1 and ids >= n_zones)."""
    if n_zones == 0:
        return rng.randint(-2, 1, size=n).astype(np.int32)
    w = np.maximum(0.5 ** np.arange(n_zones), 1.0 / n_zones)
    if n_zones >= 3:
        w[1] = 0.0
    zone_id = rng.choice(n_zones, size=n, p=w / w.sum()).astype(np.int32)
    none = rng.rand(n) < 0.1
    zone_id[none] = np.where(rng.rand(int(none.sum())) < 0.5, -1, n_zones + 3)
    return zone_id


@pytest.mark.parametrize("n_zones", [0, 1, 3, 9, 17, 200])
def test_zone_layout(n_zones):
    """The kernel's zone-major layout: a permutation that keeps input order
    within a zone and puts the nodes of no zone last, zone starts that
    match, and blocks that own contiguous runs of zones in zone order,
    covering every zone, with at most 8 blocks and none skipped."""
    rng = np.random.RandomState(70 + n_zones)
    n = 3000
    zone_id = skewed_zone_ids(rng, n, n_zones)
    layout = sk.zone_layout(torch.as_tensor(zone_id), n_zones)
    perm, pos_of = layout.perm.numpy(), layout.pos_of.numpy()
    zone_start, block_zone = layout.zone_start.numpy(), layout.block_zone.numpy()
    assert all(t.dtype == torch.int32 for t in layout)
    assert sorted(perm.tolist()) == list(range(n))  # every node exactly once
    assert (pos_of[perm] == np.arange(n)).all()
    key = np.where((zone_id >= 0) & (zone_id < n_zones), zone_id, n_zones)
    assert (np.diff(key[perm]) >= 0).all()  # zone-major, no-zone nodes last
    for z in range(n_zones + 1):  # input order kept within a zone
        assert (np.diff(perm[key[perm] == z]) > 0).all()
    assert zone_start.shape == (n_zones + 1,) and zone_start[0] == 0
    assert (zone_start[1:] == np.cumsum(np.bincount(key, minlength=n_zones + 1)[:n_zones])).all()
    for z in range(n_zones):
        assert (key[perm[zone_start[z]:zone_start[z + 1]]] == z).all()
    c = min(max(n_zones, 1), sk.MAX_CLUSTER)
    assert layout.cluster == c and block_zone.shape == (c + 1,)
    assert block_zone[0] == 0 and block_zone[-1] == n_zones and (np.diff(block_zone) >= 0).all()
    if n_zones >= c:
        assert (np.diff(block_zone) >= 1).all()  # every block owns a zone
    if n_zones >= 3:
        assert zone_start[2] == zone_start[1]  # the empty zone
    # the zoned nodes spread over the blocks: no block holds more than the
    # largest zone plus an even share
    sizes = np.diff(zone_start)
    seg = [zone_start[block_zone[b + 1]] - zone_start[block_zone[b]] for b in range(c)]
    assert sum(seg) == zone_start[-1]
    if n_zones:
        assert max(seg) <= sizes.max() + zone_start[-1] / c + 1


def test_zone_layout_one_zone_and_no_zone_only():
    layout = sk.zone_layout(torch.zeros(7, dtype=torch.int32), 1)
    assert layout.perm.tolist() == list(range(7)) and layout.zone_start.tolist() == [0, 7]
    assert layout.block_zone.tolist() == [0, 1]
    layout = sk.zone_layout(torch.full((5,), -1, dtype=torch.int32), 2)
    assert layout.perm.tolist() == list(range(5)) and layout.zone_start.tolist() == [0, 0, 0]
    assert layout.block_zone.tolist() == [0, 1, 2]


@pytest.mark.parametrize("sizes", [
    [1, 1, 1, 1, 100, 1, 1, 1, 1],  # a large zone amid small ones
    [1] * 8 + [1000],
    [1000] + [1] * 16,
    [0, 0, 0, 500, 0, 0, 0, 0, 0, 0, 7],
])
def test_zone_layout_leaves_no_block_idle(sizes):
    """However skewed the zone sizes, each zone goes at most one block after
    the zone before it, so every block of the cluster owns a zone."""
    zone_id = torch.cat([torch.full((s,), z, dtype=torch.int32) for z, s in enumerate(sizes)])
    layout = sk.zone_layout(zone_id, len(sizes))
    block_zone = layout.block_zone.numpy()
    assert layout.cluster == sk.MAX_CLUSTER
    assert block_zone[0] == 0 and block_zone[-1] == len(sizes)
    assert (np.diff(block_zone) >= 1).all()
    if sizes[:5] == [1, 1, 1, 1, 100]:
        assert block_zone.tolist() == [0, 2, 3, 4, 5, 6, 7, 8, 9]


@pytest.mark.cuda
@pytest.mark.parametrize("n,a,n_zones", [(2, 5, 1), (129, 64, 3), (4099, 64, 2), (12345, 16, 3), (10240, 1024, 3),
                                         (1000, 16, 200), (12345, 8, 150), (3000, 64, 9), (10240, 64, 17),
                                         (12345, 16, 1), (12000, 4, 4000)])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cuda_single_az_kernel_matches_plain(variant, n, a, n_zones):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the single-AZ kernel has no CPU mode")
    az_aware, minfrag, strict = VARIANTS[variant]
    arrays = random_single_az_queue(np.random.RandomState(n), n, a, n_zones)
    tensors = tuple(torch.as_tensor(x, device="cuda") for x in arrays[:12])
    name = sk.VARIANTS[sk.variant_of(az_aware, minfrag)]
    before = sk.launch_counts[name]
    flags = dict(az_aware=az_aware, minfrag=minfrag, strict=strict)
    got = sk.fifo_queue_single_az(*tensors, *arrays[12:], **flags)
    want = sk.solve_queue_single_az_plain(*tensors, *arrays[12:], **flags)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), f"{variant} n={n} a={a}"
    assert sk.launch_counts[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_zones", [1, 3, 9, 17])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cuda_single_az_kernel_uneven_zones_matches_plain(variant, n_zones):
    """Skewed zone sizes, an empty zone and nodes of no zone, with fewer
    and more zones than the cluster has blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the single-AZ kernel has no CPU mode")
    az_aware, minfrag, strict = VARIANTS[variant]
    rng = np.random.RandomState(900 + n_zones)
    arrays = list(random_single_az_queue(rng, 4000, 96, n_zones))
    arrays[3] = skewed_zone_ids(rng, 4000, n_zones)
    tensors = tuple(torch.as_tensor(x, device="cuda") for x in arrays[:12])
    flags = dict(az_aware=az_aware, minfrag=minfrag, strict=strict)
    got = sk.fifo_queue_single_az(*tensors, *arrays[12:], **flags)
    want = sk.solve_queue_single_az_plain(*tensors, *arrays[12:], **flags)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), f"{variant} zones={n_zones}"


@pytest.mark.cuda
@pytest.mark.parametrize("az_aware,inner_policy,strict", SOLVER_CASES)
def test_cuda_single_az_fifo_solver_many_zones_matches_jax(az_aware, inner_policy, strict):
    """On the card, a cluster in more zones than int8 holds takes the
    kernel (fused lane, one launch) and decides as the JAX solver does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the single-AZ kernel has no CPU mode")
    solver = fs.TpuSingleAzFifoSolver(
        az_aware=az_aware, inner_policy=inner_policy, strict_reference_parity=strict, device="cuda"
    )
    ref = JaxSingleAzSolver(
        az_aware=az_aware, backend="xla", inner_policy=inner_policy, strict_reference_parity=strict
    )
    name = sk.VARIANTS[sk.variant_of(az_aware, inner_policy == "minimal-fragmentation")]
    before = sk.launch_counts[name]
    _many_zone_decision(solver, ref, _oracle_for(az_aware, inner_policy, strict), random.Random(140 + strict))
    assert solver.last_path == "fused"
    assert sk.launch_counts[name] == before + 1
