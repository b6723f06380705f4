"""The port's minimal-fragmentation slice against the JAX package: the
whole-queue min-frag solve (``minfrag_kernel``'s plain version vs
``pallas_solve_queue_min_frag`` in interpret mode and the XLA
``solve_queue_min_frag``), ``batch_solver``'s min-frag programs, the
``TpuFifoSolver("minimal-fragmentation")`` Filter decision and the
``tpu-batch-minimal-fragmentation`` binpacker (vs the JAX solvers and the
host oracles).  Integer outputs and decisions are equal exactly;
efficiencies agree to 1e-12 in float64.  The CUDA kernel is held against
the plain version on the card (``cuda`` marker; skipped without a GPU)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.ops import batch_solver as jax_bs
from k8s_spark_scheduler_tpu.ops import packers as jax_packers
from k8s_spark_scheduler_tpu.ops.fifo_solver import TpuFifoSolver as JaxFifoSolver
from k8s_spark_scheduler_tpu.ops.pallas_queue import pallas_solve_queue_min_frag
from k8s_spark_scheduler_tpu.ops.registry import select_binpacker as jax_select_binpacker
from k8s_spark_scheduler_tpu.ops.tensorize import scale_problem, tensorize_apps, tensorize_cluster
from k8s_spark_scheduler_tpu.types.resources import copy_metadata as jax_copy_metadata
from k8s_spark_scheduler_tpu_torch import convert
from k8s_spark_scheduler_tpu_torch.ops import batch_solver as bs
from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
from k8s_spark_scheduler_tpu_torch.ops import packers
from k8s_spark_scheduler_tpu_torch.ops.capacity import MAX_CAPACITY, NodeAndExecutorCapacity
from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver
from k8s_spark_scheduler_tpu_torch.ops.registry import select_binpacker
from k8s_spark_scheduler_tpu_torch.types.resources import copy_metadata

from test_batch_parity import orders_for, random_app, random_cluster
from test_fifo_solver import host_fifo_oracle
from test_torch_batch_solver import random_snapshot
from test_torch_fifo_solver import _assert_outcome, _effs_close
from test_torch_queue_kernel import _edge_problems, assert_same, random_queue

QUEUE_FIELDS = ("avail", "driver_rank", "exec_ok", "driver", "executor", "count", "app_valid")


def jax_min_frag(arrays):
    args = tuple(jnp.asarray(x) for x in arrays)
    pallas = pallas_solve_queue_min_frag(*args, interpret=True)
    scan = jax_bs.solve_queue_min_frag(*args, with_placements=False)
    return (
        tuple(np.asarray(x) for x in pallas),
        (np.asarray(scan.feasible), np.asarray(scan.driver_idx), np.asarray(scan.avail_after)),
    )


def port_min_frag(arrays):
    return tuple(x.numpy() for x in mk.fifo_queue_min_frag(*(torch.as_tensor(x) for x in arrays)))


@pytest.mark.parametrize("n", [2, 5, 31, 64, 129, 300])
def test_plain_min_frag_queue_matches_pallas_and_scan(n):
    """Raw queues: negative availability, zero-requirement dimensions
    (unbounded capacities at MF_SENT), k = 0, invalid apps."""
    rng = np.random.RandomState(2000 + n)
    for trial in range(2):
        arrays = random_queue(rng, n, 12)
        assert bs.mf_sentinel_safe(arrays[0])
        got = port_min_frag(arrays)
        pallas, scan = jax_min_frag(arrays)
        assert_same(got, pallas, f"n={n} trial {trial} vs pallas")
        assert_same(got, scan, f"n={n} trial {trial} vs solve_queue_min_frag")
        assert got[0].dtype == np.bool_ and got[1].dtype == got[2].dtype == np.int32


def _problem(rng, n_nodes, n_apps):
    metadata = random_cluster(rng, n_nodes)
    apps = [random_app(rng) for _ in range(n_apps)]
    driver_order, executor_order = orders_for(metadata, rng)
    problem = scale_problem(tensorize_cluster(metadata, driver_order, executor_order), tensorize_apps(apps))
    assert problem.ok
    return problem


def test_plain_min_frag_queue_on_tensorized_snapshots():
    """test_pallas_queue.py::test_pallas_min_frag_matches_xla, on the port."""
    rng = random.Random(424242)
    for trial in range(8):
        problem = _problem(rng, rng.randint(2, 40), rng.randint(1, 20))
        assert bs.mf_sentinel_safe(problem.avail)
        arrays = tuple(getattr(problem, f) for f in QUEUE_FIELDS)
        got = port_min_frag(arrays)
        pallas, scan = jax_min_frag(arrays)
        assert_same(got, pallas, f"trial {trial} vs pallas")
        assert_same(got, scan, f"trial {trial} vs solve_queue_min_frag")


@pytest.mark.parametrize("case", sorted(_edge_problems()))
def test_plain_min_frag_queue_edge_cases(case):
    metadata, order, apps = _edge_problems()[case]
    problem = scale_problem(tensorize_cluster(metadata, order, order), tensorize_apps(apps))
    assert problem.ok
    arrays = tuple(getattr(problem, f) for f in QUEUE_FIELDS)
    got = port_min_frag(arrays)
    pallas, scan = jax_min_frag(arrays)
    assert_same(got, pallas, f"{case} vs pallas")
    assert_same(got, scan, f"{case} vs solve_queue_min_frag")
    assert not got[0][len(apps):].any()
    assert (got[1][len(apps):] == problem.avail.shape[0]).all()


@pytest.mark.parametrize("with_placements", [True, False])
def test_batch_solver_min_frag_programs_match_jax(with_placements):
    """solve_queue_min_frag (with and without placements) and
    min_frag_capacity, element for element."""
    rng = random.Random(61 + with_placements)
    for trial in range(6):
        problem = _problem(rng, rng.randint(2, 30), rng.randint(1, 10))
        arrays = tuple(getattr(problem, f) for f in QUEUE_FIELDS)
        got = bs.solve_queue_min_frag(*(torch.as_tensor(x) for x in arrays), with_placements=with_placements)
        want = jax_bs.solve_queue_min_frag(*(jnp.asarray(x) for x in arrays), with_placements=with_placements)
        for f in got._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.shape == w.shape and (g == w).all(), f"trial {trial} {f}"
        cap = bs.min_frag_capacity(*(torch.as_tensor(x) for x in (problem.avail, problem.executor[0], problem.exec_ok)))
        want_cap = jax_bs.min_frag_capacity(*(jnp.asarray(x) for x in (problem.avail, problem.executor[0], problem.exec_ok)))
        assert (cap.numpy() == np.asarray(want_cap)).all(), f"trial {trial} capacity"


def test_min_frag_counts_matches_host_bisect():
    """test_fifo_solver.py::test_min_frag_counts_kernel_differential on the
    port: min_frag_counts reproduces minimal_fragmentation_from_capacities
    count for count (capacity ties, unbounded sentinels, the (k+max)/2
    subset attempt, k = 0, infeasible totals), and equals the JAX program
    on the same capacities (padded with empty nodes to one shape)."""
    rng = random.Random(4242)
    for trial in range(400):
        n = rng.randint(1, 24)
        caps = []
        for _ in range(n):
            r = rng.random()
            if r < 0.1:
                caps.append(0)
            elif r < 0.2:
                caps.append(bs.MF_SENT)  # unbounded (all-dims-zero requirement)
            elif r < 0.5:
                caps.append(rng.choice([1, 2, 3, 4, 5, 5, 8, 8]))  # dense ties
            else:
                caps.append(rng.randint(1, 60))
        k = rng.choice([0, 1, rng.randint(1, 30), rng.randint(1, 200)])

        host_caps = [
            NodeAndExecutorCapacity(f"n{i}", MAX_CAPACITY if c == bs.MF_SENT else c)
            for i, c in enumerate(caps)
            if c > 0
        ]
        expected, ok = ([], True) if k == 0 else packers.minimal_fragmentation_from_capacities(k, host_caps)
        got = bs.min_frag_counts(torch.tensor(caps, dtype=torch.int32), k).numpy()
        exp_counts = np.zeros(n, np.int64)
        if ok and expected:
            for name in expected:
                exp_counts[int(name[1:])] += 1
        if ok:
            assert np.array_equal(got, exp_counts), f"trial {trial}: k={k} caps={caps}"
        else:
            assert not got.any(), f"trial {trial}: nonzero counts on infeasible"
        if trial % 8 == 0:
            padded = np.zeros(24, np.int32)
            padded[:n] = caps
            want = np.asarray(jax_bs.min_frag_counts(jnp.asarray(padded), jnp.int32(k)))
            got_padded = bs.min_frag_counts(torch.as_tensor(padded), k).numpy()
            assert np.array_equal(got_padded, want), f"trial {trial} vs JAX"


def test_sentinel_guard_and_policy_codes():
    assert bs.MF_SENT == jax_bs.MF_SENT == mk.MF_SENT
    for values in ([], [0, 5, -3], [bs.MF_SENT - 1], [bs.MF_SENT], [2**31 - 1]):
        arr = np.array(values, dtype=np.int64)
        assert bs.mf_sentinel_safe(arr) == jax_bs.mf_sentinel_safe(arr), values
    for policy in ("tightly-pack", "distribute-evenly", "minimal-fragmentation", "single-az"):
        assert bs.queue_policy_code(policy) == jax_bs.queue_policy_code(policy)
    assert bs.QUEUE_POLICY_CODES == jax_bs.QUEUE_POLICY_CODES


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("strict", [True, False])
def test_min_frag_fifo_solve_matches_jax(strict, fractional):
    rng = random.Random(300 + 2 * strict + fractional)
    port = TpuFifoSolver("minimal-fragmentation", strict_reference_parity=strict, device="cpu")
    ref = JaxFifoSolver("minimal-fragmentation", backend="xla", strict_reference_parity=strict)
    for trial in range(12):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_apps=9, fractional=fractional)
        skip = [rng.random() < 0.3 for _ in japps[:-1]]
        want = ref.solve(jax_copy_metadata(jmeta), dorder, eorder, japps[:-1], skip, japps[-1])
        got = port.solve(copy_metadata(pmeta), dorder, eorder, papps[:-1], skip, papps[-1])
        _assert_outcome(got, want, f"trial {trial}")
        if want.supported and len(japps) > 1:
            assert port.last_queue_lane == "torch"


@pytest.mark.parametrize("strict", [True, False])
def test_min_frag_fifo_decisions_match_host_oracle_loop(strict):
    """test_fifo_solver.py::test_min_frag_fifo_solver_parity_random on the
    port, against the port's own min-frag oracle."""
    rng = random.Random(52525 + strict)
    solver = TpuFifoSolver("minimal-fragmentation", strict_reference_parity=strict, device="cpu")
    packer = packers.make_minimal_fragmentation_pack(strict)
    for trial in range(15):
        _, pmeta, dorder, eorder, _, papps = random_snapshot(rng, max_nodes=20, max_apps=9)
        skip = [rng.random() < 0.3 for _ in papps[:-1]]
        ok, expected = host_fifo_oracle(pmeta, dorder, eorder, papps[:-1], skip, papps[-1], packer=packer)
        out = solver.solve(pmeta, dorder, eorder, papps[:-1], skip, papps[-1])
        assert out.supported and out.earlier_ok == ok, f"trial {trial}"
        if ok:
            assert out.result.has_capacity == expected.has_capacity, f"trial {trial}"
            assert out.result.driver_node == expected.driver_node, f"trial {trial}"
            assert out.result.executor_nodes == expected.executor_nodes, f"trial {trial}"
            if expected.has_capacity:
                _effs_close(out.result.packing_efficiencies, expected.packing_efficiencies, f"trial {trial}")


def test_min_frag_sentinel_unsafe_snapshot_is_unsupported():
    """A scaled availability that could reach MF_SENT: the JAX solver and
    the port both report supported=False (the caller uses the host
    oracle)."""
    huge = str(2**31 - 2)  # bytes; a 1-byte request keeps the memory scale at 1
    pmeta = {"a": convert.metadata_from_plain(("8", huge, 0), ("8", huge, 0))}
    app = convert.app_from_plain(("1", "1", 0), ("1", "1", 0), 2)
    solver = TpuFifoSolver("minimal-fragmentation", device="cpu")
    out = solver.solve(pmeta, ["a"], ["a"], [app], [True], app)
    assert not out.supported and solver.last_queue_lane is None
    # the same snapshot under tightly-pack is tensorizable and served
    assert TpuFifoSolver("tightly-pack", device="cpu").solve(pmeta, ["a"], ["a"], [app], [True], app).supported

    from k8s_spark_scheduler_tpu.types.resources import NodeSchedulingMetadata, Resources
    from k8s_spark_scheduler_tpu.ops.sparkapp import AppDemand

    jmeta = {"a": NodeSchedulingMetadata(available=Resources.of("8", huge), schedulable=Resources.of("8", huge))}
    japp = AppDemand(Resources.of("1", "1"), Resources.of("1", "1"), 2)
    assert not JaxFifoSolver("minimal-fragmentation", backend="xla").solve(
        jmeta, ["a"], ["a"], [japp], [True], japp
    ).supported


@pytest.mark.parametrize("strict", [True, False])
def test_tpu_batch_min_frag_binpack_func_matches_jax_and_oracle(strict):
    """test_batch_parity.py::test_min_frag_device_parity_random on the port,
    and the JAX tpu-batch-minimal-fragmentation binpacker."""
    rng = random.Random(9090 + strict)
    name = "tpu-batch-minimal-fragmentation"
    port = select_binpacker(name, strict_reference_parity=strict, device="cpu")
    ref = jax_select_binpacker(name, strict_reference_parity=strict)
    assert port.name == ref.name and port.is_single_az == ref.is_single_az is False
    assert port.queue_solver.strict_reference_parity == strict
    oracle = packers.make_minimal_fragmentation_pack(strict)
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
            _effs_close(got.packing_efficiencies, other.packing_efficiencies, f"trial {trial} vs {label}")


def test_host_min_frag_oracles_match_jax():
    """The port's host min-frag oracles equal the JAX package's on the same
    snapshots, both parity modes (the strict mode's missing efficiency
    write-back included)."""
    rng = random.Random(717)
    for trial in range(20):
        jmeta, pmeta, dorder, eorder, japps, papps = random_snapshot(rng, max_apps=2)
        ja, pa = japps[0], papps[0]
        for strict in (True, False):
            got = packers.make_minimal_fragmentation_pack(strict)(
                pa.driver_resources, pa.executor_resources, pa.min_executor_count, dorder, eorder,
                copy_metadata(pmeta),
            )
            want = jax_packers.make_minimal_fragmentation_pack(strict)(
                ja.driver_resources, ja.executor_resources, ja.min_executor_count, dorder, eorder,
                jax_copy_metadata(jmeta),
            )
            assert (got.has_capacity, got.driver_node, got.executor_nodes) == (
                want.has_capacity, want.driver_node, want.executor_nodes
            ), f"trial {trial} strict={strict}"
            _effs_close(got.packing_efficiencies, want.packing_efficiencies, f"trial {trial}")


def test_min_frag_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    mk.reset_launch_counts()
    arrays = tuple(torch.as_tensor(x) for x in random_queue(np.random.RandomState(3), 40, 6))
    got = mk.fifo_queue_min_frag(*arrays)
    want = mk.solve_queue_min_frag_plain(*arrays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert set(mk.launch_counts.values()) == {0}
    meta = [x.to("meta") for x in arrays]
    with pytest.raises(ValueError):
        mk.fifo_queue_min_frag(*meta)


def _vstar_31_probes(d, in_pass, k):
    """v* as the plain version's _mf_run finds it (the Pallas kernel's 31
    probes over [1, MF_SENT])."""
    n = d.shape[0]
    *_, vstar = mk._mf_run(d, in_pass[None, :], torch.tensor(k, dtype=torch.int32),
                           torch.arange(n, dtype=torch.int32))
    return int(vstar[0])


def _subset_pass(d, k):
    """min_frag_plain's (k + max) / 2 subset of capacities d."""
    m = int(d.max())
    has_sent = bool((d == bs.MF_SENT).any())
    return (d > 0) & ((d < bs.MF_SENT) if has_sent else (d < (k + m) // 2))


VSTAR_EDGES = {
    # name: (capacities, k, pass: "all" = d > 0, "subset" = the (k+max)/2 subset)
    "m_equals_k": ([3, 5, 2, 0], 5, "all"),
    "m_is_k_minus_1": ([4, 4, 1, 0], 5, "all"),
    "k_is_1": ([1, 7, 0], 1, "all"),
    "sentinel": ([bs.MF_SENT, 3, 0], 4, "all"),
    "sentinel_subset": ([bs.MF_SENT, 3, 2, 2], 4, "subset"),
    "pass_max_1": ([1] * 10 + [0], 6, "all"),
    "subset_pass": ([10, 3, 3, 2], 4, "subset"),
    "one_class_exact": ([2, 2, 2], 6, "all"),
}


@pytest.mark.parametrize("case", sorted(VSTAR_EDGES))
def test_vstar_short_matches_31_probes_edge_cases(case):
    caps, k, which = VSTAR_EDGES[case]
    d = torch.tensor(caps, dtype=torch.int32)
    in_pass = _subset_pass(d, k) if which == "subset" else d > 0
    assert int(torch.clamp(torch.where(in_pass, d, 0), max=k).sum()) >= k > 0
    vstar, probes = mk.vstar_short(d, k, in_pass)
    assert vstar == _vstar_31_probes(d, in_pass, k), case
    m = int(torch.where(in_pass, d, 0).max())
    assert probes == 0 if m >= k else probes <= (m - 1).bit_length()


def test_vstar_short_matches_31_probes_random():
    """Seeded random passes (the full pass or the subset pass, capacities up
    to 96 with ties, zeros and sentinels, k up to 59): the short search
    finds the 31-probe v* in at most ceil(log2 m) probes, none when the
    pass's largest capacity reaches k."""
    rng = np.random.RandomState(31)
    checked = 0
    for trial in range(600):
        n = int(rng.randint(1, 40))
        caps = np.where(rng.rand(n) < 0.5, rng.randint(1, 9, size=n), rng.randint(0, 97, size=n))
        caps[rng.rand(n) < 0.05] = bs.MF_SENT
        k = int(rng.randint(1, 60))
        d = torch.as_tensor(caps.astype(np.int32))
        in_pass = _subset_pass(d, k) if rng.rand() < 0.5 else d > 0
        if not in_pass.any() or int(torch.clamp(torch.where(in_pass, d, 0), max=k).sum()) < k:
            continue
        vstar, probes = mk.vstar_short(d, k, in_pass)
        assert vstar == _vstar_31_probes(d, in_pass, k), f"trial {trial}: k={k} caps={caps.tolist()}"
        m = int(torch.where(in_pass, d, 0).max())
        assert probes == 0 if m >= k else probes <= (m - 1).bit_length(), f"trial {trial}"
        checked += 1
    assert checked >= 300


@pytest.mark.cuda
@pytest.mark.parametrize("n,a", [(2, 5), (129, 64), (4099, 64), (12345, 16), (10240, 1024)])
def test_cuda_min_frag_kernel_matches_plain(n, a):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the min-frag kernel has no CPU mode")
    arrays = tuple(torch.as_tensor(x, device="cuda") for x in random_queue(np.random.RandomState(n), n, a))
    before = mk.launch_counts["fifo_queue_min_frag"]
    got = mk.fifo_queue_min_frag(*arrays)
    want = mk.solve_queue_min_frag_plain(*arrays)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), f"n={n} a={a}"
    assert mk.launch_counts["fifo_queue_min_frag"] == before + 1
