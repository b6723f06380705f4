"""The port's node-axis mesh (``parallel/``, ROADMAP A.5) against the
unsharded programs and the JAX package's mesh.

Each world of k = 1, 2, 3, 4 gloo ranks on the CPU (3 makes the 64-node
bucket pad to 66) is spawned once, by a module fixture, and runs every
whole-queue program of ``ops/batch_solver.py`` under every policy with
the node axis sharded (``ShardedAxis``), and ``GangPacker(use_mesh=True)``
under both policies, on the same cases: shard-boundary cases built for
that k, raw random queues, and snapshots from ``test_batch_parity``'s
generators carried into the port through ``convert.py``.  Every output
(``feasible``, ``driver_idx``, ``zone_idx``, ``uncertain``,
``avail_after``, the placements) must equal, element for element, on
every rank: the port's unsharded program, and the JAX program sharded
over a k-device mesh of the virtual CPU devices (``tests/conftest.py``),
as ``__graft_entry__.dryrun_multichip`` shards it, or the JAX package's
``GangPacker(use_mesh=True, devices=jax.devices()[:k])``.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from k8s_spark_scheduler_tpu.models.gang_packer import GangPacker as JaxGangPacker
from k8s_spark_scheduler_tpu.models.gang_packer import GangPackerConfig as JaxGangPackerConfig
from k8s_spark_scheduler_tpu.ops import batch_solver as jax_bs
from k8s_spark_scheduler_tpu.ops.tensorize import ScaledProblem as JaxScaledProblem
from k8s_spark_scheduler_tpu.parallel import mesh as jax_meshlib
from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker, GangPackerConfig
from k8s_spark_scheduler_tpu_torch.ops import fifo_solver, tensorize
from k8s_spark_scheduler_tpu_torch.ops.batch_adapter import candidate_zone_masks
from k8s_spark_scheduler_tpu_torch.parallel import mesh as meshlib
from k8s_spark_scheduler_tpu_torch.parallel.axis import LocalAxis
from k8s_spark_scheduler_tpu_torch.parallel.launch import run_world

import torch_mesh_worker as worker
from test_torch_batch_solver import random_snapshot
from test_torch_single_az import random_single_az_queue

WORLDS = (1, 2, 3, 4)
APPS = 4  # the app bucket of every case
ZONES = 3
BIG = 2**31 - 1
POLICY_NAMES = {"tightly": "tightly-pack", "evenly": "distribute-evenly"}


def node_bucket(k: int) -> int:
    return meshlib.pad_to_multiple(64, k)


def _case(avail, rank, exec_ok, zone_of, drivers, executors, counts, valid=None, eff=None, scale=None):
    """A case dict: node arrays [N], apps [A], zone masks [3, N] from a
    zone index per node (-1: none), the single-AZ efficiency inputs."""
    avail = np.asarray(avail, np.int32)
    n = avail.shape[0]
    if eff is None:
        sched = np.maximum(avail, 0) + 4
        eff = ((sched[:, 0] * 1000).astype(np.int32), (sched[:, 2] * 1000).astype(np.int32),
               (1.0 / sched[:, 1].astype(np.float64)).astype(np.float32), sched[:, 1].astype(np.int32),
               1000, 1000)
    s_cpu, s_gpu, inv_mem, th_mem, scale_cpu, scale_gpu = eff
    zone_of = np.asarray(zone_of)
    return dict(
        avail=avail, driver_rank=np.asarray(rank, np.int32), exec_ok=np.asarray(exec_ok, bool),
        zone_masks=np.stack([zone_of == z for z in range(ZONES)]),
        drivers=np.asarray(drivers, np.int32), executors=np.asarray(executors, np.int32),
        counts=np.asarray(counts, np.int32),
        valid=np.ones(len(counts), bool) if valid is None else np.asarray(valid, bool),
        s_cpu=s_cpu, s_gpu=s_gpu, inv_mem=inv_mem, th_mem=th_mem, scale_cpu=scale_cpu, scale_gpu=scale_gpu,
        scale=np.ones(3, np.int64) if scale is None else scale, n=n,
    )


def _apps(rng, first, fill=APPS):
    """`first` (driver, executor, count) triples, then random small gangs."""
    rows = list(first)
    while len(rows) < fill:
        rows.append((rng.randint(0, 3, 3) * [1, 1, 0], rng.randint(0, 3, 3) * [1, 1, 0], rng.randint(0, 12)))
    drivers, executors, counts = zip(*rows)
    return np.array(drivers), np.array(executors), np.array(counts)


def boundary_cases(k: int):
    """Shard-boundary cases for a world of k ranks over node_bucket(k)
    rows; `b` is the first row of the second shard (the middle for k = 1)."""
    n = node_bucket(k)
    per = n // k
    b = per if k > 1 else n // 2
    rng = np.random.RandomState(100 + k)
    ids = np.arange(n)
    perm = rng.permutation(n)
    every = np.ones(n, bool)
    cases = {}

    # only the last row of shard 0 / the first row of shard 1 fits the driver
    for name, row in (("driver_last_row_of_shard", b - 1), ("driver_first_row_of_next_shard", b)):
        avail = np.tile([2, 64, 0], (n, 1))
        avail[row] = [8, 64, 0]
        cases[name] = _case(avail, perm, every, ids % ZONES,
                            *_apps(rng, [([4, 1, 0], [1, 1, 0], 3), ([4, 1, 0], [1, 2, 0], 5)]))
    # one executor a node: a tightly fill of b + 3 crosses a boundary; the
    # next gang's (2 b + 1, where it fits) two of them
    avail = np.tile([1, 4, 0], (n, 1))
    cases["fill_crosses_shards"] = _case(
        avail, ids, every, ids % ZONES,
        *_apps(rng, [([0, 0, 0], [1, 1, 0], b + 3), ([0, 0, 0], [1, 1, 0], 2 * b + 1),
                     ([0, 0, 0], [1, 1, 0], 4)]))
    # equal driver ranks on several shards: ties go to the least node id
    rank = np.full(n, BIG, np.int32)
    tied = [b - 1, b] + ([2 * per] if k >= 3 else []) + ([n - 1] if k >= 4 else [])
    rank[tied] = 0
    rank[rng.choice(np.setdiff1d(ids, tied), 5, replace=False)] = 1
    avail = np.tile([8, 64, 0], (n, 1))
    avail[tied, 0] = 6  # the driver fits a tied node once
    cases["equal_driver_ranks_across_shards"] = _case(
        avail, rank, every, ids % ZONES, *_apps(rng, [([4, 1, 0], [2, 2, 0], 6)] * 4))
    # min-frag: the v* class (capacity 3) on shard 0, the partial node
    # (capacity 1) on shard 1; the driver needs nothing and ranks first on
    # an empty node
    avail = np.tile([0, 64, 0], (n, 1))
    avail[[0, 1], 0] = 3
    avail[b, 0] = 1
    rank = perm + 1
    rank[n - 1] = 0
    cases["min_frag_partial_on_another_shard"] = _case(
        avail, rank, every, ids % ZONES,
        *_apps(rng, [([0, 0, 0], [1, 1, 0], 4), ([0, 0, 0], [1, 1, 0], 1), ([0, 0, 0], [1, 1, 0], 2)]))
    # k = 0 gangs and invalid apps among fitting ones
    avail = rng.randint(0, 12, size=(n, 3)) * [1, 4, 0]
    drivers, executors, counts = _apps(rng, [])
    counts[[0, 2]] = 0
    valid = np.ones(APPS, bool)
    valid[[1, 3]] = False
    cases["zero_executor_gangs_and_invalid_apps"] = _case(avail, perm, every, ids % ZONES, drivers, executors,
                                                          counts, valid)
    # az-aware: a gang larger than any zone falls back to the cross-zone
    # pack; zones contiguous (not aligned with the shards) and interleaved
    avail = np.tile([1, 4, 0], (n, 1))
    apps = _apps(rng, [([0, 0, 0], [1, 1, 0], n // ZONES + 4), ([0, 0, 0], [1, 1, 0], 3)])
    cases["az_aware_cross_zone_contiguous"] = _case(avail, perm, every, ids * ZONES // n, *apps)
    cases["az_aware_cross_zone_interleaved"] = _case(avail, perm, every, ids % ZONES, *apps)
    return cases, b


def random_cases(k: int):
    """Raw random queues (negative availability, no-zone nodes, BIG ranks,
    zero-requirement dims) and tensorized parity-suite snapshots."""
    n = node_bucket(k)
    cases = {}
    for i in range(1):
        (avail, rank, exec_ok, zone_id, drivers, executors, counts, valid, s_cpu, s_gpu, inv_mem, th_mem,
         scale_c, scale_g, _) = random_single_az_queue(np.random.RandomState(40 + 10 * k + i), n, APPS, ZONES)
        cases[f"raw_queue_{i}"] = _case(avail, rank, exec_ok, zone_id, drivers, executors, counts, valid,
                                        (s_cpu, s_gpu, inv_mem, th_mem, scale_c, scale_g))
    rng = random.Random(7000 + k)
    while len(cases) < 3:
        _, pmeta, d, e, _, papps = random_snapshot(rng, max_nodes=60, max_apps=APPS)
        cluster = tensorize.tensorize_cluster(pmeta, d, e)
        problem = tensorize.scale_problem(cluster, tensorize.tensorize_apps(papps), node_bucket=n, app_bucket=APPS)
        eff = fifo_solver._fused_efficiency_inputs(cluster, problem) if problem.ok else None
        if eff is None:
            continue
        zones, masks = candidate_zone_masks(d, e, pmeta, cluster.node_names, n)
        zone_of = np.full(n, -1)
        for zi in range(len(zones)):
            zone_of[masks[zi]] = zi
        cases[f"snapshot_{len(cases) - 1}"] = _case(
            problem.avail, problem.driver_rank, problem.exec_ok, zone_of, problem.driver, problem.executor,
            problem.count, problem.app_valid, eff, problem.scale)
    return cases


def jax_results(cases, k: int):
    """The JAX package's programs sharded over k virtual CPU devices."""
    devices = jax.devices()[:k]
    mesh = Mesh(np.array(devices), (jax_meshlib.NODE_AXIS,))
    node = NamedSharding(mesh, P(jax_meshlib.NODE_AXIS))
    node_mat = NamedSharding(mesh, P(jax_meshlib.NODE_AXIS, None))
    zone_mat = NamedSharding(mesh, P(None, jax_meshlib.NODE_AXIS))
    rep = NamedSharding(mesh, P())
    packers = {p: JaxGangPacker(JaxGangPackerConfig(assignment_policy=name, use_mesh=True), devices=devices)
               for p, name in POLICY_NAMES.items()}
    out = {}
    for cname, c in cases.items():
        put = jax.device_put
        nodes = (put(c["avail"], node_mat), put(c["driver_rank"], node), put(c["exec_ok"], node))
        apps = tuple(put(c[key], rep) for key in worker.APPS)
        eff = tuple(put(c[key], node) for key in worker.EFF)
        res = {}
        problem = JaxScaledProblem(avail=c["avail"], driver_rank=c["driver_rank"], exec_ok=c["exec_ok"],
                                   driver=c["drivers"], executor=c["executors"], count=c["counts"],
                                   app_valid=c["valid"], scale=c["scale"], ok=True)
        for p, packer in packers.items():
            q = packer.solve(problem)
            res[f"gang_packer_{p}"] = tuple(np.asarray(x) for x in (
                q.feasible, q.driver_idx, q.exec_counts, q.exec_capacity, q.avail_after))
        mf = jax_bs.solve_queue_min_frag(*nodes, *apps)
        res["min_frag"] = tuple(np.asarray(x) for x in (mf.feasible, mf.driver_idx, mf.avail_after, mf.exec_counts))
        for variant, flags in worker.SINGLE_AZ.items():
            z = jax_bs.solve_queue_single_az(*nodes, put(c["zone_masks"], zone_mat), *apps, *eff,
                                             jnp.int32(c["scale_cpu"]), jnp.int32(c["scale_gpu"]), **flags)
            res[f"single_az_{variant}"] = tuple(np.asarray(x) for x in z)
        out[cname] = res
    return out


def world_cases(k: int):
    boundary, b = boundary_cases(k)
    return {**boundary, **random_cases(k)}, b


@pytest.fixture(scope="module")
def launched():
    """Every world's ranks, started together when the first test of this
    file asks for a world: {k: (future of run_world, cases, b)}."""
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = {}
        for k in WORLDS:
            cases, b = world_cases(k)
            future = pool.submit(run_world, worker.rank_cases, k, device="cpu",
                                 args=(list(cases.values()), 500 + k), timeout_s=900)
            worlds[k] = (future, cases, b)
        yield worlds


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"{k}ranks")
def world(request, launched):
    """One world of k ranks (spawned once for every test of this k), the
    JAX programs on k devices and the port's unsharded programs, here."""
    k = request.param
    future, cases, b = launched[k]
    names = list(cases)
    jax_out = jax_results(cases, k)
    plain = {c: worker.programs(cases[c])[0] for c in names}
    for c in names:
        for p, name in POLICY_NAMES.items():
            q = GangPacker(GangPackerConfig(assignment_policy=name), device="cpu").solve(
                worker.scaled_problem(cases[c]))
            plain[c][f"gang_packer_{p}"] = tuple(x.numpy() for x in (q.feasible, q.driver_idx, q.avail_after))
    per_rank = future.result()
    sharded = [{c: res[i][0] for i, c in enumerate(names)} for res, _, _ in per_rank]
    spent = {c: per_rank[0][0][i][1] for i, c in enumerate(names)}
    return dict(k=k, b=b, cases=cases, names=names, sharded=sharded, spent=spent, jax=jax_out, plain=plain,
                probes=[probe for _, probe, _ in per_rank], backends={bk for _, _, bk in per_rank})


def _same(got, want, label):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, f"{label}: output {i} shape {g.shape} vs {w.shape}"
        assert (g == w).all(), f"{label}: output {i} differs at {np.argwhere(g != w)[:5].tolist()}"


def test_every_rank_is_a_gloo_rank_on_the_cpu(world):
    assert world["backends"] == {"gloo"}
    assert len(world["sharded"]) == world["k"]


def test_sharded_solve_queue_equals_unsharded_and_jax_mesh(world):
    """Tightly and evenly, with and without placements: feasible,
    driver_idx, avail_after (and exec_counts, exec_capacity)."""
    for c in world["names"]:
        for p in POLICY_NAMES:
            jax_q = world["jax"][c][f"gang_packer_{p}"]
            jax_full = (jax_q[0], jax_q[1], jax_q[4], jax_q[2], jax_q[3])
            for placements in (True, False):
                key = f"queue_{p}_{placements}"
                want = world["plain"][c][key]
                _same(want, jax_full if placements else jax_full[:3], f"{c} {key} plain vs jax mesh")
                for r, rank in enumerate(world["sharded"]):
                    _same(rank[c][key], want, f"{c} {key} rank {r}")


def test_sharded_min_frag_equals_unsharded_and_jax_mesh(world):
    for c in world["names"]:
        jax_mf = world["jax"][c]["min_frag"]
        for placements in (True, False):
            key = f"min_frag_{placements}"
            want = world["plain"][c][key]
            _same(want, jax_mf if placements else jax_mf[:3], f"{c} {key} plain vs jax mesh")
            for r, rank in enumerate(world["sharded"]):
                _same(rank[c][key], want, f"{c} {key} rank {r}")


@pytest.mark.parametrize("variant", sorted(worker.SINGLE_AZ))
def test_sharded_single_az_equals_unsharded_and_jax_mesh(world, variant):
    """feasible, zone_idx, driver_idx, uncertain, avail_after."""
    key = f"single_az_{variant}"
    for c in world["names"]:
        want = world["plain"][c][key]
        _same(want, world["jax"][c][key], f"{c} {key} plain vs jax mesh")
        for r, rank in enumerate(world["sharded"]):
            _same(rank[c][key], want, f"{c} {key} rank {r}")


@pytest.mark.parametrize("policy", sorted(POLICY_NAMES))
def test_mesh_gang_packer_equals_jax_mesh_gang_packer(world, policy):
    """GangPacker(use_mesh=True) on every rank against the JAX package's
    on k devices (placements included), and its decisions against the
    unsharded GangPacker's single queue-kernel solve (plain on the CPU)."""
    key = f"gang_packer_{policy}"
    for c in world["names"]:
        want = world["jax"][c][key]
        single = world["plain"][c][key]
        _same(single, (want[0], want[1], want[4]), f"{c} {key} unsharded vs jax mesh")
        for r, rank in enumerate(world["sharded"]):
            _same(rank[c][key], want, f"{c} {key} rank {r}")


def test_sharded_axis_reductions_equal_the_whole_axis(world):
    values, masks = worker.axis_probe(500 + world["k"], node_bucket(world["k"]))
    want = worker.local_axis_results(values, masks)
    for r, probe in enumerate(world["probes"]):
        _same(probe, want, f"rank {r}")
    # the all-BIG row's argmin is node 0; the mask that holds nowhere answers n
    assert want[4][0] == 0 and want[5][2] == node_bucket(world["k"])


def test_collectives_per_app(world):
    """The node-axis reductions each program issues per app on a mesh:
    solve_app 3 (total, argmin, fill prefix), distribute-evenly +1 (the
    executor mask's prefix with k), the min-frag drain 34 (the largest
    capacity; 31 probes of both passes at once, the first with the
    passes' totals; the class prefix with the drained sum; the partial
    node's argmin), the zone scores 1 (score and nonzero); zones and the
    az-aware cross-zone pack are solved at once.  (Gathering the outputs
    comes on top: one all-gather an output.)"""
    per_app = {"queue_tightly": 3, "queue_evenly": 4, "min_frag": 37, "single_az_tightly": 4,
               "single_az_az_aware": 4, "single_az_min_frag": 38, "single_az_min_frag_strict": 38}
    for c in world["names"]:
        for key, spent in world["spent"][c].items():
            base = next(v for p, v in per_app.items() if key.startswith(p))
            assert spent == APPS * base, (c, key, spent)


def test_boundary_cases_reach_their_boundaries(world):
    """The shard-boundary cases do what their names say (so the equality
    above covers them)."""
    plain, b, n = world["plain"], world["b"], node_bucket(world["k"])
    f, didx = plain["driver_last_row_of_shard"]["queue_tightly_True"][:2]
    assert f[0] and didx[0] == b - 1
    f, didx = plain["driver_first_row_of_next_shard"]["queue_tightly_True"][:2]
    assert f[0] and didx[0] == b
    counts = plain["fill_crosses_shards"]["queue_tightly_True"][3]
    assert counts[0, b - 1] and counts[0, b] and counts[0, b + 3] == 0
    f, didx = plain["equal_driver_ranks_across_shards"]["queue_tightly_True"][:2]
    assert didx[0] == b - 1 and didx[1] == b
    mf = plain["min_frag_partial_on_another_shard"]["min_frag_True"][3][0]
    assert mf[0] == 3 and mf[1] == 0 and mf[b] == 1
    mixed = plain["zero_executor_gangs_and_invalid_apps"]["queue_tightly_True"]
    assert mixed[0][[0, 2]].all() and mixed[3][[0, 2]].sum() == 0
    assert not mixed[0][[1, 3]].any() and (mixed[1][[1, 3]] == n).all()
    for c in ("az_aware_cross_zone_contiguous", "az_aware_cross_zone_interleaved"):
        az = plain[c]["single_az_az_aware"]
        assert az[0][0] and az[1][0] == ZONES, c  # the cross-zone fallback
        assert not plain[c]["single_az_tightly"][0][0], c


def test_pad_to_multiple_equals_the_reference():
    for n in range(0, 70):
        for d in range(1, 9):
            assert meshlib.pad_to_multiple(n, d) == jax_meshlib.pad_to_multiple(n, d)


def test_local_axis_is_the_plain_reduction():
    axis = LocalAxis(6)
    x = torch.tensor([[5, 2, 9, 2, 7, 2], [BIG] * 6], dtype=torch.int32)
    least, first = axis.argmin(x)
    assert least.tolist() == [2, BIG] and first.tolist() == [1, 0]
    assert axis.first_index(torch.zeros(6, dtype=torch.bool)).item() == 6
    scan, total = axis.cumsum(x[0], x[0])
    assert scan.tolist() == np.cumsum(x[0].numpy()).tolist() and total.item() == 27
    assert axis.cumsum(x[0]).tolist() == scan.tolist()


def test_nccl_on_the_cpu_and_cuda_without_a_card_raise():
    with pytest.raises(ValueError, match="nccl"):
        meshlib.backend_for(torch.device("cpu"), "nccl")
    with pytest.raises(ValueError, match="unsupported backend"):
        meshlib.backend_for(torch.device("cpu"), "mpi")
    assert meshlib.backend_for(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        meshlib.initialize_multihost("127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            meshlib.initialize_multihost("127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            meshlib.initialize_multihost("127.0.0.1:1", 1, 0, backend="gloo")


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        meshlib.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        GangPacker(GangPackerConfig(use_mesh=True), device="cpu")


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_world(worker.raise_on_rank_1, 2, device="cpu", timeout_s=120)
