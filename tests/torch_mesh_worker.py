"""What the ranks of the mesh tests run (tests/test_torch_mesh.py,
test_torch_multihost.py).  Imports the port only, never jax: these
functions run in spawned ranks (``parallel.launch.run_world``) as well
as in the test process, unsharded."""

import numpy as np
import torch

from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker, GangPackerConfig
from k8s_spark_scheduler_tpu_torch.ops import batch_solver as bs
from k8s_spark_scheduler_tpu_torch.ops.tensorize import ScaledProblem
from k8s_spark_scheduler_tpu_torch.parallel.axis import LocalAxis

POLICIES = {"tightly": False, "evenly": True}
SINGLE_AZ = {
    "tightly": dict(),
    "az_aware": dict(az_aware=True),
    "min_frag": dict(minfrag=True, strict=False),
    "min_frag_strict": dict(minfrag=True, strict=True),
}
NODE = ("avail", "driver_rank", "exec_ok")
APPS = ("drivers", "executors", "counts", "valid")
EFF = ("s_cpu", "s_gpu", "inv_mem", "th_mem")


def _numpy(xs):
    return tuple(x.cpu().numpy() for x in xs)


def programs(case, mesh=None):
    """Every whole-queue program of ``ops/batch_solver.py`` and policy on
    one case, sharded over `mesh` (None: the whole axis on the CPU):
    {program: numpy outputs, node-axis outputs gathered whole}, and
    {program: collectives issued}."""
    if mesh is None:
        node_t = lambda x, dim=0: torch.as_tensor(x)
        whole = torch.as_tensor
        axis, gather = None, lambda x, dim=0: x
    else:
        node_t, whole = mesh.shard, mesh.replicate
        axis, gather = mesh.axis(case["avail"].shape[0]), mesh.gather_nodes
    node = [node_t(case[k]) for k in NODE]
    apps = [whole(case[k]) for k in APPS]
    eff = [node_t(case[k]) for k in EFF]
    zones = node_t(case["zone_masks"], 1)
    scales = (int(case["scale_cpu"]), int(case["scale_gpu"]))
    out, spent = {}, {}

    def count(name, before):
        if mesh is not None:
            spent[name] = mesh.collectives - before

    for policy, evenly in POLICIES.items():
        for placements in (True, False):
            before = mesh.collectives if mesh else 0
            q = bs.solve_queue(*node, *apps, evenly=evenly, with_placements=placements, axis=axis)
            count(f"queue_{policy}_{placements}", before)
            got = (q.feasible, q.driver_idx, gather(q.avail_after))
            if placements:
                got += (gather(q.exec_counts, 1), gather(q.exec_capacity, 1))
            out[f"queue_{policy}_{placements}"] = _numpy(got)
    for placements in (True, False):
        before = mesh.collectives if mesh else 0
        q = bs.solve_queue_min_frag(*node, *apps, with_placements=placements, axis=axis)
        count(f"min_frag_{placements}", before)
        got = (q.feasible, q.driver_idx, gather(q.avail_after))
        if placements:
            got += (gather(q.exec_counts, 1),)
        out[f"min_frag_{placements}"] = _numpy(got)
    for variant, flags in SINGLE_AZ.items():
        before = mesh.collectives if mesh else 0
        z = bs.solve_queue_single_az(*node, zones, *apps, *eff, *scales, axis=axis, **flags)
        count(f"single_az_{variant}", before)
        out[f"single_az_{variant}"] = _numpy(z[:4] + (gather(z.avail_after),))
    return out, spent


def scaled_problem(case) -> ScaledProblem:
    return ScaledProblem(
        avail=case["avail"], driver_rank=case["driver_rank"], exec_ok=case["exec_ok"],
        driver=case["drivers"], executor=case["executors"], count=case["counts"],
        app_valid=case["valid"], scale=case["scale"], ok=True,
    )


def gang_packer_mesh(case, mesh, policy):
    packer = GangPacker(GangPackerConfig(assignment_policy=policy, use_mesh=True), mesh=mesh)
    assert packer.mesh is mesh and packer.device == mesh.device
    q = packer.solve(scaled_problem(case))
    return _numpy((q.feasible, q.driver_idx, q.exec_counts, q.exec_capacity, q.avail_after))


def axis_probe(seed: int, n: int):
    """Random inputs of the node-axis reductions, ties across shards and
    masks that hold nowhere included: [z, n] int32 values and masks."""
    rng = np.random.RandomState(seed)
    values = rng.randint(-3, 4, size=(5, n)).astype(np.int32)
    values[0] = 2**31 - 1  # one row all BIG: argmin's index 0
    values[1, : n // 2] = 7  # the least value on the upper half only
    masks = rng.rand(5, n) < 0.1
    masks[2] = False
    return values, masks


def axis_results(axis, values, masks, gather=lambda x, dim=0: x):
    least, first = axis.argmin(values)
    scan, total, count = axis.cumsum(values, values, masks.to(torch.int32))
    return _numpy((axis.sum(values), axis.max(values), axis.min(values), least, first,
                   axis.first_index(masks), gather(scan, 1), total, count, gather(axis.iota("cpu"))))


def rank_cases(mesh, cases, probe_seed):
    """One rank of a test world: every program on every case, GangPacker
    on the mesh under both policies, the axis reductions on random data."""
    results = []
    for case in cases:
        out, spent = programs(case, mesh)
        for policy in POLICIES:
            name = "tightly-pack" if policy == "tightly" else "distribute-evenly"
            out[f"gang_packer_{policy}"] = gang_packer_mesh(case, mesh, name)
        results.append((out, spent))
    n = cases[0]["avail"].shape[0]
    values, masks = axis_probe(probe_seed, n)
    axis = mesh.axis(n)
    probe = axis_results(axis, mesh.shard(values, 1), mesh.shard(masks, 1), mesh.gather_nodes)
    return results, probe, mesh.backend


def local_axis_results(values, masks):
    return axis_results(LocalAxis(values.shape[-1]), torch.as_tensor(values), torch.as_tensor(masks))


def raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank


def multihost_rank(mesh):
    """test_multihost.py's worker on the port: both layouts of the
    multihost mesh, and the example solve on each."""
    from k8s_spark_scheduler_tpu_torch.entry import _example_problem
    from k8s_spark_scheduler_tpu_torch.parallel import mesh as meshlib

    flat = meshlib.make_multihost_mesh(device="cpu")
    grid = meshlib.make_multihost_mesh(devices_per_host_axis=True, device="cpu")
    problem = _example_problem(n_nodes=32, n_apps=4, node_bucket=64, app_bucket=16)
    solves = {}
    for name, m in (("flat", flat), ("grid", grid)):
        q = GangPacker(GangPackerConfig(use_mesh=True), mesh=m).solve(problem)
        solves[name] = _numpy((q.feasible, q.driver_idx, q.exec_counts, q.exec_capacity, q.avail_after))
    return dict(rank=flat.rank, flat=(flat.axis_names, flat.shape), grid=(grid.axis_names, grid.shape),
                coords=grid.coords, solves=solves)
