"""Entry points: a single-device forward step and a multi-rank dry run.

The counterparts of the JAX package's root ``__graft_entry__.py``.
``entry()`` returns the flagship program (the whole-queue solve of
``GangPacker``) with example arguments sized like the bench's
configuration (1): a 32-node snapshot with a small FIFO queue.
``dryrun_multichip(n)`` spawns n ranks, shards the node axis over them
(``parallel/mesh.py``) and runs every whole-queue program once: the
mesh ``GangPacker``, both single-AZ variants, the min-frag scan, a
scaling curve over world sizes and the 10,240-node bucket held against
the unsharded program, with each rank's shard bytes.

    python -m k8s_spark_scheduler_tpu_torch.entry [--device cpu] [--n 4]

Without ``--device`` the ranks run on CUDA: NCCL when every rank has a
card of its own, gloo ranks sharing the cards otherwise.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed

from .device import DeviceLike, resolve_device


def _example_problem(n_nodes: int, n_apps: int, node_bucket: Optional[int] = None,
                     app_bucket: Optional[int] = None):
    """The reference's example snapshot from seed 0: nodes of 4-63 CPU /
    8-63 Gi free in 3 zones, apps of one 1 CPU / 2 Gi driver and 1-15
    executors of 2 CPU / 4 Gi."""
    from .ops.sparkapp import AppDemand
    from .ops.tensorize import scale_problem, tensorize_apps, tensorize_cluster
    from .types.resources import NodeSchedulingMetadata, Resources

    rng = np.random.RandomState(0)
    metadata = {}
    for i in range(n_nodes):
        metadata[f"node-{i:05d}"] = NodeSchedulingMetadata(
            available=Resources.of(str(int(rng.randint(4, 64))), f"{int(rng.randint(8, 64))}Gi"),
            schedulable=Resources.of("64", "64Gi"),
            zone_label=f"z{i % 3}",
        )
    order = sorted(metadata)
    apps = [
        AppDemand(
            driver_resources=Resources.of("1", "2Gi"),
            executor_resources=Resources.of("2", "4Gi"),
            min_executor_count=int(rng.randint(1, 16)),
        )
        for _ in range(n_apps)
    ]
    problem = scale_problem(tensorize_cluster(metadata, order, order), tensorize_apps(apps),
                            node_bucket=node_bucket, app_bucket=app_bucket)
    if not problem.ok:
        raise RuntimeError("the example snapshot is not exactly tensorizable")
    return problem


def _queue_arrays(problem):
    return (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver, problem.executor,
            problem.count, problem.app_valid)


def entry(device: DeviceLike = None):
    """(fn, example_args): the whole-queue solve (tightly-pack) and a
    32-node × 8-app problem on `device` (None = CUDA)."""
    from .ops.batch_solver import solve_queue

    dev = resolve_device(device)
    args = tuple(torch.as_tensor(x, device=dev) for x in _queue_arrays(_example_problem(32, 8)))
    return functools.partial(solve_queue, evenly=False), args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _single_az_inputs(problem):
    """3 zones (node i in zone i % 3) and 64-core / 64 Gi nodes' efficiency
    inputs, as the reference's dry run builds them."""
    nb = problem.avail.shape[0]
    idx = np.arange(nb)
    zone_masks = np.stack([idx % 3 == z for z in range(3)])
    scale_c, scale_m, scale_g = (int(s) for s in problem.scale)
    s_cpu = np.full(nb, 64 * 1000, np.int32)
    s_gpu = np.zeros(nb, np.int32)
    mem_bytes = 64 * 1024**3
    th_m = np.full(nb, -(-mem_bytes // scale_m), np.int32)
    inv_m = np.full(nb, scale_m / mem_bytes, np.float32)
    return zone_masks, (s_cpu, s_gpu, inv_m, th_m), (scale_c, scale_g)


def _equal(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.numel() and not torch.equal(g.cpu(), w.cpu()):
            raise RuntimeError(f"{what}: output {i} of the sharded program differs from the unsharded one")


def _dryrun_rank(mesh) -> dict:
    """One rank of the dry run; rank 0's facts are the run's."""
    from .models.gang_packer import GangPacker, GangPackerConfig
    from .ops import batch_solver as bs
    from .parallel.mesh import pad_to_multiple

    n, dev = mesh.size, mesh.device
    whole = functools.partial(torch.as_tensor, device=dev)
    packer = GangPacker(GangPackerConfig(use_mesh=True), mesh=mesh)
    problem = _example_problem(max(2 * n, 16), 4, node_bucket=pad_to_multiple(64, n), app_bucket=16)
    out = packer.solve(problem)
    feasible = out.feasible.cpu().numpy()
    if not feasible[:4].all():
        raise RuntimeError("tiny dry-run gangs must all fit")
    want = bs.solve_queue(*map(whole, _queue_arrays(problem)), evenly=False)
    _equal(out, want, "GangPacker(use_mesh=True)")

    # the single-AZ scans (az-aware; min-frag strict) and the min-frag scan
    # sharded over the same mesh: node-axis reductions are collectives
    arrays = _queue_arrays(problem)
    zone_masks, eff, scales = _single_az_inputs(problem)
    axis = mesh.axis(problem.avail.shape[0])
    node = [mesh.shard(x) for x in arrays[:3]]
    apps = [mesh.replicate(x) for x in arrays[3:]]
    sharded_eff = [mesh.shard(x) for x in eff]
    placed = {}
    for name, flags in (("single-az az-aware", dict(az_aware=True)),
                        ("single-az min-frag strict", dict(minfrag=True, strict=True))):
        az = bs.solve_queue_single_az(*node, mesh.shard(zone_masks, 1), *apps, *sharded_eff, *scales,
                                      axis=axis, **flags)
        if not az.feasible[:4].all():
            raise RuntimeError(f"{name} dry-run gangs must all fit")
        want = bs.solve_queue_single_az(*map(whole, arrays[:3]), whole(zone_masks), *map(whole, arrays[3:]),
                                        *map(whole, eff), *scales, **flags)
        _equal(az[:4] + (mesh.gather_nodes(az.avail_after),), want, name)
        placed[name] = int(az.feasible.sum())
    mf = bs.solve_queue_min_frag(*node, *apps, with_placements=False, axis=axis)
    if not mf.feasible[:4].all():
        raise RuntimeError("min-frag dry-run gangs must all fit")
    want = bs.solve_queue_min_frag(*map(whole, arrays), with_placements=False)
    _equal((mf.feasible, mf.driver_idx, mesh.gather_nodes(mf.avail_after)),
           (want.feasible, want.driver_idx, want.avail_after), "min-frag scan")
    placed["min-frag"] = int(mf.feasible.sum())

    # scaling curve: the same whole-queue solve at 1/2/4/... ranks over a
    # fixed 1,024-node bucket, the best of 3 steps after a warm one
    curve_bucket = pad_to_multiple(1024, n)
    sizes = [k for k in (1, 2, 4, 8, 16) if k <= n and curve_bucket % k == 0]
    curve_problem = _example_problem(512, 8, node_bucket=curve_bucket, app_bucket=16)
    curve = []
    for k in sizes:
        sub = mesh.sub(k)
        if sub is None:
            continue
        sub_packer = GangPacker(GangPackerConfig(use_mesh=True), mesh=sub)
        sub_packer.solve(curve_problem)
        _sync(dev)
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            sub_packer.solve(curve_problem)
            _sync(dev)
            reps.append((time.perf_counter() - t0) * 1e3)
        curve.append((k, min(reps)))

    # the north-star bucket through the sharded program, held against the
    # unsharded one, with each rank's shard bytes
    big_bucket = pad_to_multiple(10240, n)
    big = _example_problem(10_000, 16, node_bucket=big_bucket, app_bucket=16)
    big_arrays = _queue_arrays(big)
    big_node = [mesh.shard(x) for x in big_arrays[:3]]
    big_apps = [mesh.replicate(x) for x in big_arrays[3:]]
    # every rank has built its problem before the clock starts: the step's
    # first collective would otherwise wait for the slowest rank's build
    mesh.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev), torch.distributed.ReduceOp.SUM)
    _sync(dev)
    before = mesh.collectives
    t0 = time.perf_counter()
    out_big = bs.solve_queue(*big_node, *big_apps, evenly=False, with_placements=False,
                             axis=mesh.axis(big_bucket))
    _sync(dev)
    big_ms = (time.perf_counter() - t0) * 1e3
    big_collectives = mesh.collectives - before
    ref = bs.solve_queue(*map(whole, big_arrays), evenly=False, with_placements=False)
    _equal((out_big.feasible, out_big.driver_idx, mesh.gather_nodes(out_big.avail_after)),
           (ref.feasible, ref.driver_idx, ref.avail_after), "10,240-node bucket")
    shard_bytes = sum(t.element_size() * t.numel() for t in big_node + big_apps)
    every = mesh.all_gather(torch.tensor(shard_bytes, dtype=torch.int64, device=dev)).cpu().tolist()
    app_bytes_16 = sum(np.asarray(a).nbytes for a in big_arrays[3:])
    return {
        "ranks": n,
        "backend": mesh.backend,
        "device": str(dev),
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
        "card_bytes": torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None,
        "placed": int(feasible.sum()),
        "placed_by_program": placed,
        "curve_ms": curve,
        "big_bucket": big_bucket,
        "big_ms": big_ms,
        "big_collectives": big_collectives,
        "big_feasible": int(out_big.feasible.sum()),
        "shard_bytes": every,
        "projected_bytes": max(every) - app_bytes_16 + app_bytes_16 * (1024 // 16),
    }


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """Spawn `n_devices` ranks on `device` (None = CUDA), shard the whole
    solve over them and run one step of every program; print and return
    rank 0's facts.  CPU ranks join through gloo; CUDA ranks through NCCL
    when each has a card of its own, else through gloo with their shards
    on the cards they share."""
    from .parallel.launch import run_world

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" and n_devices <= torch.cuda.device_count() else "gloo"
    facts = run_world(_dryrun_rank, n_devices, device=dev.type, backend=backend)[0]
    where = f"{facts['ranks']} {facts['backend']} ranks on {facts['device'].split(':')[0]}"
    curve = ", ".join(f"{k}rank={ms:.1f}ms" for k, ms in facts["curve_ms"])
    print(f"sharding scaling curve (1024-node whole-queue solve, {where}): {curve}")
    if facts["card_bytes"]:
        memory = (f"= {facts['projected_bytes'] / 2**20:.2f} MiB of the card's "
                  f"{facts['card_bytes'] / 2**30:.1f} GiB ({facts['card']})")
    else:
        memory = "(CPU ranks: host memory)"
    print(
        f"10k-node bucket sharded solve: {facts['big_bucket']} nodes x 16 apps on {where}, "
        f"{facts['big_ms']:.0f} ms/step, {facts['big_collectives']} collectives, decisions identical to "
        f"the unsharded program; shard bytes/rank = {facts['shard_bytes']} "
        f"({facts['big_bucket'] // facts['ranks']} node rows a rank); projected at the 1k-app queue = "
        f"{facts['projected_bytes']:,} bytes/rank {memory}"
    )
    by = facts["placed_by_program"]
    print(
        f"dryrun_multichip OK: {facts['ranks']}-rank mesh, node axis sharded, {facts['placed']} gangs placed, "
        f"single-az scans {by['single-az az-aware']} / {by['single-az min-frag strict']} placed, "
        f"min-frag scan {by['min-frag']} placed"
    )
    return facts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--n", type=int, default=4, help="ranks of the dry run")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry OK: {int(out.feasible.sum())} feasible")
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
