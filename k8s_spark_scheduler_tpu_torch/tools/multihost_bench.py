"""Two-process sharded solve timing.

Two processes join one process group through
``parallel.mesh.initialize_multihost`` (a TCP store on a local port),
shard the node axis of the example snapshot over the two ranks and time
``GangPacker(use_mesh=True).solve``: the first step, then 5 more.  The
ranks run on CUDA unless ``--device cpu``: NCCL when the host has a card
for each, gloo ranks sharing one card otherwise, gloo on the CPU.

    python -m k8s_spark_scheduler_tpu_torch.tools.multihost_bench [--device cpu] \\
        [--nodes 1024] [--apps 16]

Prints one JSON line (rank 0's numbers; host clock around steps that end
in a device synchronize).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

PROCESSES = 2
STEPS = 5


def _bench_rank(mesh, nodes: int, apps: int) -> dict:
    from ..entry import _example_problem, _sync
    from ..models.gang_packer import GangPacker, GangPackerConfig
    from ..parallel.mesh import pad_to_multiple

    packer = GangPacker(GangPackerConfig(use_mesh=True), mesh=mesh)
    problem = _example_problem(nodes, apps, node_bucket=pad_to_multiple(max(nodes, 64), mesh.size))
    t0 = time.perf_counter()
    out = packer.solve(problem)
    _sync(mesh.device)
    first_s = time.perf_counter() - t0
    steps = []
    before = mesh.collectives
    for _ in range(STEPS):
        t0 = time.perf_counter()
        out = packer.solve(problem)
        _sync(mesh.device)
        steps.append((time.perf_counter() - t0) * 1e3)
    return {
        "processes": mesh.size,
        "backend": mesh.backend,
        "device": torch.cuda.get_device_name(mesh.device) if mesh.device.type == "cuda" else "cpu",
        "nodes": nodes,
        "node_bucket": int(problem.avail.shape[0]),
        "apps": apps,
        "app_bucket": int(problem.driver.shape[0]),
        "feasible": int(out.feasible.sum()),
        "collectives_per_step": (mesh.collectives - before) // STEPS,
        "first_s": first_s,
        "step_ms_best": min(steps),
        "step_ms": steps,
    }


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..parallel.launch import run_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--apps", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = "nccl" if dev.type == "cuda" and PROCESSES <= torch.cuda.device_count() else "gloo"
    result = run_world(_bench_rank, PROCESSES, device=dev.type, backend=backend,
                       args=(args.nodes, args.apps), timeout_s=args.timeout)[0]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
