"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never move to the CPU on their own."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "k8s_spark_scheduler_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            # exact names and their submodules; the port's own prefix
            # k8s_spark_scheduler_tpu_torch must stay importable
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    import k8s_spark_scheduler_tpu_torch
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain
    from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter
    from k8s_spark_scheduler_tpu_torch.ops.registry import select_binpacker

    meta = {
        f"n{i}": metadata_from_plain((8, "32Gi", 0), (8, "32Gi", 0), zone_label=f"z{i % 2}")
        for i in range(6)
    }
    d, e = NodeSorter().potential_nodes(meta, list(meta))
    earlier = [app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 4) for _ in range(3)]
    for policy in ("tightly-pack", "distribute-evenly"):
        solver = TpuFifoSolver(assignment_policy=policy, device="cpu")
        out = solver.solve(meta, d, e, earlier, [False] * 3,
                           app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 5))
        assert out.supported and out.earlier_ok and out.result.has_capacity, out
        assert solver.last_queue_lane == "torch"
    from k8s_spark_scheduler_tpu_torch.ops.tensorize import tensorize_apps, tensorize_cluster

    packer = GangPacker(device="cpu")
    q = packer.solve(packer.scale(tensorize_cluster(meta, d, e), tensorize_apps(earlier)))
    assert bool(q.feasible[:3].all())
    bp = select_binpacker("tpu-batch", device="cpu")
    r = bp.binpack_func(earlier[0].driver_resources, earlier[0].executor_resources, 4, d, e, meta)
    assert r.has_capacity

    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuSingleAzFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.registry import available_binpackers

    current = app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 2)
    solver = TpuFifoSolver(assignment_policy="minimal-fragmentation", device="cpu")
    out = solver.solve(meta, d, e, earlier, [False] * 3, current)
    assert out.supported and out.earlier_ok and out.result.has_capacity, out
    assert solver.last_queue_lane == "torch"
    for az_aware, inner in ((False, "tightly-pack"), (True, "tightly-pack"),
                            (False, "minimal-fragmentation")):
        solver = TpuSingleAzFifoSolver(az_aware=az_aware, inner_policy=inner, device="cpu")
        out = solver.solve(meta, d, e, earlier, [False] * 3, current)
        assert out.supported and out.earlier_ok and out.result.has_capacity, out
        assert solver.last_path == "fused"
    assert len(available_binpackers()) == 12
    for name in available_binpackers():
        bp = select_binpacker(name, device="cpu")
        r = bp.binpack_func(current.driver_resources, current.executor_resources, 2, d, e, meta)
        assert r.has_capacity, name
    bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not bad, bad
    print("ISOLATED-OK")
    """
)


def test_port_runs_with_jax_and_reference_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


def test_package_sources_import_neither_jax_nor_reference_package():
    import re

    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|k8s_spark_scheduler_tpu)(\.|\s|$)"
        r"|from\s+(jax|jaxlib|k8s_spark_scheduler_tpu)(\.|\s))",
        re.M,
    )
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "k8s_spark_scheduler_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders


def test_entry_points_default_to_cuda_and_never_fall_back():
    from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker
    from k8s_spark_scheduler_tpu_torch.ops.batch_adapter import TpuBatchBinpacker, TpuSingleAzBinpacker
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver
    from k8s_spark_scheduler_tpu_torch.ops.registry import TPU_BATCH_NAMES, select_binpacker

    constructors = (
        TpuFifoSolver,
        TpuBatchBinpacker,
        TpuSingleAzFifoSolver,
        TpuSingleAzBinpacker,
        GangPacker,
        lambda: TpuFifoSolver(device="cuda"),
        lambda: TpuFifoSolver("minimal-fragmentation"),
    ) + tuple(lambda name=name: select_binpacker(name) for name in TPU_BATCH_NAMES)
    for make in constructors:
        if torch.cuda.is_available():
            made = make()
            solver = getattr(made, "queue_solver", made)
            assert solver.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


def test_backend_must_match_device():
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver

    for solver in (TpuFifoSolver, TpuSingleAzFifoSolver):
        assert solver(backend="torch", device="cpu").backend == "torch"
        with pytest.raises(ValueError):
            solver(backend="cuda", device="cpu")
