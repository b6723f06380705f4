"""The port's spans and kernel profiler around the queue solvers: the
``fifo_gate`` and ``binpack`` spans and the ``kernel:*`` profiles the JAX
solver opens (its fifo_solver.py:421/:523/:603 and the profiler lanes)
appear under a request span, the profiler records a build (first
dispatch of a shape) then execute-only hits, and a disabled profiler
records nothing."""

import pytest

from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain
from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
from k8s_spark_scheduler_tpu_torch.metrics.registry import MetricsRegistry
from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver
from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter
from k8s_spark_scheduler_tpu_torch.tracing import Tracer
from k8s_spark_scheduler_tpu_torch.tracing import profiling


@pytest.fixture
def profiler():
    """The module-level profiler bound to a fresh registry and tracer,
    restored afterwards."""
    prof = profiling.default_profiler
    saved = (prof.metrics, prof.tracer, prof.enabled, set(prof._seen))
    metrics, tracer = MetricsRegistry(), Tracer(metrics=None)
    prof.configure(metrics=metrics, tracer=tracer, enabled=True)
    prof._seen.clear()
    yield prof, metrics, tracer
    prof.metrics, prof.tracer, prof.enabled = saved[:3]
    prof._seen.clear()
    prof._seen.update(saved[3])


def _problem():
    meta = {
        f"n{i}": metadata_from_plain((8, "32Gi", 0), (8, "32Gi", 0), zone_label=f"z{i % 2}")
        for i in range(6)
    }
    d, e = NodeSorter().potential_nodes(meta, list(meta))
    earlier = [app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 3) for _ in range(3)]
    return meta, d, e, earlier, app_from_plain(("1", "1Gi", 0), ("2", "4Gi", 0), 2)


def _names(span: dict, out=None) -> list:
    out = [] if out is None else out
    out.append(span["name"])
    for child in span.get("children", ()):
        _names(child, out)
    return out


@pytest.mark.parametrize("policy", ["tightly-pack", "distribute-evenly", "minimal-fragmentation"])
def test_solve_opens_the_reference_spans_and_profiles(profiler, policy):
    prof, metrics, tracer = profiler
    meta, d, e, earlier, current = _problem()
    solver = TpuFifoSolver(policy, device="cpu")
    kernel = "fifo_queue_min_frag" if policy == "minimal-fragmentation" else "fifo_queue"
    for _ in range(2):
        with tracer.span("predicate"):
            out = solver.solve(meta, d, e, earlier, [False] * 3, current)
        assert out.supported and out.result.has_capacity
    root = tracer.traces(limit=1)[0]["root"]
    names = _names(root)
    assert names == ["predicate", "fifo_gate", f"kernel:{kernel}", "binpack", "kernel:solve_single"]
    gate = root["children"][0]
    assert gate["tags"] == {"earlierApps": 3, "lane": "torch", "earlierOk": True}
    assert root["children"][1]["tags"]["feasible"] is True
    tags = {mnames.TAG_KERNEL: kernel, mnames.TAG_LANE: "torch"}
    # the first dispatch of the shape is the build, the second a hit
    assert metrics.get_counter(mnames.KERNEL_CACHE_MISSES, tags) == 1
    assert metrics.get_counter(mnames.KERNEL_CACHE_HITS, tags) == 1
    assert metrics.get_histogram(mnames.KERNEL_EXECUTE_TIME, tags)["count"] == 2
    assert metrics.get_histogram(mnames.KERNEL_COMPILE_TIME, tags)["count"] == 1

    # no earlier drivers: the gate span still closes, with no kernel
    with tracer.span("predicate"):
        solver.solve(meta, d, e, [], [], current)
    root = tracer.traces(limit=1)[0]["root"]
    assert _names(root) == ["predicate", "fifo_gate", "binpack", "kernel:solve_single"]
    assert root["children"][0]["tags"] == {"earlierApps": 0, "earlierOk": True}


def test_single_az_queue_kernel_is_profiled(profiler):
    prof, metrics, tracer = profiler
    meta, d, e, earlier, current = _problem()
    with tracer.span("predicate"):
        TpuSingleAzFifoSolver(device="cpu").solve(meta, d, e, earlier, [False] * 3, current)
    assert "kernel:fifo_queue_single_az" in _names(tracer.traces(limit=1)[0]["root"])
    tags = {mnames.TAG_KERNEL: "fifo_queue_single_az", mnames.TAG_LANE: "torch"}
    assert metrics.get_histogram(mnames.KERNEL_EXECUTE_TIME, tags)["count"] == 1


def test_disabled_profiler_records_nothing(profiler):
    prof, metrics, tracer = profiler
    prof.configure(enabled=False)
    meta, d, e, earlier, current = _problem()
    with tracer.span("predicate"):
        TpuFifoSolver(device="cpu").solve(meta, d, e, earlier, [False] * 3, current)
    assert "kernel:fifo_queue" not in _names(tracer.traces(limit=1)[0]["root"])
    assert metrics.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    with prof.profile("fifo_queue", lane="cuda") as rec:
        rec.sync()  # the no-op record: nothing to wait for, nothing recorded
    assert metrics.snapshot()["counters"] == {}
