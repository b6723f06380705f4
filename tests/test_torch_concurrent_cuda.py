"""The concurrent engine's speculations on the card: threads that
speculate at once, each launching its queue kernel on its own CUDA
stream, reach the verdicts a ``device="cpu"`` server reaches with the
plain versions.  Needs a CUDA device (marked ``cuda``, skipped without
one); imports no JAX, so a machine with the card and without JAX runs
it, past the JAX-pinning conftest:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_concurrent_cuda.py -q``."""

import threading

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu_torch.config import ConcurrentConfig, FifoConfig, Install
from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly", "tpu-batch-minimal-fragmentation")
THREADS = 4


def _scene(h, seed: int = 5, n_nodes: int = 40, n_queued: int = 30):
    """Seeded nodes in two zones, queued drivers and the driver to
    speculate on; returns (that driver, node names)."""
    rng = np.random.RandomState(seed)
    names = [f"n{i}" for i in range(n_nodes)]
    for i, name in enumerate(names):
        h.new_node(name, cpu=str(int(rng.randint(4, 17))), memory=f"{int(rng.randint(8, 33))}Gi",
                   zone=f"zone{i % 2}")
    for i in range(n_queued):
        h.create_pod(h.static_allocation_spark_pods(
            f"queued-{i}", int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 4))),
            creation_timestamp=1000.0 + i)[0])
    current = h.static_allocation_spark_pods(
        "current", int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 3))),
        creation_timestamp=1000.0 + n_queued)[0]
    return h.create_pod(current), names


def _fields(verdict):
    o, art = verdict.outcome, verdict.artifacts
    r = o.result
    return (o.supported, o.earlier_ok, r.has_capacity, r.driver_node, tuple(r.executor_nodes),
            dict(verdict.zones), verdict.skip_allowed,
            np.asarray(art.feasible)[: art.n_earlier].tolist(),
            torch.as_tensor(art.avail_after).cpu()[: len(verdict.node_names)].tolist())


def _side_streams() -> set:
    """The handles of the non-default CUDA streams the queue kernels
    launched on since their counts were reset."""
    default = torch.cuda.default_stream().cuda_stream if torch.cuda.is_available() else 0
    return {h for counts in (qk.stream_launch_counts, mk.stream_launch_counts) for h in counts if h != default}


def _verdicts(device: str, policy: str, n_threads: int):
    """The verdicts of ``n_threads`` threads speculating on one driver at
    once, and the non-default streams their kernels launched on."""
    install = Install(fifo=True, fifo_config=FifoConfig(), binpack_algo=policy,
                      concurrent=ConcurrentConfig(enabled=True))
    h = Harness(extra_install=install, device=device)
    try:
        pod, names = _scene(h)
        spec = h.server.concurrent.speculator
        qk.reset_launch_counts()
        mk.reset_launch_counts()
        out = [None] * n_threads
        barrier = threading.Barrier(n_threads)

        def worker(i):
            barrier.wait()
            out[i] = spec.speculate(i, ExtenderArgs(pod=pod, node_names=names))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        return [_fields(v) for v in out], _side_streams()
    finally:
        h.close()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_per_thread_streams_give_the_cpu_verdicts(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the queue kernels have no CPU mode")
    on_card, streams = _verdicts("cuda", policy, THREADS)
    on_cpu, none = _verdicts("cpu", policy, 1)
    assert len(streams) == THREADS and not none
    assert all(fields == on_cpu[0] for fields in on_card)
