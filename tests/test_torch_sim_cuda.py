"""The port's simulator on the card: the same scenario and seed give the
same event log and digest on CUDA (the queue kernels) as on the CPU (their
plain versions), under the three tensor-lane policies, with speculations
and a kernel fault.  Needs a CUDA device (marked ``cuda``, skipped without
one); imports no JAX, so a machine with the card and without JAX runs it,
past the JAX-pinning conftest:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_sim_cuda.py -q``."""

import json
import os

import pytest
import torch

from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device (the port's queue kernels)"),
]

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "sim")


def _example(name: str, **overrides) -> dict:
    with open(os.path.join(EXAMPLES, f"{name}.json")) as f:
        d = json.load(f)
    d.update(overrides)
    return d


def _both(spec: dict):
    for module in (qk, mk):
        module.reset_launch_counts()
    cuda = Simulation(Scenario.from_dict(spec), device="cuda").run()
    launches = {**qk.launch_counts, **mk.launch_counts}
    cpu = Simulation(Scenario.from_dict(spec), device="cpu").run()
    assert cuda.violations == [] and cpu.violations == []
    first = next((i for i, (a, b) in enumerate(zip(cuda.event_log, cpu.event_log)) if a != b), None)
    assert first is None, (first, cuda.event_log[first], cpu.event_log[first])
    assert cuda.digest == cpu.digest
    return cuda, launches


@pytest.mark.parametrize("binpack_algo, kernel", [
    ("tpu-batch", "fifo_queue_tightly"),
    ("tpu-batch-distribute-evenly", "fifo_queue_evenly"),
    ("tpu-batch-minimal-fragmentation", "fifo_queue_min_frag"),
])
def test_smoke_on_the_card_equals_the_cpu(binpack_algo, kernel):
    result, launches = _both(_example("smoke", binpack_algo=binpack_algo))
    assert result.summary["queue_depth"]["max"] > 0
    assert launches[kernel + "_checkpointed"] > 0, launches


def test_concurrent_example_on_the_card_equals_the_cpu_and_the_serial_run():
    result, _ = _both(_example("concurrent"))
    serial = {k: v for k, v in _example("concurrent").items() if k != "concurrent"}
    assert Simulation(Scenario.from_dict(serial), device="cuda").run().digest == result.digest


def test_kernel_fault_on_the_card_equals_the_cpu():
    spec = _example("smoke", binpack_algo="tpu-batch")
    spec["faults"] = [{"at": 60, "kind": "kernel_fault", "duration": 90}]
    result, _ = _both(spec)
    assert "error" in {d["outcome"] for e in result.event_log for d in e["decisions"]}
