"""Multi-host sharded solve in the port: the mirror of
``tests/test_multihost.py`` and ``test_batch_parity.py::
test_multihost_mesh_shapes``.  Separate processes, numbered host by host
(torchrun's ``LOCAL_WORLD_SIZE`` ranks a host), join one gloo process
group through ``parallel.mesh.initialize_multihost``;
``make_multihost_mesh`` gives the 1-D ``("nodes",)`` layout and the 2-D
``("hosts", "nodes")`` rank grid, and ``GangPacker(use_mesh=True)`` on
either solves the reference worker's example problem (every gang placed)
equal to the JAX package's mesh ``GangPacker``."""

import jax
import numpy as np
import pytest

import __graft_entry__ as reference_entry
from k8s_spark_scheduler_tpu.models.gang_packer import GangPacker as JaxGangPacker
from k8s_spark_scheduler_tpu.models.gang_packer import GangPackerConfig as JaxGangPackerConfig
from k8s_spark_scheduler_tpu_torch.parallel import mesh as meshlib
from k8s_spark_scheduler_tpu_torch.parallel.launch import run_world

import torch_mesh_worker as worker


@pytest.mark.parametrize("hosts,per_host", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_multihost_mesh_layouts_and_solve(hosts, per_host):
    ranks = hosts * per_host
    results = run_world(worker.multihost_rank, ranks, device="cpu", local_ranks=per_host, timeout_s=300)
    problem = reference_entry._example_problem(n_nodes=32, n_apps=4, node_bucket=64, app_bucket=16)
    want = {}
    for devices in (ranks, 8):  # the reference worker's mesh has 8 devices
        q = JaxGangPacker(JaxGangPackerConfig(use_mesh=True), devices=jax.devices()[:devices]).solve(problem)
        want[devices] = tuple(np.asarray(x) for x in (q.feasible, q.driver_idx, q.exec_counts, q.exec_capacity,
                                                      q.avail_after))
    for r, out in enumerate(results):
        assert out["rank"] == r
        assert out["flat"] == ((meshlib.NODE_AXIS,), (ranks,))
        assert out["grid"] == (("hosts", meshlib.NODE_AXIS), (hosts, per_host))
        assert tuple(out["coords"]) == divmod(r, per_host)
        for layout, got in out["solves"].items():
            assert got[0][:4].all() and int(got[0].sum()) == 4, layout  # MULTIHOST_OK 4
            for devices, w in want.items():
                for i, (g, x) in enumerate(zip(got, w)):
                    assert (g == x).all(), (layout, devices, i)


def test_local_world_size_must_divide_the_world(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide"):
        meshlib.local_world_size(4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert meshlib.local_world_size(4) == 2
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert meshlib.local_world_size(4) == 4
