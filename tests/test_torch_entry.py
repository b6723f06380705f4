"""The port's entry points (``k8s_spark_scheduler_tpu_torch/entry.py``)
and multihost bench (``tools/multihost_bench.py``) against the JAX
package's ``__graft_entry__.py``: the example problem and ``entry()``'s
step equal the reference's, ``dryrun_multichip`` runs every check of the
reference's dry run on 2 gloo ranks on the CPU, the bench prints its JSON
line, and without ``device="cpu"`` each needs CUDA."""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as reference_entry
from k8s_spark_scheduler_tpu_torch import entry as port_entry
from k8s_spark_scheduler_tpu_torch.tools import multihost_bench

QUEUE_FIELDS = ("avail", "driver_rank", "exec_ok", "driver", "executor", "count", "app_valid", "scale")


@pytest.mark.parametrize("shape", [(32, 8, None, None), (16, 4, 64, 16), (100, 16, 102, 16),
                                   (512, 8, 1024, 16)])
def test_example_problem_equals_the_reference(shape):
    got = port_entry._example_problem(*shape)
    want = reference_entry._example_problem(*shape)
    assert got.ok and want.ok
    for field in QUEUE_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and (g == w).all(), field


def test_entry_equals_the_reference_entry():
    fn, args = port_entry.entry(device="cpu")
    jfn, jargs = reference_entry.entry()
    assert all(a.device.type == "cpu" for a in args)
    for a, j in zip(args, jargs):
        assert (a.numpy() == np.asarray(j)).all()
    got, want = fn(*args), jfn(*jargs)
    for field in got._fields:
        assert (getattr(got, field).numpy() == np.asarray(getattr(want, field))).all(), field
    assert int(got.feasible.sum()) == 8


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    facts = port_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "sharding scaling curve (1024-node whole-queue solve, 2 gloo ranks on cpu): 1rank=" in out
    assert "decisions identical to the unsharded program" in out
    assert "dryrun_multichip OK: 2-rank mesh, node axis sharded, 4 gangs placed" in out
    assert facts["backend"] == "gloo" and facts["device"] == "cpu" and facts["card_bytes"] is None
    assert [k for k, _ in facts["curve_ms"]] == [1, 2]
    assert facts["big_bucket"] == 10240 and facts["big_collectives"] == 16 * 3
    # each rank holds 5,120 node rows (avail, driver_rank, exec_ok) and the 16 apps whole
    assert facts["shard_bytes"] == [5120 * (12 + 4 + 1) + 16 * (12 + 12 + 4 + 1)] * 2
    assert facts["placed_by_program"] == {"single-az az-aware": 4, "single-az min-frag strict": 4, "min-frag": 4}


def test_multihost_bench_prints_one_json_line(capsys):
    assert multihost_bench.main(["--device", "cpu", "--nodes", "64", "--apps", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["processes"] == 2 and result["backend"] == "gloo" and result["device"] == "cpu"
    assert result["feasible"] == 4 and result["node_bucket"] == 64
    # 3 an app of the bucket (the padding apps are solved too), 3 gathers
    assert result["app_bucket"] == 16 and result["collectives_per_step"] == 16 * 3 + 3
    assert len(result["step_ms"]) == multihost_bench.STEPS


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the entry points run there")
    for call in (lambda: port_entry.entry(), lambda: port_entry.dryrun_multichip(2),
                 lambda: port_entry.main(["--n", "2"]), lambda: multihost_bench.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
