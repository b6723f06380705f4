"""The checkpointed queue pass the delta-solve session launches
(``queue_kernel.fifo_queue`` / ``minfrag_kernel.fifo_queue_min_frag`` with
``chk_base``, ``chk_stride`` and ``chk_out``), its plain versions on the
CPU against the JAX package:

- checkpoint j of a whole-queue pass equals ``avail_after`` of the JAX
  queue solve (``batch_solver`` on JAX's CPU backend) over the first
  (j + 1) * stride apps, for tightly-pack, distribute-evenly and minimal
  fragmentation at strides 1, 7 and 64; for one small case per policy
  against the Pallas kernels in interpret mode too.  Exact (int32).
- a suffix pass from any checkpoint equals the whole-queue pass in
  feasible, driver_idx, avail_after and the checkpoints it writes.

The JAX prefix is the whole queue with the apps past the prefix marked
invalid (an invalid app takes nothing), so one compiled program serves
every prefix.  The CUDA launches are held against the plain versions on
the card (``cuda`` marker; skipped without a GPU).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.ops import batch_solver as jax_bs
from k8s_spark_scheduler_tpu.ops.pallas_queue import pallas_solve_queue, pallas_solve_queue_min_frag
from k8s_spark_scheduler_tpu.ops.tensorize import scale_problem, tensorize_apps, tensorize_cluster
from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
from k8s_spark_scheduler_tpu_torch.ops.batch_solver import mf_sentinel_safe

from test_batch_parity import orders_for, random_app, random_cluster

POLICIES = ("tightly", "evenly", "minfrag")


def snapshot_queue(seed, n_nodes, n_apps):
    """A tensorized snapshot and queue from the shared generators, as
    numpy arrays (avail, driver_rank, exec_ok, drivers, executors,
    counts, valid), cut to n_apps apps."""
    rng = random.Random(seed)
    metadata = random_cluster(rng, n_nodes)
    apps = [random_app(rng) for _ in range(n_apps)]
    driver_order, executor_order = orders_for(metadata, rng)
    problem = scale_problem(tensorize_cluster(metadata, driver_order, executor_order), tensorize_apps(apps))
    assert problem.ok
    return (
        problem.avail, problem.driver_rank, problem.exec_ok, problem.driver[:n_apps],
        problem.executor[:n_apps], problem.count[:n_apps], problem.app_valid[:n_apps],
    )


def port_pass(policy, arrays, chk_base=0, chk_stride=0, chk_out=None):
    """(feasible, driver_idx, avail_after) of the port's wrapper on CPU
    tensors (its plain version), the checkpoints into chk_out."""
    args = tuple(torch.as_tensor(x) for x in arrays)
    chk = dict(chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out)
    if policy == "minfrag":
        return mk.fifo_queue_min_frag(*args, **chk)
    return qk.fifo_queue(*args, evenly=policy == "evenly", **chk)


def jax_prefix_after(policy, arrays, prefix, pallas=False):
    """avail_after of the JAX package's queue solve over the first
    `prefix` apps (the rest invalid)."""
    valid = np.array(arrays[6], copy=True)
    valid[prefix:] = False
    args = tuple(jnp.asarray(x) for x in arrays[:6]) + (jnp.asarray(valid),)
    if pallas:
        if policy == "minfrag":
            return np.asarray(pallas_solve_queue_min_frag(*args, interpret=True)[2])
        return np.asarray(pallas_solve_queue(*args, evenly=policy == "evenly", interpret=True)[2])
    if policy == "minfrag":
        return np.asarray(jax_bs.solve_queue_min_frag(*args, with_placements=False).avail_after)
    return np.asarray(jax_bs.solve_queue(*args, evenly=policy == "evenly", with_placements=False).avail_after)


def checkpointed_cold(policy, arrays, stride):
    """The whole-queue pass with every checkpoint: (outputs, chk [K, N, 3])."""
    n, a = arrays[0].shape[0], arrays[3].shape[0]
    chk = torch.full((max((a - 1) // stride, 1), n, 3), -7, dtype=torch.int32)
    return port_pass(policy, arrays, 0, stride, chk), chk


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stride,n_nodes,n_apps", [(1, 60, 30), (7, 300, 100), (64, 200, 200)])
def test_checkpoints_equal_jax_prefix_solves(policy, stride, n_nodes, n_apps):
    arrays = snapshot_queue(1000 * stride + n_apps + POLICIES.index(policy), n_nodes, n_apps)
    if policy == "minfrag":
        assert mf_sentinel_safe(arrays[0])
    (feasible, didx, after), chk = checkpointed_cold(policy, arrays, stride)
    plain = port_pass(policy, arrays)
    for g, w in zip((feasible, didx, after), plain):
        assert torch.equal(g, w)  # the checkpoints change nothing else
    n_chk = (n_apps - 1) // stride
    assert n_chk >= 1
    for j in range(n_chk):
        want = jax_prefix_after(policy, arrays, (j + 1) * stride)
        assert np.array_equal(chk[j].numpy(), want), f"checkpoint {j} (position {(j + 1) * stride})"


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoints_equal_pallas_prefix_solves(policy):
    arrays = snapshot_queue(77 + POLICIES.index(policy), 24, 16)
    (_, _, _), chk = checkpointed_cold(policy, arrays, 5)
    for j in range(3):
        want = jax_prefix_after(policy, arrays, (j + 1) * 5, pallas=True)
        assert np.array_equal(chk[j].numpy(), want), f"checkpoint {j}"


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stride,n_nodes,n_apps", [(1, 40, 24), (7, 120, 90), (64, 150, 200)])
def test_suffix_pass_from_any_checkpoint_equals_cold(policy, stride, n_nodes, n_apps):
    arrays = snapshot_queue(31 * stride + n_apps + POLICIES.index(policy), n_nodes, n_apps)
    (feasible, didx, after), chk = checkpointed_cold(policy, arrays, stride)
    n_chk = chk.shape[0] if n_apps > stride else 0
    for j in range(n_chk):
        r = (j + 1) * stride
        suffix = (chk[j].numpy(),) + arrays[1:3] + tuple(x[r:] for x in arrays[3:])
        chk2 = torch.full_like(chk, -7)
        f, d, a = port_pass(policy, suffix, r, stride, chk2)
        assert torch.equal(f, feasible[r:]) and torch.equal(d, didx[r:]), f"resume at {r}"
        assert torch.equal(a, after), f"resume at {r}"
        # it rewrites the checkpoint it started from and every later one,
        # and leaves the earlier slots alone
        assert torch.equal(chk2[j:], chk[j:]), f"resume at {r}"
        assert (chk2[:j] == -7).all()


def test_checkpoint_slots_past_the_buffer_are_skipped():
    arrays = snapshot_queue(5, 50, 40)
    (_, _, _), full = checkpointed_cold("tightly", arrays, 4)
    assert full.shape[0] == 9
    short = torch.full((3, arrays[0].shape[0], 3), -7, dtype=torch.int32)
    port_pass("tightly", arrays, 0, 4, short)
    assert torch.equal(short, full[:3])


def test_checkpoints_at_an_unaligned_base_and_past_invalid_apps():
    """chk_base not a multiple of the stride: the first checkpoint written
    is the first multiple after it; invalid apps pass the carry on."""
    arrays = list(snapshot_queue(9, 60, 30))
    arrays[6] = np.array(arrays[6], copy=True)
    arrays[6][::4] = False
    arrays = tuple(arrays)
    (feasible, didx, after), cold = checkpointed_cold("evenly", arrays, 6)
    assert cold.shape[0] == 4  # positions 6, 12, 18, 24
    r = 13  # resume from the planes after 13 apps
    start = np.array(jax_prefix_after("evenly", arrays, r))
    suffix = (start,) + arrays[1:3] + tuple(x[r:] for x in arrays[3:])
    chk = torch.full_like(cold, -7)
    f, d, a = port_pass("evenly", suffix, r, 6, chk)
    assert (chk[:2] == -7).all()  # positions 6 and 12 lie before the suffix
    assert torch.equal(chk[2:], cold[2:])
    assert torch.equal(f, feasible[r:]) and torch.equal(d, didx[r:]) and torch.equal(a, after)


def test_wrappers_refuse_bad_checkpoint_arguments():
    arrays = tuple(torch.as_tensor(x) for x in snapshot_queue(3, 10, 4))
    n = arrays[0].shape[0]
    with pytest.raises(ValueError):
        qk.fifo_queue(*arrays, chk_stride=0, chk_out=torch.zeros((2, n, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        mk.fifo_queue_min_frag(*arrays, chk_base=-1, chk_stride=2, chk_out=torch.zeros((2, n, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        qk.fifo_queue(*arrays, chk_stride=2, chk_out=torch.zeros((2, n + 1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        qk.fifo_queue(*arrays, chk_stride=2, chk_out=torch.zeros((2, n, 3), dtype=torch.int64))


def test_cpu_checkpointed_pass_counts_no_launch():
    qk.reset_launch_counts()
    mk.reset_launch_counts()
    arrays = snapshot_queue(4, 20, 12)
    for policy in POLICIES:
        checkpointed_cold(policy, arrays, 3)
    assert set(qk.launch_counts.values()) == {0}
    assert set(mk.launch_counts.values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n,a,stride,base", [(129, 64, 7, 0), (10240, 1000, 64, 0), (10240, 600, 64, 400)])
def test_cuda_checkpointed_launch_matches_plain(policy, n, a, stride, base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the queue kernels have no CPU mode")
    arrays = snapshot_queue(n + a + base, n, a)
    k = (base + a - 1) // stride
    chk_cpu = torch.full((k, arrays[0].shape[0], 3), -7, dtype=torch.int32)
    want = port_pass(policy, arrays, base, stride, chk_cpu)
    args = tuple(torch.as_tensor(x, device="cuda") for x in arrays)
    chk = torch.full_like(chk_cpu, -7, device="cuda")
    if policy == "minfrag":
        got = mk.fifo_queue_min_frag(*args, chk_base=base, chk_stride=stride, chk_out=chk)
    else:
        got = qk.fifo_queue(*args, evenly=policy == "evenly", chk_base=base, chk_stride=stride, chk_out=chk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(chk.cpu(), chk_cpu)
