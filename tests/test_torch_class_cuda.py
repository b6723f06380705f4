"""The class kernels on the card (``ops/csrc/class_kernel.cu``): on
randomized queues, each variant's launch equals its plain PyTorch version
on the CPU (outputs, checkpoints, the four evidence values) and the row
kernel on the card; a partition that crosses the
shared-memory budget at rebuilds, in both directions inside one launch,
is placed by the rule and answers the same; a class-mode session on the
card equals one on the CPU through a short delta stream, also across the
budget.  Needs a CUDA device (marked ``cuda``,
skipped without one); imports no JAX, so a machine with the card and
without JAX runs it, past the JAX-pinning conftest:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_class_cuda.py -q``."""

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
from k8s_spark_scheduler_tpu_torch.ops.fifo_session import FifoSession, class_pass, queue_pass
from torch_class_cases import budget_crossing, crossing_budget, placements

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's class kernels)")
    return torch.device("cuda")


def _problem(seed: int, n: int, a: int, odd: bool):
    """A fleet of repeated machine shapes with near-duplicates; with `odd`,
    negative availability, non-candidates, k = 0, zero requests and
    invalid apps ride along."""
    rng = np.random.RandomState(seed)
    shapes = rng.randint(8, 40, size=(6, 3)).astype(np.int32)
    avail = shapes[rng.randint(0, 6, size=n)].copy()
    near = rng.choice(n, size=max(1, n // 20), replace=False)
    avail[near, rng.randint(0, 3, size=len(near))] += 1
    rank = rng.permutation(n).astype(np.int32)
    eok = rng.rand(n) > 0.05
    packed = np.hstack([rng.randint(0, 3, size=(a, 3)), rng.randint(1, 5, size=(a, 3)),
                        rng.randint(1, 12, size=(a, 1)), np.ones((a, 1))]).astype(np.int32)
    if odd:
        avail[rng.rand(n) < 0.03] = rng.randint(-4, 3, size=3)
        rank[rng.rand(n) < 0.2] = ck.BIG
        packed[:, 6] = rng.randint(0, 12, size=a)
        packed[:, 3:6][rng.rand(a, 3) < 0.05] = 0
        packed[rng.rand(a) < 0.05, 7] = 0
    return avail, rank, eok, packed


def test_static_shared_memory_is_the_hosts_figure(card):
    assert ck.LIBRARY.load().fifo_queue_classes_static_smem() == ck.static_smem_bytes()


@pytest.mark.parametrize("policy", [0, 1, 2])
@pytest.mark.parametrize("n,a,odd", [(7, 20, True), (500, 200, True), (1500, 900, False), (3000, 300, True)])
def test_class_kernel_equals_its_plain_version_and_the_row_kernel(card, policy, n, a, odd):
    avail, rank, eok, packed = _problem(n * 7 + a, n, a, odd)
    planes, rank_t, eok_t = (torch.as_tensor(x, device=card) for x in (avail, rank, eok))
    cand = ck.candidates(rank_t)
    stride, slots = 16, 24
    chk = torch.full((slots, n, 3), -7, dtype=torch.int32, device=card)
    st = ck.ClassState(n, card)
    got = class_pass(policy, planes, cand, eok_t, packed, st, True, chk_base=3, chk_stride=stride, chk_out=chk)
    chk_cpu = torch.full((slots, n, 3), -7, dtype=torch.int32)
    st_cpu = ck.ClassState(n, "cpu")
    want = class_pass(policy, planes.cpu(), cand.cpu(), eok_t.cpu(), packed, st_cpu, True, chk_base=3,
                      chk_stride=stride, chk_out=chk_cpu)
    row = queue_pass(policy, planes, rank_t, eok_t, packed)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, row):
        assert torch.equal(g.cpu(), w) and torch.equal(g, r)
    assert torch.equal(chk.cpu(), chk_cpu)
    assert st.evidence() == st_cpu.evidence()


@pytest.mark.parametrize("policy", [0, 1, 2])
def test_class_session_on_the_card_equals_the_cpu_session(card, policy):
    avail, rank, eok, packed = _problem(policy, 2000, 600, False)
    sessions = [FifoSession(device=card), FifoSession(device="cpu")]
    for s in sessions:
        s.set_classes(True)
        s.load(avail, rank, eok, policy, stride=64)
    for queue in (packed, packed, packed[:500], packed[1:], packed[1:300]):
        got, want = (s.solve(queue) for s in sessions)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
        assert torch.equal(got[3].cpu(), want[3])
        assert sessions[0].class_stats() == sessions[1].class_stats()


def _crossing_launch(card, policy, pairs, k):
    """The crossing queue through the kernel and its plain version, and the
    row kernel, at a budget whose class room is 1.5 pairs."""
    avail, rank, eok, packed = budget_crossing(pairs, k)
    n = avail.shape[0]
    planes, rank_t, eok_t = (torch.as_tensor(x, device=card) for x in (avail, rank, eok))
    cand = ck.candidates(rank_t)
    st = ck.ClassState(n, card)
    got = class_pass(policy, planes, cand, eok_t, packed, st, True)
    st_cpu = ck.ClassState(n, "cpu")
    want = class_pass(policy, planes.cpu(), cand.cpu(), eok_t.cpu(), packed, st_cpu, True)
    row = queue_pass(policy, planes, rank_t, eok_t, packed)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, row):
        assert torch.equal(g.cpu(), w) and torch.equal(g, r)
    assert st.evidence() == st_cpu.evidence()
    return st, placements(avail, rank, eok, packed, policy, ck.dynamic_smem_bytes(n))


@pytest.mark.parametrize("policy", [0, 1, 2])
def test_partition_crosses_the_shared_memory_budget_inside_one_launch(card, policy, monkeypatch):
    pairs, k = 1500, 100
    monkeypatch.setattr(ck, "SMEM_LIMIT", crossing_budget(pairs, k))
    st, want = _crossing_launch(card, policy, pairs, k)
    # shared at the first build, global past the room, shared again
    assert want["global"] >= 1 and want["shared"] >= 2, want
    assert st.placements() == {"shared": want["shared"], "global": want["global"]}


@pytest.mark.parametrize("policy", [0, 2])
def test_overlay_past_the_budget_takes_the_global_scratch(card, policy, monkeypatch):
    """A budget below one overlay: the overlay's mirror lives in the
    state's ovx, the classes wherever they fit."""
    pairs, k = 600, 60
    n = 2 * pairs + 1
    monkeypatch.setattr(ck, "SMEM_LIMIT", ck.static_smem_bytes() + 24 * ck.overlay_capacity(n, k) - 4)
    st, want = _crossing_launch(card, policy, pairs, k)
    assert ck.placement(n, 1, k, ck.dynamic_smem_bytes(n))[0] is False
    assert st.placements() == {"shared": want["shared"], "global": want["global"]}


@pytest.mark.parametrize("policy", [0, 1, 2])
def test_class_session_across_the_budget_equals_the_cpu_session(card, policy, monkeypatch):
    """Suffix launches that start from a partition in global memory, or
    in shared memory, and rebuild across the budget."""
    pairs, k = 1500, 100
    monkeypatch.setattr(ck, "SMEM_LIMIT", crossing_budget(pairs, k))
    avail, rank, eok, packed = budget_crossing(pairs, k)
    sessions = [FifoSession(device=card), FifoSession(device="cpu")]
    for s in sessions:
        s.set_classes(True)
        s.load(avail, rank, eok, policy, stride=4)
    for queue in (packed[:9], packed[:20], packed, packed[:15], packed):
        got, want = (s.solve(queue) for s in sessions)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
        assert torch.equal(got[3].cpu(), want[3])
        assert sessions[0].class_stats() == sessions[1].class_stats()
    placed = sessions[0]._classes.placements()
    assert placed["shared"] >= 1 and placed["global"] >= 1, placed
