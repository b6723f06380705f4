"""The class kernel's shared-memory sizing and placement rule
(``ops/class_kernel.py``: ``static_smem_bytes``, ``dynamic_smem_bytes``,
``overlay_capacity``, ``placement``), and the budget-crossing queue the
card's tests use: its class count crosses a budget in both directions at
rebuilds inside one pass.  Host only."""

import pytest
import torch

from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
from torch_class_cases import budget_crossing, crossing_budget, placements


@pytest.mark.parametrize("n", [20_480, 100_000, 10**7])
def test_static_and_dynamic_shared_memory_fit_the_block(n, monkeypatch):
    static = ck.static_smem_bytes()
    assert static == 36 * ck.THREADS + 2080 == 11_296 and static % 16 == 0
    # small fleets ask for what n classes and n overlay entries take
    assert ck.dynamic_smem_bytes(7) == 7 * 4 * (ck.CLASS_WORDS + ck.OVERLAY_WORDS)
    assert ck.dynamic_smem_bytes(0) == 4 * (ck.CLASS_WORDS + ck.OVERLAY_WORDS)
    # large ones the whole opt-in budget beside the static part
    assert ck.dynamic_smem_bytes(n) + static == ck.SMEM_LIMIT == 227 * 1024
    monkeypatch.setattr(ck, "SMEM_LIMIT", static - 1)
    assert ck.dynamic_smem_bytes(n) == 0


def test_overlay_capacity_covers_one_app_past_the_rebuild_limit():
    assert ck.overlay_capacity(7, 3) == 7
    assert ck.overlay_capacity(20_480, 7) == 512 + 7 + 2
    assert ck.overlay_capacity(100_000, 7) == 100_000 // 64 + 9
    assert ck.overlay_capacity(100_000, -4) == 100_000 // 64 + 2
    assert ck.overlay_capacity(600, 10**6) == 600


def test_placement_by_class_count():
    n, kmax = 20_480, 7
    smem = ck.dynamic_smem_bytes(n)
    ov_bytes = 4 * ck.OVERLAY_WORDS * ck.overlay_capacity(n, kmax)
    room = (smem - ov_bytes) // (4 * ck.CLASS_WORDS)
    assert ck.placement(n, 136, kmax, smem) == (True, True)
    assert ck.placement(n, room, kmax, smem) == (True, True)
    assert ck.placement(n, room + 1, kmax, smem) == (True, False)
    assert ck.placement(n, 20_417, kmax, smem) == (True, False)
    # an overlay past the budget leaves the whole budget to the classes
    big = 10**8
    assert ck.placement(big, 7000, kmax, smem) == (False, True)
    assert ck.placement(big, smem // (4 * ck.CLASS_WORDS) + 1, kmax, smem) == (False, False)


def test_budget_crossing_queue_crosses_both_ways_at_rebuilds():
    pairs, k = 1500, 100
    avail, rank, eok, packed = budget_crossing(pairs, k)
    smem = crossing_budget(pairs, k) - ck.static_smem_bytes()
    for policy in (ck.POLICY_TIGHTLY, ck.POLICY_MINFRAG):
        got = placements(avail, rank, eok, packed, policy, smem)
        classes = got["classes"]
        room = 3 * pairs // 2
        assert classes[0] == pairs + 1 and max(classes) > room
        up = next(i for i, c in enumerate(classes) if c > room)
        assert any(c <= room for c in classes[up:]), classes
        assert got["shared"] >= 2 and got["global"] >= 1
        assert got["shared"] + got["global"] == len(classes)


def test_budget_crossing_queue_matches_the_row_semantics_on_the_cpu():
    """The plain class pass over the crossing queue equals the row pass."""
    from k8s_spark_scheduler_tpu_torch.ops.fifo_session import class_pass, queue_pass

    avail, rank, eok, packed = budget_crossing(300, 40)
    planes, rank_t, eok_t = (torch.as_tensor(x) for x in (avail, rank, eok))
    for policy in (0, 1, 2):
        st = ck.ClassState(avail.shape[0], "cpu")
        got = class_pass(policy, planes, ck.candidates(rank_t), eok_t, packed, st, True)
        want = queue_pass(policy, planes, rank_t, eok_t, packed)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert st.evidence()["rebuilds"] >= 2
