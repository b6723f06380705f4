"""Queues for the class kernels' shared-memory placement (imports no JAX).

``budget_crossing`` builds a fleet whose class count rises and falls again
inside one launch, so that a partition that fits a shared-memory budget
stops fitting at a rebuild and later fits again.  ``placements`` steps the
plain version app by app and applies ``class_kernel.placement`` at every
(re)build: what the kernel must count in ``ClassState.placements()``."""

import numpy as np
import torch

from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck

CROSSING_EXECUTOR = (1, 1, 10)


def budget_crossing(pairs: int, k: int):
    """`pairs` classes of two members, (j, j, 15) for j = 1..pairs: nodes
    [0, pairs) the first members, [pairs, 2 pairs) the second ones; the
    last node is the only driver candidate (not exec_ok, so value 0).
    Every app asks k executors of (1, 1, 10) and a zero driver.  A class
    member's value is 1; a taken first member becomes (j-1, j-1, 5), value
    0, a class of its own, and the second member taken later joins it.  So
    the count goes from pairs + 1 up to 2 pairs + 1 and back to pairs + 1.
    An invalid app and a k = 0 app ride along.  (avail, rank, eok, packed)."""
    n = 2 * pairs + 1
    j = np.arange(1, pairs + 1, dtype=np.int32)
    avail = np.zeros((n, 3), np.int32)
    avail[:pairs] = np.stack([j, j, np.full(pairs, 15, np.int32)], 1)
    avail[pairs:2 * pairs] = avail[:pairs]
    avail[-1] = (1000, 1000, 1000)
    rank = np.full(n, ck.BIG, np.int32)
    rank[-1] = 0
    eok = np.ones(n, bool)
    eok[-1] = False
    a = 2 * pairs // k + 3
    packed = np.tile(np.array([0, 0, 0, *CROSSING_EXECUTOR, k, 1], np.int32), (a, 1))
    packed[1, 7] = 0
    packed[3, 6] = 0
    return avail, rank, eok, packed


def real_budget_pairs(k: int) -> int:
    """budget_crossing's pairs whose class room under the card's whole
    budget (ck.SMEM_LIMIT, the launch's block) is about 1.5 pairs (n below
    32,768, so the rebuild limit is 512)."""
    pairs = 1000
    for _ in range(4):  # the room is fixed once n is past a few thousand nodes
        n = 2 * pairs + 1
        dyn = ck.dynamic_smem_bytes(n)
        room = (dyn - 4 * ck.OVERLAY_WORDS * ck.overlay_capacity(n, k)) // (4 * ck.CLASS_WORDS)
        pairs = 2 * room // 3
    return pairs


def crossing_budget(pairs: int, k: int) -> int:
    """A SMEM_LIMIT whose class room is 1.5 pairs at budget_crossing's n."""
    n = 2 * pairs + 1
    dyn = 4 * ck.OVERLAY_WORDS * ck.overlay_capacity(n, k) + 4 * ck.CLASS_WORDS * (3 * pairs // 2)
    return ck.static_smem_bytes() + dyn


def placements(avail, rank, eok, packed, policy: int, smem_bytes: int) -> dict:
    """The kernel's placements of a launch with rebuild_first over this
    queue: the plain version stepped app by app (the same decisions and
    rebuilds), ck.placement applied at the first build and at each rebuild."""
    n = avail.shape[0]
    valid = packed[:, 7] != 0
    kmax = int(max(0, packed[valid, 6].max())) if valid.any() else 0
    st = ck.ClassState(n, "cpu")
    planes = torch.as_tensor(avail)
    cand = ck.candidates(torch.as_tensor(rank))
    eok_t = torch.as_tensor(eok)
    out = {"shared": 0, "global": 0, "classes": []}

    def note():
        nc = int(st.meta[ck.M_CLASSES])
        out["shared" if ck.placement(n, nc, kmax, smem_bytes)[1] else "global"] += 1
        out["classes"].append(nc)

    ck.queue_classes_plain(planes, cand, eok_t, torch.as_tensor(packed[:0]), st, True, policy)
    note()
    for a in range(packed.shape[0]):
        before = int(st.meta[ck.M_REBUILDS])
        _, _, planes = ck.queue_classes_plain(planes, cand, eok_t, torch.as_tensor(packed[a:a + 1]), st, False,
                                              policy)
        if int(st.meta[ck.M_REBUILDS]) > before:
            note()
    return out
