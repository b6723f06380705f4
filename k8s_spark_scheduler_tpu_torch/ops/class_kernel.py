"""Class-compressed whole-FIFO-queue pass: a hand-written CUDA kernel
(``csrc/class_kernel.cu``) and its plain PyTorch version.

It replaces no Pallas kernel.  It is the port's counterpart of the
reference package's native class solver (``native/fifo_solver.cpp``:
``class_rebuild``, ``class_absorb``, ``step_app_plain_classes``,
``step_app_minfrag_classes``, ``fifo_solve_queue_classes`` and the
session's class mode), which the port may not carry as a host lane.
Above ``classes.min-nodes`` nodes the delta-solve session steps a queue
by node class instead of node by node; the decisions and the planes after
are byte for byte those of the row kernels (``queue_kernel.fifo_queue``,
``minfrag_kernel.fifo_queue_min_frag``), only the cost changes.

The partition rule is the reference's exactly: nodes with equal
``(a0, a1, a2, exec_ok)`` form one class; a node that a placement wrote
(an executor's host or the driver's node) leaves its class for the
overlay; the partition is rebuilt from the planes when the overlay holds
more than ``max(512, nb // 64)`` nodes.  So its evidence (classes at the
initial partition, rebuilds, overlay peak, classes at the last rebuild)
follows from the rule and the decisions and equals the reference's.

How a step runs, in both versions:

1. each class's value for the app (the clamped executor capacity, or the
   unclamped one under minimal fragmentation) once per class, each
   overlay node's from its planes; the capacity total weights a class by
   its live members;
2. the driver probe walks the candidates in (rank, node) order, a block's
   width at a time, and stops at the first chunk that holds a fit;
3. the fill (or the min-frag drain's takes) walks node ids upward from a
   start no higher than the first node it may take: every class keeps a
   lower bound ``lb`` of its first live member, and the start is the
   least bound among the classes (and overlay nodes) that hold the value
   it looks for.  A node's value there is its class's, its overlay entry's
   or, on the driver's node, the driver-adjusted one;
4. the nodes it wrote leave their classes for the overlay (``absorb``);
   the bounds of the classes it walked through rise past its last take.

The min-frag drain never simulates a failing attempt: a drain over the
values below ``bound`` succeeds exactly when their capacities sum to k or
more, so that sum decides which attempt places, and only that one runs.

State lives in a :class:`ClassState` (device tensors, one per session):
the node -> class map (-1: overlay), one 8-int record a class (its triple,
exec_ok, live members, ``lb``, this app's value), the overlay's node ids
(unordered), per-node scratch, the rebuild's hash table and the evidence
counters.  Class ids are internal: the kernel numbers classes in the order
its threads find them, the plain version by ``torch.unique``.  The kernel
holds the partition in shared memory while a launch runs, when it fits
(:func:`placement`), and writes it back to the state at the launch's end;
the two counters past the evidence count its placements in shared and in
global memory (the plain version leaves them 0).

``fifo_queue_classes`` (tightly-pack, distribute-evenly) and
``fifo_queue_min_frag_classes`` are the wrappers: a tensor on the CPU
takes the plain version, a CUDA tensor launches the kernel, anything else
raises; there is no fallback.  Both take the session's packed rows
``[A, 8]`` (d0..2 e0..2 count valid) and the checkpoint arguments of
``queue_kernel.fifo_queue``.  ``candidates`` orders the driver candidates
once per basis (``torch.argsort``, input layout outside the per-app chain,
as the reference's ``build_cand`` sorts on the host).

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes, under
``<package>/_build`` (listed in .gitignore).  It runs as one block of
``THREADS`` threads with :func:`dynamic_smem_bytes` of dynamic shared
memory (``SMEM_LIMIT`` in all, static part included).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import KernelLibrary, check_tensor
from .queue_kernel import check_checkpoints, count_launch, reset_counts, write_checkpoint

BIG = 2**31 - 1
MF_SENT = 2**31 - 2
POLICY_TIGHTLY, POLICY_EVENLY, POLICY_MINFRAG = 0, 1, 2

# the fields of a class record (ClassState.cls rows)
A0, A1, A2, EOK, LIVE, LB, VAL = range(7)
CLS_FIELDS = 8
# the fields of ClassState.meta
(M_CLASSES, M_OVERLAY, M_CLASSES_LAST, M_REBUILDS, M_OVERLAY_PEAK, M_CLASSES_INITIAL, M_SHARED_PLACEMENTS,
 M_GLOBAL_PLACEMENTS) = range(8)
META_FIELDS = 8

# the kernel's block and shared memory (csrc/class_kernel.cu's head)
THREADS = 256  # the kernel's block (csrc/class_kernel.cu kThreads)
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a Hopper block may opt in to, static part included
CLASS_WORDS = 7  # int32 words a class takes in shared memory: a0 a1 a2 exec_ok live lb value
OVERLAY_WORDS = 6  # int32 words an overlay entry takes: node a0 a1 a2 exec_ok value
OVX_FIELDS = 5  # ClassState.ovx rows: the overlay's a0 a1 a2 exec_ok value where it does not fit


def overlay_limit(n: int) -> int:
    """The overlay size past which the partition is rebuilt (the
    reference's ``max(512, nb / 64)``)."""
    return max(512, n // 64)


def static_smem_bytes() -> int:
    """The kernel's static shared memory, sizeof(Shared<THREADS>): two
    buffers of candidate records, the first candidates' ids, the reduction
    buffers, six scalars."""
    return 36 * THREADS + 2080


def dynamic_smem_bytes(n: int) -> int:
    """The dynamic shared memory a launch over n nodes asks for: room for
    n classes and n overlay entries, capped at what the block may hold
    beside its static part (SMEM_LIMIT in all)."""
    need = 4 * (CLASS_WORDS + OVERLAY_WORDS) * max(n, 1)
    return max(0, min(need, SMEM_LIMIT - static_smem_bytes()))


def overlay_capacity(n: int, kmax: int) -> int:
    """The overlay entries an app can reach: the rebuild limit, plus the
    nodes one app writes (at most k executors' hosts and the driver's
    node), at most n."""
    return min(max(n, 1), overlay_limit(n) + max(kmax, 0) + 2)


def placement(n: int, nclasses: int, kmax: int, smem_bytes: int) -> Tuple[bool, bool]:
    """Where the kernel keeps the partition, as it decides at the launch's
    start (the overlay) and at each (re)build (the classes): (overlay in
    shared memory, classes in shared memory).  `kmax` is the launch's
    largest k over its valid apps, `smem_bytes` its dynamic shared memory."""
    ov_bytes = 4 * OVERLAY_WORDS * overlay_capacity(n, kmax)
    ov_shared = ov_bytes <= smem_bytes
    room = (smem_bytes - (ov_bytes if ov_shared else 0)) // (4 * CLASS_WORDS)
    return ov_shared, nclasses <= room


def table_size(n: int) -> int:
    """The rebuild's hash table: a power of two at least 2n, at least 16."""
    size = 16
    while size < 2 * n:
        size <<= 1
    return size


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fifo_queue_classes_launch.argtypes = [
        p, p, i, p, p, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p, i, p,
    ]
    lib.fifo_queue_classes_launch.restype = ctypes.c_int
    lib.fifo_queue_classes_static_smem.argtypes = []
    lib.fifo_queue_classes_static_smem.restype = ctypes.c_int


LIBRARY = KernelLibrary("class_kernel.cu", _declare)

# kernel launches per variant, counted by the wrappers where they launch
launch_counts = {
    "fifo_queue_classes_tightly": 0,
    "fifo_queue_classes_evenly": 0,
    "fifo_queue_min_frag_classes": 0,
}
# the same launches by the raw handle of the CUDA stream they went on
stream_launch_counts = {}

KERNEL_NAMES = {
    POLICY_TIGHTLY: "fifo_queue_classes_tightly",
    POLICY_EVENLY: "fifo_queue_classes_evenly",
    POLICY_MINFRAG: "fifo_queue_min_frag_classes",
}


def reset_launch_counts() -> None:
    reset_counts(launch_counts, stream_launch_counts)


class ClassState:
    """The class partition of one node axis of n nodes, on `device`, and
    its evidence counters; see the module docstring.  ``meta`` carries
    the counters over from an earlier state (a session reloaded with
    another node count keeps its lifetime counters, as the reference's
    ClassSolver does)."""

    def __init__(self, n: int, device, meta: Optional[torch.Tensor] = None):
        device = torch.device(device)
        m = max(n, 1)
        self.n = n
        i32 = dict(dtype=torch.int32, device=device)
        self.node_cls = torch.full((m,), -1, **i32)
        self.cls = torch.zeros((m, CLS_FIELDS), **i32)
        self.ov = torch.zeros((m,), **i32)
        self.node_val = torch.zeros((m,), **i32)
        self.slot = torch.zeros((m,), **i32)
        self.table = torch.full((table_size(n),), -1, **i32)
        self.ovx = torch.zeros((OVX_FIELDS * m,), **i32)
        if meta is None:
            self.meta = torch.zeros((META_FIELDS,), dtype=torch.int64, device=device)
        else:
            self.meta = meta.to(device=device, dtype=torch.int64).clone()
        self.device = self.node_cls.device  # "cuda" resolved to its index

    def counters(self) -> list:
        return [int(x) for x in self.meta.tolist()]

    def evidence(self) -> dict:
        """The stateless pass's evidence (native ``out_stats``)."""
        m = self.counters()
        return {
            "classes_initial": m[M_CLASSES_INITIAL],
            "rebuilds": m[M_REBUILDS],
            "overlay_peak": m[M_OVERLAY_PEAK],
            "classes_last": m[M_CLASSES_LAST],
        }

    def stats(self) -> dict:
        """The session's class stats (native ``fifo_sess_class_stats``)."""
        m = self.counters()
        return {
            "classes_last": m[M_CLASSES_LAST],
            "rebuilds": m[M_REBUILDS],
            "overlay_peak": m[M_OVERLAY_PEAK],
            "overlay_now": m[M_OVERLAY],
        }

    def placements(self) -> dict:
        """The kernel's placements of the partition so far (each launch's
        start and each rebuild): in shared memory, in global memory."""
        m = self.counters()
        return {"shared": m[M_SHARED_PLACEMENTS], "global": m[M_GLOBAL_PLACEMENTS]}

    def tensors(self) -> tuple:
        return (self.node_cls, self.cls, self.ov, self.node_val, self.slot, self.table, self.ovx, self.meta)

    def mem_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.tensors()))


def candidates(driver_rank: torch.Tensor) -> torch.Tensor:
    """The driver candidates (rank < BIG) in (rank, node) order, int32, on
    driver_rank's device: the order the row kernels' (rank, node) minimum
    picks in."""
    order = torch.argsort(driver_rank, stable=True)
    m = int((driver_rank < BIG).sum())
    return order[:m].to(torch.int32).contiguous()


# ---- the plain version ---------------------------------------------------------


def _clamped_cap(a: torch.Tensor, e, k: int) -> torch.Tensor:
    """native clamped_cap on rows a [..., 3]: the executor capacity in
    [0, k] (a zero request is unbounded unless the availability is
    negative; a negative request divides by 1), int64."""
    cap = None
    for j in range(3):
        aj = a[..., j].long()
        if e[j] == 0:
            c = torch.where(aj >= 0, BIG, 0)
        else:
            c = torch.where(aj <= 0, 0, torch.div(aj, max(e[j], 1), rounding_mode="trunc"))
        cap = c if cap is None else torch.minimum(cap, c)
    return torch.clamp(torch.clamp(cap, max=k), min=0)


def _mf_cap(a: torch.Tensor, e) -> torch.Tensor:
    """native mf_cap_one on rows a [..., 3]: the unclamped executor
    capacity of the min-frag drain (MF_SENT unbounded), at least 0, int64."""
    cap = None
    for j in range(3):
        aj = a[..., j].long()
        if e[j] == 0:
            c = torch.where(aj >= 0, MF_SENT, 0)
        else:
            c = torch.div(aj, max(e[j], 1), rounding_mode="floor")
        cap = c if cap is None else torch.minimum(cap, c)
    return torch.clamp(torch.clamp(cap, max=MF_SENT), min=0)


def _rebuild_plain(st: ClassState, planes: torch.Tensor, exec_ok: torch.Tensor) -> None:
    """class_rebuild: the partition from the planes, the overlay emptied."""
    n = planes.shape[0]
    keys = torch.cat([planes.long(), exec_ok.long()[:, None]], 1)
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    nc = uniq.shape[0]
    st.cls[:nc, A0:A2 + 1] = uniq[:, :3].to(torch.int32)
    st.cls[:nc, EOK] = uniq[:, 3].to(torch.int32)
    st.cls[:nc, LIVE] = torch.bincount(inv, minlength=nc).to(torch.int32)
    lb = torch.full((nc,), BIG, dtype=torch.int64)
    lb.scatter_reduce_(0, inv, torch.arange(n), reduce="amin")
    st.cls[:nc, LB] = lb.to(torch.int32)
    st.cls[:nc, VAL] = 0
    st.node_cls[:n] = inv.to(torch.int32)
    st.meta[M_CLASSES] = nc
    st.meta[M_OVERLAY] = 0
    st.meta[M_CLASSES_LAST] = nc
    st.meta[M_REBUILDS] += 1


class _Step:
    """One app's step over the partition (the plain version)."""

    def __init__(self, st: ClassState, planes, exec_ok, cand, row, policy):
        self.st, self.planes, self.exec_ok, self.cand = st, planes, exec_ok, cand
        self.d, self.e, self.k = row[0:3], row[3:6], row[6]
        self.policy = policy
        self.n = planes.shape[0]
        self.nc = int(st.meta[M_CLASSES])
        self.didx = -1
        self.didx_value = 0  # the driver's node's value: cap'_d, or min-frag's dval
        self.didx_taken = False

    def value(self, a):
        return _mf_cap(a, self.e) if self.policy == POLICY_MINFRAG else _clamped_cap(a, self.e, self.k)

    def values(self):
        """Step 1: each class's value (into its record) and each overlay
        node's (into node_val).  Returns (class values, overlay ids,
        overlay values), int64."""
        st = self.st
        rep = st.cls[: self.nc]
        cv = torch.where(rep[:, EOK] != 0, self.value(rep[:, A0:A2 + 1]), 0)
        st.cls[: self.nc, VAL] = cv.to(torch.int32)
        ov = st.ov[: int(st.meta[M_OVERLAY])].long()
        ovv = torch.where(self.exec_ok[ov], self.value(self.planes[ov]), 0)
        st.node_val[ov] = ovv.to(torch.int32)
        return cv, ov, ovv

    def node_values(self, lo: int) -> torch.Tensor:
        """hv(i) for nodes [lo, n): the class's value for a class member,
        the overlay entry's for an overlay node, the driver-adjusted value
        on the driver's node (0 once it was taken)."""
        st = self.st
        c = st.node_cls[lo : self.n].long()
        v = torch.where(c >= 0, st.cls[:, VAL].long()[c.clamp(min=0)], st.node_val[lo : self.n].long())
        if lo <= self.didx:
            v[self.didx - lo] = 0 if self.didx_taken else self.didx_value
        return v

    def node_value(self, idx: torch.Tensor) -> torch.Tensor:
        st = self.st
        c = st.node_cls[idx].long()
        return torch.where(c >= 0, st.cls[:, VAL].long()[c.clamp(min=0)], st.node_val[idx].long())

    def probe(self, total: int, clamp: bool):
        """Step 2: the first candidate in rank order that takes the driver
        and leaves k executors of capacity: (didx, cap'_d) or (-1, 0)."""
        k, d = self.k, self.d
        if total < k or self.cand.numel() == 0:
            return -1, 0
        a = self.planes[self.cand]
        fits = (a[:, 0] >= d[0]) & (a[:, 1] >= d[1]) & (a[:, 2] >= d[2])
        am = a - torch.tensor(d, dtype=torch.int32)  # wraps, as the reference's int32
        cwd = torch.where(fits & self.exec_ok[self.cand], _clamped_cap(am, self.e, k), 0)
        capi = self.node_value(self.cand.long())
        if clamp:
            capi = torch.clamp(capi, 0, k)
        ok = torch.nonzero(fits & (total - capi + cwd >= k))
        if ok.numel() == 0:
            return -1, 0
        first = int(ok[0, 0])
        return int(self.cand[first]), int(cwd[first])

    def absorb(self, idx: torch.Tensor) -> None:
        """Nodes written this app leave their classes for the overlay."""
        st = self.st
        c = st.node_cls[idx].long()
        moving = idx[c >= 0]
        cm = c[c >= 0]
        if moving.numel():
            st.cls[:, LIVE] -= torch.bincount(cm, minlength=st.cls.shape[0]).to(torch.int32)
            st.node_cls[moving] = -1
            nov = int(st.meta[M_OVERLAY])
            st.ov[nov : nov + moving.numel()] = moving.to(torch.int32)
            st.meta[M_OVERLAY] = nov + moving.numel()
        st.node_val[idx] = 0
        if bool((idx == self.didx).any()):
            self.didx_taken = True

    def take(self, lo: int, select, weight, limit: int) -> int:
        """Step 3: walking nodes [lo, n) upward, take each selected node
        while the weights of the selected nodes before it sum below
        `limit`: subtract one executor from it, absorb it.  Returns the
        last node taken (-1: none)."""
        if lo >= self.n or limit <= 0:
            return -1
        v = self.node_values(lo)
        sel = select(v)
        w = torch.where(sel, weight(v), 0)
        excl = torch.cumsum(w, 0) - w
        idx = torch.nonzero(sel & (excl < limit)).flatten() + lo
        if idx.numel() == 0:
            return -1
        self.planes[idx] -= torch.tensor(self.e, dtype=torch.int32)
        self.absorb(idx)
        return int(idx[-1])

    def raise_bounds(self, classes: torch.Tensor, last: int) -> None:
        """No live member of these classes lies at or below `last` any more."""
        if last >= 0:
            lb = self.st.cls[: self.nc, LB]
            self.st.cls[: self.nc, LB] = torch.where(classes, torch.clamp(lb, min=last + 1), lb)

    def finish(self) -> int:
        """The driver row unless the driver's node hosts an executor, then
        the overlay bound."""
        if not self.didx_taken:
            self.planes[self.didx] -= torch.tensor(self.d, dtype=torch.int32)
            self.absorb(torch.tensor([self.didx]))
        st = self.st
        st.meta[M_OVERLAY_PEAK] = max(int(st.meta[M_OVERLAY_PEAK]), int(st.meta[M_OVERLAY]))
        if int(st.meta[M_OVERLAY]) > overlay_limit(self.n):
            _rebuild_plain(st, self.planes, self.exec_ok)
        return self.didx

    # -- tightly-pack / distribute-evenly ------------------------------------

    def plain(self) -> int:
        st, k = self.st, self.k
        cv, ov, ovv = self.values()
        live = st.cls[: self.nc, LIVE].long()
        total = int((cv * live).sum()) + int(ovv.sum())
        self.didx, self.didx_value = self.probe(total, clamp=False)
        if self.didx < 0:
            return -1
        if k > 0:
            starts = [int(st.cls[: self.nc, LB][(cv > 0) & (live > 0)].min()) if ((cv > 0) & (live > 0)).any()
                      else BIG]
            if (ovv > 0).any():
                starts.append(int(ov[ovv > 0].min()))
            lo = min(starts + [self.didx])
            evenly = self.policy == POLICY_EVENLY
            last = self.take(lo, lambda v: v > 0, (lambda v: torch.ones_like(v)) if evenly else (lambda v: v), k)
            self.raise_bounds(cv > 0, last)
        return self.finish()

    # -- minimal fragmentation ------------------------------------------------

    def holders(self):
        """The nodes that may take executors, as (values, multiplicities,
        start nodes): the classes with live members other than the driver's
        node, the overlay nodes but the driver's node, the driver's node
        with its own value until it is taken."""
        st = self.st
        rep = st.cls[: self.nc]
        live = rep[:, LIVE].long()
        dc = int(st.node_cls[self.didx])
        if dc >= 0:
            live = live.clone()
            live[dc] -= 1
        keep = live > 0
        vals = [rep[keep, VAL].long()]
        mult = [live[keep]]
        start = [rep[keep, LB].long()]
        ov = st.ov[: int(st.meta[M_OVERLAY])].long()
        ov = ov[ov != self.didx]
        vals.append(st.node_val[ov].long())
        mult.append(torch.ones_like(ov))
        start.append(ov)
        if not self.didx_taken:
            vals.append(torch.tensor([self.didx_value]))
            mult.append(torch.ones(1, dtype=torch.int64))
            start.append(torch.tensor([self.didx]))
        return torch.cat(vals), torch.cat(mult), torch.cat(start)

    def take_value(self, v: int, t: int) -> None:
        """The first t holders of value v in node order."""
        vals, _, start = self.holders()
        lo = int(start[vals == v].min())
        last = self.take(lo, lambda x: x == v, lambda x: torch.ones_like(x), t)
        self.raise_bounds(self.st.cls[: self.nc, VAL] == v, last)

    def value_sum(self, bound: int) -> int:
        vals, mult, _ = self.holders()
        m = (vals > 0) & (vals < bound)
        return int((vals[m] * mult[m]).sum())

    def drain(self, bound: int) -> None:
        """The value-ordered drain over the holders with values in
        (0, bound): known to succeed (value_sum(bound) >= k)."""
        rem, ceiling = self.k, bound
        while True:
            vals, mult, _ = self.holders()
            live = (vals > 0) & (vals < ceiling)
            maxv = int(vals[live].max())
            if rem <= maxv:
                self.take_value(int(vals[live & (vals >= rem)].min()), 1)  # instant fit
                return
            cnt = int(mult[live & (vals == maxv)].sum())
            t = min(cnt, rem // maxv)
            self.take_value(maxv, t)
            rem -= t * maxv
            if rem == 0:
                return
            if t < cnt:
                vals, _, _ = self.holders()
                self.take_value(int(vals[(vals >= rem) & (vals < ceiling)].min()), 1)
                return
            ceiling = maxv

    def min_frag(self) -> int:
        st, k = self.st, self.k
        cv, ov, ovv = self.values()
        live = st.cls[: self.nc, LIVE].long()
        total = int((torch.clamp(cv, 0, k) * live).sum()) + int(torch.clamp(ovv, 0, k).sum())
        self.didx, _ = self.probe(total, clamp=True)
        if self.didx < 0:
            return -1
        if bool(self.exec_ok[self.didx]):
            self.didx_value = int(_mf_cap(self.planes[self.didx] - torch.tensor(self.d, dtype=torch.int32), self.e))
        if k > 0:
            vals, mult, _ = self.holders()
            maxc = int(vals.max()) if vals.numel() else 0
            ge = vals[vals >= k]
            pos = vals[vals > 0]
            min_ge = int(ge.min()) if ge.numel() else BIG
            min_pos = int(pos.min()) if pos.numel() else BIG
            if maxc > 0:
                has_sent = maxc == MF_SENT
                attempt = has_sent or k < maxc
                target = MF_SENT if has_sent else ((k + maxc) // 2 if attempt else 0)
                have_ge = min_ge != BIG and min_ge >= k
                if attempt and have_ge and min_ge < target:
                    self.take_value(min_ge, 1)
                elif attempt and min_pos != BIG and min_pos < target and self.value_sum(target) >= k:
                    self.drain(target)
                elif have_ge:
                    self.take_value(min_ge, 1)
                elif self.value_sum(BIG) >= k:
                    self.drain(BIG)
        return self.finish()


def queue_classes_plain(
    avail: torch.Tensor,     # [N, 3] int32
    cand: torch.Tensor,      # [M] int32: driver candidates in (rank, node) order
    exec_ok: torch.Tensor,   # [N] bool
    apps: torch.Tensor,      # [A, 8] int32: d0..2 e0..2 count valid
    state: ClassState,
    rebuild: bool,
    policy: int,
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch ops, app by app, on the same
    state: (feasible [A] bool, driver_idx [A] int32 (N if infeasible),
    avail_after [N, 3] int32); checkpoints into chk_out as the row kernels
    write them.  `rebuild`: the partition does not mirror `avail` and is
    built first."""
    n = avail.shape[0]
    planes = avail.to(torch.int32).clone()
    rows = apps.tolist()
    feasible = torch.zeros(len(rows), dtype=torch.bool)
    driver_idx = torch.full((len(rows),), n, dtype=torch.int32)
    if rebuild and n > 0:
        _rebuild_plain(state, planes, exec_ok)
        state.meta[M_CLASSES_INITIAL] = state.meta[M_CLASSES]
    cand_long = cand.long()
    for a, row in enumerate(rows):
        write_checkpoint(chk_out, chk_base, chk_stride, a, planes)
        if not row[7] or n == 0:
            continue
        step = _Step(state, planes, exec_ok, cand_long, row, policy)
        di = step.min_frag() if policy == POLICY_MINFRAG else step.plain()
        if di >= 0:
            feasible[a] = True
            driver_idx[a] = di
    return feasible, driver_idx, planes


# ---- the wrappers --------------------------------------------------------------


def _check_args(avail, cand, exec_ok, apps, state: ClassState):
    device, n = avail.device, avail.shape[0]
    check_tensor(avail, "avail", torch.int32, (n, 3), device)
    check_tensor(cand, "cand", torch.int32, (cand.shape[0],), device)
    check_tensor(exec_ok, "exec_ok", torch.bool, (n,), device)
    check_tensor(apps, "apps", torch.int32, (apps.shape[0], 8), device)
    if state.n != n or state.device != device:
        raise ValueError(f"class state holds {state.n} nodes on {state.device}, not {n} on {device}")


def _run(policy, avail, cand, exec_ok, apps, state, rebuild, chk_base, chk_stride, chk_out):
    check_checkpoints(chk_out, chk_base, chk_stride, avail.shape[0], avail.device)
    _check_args(avail, cand, exec_ok, apps, state)
    if avail.device.type == "cpu":
        return queue_classes_plain(avail, cand, exec_ok, apps, state, rebuild, policy,
                                   chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out)
    return _launch(policy, avail, cand, exec_ok, apps, state, rebuild, (chk_base, chk_stride, chk_out))


def fifo_queue_classes(
    avail: torch.Tensor,
    cand: torch.Tensor,
    exec_ok: torch.Tensor,
    apps: torch.Tensor,
    state: ClassState,
    rebuild: bool,
    evenly: bool = False,
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-compressed whole-queue pass under tightly-pack (or
    distribute-evenly): (feasible [A] bool, driver_idx [A] int32,
    avail_after [N, 3] int32), equal to ``queue_kernel.fifo_queue`` at the
    same inputs; `state` is updated in place.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream (no
    synchronisation).  chk_*: the checkpoints of queue_kernel.fifo_queue."""
    policy = POLICY_EVENLY if evenly else POLICY_TIGHTLY
    return _run(policy, avail, cand, exec_ok, apps, state, rebuild, chk_base, chk_stride, chk_out)


def fifo_queue_min_frag_classes(
    avail: torch.Tensor,
    cand: torch.Tensor,
    exec_ok: torch.Tensor,
    apps: torch.Tensor,
    state: ClassState,
    rebuild: bool,
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fifo_queue_classes under minimal fragmentation, equal to
    ``minfrag_kernel.fifo_queue_min_frag`` at the same inputs (the caller
    guards ``batch_solver.mf_sentinel_safe``)."""
    return _run(POLICY_MINFRAG, avail, cand, exec_ok, apps, state, rebuild, chk_base, chk_stride, chk_out)


def _launch(policy, avail, cand, exec_ok, apps, state, rebuild, checkpoints):
    """One launch of the kernel on a CUDA device."""
    device = avail.device
    if device.type != "cuda":
        raise ValueError(f"the class kernel runs on cpu or cuda tensors, not {device}")
    n, a = avail.shape[0], apps.shape[0]
    lib = LIBRARY.load()
    feasible = torch.empty((a,), dtype=torch.bool, device=device)
    driver_idx = torch.empty((a,), dtype=torch.int32, device=device)
    avail_after = torch.empty((n, 3), dtype=torch.int32, device=device)
    divs = torch.empty((max(a, 1), 3, 2), dtype=torch.int32, device=device)  # each app's divisions (scratch)
    chk_base, chk_stride, chk_out = checkpoints
    stream = torch.cuda.current_stream(device).cuda_stream
    node_cls, cls, ov, node_val, slot, table, ovx, meta = state.tensors()
    with torch.cuda.device(device):
        err = lib.fifo_queue_classes_launch(
            avail.data_ptr(), cand.data_ptr(), cand.shape[0], exec_ok.data_ptr(), apps.data_ptr(),
            n, a, policy, int(bool(rebuild)),
            feasible.data_ptr(), driver_idx.data_ptr(), avail_after.data_ptr(),
            node_cls.data_ptr(), cls.data_ptr(), ov.data_ptr(), node_val.data_ptr(), slot.data_ptr(),
            table.data_ptr(), ovx.data_ptr(), divs.data_ptr(), meta.data_ptr(), table.shape[0] - 1,
            chk_base, chk_stride, 0 if chk_out is None else chk_out.shape[0],
            None if chk_out is None else chk_out.data_ptr(),
            dynamic_smem_bytes(n), stream,
        )
    if err != 0:
        raise RuntimeError(f"class kernel launch failed with CUDA error {err}")
    count_launch(launch_counts, stream_launch_counts, KERNEL_NAMES[policy], stream)
    return feasible, driver_idx, avail_after
