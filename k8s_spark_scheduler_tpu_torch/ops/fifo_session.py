"""The delta-solve engine's persistent solver session, resident on the
device: the counterpart of the reference package's native
``FifoSession`` (``native/fifo_solver.cpp`` ``fifo_sess_*``) and its
wrapper ``native/fifo.py`` ``NativeFifoSession``.

A session pins one (cluster basis, policy) problem: the scaled
availability planes at queue position 0, the driver ranks and executor
eligibility, the queue rows it last solved with their verdicts, a
checkpoint of the carried planes every ``stride`` queue positions and the
planes after the whole queue (the tail).  On CUDA the basis, the ranks,
the eligibility, the checkpoints (one ``[24, Nb, 3]`` int32 buffer) and
the tail are device tensors; the rows and verdicts stay on the host,
where the caller's packed rows and its blocked-driver check live.

``solve`` follows the native session step by step:

1. the first packed row that differs from the cached run;
2. while ``na // stride > 24`` the stride doubles and the odd
   checkpoints go (the positions at even multiples of the old stride are
   the multiples of the new one);
3. the resume position is the largest checkpointed position at or below
   that row, the tail counting as the checkpoint at the cached length;
4. the planes are restored from that checkpoint;
5. checkpoints past it are dropped;
6. the suffix is solved in ONE launch of the queue kernel
   (``queue_kernel.fifo_queue`` for tightly-pack / distribute-evenly,
   ``minfrag_kernel.fifo_queue_min_frag`` for minimal fragmentation) that
   writes fresh checkpoints into the buffer as it passes their positions;
7. a queue equal to the cached one (resume == its length) is served
   with no launch at all.

Verdicts of the reused prefix come from the cached run.  On a CPU
device the same bookkeeping calls the kernels' plain versions, through
the same wrappers.  The prefix compare is byte for byte, so a caller
that passes whatever it believes the queue is gets a deeper re-solve
for a wrong belief, never a wrong decision.  Not thread-safe; the
owning engine (``ops/deltasolve.py``) serialises access.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .minfrag_kernel import fifo_queue_min_frag
from .queue_kernel import fifo_queue

POLICY_TIGHTLY, POLICY_EVENLY, POLICY_MINFRAG = 0, 1, 2
# live checkpoints at most (the native session's kMaxCheckpoints)
MAX_CHECKPOINTS = 24


def _device_array(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """x (a numpy array or a tensor) as a contiguous tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dtype)


def queue_pass(
    policy_code: int,
    avail: torch.Tensor,
    driver_rank: torch.Tensor,
    exec_ok: torch.Tensor,
    packed: np.ndarray,  # [A, 8] int32: d0..2 e0..2 count valid
    chk_base: int = 0,
    chk_stride: int = 0,
    chk_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the policy's queue kernel (its plain version for
    CPU tensors) over session-format packed rows, on avail's device:
    (feasible [A] bool, driver_idx [A] int32, avail_after [Nb, 3] int32)
    as tensors, the checkpoints into chk_out."""
    device = avail.device
    rows = np.ascontiguousarray(packed, dtype=np.int32)
    args = (
        avail,
        driver_rank,
        exec_ok,
        torch.as_tensor(np.ascontiguousarray(rows[:, 0:3]), device=device),
        torch.as_tensor(np.ascontiguousarray(rows[:, 3:6]), device=device),
        torch.as_tensor(np.ascontiguousarray(rows[:, 6]), device=device),
        torch.as_tensor(rows[:, 7] != 0, device=device),
    )
    chk = dict(chk_base=chk_base, chk_stride=chk_stride, chk_out=chk_out)
    if policy_code == POLICY_MINFRAG:
        return fifo_queue_min_frag(*args, **chk)
    return fifo_queue(*args, evenly=policy_code == POLICY_EVENLY, **chk)


def solve_packed_cold(
    policy_code: int,
    avail,        # [Nb, 3] int32 basis (array or tensor; not mutated)
    driver_rank,  # [Nb] int32
    exec_ok,      # [Nb] bool
    packed: np.ndarray,  # [A, 8] int32
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Stateless whole-queue pass of a session-format packed queue: the
    warm≠cold parity guard's reference and the counterpart of the
    reference's ``native.fifo.solve_packed_cold``.  Returns (feasible
    [A] bool, driver_idx [A] int32) on the host and avail_after [Nb, 3]
    int32 on `device` (None = CUDA)."""
    device = resolve_device(device)
    feasible, didx, after = queue_pass(
        policy_code,
        _device_array(avail, torch.int32, device),
        _device_array(driver_rank, torch.int32, device),
        _device_array(exec_ok, torch.bool, device),
        packed,
    )
    return feasible.cpu().numpy(), didx.cpu().numpy(), after


def _first_difference(a: np.ndarray, b: np.ndarray) -> int:
    """The first row where two equal-length [n, 8] blocks differ (n when
    none does)."""
    if a.tobytes() == b.tobytes():
        return a.shape[0]
    return int(np.flatnonzero((a != b).any(axis=1))[0])


class FifoSession:
    """See module docstring.  ``device``: where the planes live and the
    kernels run (None = CUDA)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.policy = POLICY_TIGHTLY
        self.stride = 64
        self.nb = 0
        self.basis: Optional[torch.Tensor] = None        # [Nb, 3] int32
        self.driver_rank: Optional[torch.Tensor] = None  # [Nb] int32
        self.exec_ok: Optional[torch.Tensor] = None      # [Nb] bool
        # chk[j] = the planes BEFORE the app at position (j + 1) * stride;
        # slots [0, n_chk) are live
        self._chk: Optional[torch.Tensor] = None         # [MAX_CHECKPOINTS, Nb, 3]
        self.n_chk = 0
        self.tail: Optional[torch.Tensor] = None         # planes after the cached queue
        self._apps = np.zeros((0, 8), np.int32)
        self._feas = np.zeros(0, bool)
        self._didx = np.zeros(0, np.int32)
        self.na = 0

    def load(self, basis, driver_rank, exec_ok, policy_code: int, stride: int = 64) -> None:
        """(Re)load the basis: scaled availability [Nb, 3] at queue
        position 0, driver ranks [Nb], executor eligibility [Nb], the
        policy code, the checkpoint stride.  Drops every cached queue
        state; the checkpoint buffer is kept when Nb is unchanged."""
        if stride <= 0:
            raise ValueError(f"checkpoint stride must be positive, not {stride}")
        self.basis = _device_array(basis, torch.int32, self.device)
        self.driver_rank = _device_array(driver_rank, torch.int32, self.device)
        self.exec_ok = _device_array(exec_ok, torch.bool, self.device)
        nb = int(self.basis.shape[0])
        if self._chk is None or self._chk.shape[1] != nb:
            self._chk = torch.empty((MAX_CHECKPOINTS, nb, 3), dtype=torch.int32, device=self.device)
        self.nb = nb
        self.policy = int(policy_code)
        self.stride = int(stride)
        self.n_chk = 0
        self.tail = self.basis
        self._apps = np.zeros((0, 8), np.int32)
        self._feas = np.zeros(0, bool)
        self._didx = np.zeros(0, np.int32)
        self.na = 0

    def solve(self, packed: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray, torch.Tensor]:
        """(resume, feasible [A] bool, driver_idx [A] int32, avail_after
        [Nb, 3] int32 tensor on the session's device) for the queue
        `packed` ([A, 8] int32: d0..2 e0..2 count valid, the basis's
        units).  resume is the queue position the pass started at: 0 for a
        whole-queue pass, A when everything came from the cached run."""
        if self.basis is None:
            raise RuntimeError("FifoSession.solve on a session with no basis")
        apps = np.ascontiguousarray(packed, dtype=np.int32).reshape(-1, 8)
        na = apps.shape[0]

        # 1. the first row that differs from the cached run
        lim = min(na, self.na)
        diff = _first_difference(apps[:lim], self._apps[:lim])

        # 2. stride doubling keeps at most MAX_CHECKPOINTS live
        while na // self.stride > MAX_CHECKPOINTS:
            keep = self.n_chk // 2
            if keep:
                # old slot 2j + 1 holds position (2j + 2) * stride = (j + 1) * (2 * stride)
                self._chk[:keep] = self._chk[1 : 2 * keep : 2].clone()
            self.n_chk = keep
            self.stride *= 2

        # 3. resume at the largest checkpointed position <= diff (the tail
        # is the checkpoint at the cached length)
        if diff >= self.na:
            r = self.na
        else:
            r = min(diff // self.stride, self.n_chk) * self.stride

        # 4. the planes at r
        if r == self.na:
            start = self.tail
        elif r == 0:
            start = self.basis
        else:
            # a copy: the launch rewrites this very slot (the position r)
            start = self._chk[r // self.stride - 1].clone()

        # 5. checkpoints past r describe a superseded suffix
        self.n_chk = min(self.n_chk, r // self.stride)

        # 6. the suffix in one launch, leaving fresh checkpoints behind;
        # the prefix's verdicts are the cached run's
        feas = np.empty(na, bool)
        didx = np.empty(na, np.int32)
        feas[:r] = self._feas[:r]
        didx[:r] = self._didx[:r]
        if r < na:
            f, d, after = queue_pass(
                self.policy, start, self.driver_rank, self.exec_ok, apps[r:],
                chk_base=r, chk_stride=self.stride, chk_out=self._chk,
            )
            feas[r:] = f.cpu().numpy()
            didx[r:] = d.cpu().numpy()
            self.n_chk = (na - 1) // self.stride
            self.tail = after
        else:
            # 7. nothing to solve: the planes at r are the answer
            self.tail = start
        self._apps = apps.copy()
        self._feas = feas
        self._didx = didx
        self.na = na
        return r, feas.copy(), didx.copy(), self.tail

    def checkpoints(self) -> int:
        """Live checkpoints (at most MAX_CHECKPOINTS)."""
        return self.n_chk

    def mem_bytes(self) -> int:
        """Bytes the session holds: the device planes (basis, ranks,
        eligibility, the checkpoint buffer, the tail when it is not the
        basis) and the host cache of rows and verdicts."""
        tensors = [self.basis, self.driver_rank, self.exec_ok, self._chk]
        if self.tail is not None and self.tail is not self.basis:
            tensors.append(self.tail)
        device_bytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
        return int(device_bytes + self._apps.nbytes + self._feas.nbytes + self._didx.nbytes)
