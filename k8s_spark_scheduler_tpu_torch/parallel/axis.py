"""Node-axis reductions of the batch programs, whole or sharded.

Every program of ``ops/batch_solver.py`` reduces over the node axis only
through an axis object: ``LocalAxis`` runs plain torch ops over the whole
axis, ``ShardedAxis`` runs the same reductions over the rows a rank holds
and combines them with collectives.  So each program has one formulation
and runs unchanged on one device or over a mesh, as GSPMD partitions one
JAX program.

Each reduction takes tensors of shape [..., n] (the node axis last) and
reduces the last dimension.  Callers stack independent reductions of one
kind into one call, which the sharded axis issues as one collective.
Values are int32 (or int64 keys built from them): an int32 sum wraps the
same way in any order, so the sharded results equal the whole-axis ones
exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

BIG = 2**31 - 1


class LocalAxis:
    """The whole node axis on one device."""

    def __init__(self, n: int):
        self.n = n

    def iota(self, device) -> torch.Tensor:
        """The global node id of each row."""
        return torch.arange(self.n, dtype=torch.int32, device=device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(-1, dtype=torch.int32)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 0:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return x.amax(-1)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 0:
            return torch.full(x.shape[:-1], BIG, dtype=x.dtype, device=x.device)
        return x.amin(-1)

    def first_index(self, mask: torch.Tensor) -> torch.Tensor:
        """Least node id where mask holds, n where it holds nowhere."""
        if mask.shape[-1] == 0:
            return torch.zeros(mask.shape[:-1], dtype=torch.int32, device=mask.device)
        return torch.where(mask, self.iota(mask.device), self.n).amin(-1)

    def argmin(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(least value, least node id holding it)."""
        least = self.min(x)
        return least, self.first_index(x == least[..., None])

    def cumsum(self, x: torch.Tensor, *totals: torch.Tensor):
        """The inclusive cumulative sum of x along the node axis, and the
        sum of each of `totals` (the sharded axis gathers them together)."""
        scan = torch.cumsum(x, -1, dtype=torch.int32)
        return (scan,) + tuple(self.sum(t) for t in totals) if totals else scan


class ShardedAxis(LocalAxis):
    """The node axis of length n sharded over a ``NodeMesh``: this rank
    holds the contiguous rows ``mesh.rows(n)``.  Sums are all-reduce SUM,
    minima and maxima all-reduce MIN / MAX, argmin an all-reduce MIN of
    (value, node id) packed into one int64, and a cumulative sum the local
    scan plus the exclusive offset of the lower ranks' totals, from one
    all-gather."""

    def __init__(self, mesh, n: int):
        super().__init__(n)
        self.mesh = mesh
        self.start, stop = mesh.rows(n)
        self.n_local = stop - self.start
        if self.n_local < 1:
            raise ValueError(f"a node axis of {n} leaves rank {mesh.rank} no row")

    def iota(self, device) -> torch.Tensor:
        return torch.arange(self.start, self.start + self.n_local, dtype=torch.int32, device=device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x.sum(-1, dtype=torch.int32), dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x.amax(-1), dist.ReduceOp.MAX)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x.amin(-1), dist.ReduceOp.MIN)

    def first_index(self, mask: torch.Tensor) -> torch.Tensor:
        return self.min(torch.where(mask, self.iota(mask.device), self.n))

    def argmin(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        least = x.amin(-1)
        first = torch.where(x == least[..., None], self.iota(x.device), self.n).amin(-1)
        key = self.mesh.all_reduce(least.to(torch.int64) * 2**32 + first.to(torch.int64), dist.ReduceOp.MIN)
        return (key >> 32).to(x.dtype), (key & 0xFFFFFFFF).to(torch.int32)

    def cumsum(self, x: torch.Tensor, *totals: torch.Tensor):
        scan = torch.cumsum(x, -1, dtype=torch.int32)
        local = torch.stack([scan[..., -1]] + [t.sum(-1, dtype=torch.int32) for t in totals], -1)
        every = self.mesh.all_gather(local)  # [ranks, ..., 1 + len(totals)]
        offset = every[: self.mesh.rank, ..., 0].sum(0, dtype=torch.int32)
        scan = scan + offset[..., None]
        if not totals:
            return scan
        sums = every[..., 1:].sum(0, dtype=torch.int32)
        return (scan,) + tuple(sums[..., i] for i in range(len(totals)))
