"""The node mesh: the solver's node axis sharded over a process group.

The counterpart of the JAX package's ``parallel/mesh.py``.  There the
node axis is sharded over a ``jax.sharding.Mesh`` and GSPMD inserts the
collectives; here each rank of a ``torch.distributed`` process group
holds one contiguous block of node rows, and the programs of
``ops/batch_solver.py`` run their node-axis reductions through a
``parallel.axis.ShardedAxis``, which issues the collectives itself (sums,
minima, argmin, the exclusive prefix offsets of a cumulative sum).  The
apps stay whole on every rank.

One rank drives one device.  The backend follows the device: ``nccl``
for CUDA, ``gloo`` for the CPU.  Ranks that share one card (more ranks on
a host than cards) must ask for ``gloo`` themselves: NCCL refuses two
ranks on one GPU, and ``initialize_multihost`` raises before it would
try.  Under gloo, the collectives of CUDA tensors run on host copies
(``NodeMesh.all_reduce`` / ``all_gather``): a fixed rule of the backend,
not a fallback.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

NODE_AXIS = "nodes"
HOSTS_AXIS = "hosts"
BACKENDS = ("nccl", "gloo")


def pad_to_multiple(n: int, devices: int) -> int:
    """Node-axis length must divide evenly across the mesh."""
    if n % devices == 0:
        return n
    return n + devices - (n % devices)


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """The process group's backend for ranks on `device`: nccl for CUDA,
    gloo for the CPU, or the caller's `backend`.  NCCL on the CPU raises."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}; use one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA tensors; ranks on the CPU use gloo")
    return backend


def _local_rank(process_id: int) -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; the
    global rank when the launcher set none)."""
    return int(os.environ.get("LOCAL_RANK", process_id))


def local_world_size(world: int) -> int:
    """Ranks on each host: torchrun's ``LOCAL_WORLD_SIZE``, which must
    divide the world.  Without it every rank is on one host."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world of {world} ranks")
    return local


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join a process group of `num_processes` ranks whose rank 0 hosts
    the TCP store at `coordinator_address` (``host:port``).  Returns the
    device this rank drives: ``cuda:<local rank>`` under nccl, the card
    ``local rank % cards`` under gloo with CUDA shards, or the CPU.

    `device` None means CUDA, and raises without it.  Under nccl a rank
    whose local rank has no card of its own raises (NCCL refuses two
    ranks on one GPU): such ranks pass ``backend="gloo"``."""
    dev = resolve_device(device)
    backend = backend_for(dev, backend)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = _local_rank(process_id)
        if dev.index is not None:
            index = dev.index
        elif backend == "nccl":
            if local >= cards:
                raise RuntimeError(
                    f"rank {process_id} (local rank {local}) has no card of its own ({cards} on this "
                    "host): NCCL refuses two ranks on one GPU; pass backend='gloo'"
                )
            index = local
        else:
            index = local % cards
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    host, port = coordinator_address.rsplit(":", 1)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{host}:{int(port)}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


class NodeMesh:
    """A 1-D ``("nodes",)`` or 2-D ``("hosts", "nodes")`` layout of the
    ranks of one process group, one rank a device.  Rank r holds node rows
    ``rows(n)`` of an axis of length n (a multiple of the mesh size).  The
    mesh counts the collectives it issues (``collectives``)."""

    def __init__(self, group, device: torch.device, axis_names: Tuple[str, ...] = (NODE_AXIS,),
                 shape: Optional[Tuple[int, ...]] = None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = device
        self.backend = dist.get_backend(group)
        self.axis_names = axis_names
        self.shape = shape if shape is not None else (self.size,)
        if len(self.shape) != len(axis_names) or math.prod(self.shape) != self.size:
            raise ValueError(f"layout {self.shape} over {axis_names} does not hold {self.size} ranks")
        self.collectives = 0
        # gloo reduces on the host: its collectives of CUDA tensors run on host copies
        self._host_copies = self.backend == "gloo" and device.type == "cuda"

    def __repr__(self) -> str:
        return (f"NodeMesh(rank={self.rank}, size={self.size}, {dict(zip(self.axis_names, self.shape))}, "
                f"{self.backend}, {self.device})")

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's position in the layout (host, local) or (rank,)."""
        if len(self.shape) == 1:
            return (self.rank,)
        return divmod(self.rank, self.shape[1])

    def rows(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of a node axis of length n."""
        if n % self.size:
            raise ValueError(f"node axis of {n} does not divide over {self.size} ranks; use pad_to_multiple")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def shard(self, x, dim: int = 0) -> torch.Tensor:
        """This rank's rows of a node-axis array (`dim` is the node axis),
        on the mesh's device."""
        x = torch.as_tensor(x)
        start, stop = self.rows(x.shape[dim])
        return x.narrow(dim, start, stop - start).to(self.device).contiguous()

    def replicate(self, x) -> torch.Tensor:
        """An array every rank keeps whole (the apps), on the mesh's device."""
        return torch.as_tensor(x).to(self.device)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if t.numel() == 0:  # every rank holds the same (empty) shape
            return t
        self.collectives += 1
        if self._host_copies:
            host = t.cpu()
            dist.all_reduce(host, op=op, group=self.group)
            return host.to(t.device)
        t = t.contiguous()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's `t`, in rank order."""
        if t.numel() == 0:
            return t.new_empty((self.size,) + tuple(t.shape))
        self.collectives += 1
        src = (t.cpu() if self._host_copies else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def gather_nodes(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole node axis of a node-sharded output, on every rank."""
        parts = self.all_gather(x.movedim(dim, 0))
        return parts.reshape((parts.shape[0] * parts.shape[1],) + tuple(parts.shape[2:])).movedim(0, dim)

    def axis(self, n: int):
        """The node-axis reductions over this mesh for an axis of length n."""
        from .axis import ShardedAxis

        return ShardedAxis(self, n)

    def sub(self, k: int) -> Optional["NodeMesh"]:
        """A 1-D mesh of this mesh's first k ranks (None on the others).
        Every rank of the mesh must call it, in the same order."""
        ranks = dist.get_process_group_ranks(self.group) if self.group is not None else list(range(self.size))
        group = dist.new_group(ranks=ranks[:k], backend=self.backend)
        return NodeMesh(group, self.device) if self.rank < k else None


def make_mesh(group=None, device: DeviceLike = None) -> NodeMesh:
    """1-D mesh over the node axis: the ranks of `group` (the world by
    default), each driving its `device` (None means CUDA; the current
    card)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return NodeMesh(group, dev)


def make_multihost_mesh(devices_per_host_axis: bool = False, device: DeviceLike = None) -> NodeMesh:
    """Global mesh over every process of the world (call after
    initialize_multihost).  The 1-D layout keeps neighbouring node-axis
    shards on one host where the ranks are numbered host by host; with
    `devices_per_host_axis` the layout is ``("hosts", "nodes")``, a
    [hosts, local] rank grid with the local size from
    ``LOCAL_WORLD_SIZE``.  The node axis is sharded over all ranks in
    rank order either way."""
    mesh = make_mesh(None, device)
    if not devices_per_host_axis:
        return mesh
    local = local_world_size(mesh.size)
    return NodeMesh(None, mesh.device, (HOSTS_AXIS, NODE_AXIS), (mesh.size // local, local))
