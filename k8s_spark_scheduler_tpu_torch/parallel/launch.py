"""A world of ranks on this host, for the dry run, the multihost bench,
``chip_smoke.py``'s mesh phase and the tests.

``run_world(fn, ranks, device, backend)`` spawns `ranks` processes,
joins them into one process group through ``initialize_multihost``
(rank 0 hosts the TCP store on a free local port), calls
``fn(mesh, *args)`` in each with the 1-D ``NodeMesh`` over the world, and
returns every rank's result in rank order.  A rank that raises ends the
world: the others are terminated and the traceback is raised here.  No
process group is made in the calling process.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from ..device import DeviceLike, resolve_device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, ranks, local_ranks, port, device, backend, args, results, timeout_s):
    import torch
    import torch.distributed as dist

    from .mesh import initialize_multihost, make_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK=str(rank % local_ranks),
                      LOCAL_WORLD_SIZE=str(local_ranks))
    # the ranks of a host share its cores
    torch.set_num_threads(1)
    try:
        dev = initialize_multihost(f"127.0.0.1:{port}", ranks, rank, device=device, backend=backend,
                                   timeout_s=timeout_s)
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_world(
    fn: Callable,
    ranks: int,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    args: Sequence[Any] = (),
    local_ranks: Optional[int] = None,
    timeout_s: float = 600.0,
) -> List[Any]:
    """Every rank's ``fn(mesh, *args)``, in rank order.  `fn` and `args`
    must pickle (a module-level function).  `local_ranks` sets the ranks a
    host (``LOCAL_WORLD_SIZE``; all of them by default).  `device` None
    means CUDA, and raises before any rank starts where there is none."""
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    local_ranks = local_ranks or ranks
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, rank, ranks, local_ranks, port, device, backend, tuple(args), results, timeout_s))
        for rank in range(ranks)
    ]
    for p in procs:
        p.start()
    got, failures = {}, []
    deadline = time.monotonic() + timeout_s  # schedlint: disable=TS002 -- the world's timeout bounds the real wall time of spawned rank processes
    try:
        while len(got) + len(failures) < ranks:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:  # schedlint: disable=TS002 -- the same real-time world deadline as above
                    raise TimeoutError(f"the world of {ranks} ranks did not finish in {timeout_s:.0f} s")
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0]} before it reported")
                continue
            if ok:
                got[rank] = out
            else:
                failures.append(f"rank {rank}:\n{out}")
                break
    finally:
        if failures or len(got) < ranks:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
    if failures:
        raise RuntimeError("a rank of the world failed\n" + "\n".join(failures))
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [got[r] for r in range(ranks)]
