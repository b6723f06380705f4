"""Binpacker registry (reference ``internal/binpacker/binpack.go``).

Name → algorithm map with the reference's host policies and the batch
solver's ``tpu-batch`` names.  Unknown names fall back to the default
``distribute-evenly`` (binpack.go:52-58).  Policies of the reference that
this package does not implement yet raise instead of falling back, so a
configured policy is never silently replaced by another.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import compat
from ..device import DeviceLike
from . import packers
from .packers import SparkBinPackFunction

TIGHTLY_PACK = "tightly-pack"
DISTRIBUTE_EVENLY = "distribute-evenly"
TPU_BATCH = "tpu-batch"
TPU_BATCH_EVENLY = "tpu-batch-distribute-evenly"

# reference / JAX-package policies whose solvers are not ported yet
NOT_PORTED = (
    "az-aware-tightly-pack",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "minimal-fragmentation",
    "tpu-batch-single-az",
    "tpu-batch-az-aware",
    "tpu-batch-minimal-fragmentation",
    "tpu-batch-single-az-minimal-fragmentation",
)

DEFAULT = DISTRIBUTE_EVENLY


@dataclass
class Binpacker:
    name: str
    binpack_func: SparkBinPackFunction
    is_single_az: bool
    # whole-queue FIFO solver (set for tpu-batch*); None means the
    # extender uses the host earlier-drivers loop
    queue_solver: object = None


_REGISTRY = {
    TIGHTLY_PACK: Binpacker(TIGHTLY_PACK, packers.tightly_pack, False),
    DISTRIBUTE_EVENLY: Binpacker(DISTRIBUTE_EVENLY, packers.distribute_evenly, False),
}


def select_binpacker(
    name: str,
    strict_reference_parity: bool = compat.DEFAULT_STRICT,
    device: DeviceLike = None,
) -> Binpacker:
    """binpack.go:52-58; unknown → distribute-evenly.  The tpu-batch
    binpackers run on `device` (None = CUDA)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"binpack policy {name!r} is not ported to PyTorch yet")
    if name in (TPU_BATCH, TPU_BATCH_EVENLY):
        # imported lazily: batch_adapter imports this module
        from .batch_adapter import tpu_batch_binpacker, tpu_batch_evenly_binpacker

        if name == TPU_BATCH_EVENLY:
            return tpu_batch_evenly_binpacker(strict_reference_parity, device)
        return tpu_batch_binpacker(strict_reference_parity, device)
    return _REGISTRY.get(name, _REGISTRY[DEFAULT])


def available_binpackers() -> list[str]:
    return sorted(_REGISTRY.keys() | {TPU_BATCH, TPU_BATCH_EVENLY})
