"""Binpacker registry (reference ``internal/binpacker/binpack.go``).

Name → algorithm map with the reference's host policies and the batch
solver's ``tpu-batch*`` names.  Unknown names fall back to the default
``distribute-evenly`` (binpack.go:52-58).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import compat
from ..device import DeviceLike
from . import packers
from .packers import SparkBinPackFunction

TIGHTLY_PACK = "tightly-pack"
DISTRIBUTE_EVENLY = "distribute-evenly"
AZ_AWARE_TIGHTLY_PACK = "az-aware-tightly-pack"
SINGLE_AZ_TIGHTLY_PACK = "single-az-tightly-pack"
SINGLE_AZ_MINIMAL_FRAGMENTATION = "single-az-minimal-fragmentation"
MINIMAL_FRAGMENTATION = "minimal-fragmentation"
TPU_BATCH = "tpu-batch"
TPU_BATCH_SINGLE_AZ = "tpu-batch-single-az"
TPU_BATCH_AZ_AWARE = "tpu-batch-az-aware"
TPU_BATCH_MIN_FRAG = "tpu-batch-minimal-fragmentation"
TPU_BATCH_EVENLY = "tpu-batch-distribute-evenly"
TPU_BATCH_SINGLE_AZ_MIN_FRAG = "tpu-batch-single-az-minimal-fragmentation"

TPU_BATCH_NAMES = (
    TPU_BATCH,
    TPU_BATCH_SINGLE_AZ,
    TPU_BATCH_AZ_AWARE,
    TPU_BATCH_MIN_FRAG,
    TPU_BATCH_EVENLY,
    TPU_BATCH_SINGLE_AZ_MIN_FRAG,
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
    AZ_AWARE_TIGHTLY_PACK: Binpacker(AZ_AWARE_TIGHTLY_PACK, packers.az_aware_tightly_pack, True),
    SINGLE_AZ_TIGHTLY_PACK: Binpacker(SINGLE_AZ_TIGHTLY_PACK, packers.single_az_tightly_pack, True),
    SINGLE_AZ_MINIMAL_FRAGMENTATION: Binpacker(
        SINGLE_AZ_MINIMAL_FRAGMENTATION, packers.single_az_minimal_fragmentation, True
    ),
    MINIMAL_FRAGMENTATION: Binpacker(MINIMAL_FRAGMENTATION, packers.minimal_fragmentation_pack, False),
}


def _minfrag_binpacker(name: str, strict: bool) -> Binpacker:
    """The two host min-frag policies, built for either compat mode — the
    only policies with a switchable quirk (efficiency write-back)."""
    if name == SINGLE_AZ_MINIMAL_FRAGMENTATION:
        return Binpacker(name, packers.make_single_az_minimal_fragmentation(strict), True)
    return Binpacker(name, packers.make_minimal_fragmentation_pack(strict), False)


def select_binpacker(
    name: str,
    strict_reference_parity: bool = compat.DEFAULT_STRICT,
    device: DeviceLike = None,
) -> Binpacker:
    """binpack.go:52-58; unknown → distribute-evenly.  The tpu-batch*
    binpackers run on `device` (None = CUDA); strict_reference_parity
    threads the compat policy (compat.py) into the minimal-fragmentation
    variants."""
    if not strict_reference_parity and name in (
        MINIMAL_FRAGMENTATION,
        SINGLE_AZ_MINIMAL_FRAGMENTATION,
    ):
        return _minfrag_binpacker(name, strict_reference_parity)
    if name in TPU_BATCH_NAMES:
        # imported lazily: batch_adapter imports this module
        from . import batch_adapter

        make = {
            TPU_BATCH: batch_adapter.tpu_batch_binpacker,
            TPU_BATCH_SINGLE_AZ: batch_adapter.tpu_batch_single_az_binpacker,
            TPU_BATCH_AZ_AWARE: batch_adapter.tpu_batch_az_aware_binpacker,
            TPU_BATCH_MIN_FRAG: batch_adapter.tpu_batch_min_frag_binpacker,
            TPU_BATCH_EVENLY: batch_adapter.tpu_batch_evenly_binpacker,
            TPU_BATCH_SINGLE_AZ_MIN_FRAG: batch_adapter.tpu_batch_single_az_min_frag_binpacker,
        }[name]
        return make(strict_reference_parity, device)
    return _REGISTRY.get(name, _REGISTRY[DEFAULT])


# -- kernel chaos hook --------------------------------------------------------
#
# The simulator's kernel_fault injection point (the reference's hook, with
# this package's semantics): when armed, the extender's two device lanes
# (the tensor driver lane and the metadata lane of a queue solver) raise
# the hook's KernelFault at their entry.  There is no lane to demote to:
# the fault propagates out of the Filter exactly as a failed launch does
# (the HTTP layer answers 500).  None (the default) costs one
# module-attribute read per dispatch.


class KernelFault(RuntimeError):
    """A kernel fault injected through :func:`set_kernel_fault_hook`."""


_kernel_fault_hook = None


def set_kernel_fault_hook(fn) -> None:
    """fn(lane_name) -> Optional[Exception]; None disarms."""
    global _kernel_fault_hook
    _kernel_fault_hook = fn


def check_kernel_fault(lane: str) -> None:
    fn = _kernel_fault_hook
    if fn is not None:
        err = fn(lane)
        if err is not None:
            raise err


def available_binpackers() -> list[str]:
    return sorted(_REGISTRY.keys() | set(TPU_BATCH_NAMES))
