"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None means the CUDA device.  A CUDA device on a host without CUDA
    raises: entry points never move to the CPU on their own; callers that
    want the CPU (the tests) ask for it."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def lane_of(device: torch.device) -> str:
    """The queue lane a device runs: the hand kernel on CUDA, the plain
    PyTorch version on the CPU."""
    return "cuda" if device.type == "cuda" else "torch"

