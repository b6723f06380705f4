"""Builds and loads the package's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled at first use with ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface,
loaded with ctypes.  The library lands under ``<package>/_build`` (listed
in .gitignore), named by a hash of the source, every header it includes
from ``csrc/`` and the compiler flags, so an edit to any of them builds
anew and an unchanged kernel is loaded as it is.  Nothing here runs when
the module is imported, and there is no fallback: a build that fails
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Callable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


class KernelLibrary:
    """One kernel source and the library built from it.  `declare` sets
    the argtypes and restype of the library's exported functions."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        # compiler output of the build this process ran ("" if it loaded a cached one)
        self.build_log = ""

    def sources(self) -> List[Path]:
        """The source and every header it includes from csrc/, transitively."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in found:
                continue
            found.append(path)
            todo += [CSRC / name for name in _INCLUDE.findall(path.read_text())]
        return found

    def library_path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self.sources():
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """Build (once per source version) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            so_path = self.library_path()
            if not so_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True,
                    text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build {self.source.name}:\n{proc.stderr}")
                self.build_log = proc.stdout + proc.stderr
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(str(so_path))
            self._declare(lib)
            self._lib = lib
            return lib


def check_tensor(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device: torch.device):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def shared_bytes_or_raise(value: int, kernel: str) -> int:
    """A library's shared-bytes answer: a negative value is a CUDA error."""
    if value < 0:
        raise RuntimeError(f"CUDA error {-value} querying the {kernel} kernel")
    return int(value)
