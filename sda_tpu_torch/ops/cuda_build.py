"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``sda_tpu_torch/ops/csrc/`` has a plain C entry
point. On first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root (named by the hash of the source,
so an edited source rebuilds) and loaded with :mod:`ctypes`. Nothing here
runs at import time: this module is imported on machines without a CUDA
toolkit, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_kernel_library", "load_kernel_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_kernel_library(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library (cached by content)."""
    src = _CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_kernel_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    got = _loaded.get(source)
    if got is None:
        got = ctypes.CDLL(str(build_kernel_library(source)))
        _loaded[source] = got
    return got
