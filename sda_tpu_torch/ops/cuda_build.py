"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``sda_tpu_torch/ops/csrc/`` has a plain C entry
point. On first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root (named by the hash of the source,
the shared headers ``csrc/*.cuh``, its defines and the flags, so an edited
source or header rebuilds) and loaded with
:mod:`ctypes`. One source may be built as several variants, each with its
own ``-D`` defines and its own library. ptxas's report (registers, shared
memory and spills of every kernel) is kept beside each library as
``<name>.ptxas.txt``. Nothing here runs at import time: this module is
imported on machines without a CUDA toolkit, where only the kernels' plain
versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from sda_tpu_torch.utils.logging import span

__all__ = ["build_kernel_libraries", "load_kernel_library", "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_loaded: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(source: str, defines: tuple[str, ...]) -> Path:
    src = _CSRC / source
    flags = [*_NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build_kernel_libraries(variants) -> list[Path]:
    """Compile every ``(source, defines)`` of ``variants`` that is not built
    yet, one ``nvcc`` process each, all started together; return the
    libraries' paths in order."""
    variants = [(source, tuple(defines)) for source, defines in variants]
    libs = [_library_path(source, defines) for source, defines in variants]
    running = []
    for (source, defines), lib in zip(variants, libs):
        if lib.exists() or any(lib == other for other, _, _ in running):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(_CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((lib, tmp, proc))
    failed = []
    for lib, tmp, proc in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {lib.name}:\n{log}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load_kernel_library(source: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` built with ``defines``,
    built on first use."""
    key = (source, tuple(defines))
    got = _loaded.get(key)
    if got is None:
        with span("sda.kernel.load"):
            (lib,) = build_kernel_libraries([key])
            got = ctypes.CDLL(str(lib))
        _loaded[key] = got
    return got


def ptxas_report(source: str, defines=()) -> str:
    """ptxas's report for a built variant ("" if it was built elsewhere)."""
    log = _library_path(source, tuple(defines)).with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""
