"""Build and load the host-side native library shared with the reference.

``native/varint.cpp``, ``chacha.cpp`` and ``sealed_batch.cpp`` (C++, shared
by both packages, not part of either) hold the varint codec and the batch
sealed-box open + combine of the protocol's host plane. The port does not
load the committed ``native/libsda_native.so``, which was built with
``-march=native`` on another host: on first use it compiles the three
sources with ``native/Makefile``'s flags into ``build/native/`` at the
repository root, named by the hash of the sources and the flags, and loads
that with :mod:`ctypes`. The library resolves libsodium itself, at its first
sealed-box call. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_native_library"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SOURCES = ("varint.cpp", "chacha.cpp", "sealed_batch.cpp")
# native/Makefile: CXXFLAGS, then the link line's libraries
_FLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared"]
_LIBS = ["-ldl", "-pthread"]
_loaded: list = []


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _library_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` from the current sources lives."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_NATIVE_DIR / name).read_bytes())
    digest.update(" ".join([cxx, *_FLAGS, *_LIBS]).encode())
    return BUILD_DIR / f"libsda_native_{digest.hexdigest()[:16]}.so"


def load_native_library():
    """The loaded native library, built on first use; ``None`` when there is
    no C++ compiler, the build fails or the library does not load."""
    if _loaded:
        return _loaded[0]
    lib = None
    cxx = _compiler()
    if cxx is not None and all((_NATIVE_DIR / name).exists() for name in _SOURCES):
        path = _library_path(cxx)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *_FLAGS, "-o", str(tmp), *(str(_NATIVE_DIR / n) for n in _SOURCES), *_LIBS],
                capture_output=True, text=True,
            )
            if proc.returncode == 0:
                os.replace(tmp, path)
        if path.exists():
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
    _loaded.append(lib)
    return lib
