"""Build and load the port's host-side native library.

One library holds the protocol's host plane:

- ``native/varint.cpp`` and ``native/chacha.cpp`` (shared with the
  reference, read and not edited): the varint codec and the ChaCha mask
  expansion;
- ``sda_tpu_torch/native/nacl.cpp``: sealed boxes (X25519 +
  XSalsa20-Poly1305) and Ed25519 signatures, wire-identical to libsodium's,
  with no dependency;
- ``sda_tpu_torch/native/sealed_batch.cpp``: the clerks' batch open and
  fused open + combine over ``nacl.cpp``.

The port does not load the committed ``native/libsda_native.so``, which was
built with ``-march=native`` on another host and needs libsodium: on first
use it compiles the four sources with ``native/Makefile``'s flags into
``build/native/`` at the repository root, named by the hash of the sources
and the flags, and loads that with :mod:`ctypes`. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_native_library"]

_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _ROOT / "build" / "native"
_SOURCES = tuple(_ROOT / rel for rel in (
    "native/varint.cpp", "native/chacha.cpp",
    "sda_tpu_torch/native/nacl.cpp", "sda_tpu_torch/native/sealed_batch.cpp",
))
# native/Makefile's CXXFLAGS; of its link line's libraries only -pthread, as
# nothing here loads another library at run time
_FLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared"]
_LIBS = ["-pthread"]
_lock = threading.Lock()
_loaded: list = []  # once tried: [(library or None, why it is None)]


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _library_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` from the current sources lives."""
    digest = hashlib.sha256()
    for path in _SOURCES:
        digest.update(path.read_bytes())
    digest.update(" ".join([cxx, *_FLAGS, *_LIBS]).encode())
    return BUILD_DIR / f"libsda_native_{digest.hexdigest()[:16]}.so"


def _build_and_load():
    """``(library, None)``, or ``(None, why)`` when it cannot be built or
    loaded."""
    cxx = _compiler()
    if cxx is None:
        return None, "no C++ compiler (g++, c++ or $CXX)"
    missing = [str(p) for p in _SOURCES if not p.exists()]
    if missing:
        return None, f"missing sources: {', '.join(missing)}"
    path = _library_path(cxx)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *_FLAGS, "-o", str(tmp), *map(str, _SOURCES), *_LIBS],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            return None, f"{cxx} failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}"
        os.replace(tmp, path)
    try:
        return ctypes.CDLL(str(path)), None
    except OSError as err:
        return None, f"{path} does not load: {err}"


def load_native_library(required: bool = False):
    """The loaded native library, built on first use. Where it cannot be
    built or loaded: ``None``, or with ``required`` a ``RuntimeError`` that
    says why."""
    with _lock:
        if not _loaded:
            _loaded.append(_build_and_load())
        lib, why = _loaded[0]
    if lib is None and required:
        raise RuntimeError(f"the port's native library is unavailable: {why}")
    return lib
