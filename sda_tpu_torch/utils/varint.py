"""Zigzag + LEB128 varint codec for signed 64-bit share values.

Wire-compatible with the `integer-encoding 1.0` Rust crate used by the
reference to encode share vectors inside sealed-box ciphertexts
(client/src/crypto/encryption/sodium.rs:33-46 encrypt,
72-92 decrypt).

Signed i64 values are zigzag-mapped to u64 (`(n << 1) ^ (n >> 63)`), then
emitted as little-endian 7-bit groups with a continuation bit.

A numpy-vectorised batch codec is provided for bulk participation encoding;
this is the host-side hot loop when preparing millions of shares for the wire.

Port of the reference package's ``utils/varint.py``. The native fast path
is built and loaded lazily, on the first encode or decode, never at import.
"""

from __future__ import annotations

import ctypes

import numpy as np

_U64_MASK = (1 << 64) - 1

_UNLOADED = object()
# the native library (sda_tpu_torch.ops.native_build) once loaded, None when
# it cannot be built or loaded; set to None to force the numpy codec and the
# numpy ChaCha expansion (the sealed boxes bind it through sodium._lib)
_NATIVE = _UNLOADED


def native_library():
    """The native fast path, built on first use
    (:mod:`sda_tpu_torch.ops.native_build`), or ``None`` where it cannot be
    built or loaded: then the numpy codec runs, as in the reference without
    its library."""
    global _NATIVE
    if _NATIVE is _UNLOADED:
        from sda_tpu_torch.ops.native_build import load_native_library

        lib = load_native_library()
        if lib is not None:
            lib.sda_varint_encode.restype = ctypes.c_size_t
            lib.sda_varint_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.sda_varint_decode.restype = ctypes.c_size_t
            lib.sda_varint_decode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_size_t,
            ]
        _NATIVE = lib
    return _NATIVE


def _zigzag_encode(n: int) -> int:
    return ((n << 1) ^ (n >> 63)) & _U64_MASK


def _zigzag_decode(z: int) -> int:
    return (z >> 1) ^ -(z & 1)


def encode_varint(value: int) -> bytes:
    """Encode one signed 64-bit integer as a zigzag LEB128 varint."""
    if not -(1 << 63) <= value < (1 << 63):
        raise OverflowError(f"value out of i64 range: {value}")
    z = _zigzag_encode(value)
    out = bytearray()
    while True:
        byte = z & 0x7F
        z >>= 7
        if z:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_varint(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode one varint from ``data`` at ``offset``.

    Returns ``(value, size)`` like the reference's streaming decode loop
    (client/src/crypto/encryption/sodium.rs:83-89).
    """
    z = 0
    shift = 0
    size = 0
    while True:
        if offset + size >= len(data):
            raise ValueError("truncated varint")
        byte = data[offset + size]
        z |= (byte & 0x7F) << shift
        size += 1
        if not byte & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint too long for i64")
    return _zigzag_decode(z & _U64_MASK), size


def encode_varints(values) -> bytes:
    """Encode a sequence of signed i64 values back-to-back (numpy-vectorised).

    Equivalent to the reference's per-share encode loop but computed with
    vector ops: zigzag, per-value byte counts, then a scatter into one buffer.
    """
    arr = np.asarray(values, dtype=np.int64)
    if arr.size == 0:
        return b""
    flat = arr.ravel()
    lib = native_library()
    if lib is not None:
        src = np.ascontiguousarray(flat)
        out = np.empty(10 * src.size, dtype=np.uint8)
        n = lib.sda_varint_encode(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            src.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out[:n].tobytes()
    z = (flat.astype(np.uint64) << np.uint64(1)) ^ (flat >> np.int64(63)).astype(np.uint64)
    # number of 7-bit groups per value (at least 1), via threshold comparisons
    sizes = np.ones(flat.shape, dtype=np.int64)
    thresholds = np.uint64(1) << (np.uint64(7) * np.arange(1, 10, dtype=np.uint64))
    for t in thresholds:
        sizes += (z >= t).astype(np.int64)
    total = int(sizes.sum())
    out = np.empty(total, dtype=np.uint8)
    # byte positions
    ends = np.cumsum(sizes)
    starts = ends - sizes
    # emit up to 10 groups
    zz = z.copy()
    remaining = sizes.copy()
    pos = starts.copy()
    for _ in range(10):
        active = remaining > 0
        if not active.any():
            break
        byte = (zz & np.uint64(0x7F)).astype(np.uint8)
        cont = (remaining > 1) & active
        byte = np.where(cont, byte | np.uint8(0x80), byte)
        out[pos[active]] = byte[active]
        zz >>= np.uint64(7)
        pos = pos + 1
        remaining = remaining - 1
    return out.tobytes()


def decode_varints(data: bytes) -> np.ndarray:
    """Decode back-to-back varints until the buffer is exhausted.

    Mirrors the reference's while-loop decode
    (client/src/crypto/encryption/sodium.rs:83-89) with
    vectorised group extraction.
    """
    if not data:
        return np.zeros(0, dtype=np.int64)
    lib = native_library()
    if lib is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(len(data), dtype=np.int64)
        n = lib.sda_varint_decode(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            src.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.size,
        )
        if n == ctypes.c_size_t(-1).value:
            raise ValueError("malformed varint stream")
        return out[:n].copy()
    buf = np.frombuffer(data, dtype=np.uint8)
    cont = (buf & 0x80) != 0
    # value boundaries: a value ends at each byte with cont bit clear
    ends = np.nonzero(~cont)[0]
    if cont[-1]:
        raise ValueError("truncated varint stream")
    starts = np.concatenate(([0], ends[:-1] + 1))
    sizes = ends - starts + 1
    if (sizes > 10).any():
        raise ValueError("varint too long for i64")
    n = len(ends)
    z = np.zeros(n, dtype=np.uint64)
    groups = buf & 0x7F
    maxsize = int(sizes.max())
    for k in range(maxsize):
        sel = sizes > k
        z[sel] |= groups[starts[sel] + k].astype(np.uint64) << np.uint64(7 * k)
    value = (z >> np.uint64(1)).astype(np.int64) ^ -(z & np.uint64(1)).astype(np.int64)
    return value
