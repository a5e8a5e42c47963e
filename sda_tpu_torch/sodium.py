"""Sealed boxes and Ed25519 signatures, wire-identical to libsodium.

The reference consumes libsodium through the `sodiumoxide` Rust crate
(client/src/crypto/encryption/sodium.rs:43,78 sealed boxes;
signing/mod.rs:92,126 detached Ed25519). The port carries its own copy of
these constructions, ``sda_tpu_torch/native/nacl.cpp``, built into the
port's native library (:mod:`sda_tpu_torch.ops.native_build`) on first use
and bound here with :mod:`ctypes`. Its bytes equal libsodium 1.0.18's:

- sealed box = X25519 + XSalsa20-Poly1305 with an ephemeral sender key,
  ``epk || crypto_box_easy(m, blake2b(epk || pk), pk, esk)``
  (``crypto_box_seal`` / ``crypto_box_seal_open``);
- signatures = Ed25519 detached, RFC 8032, with libsodium's checks on
  verification (``crypto_sign_detached`` / ``crypto_sign_verify_detached``).

When the library cannot be built or loaded, the first call raises
``RuntimeError`` and says why: nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

from sda_tpu_torch.utils.errors import Invalid

SEALBYTES = 48  # crypto_box_SEALBYTES
BOX_PUBLICKEYBYTES = 32
BOX_SECRETKEYBYTES = 32
SIGN_PUBLICKEYBYTES = 32
SIGN_SECRETKEYBYTES = 64
SIGN_BYTES = 64

_u8p = ctypes.POINTER(ctypes.c_uint8)
_sizep = ctypes.POINTER(ctypes.c_size_t)
_bytes = ctypes.c_char_p
# the C signatures of the library's crypto entry points (nacl.cpp,
# sealed_batch.cpp), each returning int
_ARGTYPES = {
    "sda_x25519": [ctypes.c_char_p, _bytes, _bytes],
    "sda_x25519_base": [ctypes.c_char_p, _bytes],
    "sda_box_keypair": [ctypes.c_char_p, ctypes.c_char_p],
    "sda_box_seal": [ctypes.c_char_p, _bytes, ctypes.c_uint64, _bytes, _bytes],
    "sda_box_seal_open": [ctypes.c_char_p, _bytes, ctypes.c_uint64, _bytes, _bytes],
    "sda_sign_seed_keypair": [ctypes.c_char_p, ctypes.c_char_p, _bytes],
    "sda_sign_keypair": [ctypes.c_char_p, ctypes.c_char_p],
    "sda_sign_detached": [ctypes.c_char_p, _bytes, ctypes.c_uint64, _bytes],
    "sda_sign_verify_detached": [_bytes, _bytes, ctypes.c_uint64, _bytes],
    "sda_sealed_open_batch": [
        _u8p, _sizep, ctypes.c_size_t, _bytes, _bytes,
        ctypes.POINTER(ctypes.c_int64), _sizep, _sizep, ctypes.c_int,
    ],
    "sda_sealed_open_combine": [
        _u8p, _sizep, ctypes.c_size_t, _bytes, _bytes, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t, ctypes.c_int, _sizep,
    ],
}


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The port's native library with its crypto signatures set, built on
    the first call; raises ``RuntimeError`` when it is unavailable."""
    from sda_tpu_torch.ops.native_build import load_native_library

    lib = load_native_library(required=True)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def box_keypair() -> tuple[bytes, bytes]:
    """Generate an X25519 keypair: ``(public 32B, secret 32B)``."""
    pk = ctypes.create_string_buffer(BOX_PUBLICKEYBYTES)
    sk = ctypes.create_string_buffer(BOX_SECRETKEYBYTES)
    if _lib().sda_box_keypair(pk, sk) != 0:
        raise RuntimeError("box keypair: getrandom failed")
    return pk.raw, sk.raw


def seal(message: bytes, public_key: bytes) -> bytes:
    """Anonymous-sender sealed box (sodium.rs:43)."""
    if len(public_key) != BOX_PUBLICKEYBYTES:
        raise Invalid("bad sodium public key length")
    out = ctypes.create_string_buffer(len(message) + SEALBYTES)
    if _lib().sda_box_seal(out, message, len(message), public_key, None) != 0:
        raise Invalid("sodium seal failure")
    return out.raw


def seal_open(ciphertext: bytes, public_key: bytes, secret_key: bytes) -> bytes:
    """Open a sealed box (sodium.rs:78); raises on forgery/corruption."""
    if len(ciphertext) < SEALBYTES:
        raise Invalid("Sodium decryption failure")
    if len(public_key) != BOX_PUBLICKEYBYTES or len(secret_key) != BOX_SECRETKEYBYTES:
        raise Invalid("bad sodium key length")
    out = ctypes.create_string_buffer(len(ciphertext) - SEALBYTES)
    rc = _lib().sda_box_seal_open(out, ciphertext, len(ciphertext), public_key, secret_key)
    if rc != 0:
        raise Invalid("Sodium decryption failure")
    return out.raw


def sign_keypair() -> tuple[bytes, bytes]:
    """Generate an Ed25519 keypair: ``(verify 32B, signing 64B)``."""
    vk = ctypes.create_string_buffer(SIGN_PUBLICKEYBYTES)
    sk = ctypes.create_string_buffer(SIGN_SECRETKEYBYTES)
    if _lib().sda_sign_keypair(vk, sk) != 0:
        raise RuntimeError("sign keypair: getrandom failed")
    return vk.raw, sk.raw


def sign_detached(message: bytes, signing_key: bytes) -> bytes:
    """Detached Ed25519 signature (signing/mod.rs:92)."""
    if len(signing_key) != SIGN_SECRETKEYBYTES:
        raise Invalid("bad signing key length")
    sig = ctypes.create_string_buffer(SIGN_BYTES)
    _lib().sda_sign_detached(sig, message, len(message), signing_key)
    return sig.raw


def verify_detached(signature: bytes, message: bytes, verify_key: bytes) -> bool:
    """Verify a detached signature (signing/mod.rs:126); returns bool."""
    if len(signature) != SIGN_BYTES or len(verify_key) != SIGN_PUBLICKEYBYTES:
        return False
    return _lib().sda_sign_verify_detached(signature, message, len(message), verify_key) == 0


def random_bytes(n: int) -> bytes:
    return os.urandom(n)
