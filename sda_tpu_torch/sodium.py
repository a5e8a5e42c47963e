"""Native libsodium bindings (ctypes) for sealed boxes and Ed25519.

The reference consumes libsodium through the `sodiumoxide` Rust crate
(client/src/crypto/encryption/sodium.rs:43,78 sealed boxes;
signing/mod.rs:92,126 detached Ed25519). We bind the very same C library
directly, so ciphertexts and signatures are wire-compatible:

- sealed box = X25519 + XSalsa20-Poly1305 with an ephemeral sender key
  (``crypto_box_seal`` / ``crypto_box_seal_open``);
- signatures = Ed25519 detached (``crypto_sign_detached`` /
  ``crypto_sign_verify_detached``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

from sda_tpu_torch.utils.errors import Invalid

SEALBYTES = 48  # crypto_box_SEALBYTES
BOX_PUBLICKEYBYTES = 32
BOX_SECRETKEYBYTES = 32
SIGN_PUBLICKEYBYTES = 32
SIGN_SECRETKEYBYTES = 64
SIGN_BYTES = 64


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("sodium") or "libsodium.so.23"
    lib = ctypes.CDLL(name)
    if lib.sodium_init() < 0:  # one-time init guard, like sodium.rs:8,19
        raise RuntimeError("libsodium failed to initialise")
    return lib


def box_keypair() -> tuple[bytes, bytes]:
    """Generate an X25519 keypair: ``(public 32B, secret 32B)``."""
    lib = _lib()
    pk = ctypes.create_string_buffer(BOX_PUBLICKEYBYTES)
    sk = ctypes.create_string_buffer(BOX_SECRETKEYBYTES)
    lib.crypto_box_keypair(pk, sk)
    return pk.raw, sk.raw


def seal(message: bytes, public_key: bytes) -> bytes:
    """Anonymous-sender sealed box (sodium.rs:43)."""
    if len(public_key) != BOX_PUBLICKEYBYTES:
        raise Invalid("bad sodium public key length")
    lib = _lib()
    out = ctypes.create_string_buffer(len(message) + SEALBYTES)
    rc = lib.crypto_box_seal(out, message, ctypes.c_ulonglong(len(message)), public_key)
    if rc != 0:
        raise Invalid("sodium seal failure")
    return out.raw


def seal_open(ciphertext: bytes, public_key: bytes, secret_key: bytes) -> bytes:
    """Open a sealed box (sodium.rs:78); raises on forgery/corruption."""
    if len(ciphertext) < SEALBYTES:
        raise Invalid("Sodium decryption failure")
    lib = _lib()
    out = ctypes.create_string_buffer(len(ciphertext) - SEALBYTES)
    rc = lib.crypto_box_seal_open(
        out, ciphertext, ctypes.c_ulonglong(len(ciphertext)), public_key, secret_key
    )
    if rc != 0:
        raise Invalid("Sodium decryption failure")
    return out.raw


def sign_keypair() -> tuple[bytes, bytes]:
    """Generate an Ed25519 keypair: ``(verify 32B, signing 64B)``."""
    lib = _lib()
    vk = ctypes.create_string_buffer(SIGN_PUBLICKEYBYTES)
    sk = ctypes.create_string_buffer(SIGN_SECRETKEYBYTES)
    lib.crypto_sign_keypair(vk, sk)
    return vk.raw, sk.raw


def sign_detached(message: bytes, signing_key: bytes) -> bytes:
    """Detached Ed25519 signature (signing/mod.rs:92)."""
    lib = _lib()
    sig = ctypes.create_string_buffer(SIGN_BYTES)
    lib.crypto_sign_detached(
        sig, None, message, ctypes.c_ulonglong(len(message)), signing_key
    )
    return sig.raw


def verify_detached(signature: bytes, message: bytes, verify_key: bytes) -> bool:
    """Verify a detached signature (signing/mod.rs:126); returns bool."""
    if len(signature) != SIGN_BYTES:
        return False
    lib = _lib()
    rc = lib.crypto_sign_verify_detached(
        signature, message, ctypes.c_ulonglong(len(message)), verify_key
    )
    return rc == 0


def random_bytes(n: int) -> bytes:
    lib = _lib()
    buf = ctypes.create_string_buffer(n)
    lib.randombytes_buf(buf, ctypes.c_size_t(n))
    return buf.raw
