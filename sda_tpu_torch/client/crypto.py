"""Client crypto module: key management, sealed boxes, signatures, schemes.

The CryptoModule factory equivalent
(client/src/crypto/mod.rs:58-66): constructs maskers, share
generators/combiners/reconstructors, encryptors/decryptors and signing
helpers from the scheme descriptors carried inside an Aggregation.
"""

from __future__ import annotations

import numpy as np

from sda_tpu_torch import protocol as proto
from sda_tpu_torch import sodium
from sda_tpu_torch.masking import masker_for_scheme
from sda_tpu_torch.utils.errors import Invalid
from sda_tpu_torch.utils.varint import decode_varints, encode_varints

__all__ = ["Keystore", "CryptoModule", "ShareEncryptor", "ShareDecryptor"]


class Keystore:
    """Key storage over a client store (crypto/mod.rs:38-52).

    Encryption keypairs are stored as ``{"ek": b64, "dk": b64}`` and
    signature keypairs as ``{"vk": b64, "sk": b64}``, keyed by key id.
    """

    def __init__(self, store):
        self.store = store

    def put_encryption_keypair(self, key_id: str, ek: bytes, dk: bytes) -> None:
        self.store.put(f"ekey:{key_id}", {"ek": ek.hex(), "dk": dk.hex()})

    def get_encryption_keypair(self, key_id: str):
        obj = self.store.get(f"ekey:{key_id}")
        if obj is None:
            return None
        return bytes.fromhex(obj["ek"]), bytes.fromhex(obj["dk"])

    def put_signature_keypair(self, key_id: str, vk: bytes, sk: bytes) -> None:
        self.store.put(f"skey:{key_id}", {"vk": vk.hex(), "sk": sk.hex()})

    def get_signature_keypair(self, key_id: str):
        obj = self.store.get(f"skey:{key_id}")
        if obj is None:
            return None
        return bytes.fromhex(obj["vk"]), bytes.fromhex(obj["sk"])


class ShareEncryptor:
    """Varint-encode then seal shares for one recipient key (sodium.rs:33-46)."""

    def __init__(self, encryption_key: proto.EncryptionKey):
        self._pk = encryption_key.data

    def encrypt(self, shares) -> proto.Encryption:
        encoded = encode_varints(np.asarray(shares, dtype=np.int64))
        return proto.Encryption(data=sodium.seal(encoded, self._pk))


class ShareDecryptor:
    """Open a sealed box and varint-decode shares (sodium.rs:72-92)."""

    def __init__(self, ek: bytes, dk: bytes):
        self._ek = ek
        self._dk = dk

    def decrypt(self, encryption: proto.Encryption) -> np.ndarray:
        raw = sodium.seal_open(encryption.data, self._ek, self._dk)
        return decode_varints(raw)

    def open_combine(
        self, encryptions, modulus: int, dim: int, workers: int | None = None
    ):
        """Fused clerk combine: open + decode + modular-accumulate in ONE
        native call, never materialising the decoded share matrix
        (sda_tpu_torch/native/sealed_batch.cpp — the streaming answer to
        clerk.rs:71-72).

        Returns the combined vector with canonical ``[0, p)`` representatives
        (protocol-equivalent to the reference's signed fold, same convention
        as :func:`sda_tpu_torch.engine.device_combine`), or ``None`` when
        ``modulus`` is outside ``(0, 2^63)``, where the native accumulate
        does not apply (the caller then decrypts and combines). ``dim`` is
        the per-clerk share count every box must decode to; a mismatch
        raises ``Invalid`` like the sequential combine's dimension check, a
        tampered box raises ``Invalid`` like ``decrypt`` and a malformed
        varint stream raises ``ValueError`` like ``decode_varints``. When the
        native library cannot be built it raises ``RuntimeError``.
        """
        import ctypes

        if not (0 < modulus < (1 << 63)):
            return None
        fn = sodium._lib().sda_sealed_open_combine
        staged = _stage_boxes(encryptions)
        if staged is None:
            # empty job: the additive identity at the declared dimension
            # (the documented contract — a combined dim-length vector)
            return np.zeros(dim, dtype=np.int64)
        blob, offs, count = staged
        combined = np.empty(dim, dtype=np.int64)
        fail = ctypes.c_size_t(0)
        rc = fn(
            blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
            count, self._ek, self._dk,
            ctypes.c_uint64(modulus),
            combined.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dim,
            _default_workers(workers),
            ctypes.byref(fail),
        )
        if rc == 0:
            return combined
        if rc == -2:
            raise Invalid("sodium seal_open failure (tampered or wrong key)")
        if rc == -3:
            raise ValueError("malformed varint stream")
        raise Invalid("Wrong dimension")

    def decrypt_many(self, encryptions, workers: int | None = None) -> list:
        """Bulk decryption of a clerking job's share vectors.

        The reference opens every participation's sealed box sequentially
        inside the clerk hot loop (clerk.rs:78-82, with the FIXME at 71-72
        about exactly this). From 8 boxes on, ONE native call
        (sda_tpu_torch/native/sealed_batch.cpp) runs seal_open + varint
        decode for the whole job on a C++ thread pool, no per-box
        interpreter overhead; below that the boxes are opened one by one.
        Order is preserved; any tampered box raises ``Invalid`` exactly as
        the sequential path does.
        """
        encryptions = list(encryptions)
        if len(encryptions) < 8:
            return [self.decrypt(e) for e in encryptions]
        return _native_open_batch(encryptions, self._ek, self._dk, workers)


_SEAL_BYTES = 48  # crypto_box_SEALBYTES


def _stage_boxes(encryptions):
    """Contiguous (blob, offsets, count) staging for a list of sealed
    boxes, shared by both native entry points. ``None`` for an empty job."""
    datas = [e.data for e in encryptions]
    if not datas:
        return None
    offs = np.zeros(len(datas) + 1, dtype=np.uintp)
    offs[1:] = np.cumsum([len(d) for d in datas], dtype=np.uint64)
    blob = np.frombuffer(b"".join(datas), dtype=np.uint8)
    return blob, offs, len(datas)


def _default_workers(workers):
    import os

    return workers or min(32, os.cpu_count() or 1)


def _native_open_batch(encryptions, ek: bytes, dk: bytes, workers):
    """Whole-job sealed-box open via sda_tpu_torch/native/sealed_batch.cpp.

    Decoded values land in ONE flat buffer at per-box offsets derived from
    each box's plaintext size (a plaintext byte yields at most one varint),
    so the allocation is bounded by 8x the job's wire size and a single
    oversized box cannot inflate every row.
    """
    import ctypes

    fn = sodium._lib().sda_sealed_open_batch
    staged = _stage_boxes(encryptions)
    if staged is None:
        return []
    blob, offs, count = staged
    # per-box output capacity = plaintext bytes (box minus the 48-byte seal)
    out_offs = np.zeros(count + 1, dtype=np.uintp)
    out_offs[1:] = np.cumsum(
        [max(len(e.data) - _SEAL_BYTES, 0) for e in encryptions],
        dtype=np.uint64,
    )
    out = np.empty(int(out_offs[-1]), dtype=np.int64)
    lens = np.empty(count, dtype=np.uintp)
    fn(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        count, ek, dk,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        _default_workers(workers),
    )  # returns 0: each box's failure is in lens
    open_failed = np.uintp((1 << 64) - 1)  # SIZE_MAX
    decode_failed = np.uintp((1 << 64) - 2)  # SIZE_MAX - 1
    result = []
    for i in range(count):
        if lens[i] == open_failed:
            raise Invalid("sodium seal_open failure (tampered or wrong key)")
        if lens[i] == decode_failed:
            raise ValueError("malformed varint stream")
        start = int(out_offs[i])
        result.append(out[start : start + int(lens[i])].copy())
    return result


class CryptoModule:
    def __init__(self, keystore: Keystore):
        self.keystore = keystore

    # ------------------------------------------------------------ keygen

    def new_signature_key(self) -> proto.Labelled:
        """Fresh Ed25519 keypair, stored; returns the labelled public part
        (signing/mod.rs:28-60)."""
        vk, sk = sodium.sign_keypair()
        key_id = proto.new_id()
        self.keystore.put_signature_keypair(key_id, vk, sk)
        return proto.Labelled(id=key_id, body=proto.VerificationKey(vk))

    def new_encryption_key(self) -> str:
        """Fresh X25519 keypair, stored; returns the key id (sodium.rs:95-109)."""
        ek, dk = sodium.box_keypair()
        key_id = proto.new_id()
        self.keystore.put_encryption_keypair(key_id, ek, dk)
        return key_id

    # ----------------------------------------------------------- signing

    def sign_export(self, signer: proto.Agent, key_id: str):
        """Sign the canonical JSON of a labelled encryption key
        (signing/mod.rs:72-103)."""
        pair = self.keystore.get_encryption_keypair(key_id)
        if pair is None:
            return None
        ek, _ = pair
        labelled = proto.Labelled(id=key_id, body=proto.EncryptionKey(ek))
        sig_pair = self.keystore.get_signature_keypair(signer.verification_key.id)
        if sig_pair is None:
            return None
        _, sk = sig_pair
        signature = sodium.sign_detached(proto.canonical(labelled), sk)
        return proto.Signed(
            signature=proto.Signature(signature), signer=signer.id, body=labelled
        )

    @staticmethod
    def signature_is_valid(agent: proto.Agent, signed: proto.Signed) -> bool:
        """Verify signer id + detached signature (signing/mod.rs:106-132)."""
        if signed.signer != agent.id:
            raise Invalid("Agent differs from claimed signer")
        return sodium.verify_detached(
            signed.signature.data,
            proto.canonical(signed.body),
            agent.verification_key.body.data,
        )

    # -------------------------------------------------------- encryption

    def new_share_encryptor(self, encryption_key, scheme) -> ShareEncryptor:
        if not isinstance(scheme, proto.SodiumEncryptionScheme):
            raise Invalid(f"unsupported encryption scheme {scheme!r}")
        return ShareEncryptor(encryption_key)

    def new_share_decryptor(self, key_id: str, scheme) -> ShareDecryptor:
        if not isinstance(scheme, proto.SodiumEncryptionScheme):
            raise Invalid(f"unsupported encryption scheme {scheme!r}")
        pair = self.keystore.get_encryption_keypair(key_id)
        if pair is None:
            raise Invalid("Could not load keypair for decryption")
        return ShareDecryptor(*pair)

    # ----------------------------------------------------------- schemes

    @staticmethod
    def new_secret_masker(scheme, device_bulk_threshold: int | None = None,
                          routing=None, device=None):
        return masker_for_scheme(
            scheme, device_bulk_threshold=device_bulk_threshold, routing=routing,
            device=device,
        )

    @staticmethod
    def new_share_generator(scheme):
        return scheme.engine()

    @staticmethod
    def new_share_combiner(scheme):
        return scheme.engine()

    @staticmethod
    def new_secret_reconstructor(scheme):
        return scheme.engine()
