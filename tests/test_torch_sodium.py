"""The port's own sealed boxes and Ed25519 (``sda_tpu_torch/native/nacl.cpp``
through :mod:`sda_tpu_torch.sodium`) held byte for byte against libsodium,
which the reference binds (``sda_tpu.sodium`` and its ``_lib()``):

- X25519 public keys and shared secrets, RFC 7748 § 6.1, and the refusal of
  an all-zero shared secret;
- ``crypto_sign_seed_keypair`` keys and detached signatures, RFC 8032 § 7.1
  tests 1-3;
- a sealed box with a fixed ephemeral key against ``crypto_box_easy`` with
  the BLAKE2b-192 nonce of ``epk || pk``, at message lengths around the
  Salsa20 and Poly1305 block edges and about 3 MB;
- seal/open across the two libraries, both ways;
- the same accept/reject as libsodium on mutated boxes, signatures and
  public keys (``hypothesis``): S + L, points of small order, encodings at
  or past p, all-zero keys, bit flips;
- the batch open and the fused open + combine equal to the sequential path
  on one clerk job;
- the rest of ``tests/test_crypto_host.py``: tamper and anonymous-sender
  boxes, signature refusals, the signed key export, the batch open of
  ragged boxes, the fused open + combine at 2^63 - 871, on an empty job and
  its error parity with the reference's (type and message);
- with libsodium refused to the process, the port's loop still reveals.
"""

import ctypes
import hashlib
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from sda_tpu import sodium as ref_sodium
from sda_tpu_torch import protocol as proto
from sda_tpu_torch import sodium
from sda_tpu_torch.client.crypto import ShareDecryptor
from sda_tpu_torch.fields import positive
from sda_tpu_torch.sharing import AdditiveScheme
from sda_tpu_torch.utils.errors import Invalid
from sda_tpu_torch.utils.varint import encode_varints

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = [0, 1, 15, 16, 17, 63, 64, 65, 3_000_017]
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
# the y of the points of order 8 (and p - y); with 0, 1 and p - 1 the
# y-coordinates of every point of small order
Y8 = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")
Y8N = bytes.fromhex("c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a")


def _le(x: int) -> bytes:
    return x.to_bytes(32, "little")


def _signed(enc: bytes, sign: int) -> bytes:
    return enc[:31] + bytes([(enc[31] & 0x7F) | (sign << 7)])


# small-order y (canonical and past p), each with both sign bits; every y
# at or past p; all-zero and all-one words
SPECIAL_POINTS = sorted({
    _signed(enc, sign)
    for enc in (_le(0), _le(1), _le(P - 1), Y8, Y8N, _le(P), _le(P + 1), _le(P + 2),
                _le(2**255 - 1), _le(P + 18))
    for sign in (0, 1)
} | {bytes(32), b"\xff" * 32})
# X25519 u-coordinates of small order and their encodings past p
SMALL_U = [_le(0), _le(1), _le(P - 1), _le(P), _le(P + 1),
           _le(325606250916557431795983626356110631294008115727848805560023387167927233504),
           _le(39382357235489614581723060781553021112529911719440698176882885853963445705823)]


@pytest.fixture(scope="module")
def lib():
    return sodium._lib()


@pytest.fixture(scope="module")
def ref():
    return ref_sodium._lib()


def _buf(n: int):
    return ctypes.create_string_buffer(n)


def _port_x25519(lib, n: bytes, u: bytes):
    q = _buf(32)
    return lib.sda_x25519(q, n, u), q.raw


def _ref_x25519(ref, n: bytes, u: bytes):
    q = _buf(32)
    return ref.crypto_scalarmult(q, n, u), q.raw


def _port_seed_keypair(lib, seed: bytes):
    pk, sk = _buf(32), _buf(64)
    assert lib.sda_sign_seed_keypair(pk, sk, seed) == 0
    return pk.raw, sk.raw


def _ref_seed_keypair(ref, seed: bytes):
    pk, sk = _buf(32), _buf(64)
    assert ref.crypto_sign_seed_keypair(pk, sk, seed) == 0
    return pk.raw, sk.raw


def _port_seal_with(lib, m: bytes, pk: bytes, esk: bytes):
    out = _buf(len(m) + 48)
    return lib.sda_box_seal(out, m, len(m), pk, esk), out.raw


def _ref_seal_with(ref, m: bytes, pk: bytes, esk: bytes) -> bytes:
    """libsodium's crypto_box_seal with a chosen ephemeral key."""
    epk = _buf(32)
    assert ref.crypto_scalarmult_base(epk, esk) == 0
    nonce = hashlib.blake2b(epk.raw + pk, digest_size=24).digest()
    box = _buf(len(m) + 16)
    assert ref.crypto_box_easy(box, m, ctypes.c_ulonglong(len(m)), nonce, pk, esk) == 0
    return epk.raw + box.raw


def _ref_verify(ref, sig: bytes, m: bytes, pk: bytes) -> bool:
    return ref.crypto_sign_verify_detached(sig, m, ctypes.c_ulonglong(len(m)), pk) == 0


def _ref_open(ref, box: bytes, pk: bytes, sk: bytes):
    out = _buf(max(len(box) - 48, 1))
    if len(box) < 48:
        return None
    rc = ref.crypto_box_seal_open(out, box, ctypes.c_ulonglong(len(box)), pk, sk)
    return out.raw[: len(box) - 48] if rc == 0 else None


def _port_open(box: bytes, pk: bytes, sk: bytes):
    try:
        return sodium.seal_open(box, pk, sk)
    except Invalid:
        return None


# ------------------------------------------------------------------ X25519


def test_x25519_rfc7748_vectors(lib):
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    pa, pb = _buf(32), _buf(32)
    assert lib.sda_x25519_base(pa, a) == 0 and lib.sda_x25519_base(pb, b) == 0
    assert pa.raw.hex() == "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    assert pb.raw.hex() == "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert _port_x25519(lib, a, pb.raw) == (0, bytes.fromhex(shared))
    assert _port_x25519(lib, b, pa.raw) == (0, bytes.fromhex(shared))


def test_x25519_keys_and_shared_secrets_equal_libsodium(lib, ref):
    rng = np.random.default_rng(7)
    # random words, u past p (bit 255 set or not) and the small-order u
    points = [rng.bytes(32) for _ in range(64)] + [_le(P + 18), b"\xff" * 32] + SMALL_U
    for u in points:
        n = rng.bytes(32)
        got, want = _port_x25519(lib, n, u), _ref_x25519(ref, n, u)
        assert got[0] == want[0], u.hex()
        if want[0] == 0:
            assert got[1] == want[1]
        pk, ref_pk = _buf(32), _buf(32)
        assert lib.sda_x25519_base(pk, n) == 0 and ref.crypto_scalarmult_base(ref_pk, n) == 0
        assert pk.raw == ref_pk.raw
    for u in SMALL_U:  # every small-order point gives the refused all-zero secret
        assert _port_x25519(lib, rng.bytes(32), u)[0] == -1


# ----------------------------------------------------------------- Ed25519

RFC8032 = [  # (secret seed, public key, message, signature), RFC 8032 § 7.1 tests 1-3
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9"
     "b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f1"
     "1d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67f760984d"
     "c6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("case", range(len(RFC8032)))
def test_ed25519_rfc8032_vectors(lib, case):
    seed, pk, msg, sig = (bytes.fromhex(x) for x in RFC8032[case])
    vk, sk = _port_seed_keypair(lib, seed)
    assert vk == pk and sk == seed + pk
    assert sodium.sign_detached(msg, sk) == sig
    assert sodium.verify_detached(sig, msg, pk)


@pytest.mark.parametrize("length", LENGTHS)
def test_sign_keys_and_signatures_equal_libsodium(lib, ref, length):
    rng = np.random.default_rng(length)
    seed, msg = rng.bytes(32), rng.bytes(length)
    vk, sk = _port_seed_keypair(lib, seed)
    assert (vk, sk) == _ref_seed_keypair(ref, seed)
    sig = sodium.sign_detached(msg, sk)
    assert sig == ref_sodium.sign_detached(msg, sk)
    assert sodium.verify_detached(sig, msg, vk) and ref_sodium.verify_detached(sig, msg, vk)
    fresh_vk, fresh_sk = sodium.sign_keypair()
    assert ref_sodium.verify_detached(sodium.sign_detached(msg, fresh_sk), msg, fresh_vk)


# -------------------------------------------------------------- sealed box


@pytest.mark.parametrize("length", LENGTHS)
def test_sealed_box_with_fixed_ephemeral_key_equals_libsodium(lib, ref, length):
    rng = np.random.default_rng(100 + length)
    sk, esk, msg = rng.bytes(32), rng.bytes(32), rng.bytes(length)
    pk = _buf(32)
    assert ref.crypto_scalarmult_base(pk, sk) == 0
    rc, box = _port_seal_with(lib, msg, pk.raw, esk)
    assert rc == 0 and len(box) == length + sodium.SEALBYTES
    assert box == _ref_seal_with(ref, msg, pk.raw, esk)
    assert sodium.seal_open(box, pk.raw, sk) == msg


@pytest.mark.parametrize("length", LENGTHS)
def test_seal_and_open_across_libraries(length):
    msg = np.random.default_rng(200 + length).bytes(length)
    ek, dk = sodium.box_keypair()
    ref_ek, ref_dk = ref_sodium.box_keypair()
    assert ref_sodium.seal_open(sodium.seal(msg, ref_ek), ref_ek, ref_dk) == msg
    assert sodium.seal_open(ref_sodium.seal(msg, ek), ek, dk) == msg
    assert sodium.seal(msg, ek) != sodium.seal(msg, ek)  # a fresh ephemeral key each


def test_seal_to_a_small_order_key_fails_like_libsodium(lib, ref):
    rng = np.random.default_rng(9)
    for u in SMALL_U:
        esk = rng.bytes(32)
        assert _port_seal_with(lib, b"abc", u, esk)[0] == -1
        assert ref.crypto_box_easy(_buf(19), b"abc", ctypes.c_ulonglong(3), bytes(24), u,
                                   esk) == -1
        with pytest.raises(Invalid):
            sodium.seal(b"abc", u)


# ------------------------------------------------- accept/reject (mutated)

_BOX_SK = np.random.default_rng(11).bytes(32)
_SIGN_SEED = np.random.default_rng(12).bytes(32)


def _box_pk() -> bytes:
    pk = _buf(32)
    ref_sodium._lib().crypto_scalarmult_base(pk, _BOX_SK)
    return pk.raw


@settings(max_examples=150, deadline=None)
@given(msg=st.binary(max_size=150), flips=st.lists(st.integers(0, 8 * 198 - 1), max_size=3),
       cut=st.sampled_from([0, 0, 0, 1, 16, 47, 48, 49, 400]),
       epk=st.sampled_from([None, *SMALL_U]))
def test_mutated_boxes_open_like_libsodium(msg, flips, cut, epk):
    pk = _box_pk()
    box = bytearray(ref_sodium.seal(msg, pk))
    for bit in flips:
        if bit < 8 * len(box):
            box[bit // 8] ^= 1 << (bit % 8)
    if epk is not None:
        box[:32] = epk
    box = bytes(box[: max(0, len(box) - cut)])
    got, want = _port_open(box, pk, _BOX_SK), _ref_open(ref_sodium._lib(), box, pk, _BOX_SK)
    assert got == want
    if not flips and epk is None and cut == 0:
        assert got == msg


def _mutate_signature(sig: bytes, kind: str, data: bytes) -> bytes:
    r, s = sig[:32], int.from_bytes(sig[32:], "little")
    if kind == "s_plus_l":
        return r + _le(s + L)
    if kind == "s_plus_8l":
        return r + _le((s + 8 * L) % 2**256)
    if kind == "s_is_l":
        return r + _le(L)
    if kind == "s_random":
        return r + data[:32]
    if kind == "r_special":
        return SPECIAL_POINTS[data[0] % len(SPECIAL_POINTS)] + sig[32:]
    if kind == "flip":
        i = data[0] % 64
        return sig[:i] + bytes([sig[i] ^ (1 << (data[1] % 8))]) + sig[i + 1:]
    if kind == "random":
        return data[:64]
    return sig


@settings(max_examples=300, deadline=None)
@given(msg=st.binary(max_size=300),
       kind=st.sampled_from(["none", "s_plus_l", "s_plus_8l", "s_is_l", "s_random",
                             "r_special", "flip", "random"]),
       data=st.binary(min_size=64, max_size=64), other_msg=st.booleans())
def test_mutated_signatures_verify_like_libsodium(msg, kind, data, other_msg):
    vk, sk = _ref_seed_keypair(ref_sodium._lib(), _SIGN_SEED)
    sig = _mutate_signature(ref_sodium.sign_detached(msg, sk), kind, data)
    m = msg + b"!" if other_msg else msg
    want = _ref_verify(ref_sodium._lib(), sig, m, vk)
    assert sodium.verify_detached(sig, m, vk) == want
    if kind == "none" and not other_msg:
        assert want


@settings(max_examples=300, deadline=None)
@given(msg=st.binary(max_size=64),
       pk_kind=st.sampled_from(["special", "random", "flip", "zero"]),
       pick=st.integers(0, 10**6), data=st.binary(min_size=32, max_size=32),
       r_special=st.booleans())
def test_mutated_public_keys_verify_like_libsodium(msg, pk_kind, pick, data, r_special):
    """Points of small order, encodings at or past p (both sign bits), random
    words (most do not decode), bit flips of a real key and the all-zero
    key; the signature is the real one, or one with a small-order R and
    S = 0, which the identity-like keys would otherwise accept."""
    vk, sk = _ref_seed_keypair(ref_sodium._lib(), _SIGN_SEED)
    sig = ref_sodium.sign_detached(msg, sk)
    if pk_kind == "special":
        pk = SPECIAL_POINTS[pick % len(SPECIAL_POINTS)]
    elif pk_kind == "random":
        pk = data
    elif pk_kind == "flip":
        i = pick % 256
        pk = vk[: i // 8] + bytes([vk[i // 8] ^ (1 << (i % 8))]) + vk[i // 8 + 1:]
    else:
        pk = bytes(32)
    if r_special:
        sig = SPECIAL_POINTS[pick % len(SPECIAL_POINTS)] + bytes(32)
    want = _ref_verify(ref_sodium._lib(), sig, msg, pk)
    assert sodium.verify_detached(sig, msg, pk) == want


# ------------------------------------------------------- the clerk's batch


def test_batch_open_and_open_combine_equal_the_sequential_path():
    """One clerk job of 40 boxes: decrypt_many (the native batch) equals the
    box-by-box open, open_combine equals the scheme's combine mod p, and a
    tampered box raises Invalid on every route."""
    p = 433
    rng = np.random.default_rng(5)
    ek, dk = sodium.box_keypair()
    rows = rng.integers(-p + 1, p, size=(40, 37), dtype=np.int64)
    encs = [proto.Encryption(data=ref_sodium.seal(encode_varints(r), ek)) for r in rows]
    dec = ShareDecryptor(ek, dk)
    seq = [dec.decrypt(e) for e in encs]
    assert all(np.array_equal(s, r) for s, r in zip(seq, rows))
    batch = dec.decrypt_many(encs, workers=3)
    assert all(np.array_equal(b, s) for b, s in zip(batch, seq))
    combined = AdditiveScheme(share_count=3, modulus=p).combine(seq)
    fused = dec.open_combine(encs, p, 37, workers=3)
    assert fused.tolist() == positive(combined, p).tolist()
    bad = encs[:17] + [proto.Encryption(data=encs[17].data[:-1] + b"\x00")] + encs[18:]
    for call in (lambda: dec.decrypt(bad[17]), lambda: dec.decrypt_many(bad),
                 lambda: dec.open_combine(bad, p, 37)):
        with pytest.raises(Invalid):
            call()


# ------------------------------------- the rest of tests/test_crypto_host.py


def test_sealed_box_roundtrip_tamper_and_anonymous_sender():
    """A box opens to its message; a flipped last byte or a box one byte
    shorter than the seal overhead raises Invalid; two seals of one
    message differ (each has its own ephemeral sender key)."""
    pk, sk = sodium.box_keypair()
    msg = b"attack at dawn" * 10
    boxed = sodium.seal(msg, pk)
    assert sodium.seal_open(boxed, pk, sk) == msg
    for bad in (boxed[:-1] + bytes([boxed[-1] ^ 1]), boxed[: sodium.SEALBYTES - 1]):
        with pytest.raises(Invalid, match="^Sodium decryption failure$"):
            sodium.seal_open(bad, pk, sk)
    assert sodium.seal(b"m", pk) != sodium.seal(b"m", pk)


def test_sign_verify_detached_refusals():
    vk, sk = sodium.sign_keypair()
    sig = sodium.sign_detached(b"payload", sk)
    assert sodium.verify_detached(sig, b"payload", vk)
    assert not sodium.verify_detached(sig, b"payloae", vk)
    assert not sodium.verify_detached(sig, b"payload", sodium.sign_keypair()[0])
    assert not sodium.verify_detached(b"short", b"payload", vk)
    assert ref_sodium.verify_detached(sig, b"payload", vk)  # libsodium takes the port's


def test_crypto_module_sign_export_verifies():
    """A signed export verifies for its signer (and in the reference's
    CryptoModule); a claimed-signer mismatch raises."""
    from sda_tpu import protocol as ref_proto
    from sda_tpu.client.crypto import CryptoModule as RefCryptoModule
    from sda_tpu_torch.client import Keystore, MemoryStore, new_agent
    from sda_tpu_torch.client.crypto import CryptoModule

    ks = Keystore(MemoryStore())
    cm = CryptoModule(ks)
    agent = new_agent(ks)
    signed = cm.sign_export(agent, cm.new_encryption_key())
    assert cm.signature_is_valid(agent, signed)
    assert RefCryptoModule.signature_is_valid(
        ref_proto.Agent.from_obj(agent.to_obj()),
        ref_proto.signed_encryption_key_from_obj(signed.to_obj()))
    with pytest.raises(Invalid, match="^Agent differs from claimed signer$"):
        cm.signature_is_valid(new_agent(Keystore(MemoryStore())), signed)


def _boxes(ek, vectors):
    return [proto.Encryption(data=sodium.seal(encode_varints(np.asarray(v, dtype=np.int64)), ek))
            for v in vectors]


def _ref_decryptor(ek, dk):
    from sda_tpu.client.crypto import ShareDecryptor as RefShareDecryptor

    return RefShareDecryptor(ek, dk)


def test_decrypt_many_ragged_boxes_match_sequential_and_reference():
    """Ten boxes of ragged lengths through the native batch: each equal to
    its vector and to the reference's batch; one tampered box raises."""
    from sda_tpu import protocol as ref_proto

    ek, dk = sodium.box_keypair()
    rng = np.random.default_rng(7)
    vecs = [rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
            for n in (5, 33, 1, 129, 64, 7, 12, 90, 2, 40)]
    encs = _boxes(ek, vecs)
    got = ShareDecryptor(ek, dk).decrypt_many(encs)
    want = _ref_decryptor(ek, dk).decrypt_many([ref_proto.Encryption(data=e.data) for e in encs])
    assert [g.tolist() for g in got] == [v.tolist() for v in vecs] == [
        np.asarray(w).tolist() for w in want]
    evil = list(encs)
    evil[4] = proto.Encryption(data=encs[4].data[:-1] + bytes([encs[4].data[-1] ^ 1]))
    with pytest.raises(Invalid, match=r"^sodium seal_open failure \(tampered or wrong key\)$"):
        ShareDecryptor(ek, dk).decrypt_many(evil)


def test_open_combine_at_p63_matches_the_fold_and_the_reference():
    """25 boxes at p = 2^63 - 871 (one of them negated, as wire shares in
    the truncated domain are): canonical, equal to the scheme's fold and to
    the reference's fused open + combine of the same boxes."""
    from sda_tpu import protocol as ref_proto

    p = (1 << 63) - 871
    ek, dk = sodium.box_keypair()
    rng = np.random.default_rng(3)
    vecs = [rng.integers(0, 1 << 62, size=47, dtype=np.int64) % p for _ in range(25)]
    vecs[3] = -vecs[3]
    encs = _boxes(ek, vecs)
    got = ShareDecryptor(ek, dk).open_combine(encs, p, 47)
    want = positive(AdditiveScheme(share_count=3, modulus=p).combine(vecs), p)
    assert got.tolist() == [int(x) for x in want]
    assert (got >= 0).all() and (got < p).all()
    ref = _ref_decryptor(ek, dk).open_combine([ref_proto.Encryption(data=e.data) for e in encs],
                                              p, 47)
    assert got.tolist() == ref.tolist()


def test_open_combine_empty_job_returns_dim_zeros():
    got = ShareDecryptor(*sodium.box_keypair()).open_combine([], 10_007, 9)
    assert got.shape == (9,) and got.dtype == np.int64 and not got.any()


def _bad_jobs(ek, encs):
    """(label, job, expected error type, its message) for each way a job is
    malformed, as the reference's error-parity cases build them."""
    tampered = list(encs)
    tampered[2] = proto.Encryption(data=encs[2].data[:-1] + bytes([encs[2].data[-1] ^ 1]))
    truncated = list(encs)
    truncated[1] = proto.Encryption(data=sodium.seal(b"\x80\x80", ek))
    short = list(encs)
    short[4] = _boxes(ek, [np.arange(5)])[0]
    long = list(encs)
    long[3] = _boxes(ek, [np.arange(11)])[0]
    return {
        "tampered": (tampered, Invalid, "sodium seal_open failure (tampered or wrong key)"),
        "malformed varint": (truncated, ValueError, "malformed varint stream"),
        "short share": (short, Invalid, "Wrong dimension"),
        "long share": (long, Invalid, "Wrong dimension"),
    }


@pytest.mark.parametrize("case", ["tampered", "malformed varint", "short share", "long share"])
def test_open_combine_error_parity(case):
    """A tampered box, a malformed varint stream, and a well-formed stream
    of fewer or more values than the job's dimension raise the same error
    type with the same message as the reference's fused open + combine."""
    from sda_tpu import protocol as ref_proto
    from sda_tpu.utils.errors import Invalid as RefInvalid

    ek, dk = sodium.box_keypair()
    encs = _boxes(ek, [np.arange(8)] * 6)
    job, error, message = _bad_jobs(ek, encs)[case]
    with pytest.raises(error) as got:
        ShareDecryptor(ek, dk).open_combine(job, 10_007, 8)
    assert str(got.value) == message
    ref_error = RefInvalid if error is Invalid else error
    with pytest.raises(ref_error) as want:
        _ref_decryptor(ek, dk).open_combine([ref_proto.Encryption(data=e.data) for e in job],
                                            10_007, 8)
    assert str(want.value) == message


def test_decrypt_many_error_parity_malformed_varint():
    """A well-sealed box of a truncated varint stream raises ValueError
    from the native batch, like the sequential decode."""
    ek, dk = sodium.box_keypair()
    encs = _boxes(ek, [np.arange(4)] * 9)
    encs[5] = proto.Encryption(data=sodium.seal(b"\xff\xff\xff", ek))
    with pytest.raises(ValueError, match="^malformed varint stream$"):
        ShareDecryptor(ek, dk).decrypt_many(encs)


def test_loop_reveals_with_libsodium_refused():
    """In a process where ctypes loads nothing named sodium and
    find_library finds nothing, the port's in-process loop (recipient, 8
    clerks, 2 participants, packed Shamir) reveals [2, 4, 6, 8]."""
    code = textwrap.dedent(
        """
        import ctypes, ctypes.util
        import numpy as np

        real_init = ctypes.CDLL.__init__

        def refuse(self, name, *args, **kwargs):
            if name is not None and "sodium" in str(name):
                raise OSError(f"refused: {name}")
            real_init(self, name, *args, **kwargs)

        ctypes.CDLL.__init__ = refuse
        ctypes.util.find_library = lambda name: None

        from sda_tpu_torch import protocol as proto
        from sda_tpu_torch.client import Keystore, MemoryStore, SdaClient, new_agent
        from sda_tpu_torch.server import new_memory_server

        def client(service, **kw):
            ks = Keystore(MemoryStore())
            return SdaClient(new_agent(ks), ks, service, device="cpu", **kw)

        service = new_memory_server()
        recipient = client(service)
        rkey = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(rkey)
        agg = proto.Aggregation(
            id=proto.new_id(), title="no libsodium", vector_dimension=4, modulus=433,
            recipient=recipient.agent.id, recipient_key=rkey,
            masking_scheme=proto.ChaChaMasking(modulus=433, dimension=4, seed_bitsize=128),
            committee_sharing_scheme=proto.PackedShamirSharing(
                secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
                omega_secrets=354, omega_shares=150),
        )
        recipient.upload_aggregation(agg)
        clerks = [client(service, device_bulk_threshold=1) for _ in range(8)]
        for c in clerks:
            key = c.new_encryption_key()
            c.upload_agent()
            c.upload_encryption_key(key)
        recipient.begin_aggregation(agg.id)
        for _ in range(2):
            part = client(service)
            part.upload_agent()
            part.participate(np.array([1, 2, 3, 4]), agg.id)
        recipient.end_aggregation(agg.id)
        recipient.run_chores(-1)
        for c in clerks:
            c.run_chores(-1)
        with open("/proc/self/maps") as maps:
            assert not [line for line in maps if "sodium" in line]
        print(recipient.reveal_aggregation(agg.id).positive().values.tolist())
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[2, 4, 6, 8]"


def test_the_library_is_required(monkeypatch):
    """With the library unbuildable the crypto raises and says why; the
    varint codec takes numpy."""
    from sda_tpu_torch.ops import native_build
    from sda_tpu_torch.utils import varint

    monkeypatch.setattr(native_build, "_loaded", [(None, "no C++ compiler (test)")])
    monkeypatch.setattr(varint, "_NATIVE", varint._UNLOADED)
    sodium._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            sodium.box_keypair()
        with pytest.raises(RuntimeError, match="native library is unavailable"):
            ShareDecryptor(bytes(32), bytes(32)).open_combine(
                [proto.Encryption(data=bytes(60))], 433, 1)
        assert varint.native_library() is None
        assert varint.decode_varints(varint.encode_varints(np.arange(5))).tolist() == list(range(5))
    finally:
        sodium._lib.cache_clear()
