"""The port's wire plane against sda_tpu's: protocol JSON, varint streams,
sealed boxes and signatures.

Every resource serialises to the same bytes in both packages and parses
from the other's; the frozen goldens under ``tests/golden/wire`` parse in
the port; varint streams agree in both directions with and without the
native fast path; a box sealed (a key signed) by one package opens
(verifies) in the other.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from sda_tpu import protocol as ref_proto
from sda_tpu import sodium as ref_sodium
from sda_tpu.client.crypto import ShareDecryptor as RefDecryptor
from sda_tpu.client.crypto import ShareEncryptor as RefEncryptor
from sda_tpu.utils import varint as ref_varint
from sda_tpu_torch import protocol as proto
from sda_tpu_torch import sodium
from sda_tpu_torch.client.crypto import ShareDecryptor, ShareEncryptor
from sda_tpu_torch.utils import varint

GOLDEN = Path(__file__).parent / "golden" / "wire"

AGENT_ID = "0de87e33-abb9-4d4b-a84a-b7c22f5ab79a"
VKEY_ID = "1bb1c200-b8b4-40bc-9eb2-66f5ca334338"
EKEY_ID = "2cc2d311-c9c5-51cd-8fc3-77a6db445449"
AGG_ID = "3dd3e422-dad6-62de-9ad4-88b7ec556550"
PART_ID = "4ee4f533-ebe7-73ef-8be5-99c8fd667661"
SNAP_ID = "5ff50644-fcf8-84f0-9cf6-aad90e778772"
JOB_ID = "60061755-0d09-9501-8d07-bbea1f889883"


def _instances(m):
    """One instance of every wire resource, built from protocol module ``m``
    (the goldens' values)."""
    vkey = m.Labelled(id=VKEY_ID, body=m.VerificationKey(bytes(range(32))))
    agent = m.Agent(id=AGENT_ID, verification_key=vkey)
    ekey = m.Labelled(id=EKEY_ID, body=m.EncryptionKey(bytes(range(32, 64))))
    enc = m.Encryption(b"ciphertext-bytes")
    result = m.ClerkingResult(job=JOB_ID, clerk=AGENT_ID, encryption=enc)
    status = m.SnapshotStatus(id=SNAP_ID, number_of_clerking_results=7, result_ready=True)
    return {
        "Agent": agent,
        "Profile": m.Profile(owner=AGENT_ID, name="Name", twitter_id="tw", keybase_id="kb",
                             website="https://x"),
        "SignedEncryptionKey": m.Signed(signature=m.Signature(bytes(range(64))),
                                        signer=AGENT_ID, body=ekey),
        "Aggregation": m.Aggregation(
            id=AGG_ID, title="wire fixture", vector_dimension=4, modulus=433,
            recipient=AGENT_ID, recipient_key=EKEY_ID,
            masking_scheme=m.ChaChaMasking(433, 4, 128),
            committee_sharing_scheme=m.PackedShamirSharing(3, 8, 4, 433, 354, 150),
        ),
        "AggregationAdditiveFull": m.Aggregation(
            id=AGG_ID, title="wire fixture 2", vector_dimension=10, modulus=433,
            recipient=AGENT_ID, recipient_key=EKEY_ID, masking_scheme=m.FullMasking(433),
            committee_sharing_scheme=m.AdditiveSharing(3, 433),
        ),
        "AggregationNoMasking": m.Aggregation(
            id=AGG_ID, title="no masking", vector_dimension=1_000_002,
            modulus=(1 << 63) - 871, recipient=AGENT_ID, recipient_key=EKEY_ID,
            masking_scheme=m.NoMasking(),
            committee_sharing_scheme=m.AdditiveSharing(8, (1 << 63) - 871),
        ),
        "ClerkCandidate": m.ClerkCandidate(id=AGENT_ID, keys=(EKEY_ID,)),
        "Committee": m.Committee(aggregation=AGG_ID, clerks_and_keys=((AGENT_ID, EKEY_ID),)),
        "Participation": m.Participation(id=PART_ID, participant=AGENT_ID, aggregation=AGG_ID,
                                         recipient_encryption=enc,
                                         clerk_encryptions=((AGENT_ID, enc),)),
        "ParticipationUnmasked": m.Participation(id=PART_ID, participant=AGENT_ID,
                                                 aggregation=AGG_ID, recipient_encryption=None,
                                                 clerk_encryptions=((AGENT_ID, enc),)),
        "Snapshot": m.Snapshot(id=SNAP_ID, aggregation=AGG_ID),
        "ClerkingJob": m.ClerkingJob(id=JOB_ID, clerk=AGENT_ID, aggregation=AGG_ID,
                                     snapshot=SNAP_ID, encryptions=(enc,)),
        "ClerkingResult": result,
        "SnapshotStatus": status,
        "AggregationStatus": m.AggregationStatus(aggregation=AGG_ID, number_of_participations=2,
                                                 snapshots=(status,)),
        "SnapshotResult": m.SnapshotResult(snapshot=SNAP_ID, number_of_participations=2,
                                           clerk_encryptions=(result,),
                                           recipient_encryptions=(enc,)),
        "AuthToken": m.AuthToken(id=AGENT_ID, body="sekret-token"),
        "Pong": m.Pong(running=True),
    }


def _from_obj(m, name):
    if name == "SignedEncryptionKey":
        return m.signed_encryption_key_from_obj
    base = name.replace("AdditiveFull", "").replace("NoMasking", "").replace("Unmasked", "")
    return getattr(m, base).from_obj


NAMES = sorted(_instances(proto))


@pytest.mark.parametrize("name", NAMES)
def test_wire_json_is_byte_equal_both_ways(name):
    mine, ref = _instances(proto)[name], _instances(ref_proto)[name]
    assert proto.canonical(mine) == ref_proto.canonical(ref)
    assert json.dumps(mine.to_obj(), indent=1) == json.dumps(ref.to_obj(), indent=1)
    # each package parses the other's bytes back to its own equal object
    assert _from_obj(proto, name)(json.loads(ref_proto.canonical(ref))) == mine
    assert _from_obj(ref_proto, name)(json.loads(proto.canonical(mine))) == ref


@pytest.mark.parametrize("path", sorted(GOLDEN.glob("*.json")), ids=lambda p: p.stem)
def test_goldens_parse_in_the_port(path):
    frozen = json.loads(path.read_text())
    obj = _from_obj(proto, path.stem)(frozen)
    assert obj.to_obj() == frozen
    assert obj == _instances(proto)[path.stem]


def test_canonical_signing_bytes_match_the_golden():
    ekey = proto.Labelled(id=EKEY_ID, body=proto.EncryptionKey(bytes(range(32, 64))))
    assert proto.canonical(ekey) == (GOLDEN / "canonical_labelled_key.bin").read_bytes()


def test_scheme_descriptors_round_trip_and_build_port_schemes():
    for scheme in (proto.AdditiveSharing(3, 433),
                   proto.PackedShamirSharing(3, 8, 4, 433, 354, 150)):
        obj = proto.sharing_scheme_to_obj(scheme)
        assert obj == ref_proto.sharing_scheme_to_obj(ref_proto.sharing_scheme_from_obj(obj))
        assert type(scheme.engine()).__module__ == "sda_tpu_torch.sharing"
    for scheme in (proto.NoMasking(), proto.FullMasking(433), proto.ChaChaMasking(433, 4, 128)):
        obj = proto.masking_scheme_to_obj(scheme)
        assert ref_proto.masking_scheme_to_obj(ref_proto.masking_scheme_from_obj(obj)) == obj
        assert proto.masking_scheme_from_obj(obj) == scheme


def _values():
    rng = np.random.default_rng(7)
    edge = np.array([0, 1, -1, 63, 64, -64, -65, (1 << 62), -(1 << 63), (1 << 63) - 1],
                    dtype=np.int64)
    return np.concatenate([edge, rng.integers(-(1 << 63), (1 << 63) - 1, size=2000,
                                              dtype=np.int64),
                           rng.integers(-300, 300, size=500, dtype=np.int64)])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_varint_streams_equal_both_ways(native, monkeypatch):
    if native:
        if varint.native_library() is None:
            pytest.fail("the native library did not build from native/ (no C++ compiler?)")
        assert ref_varint._NATIVE is not None
    else:
        monkeypatch.setattr(varint, "_NATIVE", None)
        monkeypatch.setattr(ref_varint, "_NATIVE", None)
    vals = _values()
    mine = varint.encode_varints(vals)
    assert mine == ref_varint.encode_varints(vals)
    assert np.array_equal(varint.decode_varints(ref_varint.encode_varints(vals)), vals)
    assert np.array_equal(ref_varint.decode_varints(mine), vals)
    for v in (0, -1, (1 << 63) - 1, -(1 << 63)):
        assert varint.encode_varint(v) == ref_varint.encode_varint(v)
        size = len(varint.encode_varint(v))
        assert varint.decode_varint(ref_varint.encode_varint(v)) == (v, size)
    with pytest.raises(ValueError):
        varint.decode_varints(b"\x80\x80")


def test_boxes_and_signatures_cross_packages():
    ek, dk = sodium.box_keypair()
    ref_ek, ref_dk = ref_sodium.box_keypair()
    msg = bytes(range(200))
    assert ref_sodium.seal_open(sodium.seal(msg, ref_ek), ref_ek, ref_dk) == msg
    assert sodium.seal_open(ref_sodium.seal(msg, ek), ek, dk) == msg
    vk, sk = sodium.sign_keypair()
    ref_vk, ref_sk = ref_sodium.sign_keypair()
    assert ref_sodium.verify_detached(sodium.sign_detached(msg, sk), msg, vk)
    assert sodium.verify_detached(ref_sodium.sign_detached(msg, ref_sk), msg, ref_vk)
    assert not sodium.verify_detached(ref_sodium.sign_detached(msg, ref_sk), msg + b"x", ref_vk)

    # share vectors: encrypted by one package, decrypted (and fused-combined) by the other
    vals = _values()[:300]
    ref_box = RefEncryptor(ref_proto.EncryptionKey(ek)).encrypt(vals)
    mine = ShareDecryptor(ek, dk)
    assert np.array_equal(mine.decrypt(proto.Encryption(ref_box.data)), vals)
    my_box = ShareEncryptor(proto.EncryptionKey(ref_ek)).encrypt(vals)
    assert np.array_equal(RefDecryptor(ref_ek, ref_dk).decrypt(ref_proto.Encryption(my_box.data)),
                          vals)
    p = (1 << 61) - 1
    shares = [np.random.default_rng(i).integers(0, p, size=50) for i in range(12)]
    boxes = [proto.Encryption(RefEncryptor(ref_proto.EncryptionKey(ek)).encrypt(s).data)
             for s in shares]
    want = np.sum(np.array(shares, dtype=object), axis=0) % p
    assert mine.open_combine(boxes, p, 50).tolist() == want.tolist()
    assert [list(v) for v in mine.decrypt_many(boxes)] == [list(s) for s in shares]
