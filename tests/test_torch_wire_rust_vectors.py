"""The port's wire encoding against the vectors lifted from the Rust
reference's own source: the twin of ``tests/test_wire_rust_vectors.py`` on
``sda_tpu_torch.protocol``.

The vectors are the reference suite's own constants, imported from it: the
base64 serde-test tokens of ``byte_arrays.rs`` and the hand-derived
canonical JSON of an Aggregation, a Labelled key and a Signed key. The
port must produce them byte for byte, parse them back to equal objects,
and agree with ``sda_tpu.protocol`` on each.
"""

import base64
import json

from sda_tpu import protocol as ref_proto
from sda_tpu_torch import protocol as proto
from tests.test_wire_rust_vectors import (
    AGG_ID,
    B8_ZERO,
    B32_ZERO,
    B64_ZERO,
    EXPECTED_AGG_CHACHA_PACKED,
    EXPECTED_AGG_NONE_ADDITIVE,
    EXPECTED_LABELLED_KEY,
    EXPECTED_SIGNED_KEY,
    KEY_ID,
    RCPT_ID,
    RKEY_ID,
    SIGNER,
)


def test_rust_b8_vector():
    assert base64.b64encode(bytes(8)).decode() == B8_ZERO


def test_rust_b32_vector_pins_key_encoding():
    assert base64.b64encode(bytes(32)).decode() == B32_ZERO
    for cls in (proto.EncryptionKey, proto.VerificationKey):
        assert cls(bytes(32)).to_obj() == {"Sodium": B32_ZERO}
    assert proto.EncryptionKey.from_obj({"Sodium": B32_ZERO}).data == bytes(32)
    assert proto.VerificationKey.from_obj({"Sodium": B32_ZERO}).data == bytes(32)


def test_rust_b64_vector_pins_signature_encoding():
    assert base64.b64encode(bytes(64)).decode() == B64_ZERO
    assert proto.Signature(bytes(64)).to_obj() == {"Sodium": B64_ZERO}
    assert proto.Signature.from_obj({"Sodium": B64_ZERO}).data == bytes(64)


def _agg(P, **overrides):
    base = dict(
        id=AGG_ID, title="secret ballot", vector_dimension=4, modulus=433,
        recipient=RCPT_ID, recipient_key=RKEY_ID,
        masking_scheme=P.ChaChaMasking(modulus=433, dimension=4, seed_bitsize=128),
        committee_sharing_scheme=P.PackedShamirSharing(
            secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
            omega_secrets=354, omega_shares=150),
    )
    base.update(overrides)
    return P.Aggregation(**base)


def _none_additive(P):
    return _agg(P, vector_dimension=10, masking_scheme=P.NoMasking(),
                committee_sharing_scheme=P.AdditiveSharing(share_count=3, modulus=433))


def test_aggregation_canonical_matches_hand_derived_chacha_packed():
    assert proto.canonical(_agg(proto)).decode() == EXPECTED_AGG_CHACHA_PACKED
    assert proto.canonical(_agg(proto)) == ref_proto.canonical(_agg(ref_proto))


def test_aggregation_canonical_matches_hand_derived_none_additive():
    assert proto.canonical(_none_additive(proto)).decode() == EXPECTED_AGG_NONE_ADDITIVE
    assert proto.canonical(_none_additive(proto)) == ref_proto.canonical(
        _none_additive(ref_proto))


def test_aggregation_roundtrips_from_hand_derived_json():
    """The decoder takes the hand-derived wire form, not only its own."""
    for text, want in ((EXPECTED_AGG_CHACHA_PACKED, _agg(proto)),
                       (EXPECTED_AGG_NONE_ADDITIVE, _none_additive(proto))):
        assert proto.Aggregation.from_obj(json.loads(text)) == want


def _labelled(P):
    return P.Labelled(id=KEY_ID, body=P.EncryptionKey(bytes(32)))


def test_labelled_key_canonical_matches_hand_derived():
    assert proto.canonical(_labelled(proto)).decode() == EXPECTED_LABELLED_KEY
    assert proto.canonical(_labelled(proto)) == ref_proto.canonical(_labelled(ref_proto))


def test_signed_key_canonical_matches_hand_derived():
    def signed(P):
        return P.Signed(signature=P.Signature(bytes(64)), signer=SIGNER, body=_labelled(P))

    assert proto.canonical(signed(proto)).decode() == EXPECTED_SIGNED_KEY
    assert proto.canonical(signed(proto)) == ref_proto.canonical(signed(ref_proto))
    assert proto.signed_encryption_key_from_obj(json.loads(EXPECTED_SIGNED_KEY)) == signed(proto)
