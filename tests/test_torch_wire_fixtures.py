"""The port's wire shapes against the frozen JSON fixtures: the twin of
``tests/test_wire_fixtures.py`` on ``sda_tpu_torch.protocol``.

One golden file per resource type (``tests/golden/wire/*.json``) and the
canonical signing bytes (``canonical_labelled_key.bin``), made from the
reference. Each resource, built with the port's own constructors from the
reference suite's ids, must serialise to its golden file, parse back from
it to an equal object, and equal the reference's serialisation of the same
resource.
"""

import json

import pytest

from sda_tpu import protocol as ref_proto
from sda_tpu_torch import protocol as proto
from tests.test_wire_fixtures import (
    AGENT_ID,
    AGG_ID,
    EKEY_ID,
    GOLDEN,
    JOB_ID,
    PART_ID,
    SNAP_ID,
    VKEY_ID,
)


def _instances(P):
    vkey = P.Labelled(id=VKEY_ID, body=P.VerificationKey(bytes(range(32))))
    agent = P.Agent(id=AGENT_ID, verification_key=vkey)
    ekey = P.Labelled(id=EKEY_ID, body=P.EncryptionKey(bytes(range(32, 64))))
    enc = P.Encryption(b"ciphertext-bytes")
    result = P.ClerkingResult(job=JOB_ID, clerk=AGENT_ID, encryption=enc)
    snap_status = P.SnapshotStatus(id=SNAP_ID, number_of_clerking_results=7, result_ready=True)
    return {
        "Agent": agent,
        "Profile": P.Profile(owner=AGENT_ID, name="Name", twitter_id="tw", keybase_id="kb",
                             website="https://x"),
        "SignedEncryptionKey": P.Signed(signature=P.Signature(bytes(range(64))),
                                        signer=AGENT_ID, body=ekey),
        "Aggregation": P.Aggregation(
            id=AGG_ID, title="wire fixture", vector_dimension=4, modulus=433,
            recipient=AGENT_ID, recipient_key=EKEY_ID, masking_scheme=P.ChaChaMasking(433, 4, 128),
            committee_sharing_scheme=P.PackedShamirSharing(3, 8, 4, 433, 354, 150)),
        "AggregationAdditiveFull": P.Aggregation(
            id=AGG_ID, title="wire fixture 2", vector_dimension=10, modulus=433,
            recipient=AGENT_ID, recipient_key=EKEY_ID, masking_scheme=P.FullMasking(433),
            committee_sharing_scheme=P.AdditiveSharing(3, 433)),
        "ClerkCandidate": P.ClerkCandidate(id=AGENT_ID, keys=(EKEY_ID,)),
        "Committee": P.Committee(aggregation=AGG_ID, clerks_and_keys=((AGENT_ID, EKEY_ID),)),
        "Participation": P.Participation(
            id=PART_ID, participant=AGENT_ID, aggregation=AGG_ID, recipient_encryption=enc,
            clerk_encryptions=((AGENT_ID, enc),)),
        "Snapshot": P.Snapshot(id=SNAP_ID, aggregation=AGG_ID),
        "ClerkingJob": P.ClerkingJob(id=JOB_ID, clerk=AGENT_ID, aggregation=AGG_ID,
                                     snapshot=SNAP_ID, encryptions=(enc,)),
        "ClerkingResult": result,
        "SnapshotStatus": snap_status,
        "AggregationStatus": P.AggregationStatus(aggregation=AGG_ID, number_of_participations=2,
                                                 snapshots=(snap_status,)),
        "SnapshotResult": P.SnapshotResult(snapshot=SNAP_ID, number_of_participations=2,
                                           clerk_encryptions=(result,),
                                           recipient_encryptions=(enc,)),
        "AuthToken": P.AuthToken(id=AGENT_ID, body="sekret-token"),
        "Pong": P.Pong(running=True),
    }


_FROM_OBJ = {"SignedEncryptionKey": proto.signed_encryption_key_from_obj,
             "AggregationAdditiveFull": proto.Aggregation.from_obj}


@pytest.mark.parametrize("name", sorted(_instances(proto)))
def test_wire_shape_is_frozen(name):
    obj = _instances(proto)[name]
    frozen = json.loads((GOLDEN / f"{name}.json").read_text())
    assert obj.to_obj() == frozen, f"wire shape of {name} drifted from the frozen fixture"
    assert _FROM_OBJ.get(name, type(obj).from_obj)(frozen) == obj
    assert proto.canonical(obj) == ref_proto.canonical(_instances(ref_proto)[name])


def test_canonical_signing_bytes_are_frozen():
    ekey = proto.Labelled(id=EKEY_ID, body=proto.EncryptionKey(bytes(range(32, 64))))
    assert proto.canonical(ekey) == (GOLDEN / "canonical_labelled_key.bin").read_bytes()
