"""The port's server-side transposition, byte by byte with fake ciphertexts:
the twin of ``tests/test_service_transpose.py`` on ``sda_tpu_torch``.

20 agents, a committee of 3, 100 participations whose fake 2-byte
ciphertexts are ``[clerk_index, participant_index]``: each clerking job must
hold exactly its own clerk's bytes, and the statuses move as the
reference's do. The same ids and objects go through the reference's server
on the same backend (memory, jsondir, mongo on ``tests/fake_pymongo.py``),
and every job (its boxes in order), status and result must equal the
reference's (job ids aside, which each server draws).
"""

import sys
import uuid

import numpy as np
import pytest

from sda_tpu import protocol as ref_proto
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.utils.errors import Invalid
from tests.fixtures import with_service as ref_with_service

from .test_torch_failure_tolerance import with_service

BACKENDS = ["memory", "jsondir", "mongo"]


@pytest.fixture(autouse=True)
def _keep_pymongo():
    """The reference's ``with_service("mongo")`` leaves its pymongo fake in
    ``sys.modules``; put back what was there."""
    saved = sys.modules.get("pymongo")
    yield
    if saved is None:
        sys.modules.pop("pymongo", None)
    else:
        sys.modules["pymongo"] = saved


def _ids(n, seed):
    rng = np.random.default_rng(seed)
    return [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n)]


def _agent(P, agent_id, key_id):
    return P.Agent(id=agent_id, verification_key=P.Labelled(
        id=key_id, body=P.VerificationKey(bytes(32))))


def _signed_key(P, agent_id, key_id):
    return P.Signed(signature=P.Signature(bytes(64)), signer=agent_id,
                    body=P.Labelled(id=key_id, body=P.EncryptionKey(bytes(32))))


def mocked_loop(service, P, seed=0):
    """The reference's ``full_mocked_loop`` with ids drawn from ``seed``;
    returns every observable outcome, job ids left out."""
    ids = iter(_ids(400, seed))
    recipient = _agent(P, next(ids), next(ids))
    service.create_agent(recipient, recipient)
    recipient_key = _signed_key(P, recipient.id, next(ids))
    service.create_encryption_key(recipient, recipient_key)
    agents = {recipient.id: recipient}
    for _ in range(20):
        clerk = _agent(P, next(ids), next(ids))
        service.create_agent(clerk, clerk)
        service.create_encryption_key(clerk, _signed_key(P, clerk.id, next(ids)))
        agents[clerk.id] = clerk
    agg = P.Aggregation(
        id=next(ids), title="mocked", vector_dimension=4, modulus=433,
        recipient=recipient.id, recipient_key=recipient_key.id,
        masking_scheme=P.NoMasking(),
        committee_sharing_scheme=P.AdditiveSharing(share_count=3, modulus=433),
    )
    service.create_aggregation(recipient, agg)
    candidates = service.suggest_committee(recipient, agg.id)
    selected = sorted((c.id, c.keys[0]) for c in candidates)[:3]
    service.create_committee(recipient, P.Committee(aggregation=agg.id,
                                                    clerks_and_keys=tuple(selected)))
    for pi in range(100):
        participant = _agent(P, next(ids), next(ids))
        service.create_agent(participant, participant)
        service.create_participation(participant, P.Participation(
            id=next(ids), participant=participant.id, aggregation=agg.id,
            recipient_encryption=None,
            clerk_encryptions=tuple((cid, P.Encryption(bytes([ci, pi % 256])))
                                    for ci, (cid, _) in enumerate(selected))))
    out = {"candidates": sorted((c.id, tuple(c.keys)) for c in candidates)}
    st = service.get_aggregation_status(recipient, agg.id)
    out["before"] = (st.number_of_participations, st.snapshots)
    snapshot = P.Snapshot(id=next(ids), aggregation=agg.id)
    service.create_snapshot(recipient, snapshot)
    out["snapshot"] = service.get_aggregation_status(recipient, agg.id).to_obj()
    out["jobs"] = []
    for ci, (clerk_id, _) in enumerate(selected):
        job = service.get_clerking_job(agents[clerk_id], clerk_id)
        out["jobs"].append((job.clerk, job.aggregation, job.snapshot,
                            [e.data for e in job.encryptions]))
        service.create_clerking_result(agents[clerk_id], P.ClerkingResult(
            job=job.id, clerk=clerk_id, encryption=P.Encryption(bytes([ci]))))
    out["after"] = service.get_aggregation_status(recipient, agg.id).to_obj()
    result = service.get_snapshot_result(recipient, agg.id, snapshot.id)
    out["result"] = (result.snapshot, result.number_of_participations,
                     sorted((r.clerk, r.encryption.data) for r in result.clerk_encryptions),
                     result.recipient_encryptions)
    out["selected"] = selected
    return out


@pytest.mark.parametrize("kind", BACKENDS)
def test_full_mocked_loop(kind):
    with with_service(kind) as service:
        got = mocked_loop(service, proto)
    assert got["before"] == (100, ())
    assert got["snapshot"]["snapshots"][0]["number_of_clerking_results"] == 0
    assert got["snapshot"]["snapshots"][0]["result_ready"] is False
    assert len(got["jobs"]) == 3
    for ci, (clerk, _, _, datas) in enumerate(got["jobs"]):
        assert clerk == got["selected"][ci][0]
        assert len(datas) == 100 and {d[0] for d in datas} == {ci}  # its own bytes only
        assert sorted(d[1] for d in datas) == list(range(100))
    assert got["after"]["snapshots"][0]["number_of_clerking_results"] == 3
    assert got["after"]["snapshots"][0]["result_ready"] is True
    assert got["result"][1:] == (100, [(c, bytes([i])) for i, (c, _) in
                                       enumerate(got["selected"])], None)
    # the reference's server on the same backend: the same transposition
    with ref_with_service(kind) as ref_service:
        want = mocked_loop(ref_service, ref_proto)
    assert got == want


@pytest.mark.parametrize("kind", BACKENDS)
def test_clerk_result_spoofing_rejected(kind):
    """A result for an unknown job is refused, as by the reference."""
    with with_service(kind) as service:
        clerk = _agent(proto, proto.new_id(), proto.new_id())
        service.create_agent(clerk, clerk)
        with pytest.raises(Invalid):
            service.create_clerking_result(clerk, proto.ClerkingResult(
                job=proto.new_id(), clerk=clerk.id, encryption=proto.Encryption(b"x")))
