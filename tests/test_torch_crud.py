"""The port's agent, profile and key CRUD, ACL refusals and aggregation
listing: the twin of ``tests/test_crud.py`` on ``sda_tpu_torch``.

Each case runs on the reference's two backends (memory, jsondir) and on the
port's Mongo store over ``tests/fake_pymongo.py``, with the reference's
outcome: the same refusals (``PermissionDenied``, ``Invalid``,
``InvalidCredentials`` of ``sda_tpu_torch.utils.errors``) and the same
listings. The listing filters are also run through the reference's server
on the same objects (crossed as wire JSON), and must give the same ids.
"""

import pytest

from sda_tpu import protocol as ref_proto
from sda_tpu.server import new_memory_server as ref_memory_server
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied

from .test_torch_failure_tolerance import with_service
from .test_torch_http import dummy_agent

BACKENDS = ["memory", "jsondir", "mongo"]


@pytest.fixture(params=BACKENDS)
def service(request):
    with with_service(request.param) as s:
        yield s


def dummy_signed_key(agent: proto.Agent) -> proto.Signed:
    return proto.Signed(signature=proto.Signature(bytes(64)), signer=agent.id,
                        body=proto.Labelled(id=proto.new_id(),
                                            body=proto.EncryptionKey(bytes(32))))


def _aggregation(recipient_id, title="t", share_count=3):
    return proto.Aggregation(
        id=proto.new_id(), title=title, vector_dimension=4, modulus=433,
        recipient=recipient_id, recipient_key=proto.new_id(),
        masking_scheme=proto.NoMasking(),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=share_count, modulus=433),
    )


def test_ping(service):
    assert service.ping().running is True


def test_agent_crud(service):
    agent = dummy_agent()
    service.create_agent(agent, agent)
    assert service.get_agent(agent, agent.id) == agent
    service.create_agent(agent, agent)  # an identical create succeeds


def test_agent_create_acl(service):
    alice, eve = dummy_agent(), dummy_agent()
    with pytest.raises(PermissionDenied):
        service.create_agent(eve, alice)


def test_profile_crud_and_acl(service):
    agent = dummy_agent()
    service.create_agent(agent, agent)
    profile = proto.Profile(owner=agent.id, name="Alice")
    service.upsert_profile(agent, profile)
    assert service.get_profile(agent, agent.id) == profile
    profile2 = proto.Profile(owner=agent.id, name="Alice 2", website="https://x")
    service.upsert_profile(agent, profile2)
    assert service.get_profile(agent, agent.id) == profile2
    eve = dummy_agent()
    service.create_agent(eve, eve)
    with pytest.raises(PermissionDenied):
        service.upsert_profile(eve, proto.Profile(owner=agent.id, name="Mallory"))


def test_encryption_key_crud_acl(service):
    agent = dummy_agent()
    service.create_agent(agent, agent)
    key = dummy_signed_key(agent)
    service.create_encryption_key(agent, key)
    assert service.get_encryption_key(agent, key.id) == key
    eve = dummy_agent()
    service.create_agent(eve, eve)
    with pytest.raises(PermissionDenied):
        service.create_encryption_key(eve, dummy_signed_key(agent))


def test_aggregation_listing_filters(service):
    recipient = dummy_agent()
    service.create_agent(recipient, recipient)
    a1, a2 = _aggregation(recipient.id, "federated mnist"), _aggregation(recipient.id, "sensor sum")
    service.create_aggregation(recipient, a1)
    service.create_aggregation(recipient, a2)
    other = dummy_agent()
    got = (set(service.list_aggregations(recipient)),
           service.list_aggregations(recipient, filter="mnist"),
           set(service.list_aggregations(recipient, recipient=recipient.id)),
           service.list_aggregations(recipient, recipient=other.id))
    assert got == ({a1.id, a2.id}, [a1.id], {a1.id, a2.id}, [])
    # the reference's server on the same objects lists the same ids
    ref = ref_memory_server()
    ref_recipient = ref_proto.Agent.from_obj(recipient.to_obj())
    ref.create_agent(ref_recipient, ref_recipient)
    for a in (a1, a2):
        ref.create_aggregation(ref_recipient, ref_proto.Aggregation.from_obj(a.to_obj()))
    assert got == (set(ref.list_aggregations(ref_recipient)),
                   ref.list_aggregations(ref_recipient, filter="mnist"),
                   set(ref.list_aggregations(ref_recipient, recipient=recipient.id)),
                   ref.list_aggregations(ref_recipient, recipient=other.id))
    with pytest.raises(PermissionDenied):  # only the recipient deletes
        service.delete_aggregation(dummy_agent(), a1.id)
    service.delete_aggregation(recipient, a1.id)
    assert service.get_aggregation(recipient, a1.id) is None


def test_committee_size_validation(service):
    recipient = dummy_agent()
    service.create_agent(recipient, recipient)
    agg = _aggregation(recipient.id)
    service.create_aggregation(recipient, agg)
    bad = proto.Committee(aggregation=agg.id, clerks_and_keys=((proto.new_id(), proto.new_id()),))
    with pytest.raises(Invalid, match="^Expected 3 clerks in the committee, found 1 instead$"):
        service.create_committee(recipient, bad)


def test_auth_token_lifecycle(service):
    server = service.server
    agent = dummy_agent()
    service.create_agent(agent, agent)
    token = proto.AuthToken(id=agent.id, body="s3cret")
    server.upsert_auth_token(token)
    assert server.check_auth_token(token) == agent
    with pytest.raises(InvalidCredentials):
        server.check_auth_token(proto.AuthToken(id=agent.id, body="wrong"))
    server.delete_auth_token(agent.id)
    with pytest.raises(InvalidCredentials):
        server.check_auth_token(token)


def test_delete_aggregation_cascades_everything():
    """Deleting an aggregation removes its snapshots, their masks and
    contents, the clerking jobs (queued and done) and the results."""
    from sda_tpu_torch.server import SdaServer
    from sda_tpu_torch.stores import MemoryStores

    stores = MemoryStores()
    server = SdaServer(stores)
    agg = _aggregation(proto.new_id(), "cascade", share_count=2)
    server.create_aggregation(agg)
    clerks = [proto.new_id(), proto.new_id()]
    server.create_committee(proto.Committee(
        aggregation=agg.id, clerks_and_keys=tuple((c, proto.new_id()) for c in clerks)))
    for _ in range(3):
        server.create_participation(proto.Participation(
            id=proto.new_id(), participant=proto.new_id(), aggregation=agg.id,
            recipient_encryption=None,
            clerk_encryptions=tuple((c, proto.Encryption(data=b"x")) for c in clerks)))
    snap = proto.Snapshot(id=proto.new_id(), aggregation=agg.id)
    server.create_snapshot(snap)
    job = stores.poll_clerking_job(clerks[0])  # clerk 0 completes; clerk 1's stays queued
    stores.create_clerking_result(proto.ClerkingResult(
        job=job.id, clerk=clerks[0], encryption=proto.Encryption(data=b"r")))
    assert stores.list_snapshots(agg.id) == [snap.id]
    assert stores.list_results(snap.id) == [job.id]
    assert stores.poll_clerking_job(clerks[1]) is not None

    server.delete_aggregation(agg.id)

    assert stores.get_aggregation(agg.id) is None
    assert stores.get_committee(agg.id) is None
    assert stores.count_participations(agg.id) == 0
    assert stores.list_snapshots(agg.id) == []
    assert stores.get_snapshot(agg.id, snap.id) is None
    assert stores.list_results(snap.id) == []
    assert stores.get_snapshot_mask(snap.id) is None
    assert stores.count_participations_snapshot(agg.id, snap.id) == 0
    for c in clerks:
        assert stores.poll_clerking_job(c) is None
        assert stores.get_clerking_job(c, job.id) is None
