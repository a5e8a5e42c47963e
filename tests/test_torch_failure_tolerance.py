"""The port's failure tolerance: clerk dropout, retries, idempotence.

The twin of ``tests/test_failure_tolerance.py`` on ``sda_tpu_torch``: the
same cases, each with the reference's outcome (the same error type, by its
message, and the same status counts). Packed Shamir 3/8/4 tolerates
``share_count - (t + k)`` missing clerks; ``result_ready`` fires at the
reconstruction threshold; participation retries are idempotent through
client-made ids.

Kept differences the twins adapt to: every client passes ``device="cpu"``
(the port's default device is the card); the reference's ``Invalid`` is
``sda_tpu_torch.utils.errors.Invalid`` here.

Also here: the port's ``with_service`` (the service kinds of
``tests/fixtures.py``: memory, jsondir, mongo on ``tests/fake_pymongo.py``
and http), which the other twins import, and
``test_tolerance_scenario_at_small_width``, the ``tolerance:`` phase of
``chip_smoke.py`` run on the CPU at 1,002 dimensions.
"""

import contextlib
import dataclasses
import secrets
import sys
import tempfile

import numpy as np
import pytest

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.utils.errors import Invalid

from .test_torch_client import CONFIGS, agg_default, make_client


@contextlib.contextmanager
def with_service(kind: str = "memory"):
    """The port's service of one kind: memory, jsondir, mongo (on the
    in-repo pymongo fake, a throwaway database) or http (a port server over
    a jsondir store on an ephemeral port)."""
    from sda_tpu_torch.client import MemoryStore
    from sda_tpu_torch.server import new_jsondir_server, new_memory_server

    if kind == "memory":
        yield new_memory_server()
    elif kind == "jsondir":
        with tempfile.TemporaryDirectory(prefix="sda-torch-tests-") as d:
            yield new_jsondir_server(d)
    elif kind == "mongo":
        from tests import fake_pymongo

        saved = sys.modules.get("pymongo")
        sys.modules["pymongo"] = fake_pymongo
        url, db = "mongodb://localhost:27017", f"sda-torch-test-{secrets.randbits(64)}"
        try:
            from sda_tpu_torch.stores_mongo import new_mongo_server

            yield new_mongo_server(url, db)
            fake_pymongo.MongoClient(url).drop_database(db)
        finally:
            if saved is None:
                sys.modules.pop("pymongo", None)
            else:
                sys.modules["pymongo"] = saved
    elif kind == "http":
        from sda_tpu_torch.http import HttpSdaService, serve_background

        with tempfile.TemporaryDirectory(prefix="sda-torch-tests-http-") as d:
            with serve_background(new_jsondir_server(d)) as url:
                yield HttpSdaService(url, MemoryStore())
    else:
        raise ValueError(kind)


def _keyed(service, n):
    clients = [make_client(service) for _ in range(n)]
    for c in clients:
        key = c.new_encryption_key()
        c.upload_agent()
        c.upload_encryption_key(key)
    return clients


def _setup(service, n_clerks=3, participants=(), **overrides):
    """Recipient + keyed clerks + an elected committee; each entry of
    ``participants`` is one participant's vector."""
    recipient = make_client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = agg_default(recipient.agent.id, rkey, **overrides)
    recipient.upload_aggregation(agg)
    clerks = _keyed(service, n_clerks)
    recipient.begin_aggregation(agg.id)
    for values in participants:
        part = make_client(service)
        part.upload_agent()
        part.participate(np.array(values), agg.id)
    return recipient, clerks, agg


def _members(recipient, clerks, agg):
    """The committee's clients, in committee order."""
    committee = recipient.service.get_committee(recipient.agent, agg.id)
    everyone = {c.agent.id: c for c in clerks + [recipient]}
    return [everyone[cid] for cid, _ in committee.clerks_and_keys]


@pytest.mark.parametrize("kind", ["memory", "http"])
def test_clerk_dropout_reveal_still_works(kind):
    """7 of 8 clerks respond (threshold 7): the reveal succeeds through the
    Lagrange subset, on the host and through the device reconstruction."""
    with with_service(kind) as service:
        recipient, clerks, agg = _setup(service, 8, [[1, 2, 3, 4]] * 2,
                                        **CONFIGS["with_packedshamir"])
        recipient.end_aggregation(agg.id)
        for c in _members(recipient, clerks, agg)[:-1]:  # one dropout
            c.run_chores(-1)
        snap = recipient.service.get_aggregation_status(recipient.agent, agg.id).snapshots[0]
        assert (snap.number_of_clerking_results, snap.result_ready) == (7, True)
        assert recipient.reveal_aggregation(agg.id).positive().values.tolist() == [2, 4, 6, 8]
        recipient.device_bulk_threshold = 1
        assert recipient.reveal_aggregation(agg.id).positive().values.tolist() == [2, 4, 6, 8]


def test_too_many_dropouts_not_ready():
    with with_service("memory") as service:
        recipient, clerks, agg = _setup(service, 8, [[1, 2, 3, 4]],
                                        **CONFIGS["with_packedshamir"])
        recipient.end_aggregation(agg.id)
        for c in _members(recipient, clerks, agg)[:6]:  # below threshold 7
            c.run_chores(-1)
        status = recipient.service.get_aggregation_status(recipient.agent, agg.id)
        assert status.snapshots[0].number_of_clerking_results == 6
        assert status.snapshots[0].result_ready is False
        with pytest.raises(Invalid, match="^Aggregation not ready$"):
            recipient.reveal_aggregation(agg.id)


def _tampered_signed_key(client):
    """A signed encryption key whose Ed25519 signature has one bit flipped."""
    key_id = client.crypto.new_encryption_key()
    signed = client.crypto.sign_export(client.agent, key_id)
    bad_sig = bytearray(signed.signature.data)
    bad_sig[0] ^= 0x01
    return key_id, proto.Signed(signature=proto.Signature(bytes(bad_sig)),
                                signer=signed.signer, body=signed.body)


def _upload_tampered_key(client) -> str:
    key_id, tampered = _tampered_signed_key(client)
    client.service.create_encryption_key(client.agent, tampered)
    return key_id


def test_tampered_clerk_key_rejected_at_participation():
    """Every clerk presents a forged key: the participant must refuse."""
    with with_service("memory") as service:
        recipient = make_client(service)
        rkey = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(rkey)
        agg = agg_default(recipient.agent.id, rkey)
        recipient.upload_aggregation(agg)
        for c in [make_client(service) for _ in range(3)]:
            c.upload_agent()
            _upload_tampered_key(c)
        recipient.begin_aggregation(agg.id)
        part = make_client(service)
        part.upload_agent()
        with pytest.raises(Invalid, match="^Signature verification failed for key$"):
            part.new_participation(np.array([1, 2, 3, 4]), agg.id)


def test_forged_recipient_key_rejected_at_mask_encryption():
    with with_service("memory") as service:
        recipient = make_client(service)
        recipient.upload_agent()
        bad_key_id = _upload_tampered_key(recipient)
        agg = agg_default(recipient.agent.id, bad_key_id,
                          masking_scheme=proto.FullMasking(modulus=433))
        recipient.upload_aggregation(agg)
        _keyed(service, 3)
        recipient.begin_aggregation(agg.id)
        part = make_client(service)
        part.upload_agent()
        with pytest.raises(Invalid, match="^Signature verification failed for key$"):
            part.new_participation(np.array([1, 2, 3, 4]), agg.id)


def test_forged_recipient_key_rejected_at_clerking():
    """With no masking the clerk is the first to verify the recipient key."""
    with with_service("memory") as service:
        recipient = make_client(service)
        recipient.upload_agent()
        bad_key_id, tampered = _tampered_signed_key(recipient)
        agg = agg_default(recipient.agent.id, bad_key_id)
        recipient.upload_aggregation(agg)
        clerks = _keyed(service, 3)
        recipient.begin_aggregation(agg.id)
        # the forged key lands after the election: the recipient is no candidate
        service.create_encryption_key(recipient.agent, tampered)
        part = make_client(service)
        part.upload_agent()
        part.participate(np.array([1, 2, 3, 4]), agg.id)
        recipient.end_aggregation(agg.id)
        clerk = _members(recipient, clerks, agg)[0]
        with pytest.raises(Invalid, match="^Signature verification failed for key$"):
            clerk.run_chores(-1)


@pytest.mark.parametrize("route", ["sequential", "fused"])
def test_corrupted_sealed_box_surfaces_invalid(route):
    """A corrupted ciphertext surfaces Invalid at the clerk on the
    sequential route (the reference's case) and on the fused native open +
    combine of the bulk route, with the message of each."""
    with with_service("memory") as service:
        recipient, clerks, agg = _setup(service)
        part = make_client(service)
        part.upload_agent()
        participation = part.new_participation(np.array([1, 2, 3, 4]), agg.id)
        clerk_id, enc = participation.clerk_encryptions[0]
        corrupted = bytearray(enc.data)
        corrupted[len(corrupted) // 2] ^= 0xFF
        part.upload_participation(dataclasses.replace(
            participation,
            clerk_encryptions=((clerk_id, type(enc)(data=bytes(corrupted))),)
            + tuple(participation.clerk_encryptions[1:])))
        recipient.end_aggregation(agg.id)
        victim = {c.agent.id: c for c in clerks + [recipient]}[clerk_id]
        if route == "fused":
            victim.device_bulk_threshold = 1
        message = ("Sodium decryption failure" if route == "sequential"
                   else r"sodium seal_open failure \(tampered or wrong key\)")
        with pytest.raises(Invalid, match=f"^{message}$"):
            victim.run_chores(-1)


@pytest.mark.parametrize("kind", ["jsondir", "mongo", "http"])
def test_participation_retry_idempotent(kind):
    with with_service(kind) as service:
        recipient, _, agg = _setup(service)
        part = make_client(service)
        part.upload_agent()
        participation = part.new_participation(np.array([1, 2, 3, 4]), agg.id)
        part.upload_participation(participation)
        part.upload_participation(participation)  # a network retry: the same id
        status = recipient.service.get_aggregation_status(recipient.agent, agg.id)
        assert status.number_of_participations == 1


@pytest.mark.parametrize("kind", ["jsondir", "mongo"])
def test_clerk_job_durable_until_result(kind):
    """A job stays pollable until its result is stored."""
    with with_service(kind) as service:
        recipient, clerks, agg = _setup(service, participants=[[1, 2, 3, 4]])
        recipient.end_aggregation(agg.id)
        clerk = _members(recipient, clerks, agg)[0]
        j1 = service.get_clerking_job(clerk.agent, clerk.agent.id)
        j2 = service.get_clerking_job(clerk.agent, clerk.agent.id)
        assert j1 is not None and j1.id == j2.id
        result = clerk.process_clerking_job(j1)
        service.create_clerking_result(clerk.agent, result)
        assert service.get_clerking_job(clerk.agent, clerk.agent.id) is None
        service.create_clerking_result(clerk.agent, result)  # a retry after a lost ack


def test_tolerance_scenario_at_small_width():
    """``chip_smoke.py``'s ``tolerance:`` sequence on the CPU at 1,002
    dimensions, through the script's own ``_loop_pass`` and checks: the
    retry counted once; participant 3's box for clerk 7 tampered, so clerk
    7's fused open + combine raises Invalid, stores nothing and its job
    stays pollable; clerks 0-5 give 6 results, not ready, the reveal
    refused; clerk 6 gives 7, ready; the reveal exact through
    ``_device_reconstruct``'s subset branch; the forged clerk key refused.
    The tampered clerk's own combined share completes the full set, whose
    reconstruction equals the subset's."""
    import chip_smoke
    from sda_tpu_torch.fields import positive

    cfg = dict(chip_smoke.TOLERANCE, dimension=1_002)
    r = chip_smoke._loop_pass(**cfg, device="cpu")
    assert chip_smoke._tolerance_failures(r, cfg) == []
    assert r["engines"] == {"sharing": ["cpu"], "reconstruction": ["cpu"]}
    assert [st["refused"] for st in r["stages"]] == ["Invalid: Aggregation not ready", None]
    (rec,) = r["reconstructions"]
    scheme = rec["scheme"]
    full = sorted(rec["shares"] + [(7, r["tampered"]["share"])], key=lambda t: t[0])
    client = r["recipient"]
    subset_out = client._device_reconstruct(scheme, rec["shares"], 1_002)
    full_out = client._device_reconstruct(scheme, full, 1_002)
    host_out = scheme.reconstruct(full, dimension=1_002)
    assert subset_out.tolist() == full_out.tolist()
    assert positive(host_out, r["modulus"]).tolist() == full_out.tolist()
