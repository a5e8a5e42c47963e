"""The port's REST transport (``sda_tpu_torch.http``) against sda_tpu's.

- the cases of ``tests/test_http.py`` (ping, the TOFU auth lifecycle, the
  token store, resource-vs-route 404, the 400s) on the port's client and
  server;
- the concurrency case of ``tests/test_http_concurrency.py`` on the port's
  client and server;
- two mixed loops over real HTTP, each a full loop revealing ``[2, 4, 6,
  8]``: the port's clients against the reference's server, and the
  reference's clients against the port's server. The wire format is the
  reference's, so neither side can tell the other apart.

Every server runs inside a ``with serve_background(...)`` block on an
ephemeral port, so no server thread outlives its test.
"""

import threading

import numpy as np
import pytest
import requests

from sda_tpu import client as ref_client
from sda_tpu import protocol as ref_proto
from sda_tpu.http.client import HttpSdaService as RefHttpSdaService
from sda_tpu.http.server import serve_background as ref_serve_background
from sda_tpu.server import new_memory_server as ref_memory_server
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.client import Keystore, MemoryStore, SdaClient, new_agent
from sda_tpu_torch.http import HttpSdaService, serve_background
from sda_tpu_torch.http.client import token_for_store
from sda_tpu_torch.server import new_jsondir_server, new_memory_server
from sda_tpu_torch.utils.errors import InvalidCredentials, SdaError


def dummy_agent() -> proto.Agent:
    """All-zero keys (the reference fixtures' ``dummy_agent``)."""
    return proto.Agent(id=proto.new_id(), verification_key=proto.Labelled(
        id=proto.new_id(), body=proto.VerificationKey(bytes(32))))


@pytest.fixture(scope="module")
def http_url():
    """One port server for the stateless cases (each makes its own agents)."""
    with serve_background(new_memory_server()) as url:
        yield url


# ------------------------------------------------- tests/test_http.py cases


def test_ping_no_auth(http_url):
    assert HttpSdaService(http_url, MemoryStore()).ping().running is True


def test_tofu_auth_lifecycle(http_url):
    svc = HttpSdaService(http_url, MemoryStore())
    agent = dummy_agent()
    svc.create_agent(agent, agent)  # records the token (TOFU)
    assert svc.get_agent(agent, agent.id) == agent
    # the same agent id with a different token -> 401 InvalidCredentials
    with pytest.raises(InvalidCredentials):
        HttpSdaService(http_url, MemoryStore()).get_agent(agent, agent.id)


def test_token_store_generates_once():
    store = MemoryStore()
    t1 = token_for_store(store)
    assert token_for_store(store) == t1 and len(t1) == 32 and t1.isalnum()


def test_resource_not_found_vs_route_not_found(http_url):
    svc = HttpSdaService(http_url, MemoryStore())
    agent = dummy_agent()
    svc.create_agent(agent, agent)
    # unknown resource id -> 404 + Resource-not-found header -> None
    assert svc.get_agent(agent, proto.new_id()) is None
    # unknown route -> plain 404 -> error
    r = requests.get(http_url + "/v1/nonsense")
    assert r.status_code == 404 and "Resource-not-found" not in r.headers
    with pytest.raises(SdaError):
        svc._process(r)


def test_missing_auth_is_400(http_url):
    r = requests.get(http_url + "/v1/agents/" + proto.new_id())
    assert r.status_code == 400  # "Basic Authorization required"


def test_malformed_body_is_400(http_url):
    agent = dummy_agent()
    r = requests.post(http_url + "/v1/agents/me", data=b"not json", auth=(agent.id, "tok"),
                      headers={"Content-Type": "application/json"})
    assert r.status_code in (400, 500)
    r = requests.post(http_url + "/v1/agents/me", auth=(agent.id, "tok"))
    assert r.status_code == 400  # "Expected a body"


def test_inconsistent_agent_id_rejected(http_url):
    agent = dummy_agent()
    r = requests.post(http_url + "/v1/agents/me", json=agent.to_obj(),
                      auth=(proto.new_id(), "tok"))
    assert r.status_code == 400 and "inconsistent" in r.text


def test_title_filter_is_unquoted(http_url):
    """``GET /v1/aggregations?title=...`` arrives URL-encoded; the server's
    ``unquote_plus`` must give the filter back as the client sent it."""
    svc = HttpSdaService(http_url, MemoryStore())
    agent = dummy_agent()
    svc.create_agent(agent, agent)
    agg = proto.Aggregation(
        id=proto.new_id(), title="a title & more+", vector_dimension=2, modulus=433,
        recipient=agent.id, recipient_key=proto.new_id(), masking_scheme=proto.NoMasking(),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=3, modulus=433))
    svc.create_aggregation(agent, agg)
    assert svc.list_aggregations(agent, filter="title & more+") == [agg.id]
    assert svc.list_aggregations(agent, filter="absent") == []


# ------------------------------------- tests/test_http_concurrency.py case


def _port_client(service) -> SdaClient:
    service = service.clone_fresh()  # one auth token per agent
    keystore = Keystore(MemoryStore())
    return SdaClient(new_agent(keystore), keystore, service, device="cpu")


def test_concurrent_participations_and_clerking_over_http(tmp_path):
    with serve_background(new_jsondir_server(str(tmp_path))) as url:
        service = HttpSdaService(url, token_store=MemoryStore())
        recipient = _port_client(service)
        rk = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(rk)
        dim, n_participants = 6, 12
        agg = proto.Aggregation(
            id=proto.new_id(), title="concurrent", vector_dimension=dim, modulus=433,
            recipient=recipient.agent.id, recipient_key=rk, masking_scheme=proto.NoMasking(),
            committee_sharing_scheme=proto.AdditiveSharing(share_count=3, modulus=433))
        recipient.upload_aggregation(agg)
        clerks = [_port_client(service) for _ in range(3)]
        for c in clerks:
            key = c.new_encryption_key()
            c.upload_agent()
            c.upload_encryption_key(key)
        recipient.begin_aggregation(agg.id)
        errors = []

        def run(fn, *args):
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(e)

        def participate(i):
            p = _port_client(service)
            p.upload_agent()
            p.participate(np.arange(dim) + i, agg.id)

        def in_threads(targets):
            threads = [threading.Thread(target=run, args=t) for t in targets]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads), "a thread did not finish"
            assert not errors, errors

        # 12 participants upload in parallel, each its own client and connection
        in_threads([(participate, i) for i in range(n_participants)])
        recipient.end_aggregation(agg.id)
        # every committee member clerks at once
        in_threads([(c.run_chores, -1) for c in clerks + [recipient]])
        out = recipient.reveal_aggregation(agg.id)
        want = [sum(j + i for i in range(n_participants)) % 433 for j in range(dim)]
        assert out.positive().values.tolist() == want


# ------------------------------------------------------- the mixed loops

PACKED = dict(secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
              omega_secrets=354, omega_shares=150)


def _full_loop(pr, service, make_client):
    """The full loop of tests/test_full_loop.py with ``pr``'s protocol
    objects: recipient + 8 clerks + 2 participants each contributing
    ``[1, 2, 3, 4]`` under packed Shamir at p = 433; returns the reveal."""
    recipient = make_client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = pr.Aggregation(
        id=pr.new_id(), title="mixed", vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=pr.NoMasking(),
        committee_sharing_scheme=pr.PackedShamirSharing(**PACKED))
    recipient.upload_aggregation(agg)
    clerks = [make_client(service) for _ in range(8)]
    for clerk in clerks:
        key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(key)
    recipient.begin_aggregation(agg.id)
    for _ in range(2):
        participant = make_client(service)
        participant.upload_agent()
        participant.participate(np.array([1, 2, 3, 4]), agg.id)
    recipient.end_aggregation(agg.id)
    recipient.run_chores(-1)
    for clerk in clerks:
        clerk.run_chores(-1)
    return recipient.reveal_aggregation(agg.id).positive().values.tolist()


def _ref_client(service):
    service = service.clone_fresh()
    keystore = ref_client.Keystore(ref_client.MemoryStore())
    return ref_client.SdaClient(ref_client.new_agent(keystore), keystore, service)


def test_port_clients_against_the_reference_http_server():
    with ref_serve_background(ref_memory_server()) as url:
        service = HttpSdaService(url, token_store=MemoryStore())
        assert _full_loop(proto, service, _port_client) == [2, 4, 6, 8]


def test_reference_clients_against_the_port_http_server():
    with serve_background(new_memory_server()) as url:
        service = RefHttpSdaService(url, token_store=ref_client.MemoryStore())
        assert _full_loop(ref_proto, service, _ref_client) == [2, 4, 6, 8]
