"""The port's protocol loop: participant -> clerk -> recipient, in process.

Mirrors the reference's own loop tests through ``sda_tpu_torch`` on the CPU
(``device="cpu"``; with no card the default device raises):

- ``tests/test_full_loop.py``: recipient + 8 clerks + 2 participants each
  contributing ``[1, 2, 3, 4]`` reveal ``[2, 4, 6, 8]`` under the four
  scheme configurations, on the memory and the JSON-directory stores and
  over HTTP, the verified-key cache and the idempotent end of an
  aggregation;
- ``tests/test_engine.py:316-411``: the clerks' device combine, the
  recipient's device ChaCha reveal and reconstruction, the participants'
  device share generation;
- ``tests/test_clerk_routing.py``: the clerk's three combine routes;
- a mixed loop: the port's clients against the reference's in-process
  server, every call crossing as wire JSON.
"""

import json

import numpy as np
import pytest

import sda_tpu_torch.client as client_mod
from sda_tpu import protocol as ref_proto
from sda_tpu.server import new_memory_server as ref_memory_server
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.client import Keystore, MemoryStore, SdaClient, _streamed_decrypt, new_agent
from sda_tpu_torch.client.crypto import ShareDecryptor
from sda_tpu_torch.fields import positive
from sda_tpu_torch.server import new_jsondir_server, new_memory_server
from sda_tpu_torch.utils.errors import Invalid

CONFIGS = {
    "simple": {},
    "with_fullmask": {"masking_scheme": proto.FullMasking(modulus=433)},
    "with_chachamask": {
        "masking_scheme": proto.ChaChaMasking(modulus=433, dimension=4, seed_bitsize=128)
    },
    "with_packedshamir": {
        "committee_sharing_scheme": proto.PackedShamirSharing(
            secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
            omega_secrets=354, omega_shares=150,
        )
    },
}


def make_client(service, **kw) -> SdaClient:
    # an HTTP proxy carries one agent's auth token: each client its own
    if hasattr(service, "clone_fresh"):
        service = service.clone_fresh()
    keystore = Keystore(MemoryStore())
    return SdaClient(new_agent(keystore), keystore, service, device="cpu", **kw)


def agg_default(recipient_id, recipient_key_id, **overrides):
    base = dict(
        id=proto.new_id(), title="foo", vector_dimension=4, modulus=433,
        recipient=recipient_id, recipient_key=recipient_key_id,
        masking_scheme=proto.NoMasking(),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=3, modulus=433),
    )
    base.update(overrides)
    return proto.Aggregation(**base)


def run_loop(service, config, clerk_kw=(), recipient_kw=(), participant_kw=()):
    """The full loop of tests/test_full_loop.py; returns the reveal."""
    recipient = make_client(service, **dict(recipient_kw))
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = agg_default(recipient.agent.id, rkey, **CONFIGS[config])
    recipient.upload_aggregation(agg)
    clerks = [make_client(service, **dict(clerk_kw)) for _ in range(8)]
    for clerk in clerks:
        key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(key)
    recipient.begin_aggregation(agg.id)
    for _ in range(2):
        participant = make_client(service, **dict(participant_kw))
        participant.upload_agent()
        participant.participate(np.array([1, 2, 3, 4]), agg.id)
    recipient.end_aggregation(agg.id)

    status = recipient.service.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == 2 and len(status.snapshots) == 1
    assert status.snapshots[0].result_ready is False

    recipient.run_chores(-1)
    for clerk in clerks:
        clerk.run_chores(-1)
    status = recipient.service.get_aggregation_status(recipient.agent, agg.id)
    expected_results = agg.committee_sharing_scheme.output_size
    assert status.snapshots[0].number_of_clerking_results == expected_results
    assert status.snapshots[0].result_ready is True
    return recipient.reveal_aggregation(agg.id).positive().values.tolist()


@pytest.mark.parametrize("store", ["memory", "jsondir"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_full_loop(config, store, tmp_path):
    service = new_memory_server() if store == "memory" else new_jsondir_server(str(tmp_path))
    assert run_loop(service, config) == [2, 4, 6, 8]


@pytest.mark.parametrize("config", ["simple", "with_packedshamir"])
def test_full_loop_over_http(config):
    """The same loop over the port's REST transport (a port server over a
    jsondir store)."""
    from .test_torch_failure_tolerance import with_service

    with with_service("http") as service:
        assert run_loop(service, config) == [2, 4, 6, 8]


def test_verified_key_cache_skips_refetch_and_never_caches_failures():
    """A (owner, key) pair that verified once is not fetched again; a failed
    verification is retried on every call and never cached."""
    service = new_memory_server()
    owner = make_client(service)
    key_id = owner.new_encryption_key()
    owner.upload_agent()
    owner.upload_encryption_key(key_id)
    user = make_client(service)
    calls = []
    real_get = user.service.get_encryption_key
    user.service.get_encryption_key = lambda caller, kid: calls.append(kid) or real_get(caller, kid)
    first = user._verified_encryption_key(owner.agent.id, key_id)
    assert calls == [key_id]
    assert user._verified_encryption_key(owner.agent.id, key_id) is first
    assert calls == [key_id]
    bad = make_client(service)
    bad_calls = []
    bad.service.get_encryption_key = (
        lambda caller, kid: bad_calls.append(kid) or real_get(caller, kid))
    bad.crypto.signature_is_valid = lambda *_: False
    for _ in range(2):
        with pytest.raises(Invalid, match="^Signature verification failed for key$"):
            bad._verified_encryption_key(owner.agent.id, key_id)
    assert len(bad_calls) == 2 and not bad._verified_keys


def test_end_aggregation_idempotent():
    """A second end_aggregation makes no second snapshot."""
    service = new_memory_server()
    recipient = make_client(service)
    key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(key)
    agg = agg_default(recipient.agent.id, key)
    recipient.upload_aggregation(agg)
    for c in [make_client(service) for _ in range(3)]:
        ck = c.new_encryption_key()
        c.upload_agent()
        c.upload_encryption_key(ck)
    recipient.begin_aggregation(agg.id)
    recipient.end_aggregation(agg.id)
    recipient.end_aggregation(agg.id)
    assert len(service.get_aggregation_status(recipient.agent, agg.id).snapshots) == 1


def test_client_device_bulk_combine_full_loop():
    """Clerks combine on the device route (test_engine.py:316)."""
    assert run_loop(new_memory_server(), "with_packedshamir",
                    clerk_kw={"device_bulk_threshold": 1},
                    recipient_kw={"device_bulk_threshold": 1}) == [2, 4, 6, 8]


def test_client_device_reveal_chacha_full_loop(monkeypatch):
    """The recipient re-expands the ChaCha seeds through the device route and
    reconstructs on the device (test_engine.py:349)."""
    from sda_tpu_torch.ops import chacha_kernel
    from sda_tpu_torch.routing import RoutingPolicy

    calls = []
    real = chacha_kernel.combine_masks_device

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(chacha_kernel, "combine_masks_device", spy)
    assert run_loop(new_memory_server(), "with_chachamask",
                    recipient_kw={"device_bulk_threshold": 1,
                                  "routing": RoutingPolicy.force("device")}) == [2, 4, 6, 8]
    assert calls == ["cpu"]


@pytest.mark.parametrize("config", ["simple", "with_packedshamir"])
def test_client_device_share_generation_full_loop(config, monkeypatch):
    """Participants share on the device (share_mxu, test_engine.py:381)."""
    from sda_tpu_torch.engine import TorchAggregationEngine

    calls = []
    real = TorchAggregationEngine.share_mxu

    def spy(self, ext):
        calls.append(ext.device.type)
        return real(self, ext)

    monkeypatch.setattr(TorchAggregationEngine, "share_mxu", spy)
    assert run_loop(new_memory_server(), config,
                    participant_kw={"device_bulk_threshold": 1}) == [2, 4, 6, 8]
    assert calls == ["cpu", "cpu"]


def test_recipient_reconstructs_a_threshold_subset_on_the_device():
    """A degraded committee: the device reconstruction applies the subset's
    Lagrange matrix (the modmat route)."""
    scheme = proto.PackedShamirSharing(3, 8, 4, 433, 354, 150).engine()
    rng = np.random.default_rng(3)
    secrets = [rng.integers(0, 433, size=10) for _ in range(3)]
    shares = [scheme.share_vector(s) for s in secrets]
    combined = [(j, scheme.combine([s[j] for s in shares])) for j in range(8)]
    subset = [combined[j] for j in (0, 2, 3, 5, 6, 7, 1)]
    client = make_client(new_memory_server(), device_bulk_threshold=1)
    got = client._device_reconstruct(scheme, subset, 10)
    assert positive(got, 433).tolist() == (np.sum(secrets, axis=0) % 433).tolist()


# ------------------------------------------------ clerk routing (test_clerk_routing.py)


def _setup_job(service, participants=4, dimension=6):
    recipient = make_client(service)
    rk = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rk)
    agg = proto.Aggregation(
        id=proto.new_id(), title="routing", vector_dimension=dimension, modulus=433,
        recipient=recipient.agent.id, recipient_key=rk, masking_scheme=proto.NoMasking(),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=3, modulus=433),
    )
    recipient.upload_aggregation(agg)
    clerks = [make_client(service) for _ in range(3)]
    for c in clerks:
        key = c.new_encryption_key()
        c.upload_agent()
        c.upload_encryption_key(key)
    recipient.begin_aggregation(agg.id)
    for i in range(participants):
        p = make_client(service)
        p.upload_agent()
        p.participate(np.arange(dimension) + i, agg.id)
    recipient.end_aggregation(agg.id)
    for clerk in clerks:
        job = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
        if job is not None:
            return clerk, job, agg
    raise AssertionError("no clerk received a job")


def _spy(monkeypatch):
    calls = {"fused": 0, "device": 0, "device_results": []}
    real_fused = ShareDecryptor.open_combine

    def spy_fused(self, encs, modulus, dim, workers=None):
        calls["fused"] += 1
        return real_fused(self, encs, modulus, dim, workers)

    import sda_tpu_torch.engine

    real_device = sda_tpu_torch.engine.device_combine

    def spy_device(modulus, share_vectors, chunk_size=256, device=None):
        calls["device"] += 1
        assert device == "cpu"
        out = real_device(modulus, share_vectors, chunk_size=chunk_size, device=device)
        calls["device_results"].append(out)
        return out

    monkeypatch.setattr(ShareDecryptor, "open_combine", spy_fused)
    monkeypatch.setattr(sda_tpu_torch.engine, "device_combine", spy_device)
    return calls


def test_routing_sequential_by_default(monkeypatch):
    clerk, job, _ = _setup_job(new_memory_server())
    calls = _spy(monkeypatch)
    clerk.device_bulk_threshold = None
    assert clerk.process_clerking_job(job).job == job.id
    assert (calls["fused"], calls["device"]) == (0, 0)


def test_routing_fused_below_crossover(monkeypatch):
    clerk, job, _ = _setup_job(new_memory_server())
    calls = _spy(monkeypatch)
    clerk.device_bulk_threshold = 1
    clerk.process_clerking_job(job)
    assert (calls["fused"], calls["device"]) == (1, 0)


def test_routing_device_fallback_without_native_above_crossover(monkeypatch):
    """The device route fires only when the fused open cannot run; its
    combine equals the fused native one."""
    clerk, job, agg = _setup_job(new_memory_server())
    calls = _spy(monkeypatch)
    own_key = next(k for cid, k in clerk.service.get_committee(clerk.agent, agg.id).clerks_and_keys
                   if cid == clerk.agent.id)
    decryptor = clerk.crypto.new_share_decryptor(own_key, agg.committee_encryption_scheme)
    fused = decryptor.open_combine(job.encryptions, 433, 6)
    monkeypatch.setattr(ShareDecryptor, "open_combine",
                        lambda self, encs, modulus, dim, workers=None: None)
    clerk.device_bulk_threshold = 1
    monkeypatch.setattr(client_mod, "DEVICE_COMBINE_CROSSOVER", 10)
    clerk.process_clerking_job(job)
    assert calls["device"] == 1
    assert calls["device_results"][0].tolist() == fused.tolist()


def test_routing_fused_preferred_even_above_crossover(monkeypatch):
    clerk, job, _ = _setup_job(new_memory_server())
    calls = _spy(monkeypatch)
    clerk.device_bulk_threshold = 1
    monkeypatch.setattr(client_mod, "DEVICE_COMBINE_CROSSOVER", 10)
    clerk.process_clerking_job(job)
    assert (calls["fused"], calls["device"]) == (1, 0)


def test_fused_combine_congruent_to_sequential_fold():
    clerk, job, agg = _setup_job(new_memory_server())
    own_key = next(k for cid, k in clerk.service.get_committee(clerk.agent, agg.id).clerks_and_keys
                   if cid == clerk.agent.id)
    decryptor = clerk.crypto.new_share_decryptor(own_key, agg.committee_encryption_scheme)
    vecs = [decryptor.decrypt(e) for e in job.encryptions]
    seq = agg.committee_sharing_scheme.engine().combine(vecs)
    fused = decryptor.open_combine(job.encryptions, 433, len(vecs[0]))
    assert fused is not None
    assert positive(seq, 433).tolist() == fused.tolist()


def test_bulk_routing_falls_back_without_native(monkeypatch):
    import sda_tpu_torch.utils.varint as varint_mod

    clerk, job, _ = _setup_job(new_memory_server())
    monkeypatch.setattr(varint_mod, "_NATIVE", None)
    clerk.device_bulk_threshold = 1
    assert clerk.process_clerking_job(job).job == job.id


def test_streamed_decrypt_rejects_uniformly_wrong_length():
    from sda_tpu_torch import sodium
    from sda_tpu_torch.utils.varint import encode_varints

    ek, dk = sodium.box_keypair()
    encs = [proto.Encryption(data=sodium.seal(encode_varints(np.arange(9, dtype=np.int64)), ek))
            for _ in range(4)]
    dec = ShareDecryptor(ek, dk)
    with pytest.raises(Invalid, match="Wrong dimension"):
        list(_streamed_decrypt(dec, encs, expected_len=8, chunk=2))
    assert len(list(_streamed_decrypt(dec, encs, expected_len=9, chunk=2))) == 4


# ------------------------------------------------------------- the mixed loop


def _convert(obj, target):
    """An object of one package's protocol as the other's, through its wire
    JSON (the way an HTTP peer would receive it)."""
    if obj is None or isinstance(obj, (str, int, bool, bytes)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert(x, target) for x in obj)
    wire = json.loads(json.dumps(obj.to_obj()))
    name = type(obj).__name__
    if name == "Signed":
        return target.signed_encryption_key_from_obj(wire)
    return getattr(target, name).from_obj(wire)


class WireBridge:
    """The reference's in-process service seen by the port's clients: every
    argument and result crosses as wire JSON."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        method = getattr(self.inner, name)

        def call(*args, **kwargs):
            args = [_convert(a, ref_proto) for a in args]
            kwargs = {k: _convert(v, ref_proto) for k, v in kwargs.items()}
            return _convert(method(*args, **kwargs), proto)

        return call


@pytest.mark.parametrize("config", list(CONFIGS))
def test_port_clients_against_the_reference_server(config):
    assert run_loop(WireBridge(ref_memory_server()), config) == [2, 4, 6, 8]
