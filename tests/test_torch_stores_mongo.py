"""The port's Mongo store (``sda_tpu_torch.stores_mongo``) against sda_tpu's.

Runs on the in-repo pymongo-API fake (``tests/fake_pymongo.py``), installed
as ``sys.modules["pymongo"]`` for each test, as ``tests/test_stores_mongo.py``
does when pymongo is missing, so no mongod is needed. The port's store
imports pymongo only when one is built. It holds:

- the ``_MongoKV`` contract cases of ``tests/test_stores_mongo.py``: the
  KV contract, the atomic compare-on-conflict create, contention, the
  duplicate-key behaviour it rests on, the upsert, the pipeline's numeric
  array index and the missing-participation refusal;
- the server-side transposition, one parametrised test over the layouts
  the reference's pipeline cases use (shuffled insertion, a frozen subset,
  short encryption arrays, no participations), each equal to the
  reference's ``_MongoKV`` on the same documents;
- one full packed-Shamir loop through the port's client on the store.
"""

import secrets
import sys

import numpy as np
import pytest

from sda_tpu import protocol as ref_proto
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.client import Keystore, MemoryStore, SdaClient, new_agent
from sda_tpu_torch.utils.errors import Invalid
from tests import fake_pymongo

URL = "mongodb://localhost:27017"


@pytest.fixture(autouse=True)
def fake_mongo(monkeypatch):
    monkeypatch.setitem(sys.modules, "pymongo", fake_pymongo)


def _db():
    return f"sda-torch-test-{secrets.randbits(64)}"


@pytest.fixture
def mongo_kv():
    from sda_tpu_torch.stores_mongo import _MongoKV

    db = _db()
    yield _MongoKV(URL, db)
    fake_pymongo.MongoClient(URL).drop_database(db)


# ------------------------------------------------------ the KV contract


def test_kv_contract(mongo_kv):
    assert mongo_kv.get("ns", "a") is None
    mongo_kv.put("ns", "a", {"x": 1})
    assert mongo_kv.get("ns", "a") == {"x": 1}
    mongo_kv.put("ns", "a", {"x": 2})  # upsert overwrites
    assert mongo_kv.get("ns", "a") == {"x": 2}
    mongo_kv.put("ns", "b", {"y": 3})
    mongo_kv.put("other/ns", "c", {"z": 4})  # namespaces are isolated
    assert mongo_kv.keys("ns") == ["a", "b"]
    assert mongo_kv.keys("other/ns") == ["c"]
    mongo_kv.delete("ns", "a")
    assert mongo_kv.get("ns", "a") is None
    assert mongo_kv.keys("ns") == ["b"]
    mongo_kv.create("ns", "d", {"v": 1})
    mongo_kv.create("ns", "d", {"v": 1})  # idempotent re-create
    with pytest.raises(Invalid):
        mongo_kv.create("ns", "d", {"v": 2})


def test_upsert_contract(mongo_kv):
    """``put`` seeds the filter's ``_k`` into the created document and never
    duplicates it on repeat."""
    ns = "upsert/contract"
    mongo_kv.put(ns, "k1", {"a": 1})
    mongo_kv.put(ns, "k1", {"a": 2})
    docs = list(mongo_kv._coll(ns).find({"_k": "k1"}))
    assert len(docs) == 1 and docs[0]["_k"] == "k1" and docs[0]["v"] == {"a": 2}


def test_create_contract_atomic_via_unique_index(mongo_kv):
    ns = "create/contract"
    mongo_kv.create(ns, "k", {"a": 1})
    mongo_kv.create(ns, "k", {"a": 1})  # idempotent retry
    with pytest.raises(Invalid, match="conflicting create"):
        mongo_kv.create(ns, "k", {"a": 2})
    assert mongo_kv.get(ns, "k") == {"a": 1}
    assert len(list(mongo_kv._coll(ns).find({"_k": "k"}))) == 1


def test_create_contention_distinct_from_conflict(mongo_kv):
    """Retries exhausted under delete/create churn report contention, not a
    compare-on-conflict failure."""
    ns = "create/churn"
    coll = mongo_kv._coll(ns)
    real_insert = coll.insert_one

    def churny_insert(doc):
        real_insert(dict(doc))  # another writer wins, then deletes
        coll.delete_one({"_k": doc["_k"]})
        raise fake_pymongo.errors.DuplicateKeyError("duplicate key")

    coll.insert_one = churny_insert
    try:
        with pytest.raises(Invalid, match="contention.*retry"):
            mongo_kv.create(ns, "k", {"a": 1})
    finally:
        coll.insert_one = real_insert


def test_insert_one_contract_duplicate_key(mongo_kv):
    coll = mongo_kv._coll("insert/contract")
    coll.insert_one({"_k": "x", "v": 1})
    with pytest.raises(fake_pymongo.errors.DuplicateKeyError):
        coll.insert_one({"_k": "x", "v": 2})
    assert [d["v"] for d in coll.find({"_k": "x"})] == [1]


# ---------------------------------------------------- the transposition


def _put_participation(kv, ns, pid, n_clerks, tag):
    kv.put(ns, pid, {"id": pid, "clerk_encryptions": [
        [f"clerk{ci}", {"Sodium": proto._b64e(bytes([ci, tag]))}] for ci in range(n_clerks)]})


def test_pipeline_contract_array_index_numeric(mongo_kv):
    """``includeArrayIndex`` emits a number, so ``int(_id)`` and
    ``ix >= clerks_number`` are both defined."""
    ns = "participations/ixtype"
    pid = proto.new_id()
    _put_participation(mongo_kv, ns, pid, 3, 0)
    pipeline = [
        {"$match": {"_k": {"$in": [pid]}}},
        {"$unwind": {"path": "$v.clerk_encryptions", "includeArrayIndex": "clerk_ix"}},
        {"$group": {"_id": "$clerk_ix", "shares": {"$push": "$v.clerk_encryptions"}}},
        {"$sort": {"_id": 1}},
    ]
    ids = [d["_id"] for d in mongo_kv._coll(ns).aggregate(pipeline, allowDiskUse=True)]
    assert [int(i) for i in ids] == [0, 1, 2]
    assert all(isinstance(i, int) and i < 3 for i in ids)


def test_pipeline_contract_missing_pid_raises(mongo_kv):
    ns = "participations/missing"
    pid = proto.new_id()
    _put_participation(mongo_kv, ns, pid, 2, 0)
    with pytest.raises(Invalid, match="inconsistent snapshot"):
        list(mongo_kv.transpose_clerk_encryptions(ns, [pid, proto.new_id()], 2))


# (participations, encryptions each carries, clerks asked for, insertion
# order, how many of the participations are frozen)
LAYOUTS = {
    "all": (10, 3, 3, None, 10),
    "shuffled insertion": (7, 4, 4, (3, 0, 6, 2, 5, 1, 4), 7),
    "frozen subset": (6, 2, 2, None, 3),
    "short arrays": (2, 1, 3, None, 2),
    "no participations": (4, 3, 3, None, 0),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_transposition_matches_reference(layout):
    """``[participants x clerks] -> [clerks x participants]`` on the
    database: ``clerks`` columns in clerk order, each holding exactly the
    frozen participations' encryptions for that clerk, equal to the
    reference's ``_MongoKV`` on the same documents."""
    from sda_tpu.stores_mongo import _MongoKV as RefMongoKV
    from sda_tpu_torch.stores_mongo import _MongoKV

    n_parts, n_enc, clerks, order, n_frozen = LAYOUTS[layout]
    db, ref_db = _db(), _db()
    port, ref = _MongoKV(URL, db), RefMongoKV(URL, ref_db)
    try:
        ns = "participations/agg"
        pids = [proto.new_id() for _ in range(n_parts)]
        for pi in order or range(n_parts):
            for kv in (port, ref):
                _put_participation(kv, ns, pids[pi], n_enc, pi)
        frozen = pids[:n_frozen]
        cols = list(port.transpose_clerk_encryptions(ns, frozen, clerks))
        assert cols == list(ref.transpose_clerk_encryptions(ns, frozen, clerks))
        assert len(cols) == clerks
        for ci, col in enumerate(cols):
            want = sorted(bytes([ci, pi]) for pi in range(n_frozen)) if ci < n_enc else []
            assert sorted(proto._b64d(e["Sodium"]) for e in col) == want
    finally:
        fake_pymongo.MongoClient(URL).drop_database(db)
        fake_pymongo.MongoClient(URL).drop_database(ref_db)


def test_wire_documents_are_the_references(mongo_kv):
    """A participation stored through the port's server reads back through
    the reference's protocol objects unchanged: both packages keep the
    same documents."""
    from sda_tpu_torch.stores import Stores

    stores = Stores(mongo_kv)
    part = proto.Participation(
        id=proto.new_id(), participant=proto.new_id(), aggregation=proto.new_id(),
        recipient_encryption=None,
        clerk_encryptions=tuple((proto.new_id(), proto.Encryption(bytes([ci, 7])))
                                for ci in range(3)))
    stores.create_participation(part)
    doc = mongo_kv.get(f"participations/{part.aggregation}", part.id)
    assert ref_proto.Participation.from_obj(doc).to_obj() == part.to_obj()


# ------------------------------------------------------- the full loop


def test_mongo_full_crypto_loop():
    """Recipient + 8 clerks + 2 participants of ``[1, 2, 3, 4]`` under packed
    Shamir at p = 433 through the port's client on the Mongo store."""
    from sda_tpu_torch.stores_mongo import new_mongo_server

    def make_client():
        keystore = Keystore(MemoryStore())
        return SdaClient(new_agent(keystore), keystore, service, device="cpu")

    db = _db()
    service = new_mongo_server(URL, db)
    try:
        recipient = make_client()
        rkey = recipient.new_encryption_key()
        recipient.upload_agent()
        recipient.upload_encryption_key(rkey)
        agg = proto.Aggregation(
            id=proto.new_id(), title="foo", vector_dimension=4, modulus=433,
            recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=proto.NoMasking(),
            committee_sharing_scheme=proto.PackedShamirSharing(
                secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
                omega_secrets=354, omega_shares=150))
        recipient.upload_aggregation(agg)
        clerks = [make_client() for _ in range(8)]
        for c in clerks:
            key = c.new_encryption_key()
            c.upload_agent()
            c.upload_encryption_key(key)
        recipient.begin_aggregation(agg.id)
        for _ in range(2):
            p = make_client()
            p.upload_agent()
            p.participate(np.array([1, 2, 3, 4]), agg.id)
        recipient.end_aggregation(agg.id)
        recipient.run_chores(-1)
        for c in clerks:
            c.run_chores(-1)
        assert recipient.reveal_aggregation(agg.id).positive().values.tolist() == [2, 4, 6, 8]
    finally:
        fake_pymongo.MongoClient(URL).drop_database(db)
