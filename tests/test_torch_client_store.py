"""The port's client-side store and keystore: the twin of
``tests/test_client_store.py`` on ``sda_tpu_torch``.

The reference's five cases, then the files themselves: what the port's
``Filebased`` store and ``Keystore`` write, the reference's read back
equal, and the reverse, so an identity directory made by one package serves
the other.
"""

import pytest

from sda_tpu.client.crypto import Keystore as RefKeystore
from sda_tpu.client.store import Filebased as RefFilebased
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.client.crypto import Keystore
from sda_tpu_torch.client.store import Filebased, MemoryStore
from sda_tpu_torch.utils.errors import Invalid


@pytest.mark.parametrize("make", [MemoryStore, None], ids=["memory", "filebased"])
def test_kv_and_alias(tmp_path, make):
    store = make() if make else Filebased(str(tmp_path / "s"))
    assert store.get("missing") is None
    store.put("k", {"a": 1})
    assert store.get("k") == {"a": 1}
    store.put("k", {"a": 2})  # upsert
    assert store.get("k") == {"a": 2}
    store.put_alias("latest", "k")
    assert store.get_alias("latest") == "k"
    assert store.get_aliased("latest") == {"a": 2}
    assert store.get_aliased("nothing") is None


def test_filebased_persists(tmp_path):
    p = str(tmp_path / "s")
    Filebased(p).put("x", [1, 2, 3])
    assert Filebased(p).get("x") == [1, 2, 3]


def test_keystore_roundtrip(tmp_path):
    ks = Keystore(Filebased(str(tmp_path / "keys")))
    ks.put_encryption_keypair("id1", b"\x01" * 32, b"\x02" * 32)
    assert ks.get_encryption_keypair("id1") == (b"\x01" * 32, b"\x02" * 32)
    assert ks.get_encryption_keypair("nope") is None
    ks.put_signature_keypair("id2", b"\x03" * 32, b"\x04" * 64)
    assert ks.get_signature_keypair("id2") == (b"\x03" * 32, b"\x04" * 64)


def test_store_create_conflict_semantics(tmp_path):
    """The JSON-directory store's compare-on-conflict create."""
    from sda_tpu_torch.stores import JsonDirStores

    stores = JsonDirStores(str(tmp_path / "srv"))
    agent = proto.Agent(id=proto.new_id(), verification_key=proto.Labelled(
        id=proto.new_id(), body=proto.VerificationKey(bytes(32))))
    stores.create_agent(agent)
    stores.create_agent(agent)  # an identical re-create is fine (retry safety)
    conflicting = proto.Agent(id=agent.id, verification_key=proto.Labelled(
        id=proto.new_id(), body=proto.VerificationKey(bytes(32))))
    with pytest.raises(Invalid):
        stores.create_agent(conflicting)


STORES = {"port": (Filebased, Keystore), "reference": (RefFilebased, RefKeystore)}


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_identity_directory_serves_both_packages(tmp_path, writer, reader):
    """Values, aliases and key pairs written by one package read back equal
    in the other, and the files are byte-equal to what the other writes."""
    def fill(store_cls, keystore_cls, root):
        store = store_cls(str(root / "s"))
        store.put("agent", {"id": "a", "keys": [1, 2]})
        store.put_alias("latest", "agent")
        ks = keystore_cls(store_cls(str(root / "k")))
        ks.put_encryption_keypair("e", bytes(range(32)), bytes(range(32, 64)))
        ks.put_signature_keypair("s", bytes(range(64, 96)), bytes(range(64)))

    fill(*STORES[writer], tmp_path / "w")
    store_cls, keystore_cls = STORES[reader]
    store = store_cls(str(tmp_path / "w" / "s"))
    assert store.get("agent") == {"id": "a", "keys": [1, 2]}
    assert store.get_aliased("latest") == {"id": "a", "keys": [1, 2]}
    ks = keystore_cls(store_cls(str(tmp_path / "w" / "k")))
    assert ks.get_encryption_keypair("e") == (bytes(range(32)), bytes(range(32, 64)))
    assert ks.get_signature_keypair("s") == (bytes(range(64, 96)), bytes(range(64)))
    fill(*STORES[reader], tmp_path / "r")
    files = sorted(p.relative_to(tmp_path / "w") for p in (tmp_path / "w").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "r") for p in (tmp_path / "r").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "w" / f).read_bytes() == (tmp_path / "r" / f).read_bytes()
