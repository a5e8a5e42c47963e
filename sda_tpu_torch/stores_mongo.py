"""MongoDB storage backend (optional; requires pymongo).

Port of the reference package's ``stores_mongo``. The upstream project
ships a Mongo production store (`sda-server-store-mongodb`);
its one special trick is pushing the snapshot transposition into a Mongo
aggregation pipeline with ``allow_disk_use``
(server-store-mongodb/src/aggregations.rs:164-195) because
the jfs default transposes in RAM. This backend keeps that trick
(:meth:`_MongoKV.transpose_clerk_encryptions` — ``$match`` the frozen ids,
``$unwind`` the clerk-encryption array with its index, ``$group`` by clerk
index, ``$sort``) while the rest is a thin KV adapter over the shared
:class:`sda_tpu_torch.stores.Stores` logic: one document per record, one
collection per namespace, unique index on ``_k``. All store semantics
(compare-on-conflict create, durable job queues, snapshot freezing) are
inherited and covered by the same tests (run against a pymongo-API fake in
CI, or a real mongod when one is reachable). Bulk device workloads
transpose on the device instead (``all_to_all_axis`` in
:mod:`sda_tpu_torch.parallel`). ``pymongo`` is imported when a store is
built, not with this module.
"""

from __future__ import annotations

from typing import Iterator

from sda_tpu_torch.stores import Stores, _KV

__all__ = ["MongoStores", "new_mongo_server"]


class _MongoKV(_KV):
    def __init__(self, url: str, db_name: str = "sda"):
        try:
            import pymongo
        except ImportError as e:
            raise ImportError(
                "MongoDB store requires pymongo (not installed in this environment)"
            ) from e
        self._client = pymongo.MongoClient(url)
        self._db = self._client[db_name]
        self._indexed: set[str] = set()

    def _coll(self, ns: str):
        name = ns.replace("/", "__")
        coll = self._db[name]
        if name not in self._indexed:
            coll.create_index("_k", unique=True, background=True)
            self._indexed.add(name)
        return coll

    def get(self, ns, key):
        doc = self._coll(ns).find_one({"_k": key})
        if doc is None:
            return None
        doc.pop("_id", None)
        doc.pop("_k", None)
        return doc["v"]

    def put(self, ns, key, value):
        self._coll(ns).update_one({"_k": key}, {"$set": {"v": value}}, upsert=True)

    def create(self, ns, key, value):
        """Atomic compare-on-conflict create: the unique ``_k`` index makes
        ``insert_one`` the linearisation point, so two concurrent creates
        with different values cannot both win (the base class's
        get-then-put could lose the conflict under the threaded server)."""
        import pymongo

        from sda_tpu_torch.utils.errors import Invalid

        for _ in range(4):
            try:
                self._coll(ns).insert_one({"_k": key, "v": value})
                return
            except pymongo.errors.DuplicateKeyError:
                existing = self.get(ns, key)
                if existing == value:
                    return  # idempotent retry of the same create
                if existing is not None:
                    raise Invalid(f"conflicting create for {ns}/{key}")
                # the winning doc was deleted between our failed insert and
                # the read — the key is creatable again; retry the insert
        # retries exhausted without ever observing a conflicting value:
        # that is delete/create churn, not a compare-on-conflict failure
        raise Invalid(f"create contention for {ns}/{key}, retry")

    def delete(self, ns, key):
        self._coll(ns).delete_one({"_k": key})

    def keys(self, ns):
        return sorted(d["_k"] for d in self._coll(ns).find({}, {"_k": 1}))

    def transpose_clerk_encryptions(
        self, ns: str, pids: list[str], clerks_number: int
    ) -> Iterator[list]:
        """Server-side [participants x clerks] transposition.

        The reference's scalable path (aggregations.rs:164-195): the
        database regroups and spills to disk; the server never holds the
        full matrix. Yields ``clerks_number`` raw-encryption columns.

        A frozen participation id missing from the collection is a
        corrupted snapshot; the ``$in`` match would silently shrink the
        aggregate, so the matched count is verified up front and a
        mismatch raises — matching the generic path's
        "inconsistent snapshot" semantics (:mod:`sda_tpu_torch.stores`).
        """
        from sda_tpu_torch.utils.errors import Invalid

        matched = self._coll(ns).count_documents({"_k": {"$in": list(pids)}})
        if matched != len(set(pids)):
            raise Invalid("inconsistent snapshot: missing participation")
        pipeline = [
            {"$match": {"_k": {"$in": list(pids)}}},
            {
                "$unwind": {
                    "path": "$v.clerk_encryptions",
                    "includeArrayIndex": "clerk_ix",
                }
            },
            {
                "$group": {
                    "_id": "$clerk_ix",
                    "shares": {"$push": "$v.clerk_encryptions"},
                }
            },
            {"$sort": {"_id": 1}},
        ]
        # the cursor arrives $sort-ed by clerk index: stream it, filling in
        # empty columns for clerks with no shares (0-participation edge)
        next_ix = 0
        for doc in self._coll(ns).aggregate(pipeline, allowDiskUse=True):
            ix = int(doc["_id"])
            if ix >= clerks_number:
                break
            while next_ix < ix:
                yield []
                next_ix += 1
            yield [pair[1] for pair in doc["shares"]]
            next_ix = ix + 1
        while next_ix < clerks_number:
            yield []
            next_ix += 1


def MongoStores(url: str, db_name: str = "sda") -> Stores:
    return Stores(_MongoKV(url, db_name))


def new_mongo_server(url: str, db_name: str = "sda"):
    from sda_tpu_torch.server import SdaServer, SdaServerService

    return SdaServerService(SdaServer(MongoStores(url, db_name)))
