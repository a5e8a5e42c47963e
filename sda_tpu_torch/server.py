"""In-process SDA server: orchestration, ACL, snapshot pipeline.

Mirrors server/src/server.rs (orchestration over the store
interfaces + the ACL wrapper implementing every service trait) and
snapshot.rs (the participation-freeze + transpose + job-enqueue pipeline —
the only server-side compute).

Key semantics preserved:

- committee size must equal the sharing scheme's output size
  (server.rs:87-98);
- ``result_ready`` fires at ``#results >= reconstruction_threshold``, not at
  full participation (server.rs:119-121) — the protocol's failure tolerance;
- clerk result push re-fetches the job to prevent spoofing
  (server.rs:351-360);
- agent/profile/key reads are public; recipient-only methods verify
  ``aggregation.recipient`` (server.rs:203-336).
"""

from __future__ import annotations

from typing import Optional

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.service import SdaService
from sda_tpu_torch.stores import JsonDirStores, MemoryStores, Stores
from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied
from sda_tpu_torch.utils.logging import get_logger

_LOG = get_logger("server")

__all__ = ["SdaServer", "SdaServerService", "new_memory_server", "new_jsondir_server"]


class SdaServer:
    """Storage-agnostic orchestration (server.rs:5-191)."""

    def __init__(self, stores: Stores):
        self.stores = stores

    def ping(self) -> proto.Pong:
        self.stores.ping()
        return proto.Pong(running=True)

    # ------------------------------------------------------------- agents

    def create_agent(self, agent: proto.Agent) -> None:
        self.stores.create_agent(agent)

    def get_agent(self, agent_id: str) -> Optional[proto.Agent]:
        return self.stores.get_agent(agent_id)

    def upsert_profile(self, profile: proto.Profile) -> None:
        self.stores.upsert_profile(profile)

    def get_profile(self, owner: str) -> Optional[proto.Profile]:
        return self.stores.get_profile(owner)

    def create_encryption_key(self, key: proto.Signed) -> None:
        self.stores.create_encryption_key(key)

    def get_encryption_key(self, key_id: str) -> Optional[proto.Signed]:
        return self.stores.get_encryption_key(key_id)

    # ------------------------------------------------------- aggregations

    def list_aggregations(self, filter=None, recipient=None) -> list[str]:
        return self.stores.list_aggregations(filter, recipient)

    def get_aggregation(self, aggregation: str) -> Optional[proto.Aggregation]:
        return self.stores.get_aggregation(aggregation)

    def get_committee(self, aggregation: str) -> Optional[proto.Committee]:
        return self.stores.get_committee(aggregation)

    def create_aggregation(self, aggregation: proto.Aggregation) -> None:
        self.stores.create_aggregation(aggregation)

    def delete_aggregation(self, aggregation: str) -> None:
        self.stores.delete_aggregation(aggregation)

    def suggest_committee(self, aggregation: str) -> list[proto.ClerkCandidate]:
        if self.stores.get_aggregation(aggregation) is None:
            raise Invalid("aggregation not found")
        return self.stores.suggest_committee()

    def create_committee(self, committee: proto.Committee) -> None:
        agg = self.stores.get_aggregation(committee.aggregation)
        if agg is None:
            raise Invalid("aggregation not found")
        expected = agg.committee_sharing_scheme.output_size
        if expected != len(committee.clerks_and_keys):
            raise Invalid(
                f"Expected {expected} clerks in the committee, "
                f"found {len(committee.clerks_and_keys)} instead"
            )
        self.stores.create_committee(committee)

    def create_participation(self, participation: proto.Participation) -> None:
        self.stores.create_participation(participation)

    def get_aggregation_status(self, aggregation: str) -> Optional[proto.AggregationStatus]:
        agg = self.stores.get_aggregation(aggregation)
        if agg is None:
            return None
        snapshots = []
        for sid in self.stores.list_snapshots(aggregation):
            results_count = len(self.stores.list_results(sid))
            snapshots.append(
                proto.SnapshotStatus(
                    id=sid,
                    number_of_clerking_results=results_count,
                    # server.rs:119-121: ready at the reconstruction threshold
                    result_ready=results_count
                    >= agg.committee_sharing_scheme.reconstruction_threshold,
                )
            )
        return proto.AggregationStatus(
            aggregation=aggregation,
            number_of_participations=self.stores.count_participations(aggregation),
            snapshots=tuple(snapshots),
        )

    # --------------------------------------------------- snapshot pipeline

    def create_snapshot(self, snapshot: proto.Snapshot) -> None:
        """The snapshot pipeline (snapshot.rs:4-47).

        Freeze participations -> transpose into per-clerk jobs -> persist the
        snapshot -> collect the recipient mask blob if masking is on.
        """
        # debug progress lines mirror the reference pipeline (snapshot.rs:7-45)
        _LOG.debug("snapshotting participations for %s", snapshot.id)
        aggregation = self.stores.get_aggregation(snapshot.aggregation)
        if aggregation is None:
            raise Invalid("lost aggregation")
        self.stores.snapshot_participations(snapshot.aggregation, snapshot.id)
        committee = self.stores.get_committee(snapshot.aggregation)
        if committee is None:
            raise Invalid("lost committee")
        _LOG.debug("generating clerking jobs for %s", snapshot.id)
        encryptions = self.stores.iter_snapshot_clerk_jobs_data(
            snapshot.aggregation, snapshot.id, len(committee.clerks_and_keys)
        )
        n_jobs = 0
        for (clerk_id, _), shares in zip(committee.clerks_and_keys, encryptions):
            self.stores.enqueue_clerking_job(
                proto.ClerkingJob(
                    id=proto.new_id(),
                    clerk=clerk_id,
                    aggregation=snapshot.aggregation,
                    snapshot=snapshot.id,
                    encryptions=tuple(shares),
                )
            )
            n_jobs += 1
        _LOG.debug("enqueued %d clerking jobs for %s", n_jobs, snapshot.id)
        self.stores.create_snapshot(snapshot)
        if aggregation.masking_scheme.has_mask:
            _LOG.debug("collecting recipient mask encryptions for %s", snapshot.id)
            recipient_encryptions = []
            for part in self.stores.iter_snapped_participations(
                snapshot.aggregation, snapshot.id
            ):
                if part.recipient_encryption is None:
                    raise Invalid("participation should have had a recipient encryption")
                recipient_encryptions.append(part.recipient_encryption)
            self.stores.create_snapshot_mask(snapshot.id, recipient_encryptions)

    # ----------------------------------------------------------- clerking

    def poll_clerking_job(self, clerk: str) -> Optional[proto.ClerkingJob]:
        return self.stores.poll_clerking_job(clerk)

    def get_clerking_job(self, clerk: str, job: str) -> Optional[proto.ClerkingJob]:
        return self.stores.get_clerking_job(clerk, job)

    def create_clerking_result(self, result: proto.ClerkingResult) -> None:
        self.stores.create_clerking_result(result)

    def get_snapshot_result(self, aggregation: str, snapshot: str) -> Optional[proto.SnapshotResult]:
        results = [
            self.stores.get_result(snapshot, jid) for jid in self.stores.list_results(snapshot)
        ]
        if any(r is None for r in results):
            raise Invalid("inconsistent storage")
        return proto.SnapshotResult(
            snapshot=snapshot,
            number_of_participations=self.stores.count_participations_snapshot(
                aggregation, snapshot
            ),
            clerk_encryptions=tuple(results),
            recipient_encryptions=(
                tuple(m) if (m := self.stores.get_snapshot_mask(snapshot)) is not None else None
            ),
        )

    # --------------------------------------------------------- auth (http)

    def upsert_auth_token(self, token: proto.AuthToken) -> None:
        self.stores.upsert_auth_token(token)

    def check_auth_token(self, token: proto.AuthToken) -> proto.Agent:
        db = self.stores.get_auth_token(token.id)
        if db is not None and db == token:
            agent = self.stores.get_agent(token.id)
            if agent is None:
                raise Invalid("Agent not found")
            return agent
        raise InvalidCredentials()

    def delete_auth_token(self, agent_id: str) -> None:
        self.stores.delete_auth_token(agent_id)


def _acl_agent_is(caller: proto.Agent, agent_id: str) -> None:
    if caller.id != agent_id:
        raise PermissionDenied()


class SdaServerService(SdaService):
    """ACL wrapper implementing the full service bundle (server.rs:193-361)."""

    def __init__(self, server: SdaServer):
        self.server = server

    def ping(self) -> proto.Pong:
        return self.server.ping()

    # agent methods: reads public, writes owner-only (server.rs:217-243)

    def create_agent(self, caller, agent):
        _acl_agent_is(caller, agent.id)
        self.server.create_agent(agent)

    def get_agent(self, caller, agent_id):
        return self.server.get_agent(agent_id)

    def upsert_profile(self, caller, profile):
        _acl_agent_is(caller, profile.owner)
        self.server.upsert_profile(profile)

    def get_profile(self, caller, owner):
        return self.server.get_profile(owner)

    def create_encryption_key(self, caller, key):
        _acl_agent_is(caller, key.signer)
        self.server.create_encryption_key(key)

    def get_encryption_key(self, caller, key_id):
        return self.server.get_encryption_key(key_id)

    # aggregation discovery: public

    def list_aggregations(self, caller, filter=None, recipient=None):
        return self.server.list_aggregations(filter, recipient)

    def get_aggregation(self, caller, aggregation):
        return self.server.get_aggregation(aggregation)

    def get_committee(self, caller, aggregation):
        return self.server.get_committee(aggregation)

    # recipient-only methods (server.rs:270-336)

    def _require_recipient(self, caller, aggregation_id) -> proto.Aggregation:
        agg = self.server.get_aggregation(aggregation_id)
        if agg is None:
            raise Invalid("No aggregation found")
        _acl_agent_is(caller, agg.recipient)
        return agg

    def create_aggregation(self, caller, aggregation):
        _acl_agent_is(caller, aggregation.recipient)
        self.server.create_aggregation(aggregation)

    def delete_aggregation(self, caller, aggregation):
        self._require_recipient(caller, aggregation)
        self.server.delete_aggregation(aggregation)

    def suggest_committee(self, caller, aggregation):
        self._require_recipient(caller, aggregation)
        return self.server.suggest_committee(aggregation)

    def create_committee(self, caller, committee):
        self._require_recipient(caller, committee.aggregation)
        self.server.create_committee(committee)

    def get_aggregation_status(self, caller, aggregation):
        self._require_recipient(caller, aggregation)
        return self.server.get_aggregation_status(aggregation)

    def create_snapshot(self, caller, snapshot):
        self._require_recipient(caller, snapshot.aggregation)
        self.server.create_snapshot(snapshot)

    def get_snapshot_result(self, caller, aggregation, snapshot):
        self._require_recipient(caller, aggregation)
        return self.server.get_snapshot_result(aggregation, snapshot)

    # participation

    def create_participation(self, caller, participation):
        _acl_agent_is(caller, participation.participant)
        self.server.create_participation(participation)

    # clerking

    def get_clerking_job(self, caller, clerk):
        _acl_agent_is(caller, clerk)
        return self.server.poll_clerking_job(clerk)

    def create_clerking_result(self, caller, result):
        # anti-spoofing re-fetch (server.rs:351-360)
        job = self.server.get_clerking_job(result.clerk, result.job)
        if job is None:
            raise Invalid("Job not found")
        _acl_agent_is(caller, job.clerk)
        self.server.create_clerking_result(result)


def new_memory_server() -> SdaServerService:
    return SdaServerService(SdaServer(MemoryStores()))


def new_jsondir_server(root: str) -> SdaServerService:
    """jfs-parity durable server (sda_server::new_jfs_server equivalent)."""
    return SdaServerService(SdaServer(JsonDirStores(root)))
