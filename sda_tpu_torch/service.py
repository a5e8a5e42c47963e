"""The SDA service interface bundle.

Mirrors the six service traits of protocol/src/methods.rs
(SdaBaseService + Agent/Aggregation/Clerking/Participation/Recipient). Every
method takes ``caller`` explicitly — identity is an argument, not ambient
state (methods.rs docstring convention).

Port of the reference package's ``service`` module. The port implements
it in process (:class:`sda_tpu_torch.server.SdaServerService`) and over
REST (the proxy :class:`sda_tpu_torch.http.client.HttpSdaService`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from sda_tpu_torch import protocol as proto


class SdaService(ABC):
    """Combined service interface (methods.rs:13-22)."""

    # ------------------------------------------------------------- base

    @abstractmethod
    def ping(self) -> proto.Pong: ...

    # ------------------------------------------------------------ agent

    @abstractmethod
    def create_agent(self, caller: proto.Agent, agent: proto.Agent) -> None: ...

    @abstractmethod
    def get_agent(self, caller: proto.Agent, agent_id: str) -> Optional[proto.Agent]: ...

    @abstractmethod
    def upsert_profile(self, caller: proto.Agent, profile: proto.Profile) -> None: ...

    @abstractmethod
    def get_profile(self, caller: proto.Agent, owner: str) -> Optional[proto.Profile]: ...

    @abstractmethod
    def create_encryption_key(self, caller: proto.Agent, key: proto.Signed) -> None: ...

    @abstractmethod
    def get_encryption_key(self, caller: proto.Agent, key_id: str) -> Optional[proto.Signed]: ...

    # ------------------------------------------------------ aggregation

    @abstractmethod
    def list_aggregations(
        self, caller: proto.Agent, filter: Optional[str] = None, recipient: Optional[str] = None
    ) -> list[str]: ...

    @abstractmethod
    def get_aggregation(self, caller: proto.Agent, aggregation: str) -> Optional[proto.Aggregation]: ...

    @abstractmethod
    def get_committee(self, caller: proto.Agent, aggregation: str) -> Optional[proto.Committee]: ...

    # ---------------------------------------------------- participation

    @abstractmethod
    def create_participation(self, caller: proto.Agent, participation: proto.Participation) -> None: ...

    # --------------------------------------------------------- clerking

    @abstractmethod
    def get_clerking_job(self, caller: proto.Agent, clerk: str) -> Optional[proto.ClerkingJob]: ...

    @abstractmethod
    def create_clerking_result(self, caller: proto.Agent, result: proto.ClerkingResult) -> None: ...

    # -------------------------------------------------------- recipient

    @abstractmethod
    def create_aggregation(self, caller: proto.Agent, aggregation: proto.Aggregation) -> None: ...

    @abstractmethod
    def delete_aggregation(self, caller: proto.Agent, aggregation: str) -> None: ...

    @abstractmethod
    def suggest_committee(self, caller: proto.Agent, aggregation: str) -> list[proto.ClerkCandidate]: ...

    @abstractmethod
    def create_committee(self, caller: proto.Agent, committee: proto.Committee) -> None: ...

    @abstractmethod
    def get_aggregation_status(
        self, caller: proto.Agent, aggregation: str
    ) -> Optional[proto.AggregationStatus]: ...

    @abstractmethod
    def create_snapshot(self, caller: proto.Agent, snapshot: proto.Snapshot) -> None: ...

    @abstractmethod
    def get_snapshot_result(
        self, caller: proto.Agent, aggregation: str, snapshot: str
    ) -> Optional[proto.SnapshotResult]: ...
