"""HTTP client proxy: the full SdaService re-implemented over REST.

Port of the reference package's ``http.client``. Mirrors
`sda-client-http` (client-http/src/client.rs):
every service method maps 1:1 to a route; requests are decorated with Basic
auth from a token store that auto-generates a random 32-char ascii token on
first use (tokenstore.rs:8-23 — the trust-on-first-use secret); response
statuses map back to the same error kinds the in-process service raises, so
client code cannot tell the transports apart.

``requests`` is imported when a proxy is built, not with this module.
"""

from __future__ import annotations

import secrets
import string
from typing import Optional

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.service import SdaService
from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied, SdaError

__all__ = ["HttpSdaService", "token_for_store"]


def token_for_store(store) -> str:
    """Get-or-create the agent's auth token (tokenstore.rs semantics)."""
    existing = store.get("auth_token")
    if existing is not None:
        return existing
    alphabet = string.ascii_letters + string.digits
    token = "".join(secrets.choice(alphabet) for _ in range(32))
    store.put("auth_token", token)
    return token


class HttpSdaService(SdaService):
    def __init__(self, server_root: str, token_store):
        import requests

        self.server_root = server_root.rstrip("/")
        self.token_store = token_store
        self.session = requests.Session()

    def clone_fresh(self) -> "HttpSdaService":
        """New proxy with its own (fresh) token store — one per agent, since
        the auth token is the agent's trust-on-first-use secret."""
        from sda_tpu_torch.client.store import MemoryStore

        return HttpSdaService(self.server_root, MemoryStore())

    # --------------------------------------------------------- plumbing

    def _auth(self, caller: Optional[proto.Agent]):
        if caller is None:
            return None
        return (caller.id, token_for_store(self.token_store))

    def _process(self, response):
        """Status -> result mapping, symmetric to the server
        (client.rs:43-96)."""
        if response.status_code in (200, 201):
            if response.content:
                return response.json()
            return None
        if response.status_code == 404:
            if "Resource-not-found" in response.headers:
                return None
            raise SdaError("HTTP/REST route not found")
        if response.status_code == 401:
            raise InvalidCredentials()
        if response.status_code == 403:
            raise PermissionDenied()
        if response.status_code == 400:
            raise Invalid(response.text)
        raise SdaError(f"HTTP/REST error: {response.status_code} {response.text}")

    def _get(self, caller, path, params=None):
        return self._process(
            self.session.get(
                self.server_root + path,
                params=params,
                auth=self._auth(caller),
                headers={"User-Agent": "SDA CLI client"},
            )
        )

    def _post(self, caller, path, body):
        obj = body.to_obj() if hasattr(body, "to_obj") else body
        return self._process(
            self.session.post(
                self.server_root + path,
                json=obj,
                auth=self._auth(caller),
                headers={"User-Agent": "SDA CLI client"},
            )
        )

    def _delete(self, caller, path):
        return self._process(
            self.session.delete(self.server_root + path, auth=self._auth(caller))
        )

    # ------------------------------------------------------------ methods

    def ping(self) -> proto.Pong:
        obj = self._get(None, "/v1/ping")
        return proto.Pong.from_obj(obj)

    def create_agent(self, caller, agent):
        self._post(caller, "/v1/agents/me", agent)

    def get_agent(self, caller, agent_id):
        obj = self._get(caller, f"/v1/agents/{agent_id}")
        return proto.Agent.from_obj(obj) if obj is not None else None

    def upsert_profile(self, caller, profile):
        self._post(caller, "/v1/agents/me/profile", profile)

    def get_profile(self, caller, owner):
        obj = self._get(caller, f"/v1/agents/{owner}/profile")
        return proto.Profile.from_obj(obj) if obj is not None else None

    def create_encryption_key(self, caller, key):
        self._post(caller, "/v1/agents/me/keys", key)

    def get_encryption_key(self, caller, key_id):
        obj = self._get(caller, f"/v1/agents/any/keys/{key_id}")
        return proto.signed_encryption_key_from_obj(obj) if obj is not None else None

    def list_aggregations(self, caller, filter=None, recipient=None):
        params = {}
        if filter is not None:
            params["title"] = filter
        if recipient is not None:
            params["recipient"] = recipient
        obj = self._get(caller, "/v1/aggregations", params=params)
        return list(obj) if obj is not None else []

    def get_aggregation(self, caller, aggregation):
        obj = self._get(caller, f"/v1/aggregations/{aggregation}")
        return proto.Aggregation.from_obj(obj) if obj is not None else None

    def get_committee(self, caller, aggregation):
        obj = self._get(caller, f"/v1/aggregations/{aggregation}/committee")
        return proto.Committee.from_obj(obj) if obj is not None else None

    def create_aggregation(self, caller, aggregation):
        self._post(caller, "/v1/aggregations", aggregation)

    def delete_aggregation(self, caller, aggregation):
        self._delete(caller, f"/v1/aggregations/{aggregation}")

    def suggest_committee(self, caller, aggregation):
        obj = self._get(caller, f"/v1/aggregations/{aggregation}/committee/suggestions")
        if obj is None:
            return []
        return [proto.ClerkCandidate.from_obj(c) for c in obj]

    def create_committee(self, caller, committee):
        self._post(caller, "/v1/aggregations/implied/committee", committee)

    def create_participation(self, caller, participation):
        self._post(caller, "/v1/aggregations/participations", participation)

    def get_aggregation_status(self, caller, aggregation):
        obj = self._get(caller, f"/v1/aggregations/{aggregation}/status")
        return proto.AggregationStatus.from_obj(obj) if obj is not None else None

    def create_snapshot(self, caller, snapshot):
        self._post(caller, "/v1/aggregations/implied/snapshot", snapshot)

    def get_clerking_job(self, caller, clerk):
        obj = self._get(caller, "/v1/aggregations/any/jobs")
        return proto.ClerkingJob.from_obj(obj) if obj is not None else None

    def create_clerking_result(self, caller, result):
        self._post(caller, f"/v1/aggregations/implied/jobs/{result.job}/result", result)

    def get_snapshot_result(self, caller, aggregation, snapshot):
        obj = self._get(caller, f"/v1/aggregations/{aggregation}/snapshots/{snapshot}/result")
        return proto.SnapshotResult.from_obj(obj) if obj is not None else None
