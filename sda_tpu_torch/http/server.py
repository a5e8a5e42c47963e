"""REST server binding over the in-process SDA service.

Port of the reference package's ``http.server``. Mirrors
`sda-server-http`:

- the exact route table (server-http/src/lib.rs:20-60);
- HTTP Basic auth parsed into an AuthToken, **trust-on-first-use**: the token
  presented at ``POST /v1/agents/me`` is recorded and must be replayed on all
  subsequent requests (lib.rs:193-201);
- error -> status mapping 401/403/400/500 (lib.rs:105-122);
- ``None`` results are 404 with a ``Resource-not-found: true`` header to
  distinguish them from unknown routes (lib.rs:338-343).
"""

from __future__ import annotations

import base64
import contextlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote_plus

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.server import SdaServerService
from sda_tpu_torch.utils.errors import Invalid, InvalidCredentials, PermissionDenied
from sda_tpu_torch.utils.logging import get_logger

__all__ = ["SdaHttpServer", "serve_background"]

_UUID = r"[0-9a-fA-F-]{36}"
_LOG = get_logger("http")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    service: SdaServerService = None  # set by server factory

    # --------------------------------------------------------- plumbing

    def log_message(self, fmt, *args):
        # stdlib per-request lines route to the structured logger at DEBUG;
        # the INFO request line (method path -> status) is in _dispatch
        _LOG.debug(fmt, *args)

    def _auth_token(self) -> proto.AuthToken:
        header = self.headers.get("Authorization", "").strip()
        if not header.startswith("Basic "):
            raise Invalid("Basic Authorization required")
        try:
            decoded = base64.b64decode(header[len("Basic "):]).decode()
            agent_id, _, secret = decoded.partition(":")
        except Exception:
            raise Invalid("Invalid Auth header")
        if not agent_id or not secret:
            raise Invalid("Invalid Auth header")
        return proto.AuthToken(id=agent_id, body=secret)

    def _caller(self) -> proto.Agent:
        return self.service.server.check_auth_token(self._auth_token())

    def _read_json(self):
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            raise Invalid("Expected a body")
        return json.loads(self.rfile.read(length))

    def _reply(self, status: int, body: bytes = b"", headers=()):
        self._status = status
        self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        if body:
            self.send_header("Content-Type", "application/json")
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json_option(self, value):
        if value is None:
            self._reply(404, headers=[("Resource-not-found", "true")])
        else:
            obj = value.to_obj() if hasattr(value, "to_obj") else value
            self._reply(200, json.dumps(obj).encode())

    def _empty_201(self):
        self._reply(201)

    def _dispatch(self, method: str):
        # request line + error mapping logged like the reference
        # (server-http/src/lib.rs:105-135)
        path, _, query = self.path.partition("?")
        self._status = None
        try:
            handled = self._route(method, path, query)
            if not handled:
                self._reply(404, b"route not found")
        except InvalidCredentials as e:
            _LOG.warning("unauthorized: %s", e)
            self._reply(401, str(e).encode())
        except PermissionDenied as e:
            _LOG.warning("forbidden: %s", e)
            self._reply(403, str(e).encode())
        except Invalid as e:
            _LOG.warning("invalid request: %s", e)
            self._reply(400, str(e).encode())
        except Exception as e:  # noqa: BLE001 — 500 boundary
            _LOG.error("error in server: %s", e)
            self._reply(500, f"error in server: {e}".encode())
        _LOG.info("%s %s -> %s", method, path, self._status)

    # ----------------------------------------------------------- routes

    def _route(self, method: str, path: str, query: str) -> bool:
        svc = self.service

        def m(pattern):
            return re.fullmatch(pattern, path)

        if method == "GET" and path == "/v1/ping":
            self._send_json_option(svc.ping())
            return True

        if method == "POST" and path == "/v1/agents/me":
            # TOFU: record the presented token at agent creation
            auth = self._auth_token()
            agent = proto.Agent.from_obj(self._read_json())
            if agent.id != auth.id:
                self._reply(400, b"inconsistent agent ids")
                return True
            svc.create_agent(agent, agent)
            svc.server.upsert_auth_token(auth)
            self._empty_201()
            return True

        if method == "GET" and (match := m(rf"/v1/agents/({_UUID})")):
            self._send_json_option(svc.get_agent(self._caller(), match.group(1)))
            return True

        if method == "GET" and (match := m(rf"/v1/agents/({_UUID})/profile")):
            self._send_json_option(svc.get_profile(self._caller(), match.group(1)))
            return True

        if method == "POST" and path == "/v1/agents/me/profile":
            svc.upsert_profile(self._caller(), proto.Profile.from_obj(self._read_json()))
            self._empty_201()
            return True

        if method == "GET" and (match := m(rf"/v1/agents/any/keys/({_UUID})")):
            self._send_json_option(svc.get_encryption_key(self._caller(), match.group(1)))
            return True

        if method == "POST" and path == "/v1/agents/me/keys":
            svc.create_encryption_key(
                self._caller(), proto.signed_encryption_key_from_obj(self._read_json())
            )
            self._empty_201()
            return True

        if path == "/v1/aggregations" and method == "POST":
            svc.create_aggregation(self._caller(), proto.Aggregation.from_obj(self._read_json()))
            self._empty_201()
            return True

        if path == "/v1/aggregations" and method == "GET":
            params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
            title = unquote_plus(params["title"]) if "title" in params else None
            recipient = params.get("recipient")
            self._send_json_option(
                svc.list_aggregations(self._caller(), filter=title, recipient=recipient)
            )
            return True

        if match := m(rf"/v1/aggregations/({_UUID})"):
            if method == "GET":
                self._send_json_option(svc.get_aggregation(self._caller(), match.group(1)))
                return True
            if method == "DELETE":
                svc.delete_aggregation(self._caller(), match.group(1))
                self._reply(200)
                return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/committee/suggestions")):
            out = [c.to_obj() for c in svc.suggest_committee(self._caller(), match.group(1))]
            self._send_json_option(out)
            return True

        if method == "POST" and path == "/v1/aggregations/implied/committee":
            svc.create_committee(self._caller(), proto.Committee.from_obj(self._read_json()))
            self._empty_201()
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/committee")):
            self._send_json_option(svc.get_committee(self._caller(), match.group(1)))
            return True

        if method == "POST" and path == "/v1/aggregations/participations":
            svc.create_participation(
                self._caller(), proto.Participation.from_obj(self._read_json())
            )
            self._empty_201()
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/status")):
            self._send_json_option(svc.get_aggregation_status(self._caller(), match.group(1)))
            return True

        if method == "POST" and path == "/v1/aggregations/implied/snapshot":
            svc.create_snapshot(self._caller(), proto.Snapshot.from_obj(self._read_json()))
            self._empty_201()
            return True

        if method == "GET" and path == "/v1/aggregations/any/jobs":
            caller = self._caller()
            self._send_json_option(svc.get_clerking_job(caller, caller.id))
            return True

        if method == "POST" and (match := m(rf"/v1/aggregations/implied/jobs/({_UUID})/result")):
            svc.create_clerking_result(
                self._caller(), proto.ClerkingResult.from_obj(self._read_json())
            )
            self._empty_201()
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/snapshots/({_UUID})/result")):
            self._send_json_option(
                svc.get_snapshot_result(self._caller(), match.group(1), match.group(2))
            )
            return True

        return False

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


class SdaHttpServer:
    """HTTP binding; ``listen()`` blocks, ``start()`` runs on a thread."""

    def __init__(self, service: SdaServerService, host: str = "127.0.0.1", port: int = 8888):
        handler = type("BoundHandler", (_Handler,), {"service": service})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def listen(self) -> None:
        self.httpd.serve_forever()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


@contextlib.contextmanager
def serve_background(service: SdaServerService, host: str = "127.0.0.1", port: int = 0):
    """Test fixture: serve on an ephemeral port, yield the base URL.

    Python equivalent of the upstream background rouille server with a
    stop flag (integration-tests/src/lib.rs:143-179).
    """
    server = SdaHttpServer(service, host, port)
    server.start()
    try:
        yield server.url
    finally:
        server.stop()
