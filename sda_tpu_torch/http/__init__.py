"""REST transport: server binding and client proxy.

Port of the reference package's ``http``. Route table, auth model and
status mapping mirror the upstream REST server and client (server-http
route docs, Basic auth, error mapping; client-http status handling), and
the wire format is the reference's byte for byte, so the port's clients
talk to the reference's server and the other way round.

``requests`` is imported only by the client proxy's methods, so this
package imports on a machine without it.
"""

from sda_tpu_torch.http.client import HttpSdaService
from sda_tpu_torch.http.server import SdaHttpServer, serve_background

__all__ = ["HttpSdaService", "SdaHttpServer", "serve_background"]
