"""`sdad` — the coordination-server daemon CLI.

Port of the reference package's ``server_cli``. Mirrors the upstream
server-cli: store selection via ``--jfs <dir>`` (or
``--mongo <url>`` when pymongo is installed), ``httpd`` subcommand binding
``127.0.0.1:8888`` by default (bin/sdad.rs:33-37).

Run as ``python -m sda_tpu_torch.server_cli --jfs <dir> httpd [-b host:port]``.
"""

from __future__ import annotations

import argparse
import sys

from sda_tpu_torch.http.server import SdaHttpServer
from sda_tpu_torch.server import new_jsondir_server

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdad", description="SDA coordination server")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--jfs", metavar="jfs_root", help="use a JSON-file store")
    p.add_argument("--mongo", metavar="mongo_url", help="use a mongodb store (requires pymongo)")
    p.add_argument("--mongo-dbname", default="sda")
    sub = p.add_subparsers(dest="cmd", required=True)
    httpd = sub.add_parser("httpd", help="Run a http server")
    httpd.add_argument("-b", "--bind", default="127.0.0.1:8888", help="defaults to 127.0.0.1:8888")
    return p


def build_backend_server(args):
    if args.mongo:
        try:
            from sda_tpu_torch.stores_mongo import new_mongo_server
        except ImportError as e:
            raise SystemExit(f"mongo store unavailable: {e}")
        return new_mongo_server(args.mongo, args.mongo_dbname)
    if args.jfs:
        return new_jsondir_server(args.jfs)
    raise SystemExit("need a store configuration (--jfs or --mongo)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from sda_tpu_torch.utils.logging import setup as _log_setup

    _log_setup(args.verbose)  # -v/-vv -> info/debug (server-cli/src/lib.rs:29-36)
    service = build_backend_server(args)
    if args.cmd == "httpd":
        host, _, port = args.bind.partition(":")
        server = SdaHttpServer(service, host or "127.0.0.1", int(port or 8888))
        print(f"Starting server on {server.url}", file=sys.stderr)
        try:
            server.listen()
        except KeyboardInterrupt:
            return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
