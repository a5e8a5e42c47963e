"""The port's command-line tools against sda_tpu's.

- ``sda_tpu_torch.cli`` (``sda``) through the README walkthrough against
  the port's ``serve_background(new_jsondir_server(...))``: golden reveal
  ``0 2 2 4 4 6 6 8 8 10``; the packed-Shamir and agent-error cases of
  ``tests/test_cli.py``;
- ``sda_tpu_torch.params.derive`` equal to the reference's, and its
  refusals;
- ``sda_tpu_torch.server_cli.build_backend_server`` for a JSON directory,
  a Mongo URL (on ``tests/fake_pymongo.py``) and neither.
"""

import json
import sys

import pytest

from sda_tpu import params as ref_params
from sda_tpu_torch import cli, params, server_cli
from sda_tpu_torch.http.server import serve_background
from sda_tpu_torch.server import SdaServerService, new_jsondir_server


@pytest.fixture
def http_url(tmp_path):
    with serve_background(new_jsondir_server(str(tmp_path / "server"))) as url:
        yield url


def sda(url, tmp_path, ident, *args):
    rc = cli.main(["-s", url, "-i", str(tmp_path / "agent" / ident), *map(str, args)])
    assert rc == 0, f"sda {args} failed"


def test_readme_walkthrough(http_url, tmp_path, capsys):
    url = http_url
    for i in ["recipient", "clerk-1", "clerk-2", "clerk-3"]:
        sda(url, tmp_path, i, "agent", "create")
        sda(url, tmp_path, i, "agent", "keys", "create")
    for i in ["part-1", "part-2", "part-3"]:
        sda(url, tmp_path, i, "agent", "create")

    sda(url, tmp_path, "recipient", "agent", "keys", "show")
    key_id = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(key_id) == 36

    aggid = "ad3142d8-9a83-4f40-a64a-a8c90b701bde"
    sda(url, tmp_path, "recipient", "aggregations", "create", "--id", aggid,
        "aggro", 10, 433, key_id, 3)
    sda(url, tmp_path, "recipient", "aggregations", "begin", aggid)

    sda(url, tmp_path, "part-1", "participate", aggid, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
    sda(url, tmp_path, "part-2", "participate", aggid, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    sda(url, tmp_path, "part-3", "participate", aggid, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1)

    sda(url, tmp_path, "recipient", "aggregations", "end", aggid)
    for i in ["recipient", "clerk-1", "clerk-2", "clerk-3"]:
        sda(url, tmp_path, i, "clerk", "--once")

    capsys.readouterr()
    sda(url, tmp_path, "recipient", "aggregations", "reveal", aggid)
    assert "result: 0 2 2 4 4 6 6 8 8 10" in capsys.readouterr().out  # README golden


def test_cli_shamir_sharing(http_url, tmp_path, capsys):
    url = http_url
    for i in ["recipient"] + [f"c{j}" for j in range(8)]:
        sda(url, tmp_path, i, "agent", "create")
        sda(url, tmp_path, i, "agent", "keys", "create")
    sda(url, tmp_path, "p1", "agent", "create")

    sda(url, tmp_path, "recipient", "agent", "keys", "show")
    key_id = capsys.readouterr().out.strip().splitlines()[-1]
    capsys.readouterr()
    sda(url, tmp_path, "recipient", "aggregations", "create", "sham", 4, 433, key_id, 8,
        "--sharing", "shamir", "--secret-count", 3, "--privacy-threshold", 4)
    aggid = capsys.readouterr().out.strip().split()[-1]

    sda(url, tmp_path, "recipient", "aggregations", "begin", aggid)
    sda(url, tmp_path, "p1", "participate", aggid, 10, 20, 30, 40)
    sda(url, tmp_path, "recipient", "aggregations", "end", aggid)
    for i in ["recipient"] + [f"c{j}" for j in range(8)]:
        sda(url, tmp_path, i, "clerk", "--once")
    capsys.readouterr()
    sda(url, tmp_path, "recipient", "aggregations", "reveal", aggid)
    assert "result: 10 20 30 40" in capsys.readouterr().out


def test_cli_agent_errors(http_url, tmp_path, capsys):
    url = http_url
    # participate without an agent -> helpful error, exit 1
    rc = cli.main(["-s", url, "-i", str(tmp_path / "agent" / "nobody"),
                   "participate", "some-agg", "1", "2"])
    assert rc == 1
    assert "sda agent create" in capsys.readouterr().err
    # agent create twice without --force keeps the identity
    sda(url, tmp_path, "alice", "agent", "create")
    ident = (tmp_path / "agent" / "alice" / "agent_record.json").read_text()
    sda(url, tmp_path, "alice", "agent", "create")
    assert (tmp_path / "agent" / "alice" / "agent_record.json").read_text() == ident


def test_cli_shamir_rejects_a_modulus_without_the_roots():
    """p = 433 hosts 8 | p-1 and 9 | p-1; 431 is prime but hosts neither."""
    with pytest.raises(cli.SdaError, match="cannot host the transforms"):
        cli._shamir_scheme(431, 8, 3, 4)
    with pytest.raises(cli.SdaError, match="prime modulus"):
        cli._shamir_scheme(435, 8, 3, 4)


def test_cli_reports_an_unreachable_server(tmp_path, capsys):
    rc = cli.main(["-s", "http://127.0.0.1:9", "-i", str(tmp_path / "a"), "ping"])
    assert rc == 1 and "cannot reach service" in capsys.readouterr().err


# ------------------------------------------------------------------ params


@pytest.mark.parametrize("bits,share_count,secret_count,privacy_threshold",
                         [(62, 8, 3, 4), (20, 8, 3, 4), (40, 26, 3, 12), (70, 8, 1, 6)])
def test_params_derive_matches_reference(bits, share_count, secret_count, privacy_threshold):
    got = params.derive(bits, share_count, secret_count, privacy_threshold)
    assert got == ref_params.derive(bits, share_count, secret_count, privacy_threshold)
    assert got["prime_modulus"].bit_length() >= bits


@pytest.mark.parametrize("args", [(62, 8, 3, 3), (62, 9, 3, 4)])
def test_params_refusals_match_reference(args):
    with pytest.raises(SystemExit) as got:
        params.derive(*args)
    with pytest.raises(SystemExit) as want:
        ref_params.derive(*args)
    assert str(got.value) == str(want.value)


def test_params_main_prints_the_derivation(capsys):
    assert params.main(["--bits", "20"]) == 0
    assert json.loads(capsys.readouterr().out) == ref_params.derive(20, 8, 3, 4)


# -------------------------------------------------------------- server_cli


def _backend(argv):
    return server_cli.build_backend_server(server_cli.build_parser().parse_args(argv))


def test_server_cli_jsondir_backend(tmp_path):
    service = _backend(["--jfs", str(tmp_path), "httpd"])
    assert isinstance(service, SdaServerService) and service.ping().running


def test_server_cli_mongo_backend(monkeypatch):
    """On ``tests/fake_pymongo.py``, so the test needs no mongod."""
    from tests import fake_pymongo

    monkeypatch.setitem(sys.modules, "pymongo", fake_pymongo)
    from sda_tpu_torch.stores_mongo import _MongoKV

    url, db = "mongodb://localhost:27017", "sda-torch-cli-test"
    service = _backend(["--mongo", url, "--mongo-dbname", db, "httpd"])
    try:
        assert isinstance(service.server.stores._kv, _MongoKV) and service.ping().running
    finally:
        fake_pymongo.MongoClient(url).drop_database(db)


def test_server_cli_needs_a_store():
    with pytest.raises(SystemExit, match="need a store"):
        _backend(["httpd"])
