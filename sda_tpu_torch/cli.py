"""`sda` — the agent command-line interface.

Port of the reference package's ``cli``. Mirrors the upstream CLI command
tree (cli/src/main.rs:29-81):
ping, agent create/show, agent keys create/show, clerk [--once], aggregations
create/begin/end/reveal, participate. Identity layout matches too: the agent
lives under an alias in the identity store, keys under ``<identity>/keys``
(main.rs:113-128).

Improvements over the upstream CLI: ``--sharing shamir`` is implemented (it
was left ``unimplemented!()``, main.rs:226) — packed-Shamir
parameters are derived automatically for the given modulus; and the ChaCha
mask dimension is the vector dimension (upstream passed share_count,
main.rs:236-242, which only worked when they coincided).

The recipient's mask combine (full and ChaCha masking) runs where the
port's :class:`~sda_tpu_torch.client.SdaClient` runs it by default: on the
card, raising without one. Unmasked aggregations need no card.

Run as ``python -m sda_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import sys
import time

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.client import Filebased, Keystore, SdaClient, new_agent
from sda_tpu_torch.http.client import HttpSdaService
from sda_tpu_torch.utils.errors import SdaError

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sda", description="SDA agent CLI")
    p.add_argument("-s", "--server", default="http://localhost:8888", help="Server root")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument(
        "-i", "--identity", default=".sda",
        help="Storage directory for identity, including keys (defaults to .sda)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("ping", help="check service availability")

    agent = sub.add_parser("agent", help="identity management")
    agent_sub = agent.add_subparsers(dest="agent_cmd", required=True)
    create = agent_sub.add_parser("create")
    create.add_argument("-f", "--force", action="store_true", help="Overwrite any existing identity")
    agent_sub.add_parser("show")
    keys = agent_sub.add_parser("keys")
    keys_sub = keys.add_subparsers(dest="keys_cmd", required=True)
    keys_sub.add_parser("create")
    keys_sub.add_parser("show")

    clerk = sub.add_parser("clerk", help="run a clerk in a loop")
    clerk.add_argument("-o", "--once", action="store_true", help="Run just once and leave")
    clerk.add_argument("--poll-seconds", type=int, default=300)

    aggs = sub.add_parser("aggregations", aliases=["agg", "aggs", "aggregation"],
                          help="manage aggregations")
    aggs_sub = aggs.add_subparsers(dest="aggs_cmd", required=True)
    c = aggs_sub.add_parser("create")
    c.add_argument("title")
    c.add_argument("dimension", type=int)
    c.add_argument("modulus", type=int)
    c.add_argument("key", help="key id to use for recipient encryption")
    c.add_argument("share_count", type=int)
    c.add_argument("--id", dest="agg_id")
    c.add_argument("--mask", choices=["none", "full", "chacha"], default="none")
    c.add_argument("--sharing", choices=["add", "shamir"], default="add")
    c.add_argument("--secret-count", type=int, default=3, help="packed secrets per polynomial (shamir)")
    c.add_argument("--privacy-threshold", type=int, default=None, help="max colluding clerks (shamir)")
    b = aggs_sub.add_parser("begin", help="autoselect a committee for the aggregation")
    b.add_argument("id")
    e = aggs_sub.add_parser("end", help="create an aggregation snapshot and clerking jobs")
    e.add_argument("aggregation_id")
    r = aggs_sub.add_parser("reveal", help="reveal an aggregation result")
    r.add_argument("aggregation_id")

    part = sub.add_parser("participate", help="contribute a participation vector")
    part.add_argument("id", help="aggregation id")
    part.add_argument("values", nargs="+", type=int)
    return p


def _shamir_scheme(modulus: int, share_count: int, secret_count: int, privacy_threshold):
    """Derive packed-Shamir parameters for a user-supplied prime modulus."""
    from sda_tpu_torch.fields import PrimeField, _is_probable_prime

    if privacy_threshold is None:
        privacy_threshold = max(1, (share_count - 1) // 2 - secret_count + 1)
    m = secret_count + privacy_threshold + 1
    n1 = share_count + 1
    if not _is_probable_prime(modulus):
        raise SdaError(f"--sharing shamir requires a prime modulus, got {modulus}")
    if (modulus - 1) % m or (modulus - 1) % n1:
        raise SdaError(
            f"modulus {modulus} cannot host the transforms: need "
            f"{m} | p-1 and {n1} | p-1 (try `python -m sda_tpu_torch.params` to find one)"
        )
    f = PrimeField(modulus)
    return proto.PackedShamirSharing(
        secret_count=secret_count,
        share_count=share_count,
        privacy_threshold=privacy_threshold,
        prime_modulus=modulus,
        omega_secrets=int(f.find_element_of_order(m)),
        omega_shares=int(f.find_element_of_order(n1)),
    )


def run(args) -> int:
    import os

    identity = Filebased(args.identity)
    keystore = Keystore(Filebased(os.path.join(args.identity, "keys")))
    service = HttpSdaService(args.server, identity)

    agent_obj = identity.get_aliased("agent")
    agent = proto.Agent.from_obj(agent_obj) if agent_obj else None

    def client() -> SdaClient:
        if agent is None:
            raise SdaError('Agent is needed. Maybe run "sda agent create" ?')
        return SdaClient(agent, keystore, service)

    if args.cmd == "ping":
        pong = service.ping()
        if not pong.running:
            raise SdaError("Service may not be running")
        print("Service appears to be running", file=sys.stderr)
        return 0

    if args.cmd == "agent":
        if args.agent_cmd == "create":
            nonlocal_agent = agent
            if nonlocal_agent is not None and not args.force:
                print("Using existing agent; use --force to create new", file=sys.stderr)
            else:
                nonlocal_agent = new_agent(keystore)
                identity.put("agent_record", nonlocal_agent.to_obj())
                identity.put_alias("agent", "agent_record")
                print(f"Created new agent with id {nonlocal_agent.id}", file=sys.stderr)
            SdaClient(nonlocal_agent, keystore, service).upload_agent()
            return 0
        if args.agent_cmd == "show":
            if agent is None:
                print("No local agent found", file=sys.stderr)
            else:
                print(f"Local agent is {agent.id}")
            return 0
        if args.agent_cmd == "keys":
            if args.keys_cmd == "create":
                cl = client()
                key = cl.new_encryption_key()
                cl.upload_encryption_key(key)
                print(f"Created and uploaded key: {key}")
                return 0
            if args.keys_cmd == "show":
                key_dir = getattr(keystore.store, "path", None)
                if key_dir and os.path.isdir(key_dir):
                    for name in sorted(os.listdir(key_dir)):
                        if name.startswith("ekey_") and name.endswith(".json"):
                            print(name[len("ekey_") : -len(".json")])
                return 0

    if args.cmd == "clerk":
        service.ping()
        cl = client()
        while True:
            cl.run_chores(-1)
            if args.once:
                return 0
            time.sleep(args.poll_seconds)  # 5-min poll loop (main.rs:198-205)

    if args.cmd in ("aggregations", "agg", "aggs", "aggregation"):
        service.ping()
        cl = client()
        if args.aggs_cmd == "create":
            if args.sharing == "add":
                sharing = proto.AdditiveSharing(share_count=args.share_count, modulus=args.modulus)
            else:
                sharing = _shamir_scheme(
                    args.modulus, args.share_count, args.secret_count, args.privacy_threshold
                )
            if args.mask == "none":
                masking = proto.NoMasking()
            elif args.mask == "full":
                masking = proto.FullMasking(modulus=args.modulus)
            else:
                masking = proto.ChaChaMasking(
                    modulus=args.modulus, dimension=args.dimension, seed_bitsize=128
                )
            agg = proto.Aggregation(
                id=args.agg_id or proto.new_id(),
                title=args.title,
                vector_dimension=args.dimension,
                modulus=args.modulus,
                recipient=cl.agent.id,
                recipient_key=args.key,
                masking_scheme=masking,
                committee_sharing_scheme=sharing,
            )
            cl.upload_aggregation(agg)
            print(f"aggregation created. id: {agg.id}")
            return 0
        if args.aggs_cmd == "begin":
            cl.begin_aggregation(args.id)
            return 0
        if args.aggs_cmd == "end":
            cl.end_aggregation(args.aggregation_id)
            return 0
        if args.aggs_cmd == "reveal":
            result = cl.reveal_aggregation(args.aggregation_id).positive()
            print("result:", " ".join(str(int(v)) for v in result.values))
            return 0

    if args.cmd == "participate":
        cl = client()
        cl.participate(args.values, args.id)
        return 0

    raise SdaError(f"Unknown command {args.cmd}")


def main(argv=None) -> int:
    import requests

    args = build_parser().parse_args(argv)
    from sda_tpu_torch.utils.logging import setup as _log_setup

    _log_setup(args.verbose)  # -v/-vv -> info/debug (cli/src/main.rs:83-88)
    try:
        return run(args)
    except SdaError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except requests.RequestException as e:
        print(f"error: cannot reach service at {args.server}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
