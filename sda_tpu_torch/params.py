"""Parameter helper: find NTT-friendly primes for packed-Shamir configs.

Port of the reference package's ``params``. The upstream project provides
no tooling for choosing PackedShamir parameters (its CLI aborts with
``unimplemented!()``, cli/src/main.rs:226). This utility searches primes ``p`` with ``2^a | p-1`` and ``3^b | p-1`` so both transform
sizes exist, and reports the roots of unity.

Usage::

    python -m sda_tpu_torch.params --bits 62 --share-count 8 --secret-count 3 \
        --privacy-threshold 4
"""

from __future__ import annotations

import argparse
import json
import sys


def derive(bits: int, share_count: int, secret_count: int, privacy_threshold: int):
    from sda_tpu_torch.fields import find_prime_field

    m = secret_count + privacy_threshold + 1
    n1 = share_count + 1

    def smooth_cover(x: int, base: int) -> int:
        size = 1
        while size < x:
            size *= base
        return size

    order2 = smooth_cover(m, 2)
    order3 = smooth_cover(n1, 3)
    if order2 != m:
        raise SystemExit(
            f"secret_count + privacy_threshold + 1 = {m} must be a power of two "
            f"(nearest: use privacy_threshold={order2 - secret_count - 1})"
        )
    if order3 != n1:
        raise SystemExit(
            f"share_count + 1 = {n1} must be a power of three "
            f"(nearest: use share_count={order3 - 1})"
        )
    p, w2, w3 = find_prime_field(bits, order2, order3)
    return {
        "prime_modulus": p,
        "secret_count": secret_count,
        "share_count": share_count,
        "privacy_threshold": privacy_threshold,
        "omega_secrets": w2,
        "omega_shares": w3,
        "reconstruction_threshold": privacy_threshold + secret_count,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sda-params", description=__doc__)
    ap.add_argument("--bits", type=int, default=62, help="minimum modulus bits")
    ap.add_argument("--share-count", type=int, default=8)
    ap.add_argument("--secret-count", type=int, default=3)
    ap.add_argument("--privacy-threshold", type=int, default=4)
    args = ap.parse_args(argv)
    out = derive(args.bits, args.share_count, args.secret_count, args.privacy_threshold)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
