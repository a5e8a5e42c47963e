"""Bulk device-pipeline example on the PyTorch port: aggregate many
participants' vectors.

The protocol-level flow (agents, sealed boxes, HTTP) is shown by
simple-cli-example-torch.sh; this example drives the compute core
directly, the path a serving deployment uses once participations are
decrypted: mask + share + combine + reconstruct for a whole batch of
participants in one step (torch CIOS limb arithmetic, no hand-written
kernel), then the reveal checked against the plain modular sum.

Runs on the card by default; ``--device cpu`` runs it on the CPU:

    python examples/bulk_aggregation_torch.py [--participants 32] [--dimension 4096]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# runnable as `python examples/bulk_aggregation_torch.py` from anywhere: the
# repository root (this file's parent directory) is the import root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--participants", type=int, default=32)
    ap.add_argument("--dimension", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sda_tpu_torch.models import FederatedAggregation

    # 64-bit pseudo-Mersenne production field, packed Shamir (3 secrets per
    # polynomial, committee of 8, tolerates 1 missing clerk)
    model = FederatedAggregation.packed_64bit(dimension=args.dimension, device=args.device)
    device = model.engine.device
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"field: p = {model.scheme_modulus} "
          f"({model.scheme_modulus.bit_length()}-bit)", file=sys.stderr)

    secrets, generator = model.example_inputs(participants=args.participants, seed=0)
    t0 = time.perf_counter()
    out = model.forward(secrets, generator)  # mask + share + combine + reconstruct
    revealed = model.reveal(out)  # copies to the host: the step has finished
    dt = time.perf_counter() - t0

    # ground truth: the plain modular sum of everyone's vectors (the same
    # draws example_inputs made)
    rng = np.random.default_rng(0)
    plain = rng.integers(
        0, min(model.scheme_modulus, 1 << 31),
        size=(args.participants, args.dimension),
    )
    want = plain.astype(object).sum(axis=0) % model.scheme_modulus
    ok = all(int(a) == int(b) for a, b in zip(revealed, want))
    print(f"aggregated {args.participants} x {args.dimension}-dim on {where} in "
          f"{dt*1e3:.1f} ms on the host clock (first call); reveal "
          f"{'matches' if ok else 'DOES NOT match'} the modular sum",
          file=sys.stderr)
    print(" ".join(str(int(x)) for x in revealed[:8]), "...")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
