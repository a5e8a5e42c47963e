"""Per-launch roofline report for the headline configuration.

    python -m sda_tpu_torch.tools.bench_roofline [--dimension 1000002] [--participants 768]
        [--lanes 1024] [--breakdown]

Port of the reference repository's root ``bench_roofline.py`` on the card.
At ``FederatedAggregation.packed_64bit(dimension)`` with ``participants``
participants, two launches of the byte-limb kernel (B1), each timed on the
device (CUDA events, :func:`~sda_tpu_torch.utils.profiling.cuda_time`) and
held to the card's ceilings (:func:`~sda_tpu_torch.utils.profiling.roofline`
on :func:`~sda_tpu_torch.utils.profiling.detect_card`):

- **full pipeline**: ``engine.aggregate_mxu8_kernel``, share + combine +
  reconstruct in one launch;
- **combine-only**: ``engine.mxu8_kernel_combined``, the same launch
  without the reconstruction (the streaming path's first chunk).

Each report's bytes and int8 operations are ``tools._common.mxu8_cost``'s;
its 32-bit term is the Philox calls times the built instance's SASS
instructions per call (``tools._common.mxu8_bound``). ``--breakdown`` adds
the device milliseconds per kernel of the full pipeline
(:func:`~sda_tpu_torch.utils.profiling.device_breakdown`). Unlike the
reference, both outputs are checked against the modular sum of the
participants' secrets (the combine-only one through one reconstruction).

Prints ``# card: ...`` and one line per launch on stderr, the reference's
keys as one JSON line on stdout (``chip``: the card's name; each report's
``card``: the spec its ceilings come from), and writes
``build/measurements/ROOFLINE.json``. With ``device="cpu"`` (``measure``
only) the plain versions run the checks and nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sda_tpu_torch.models import FederatedAggregation
from sda_tpu_torch.tools._common import (
    card_fields,
    make_planar_secrets,
    mxu8_bound,
    mxu8_cost,
    mxu8_philox_calls,
    reveal_check_slice,
    write_artifact,
)
from sda_tpu_torch.utils.device import resolve_device
from sda_tpu_torch.utils.profiling import (
    card_line,
    cuda_time,
    detect_card,
    device_breakdown,
    max_sm_mhz,
    roofline,
)

__all__ = ["measure", "main", "ITERS", "WARMUP", "BREAKDOWN_ITERS", "TOP_KERNELS"]

# timed calls of each launch after WARMUP untimed ones; traced calls of the
# breakdown, and the kernels it prints
ITERS, WARMUP, BREAKDOWN_ITERS, TOP_KERNELS = 8, 2, 5, 12


def _report(step, plan, nbp: int, device, card, mhz) -> dict:
    """The launch's time and roofline on the card; on the CPU its bytes
    and int8 operations with nothing timed."""
    nbytes, ops = mxu8_cost(plan, nbp)
    if device.type != "cuda":
        return {"card": None, "seconds": None, "hbm_bytes": nbytes, "int8_ops": ops,
                "note": "CPU run: checks only, no time measured"}
    t = cuda_time(step, iters=ITERS, warmup=WARMUP)
    bound_ms, bound_by, parts, call_ops = mxu8_bound(plan, nbp, mhz, card=card)
    calls = mxu8_philox_calls(plan, nbp)
    rep = roofline(t.median_ms / 1e3, hbm_bytes=nbytes, int8_ops=ops,
                   int32_ops=calls * call_ops, sm_mhz=mhz, card=card)
    return {**rep, "min_s": t.min_ms / 1e3, "max_s": t.max_ms / 1e3, "n": len(t.samples_ms),
            "hbm_bytes": nbytes, "int8_ops": ops, "philox_calls": calls,
            "philox_sass_per_call": call_ops, "sm_mhz": mhz, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_parts_ms": parts}


def measure(dimension: int = 1_000_002, participants: int = 768, lanes: int = 1024,
            breakdown: bool = False, device=None) -> dict:
    """Both launches checked, and on the card timed and held to the bound;
    returns the artifact (the reference's keys first)."""
    device = resolve_device(device)
    engine = FederatedAggregation.packed_64bit(dimension=dimension, device=device).engine
    P = participants
    k, L8 = engine.spec.secret_count, engine.mxu8.L8
    nbp = -(-engine.nb // lanes) * lanes
    rows = P * k * L8
    sec8 = make_planar_secrets(engine, 7, rows, nbp)
    on_card = device.type == "cuda"
    card = detect_card() if on_card else None
    mhz = max_sm_mhz() if on_card else None

    def full(i):
        return engine.aggregate_mxu8_kernel(sec8, i, p_count=P, lanes=lanes)

    def combined(i):
        return engine.mxu8_kernel_combined(sec8, i, P, lanes)

    reveal_check_slice(engine, sec8, full(0), P, what="full pipeline")
    reveal_check_slice(engine, sec8, engine.reconstruct_planar8(combined(0), lanes), P,
                       what="combine-only")
    rep = _report(full, engine._plan("share", rows, P, device), nbp, device, card, mhz)
    rep_c = _report(combined, engine._plan("combine", rows, P, device), nbp, device, card, mhz)
    kernels = device_breakdown(full, iters=BREAKDOWN_ITERS) if breakdown and on_card else None
    return {
        "metric": "headline pipeline roofline",
        "chip": torch.cuda.get_device_name(device) if on_card else "cpu",
        "ms_per_step": rep["seconds"] * 1e3 if on_card else None,
        "full_pipeline": rep,
        "combine_only": rep_c,
        **({"breakdown_ms": kernels} if breakdown else {}),
        **card_fields(device),
        "shape": {"dimension": dimension, "participants": P, "lanes": lanes, "rows": rows,
                  "nbp": nbp, "input_bytes": int(sec8.numel())},
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench_roofline", description=__doc__.splitlines()[0])
    ap.add_argument("--dimension", type=int, default=1_000_002)
    ap.add_argument("--participants", type=int, default=768)
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--breakdown", action="store_true",
                    help="also print the device time per kernel of the full pipeline")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    art = measure(args.dimension, args.participants, args.lanes, args.breakdown)
    print(f"# card: {card_line()}", file=sys.stderr)
    for label, key in (("full pipeline", "full_pipeline"), ("combine-only", "combine_only")):
        rep = art[key]
        print(f"# {label}: {rep['seconds'] * 1e3:.4f} ms, bound {rep['bound_ms']:.4f} ms "
              f"({rep['bound_by']}), {rep['fraction_of_sol']:.4f} of it", file=sys.stderr)
    for name, ms in list((art.get("breakdown_ms") or {}).items())[:TOP_KERNELS]:
        print(f"# breakdown: {ms:8.4f} ms  {name}", file=sys.stderr)
    path = write_artifact("ROOFLINE", art)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps({key: art[key] for key in ("metric", "chip", "ms_per_step", "full_pipeline",
                                                "combine_only", "breakdown_ms") if key in art}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
