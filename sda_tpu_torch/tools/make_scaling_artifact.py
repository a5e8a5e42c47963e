"""Compose the config-5 scaling artifact: the measured split on one card
and a projection onto one NVLink node.

    python -m sda_tpu_torch.tools.make_scaling_artifact [out.json]

Port of the reference repository's ``tools/make_scaling_artifact.py``. It
runs :mod:`sda_tpu_torch.tools.bench_scaling` twice (:func:`measure`):

1. on one card, in a world of one, at full width: the config-5 streaming
   step's chunk loop and finish, 131 chunks x 768 participants x 1,000,002
   dimensions (``--dim-per-device 333334 --streaming-chunks 131``), the
   gen-4 kernels (B1, B3) on the card;
2. on 8 gloo ranks at the reference's tiny sizes, for correctness only: the
   collective structure (the modular all-reduce and the gather) runs end to
   end. CPU timings carry no scaling signal (the ranks share one host's
   cores, and gloo costs nothing like NVLink), so nothing is derived from
   them.

Then :func:`compose` projects BASELINE config 5 (100,000 participants x
1,000,002) onto ``CARDS`` cards (one H100 NVLink node) from the measured
numbers and one assumption, every projected number labelled so. Each card
streams its share of the participants in chunks of 768 at the measured
time a chunk; the finish is ONE ring all-reduce of the measured per-card
payload (the clerks' partial sums at full width on a pure participant
mesh), 2 (N - 1) / N x the payload over an effective per-card NVLink
bandwidth, plus the measured local finish. The measurement is at the full
dimension on the card the model is for, so it is not rescaled. The
bandwidth is the model's one load-bearing assumption, and the artifact
shows the projection across a 3x range of it, and the same model at
``ALSO_CARDS`` cards. Writes ``build/measurements/SCALING.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

__all__ = ["measure", "compose", "main", "REAL_ARGS", "VIRT_ARGS", "CARDS", "ALSO_CARDS",
           "NVLINK_GBPS", "NVLINK_SWEEP_GBPS", "PARTICIPANTS", "DIMENSION", "P_CHUNK"]

ROOT = Path(__file__).resolve().parents[2]
# config 5's split at full width on one card, and the reference's 8-rank check
REAL_ARGS = ["--devices", "1", "--dim-per-device", "333334", "--participants-per-device",
             "768", "--streaming-chunks", "131"]
VIRT_ARGS = ["--devices", "8", "--cpu-mesh", "--dim-per-device", "2048",
             "--participants-per-device", "8", "--streaming-chunks", "3"]
# BASELINE config 5 (100k participants x 1M dimensions) on one H100 node
PARTICIPANTS, DIMENSION, P_CHUNK = 100_000, 1_000_002, 768
CARDS, ALSO_CARDS = 8, 4
# effective per-card NVLink bandwidth of a ring all-reduce, GB/s: the
# assumption (the data sheet gives 450 GB/s each way per card), and the 3x
# range the projection is shown across
NVLINK_GBPS = 300.0
NVLINK_SWEEP_GBPS = (150.0, 300.0, 450.0)


def run_bench(args: list[str], timeout: int = 3000) -> dict:
    """``python -m sda_tpu_torch.tools.bench_scaling args``'s JSON line."""
    out = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.tools.bench_scaling", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )
    sys.stderr.write(out.stderr)
    if out.returncode != 0:
        raise RuntimeError(f"bench_scaling failed: {out.stderr[-500:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def measure() -> tuple[dict, dict]:
    """(the one-card run's JSON, the 8-rank gloo run's JSON)."""
    return run_bench(REAL_ARGS), run_bench(VIRT_ARGS)


def _project(chunk_s: float, payload_bytes: float, finish_local_s: float, cards: int,
             gbps: float) -> dict:
    chunks_per_card = -(-PARTICIPANTS // (cards * P_CHUNK))
    compute_s = chunks_per_card * chunk_s
    allreduce_s = 2 * (cards - 1) / cards * payload_bytes / (gbps * 1e9)
    total_s = compute_s + allreduce_s + finish_local_s
    return {"chunks_per_card": chunks_per_card, "compute_s": compute_s,
            "allreduce_s": allreduce_s, "total_s": total_s,
            "aggregations_per_s": PARTICIPANTS / total_s,
            "weak_scaling_efficiency": compute_s / total_s}


def _model(chunk_s: float, payload_bytes: float, finish_local_s: float, cards: int) -> dict:
    base = _project(chunk_s, payload_bytes, finish_local_s, cards, NVLINK_GBPS)
    return {
        "cards": cards,
        **base,
        "finish_s": base["allreduce_s"] + finish_local_s,
        "nvlink_bandwidth_sensitivity": {
            f"{int(g)}_GBps": {key: _project(chunk_s, payload_bytes, finish_local_s, cards, g)[key]
                               for key in ("allreduce_s", "total_s", "weak_scaling_efficiency")}
            for g in NVLINK_SWEEP_GBPS
        },
    }


def compose(real: dict, virt: dict | None) -> dict:
    """The artifact from the one-card run ``real`` (its ``streaming_sharded``
    row, and where it ran) and the gloo run ``virt`` (``None``: not run)."""
    s = real["streaming_sharded"]
    chunk_s = s["chunk_loop_ms"] / 1e3 / s["chunks"]
    payload_bytes = s["allreduce_payload_mb"] * 1e6
    finish_local_s = s["finish_ms"] / 1e3
    virt_summary = None
    if virt is not None:
        virt_summary = {
            "purpose": "correctness-only: the collective structure runs on 8 gloo ranks; "
                       "CPU-mesh timings carry no scaling signal (one shared host CPU)",
            "devices_validated": sorted(int(k) for k in virt["results"]),
            "streaming_sharded_ran": bool(virt.get("streaming_sharded")),
        }
    return {
        "metric": f"config-5 scaling: measured split on one card + projected {CARDS}-card "
                  f"NVLink node",
        "real_card": real,
        "virtual_8rank_mesh": virt_summary,
        "projected": {
            "note": "projected, not measured: the measured chunk time and finish on one card, "
                    "and an assumed effective per-card NVLink bandwidth",
            "assumptions": {
                "nvlink_effective_gbps_per_card": NVLINK_GBPS,
                "participants": PARTICIPANTS,
                "dimension": DIMENSION,
                "p_chunk": P_CHUNK,
            },
            "measured_chunk_s": chunk_s,
            "allreduce_payload_mb_per_card": payload_bytes / 1e6,
            "finish_local_s": finish_local_s,
            **_model(chunk_s, payload_bytes, finish_local_s, CARDS),
            f"at_{ALSO_CARDS}_cards": _model(chunk_s, payload_bytes, finish_local_s, ALSO_CARDS),
        },
    }


def main(argv=None) -> int:
    from sda_tpu_torch.tools._common import MEASUREMENTS_DIR

    argv = sys.argv[1:] if argv is None else argv
    out_path = Path(argv[0]) if argv else MEASUREMENTS_DIR / "SCALING.json"
    artifact = compose(*measure())
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(artifact, indent=2))
    proj = artifact["projected"]
    print(f"wrote {out_path}; projected {CARDS}-card efficiency "
          f"{proj['weak_scaling_efficiency']:.1%} ({proj['aggregations_per_s']:.0f} "
          f"aggregations/s, projected)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
