"""Config-2 single-job latency decomposition: launch floor vs kernel work.

    python3 -m sda_tpu_torch.tools.measure_latency_floor

Port of the reference's ``tools/measure_latency_floor.py`` on the card.
Config 2 (1,002 dimensions, 100 participants, packed Shamir at
p = 2^63 - 871) is a ~0.9 MB-input job. Timed on the device (CUDA events,
:func:`~sda_tpu_torch.utils.profiling.cuda_time_samples`):

1. the real kernel (B1: share + combine + reconstruct, one launch);
2. T1 (:func:`~sda_tpu_torch.ops.probes.probe_t1`): B1's grid and tile,
   every input byte read, the output filled with the seed: the launch +
   copy floor at this shape;
3. T1': one block, a 1 KB input, a 4 KB output: the bare launch floor;
4. the real kernel on 64 lane-concatenated jobs (the serving answer).

Beside them, the same bytes through PyTorch's own kernels (a sum of the
input's words and a fill of the output). Every reveal is checked; T1's sink
XOR is checked against the input's. Writes
``build/measurements/LATENCY_FLOOR.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from sda_tpu_torch.models import FederatedAggregation
from sda_tpu_torch.ops.probes import library_probe, probe_bytes, probe_t1, probe_t1_bare
from sda_tpu_torch.tools._common import (
    bound,
    card_fields,
    check_sink,
    make_planar_secrets,
    median_s,
    mxu8_cost,
    reveal_check_slice,
    seconds,
    timed,
    write_artifact,
)
from sda_tpu_torch.utils.device import resolve_device
from sda_tpu_torch.utils.profiling import PEAK_BYTES

__all__ = ["measure", "main", "SAMPLES", "ITERS", "BATCH_ITERS"]

# timing windows, and calls per window (the 64-job launch: BATCH_ITERS)
SAMPLES, ITERS, BATCH_ITERS = 5, 6, 2


def measure(dimension: int = 1002, participants: int = 100, jobs: int = 64,
            device=None) -> dict:
    device = resolve_device(device)
    engine = FederatedAggregation.packed_64bit(dimension=dimension, device=device).engine
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    lanes = -(-engine.nb // 128) * 128
    rows = participants * k * L8
    sec8 = make_planar_secrets(engine, 1, rows, lanes)
    out_rows = L * k

    # 1. the real single-launch job
    out = engine.aggregate_mxu8_kernel(sec8, 0, p_count=participants, lanes=lanes)
    reveal_check_slice(engine, sec8, out, participants, width=lanes, what="config-2 job")
    t_real = timed(lambda i: engine.aggregate_mxu8_kernel(sec8, i, p_count=participants,
                                                          lanes=lanes),
                   device, SAMPLES, ITERS)
    plan = engine._plan("share", rows, participants, device)
    bound_ms, bound_by = bound([mxu8_cost(plan, lanes)])

    # 2. T1: the same grid, tile and output, every input byte read
    first = probe_t1(sec8, out_rows, 7)
    check_sink(first, sec8)
    noop_bytes = probe_bytes(sec8, *first)
    t_noop = timed(lambda i: probe_t1(sec8, out_rows, i), device, SAMPLES, ITERS)
    out_buf = torch.empty((out_rows, lanes), dtype=torch.int32, device=device)
    t_lib = timed(lambda i: library_probe(sec8, out_buf, i), device, SAMPLES, ITERS)

    # 3. T1': the bare launch floor
    tiny = torch.zeros((8, 128), dtype=torch.int8, device=device)
    check_sink(probe_t1_bare(tiny, 8 * 128, 7), tiny)
    t_bare = timed(lambda i: probe_t1_bare(tiny, 8 * 128, i), device, SAMPLES, ITERS)

    # 4. serving: `jobs` jobs lane-concatenated into one launch
    nbp_b = jobs * lanes
    sec8b = make_planar_secrets(engine, 2, rows, nbp_b)
    lanes_b = 1024 if nbp_b % 1024 == 0 else lanes
    outb = engine.aggregate_mxu8_kernel(sec8b, 0, p_count=participants, lanes=lanes_b)
    reveal_check_slice(engine, sec8b, outb, participants, what=f"{jobs}-job batch")
    t_b = timed(lambda i: engine.aggregate_mxu8_kernel(sec8b, i, p_count=participants,
                                                       lanes=lanes_b),
                device, SAMPLES, BATCH_ITERS)

    real_s, noop_s = median_s(t_real), median_s(t_noop)
    bare_s, b_s = median_s(t_bare), median_s(t_b)
    measured = real_s is not None
    return {
        "metric": "config-2 single-launch latency decomposition (CUDA events)",
        **card_fields(device),
        "shape": {"dimension": dimension, "participants": participants,
                  "lanes": lanes, "input_bytes": int(sec8.numel()),
                  "grid_blocks": lanes // 128},
        "single_job_s": real_s,
        "single_job": seconds(t_real),
        "noop_same_shape_s": noop_s,
        "noop_same_shape": seconds(t_noop),
        "noop_bytes": noop_bytes,
        "noop_bound_s": noop_bytes / PEAK_BYTES,
        "library_same_bytes_s": median_s(t_lib),
        "bare_launch_s": bare_s,
        "bare_launch": seconds(t_bare),
        "kernel_work_s": real_s - noop_s if measured else None,
        "speed_of_light_s": bound_ms / 1e3,
        "speed_of_light_by": bound_by,
        "fraction_of_sol": bound_ms / 1e3 / real_s if measured else None,
        "launch_floor_fraction_of_job": noop_s / real_s if measured else None,
        "batched64_per_job_s": b_s / jobs if measured else None,
        "batched64_speedup_per_job": real_s / (b_s / jobs) if measured else None,
        "batched_jobs": jobs,
        "note": (
            "noop_same_shape_s is T1 (csrc/probes.cu): B1's grid (one 256-thread block per "
            "128 lanes) reading every input byte through the tile B1 stages and filling the "
            "output with the seed: the launch + copy floor at this shape. bare_launch_s is "
            "T1': one block, 1 KB in, 4 KB out. library_same_bytes_s reads the same input "
            "once with torch's sum and fills the output with torch's fill_. kernel_work_s "
            "is what the kernel adds above its floor."
        ),
    }


def main() -> int:
    artifact = measure()
    path = write_artifact("LATENCY_FLOOR", artifact)
    print(json.dumps(artifact, indent=2))
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
