"""Config-2 lane-batched serving decomposition: where the time above the
copy floor goes.

    python3 -m sda_tpu_torch.tools.measure_lane_batch_floor

Port of the reference's ``tools/measure_lane_batch_floor.py`` on the card.
A 512-job lane batch (1,002 dimensions, 100 participants each, one B1
launch) is timed on the device (CUDA events) as:

1. the real batched kernel (in-kernel randomness + fused reconstruction).
   The reference timed it at three kernel lane-block sizes (512, 1024,
   2048), the TPU's block width. The port's B1 launcher uses ``lanes`` only
   to check that it divides NBP: its grid is one 256-thread block per 128
   lanes whatever ``lanes`` is, so the three would be one launch, and it is
   timed once;
2. T2 (:func:`~sda_tpu_torch.ops.probes.probe_t2`): B1's grid and tile,
   every input byte read, the output filled: the copy floor of the same
   bytes;
3. the real kernel WITHOUT fused reconstruction;
4. the real kernel with the caller's randomness (no in-kernel randomness;
   more input bytes, its own bound); 4b. the combined-draw mode
   (``rand_participants=1``); 3, 4 and 4b are
   :func:`~sda_tpu_torch.ops.mxu8.fused_share_combine_mxu8`'s plan, built
   once, and its launch (``run_mxu8``), so no timed call re-plans;
5. the same bytes at 4x the participants (128 jobs x 400).

Beside them, the same bytes through PyTorch's own kernels. The real and the
4x kernels' reveals are checked, and T2's sink XOR against the input's.
Writes ``build/measurements/LANE_BATCH_FLOOR.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from sda_tpu_torch.models import FederatedAggregation
from sda_tpu_torch.ops.mxu8 import mxu8_plan, run_mxu8
from sda_tpu_torch.ops.probes import library_probe, probe_bytes, probe_t2
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

__all__ = ["measure", "main", "SAMPLES", "ITERS"]

# timing windows, and calls per window
SAMPLES, ITERS = 5, 3


def measure(dimension: int = 1002, participants: int = 100, jobs: int = 512,
            device=None) -> dict:
    device = resolve_device(device)
    engine = FederatedAggregation.packed_64bit(dimension=dimension, device=device).engine
    mxu8, spec = engine.mxu8, engine.spec
    k, r, L8, L = spec.secret_count, spec.randomness_count, mxu8.L8, engine.ctx.L
    job_lanes = -(-engine.nb // 128) * 128
    nbp = jobs * job_lanes
    rows = participants * k * L8
    sec8 = make_planar_secrets(engine, 5, rows, nbp)
    out_rows_rec = L * k

    def plan_of(p_count, rows_, **kw):
        return mxu8_plan(mxu8, spec.share_matrix, rows_, p_count, k, r, device=device, **kw)

    def sol(t, plan, nbp_):
        """The launch's bound and the fraction of it the time reaches."""
        bound_ms, by = bound([mxu8_cost(plan, nbp_)])
        frac = None if t is None else bound_ms / t.median_ms
        return {"bound_s": bound_ms / 1e3, "bound_by": by, "fraction_of_sol": frac}

    results = {}
    share_plan = engine._plan("share", rows, participants, device)

    # 1. the real kernel
    lanes = 1024 if nbp % 1024 == 0 else job_lanes
    out = engine.aggregate_mxu8_kernel(sec8, 0, p_count=participants, lanes=lanes)
    reveal_check_slice(engine, sec8, out, participants, what="lane batch job 0")
    t_real = timed(lambda i: engine.aggregate_mxu8_kernel(sec8, i, p_count=participants,
                                                          lanes=lanes),
                   device, SAMPLES, ITERS)
    results[f"real_lanes{lanes}"] = {"s": seconds(t_real), **sol(t_real, share_plan, nbp),
                                     "grid_blocks": nbp // 128}
    real = seconds(t_real)

    # 2. T2: the copy floor of the same bytes through the same grid
    first = probe_t2(sec8, out_rows_rec, 7)
    check_sink(first, sec8)
    noop_bytes = probe_bytes(sec8, *first)
    t_noop = timed(lambda i: probe_t2(sec8, out_rows_rec, i), device, SAMPLES, ITERS)
    results["noop_same_shape"] = {
        "s": seconds(t_noop), "bytes": noop_bytes, "bound_s": noop_bytes / PEAK_BYTES,
        "fraction_of_sol": None if t_noop is None
        else noop_bytes / PEAK_BYTES / median_s(t_noop),
    }
    out_buf = torch.empty((out_rows_rec, nbp), dtype=torch.int32, device=device)
    t_lib = timed(lambda i: library_probe(sec8, out_buf, i), device, SAMPLES, ITERS)
    results["library_same_bytes"] = {"s": seconds(t_lib)}

    # 3. combine only (no fused reconstruction)
    comb_plan = plan_of(participants, rows)
    t_comb = timed(lambda i: run_mxu8(comb_plan, sec8, i, lanes=lanes), device, SAMPLES, ITERS)
    results["combine_only"] = {"s": seconds(t_comb), **sol(t_comb, comb_plan, nbp)}

    # 4. the caller's randomness (no in-kernel randomness)
    rows_ext = participants * (k + r) * L8
    sec8_ext = make_planar_secrets(engine, 6, rows_ext, nbp)
    ext_plan = plan_of(participants, rows_ext, reconstruct_matrix=spec.reconstruct_matrix)
    t_ext = timed(lambda i: run_mxu8(ext_plan, sec8_ext, 0, lanes=lanes), device,
                  SAMPLES, ITERS)
    results["host_randomness"] = {"s": seconds(t_ext), **sol(t_ext, ext_plan, nbp),
                                  "input_bytes": int(sec8_ext.numel())}
    del sec8_ext

    # 4b. combined-draw serving mode: one randomness draw per slot
    cd_plan = plan_of(participants, rows, reconstruct_matrix=spec.reconstruct_matrix,
                      rand_participants=1)
    t_cd = timed(lambda i: run_mxu8(cd_plan, sec8, i, lanes=lanes), device, SAMPLES, ITERS)
    results["combined_draw"] = {"s": seconds(t_cd), **sol(t_cd, cd_plan, nbp)}

    # 5. the same bytes at 4x the participants (jobs / 4 jobs)
    p_big, jobs_big = 4 * participants, max(1, jobs // 4)
    rows_big = p_big * k * L8
    nbp_big = jobs_big * job_lanes
    sec8_big = make_planar_secrets(engine, 7, rows_big, nbp_big)
    lanes_big = lanes if nbp_big % lanes == 0 else job_lanes
    out_big = engine.aggregate_mxu8_kernel(sec8_big, 0, p_count=p_big, lanes=lanes_big)
    reveal_check_slice(engine, sec8_big, out_big, p_big, what="4x-participant batch job 0")
    t_big = timed(lambda i: engine.aggregate_mxu8_kernel(sec8_big, i, p_count=p_big,
                                                         lanes=lanes_big),
                  device, SAMPLES, ITERS)
    big_plan = engine._plan("share", rows_big, p_big, device)
    results["same_bytes_4x_participants"] = {
        "s": seconds(t_big), **sol(t_big, big_plan, nbp_big),
        "participants": p_big, "jobs": jobs_big,
    }
    del sec8_big

    measured = real is not None
    blocks = nbp // 128
    decomposition = None
    if measured:
        dt_real, d_noop = real["median"], median_s(t_noop)
        dt_ext = median_s(t_ext)
        decomposition = {
            "dma_floor_s": d_noop,
            "compute_above_dma_s": dt_real - d_noop,
            "fused_stage2_epilogue_s": dt_real - median_s(t_comb),
            # the caller's randomness has more input bytes: compare the time
            # above each one's copy floor, scaled by input bytes
            "prng_plus_randsum_s": (dt_real - d_noop) - (dt_ext - d_noop * rows_ext / rows),
            "per_block_us": {"real": dt_real / blocks * 1e6, "dma": d_noop / blocks * 1e6},
            "copy_floor_tb_s": noop_bytes / d_noop / 1e12,
            "library_tb_s": noop_bytes / median_s(t_lib) / 1e12,
        }
    return {
        "metric": "config-2 512-job lane-batch decomposition (CUDA-event medians)",
        **card_fields(device),
        "shape": {"dimension": dimension, "participants": participants, "jobs": jobs,
                  "nbp": nbp, "input_bytes": int(sec8.numel()),
                  "kernel_lanes": lanes, "grid_blocks": blocks},
        "experiments": results,
        "decomposition": decomposition,
        "lanes_note": (
            "the port's B1 launcher uses lanes only to check that it divides NBP; the grid is "
            "one 256-thread block per 128 lanes for every lanes value, so the reference's "
            "real_lanes512/1024/2048 rows are one launch, timed once here"
        ),
        "finding": None if not measured else (
            f"T2 streams the {noop_bytes / 1e6:.1f} MB of the lane batch through B1's grid "
            f"at {noop_bytes / median_s(t_noop) / 1e12:.3f} TB/s; the real kernel takes "
            f"{real['median'] / median_s(t_noop):.2f}x its copy floor"
        ),
    }


def main() -> int:
    artifact = measure()
    path = write_artifact("LANE_BATCH_FLOOR", artifact)
    print(json.dumps(artifact, indent=2))
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
