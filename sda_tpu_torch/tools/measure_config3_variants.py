"""Config-3 (128-bit) launch-shape sweep of the chunked kernel, and its
controls at the best shape.

    python3 -m sda_tpu_torch.tools.measure_config3_variants

Port of the reference's ``tools/measure_config3_variants.py`` on the card.
Config 3 is 1,024 participants x 10,002 dimensions at p = 2^127 - 1495,
run as ``n_chunks`` stacked chunks in ONE launch (B2; B1 when
``n_chunks`` is 1). The reference swept ``(n_chunks, lanes)`` because
``lanes`` was the TPU's block width. The port's B2 launcher uses ``lanes``
only for NBP's padding (NBP = NB rounded up to a multiple of ``lanes``) and
the per-chunk seed stride (NBP // lanes): its grid is NBP / 128 lane blocks
times the split count S (:func:`~sda_tpu_torch.ops.mxu8.launch_splits`)
whatever ``lanes`` is. So the sweep is over what changes the launch,
``(n_chunks, NBP)``: the reference's variants plus every ``n_chunks`` at
the least padding (``lanes`` 128), one row per distinct launch, each with
its S and its grid (one chunk runs B1: S = 1). At the best row, the
controls are T3 (:func:`~sda_tpu_torch.ops.probes.probe_t3`: B2's split
grid at the row's S, every byte read, the output written once), the
combined-draw mode and the launch without fused reconstruction, and the
same bytes through PyTorch's own kernels. T3 is also timed at the best
row of more than one chunk, so it covers several chunks whichever row is
best. Every row's reveal is checked, and T3's sink XOR against the
input's. Writes
``build/measurements/CONFIG3_SWEEP.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from sda_tpu_torch.models import FederatedAggregation
from sda_tpu_torch.ops.mxu8 import launch_splits, mxu8_plan, run_mxu8
from sda_tpu_torch.ops.probes import library_probe, probe_bytes, probe_t3
from sda_tpu_torch.tools._common import (
    bound,
    card_fields,
    check_sink,
    make_planar_secrets,
    median_s,
    mxu8_cost,
    reveal_check_slice,
    timed,
    write_artifact,
)
from sda_tpu_torch.utils.device import resolve_device
from sda_tpu_torch.utils.profiling import PEAK_BYTES

__all__ = ["measure", "main", "REFERENCE_VARIANTS", "SAMPLES", "ITERS"]

# the reference's (n_chunks, lanes) variants
REFERENCE_VARIANTS = ((1, 384), (2, 384), (4, 384), (2, 256), (4, 256), (8, 256), (2, 512),
                      (4, 512))
# timing windows, and calls per window
SAMPLES, ITERS = 3, 3


def _ms(t, key):
    return None if t is None else getattr(t, key)


def _splits(plan, nbp: int, device) -> int:
    """The split count of the launch: B2's on the card; 1 for one chunk (B1
    does not split) and on the CPU (the plain version has no grid)."""
    if plan.n_chunks == 1 or device.type != "cuda":
        return 1
    return launch_splits(plan, nbp, device)


def measure(dimension: int = 10_002, total: int = 1024, variants=REFERENCE_VARIANTS,
            extra_chunks=(1, 2, 4, 8), device=None) -> dict:
    device = resolve_device(device)
    engine = FederatedAggregation.packed_128bit(dimension=dimension, device=device).engine
    mxu8, spec = engine.mxu8, engine.spec
    k, r, L8, L = spec.secret_count, spec.randomness_count, mxu8.L8, engine.ctx.L

    def stacked(n_chunks, rows, nbp):
        return torch.cat([make_planar_secrets(engine, 10 + i, rows, nbp) for i in range(n_chunks)])

    launches = {}
    for n_chunks, lanes in (*variants, *((n, 128) for n in extra_chunks)):
        nbp = -(-engine.nb // lanes) * lanes
        if total % n_chunks or (n_chunks, nbp) in launches:
            continue
        launches[(n_chunks, nbp)] = lanes

    rows_out = []
    for (n_chunks, nbp), lanes in launches.items():
        p_chunk = total // n_chunks
        rows = p_chunk * k * L8
        sec8_all = stacked(n_chunks, rows, nbp)
        out = engine.aggregate_mxu8_kernel_chunked(sec8_all, n_chunks, p_chunk, seed=1,
                                                   lanes=lanes)
        reveal_check_slice(engine, sec8_all, out, total, width=lanes,
                           what=f"config 3 n_chunks={n_chunks} lanes={lanes}")
        t = timed(lambda i: engine.aggregate_mxu8_kernel_chunked(
            sec8_all, n_chunks, p_chunk, seed=1 + i, lanes=lanes), device, SAMPLES, ITERS)
        plan = engine._plan("share", rows, p_chunk, device, n_chunks)
        bound_ms, by = bound([mxu8_cost(plan, nbp)])
        splits = _splits(plan, nbp, device)
        rows_out.append({
            "n_chunks": n_chunks, "lanes": lanes, "nbp": nbp, "splits": splits,
            "lane_blocks": nbp // 128, "grid_blocks": nbp // 128 * splits,
            "ms": _ms(t, "median_ms"), "ms_min": _ms(t, "min_ms"), "ms_max": _ms(t, "max_ms"),
            "bound_ms": bound_ms, "bound_by": by,
            "fraction_of_sol": None if t is None else bound_ms / t.median_ms,
            "aggs_s": None if t is None else total / (t.median_ms / 1e3),
        })
        del sec8_all

    measured = rows_out[0]["ms"] is not None

    def best_of(candidates):
        return max(candidates, key=lambda row: row["fraction_of_sol"]) if measured else candidates[0]

    best = best_of(rows_out)
    out_rows = L * k

    def t3_floor(row):
        """T3 at ``row``'s launch and split count: (its input, timing,
        bytes); sink checked."""
        n, nbp_, splits = row["n_chunks"], row["nbp"], row["splits"]
        sec8 = stacked(n, total // n * k * L8, nbp_)
        first = probe_t3(sec8, out_rows, n, 7, splits)
        check_sink(first, sec8)
        return sec8, timed(lambda i: probe_t3(sec8, out_rows, n, i, splits), device, SAMPLES,
                           ITERS), probe_bytes(sec8, *first)

    # T3 at the best launch of more than one chunk
    chunked_rows = [row for row in rows_out if row["n_chunks"] > 1]
    chunk_loop = None
    if chunked_rows:
        row = best_of(chunked_rows)
        _, t, nbytes = t3_floor(row)
        chunk_loop = {"n_chunks": row["n_chunks"], "nbp": row["nbp"], "splits": row["splits"],
                      "grid_blocks": row["grid_blocks"], "real_ms": row["ms"],
                      "noop_ms": _ms(t, "median_ms"), "noop_bytes": nbytes,
                      "noop_bound_ms": nbytes / PEAK_BYTES * 1e3,
                      "copy_floor_tb_s": None if t is None else nbytes / median_s(t) / 1e12}

    # controls at the best shape
    n_chunks, lanes, nbp = best["n_chunks"], best["lanes"], best["nbp"]
    p_chunk = total // n_chunks
    rows = p_chunk * k * L8
    sec8_all, t_noop, noop_bytes = t3_floor(best)
    out_buf = torch.empty((out_rows, nbp), dtype=torch.int32, device=device)
    t_lib = timed(lambda i: library_probe(sec8_all, out_buf, i), device, SAMPLES, ITERS)
    controls = {"noop_dma_floor_ms": _ms(t_noop, "median_ms"), "noop_bytes": noop_bytes,
                "noop_bound_ms": noop_bytes / PEAK_BYTES * 1e3,
                "library_same_bytes_ms": _ms(t_lib, "median_ms")}
    for name, kw in (("combined_draw", dict(reconstruct_matrix=spec.reconstruct_matrix,
                                            rand_participants=1)),
                     ("no_reconstruction", dict())):
        plan = mxu8_plan(mxu8, spec.share_matrix, rows, p_chunk, k, r, device=device,
                         n_chunks=n_chunks, **kw)
        t = timed(lambda i: run_mxu8(plan, sec8_all, i, lanes=lanes), device, SAMPLES, ITERS)
        controls[f"{name}_ms"] = _ms(t, "median_ms")
    if measured:
        controls["copy_floor_tb_s"] = noop_bytes / median_s(t_noop) / 1e12
        controls["library_tb_s"] = noop_bytes / median_s(t_lib) / 1e12
    return {
        "metric": "config-3 (128-bit, 10k-dim, 1024 participants) launch-shape sweep",
        **card_fields(device),
        "rows": rows_out,
        "best": best,
        "controls_at_best": controls,
        "noop_at_best_chunked": chunk_loop,
        "lanes_note": (
            "the port's B2 launcher uses lanes only for NBP's padding and the per-chunk seed "
            "stride (NBP // lanes); its grid is NBP / 128 lane blocks x the split count S, each "
            "block summing its range of (chunk, K tile) and of (chunk, draw), so the rows sweep "
            "(n_chunks, NBP), one per distinct launch"
        ),
    }


def main() -> int:
    artifact = measure()
    path = write_artifact("CONFIG3_SWEEP", artifact)
    print(json.dumps(artifact, indent=2))
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
