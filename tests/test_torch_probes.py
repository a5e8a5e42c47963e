"""The port's floor probes and measurement tools against sda_tpu's.

Each probe's plain version is held against the reference tool's no-op
Pallas kernel, rebuilt here with the tool's grid and block specs and run in
interpret mode (the tools define their kernels inside ``main()``), at small
shapes of the tools' layouts; the probe's sink against numpy's XOR of the
input. The port's tools run at tiny shapes on the CPU, so every reveal
check, sink check and artifact key is exercised; nothing is timed there.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sda_tpu_torch.ops import probes
from sda_tpu_torch.ops.mxu8 import split_ranges
from sda_tpu_torch.tools import _common
from sda_tpu_torch.tools import measure_combine_crossover as crossover
from sda_tpu_torch.tools import measure_config3_variants as config3
from sda_tpu_torch.tools import measure_lane_batch_floor as lane_batch
from sda_tpu_torch.tools import measure_latency_floor as latency
from sda_tpu_torch.utils import profiling

SEED = -0x61C88647  # 0x9E3779B9 as int32: the uint32 fill has bit 31 set


def _noop_kernel(seed_ref, s_ref, o_ref):
    # the reference tools' body (tools/measure_*_floor.py, measure_config3_variants.py)
    o_ref[...] = jnp.zeros_like(o_ref) + seed_ref[0].astype(o_ref.dtype)


def _reference(x, grid, in_block, in_map, out_shape, out_block, out_map, dtype):
    call = pl.pallas_call(
        _noop_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(in_block, in_map, memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(out_block, out_map, memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        interpret=True,
    )
    out = call(jnp.asarray([SEED], jnp.int32), jnp.asarray(x))
    return np.asarray(out).view(np.int32)


def _block_xor(x: np.ndarray, lanes: int = 128) -> np.ndarray:
    """Per 128-lane block, the XOR of every uint32 word of its column slice."""
    rows, nbp = x.shape
    words = np.ascontiguousarray(x).view(np.uint32).reshape(rows, nbp // lanes, lanes // 4)
    return np.bitwise_xor.reduce(np.bitwise_xor.reduce(words, axis=2), axis=0).view(np.int32)


def _planar(rows, nbp, seed):
    return np.random.default_rng(seed).integers(-128, 128, size=(rows, nbp), dtype=np.int8)


def test_t1_matches_the_latency_tool_kernel():
    """T1 (measure_latency_floor.py:76): grid (1,), the whole [rows, lanes]
    input block, a [L*k, lanes] uint32 output."""
    rows, lanes, out_rows = 4 * 3 * 8, 128, 12
    x = _planar(rows, lanes, 1)
    want = _reference(x, (1,), (rows, lanes), lambda t: (0, 0), (out_rows, lanes),
                      (out_rows, lanes), lambda t: (0, 0), jnp.uint32)
    out, sink = probes.probe_t1(torch.from_numpy(x), out_rows, SEED)
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(sink.numpy(), _block_xor(x))
    # the plain version launches nothing
    assert probes.probe_launches == {name: 0 for name in probes.probe_launches}


def test_t1_bare_matches_the_bare_launch_kernel():
    """T1' (measure_latency_floor.py:93): an [8, 128] int8 input, an [8, 128]
    int32 output."""
    x = _planar(8, 128, 2)
    want = _reference(x, (1,), (8, 128), lambda t: (0, 0), (8, 128), (8, 128),
                      lambda t: (0, 0), jnp.int32)
    out, sink = probes.probe_t1_bare(torch.from_numpy(x), 8 * 128, SEED)
    assert np.array_equal(out.numpy().reshape(8, 128), want)
    assert int(sink[0]) & 0xFFFFFFFF == int(np.bitwise_xor.reduce(x.view(np.uint32).ravel()))


@pytest.mark.parametrize("nbp,best_lanes", [(1024, 512), (768, 256)])
def test_t2_matches_the_lane_batch_tool_kernel(nbp, best_lanes):
    """T2 (measure_lane_batch_floor.py:100): grid (nbp / lanes,), block
    (rows, lanes) at (0, t)."""
    rows, out_rows = 5 * 3 * 8, 12
    x = _planar(rows, nbp, 3)
    want = _reference(x, (nbp // best_lanes,), (rows, best_lanes), lambda t: (0, t),
                      (out_rows, nbp), (out_rows, best_lanes), lambda t: (0, t), jnp.uint32)
    out, sink = probes.probe_t2(torch.from_numpy(x), out_rows, SEED)
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(sink.numpy(), _block_xor(x))
    assert probes.xor_words(sink) == probes.xor_words(torch.from_numpy(x))


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_t3_matches_the_config3_tool_kernel(n_chunks):
    """T3 (measure_config3_variants.py:126): grid (nbp / lanes, n_chunks),
    chunk c's block at (c, t), the output block at (0, t) across chunks."""
    rows, nbp, lanes, out_rows = 2 * 3 * 16, 512, 256, 24
    x = _planar(n_chunks * rows, nbp, 4)
    want = _reference(x, (nbp // lanes, n_chunks), (rows, lanes), lambda t, c: (c, t),
                      (out_rows, nbp), (out_rows, lanes), lambda t, c: (0, t), jnp.uint32)
    out, sink = probes.probe_t3(torch.from_numpy(x), out_rows, n_chunks, SEED, 1)
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(sink.numpy(), _block_xor(x))


@pytest.mark.parametrize("splits", [2, 3, 7, 40])
def test_t3_on_the_split_grid(splits):
    """T3 on B2's split grid: the same output, one sink per (split, lane
    block), each the XOR of the 64-row tiles of that split's pieces (3
    chunks of 150 rows: 3 tiles each, the last partial), and the sinks'
    XOR still that of the whole input."""
    n_chunks, rows, nbp, out_rows = 3, 150, 384, 24
    x = _planar(n_chunks * rows, nbp, 6)
    out, sink = probes.probe_t3(torch.from_numpy(x), out_rows, n_chunks, SEED, splits)
    one, _ = probes.probe_t3(torch.from_numpy(x), out_rows, n_chunks, SEED, 1)
    assert torch.equal(out, one)
    want = []
    for pieces in split_ranges(3, n_chunks, splits):
        acc = np.zeros(nbp // 128, dtype=np.int32)
        for c, b, e in pieces:
            acc ^= _block_xor(x[c * rows + 64 * b : c * rows + min(64 * e, rows)])
        want.append(acc)
    assert np.array_equal(sink.numpy(), np.concatenate(want))
    assert probes.xor_words(sink) == probes.xor_words(torch.from_numpy(x))


def test_probes_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((8, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.probe_t2(x, 4, 0)
    with pytest.raises(ValueError, match="n_chunks"):
        probes.probe_t3(torch.zeros((9, 128), dtype=torch.int8), 4, 2, 0, 1)
    with pytest.raises(ValueError, match="splits must be >= 1"):
        probes.probe_t3(torch.zeros((8, 128), dtype=torch.int8), 4, 2, 0, 0)
    with pytest.raises(ValueError, match="int8"):
        probes.probe_t1(torch.zeros((8, 128), dtype=torch.int32), 4, 0)
    meta = torch.empty((8, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.probe_t1(meta, 4, 0)


def test_library_probe_and_bytes():
    x = torch.from_numpy(_planar(16, 256, 5))
    out = torch.empty((4, 256), dtype=torch.int32)
    total = probes.library_probe(x, out, SEED)
    assert int(total) == int(x.numpy().view(np.int32).astype(np.int64).sum())
    assert bool((out == SEED).all())
    sink = torch.empty(2, dtype=torch.int32)
    assert probes.probe_bytes(x, out, sink) == 16 * 256 + 4 * 256 * 4 + 8


def test_roofline_names_the_binding_ceiling():
    rep = profiling.roofline(1e-3, hbm_bytes=3.35e9 / 2, int8_ops=1.979e12 / 4)
    assert rep["binding_resource"] == "hbm"
    assert rep["speed_of_light_s"] == pytest.approx(0.5e-3)
    assert rep["fraction_of_sol"] == pytest.approx(0.5)
    rep = profiling.roofline(2e-3, int32_ops=132 * 128 * 1000e6 * 1e-3, sm_mhz=1000.0)
    assert rep["binding_resource"] == "int32"
    assert rep["fraction_of_sol"] == pytest.approx(0.5)


def test_latency_tool_runs_its_checks_on_the_cpu():
    art = latency.measure(dimension=30, participants=4, jobs=2, device="cpu")
    for key in ("metric", "shape", "single_job_s", "noop_same_shape_s", "bare_launch_s",
                "kernel_work_s", "speed_of_light_s", "fraction_of_sol",
                "launch_floor_fraction_of_job", "batched64_per_job_s",
                "batched64_speedup_per_job", "note"):
        assert key in art
    assert art["device"] == "cpu" and art["single_job_s"] is None  # nothing timed here
    assert art["shape"]["lanes"] == 128 and art["noop_bytes"] == 96 * 128 + 12 * 128 * 4 + 4


def test_lane_batch_tool_runs_its_checks_on_the_cpu():
    art = lane_batch.measure(dimension=30, participants=4, jobs=8, device="cpu")
    assert {"metric", "shape", "experiments", "decomposition", "finding", "lanes_note"} <= set(art)
    # the real launch is timed once: the port's grid does not depend on lanes
    assert set(art["experiments"]) == {
        "real_lanes1024", "noop_same_shape", "library_same_bytes", "combine_only",
        "host_randomness", "combined_draw", "same_bytes_4x_participants"}
    assert art["shape"]["grid_blocks"] == 8 and art["decomposition"] is None
    assert art["shape"]["kernel_lanes"] == 1024


def test_config3_tool_sweeps_distinct_launches_on_the_cpu():
    art = config3.measure(dimension=30, total=8, variants=((1, 384), (2, 256), (2, 128)),
                          extra_chunks=(1, 2, 4), device="cpu")
    launches = [(r["n_chunks"], r["nbp"]) for r in art["rows"]]
    assert len(launches) == len(set(launches))  # one row per distinct launch
    assert launches == [(1, 384), (2, 256), (2, 128), (1, 128), (4, 128)]
    assert {"noop_dma_floor_ms", "combined_draw_ms", "no_reconstruction_ms"} <= set(
        art["controls_at_best"])
    # every row records its split count and real grid (on the CPU, S = 1)
    assert all(r["splits"] == 1 and r["grid_blocks"] == r["lane_blocks"] * r["splits"]
               for r in art["rows"])
    # T3 runs at a launch of more than one chunk as well
    chunked = art["noop_at_best_chunked"]
    assert chunked["n_chunks"] > 1 and chunked["noop_bytes"] == 8 * 3 * 16 * chunked["nbp"] + (
        4 * 8 * 3 * chunked["nbp"] + 4 * chunked["nbp"] // 128)


def test_crossover_tool_runs_both_routes_on_the_cpu():
    art = crossover.measure(shapes=((12, 20), (20, 7)), device="cpu")
    assert [r["total_elements"] for r in art["rows"]] == [240, 140]
    assert {"metric", "host_cores", "rows", "observed_crossover_elements", "note"} <= set(art)


def test_a_wrong_reveal_fails_the_tool(monkeypatch):
    import sda_tpu_torch.engine as engine_mod

    real = engine_mod.run_mxu8

    def corrupt(plan, sec, seed=0, lanes=None, acc_in=None):
        out = real(plan, sec, seed, lanes=lanes, acc_in=acc_in).clone()
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(engine_mod, "run_mxu8", corrupt)
    with pytest.raises(AssertionError, match="reveal"):
        latency.measure(dimension=30, participants=4, jobs=2, device="cpu")


def test_a_probe_that_skips_bytes_fails_the_sink_check():
    x = torch.from_numpy(_planar(8, 128, 6))
    out, sink = probes.probe_t1(x, 4, 0)
    _common.check_sink((out, sink), x)
    sink[0] ^= 1
    with pytest.raises(AssertionError, match="sink XOR"):
        _common.check_sink((out, sink), x)


def test_artifacts_go_under_build_measurements(tmp_path, monkeypatch):
    root = Path(__file__).resolve().parents[1]
    assert _common.MEASUREMENTS_DIR == root / "build" / "measurements"
    monkeypatch.setattr(_common, "MEASUREMENTS_DIR", tmp_path / "build" / "measurements")
    path = _common.write_artifact("LATENCY_FLOOR", {"metric": "x"})
    assert path == tmp_path / "build" / "measurements" / "LATENCY_FLOOR.json"
    assert path.read_text().startswith("{")
