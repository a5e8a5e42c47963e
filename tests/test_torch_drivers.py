"""The port's mesh drivers against the reference's root drivers.

- ``sda_tpu_torch.graft_entry.entry()`` on the CPU reveals what the
  reference ``__graft_entry__.entry()`` reveals for the same secrets from
  the same seed (the randomness cancels at the reveal);
- ``_mesh_shape`` is the reference's table;
- ``dryrun_multichip(n, device_type="cpu")`` passes its seven exact
  reveals in a world of 1 (in this process) and of 2 gloo ranks (spawned,
  every wait bounded), and refuses a world of another size;
- ``sda_tpu_torch.tools.bench_scaling --cpu-mesh --devices 2`` at tiny
  sizes prints the reference's keys, and its config-5 chunk loop and
  finish reveal the participants' sum;
- with no card, every entry point asked for ``cuda`` (the default) raises:
  nothing drops to the CPU on its own.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from sda_tpu_torch import graft_entry
from sda_tpu_torch.parallel.launch import spawn_ranks
from sda_tpu_torch.tools import bench_scaling

RANKS_TIMEOUT_S = 180  # one rank group, spawn to the last result

# the reference's output keys (bench_scaling.py:129-133, :208-216, :223-228)
REF_TOP_KEYS = {"metric", "platform", "results", "streaming_sharded"}
REF_ROW_KEYS = {"ms_per_step", "gfieldops_per_s", "weak_scaling_efficiency"}
REF_STREAM_KEYS = {"participants", "dimension", "chunks", "chunk_loop_ms", "finish_ms",
                   "comm_fraction", "gfieldops_per_s", "allreduce_payload_mb"}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_entry_reveal_matches_reference():
    import __graft_entry__ as ref_entry
    from sda_tpu.models import FederatedAggregation as RefModel

    fn, args = ref_entry.entry()
    want = RefModel.packed_64bit(dimension=1024).reveal(np.asarray(fn(*args)))
    fn, (secrets, generator) = graft_entry.entry(device="cpu")
    assert tuple(secrets.shape) == tuple(np.asarray(args[0]).shape)
    got = fn.__self__.reveal(fn(secrets, generator))
    assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 32, 64])
def test_mesh_shape_matches_reference(n):
    import __graft_entry__ as ref_entry

    assert graft_entry._mesh_shape(n) == ref_entry._mesh_shape(n)


def test_dryrun_world_of_one(capsys):
    import torch.distributed as dist

    graft_entry.dryrun_multichip(1, device_type="cpu")
    assert "dryrun_multichip OK: mesh={'p': 1, 'd': 1, 'c': 1}" in capsys.readouterr().out
    assert not dist.is_initialized()  # the world it made is closed again


def test_dryrun_two_gloo_ranks():
    got = spawn_ranks(graft_entry._dryrun_rank, 2, (2, "cpu"), "cpu", timeout=RANKS_TIMEOUT_S)
    assert sorted(got) == [0, 1]


def test_dryrun_checks_the_world_size():
    import torch.distributed as dist

    from sda_tpu_torch.parallel import make_mesh

    make_mesh({"p": 1, "d": 1, "c": 1}, "cpu")  # a world of one
    try:
        with pytest.raises(ValueError, match="dryrun of 2 devices in a world of 1 ranks"):
            graft_entry.dryrun_multichip(2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_bench_scaling_prints_reference_keys():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_scaling.main(["--cpu-mesh", "--devices", "2", "--dim-per-device", "16",
                                   "--participants-per-device", "2",
                                   "--streaming-chunks", "2"]) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert REF_TOP_KEYS <= set(res) and res["platform"] == "cpu"
    assert sorted(res["results"]) == ["1", "2"]
    assert all(set(row) == REF_ROW_KEYS for row in res["results"].values())
    assert res["results"]["1"]["weak_scaling_efficiency"] == 1.0
    stream = res["streaming_sharded"]
    assert set(stream) == REF_STREAM_KEYS
    assert (stream["participants"], stream["dimension"], stream["chunks"]) == (8, 48, 2)
    assert stream["allreduce_payload_mb"] == 8 * 16 * 4 * 4 / 1e6  # n x nb x L x 4 B
    assert 0 < stream["comm_fraction"] < 1


def test_bench_config5_split_reveals_the_sum():
    """The config-5 chunk loop (B1, then B3, plain versions) and its finish
    in a world of one on the CPU: the reveal is 3 x the chunk's sum."""
    import torch.distributed as dist

    from sda_tpu_torch.parallel import make_mesh
    from sda_tpu_torch.tools._common import reveal_check_slice

    mesh = make_mesh({"p": 1, "d": 1, "c": 1}, "cpu")
    try:
        case = bench_scaling.config5_case(mesh, 3, 100, 3)
        out = case.finish(case.loop(0))
        reveal_check_slice(case.pipe.engine, case.planar, out, case.p_chunk, width=100, times=3,
                           what="config-5 split")
        weak = bench_scaling.weak_case(mesh, 3, 100)
        assert tuple(weak.step(0).shape) == (100, 3, weak.pipe.engine.ctx.L)
    finally:
        dist.destroy_process_group()


def test_card_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="--cpu-mesh"):
        bench_scaling.main(["--devices", "1"])
    with pytest.raises(RuntimeError, match="CUDA devices"):
        spawn_ranks(graft_entry._dryrun_rank, 2, (2, "cuda"), "cuda")
    with pytest.raises(RuntimeError, match="CUDA devices"):  # the card unless asked for the CPU
        spawn_ranks(graft_entry._dryrun_rank, 1, (1, "cuda"))
