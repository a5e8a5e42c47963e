"""The port's twins of the reference's root drivers.

- ``sda_tpu_torch.tools.bench_roofline.measure(..., device="cpu")`` runs
  both reveal checks on the plain version, times nothing and returns the
  reference's keys; with no card its ``main`` raises;
- ``examples/bulk_aggregation_torch.py`` on the CPU prints the same
  revealed values as the reference's ``examples/bulk_aggregation.py`` at
  the same flags, and with no card its default device raises;
- ``sda_tpu_torch.tools.make_scaling_artifact.compose`` on a fixed
  config-5 row gives the model's arithmetic, labelled projected.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sda_tpu_torch.tools import bench_roofline
from sda_tpu_torch.tools import make_scaling_artifact as msa

ROOT = Path(__file__).resolve().parents[1]
# bench_roofline.py:82-93, the reference's JSON line
REF_KEYS = {"metric", "chip", "ms_per_step", "full_pipeline", "combine_only"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_roofline_tool_checks_on_the_cpu():
    art = bench_roofline.measure(dimension=64, participants=4, lanes=128, device="cpu",
                                 breakdown=True)
    assert REF_KEYS | {"breakdown_ms"} <= set(art)
    assert art["ms_per_step"] is None and art["breakdown_ms"] is None  # nothing timed here
    assert art["device"] == "cpu" and art["chip"] == "cpu"
    for key in ("full_pipeline", "combine_only"):
        assert art[key]["seconds"] is None and art[key]["hbm_bytes"] > 0
    assert art["shape"] == {"dimension": 64, "participants": 4, "lanes": 128, "rows": 96,
                            "nbp": 128, "input_bytes": 96 * 128}
    assert "breakdown_ms" not in bench_roofline.measure(dimension=64, participants=4, lanes=128,
                                                        device="cpu")


def test_roofline_tool_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_roofline.main(["--dimension", "64", "--participants", "4", "--lanes", "128"])


def test_bulk_example_matches_the_reference(capsys, monkeypatch):
    flags = ["--participants", "4", "--dimension", "64"]
    ours = _load(ROOT / "examples" / "bulk_aggregation_torch.py", "bulk_aggregation_torch")
    assert ours.main(["--device", "cpu", *flags]) == 0
    got = capsys.readouterr()
    assert "on cpu" in got.err and "reveal matches the modular sum" in got.err
    ref = _load(ROOT / "examples" / "bulk_aggregation.py", "bulk_aggregation")
    monkeypatch.setattr(sys, "argv", ["bulk_aggregation.py", *flags])
    assert ref.main() == 0
    want = capsys.readouterr()
    assert got.out == want.out
    assert got.out.split()[:-1] and got.out.split()[-1] == "..."


def test_bulk_example_needs_a_card_by_default(no_card):
    ours = _load(ROOT / "examples" / "bulk_aggregation_torch.py", "bulk_aggregation_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ours.main(["--participants", "2", "--dimension", "8"])


def test_scaling_artifact_compose_is_the_model():
    row = {"participants": 131 * 768, "dimension": 1_000_002, "chunks": 131,
           "chunk_loop_ms": 655.0, "finish_ms": 0.7, "comm_fraction": 0.001,
           "gfieldops_per_s": 6100.0, "allreduce_payload_mb": 42.666752}
    virt = {"results": {"1": {}, "2": {}, "4": {}, "8": {}}, "streaming_sharded": {"chunks": 3}}
    art = msa.compose({"streaming_sharded": row}, virt)
    proj = art["projected"]
    chunk_s = 0.655 / 131
    assert proj["measured_chunk_s"] == pytest.approx(chunk_s)
    # 100,000 participants over 8 cards in chunks of 768: 17 chunks a card
    assert proj["cards"] == 8 and proj["chunks_per_card"] == 17
    assert proj["compute_s"] == pytest.approx(17 * chunk_s)
    payload = 42.666752e6
    assert proj["allreduce_s"] == pytest.approx(2 * 7 / 8 * payload / 300e9)
    total = 17 * chunk_s + 2 * 7 / 8 * payload / 300e9 + 0.7e-3
    assert proj["total_s"] == pytest.approx(total)
    assert proj["weak_scaling_efficiency"] == pytest.approx(17 * chunk_s / total)
    assert proj["aggregations_per_s"] == pytest.approx(100_000 / total)
    assert proj["finish_s"] == pytest.approx(2 * 7 / 8 * payload / 300e9 + 0.7e-3)
    assert set(proj["nvlink_bandwidth_sensitivity"]) == {"150_GBps", "300_GBps", "450_GBps"}
    slow = proj["nvlink_bandwidth_sensitivity"]["150_GBps"]
    assert slow["allreduce_s"] == pytest.approx(2 * proj["allreduce_s"])
    four = proj["at_4_cards"]
    assert four["chunks_per_card"] == 33
    assert four["allreduce_s"] == pytest.approx(2 * 3 / 4 * payload / 300e9)
    assert "projected" in proj["note"] and "projected" in art["metric"]
    assert art["virtual_8rank_mesh"]["devices_validated"] == [1, 2, 4, 8]
    assert msa.compose({"streaming_sharded": row}, None)["virtual_8rank_mesh"] is None
    assert np.isclose(art["real_card"]["streaming_sharded"]["chunk_loop_ms"], 655.0)
