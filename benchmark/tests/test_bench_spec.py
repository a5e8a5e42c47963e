"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds its
configuration, traffic, route and metric files by name."""

import json
import re

import pytest

from benchmark.core import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(".." not in p and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    named = [w for w in BENCH["command"] if "/" in w and not w.startswith("python")]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, CELLS, [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(_line(m["layer"]) for m in BENCH["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    spec.load_module("routes", c.traffic["route"])
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert int(c.traffic["participants"]) % int(c.traffic["chunk"]) == 0
    assert int(c.config["resident_participants"]) % int(c.traffic["chunk"]) == 0


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) * 25 // 100)
