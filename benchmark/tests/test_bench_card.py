"""The control and the stale aggregate at each cell's own size, on the
card: the reference, in float64, in the program's place, and the program
handing on the round before's sum, have to come out not correct. Skips
where there is no CUDA card; on the card's machine:
``python -m pytest benchmark/tests/test_bench_card.py -m card -s``."""

import json

import pytest
import torch

from benchmark.core import driver, spec
from benchmark.tests.systems import ControlSystem, StaleAggregate

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [3_100_000_001, 3_100_000_002, 3_100_000_003]


def _reads_not_correct(name, factory, cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = driver.run_cell(spec.load_cell(cell), seed, 1.0, False,
                                     torch.device("cuda", 0), system_factory=factory)
    print(f"{name} {cell} seed {seed}: " + json.dumps(checks), flush=True)
    assert result["correct"] is False
    assert checks["wrong_elements"]["value"] > checks["wrong_elements"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size_reads_not_correct(cell, seed):
    _reads_not_correct("control", ControlSystem, cell, seed)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_stale_aggregate_at_cell_size_reads_not_correct(cell, seed):
    _reads_not_correct("stale_aggregate", StaleAggregate, cell, seed)
