"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in float64 in the program's place) and the program
with a fault planted under the timed path."""

import pytest

from benchmark.core import driver
from benchmark.tests.cells import tiny_cell
from benchmark.tests.systems import FAULTS, ControlSystem

KINDS = ["streaming", "single"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_not_correct(kind, fault):
    result, checks = driver.run_cell(tiny_cell(kind), 2**31 + 5, 0.01, False, "cpu",
                                     system_factory=FAULTS[fault])
    assert result["correct"] is False
    assert checks["wrong_elements"]["value"] > checks["wrong_elements"]["limit"]


@pytest.mark.parametrize("kind", KINDS)
def test_control_reads_not_correct(kind):
    result, checks = driver.run_cell(tiny_cell(kind), 2**31 + 6, 0.01, False, "cpu",
                                     system_factory=ControlSystem)
    assert result["correct"] is False
    assert checks["wrong_elements"]["value"] >= 30 * checks["wrong_rounds"]["value"] // 2
