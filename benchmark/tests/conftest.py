"""The benchmark's own tests: ``python -m pytest benchmark/tests`` on the
CPU; the tests marked ``card`` run at the cells' own sizes and skip where
there is no CUDA card (``python -m pytest benchmark/tests -m card`` on the
card's machine)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
