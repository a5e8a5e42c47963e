"""A cell, resolved by name from ``BENCHMARK.json`` and the files it names.

- ``configs[].file``: the deployment (scheme, field, dimension, committee,
  masking, guarantees, the program's constructor);
- ``benchmark/traffic/<traffic>.json``: the round (cohort, chunking, route,
  warm-up, traced and checked rounds);
- ``benchmark/routes/<route>.py``: how a round calls the program's engine;
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here knows a cell, configuration, traffic mix or metric by name.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def masking(self):
        return self.config.get("masking")


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: Path | None = None) -> Cell:
    bench = json.loads((bench_json or ROOT / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (work,) = found
    (conf,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
