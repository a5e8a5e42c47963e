"""Cells at sizes the CPU runs in seconds: the shapes of the real cells,
with their widths cut, driven through the same harness."""

from __future__ import annotations

import json

from benchmark.core import spec

_MASKING = {"scheme": "chacha", "seed_bits": 128, "program": "sda_tpu_torch.masking:ChaChaMasker"}


def _config(name: str, dimension: int, resident: int) -> dict:
    conf = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())
    conf.update(dimension=dimension, resident_participants=resident)
    return conf


def tiny_cell(kind: str) -> spec.Cell:
    """``streaming`` (the streamed cell) or ``single`` (one launch a
    round)."""
    if kind == "streaming":
        config = _config("fl-1m-p64", 30, 12)
        traffic = dict(route="streaming", participants=8, chunk=4, lanes=16, warmup_rounds=1,
                       trace_rounds=2, check_rounds=2)
    elif kind == "single":
        config = _config("fl-1m-p64", 30, 12)
        traffic = dict(route="single", participants=4, chunk=4, lanes=16, warmup_rounds=1,
                       trace_rounds=2, check_rounds=2)
    else:
        raise ValueError(kind)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    return spec.Cell(name=f"tiny.{kind}", chips=1, config=config, traffic=traffic,
                     end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
                     per_layer=list(bench["per_layer"]))
