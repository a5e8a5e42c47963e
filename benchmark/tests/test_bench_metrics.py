"""The per-layer readers on a trace made by hand."""

import pytest

from benchmark.core import spec, yardstick
from benchmark.core.driver import Record
from benchmark.core.trace import TraceReading
from benchmark.tests.cells import tiny_cell


def _reading():
    # two rounds of 1 ms each, device busy 0.1-0.3 and 1.2-1.4 ms (mxu8),
    # 0.5-0.6 ms (chacha); decode open 0.6-1.0 ms
    acts = [("void mxu8_fused_kernel<4>(int)", 100, 300, 1), ("chacha_fold_kernel", 500, 600, 2),
            ("void mxu8_fused_kernel<4>(int)", 1200, 1400, 3)]
    ranges = [("round", 0, 1000), ("round", 1000, 2000), ("decode", 600, 1000)]
    return TraceReading(rounds=2, activities=acts, ranges=ranges,
                        spans={"aggregate": [0.002, 0.004]})


def _read(name, record):
    return spec.load_module("metrics", name).read(record)


def test_device_idle_and_gaps():
    t = _reading()
    assert t.window_seconds() == pytest.approx(0.002)
    assert t.busy_seconds() == pytest.approx(0.0005)
    rec = Record(cell=tiny_cell("streaming"), setup_s=1.0, trace=t, spans=t.spans)
    assert _read("device_idle", rec) == pytest.approx(75.0)
    gaps = t.idle_gaps()
    assert sorted(g[0] for g in gaps[:2]) == ["between", "decode"]
    assert [g[1] for g in gaps] == pytest.approx([0.0006, 0.0006, 0.0002, 0.0001])
    assert t.device_ops()[0] == ["mxu8_fused_kernel", pytest.approx(0.0004)]


def test_rooflines_and_spans():
    cell = tiny_cell("streaming")
    t = _reading()
    rec = Record(cell=cell, setup_s=1.0, trace=t, spans=t.spans)
    bound = yardstick.aggregate_bound_s(8, 30, 63)
    assert _read("mxu8_roofline", rec) == pytest.approx(100 * bound / 0.0002)
    assert _read("chacha_roofline", rec) == pytest.approx(
        100 * yardstick.chacha_bound_s(8, 30) / 0.00005)
    assert _read("aggregate_ms", rec) == pytest.approx(3.0)
    assert _read("unmask_ms", rec) is None


def test_end_to_end_readers():
    rec = Record(cell=tiny_cell("single"), setup_s=2.5, rounds=40, window_s=2.0,
                 latencies_s=[0.05] * 38 + [0.06, 0.07])
    assert _read("round_ms", rec) == pytest.approx(50.0)
    assert _read("setup_s", rec) == 2.5
    assert _read("device_idle", rec) is None and _read("mxu8_roofline", rec) is None


def test_a_trace_that_is_never_whole_is_refused(monkeypatch):
    from benchmark.core import driver, trace

    monkeypatch.setattr(trace, "trace_problem",
                        lambda *a, **k: "device activities recorded 5 times for 3 rounds")
    with pytest.raises(trace.TraceRefused):
        driver.run_cell(tiny_cell("single"), 8, 0.01, True, "cpu")
