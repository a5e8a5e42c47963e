"""The program's own spans beside the harness's trace
(``benchmark/core/program_spans.py``): self time and the idle split on
ranges made by hand, the spans of a traced tiny round on the CPU, and, on
the card, each cell's traced round: the fused route's phases, the three
host edges against the harness's call spans, and the card's idle time
named by the spans (``python -m pytest
benchmark/tests/test_bench_program_spans.py -m card -s`` prints them)."""

import json

import pytest
import torch

from benchmark.core import driver, program_spans, spec, trace
from benchmark.core.trace import TraceReading
from benchmark.tests.cells import tiny_cell

CELLS = ["fl1m.cohort16k", "fl1m.cohort1k"]
# the host edges that the round's host-clock spans hold, by the span that
# holds each
EDGES = {"decode": "sda.engine.decode.to_object", "unmask": "sda.masking.unmask.from_object"}


def _by_hand():
    # one round 0-1000 us; the card busy 100-300 (mxu8) and 500-600 (chacha)
    acts = [("mxu8_fused_kernel", 100, 300, 1), ("chacha_fold_kernel", 500, 600, 2)]
    ranges = [("round", 0, 1000), ("mask_combine", 400, 800)]
    program = [("sda.masking.combine", 410, 790), ("sda.chacha.keys", 420, 480),
               ("sda.chacha.fold", 480, 500), ("sda.chacha.wait", 500, 650),
               ("sda.chacha.recombine", 650, 780), ("sda.chacha.keys", 430, 470)]
    return TraceReading(rounds=1, activities=acts, ranges=ranges), program


def test_self_time_is_the_length_less_the_children():
    _, program = _by_hand()
    assert program_spans.self_seconds(program, "sda.masking.combine") == pytest.approx(20e-6)
    # two keys ranges, one inside the other: their self times add to the outer's length
    assert program_spans.self_seconds(program, "sda.chacha.keys") == pytest.approx(60e-6)
    assert program_spans.self_seconds(program, "sda.chacha.wait") == pytest.approx(150e-6)
    assert program_spans.self_seconds([], "sda.chacha.wait") == 0.0
    assert program_spans.seconds(program, "sda.chacha.keys") == pytest.approx(100e-6)
    assert program_spans.seconds(program, "sda.engine.decode") == 0.0


def test_idle_split_by_the_innermost_span_by_interval():
    reading, program = _by_hand()
    idle = program_spans.idle_by_span(reading, program)
    assert idle == pytest.approx({
        "outside": 100e-6 + 110e-6 + 210e-6,
        "sda.masking.combine": 10e-6 + 10e-6,
        "sda.chacha.keys": 60e-6,
        "sda.chacha.fold": 20e-6,
        "sda.chacha.wait": 50e-6,
        "sda.chacha.recombine": 130e-6,
    })
    assert sum(idle.values()) == pytest.approx(reading.window_seconds() - reading.busy_seconds())
    within = program_spans.idle_by_span(reading, program, within=[(400, 800)])
    assert within["outside"] == pytest.approx(20e-6)
    assert sum(within.values()) == pytest.approx(300e-6)
    assert program_spans.idle_by_span(TraceReading(rounds=0), program) == {}


def _capture(monkeypatch) -> list:
    """The harness's profiler sessions, as it reads its ranges from each."""
    sessions = []
    real = trace._ranges

    def ranges(prof, labels):
        sessions.append((prof, labels))
        return real(prof, labels)

    monkeypatch.setattr(trace, "_ranges", ranges)
    return sessions


def _traced(monkeypatch, cell, seed, device):
    sessions = _capture(monkeypatch)
    result, _ = driver.run_cell(cell, seed, 1.0, True, device)
    prof, labels = sessions[-1]
    reading = TraceReading(rounds=result["attempted"], activities=trace._activities(prof, labels),
                           ranges=trace._ranges(prof, labels))
    return result, reading, program_spans.program_ranges(prof)


def _inside(rng, ranges, name):
    return any(n == name and s <= rng[1] and rng[2] <= e for n, s, e in ranges)


@pytest.mark.parametrize("kind", ["streaming", "single"])
def test_a_traced_tiny_round_holds_the_program_spans(monkeypatch, kind):
    result, reading, program = _traced(monkeypatch, tiny_cell(kind), 12, "cpu")
    assert result["correct"] is True
    names = [n for n, _, _ in program]
    calls = {"aggregate": "sda.engine.aggregate", "mask_combine": "sda.masking.combine",
             "decode": "sda.engine.decode", "unmask": "sda.masking.unmask"}
    for call, top in calls.items():
        tops = [r for r in program if r[0] == top]
        assert len(tops) == result["attempted"]
        assert all(_inside(r, reading.ranges, call) for r in tops)
    for edge in EDGES.values():
        assert names.count(edge) == result["attempted"]
    assert ("sda.engine.reconstruct" in names) == (kind == "streaming")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_card_round_names_its_phases_and_idle(monkeypatch, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, reading, program = _traced(monkeypatch, spec.load_cell(cell), 3_100_000_019,
                                       torch.device("cuda", 0))
    rounds = result["attempted"]
    assert result["correct"] is True and rounds > 0
    names = [n for n, _, _ in program]
    # the fused route: the seeds' keys (in combine and at the launch), B5's
    # launch, the waits on its counts and limbs, the recombine
    assert names.count("sda.masking.combine") == names.count("sda.chacha.fold") == rounds
    assert names.count("sda.chacha.keys") == names.count("sda.chacha.wait") == 2 * rounds
    assert names.count("sda.chacha.recombine") == rounds
    assert all(_inside(r, program, "sda.masking.combine") for r in program
               if r[0].startswith("sda.chacha."))
    # the program's ranges are host ranges: none is counted as the card's work
    assert not any(a[0].startswith(program_spans.PREFIX) for a in reading.activities)

    ms = {k: v["value"] for k, v in result["metrics"].items()}
    per_round = {n: 1e3 * program_spans.self_seconds(program, n) / rounds for n in set(names)}
    combine = 1e3 * program_spans.seconds(program, "sda.masking.combine") / rounds
    # every wait of this route is the combine's
    combine_host = combine - 1e3 * program_spans.seconds(program, "sda.chacha.wait") / rounds
    chacha_device = 1e3 * reading.kernel_seconds("chacha") / rounds
    edges = {call: 1e3 * program_spans.seconds(program, name) / rounds
             for call, name in EDGES.items()}
    within = [(s, e) for n, s, e in reading.ranges if n in driver.SPAN_NAMES]
    idle = program_spans.idle_by_span(reading, program, within)
    named = 1 - idle.get(program_spans.OUTSIDE, 0.0) / sum(idle.values())
    outside = {call: 1e3 * program_spans.idle_by_span(
        reading, program, [(s, e) for n, s, e in reading.ranges if n == call]
    ).get(program_spans.OUTSIDE, 0.0) / rounds for call in driver.SPAN_NAMES}
    folds = sorted(s for n, s, _, _ in reading.activities
                   if trace.kernel_name(n).startswith("chacha_fold"))
    launches = sorted(s for n, s, _ in program if n == "sda.chacha.fold")
    print(f"{cell}: " + json.dumps({
        "rounds": rounds, "outer_ms": {k: ms[k + "_ms"] for k in ("aggregate", "mask_combine",
                                                                  "decode", "unmask")},
        "combine_host_ms": combine_host, "chacha_device_ms": chacha_device,
        "decode_object_ms": edges["decode"], "unmask_object_ms": edges["unmask"],
        "self_ms": dict(sorted(per_round.items(), key=lambda kv: -kv[1])),
        "idle_ms": {k: 1e3 * v / rounds for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_named": named, "outside_idle_ms_by_call": outside,
        "device_idle": ms["device_idle"],
        "b5_after_launch_us": [k - f for k, f in zip(folds, launches)]}), flush=True)
    # one B5 and one launch span a round; how far each B5 starts after its
    # launch span shows how far the trace's host and card clocks drift apart
    assert len(folds) == len(launches) == rounds
    assert edges["decode"] <= ms["decode_ms"] and edges["unmask"] <= ms["unmask_ms"]
    assert abs(combine_host + chacha_device - ms["mask_combine_ms"]) <= 0.15 * ms["mask_combine_ms"]
