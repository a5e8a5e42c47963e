"""A tiny round through the harness on the CPU: the result line, the checks
and the refusal where there is no card."""

import io
import json
import math

import pytest
import torch

from benchmark import run
from benchmark.core import driver, inputs
from benchmark.tests.cells import tiny_cell

KINDS = ["streaming", "single"]


@pytest.mark.parametrize("kind", KINDS)
def test_result_line_and_checks(kind):
    result, checks = driver.run_cell(tiny_cell(kind), 2**31 + 77, 0.01, False, "cpu")
    out, err = io.StringIO(), io.StringIO()
    run.emit(result, checks, out, err)
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert set(last["metrics"]) == {"round_ms", "setup_s"}
    assert all(v["value"] > 0 for v in last["metrics"].values())
    assert err.getvalue().splitlines()[-2:] == ["check wrong_elements 0 limit 0",
                                                "check wrong_rounds 0 limit 0"]


@pytest.mark.parametrize("kind", KINDS)
def test_traced_run(kind):
    result, _ = driver.run_cell(tiny_cell(kind), 12, 0.01, True, "cpu")
    assert result["correct"] is True and result["attempted"] == 2
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"aggregate_ms", "decode_ms"} <= set(result["metrics"])
    assert "window_s" in result["device"] and "busy_s" in result["device"]


def test_same_seed_same_inputs():
    a, _ = driver.run_cell(tiny_cell("single"), 5, 0.01, False, "cpu")
    cell = tiny_cell("single")
    inp = [driver.round_input(cell, 5, k) for k in range(3)]
    again = [driver.round_input(cell, 5, k) for k in range(3)]
    assert all((x.seed_words == y.seed_words).all() and x.kernel_seed == y.kernel_seed
               and x.chunks == y.chunks for x, y in zip(inp, again))
    assert a["correct"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "fl1m.cohort1k", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("per_round,resident", [(16, 5), (1, 5), (2, 3)])
def test_each_round_draws_another_cohort(per_round, resident):
    rounds = [inputs.round_chunks(2**40 + 3, k, per_round, resident) for k in range(1100)]
    assert all(len(r) == per_round and r == sorted(r) and 0 <= r[0] and r[-1] < resident
               for r in rounds)
    assert all(a != b for a, b in zip(rounds, rounds[1:]))
    assert len({tuple(r) for r in rounds}) == min(1100, math.comb(per_round + resident - 1,
                                                                 per_round)) or per_round == 16
    assert rounds[1050] == inputs.round_chunks(2**40 + 3, 1050, per_round, resident)
    assert rounds != [inputs.round_chunks(2**40 + 4, k, per_round, resident)
                      for k in range(1100)]


def test_multisets_are_counted_once_each():
    seen = [tuple(inputs.multiset(i, 3, 4)) for i in range(math.comb(6, 3))]
    assert len(set(seen)) == len(seen) == 20 and seen[0] == (0, 0, 0) and seen[-1] == (3, 3, 3)


def test_the_sample_keeps_only_what_it_compares():
    picks = []
    for seed in range(200):
        sample = inputs.Sample(seed, 3)
        for k in range(50):
            sample.offer(k, [k])
        kept = sample.kept()
        assert len(kept) == 3 and all(v == [k] for k, v in kept.items())
        picks += list(kept)
    again = inputs.Sample(7, 3)
    for k in range(50):
        again.offer(k, [k])
    assert list(again.kept()) == picks[21:24]
    assert 0 < sum(k < 25 for k in picks) / len(picks) < 0.6


@pytest.mark.parametrize("kind", KINDS)
def test_setup_line_sums_to_setup_s(kind, capsys):
    result, _ = driver.run_cell(tiny_cell(kind), 2**32 + 5, 0.01, False, "cpu",
                                phases={"imports": 0.0, "context": 0.0})
    (line,) = [s for s in capsys.readouterr().err.splitlines() if s.startswith("setup: ")]
    parts, total = line.removeprefix("setup: ").split(" = ")
    phases = dict(p.rsplit(" ", 1) for p in parts.split(", "))
    assert list(phases) == ["imports", "context", "program", "store", "warmup", "other"]
    setup_s = result["metrics"]["setup_s"]["value"]
    assert total == f"{setup_s:.3f} s"
    assert math.isclose(sum(float(v) for v in phases.values()), setup_s, abs_tol=0.004)
    assert all(float(v) >= 0 for k, v in phases.items() if k != "other")
