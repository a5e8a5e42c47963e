"""The window's bookkeeping: the window's inputs made in set-up, the
sample holding what it replaces until the window closes, and every program
call of every round inside the timed window."""

import math
import time
import weakref

import numpy as np
import pytest

from benchmark.core import driver, inputs
from benchmark.tests.cells import tiny_cell


class Counting:
    """A stand-in for the program: each call takes ``pause`` seconds and is
    logged with the round it belongs to."""

    pause = 0.002

    def __init__(self, cell, seed, device):
        self.log = Counting.log = []

    def _call(self, name, k):
        time.sleep(self.pause)
        self.log.append((name, k))

    def aggregate(self, inp):
        self._call("aggregate", inp.index)
        return inp.index

    def combine(self, inp):
        self._call("combine", inp.index)
        return inp.index

    def decode(self, k):
        self._call("decode", k)
        return np.full(4, k, dtype=np.int64)

    def unmask(self, mask, vals):
        self._call("unmask", mask)
        return vals

    def close(self):
        pass


@pytest.mark.parametrize("kind", ["streaming", "single"])
def test_window_inputs_are_the_rounds_own(kind):
    cell = tiny_cell(kind)
    made = driver.window_inputs(cell, 2**33 + 1, 7, 1.0, [0.25, 0.1, 0.5])
    assert len(made) == math.ceil(1.0 / 0.1 * driver.AHEAD) + 1
    for i, inp in enumerate(made):
        again = driver.round_input(cell, 2**33 + 1, 7 + i)
        assert inp.index == again.index == 7 + i
        assert inp.chunks == again.chunks and inp.kernel_seed == again.kernel_seed
        assert (inp.seed_words == again.seed_words).all()


def test_every_call_of_every_round_is_timed(monkeypatch):
    cell = tiny_cell("single")
    seen = []
    real = driver.round_input

    def spy(cell_, seed, k):
        seen.append(k)
        return real(cell_, seed, k)

    # few inputs made ahead: the window runs past them and makes the rest
    monkeypatch.setattr(driver, "AHEAD", 0.1)
    monkeypatch.setattr(driver, "round_input", spy)
    result, _ = driver.run_cell(cell, 2**34 + 3, 0.2, False, "cpu", system_factory=Counting)
    window = result["attempted"]
    calls = [k for name, k in Counting.log if name == "aggregate"]
    warm = len(calls) - window
    assert calls == list(range(warm + window)) and sorted(seen) == sorted(set(seen))
    for name in ("combine", "decode", "unmask"):
        assert [k for n, k in Counting.log if n == name] == calls
    assert result["metrics"]["round_ms"]["value"] >= 4 * Counting.pause * 1e3
    assert result["correct"] is False  # the stand-in's answers are not the sums


def test_the_sample_frees_nothing_until_released():
    sample = inputs.Sample(11, 2)
    refs = []
    for k in range(40):
        answer = np.full(5, k, dtype=np.int64)
        refs.append(weakref.ref(answer))
        sample.offer(k, answer)
        del answer
    kept = sample.kept()
    alive = [k for k, r in enumerate(refs) if r() is not None]
    # the kept answers, and every one they replaced, are still held
    assert len(sample.replaced) >= 2 and len(alive) == len(kept) + len(sample.replaced)
    assert set(kept) <= set(alive) and all((v == k).all() for k, v in kept.items())
    sample.release()
    assert [k for k, r in enumerate(refs) if r() is not None] == sorted(kept)
