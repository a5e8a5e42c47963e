"""The ``tss728.cohort16k`` cell: its comparison fails what it has to, and
the wide kernel it runs equals its plain version.

The control of the other cells (the reference in float64) is exact at
this field (16,384 x 2^19 < 2^53), so it would read correct here; the
comparison is held instead to two faults planted in the threshold reveal
at a small size on the CPU: the Lagrange matrix of another subset of
clerks, and one reporting clerk's shares dropped. The tests marked
``card`` run the wide kernel (``csrc/mxu8.cu`` mode 3) on the card against
the plain version, bit for bit, and skip where there is no CUDA card
(``python -m pytest benchmark/tests/test_bench_tss728.py -m card -s`` on
the card's machine)."""

from __future__ import annotations

import dataclasses
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.core import driver, inputs, spec, wide_walk
from benchmark.tests.systems import _Faulty

CONFIG = json.loads((spec.BENCH_DIR / "configs" / "tss-728-p20.json").read_text())
# the cell's rounds are drawn from C(207, 128) cohorts, past int64
wide_walk.install()


def tiny_cell(participants: int = 8, chunk: int = 4, resident: int = 12) -> spec.Cell:
    """The cell's configuration and route at a width the CPU runs in
    seconds: 200 elements, 8 participants a round as 2 chunks of 4."""
    config = dict(CONFIG, dimension=200, resident_participants=resident)
    traffic = dict(route="threshold", participants=participants, chunk=chunk, lanes=16,
                   warmup_rounds=1, trace_rounds=2, check_rounds=2)
    return spec.Cell(name="tiny.threshold", chips=1, config=config, traffic=traffic)


class WrongSubsetMatrix(_Faulty):
    """The reporting clerks' shares reconstructed with the Lagrange matrix
    of another subset (each index one higher, mod n)."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        s = dataclasses.replace(self.engine.spec)
        real, n = s.subset_matrix, s.share_count

        def wrong(clerks):
            return real(sorted((i + 1) % n for i in clerks))

        object.__setattr__(s, "subset_matrix", wrong)
        self.engine.spec = s


class DroppedClerk(_Faulty):
    """The first reporting clerk's combined shares dropped (read as zero)
    before the reconstruction."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        eng, real = self.engine, self.engine._clerk_bytes

        def dropped(comb, s):
            out = real(comb, s).clone()
            out[: eng.mxu8.L8] = -128  # biased zero bytes
            return out

        eng._clerk_bytes = dropped


class Float32Control:
    """The round's answer computed in float32, the precision below the
    exact sum that float64 still holds here: the values' sum reaches 2^33,
    past float32's 24-bit mantissa, at the cell's size."""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, traffic = cell.config, cell.traffic
        self.chunk = int(traffic["chunk"])
        self.per_round = int(traffic["participants"]) // self.chunk
        self.resident = int(cfg["resident_participants"]) // self.chunk
        self.totals = {}

    def _total(self, c):
        got = self.totals.get(c)
        if got is None:
            cfg = self.cell.config
            got = 0
            for block, count in inputs.chunk_blocks(self.chunk):
                limbs = inputs.participant_limbs(self.seed, c, block, count, int(cfg["dimension"]),
                                                 int(cfg["value_bits"]), self.device)
                got = got + (limbs[..., 0] + limbs[..., 1] * 65536).to(torch.float32).sum(dim=0)
            self.totals[c] = got
        return got

    def aggregate(self, inp):
        return inp.index

    def combine(self, inp):
        return None

    def decode(self, k):
        chunks = inputs.round_chunks(self.seed, k, self.per_round, self.resident)
        total = sum(self._total(c) for c in chunks)
        return torch.fmod(total, float(self.cell.config["modulus"])).cpu().numpy().astype(np.int64)

    def unmask(self, mask, vals):
        return vals

    def close(self):
        self.totals = None


@pytest.mark.parametrize("fault", [WrongSubsetMatrix, DroppedClerk], ids=lambda f: f.__name__)
def test_planted_fault_reads_not_correct(fault):
    result, checks = driver.run_cell(tiny_cell(), 2**33 + 7, 0.01, False, "cpu",
                                     system_factory=fault)
    assert result["correct"] is False
    assert checks["wrong_elements"]["value"] > checks["wrong_elements"]["limit"]


def test_float32_control_reads_correct_where_float32_is_exact():
    """At the tiny size the values' sum stays below 2^24: the float32
    control is exact there, and the comparison passes it."""
    result, _ = driver.run_cell(tiny_cell(), 2**33 + 9, 0.01, False, "cpu",
                                system_factory=Float32Control)
    assert result["correct"] is True


def test_tiny_cell_reads_correct():
    result, checks = driver.run_cell(tiny_cell(), 2**33 + 8, 0.01, False, "cpu")
    assert result["correct"] is True, checks
    assert checks["wrong_elements"]["value"] == 0


def test_wide_walk_reads_correct():
    """100 chunks of one participant a round from 30 resident: C(129, 100)
    cohorts, past int64, drawn by the wide walk for the program and the
    reference alike."""
    cell = tiny_cell(participants=100, chunk=1, resident=30)
    assert math.comb(129, 100) >= wide_walk.NARROW
    result, checks = driver.run_cell(cell, 2**33 + 10, 0.01, False, "cpu")
    assert result["correct"] is True, checks


@pytest.mark.parametrize("per_round,resident", [(16, 10), (1, 2), (3, 4)])
def test_wide_walk_leaves_narrow_counts_to_numpy(per_round, resident):
    seed = 2**40 + 3
    states = math.comb(per_round + resident - 1, per_round)
    for block in (0, 1):
        assert inputs._walk(seed, states, block) == inputs._walk.narrow(seed, states, block)


def test_wide_walk_draws_the_cells_cohorts():
    """128 chunks of 80 resident, across a block of the walk: each round a
    sorted multiset, none the round's before, fixed by the seed."""
    seed = 3_300_000_001
    rounds = [tuple(inputs.round_chunks(seed, k, 128, 80)) for k in range(1020, 1030)]
    assert rounds == [tuple(inputs.round_chunks(seed, k, 128, 80)) for k in range(1020, 1030)]
    assert all(len(r) == 128 and list(r) == sorted(r) and 0 <= r[0] and r[-1] < 80
               for r in rounds)
    assert all(a != b for a, b in zip(rounds, rounds[1:]))
    assert rounds != [tuple(inputs.round_chunks(seed + 1, k, 128, 80)) for k in range(1020, 1030)]
    assert len(set(rounds[0])) > 40


def test_wide_walk_installs_once():
    walk = inputs._walk
    wide_walk.install()
    assert inputs._walk is walk and walk.narrow.__name__ == "_walk"


def test_route_streams_each_chunk_as_one_launch():
    route = spec.load_module("routes", "threshold")
    got = {}

    class Engine:
        spec = SimpleNamespace(secret_count=2, randomness_count=1, share_count=5)

        def aggregate_mxu8_kernel_streaming(self, pieces, p_chunk, seed0, lanes, clerks):
            got.update(pieces=pieces, p_chunk=p_chunk, seed0=seed0, lanes=lanes, clerks=clerks)
            return "out"

    class Store:
        def chunk_rows(self, c):  # 4 participants of 3 rows
            return torch.arange(12 * c, 12 * c + 12).reshape(12, 1)

    assert route.aggregate(Engine(), Store(), [1, 0, 1], 4, 9, 16) == "out"
    assert [p[:, 0].tolist() for p in got["pieces"]] == [
        list(range(12, 24)), list(range(0, 12)), list(range(12, 24))]
    assert (got["p_chunk"], got["seed0"], got["lanes"]) == (4, 9, 16)
    assert got["clerks"] == route.reporting_clerks(Engine.spec, 9)
    assert got["clerks"] == sorted(set(got["clerks"])) and len(got["clerks"]) == 3
    assert all(0 <= i < 5 for i in got["clerks"])
    with pytest.raises(ValueError):
        route.aggregate(Engine(), Store(), [0], route.LAUNCH + 1, 9, 16)


# ------------------------------------------------------------ on the card


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _plans(p: int, matrix, rows: int, p_count: int, k: int, r: int, device):
    from sda_tpu_torch.ops.limbs import LimbContext
    from sda_tpu_torch.ops.mxu8 import Mxu8Context, mxu8_plan

    mxu8 = Mxu8Context.create(LimbContext.create(p))
    return [mxu8_plan(mxu8, matrix, rows, p_count, k, r, device=d) for d in ("cpu", device)]


def _tss_matrix():
    from sda_tpu_torch.sharing import PackedShamirScheme

    s = PackedShamirScheme(100, 728, 155, 746_497, 95_660, 610_121)
    return s.device_spec()


# (name, participants, PRNG, lanes): the cell's scheme at its widths; its
# chunk of 128 with in-kernel randomness, a few participants with the
# caller's, and lane counts that are not multiples of 16 or 128
TSS_CASES = [("prng4", 4, True, 256), ("prng3_lanes200", 3, True, 200),
             ("caller2", 2, False, 256), ("chunk128", 128, True, 256)]


@pytest.mark.card
@pytest.mark.parametrize("case", TSS_CASES, ids=lambda c: c[0])
def test_wide_kernel_equals_plain_version(case):
    from sda_tpu_torch.ops import mxu8 as m8

    dev = _card()
    _, P, prng, nbp = case
    spec_ = _tss_matrix()
    k, r = spec_.secret_count, spec_.randomness_count
    rows = P * (k if prng else k + r) * 4
    cpu, card = _plans(spec_.modulus, spec_.share_matrix, rows, P, k, r, dev)
    assert m8.is_wide(card) and card.mxu8.special is None and card.mxu8.L16r == 6
    gen = torch.Generator().manual_seed(P * 1000 + nbp)
    secs = [torch.randint(-128, 128, (rows, nbp), generator=gen, dtype=torch.int8)
            for _ in range(2)]
    before = m8.mxu8_wide_launches
    want = m8.run_mxu8(cpu, secs[0], seed=2**31 + 17)  # B1
    got = m8.run_mxu8(card, secs[0].to(dev), seed=2**31 + 17)
    assert torch.equal(got.cpu(), want)
    want = m8.run_mxu8(cpu, secs[1], seed=99, acc_in=want)  # B3 onto it
    got = m8.run_mxu8(card, secs[1].to(dev), seed=99, acc_in=got)
    assert torch.equal(got.cpu(), want)
    assert m8.mxu8_wide_launches == before + 2


@pytest.mark.card
def test_wide_reconstruction_equals_plain_version():
    from sda_tpu_torch.ops import mxu8 as m8

    dev = _card()
    spec_ = _tss_matrix()
    clerks = sorted(np.random.default_rng(3).choice(728, 255, replace=False).tolist())
    cpu, card = _plans(spec_.modulus, spec_.subset_matrix(clerks), 255 * 4, 1, 255, 0, dev)
    assert m8.is_wide(card)  # 100 outputs: 401 rows
    sec = torch.randint(-128, 128, (255 * 4, 10496), generator=torch.Generator().manual_seed(4),
                        dtype=torch.int8)
    assert torch.equal(m8.run_mxu8(card, sec.to(dev)).cpu(), m8.run_mxu8(cpu, sec))


@pytest.mark.card
@pytest.mark.parametrize("prng", [True, False])
def test_wide_kernel_at_another_field(prng):
    """25 clerks of an additive scheme at p = 2^63 - 871 (8-byte limbs, the
    pseudo-Mersenne fold): 201 output rows, the narrowest wide plan."""
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.sharing import AdditiveScheme

    dev = _card()
    s = AdditiveScheme(25, 2**63 - 871).device_spec()
    P, nbp = 3, 384
    rows = P * (1 if prng else 25) * 8
    cpu, card = _plans(s.modulus, s.share_matrix, rows, P, 1, 24, dev)
    assert m8.is_wide(card) and card.mxu8.special is not None
    sec = torch.randint(-128, 128, (rows, nbp), generator=torch.Generator().manual_seed(8),
                        dtype=torch.int8)
    assert torch.equal(m8.run_mxu8(card, sec.to(dev), seed=5).cpu(), m8.run_mxu8(cpu, sec, seed=5))


@pytest.mark.card
@pytest.mark.parametrize("seed", [3_300_000_011, 3_300_000_012, 3_300_000_013])
def test_float32_control_at_cell_size_reads_not_correct(seed):
    dev = _card()
    result, checks = driver.run_cell(spec.load_cell("tss728.cohort16k"), seed, 1.0, False, dev,
                                     system_factory=Float32Control)
    print(f"float32 control seed {seed}: " + json.dumps(checks), flush=True)
    assert result["correct"] is False
    assert checks["wrong_elements"]["value"] > checks["wrong_elements"]["limit"]


@pytest.mark.card
def test_narrow_plan_keeps_its_launch():
    """An 8-clerk plan (65 output rows) launches B1 as before, not the wide
    variant."""
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.sharing import PackedShamirScheme

    dev = _card()
    p, w2, w3 = find_special_prime_field(63, 8, 9)
    s = PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec()
    cpu, card = _plans(p, s.share_matrix, 16 * 3 * 8, 16, 3, 4, dev)
    assert not m8.is_wide(card)
    sec = torch.randint(-128, 128, (16 * 3 * 8, 256), generator=torch.Generator().manual_seed(9),
                        dtype=torch.int8)
    b1, wide = m8.mxu8_launches, m8.mxu8_wide_launches
    assert torch.equal(m8.run_mxu8(card, sec.to(dev), seed=3).cpu(), m8.run_mxu8(cpu, sec, seed=3))
    assert (m8.mxu8_launches, m8.mxu8_wide_launches) == (b1 + 1, wide)
