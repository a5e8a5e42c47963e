"""What the tests put in the program's place under the harness: the
control (the reference one precision below the exact sum the
configurations state: float64, or float32 where float64 still holds the
sum) and the program with one fault planted."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import inputs, spec
from benchmark.core.driver import ProgramSystem
from benchmark.reference.round import ReferenceRound


class ControlSystem:
    """The reference, computed in float64, in the program's place."""

    def __init__(self, cell, seed, device):
        self.ref = ReferenceRound(cell, seed, device, precision="float64")

    def aggregate(self, inp):
        return inp.index

    def combine(self, inp):
        return None

    def decode(self, out):
        return self.ref.answer(out)

    def unmask(self, mask, vals):
        return vals

    def close(self):
        self.ref = None


class Float32Control:
    """The round's answer computed in float32, the precision below the
    exact sum that float64 still holds here: the values' sum reaches 2^33,
    past float32's 24-bit mantissa, at the cell's size."""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, traffic = cell.config, cell.traffic
        # the route draws the rounds' cohorts as the program's set-up would
        # (the threshold route installs the walk over more than 2^63 cohorts)
        spec.load_module("routes", traffic["route"])
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


def control_for(cell):
    """The cell's control: float64, unless a round's sum of values fits
    float64's 53-bit mantissa and float64 would be exact; then float32."""
    largest = int(cell.traffic["participants"]) * ((1 << int(cell.config["value_bits"])) - 1)
    return ControlSystem if largest >= 1 << 53 else Float32Control


class _Faulty(ProgramSystem):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.masked = cell.masking is not None
        self.modulus = int(cell.config["modulus"])

    def finish(self, vals):
        return vals

    def decode(self, out):
        vals = super().decode(out)
        return vals if self.masked else self.finish(vals)

    def unmask(self, mask, vals):
        return self.finish(super().unmask(mask, vals))


class StaleAggregate(_Faulty):
    """The engine's output of the round before handed on in place of this
    round's: the decode and the unmask then work on a stale sum."""

    last = None

    def aggregate(self, inp):
        out = super().aggregate(inp)
        prev, self.last = self.last, out
        return out if prev is None else prev


class StaleRound(_Faulty):
    """A round that hands back the previous round's answer."""

    last = None

    def finish(self, vals):
        prev = self.last if self.last is not None else np.zeros_like(np.asarray(vals))
        self.last = vals
        return prev


class HalfCohort(_Faulty):
    """Half of each chunk's participants left out, the sum of the rest
    doubled."""

    def aggregate(self, inp):
        store = self.store

        class Half:
            def chunk_rows(self, c):
                rows = store.chunk_rows(c)
                return rows[: rows.shape[0] // 2]

        return self.route.aggregate(self.engine, Half(), inp.chunks, self.chunk // 2,
                                    inp.kernel_seed, self.lanes)

    def decode(self, out):
        vals = np.asarray(ProgramSystem.decode(self, out), dtype=object) * 2 % self.modulus
        return vals if self.masked else self.finish(vals)


class AlteredAnswer(_Faulty):
    """One element of the engine's output altered where it is made."""

    def aggregate(self, inp):
        out = super().aggregate(inp).clone()
        out[0, 0, 0] ^= 1
        return out


FAULTS = {"stale_aggregate": StaleAggregate, "stale_round": StaleRound,
          "half_cohort": HalfCohort, "altered_answer": AlteredAnswer}
