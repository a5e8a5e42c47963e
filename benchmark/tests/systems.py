"""What the tests put in the program's place under the harness: the
control (the reference in float64, one precision below the exact sum the
configurations state) and the program with one fault planted."""

from __future__ import annotations

import numpy as np

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
