"""The answer a round owes: the sum mod p of the round's participant
values, less the sum of its participants' ChaCha masks where the
configuration masks.

It works everything out again from the inputs the benchmark made
(:mod:`benchmark.core.inputs`) and the configuration's modulus; it imports
nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import numpy as np

from benchmark.core import inputs
from benchmark.reference import chacha20
from benchmark.reference.field import ChunkSums


class ReferenceRound:
    def __init__(self, cell, seed: int, device, precision: str = "exact"):
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.seed, self.device, self.precision = cell, seed, device, precision
        self.modulus = int(cfg["modulus"])
        self.dimension = int(cfg["dimension"])
        self.value_bits = int(cfg["value_bits"])
        self.chunk = int(traffic["chunk"])
        self.per_round = int(traffic["participants"]) // self.chunk
        self.resident = int(cfg["resident_participants"]) // self.chunk
        self._chunks: dict[int, np.ndarray] = {}

    def chunk_total(self, c: int) -> np.ndarray:
        got = self._chunks.get(c)
        if got is None:
            sums = ChunkSums(self.precision)
            for block, count in inputs.chunk_blocks(self.chunk):
                sums.add(inputs.participant_limbs(self.seed, c, block, count, self.dimension,
                                                  self.value_bits, self.device))
            got = self._chunks[c] = sums.total(self.modulus)
        return got

    def answer(self, k: int) -> np.ndarray:
        """Round ``k``'s revealed vector, canonical in ``[0, p)``: Python ints
        (exact) or float64 (the control)."""
        p = self.modulus if self.precision == "exact" else float(self.modulus)
        total = sum(self.chunk_total(c)
                    for c in inputs.round_chunks(self.seed, k, self.per_round, self.resident))
        masking = self.cell.masking
        if masking:
            words = inputs.round_seed_words(self.seed, k, self.chunk * self.per_round,
                                            -(-int(masking["seed_bits"]) // 32))
            total = total - chacha20.combined_mask(words, self.dimension, self.modulus,
                                                   self.device, self.precision)
        return total % p
