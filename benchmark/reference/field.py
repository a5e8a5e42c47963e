"""Sums of participant values mod p, in plain PyTorch and Python ints.

A participant value is written as little-endian 16-bit limbs. The sum of
many values is taken limb by limb in int64 (each limb sum stays far below
2**63) and finished in Python ints, then reduced mod p once, so it is exact
for any modulus. ``precision="float64"`` sums the values as float64 instead:
the control, one precision below the exact sum.
"""

from __future__ import annotations

import numpy as np
import torch


def limb_sums_to_ints(sums: torch.Tensor) -> np.ndarray:
    """``[d, L]`` int64 limb sums -> object array of the ``[d]`` totals."""
    limbs = sums.cpu().numpy()
    total = np.zeros(limbs.shape[0], dtype=object)
    for j in reversed(range(limbs.shape[1])):
        total = (total << 16) + limbs[:, j].astype(object)
    return total


def limb_values_float(limbs: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` limbs -> float64 values (rounded above 53 bits)."""
    scale = torch.tensor([float(1 << (16 * j)) for j in range(limbs.shape[-1])],
                         dtype=torch.float64, device=limbs.device)
    return (limbs.to(torch.float64) * scale).sum(dim=-1)


class ChunkSums:
    """The sum of one chunk's participant values, exact or in float64,
    from limb blocks handed in one at a time."""

    def __init__(self, precision: str = "exact"):
        self.precision = precision
        self.acc = None

    def add(self, limbs: torch.Tensor):
        """``limbs``: ``[participants, d, L]``."""
        part = (limbs.sum(dim=0) if self.precision == "exact"
                else limb_values_float(limbs).sum(dim=0))
        self.acc = part if self.acc is None else self.acc + part

    def total(self, modulus: int) -> np.ndarray:
        if self.precision == "exact":
            return limb_sums_to_ints(self.acc) % modulus
        return np.fmod(self.acc.cpu().numpy(), float(modulus))
