"""The flagship workload: federated-model secure aggregation.

Port of the reference package's ``models/federated.py``. One object is one
deployable configuration of the device pipeline (mask -> share -> combine
-> reconstruct -> unmask) at bulk scale: 1M-dimension gradient vectors from
many participants. Masking on the device uses pads drawn from a
``torch.Generator``; the per-participant pads cancel in the aggregate.
"""

from __future__ import annotations

import numpy as np
import torch

from sda_tpu_torch.engine import TorchAggregationEngine
from sda_tpu_torch.fields import find_special_prime_field
from sda_tpu_torch.ops.modmat import uniform_limbs
from sda_tpu_torch.sharing import AdditiveScheme, PackedShamirScheme

__all__ = ["FederatedAggregation"]


class FederatedAggregation:
    """Secure-aggregation workload for a fixed configuration."""

    def __init__(self, scheme, dimension: int, masked: bool = True, device=None):
        self.scheme = scheme
        self.dimension = dimension
        self.masked = masked
        self.engine = TorchAggregationEngine(scheme.device_spec(), dimension, device=device)

    def forward(self, secrets, generator: torch.Generator):
        """One aggregation step: secrets ``[P, nb, k, L]`` -> revealed sums.

        The device applies masks (participant side), aggregates shares, and
        unmasks with the combined pad (recipient side) — the full protocol
        data flow. Pads and sharing randomness come from ``generator``,
        which must lie on the engine's device.
        """
        ctx, engine = self.engine.ctx, self.engine
        p_count = secrets.shape[0]
        pad_sum = None
        if self.masked:
            pads = uniform_limbs(ctx, generator, tuple(secrets.shape[:-1]))
            secrets = ctx.add_mod(secrets, pads)
            pad_sum = ctx.sum_mod(pads, axis=0)  # recipient-side combine
        rand = uniform_limbs(
            ctx, generator, (p_count, engine.nb, engine.spec.randomness_count)
        )
        out = engine.aggregate(secrets, rand)  # [nb, k, L]
        if pad_sum is not None:
            out = ctx.sub_mod(out, pad_sum)
        return out

    # ---------------------------------------------------------- host edges

    def example_inputs(self, participants: int, seed: int = 0):
        """Secrets below ``min(p, 2^31)`` from ``numpy.random.default_rng(seed)``
        as a limb tensor, and a generator seeded with ``seed``, both on the
        engine's device."""
        rng = np.random.default_rng(seed)
        secrets = rng.integers(
            0, min(self.scheme_modulus, 1 << 31), size=(participants, self.dimension)
        )
        generator = torch.Generator(device=self.engine.device)
        generator.manual_seed(seed)
        return self.engine.encode_secrets(secrets), generator

    @property
    def scheme_modulus(self) -> int:
        return self.engine.spec.modulus

    def reveal(self, out_limbs) -> np.ndarray:
        return self.engine.decode_output(out_limbs)

    # --------------------------------------------------------- constructors

    @classmethod
    def packed_64bit(cls, dimension: int = 1024, committee: int = 8,
                     device=None) -> "FederatedAggregation":
        """64-bit prime field, packed Shamir (3 secrets per batch, privacy
        threshold 4). The production prime is pseudo-Mersenne
        (p = 2^63 - 871, 72 | p-1), so device canonicalisation is
        multiply-free."""
        p, w2, w3 = find_special_prime_field(63, 8, 9)
        scheme = PackedShamirScheme(
            secret_count=3,
            share_count=committee,
            privacy_threshold=4,
            prime_modulus=p,
            omega_secrets=w2,
            omega_shares=w3,
        )
        return cls(scheme, dimension, device=device)

    @classmethod
    def packed_128bit(cls, dimension: int = 10_000, device=None) -> "FederatedAggregation":
        """128-bit modulus, multi-limb arithmetic (pseudo-Mersenne
        p = 2^127 - 1495)."""
        p, w2, w3 = find_special_prime_field(127, 8, 9)
        scheme = PackedShamirScheme(
            secret_count=3,
            share_count=8,
            privacy_threshold=4,
            prime_modulus=p,
            omega_secrets=w2,
            omega_shares=w3,
        )
        return cls(scheme, dimension, device=device)

    @classmethod
    def packed_tss728(cls, dimension: int = 1 << 20, device=None) -> "FederatedAggregation":
        """The packed-sharing example of the threshold-secret-sharing crate
        that sda's ``PackedShamir`` scheme wraps, as published: 100 secrets
        a batch, 728 clerks, privacy threshold 155, p = 746,497 (a 20-bit
        generic prime, p - 1 = 2^10 * 3^6), omega_secrets = 95,660 (order
        256) and omega_shares = 610,121 (order 729). Any 255 of the clerks
        reveal (``engine.reconstruct_planar8(..., clerks=...)``). Unmasked,
        as sda's ``LinearMaskingScheme::None`` allows."""
        scheme = PackedShamirScheme(
            secret_count=100,
            share_count=728,
            privacy_threshold=155,
            prime_modulus=746_497,
            omega_secrets=95_660,
            omega_shares=610_121,
        )
        return cls(scheme, dimension, masked=False, device=device)

    @classmethod
    def additive_small(cls, dimension: int = 10, modulus: int = 433,
                       share_count: int = 3, device=None):
        """The small additive walkthrough shape."""
        return cls(AdditiveScheme(share_count=share_count, modulus=modulus), dimension,
                   device=device)
