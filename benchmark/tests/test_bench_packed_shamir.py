"""The plain packed-Shamir reference (``benchmark/reference/packed_shamir.py``)
at the threshold-secret-sharing crate's packed example: 100 secrets, 728
clerks, threshold 155, p = 746,497."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.packed_shamir import PackedShamir


def test_reference_reconstructs_from_any_threshold():
    ref = PackedShamir(746_497, 100, 728, 155, 95_660, 610_121)
    gen = torch.Generator().manual_seed(11)
    secrets = torch.randint(0, ref.p, (3, ref.k), generator=gen, dtype=torch.int64)
    rand = torch.randint(0, ref.p, (3, ref.t), generator=gen, dtype=torch.int64)
    shares = ref.share(secrets, rand)  # [3, n]
    rng = np.random.default_rng(5)
    for count in (ref.threshold, ref.n):
        idx = sorted(rng.choice(ref.n, count, replace=False).tolist())
        assert torch.equal(ref.reconstruct(shares[:, idx], idx), secrets)
    with pytest.raises(ValueError):
        ref.reconstruct(shares[:, : ref.threshold - 1], list(range(ref.threshold - 1)))
