"""The frozen reference agrees with ChaCha20's published block vector and
with ``sda_tpu_torch`` at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.reference import chacha20
from benchmark.reference.field import ChunkSums

P63 = 2**63 - 871
P127 = 2**127 - 1495


def test_block_function_rfc7539_2_3_2():
    key = [int.from_bytes(bytes(range(4 * i, 4 * i + 4)), "little") for i in range(8)]
    state = list(chacha20.CONSTANTS) + key + [1, 0x09000000, 0x4A000000, 0x00000000]
    out = chacha20.block_function([torch.tensor([w], dtype=torch.int64) for w in state])
    want = [0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3, 0xC7F4D1C7, 0x0368C033,
            0x9AAA2204, 0x4E6CD4C3, 0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
            0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2]
    assert [int(w) for w in out] == want


@pytest.mark.parametrize("modulus", [P63, 2**62 + 1, 433])
@pytest.mark.parametrize("dimension", [1, 37])
def test_combined_mask_matches_the_port(modulus, dimension):
    """The port's host oracle skips rejected draws too; 2**62 + 1 rejects
    about a quarter of them."""
    from sda_tpu_torch import chacha

    rng = np.random.default_rng(modulus % 1000 + dimension)
    seeds = rng.integers(0, 1 << 32, size=(5, 4), dtype=np.int64)
    masks = chacha.expand_masks([s.tolist() for s in seeds], dimension, modulus)
    want = [sum(int(m[j]) for m in masks) % modulus for j in range(dimension)]
    got = chacha20.combined_mask(seeds, dimension, modulus, "cpu", batch=16)
    assert got.tolist() == want


def test_control_reads_wrong():
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 1 << 32, size=(8, 4), dtype=np.int64)
    exact = chacha20.combined_mask(seeds, 40, P63, "cpu")
    low = chacha20.combined_mask(seeds, 40, P63, "cpu", precision="float64")
    assert sum(int(a) != b for a, b in zip(exact, low.tolist())) > 30


@pytest.mark.parametrize("modulus,limbs", [(P63, 4), (P127, 8)])
def test_chunk_sums_match_python_ints(modulus, limbs):
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 1 << 16, (9, 6, limbs), generator=g, dtype=torch.int64)
    sums = ChunkSums()
    sums.add(x[:4])
    sums.add(x[4:])
    values = [[sum(int(x[p, j, i]) << (16 * i) for i in range(limbs)) for j in range(6)]
              for p in range(9)]
    want = [sum(v[j] for v in values) % modulus for j in range(6)]
    assert sums.total(modulus).tolist() == want


def test_chunk_sums_match_the_port_device_combine():
    from sda_tpu_torch.engine import device_combine

    g = torch.Generator().manual_seed(9)
    x = torch.randint(0, 1 << 16, (7, 11, 4), generator=g, dtype=torch.int64)
    x[..., 3] &= (1 << 14) - 1
    values = (x * torch.tensor([1, 1 << 16, 1 << 32, 1 << 48])).sum(-1)
    sums = ChunkSums()
    sums.add(x)
    got = sums.total(P63).tolist()
    assert got == device_combine(P63, list(values.numpy()), device="cpu").tolist()
