"""The port's overflow-safe folds at the 63-bit production prime: the twin of
``tests/test_overflow_63bit.py`` on ``sda_tpu_torch``.

At p = 2^63 - 871 two canonical elements can sum past 2^63, so a naive
int64 fold wraps. Each case holds the port against the reference's
python-int oracle and, on the same numpy inputs, against the reference's
own function (``sda_tpu.fields``, ``sda_tpu.masking``, ``sda_tpu.sharing``).

Kept difference the twins adapt to: the port's maskers run on the card by
default, so they are built with ``device="cpu"`` (the host fold), or with a
forced device route on the CPU (``RoutingPolicy.force("device")``) where
the reference's case takes its device route.
"""

import numpy as np
import pytest

from sda_tpu import fields as ref_fields
from sda_tpu import masking as ref_masking
from sda_tpu import sharing as ref_sharing
from sda_tpu_torch.chacha import expand_masks
from sda_tpu_torch.fields import (
    find_special_prime_field,
    positive,
    trunc_add_mod,
    trunc_sub_mod,
)
from sda_tpu_torch.masking import ChaChaMasker, FullMasker
from sda_tpu_torch.routing import RoutingPolicy
from sda_tpu_torch.sharing import AdditiveScheme, PackedShamirScheme
from sda_tpu_torch.utils.errors import Invalid

P63 = (1 << 63) - 871  # find_special_prime_field(63, 8, 9)


def _oracle_trunc(v: int, m: int) -> int:
    r = abs(v) % m
    return r if v >= 0 else -r


@pytest.mark.parametrize("m", [433, (1 << 31) - 1, (1 << 62) + 57, P63])
def test_trunc_add_sub_mod_oracle(m):
    rng = np.random.default_rng(7)
    mags = rng.integers(0, min(m, 1 << 62), size=200, dtype=np.int64) % m
    edge = np.array([0, 1, m - 1, m // 2, m - 2][: min(5, m)], dtype=np.int64)
    a = np.concatenate([mags, edge, -mags, -edge])
    b = np.roll(a, 17)
    got_add, got_sub = trunc_add_mod(a, b, m), trunc_sub_mod(a, b, m)
    assert got_add.tolist() == [_oracle_trunc(int(x) + int(y), m) for x, y in zip(a, b)]
    assert got_sub.tolist() == [_oracle_trunc(int(x) - int(y), m) for x, y in zip(a, b)]
    assert got_add.tolist() == ref_fields.trunc_add_mod(a, b, m).tolist()
    assert got_sub.tolist() == ref_fields.trunc_sub_mod(a, b, m).tolist()


def test_p63_is_the_production_prime():
    assert find_special_prime_field(63, 8, 9) == ref_fields.find_special_prime_field(63, 8, 9)
    assert find_special_prime_field(63, 8, 9)[0] == P63


def test_chacha_masker_63bit_prime():
    """A 4-seed combine at p = 2^63 - 871 against the python-int fold of the
    expansion, and the reveal equals the sum of the secrets."""
    d = 64
    m = ChaChaMasker(modulus=P63, dimension=d, seed_bitsize=128, device="cpu")
    secrets = [np.arange(d, dtype=np.int64) * (i + 1) for i in range(4)]
    seeds, maskeds = zip(*(m.mask(s) for s in secrets))
    combined = m.combine(list(seeds))
    rows = expand_masks([[int(np.uint32(w)) for w in s] for s in seeds], d, P63)
    acc = [0] * d
    for row in rows:
        acc = [_oracle_trunc(a + int(r), P63) for a, r in zip(acc, row)]
    assert combined.tolist() == acc
    assert combined.tolist() == ref_masking.ChaChaMasker(P63, d, 128).combine(list(seeds)).tolist()
    masked_sum = np.zeros(d, dtype=np.int64)
    for mk in maskeds:
        masked_sum = trunc_add_mod(masked_sum, mk, P63)
    out = positive(m.unmask((combined, masked_sum)), P63)
    assert [int(x) for x in out] == [sum(int(s[j]) for s in secrets) % P63 for j in range(d)]


def test_full_masker_63bit_prime():
    d = 32
    m = FullMasker(P63, device="cpu")
    secrets = [np.full(d, (P63 - 1) // 2, dtype=np.int64), np.arange(d, dtype=np.int64)]
    masks, maskeds = zip(*(m.mask(s) for s in secrets))
    assert all(np.asarray(k, dtype=np.int64).max() < P63 for k in masks)
    combined = m.combine(list(masks))
    assert combined.tolist() == ref_masking.FullMasker(P63).combine(list(masks)).tolist()
    out = positive(m.unmask((combined, trunc_add_mod(maskeds[0], maskeds[1], P63))), P63)
    assert [int(x) for x in out] == [(int(secrets[0][j]) + int(secrets[1][j])) % P63
                                     for j in range(d)]


def test_additive_combine_63bit_prime_matches_oracle():
    rng = np.random.default_rng(11)
    vecs = [rng.integers(0, 1 << 62, size=16, dtype=np.int64) % P63 for _ in range(5)]
    got = AdditiveScheme(share_count=3, modulus=P63).combine(vecs)
    acc = [0] * 16
    for v in vecs:
        acc = [_oracle_trunc(a + int(x), P63) for a, x in zip(acc, v)]
    assert got.dtype == np.int64 and got.tolist() == acc
    assert got.tolist() == ref_sharing.AdditiveScheme(share_count=3, modulus=P63).combine(
        vecs).tolist()


def test_packed_combine_63bit_prime_matches_oracle():
    p, w2, w3 = find_special_prime_field(63, 8, 9)
    params = dict(secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=p,
                  omega_secrets=w2, omega_shares=w3)
    rng = np.random.default_rng(13)
    vecs = [rng.integers(0, 1 << 62, size=8, dtype=np.int64) % p for _ in range(4)]
    got = PackedShamirScheme(**params).combine(vecs)
    acc = [0] * 8
    for v in vecs:
        acc = [_oracle_trunc(a + int(x), p) for a, x in zip(acc, v)]
    assert got.tolist() == acc
    assert got.tolist() == ref_sharing.PackedShamirScheme(**params).combine(vecs).tolist()


def test_full_masker_device_combine_parity():
    """The Full-mask combine on the device route (run on the CPU) equals the
    host fold; a dimension mismatch raises on that route too."""
    d, parts = 64, 10
    rng = np.random.default_rng(21)
    masks = [rng.integers(0, 1 << 62, size=d, dtype=np.int64) % P63 for _ in range(parts)]
    host = FullMasker(P63, device="cpu").combine(masks)
    device = FullMasker(P63, routing=RoutingPolicy.force("device"), device="cpu")
    assert device.combine(masks).tolist() == host.tolist()
    assert host.tolist() == ref_masking.FullMasker(P63).combine(masks).tolist()
    with pytest.raises(Invalid):
        device.combine(masks[:3] + [masks[3][:-1]])


def test_combine_fold_hostile_out_of_domain_values():
    """Wire shares outside (-p, p) still combine congruently."""
    got = int(AdditiveScheme(share_count=3, modulus=433).combine(
        [np.array([1 << 62], dtype=np.int64)] * 3)[0])
    assert got % 433 == (3 * (1 << 62)) % 433
    vecs2 = [np.array([(1 << 63) - 5], dtype=np.int64), np.array([7], dtype=np.int64)]
    got2 = AdditiveScheme(share_count=2, modulus=P63).combine(vecs2)
    assert int(got2[0]) % P63 == (((1 << 63) - 5) + 7) % P63
    assert got2.tolist() == ref_sharing.AdditiveScheme(share_count=2, modulus=P63).combine(
        vecs2).tolist()


def test_full_masker_hostile_out_of_domain_masks():
    masks = [np.array([1 << 62], dtype=np.int64)] * 2
    out = FullMasker(433, device="cpu").combine(masks)
    assert int(out[0]) % 433 == (2 * (1 << 62)) % 433
    assert out.tolist() == ref_masking.FullMasker(433).combine(masks).tolist()
