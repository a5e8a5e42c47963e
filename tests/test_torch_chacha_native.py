"""The port's native ChaCha expansion (``sda_tpu_torch.chacha.expand_masks``
through ``native/chacha.cpp``) against the reference's ``sda_tpu.chacha``.

- at moduli 433, 12345, 2^61 - 1, 2^62 + 1 (about 1/4 of the draws
  rejected) and 2^63 - 871, the native route, the numpy route (the library
  unloaded, and ``_expand_masks_numpy`` itself) and the reference give the
  same masks for the same seeded seeds;
- seeds of mixed lengths, an empty seed list and ``dimension == 0`` take
  numpy, as the reference's guards send them;
- ``chacha.expansions`` counts the route each call took;
- ``ChaChaMasker(..., device="cpu").combine`` (the host fold, now native)
  equals the reference masker's.
"""

import numpy as np
import pytest

import sda_tpu.chacha as ref_chacha
from sda_tpu.masking import ChaChaMasker as RefChaChaMasker
from sda_tpu_torch import chacha
from sda_tpu_torch.masking import ChaChaMasker
from sda_tpu_torch.utils import varint

MODULI = [433, 12345, (1 << 61) - 1, (1 << 62) + 1, (1 << 63) - 871]
D = 40


@pytest.fixture
def native():
    if varint.native_library() is None:
        pytest.fail("the native library did not build: no C++ compiler or a build error")
    return varint.native_library()


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(varint, "_NATIVE", None)


def _seeds(n: int, seed: int, bits: int = 128):
    rng = np.random.default_rng(seed)
    return [chacha.new_seed(bits, rng) for _ in range(n)]


def _routes(fn):
    before = dict(chacha.expansions)
    out = fn()
    return out, {k: chacha.expansions[k] - before[k] for k in before}


@pytest.mark.parametrize("modulus", MODULI)
def test_native_and_numpy_equal_the_reference(native, modulus, monkeypatch):
    seeds = _seeds(3, modulus % 1000)
    want = ref_chacha.expand_masks(seeds, D, modulus)
    got, routes = _routes(lambda: chacha.expand_masks(seeds, D, modulus))
    assert routes == {"native": 1, "numpy": 0}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(chacha._expand_masks_numpy(seeds, D, modulus), want)
    monkeypatch.setattr(varint, "_NATIVE", None)
    got, routes = _routes(lambda: chacha.expand_masks(seeds, D, modulus))
    assert routes == {"native": 0, "numpy": 1}
    np.testing.assert_array_equal(got, want)


def test_forced_rejection_modulus_rejects_a_quarter(native):
    """At 2^62 + 1 about 1/4 of the raw draws fall in the rejection zone, so
    every seed takes numpy's scalar path, and native skips inline."""
    modulus = (1 << 62) + 1
    seeds = _seeds(4, 5)
    zone = (1 << 64) - 1 - ((1 << 64) - 1) % modulus
    share = float((chacha._raw_draws(seeds, 4096) >= np.uint64(zone)).mean())
    assert 0.2 < share < 0.3
    np.testing.assert_array_equal(chacha.expand_masks(seeds, 256, modulus),
                                  chacha._expand_masks_numpy(seeds, 256, modulus))


def test_guards_send_other_inputs_to_numpy(native):
    mixed = _seeds(2, 1, bits=128) + _seeds(1, 2, bits=64)
    got, routes = _routes(lambda: chacha.expand_masks(mixed, D, 433))
    assert routes == {"native": 0, "numpy": 1}
    np.testing.assert_array_equal(got, ref_chacha.expand_masks(mixed, D, 433))
    for seeds, dim in (([], D), (_seeds(2, 3), 0)):
        got, routes = _routes(lambda: chacha.expand_masks(seeds, dim, 433))
        assert routes == {"native": 0, "numpy": 1}
        assert got.shape == (len(seeds), dim) and got.dtype == np.int64


def test_masker_host_fold_matches_the_reference(native):
    modulus, dim, n = (1 << 63) - 871, 64, 5
    rng = np.random.default_rng(9)
    seeds = [np.array(chacha.new_seed(128, rng), dtype=np.int64) for _ in range(n)]
    got, routes = _routes(lambda: ChaChaMasker(modulus, dim, 128, device="cpu").combine(seeds))
    assert routes == {"native": 1, "numpy": 0}
    want = RefChaChaMasker(modulus, dim, 128).combine(seeds)
    np.testing.assert_array_equal(got, want)


def test_masker_host_fold_without_the_library(no_native):
    seeds = [np.array(w, dtype=np.int64) for w in _seeds(4, 11)]
    got, routes = _routes(lambda: ChaChaMasker(433, D, 128, device="cpu").combine(seeds))
    assert routes == {"native": 0, "numpy": 1}
    np.testing.assert_array_equal(got, RefChaChaMasker(433, D, 128).combine(seeds))
