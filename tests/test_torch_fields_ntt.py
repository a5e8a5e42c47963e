"""The port's whole ``fields`` and ``ntt`` surface against sda_tpu's.

``PrimeField.sub``, ``neg``, ``pow``, ``inv``, ``sum`` and
``element_order``, the module's ``element_order``, and ``ntt``, ``intt``
and ``_ct_step`` take the same numpy inputs in both packages and must give
equal values, on the vectors of ``tests/test_fields.py`` and
``tests/test_ntt.py``: p = 433 with ord(354) = 8 and ord(150) = 9, the
89-bit Mersenne prime, and the primes ``find_prime_field`` derives.
"""

import numpy as np
import pytest

from sda_tpu import fields as ref_fields
from sda_tpu import ntt as ref_ntt
from sda_tpu_torch import fields, ntt

P89 = (1 << 89) - 1


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert [int(x) for x in got.reshape(-1)] == [int(x) for x in want.reshape(-1)]


@pytest.mark.parametrize("p", [433, P89, 2**61 - 1])
def test_field_ops_match_reference(p):
    rng = np.random.default_rng(p % 1000)
    port, ref = fields.PrimeField(p), ref_fields.PrimeField(p)
    a = ref.sample((5, 7), rng=rng)
    b = ref.sample((5, 7), rng=rng)
    _equal(port.sub(a, b), ref.sub(a, b))
    _equal(port.neg(a), ref.neg(a))
    _equal(port.pow(a, 5), ref.pow(a, 5))
    _equal(port.pow(a, p - 2), ref.pow(a, p - 2))
    nonzero = np.where(np.asarray(a) == 0, 1, a).astype(a.dtype)
    _equal(port.inv(nonzero), ref.inv(nonzero))
    assert port.inv(np.asarray(3)) == ref.inv(np.asarray(3))
    assert port.pow(np.asarray(7), 10**20) == ref.pow(np.asarray(7), 10**20)
    assert port.pow(np.asarray(7), -3) == ref.pow(np.asarray(7), -3)
    for axis in (None, 0, 1):
        _equal(port.sum(a, axis=axis), ref.sum(a, axis=axis))


def test_small_field_vector():
    """tests/test_fields.py's p = 433 vector."""
    f = fields.PrimeField(433)
    a = np.array([0, 1, 432, 200])
    b = np.array([432, 432, 432, 300])
    assert f.sub(a, b).tolist() == [1, 2, 0, 333]
    assert f.neg(a).tolist() == [0, 432, 1, 233]
    assert f.inv(np.array([2]))[0] == 217  # 2*217 = 434 = 1 mod 433


@pytest.mark.parametrize("x,p,order", [(354, 433, 8), (150, 433, 9), (1, 433, 1),
                                       (432, 433, 2), (5, 433, None), (3, P89, None)])
def test_element_order_matches_reference(x, p, order):
    got = fields.element_order(x, p)
    assert got == ref_fields.element_order(x, p) == fields.PrimeField(p).element_order(x)
    if order is not None:
        assert got == order


def test_find_prime_field_roots_have_their_order():
    p, w2, w3 = fields.find_prime_field(62, 16, 27)
    assert (p, w2, w3) == ref_fields.find_prime_field(62, 16, 27)
    assert fields.element_order(w2, p) == 16 and fields.element_order(w3, p) == 27


# ------------------------------------------------------------------- ntt


def _ntt_field(kind):
    if kind in ("p11", "p433"):
        return int(kind[1:])
    return ref_fields.find_prime_field(20 if kind == "p20" else 70, 16, 27)[0]


@pytest.mark.parametrize("kind,n", [("p433", 8), ("p433", 9), ("p20", 16), ("p20", 27),
                                    ("p20", 24), ("p11", 5), ("p11", 10), ("p70", 8),
                                    ("p70", 9)])
def test_ntt_intt_match_reference(kind, n):
    """``ntt`` (radix 2 and 3 Cooley-Tukey steps, the Vandermonde fallback
    at n = 5, alone and under a radix-2 step) and ``intt`` equal the reference's, and round-trip."""
    p = _ntt_field(kind)
    ref_f, port_f = ref_fields.PrimeField(p), fields.PrimeField(p)
    w = ref_f.find_element_of_order(n)
    coeffs = ref_f.sample((4, n), rng=np.random.default_rng(n))
    evals = ntt.ntt(port_f, coeffs, w)
    _equal(evals, ref_ntt.ntt(ref_f, coeffs, w))
    _equal(ntt.intt(port_f, evals, w), ref_ntt.intt(ref_f, evals, w))
    _equal(ntt.intt(port_f, evals, w), coeffs)
    _equal(evals, port_f.matmul(coeffs, ntt.ntt_matrix(port_f, w, n)))


@pytest.mark.parametrize("radix,n", [(2, 8), (3, 9), (2, 24), (3, 27)])
def test_ct_step_matches_reference(radix, n):
    p = _ntt_field("p20")
    ref_f, port_f = ref_fields.PrimeField(p), fields.PrimeField(p)
    w = ref_f.find_element_of_order(n)
    coeffs = ref_f.sample((3, n), rng=np.random.default_rng(radix * n))
    _equal(ntt._ct_step(port_f, coeffs, w, radix), ref_ntt._ct_step(ref_f, coeffs, w, radix))


def test_ntt_evaluates_polynomial():
    """tests/test_ntt.py's direct evaluation at p = 433, omega = 354."""
    f = fields.PrimeField(433)
    coeffs = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    evals = ntt.ntt(f, coeffs, 354)
    for j in range(8):
        x = pow(354, j, 433)
        assert int(evals[j]) == sum(int(c) * pow(x, i, 433) for i, c in enumerate(coeffs)) % 433
