"""Number-theoretic transform matrices over prime fields (host side).

A copy of the matrix builders of the reference package's ``ntt`` module,
kept so that the port imports nothing of it. The packed-Shamir scheme needs
two transforms (the p=433 parameter vector of the upstream full-loop test):

- a radix-2-smooth transform of size ``m = secret_count + threshold + 1``
  (root ``omega_secrets``), used inverse to interpolate the sharing
  polynomial, and
- a radix-3-smooth transform of size ``n = share_count + 1`` (root
  ``omega_shares``), used forward to evaluate it at the share points.

This module provides the exact host Vandermonde matrix builders. The device
path collapses the whole linear pipeline into a single modular matmul (see
:mod:`sda_tpu_torch.sharing` and :mod:`sda_tpu_torch.ops`), because
per-batch transform sizes are tiny while the batch axis is huge.
"""

from __future__ import annotations

import numpy as np

from sda_tpu_torch.fields import PrimeField

__all__ = ["ntt_matrix", "intt_matrix"]


def _powers(field: PrimeField, base: int, count: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(count-1)] in canonical form."""
    out = [1] * count
    for i in range(1, count):
        out[i] = (out[i - 1] * base) % field.p
    return np.array(out, dtype=field.dtype)


def ntt_matrix(field: PrimeField, omega: int, n: int) -> np.ndarray:
    """Vandermonde matrix ``V[i, j] = omega^(i*j)`` (coeffs @ V = evals)."""
    out = np.empty((n, n), dtype=field.dtype)
    for r in range(n):
        out[r] = _powers(field, pow(int(omega), r, field.p), n)
    return out


def intt_matrix(field: PrimeField, omega: int, n: int) -> np.ndarray:
    """Inverse Vandermonde: ``W[j, i] = omega^(-i*j)/n`` (evals @ W = coeffs)."""
    omega_inv = pow(int(omega), -1, field.p)
    n_inv = pow(n, -1, field.p)
    v = ntt_matrix(field, omega_inv, n)
    return field.mul(v, np.full((), n_inv, dtype=field.dtype))
