"""Number-theoretic transforms over prime fields (host side).

A copy of the reference package's ``ntt`` module, kept so that the port
imports nothing of it. The packed-Shamir scheme needs two transforms (the
p=433 parameter vector of the upstream full-loop test):

- a radix-2-smooth transform of size ``m = secret_count + threshold + 1``
  (root ``omega_secrets``), used inverse to interpolate the sharing
  polynomial, and
- a radix-3-smooth transform of size ``n = share_count + 1`` (root
  ``omega_shares``), used forward to evaluate it at the share points.

This module provides exact host implementations (mixed radix-2/3
Cooley-Tukey with an O(n^2) fallback for other factors) plus Vandermonde
matrix builders. The device path collapses the whole linear pipeline into
a single modular matmul (see :mod:`sda_tpu_torch.sharing` and
:mod:`sda_tpu_torch.ops`), because per-batch transform sizes are tiny
while the batch axis is huge.
"""

from __future__ import annotations

import numpy as np

from sda_tpu_torch.fields import PrimeField

__all__ = ["ntt", "intt", "ntt_matrix", "intt_matrix"]


def _powers(field: PrimeField, base: int, count: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(count-1)] in canonical form."""
    out = [1] * count
    for i in range(1, count):
        out[i] = (out[i - 1] * base) % field.p
    return np.array(out, dtype=field.dtype)


def ntt(field: PrimeField, coeffs: np.ndarray, omega: int) -> np.ndarray:
    """Evaluate polynomial(s) at the powers of ``omega`` (last axis).

    ``out[..., j] = sum_i coeffs[..., i] * omega**(i*j) mod p`` where the
    transform size ``n`` is the length of the last axis; ``omega`` must have
    multiplicative order ``n``.
    """
    coeffs = field.asarray(coeffs)
    n = coeffs.shape[-1]
    if n == 1:
        return coeffs.copy()
    if n % 2 == 0:
        return _ct_step(field, coeffs, omega, radix=2)
    if n % 3 == 0:
        return _ct_step(field, coeffs, omega, radix=3)
    # O(n^2) fallback: direct Vandermonde product
    return field.matmul(coeffs, ntt_matrix(field, omega, n))


def _ct_step(field: PrimeField, coeffs: np.ndarray, omega: int, radix: int) -> np.ndarray:
    """One decimation-in-time Cooley-Tukey step for the given radix."""
    n = coeffs.shape[-1]
    sub = n // radix
    omega_sub = pow(int(omega), radix, field.p)
    parts = [ntt(field, coeffs[..., r::radix], omega_sub) for r in range(radix)]
    ksub = np.arange(n) % sub
    acc = parts[0][..., ksub]
    for r in range(1, radix):
        # twiddle for term r at output k is omega^(r*k)
        twiddle = _powers(field, pow(int(omega), r, field.p), n)
        acc = field.add(acc, field.mul(parts[r][..., ksub], twiddle))
    return acc


def intt(field: PrimeField, evals: np.ndarray, omega: int) -> np.ndarray:
    """Inverse transform: recover coefficients from evaluations.

    ``out[..., i] = (1/n) * sum_j evals[..., j] * omega**(-i*j) mod p``.
    """
    evals = field.asarray(evals)
    n = evals.shape[-1]
    omega_inv = pow(int(omega), -1, field.p)
    n_inv = pow(n, -1, field.p)
    raw = ntt(field, evals, omega_inv)
    return field.mul(raw, np.full((), n_inv, dtype=field.dtype))


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
