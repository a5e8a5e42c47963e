"""Packed Shamir sharing as the threshold-secret-sharing crate publishes it,
in plain PyTorch int64.

The crate's ``PackedSecretSharing`` has a threshold t, a share count n, a
secret count k, a prime p, ``omega_secrets`` of order m = k + t + 1 and
``omega_shares`` of order n + 1. One batch of k secrets and t random values
fixes the polynomial of degree below m whose values at the powers of
``omega_secrets`` are 0 (at the power 0, the point 1), the secrets (powers
1..k) and the randomness (powers k + 1..k + t); clerk i (from 0) holds its
value at ``omega_shares**(i + 1)``. Any k + t clerks, with the public point
(1, 0), fix the polynomial again, and the secrets are its values at the
powers 1..k of ``omega_secrets``.

Where this departs from the crate, for the tests' sake: the randomness is
handed in (the crate draws it); the sharing is one dense matrix product
(the crate runs an inverse radix-2 FFT, then a radix-3 FFT); the
reconstruction evaluates Lagrange's basis at the secrets' points (the crate
interpolates in Newton's form and evaluates by FFT). Both give the same
values. The prime must be below 2^31, so that every product of two
residues, and a sum of 2^17 of them, stays inside int64. Nothing here
imports the program.
"""

from __future__ import annotations

import torch


def _pow_mod(base: torch.Tensor, exp: torch.Tensor, p: int) -> torch.Tensor:
    """``base ** exp mod p`` elementwise (int64, exp >= 0), by square and
    multiply."""
    base, exp = torch.broadcast_tensors(base % p, exp)
    out, base, exp = torch.ones_like(base), base.clone(), exp.clone()
    while bool((exp > 0).any()):
        out = torch.where(exp & 1 == 1, out * base % p, out)
        base, exp = base * base % p, exp >> 1
    return out


class PackedShamir:
    def __init__(self, p: int, k: int, n: int, t: int, omega_secrets: int, omega_shares: int):
        if p >= 1 << 31:
            raise ValueError("the plain reference takes primes below 2^31")
        self.p, self.k, self.n, self.t = p, k, n, t
        self.m = k + t + 1
        self.w_secrets, self.w_shares = omega_secrets, omega_shares
        if pow(omega_secrets, self.m, p) != 1 or pow(omega_shares, n + 1, p) != 1:
            raise ValueError("the roots' orders do not divide k + t + 1 and n + 1")
        i = torch.arange(self.m, dtype=torch.int64)
        # values at omega_secrets^j -> coefficients: m^-1 omega_secrets^(-ij)
        inv_w = pow(omega_secrets, p - 2, p)
        to_coef = _pow_mod(torch.tensor(inv_w), i[:, None] * i[None, :], p)
        # coefficients -> values at the clerks' points omega_shares^(c + 1)
        xs = _pow_mod(torch.tensor(omega_shares), torch.arange(1, n + 1, dtype=torch.int64), p)
        to_shares = _pow_mod(xs[None, :], i[:, None], p)  # [m, n]
        self.share_matrix = (to_coef @ to_shares) % p * pow(self.m, p - 2, p) % p  # [m, n]

    @property
    def threshold(self) -> int:
        """Clerks that reconstruct: k + t (the point (1, 0) is public)."""
        return self.k + self.t

    def share(self, secrets: torch.Tensor, randomness: torch.Tensor) -> torch.Tensor:
        """``[B, k]`` secrets and ``[B, t]`` randomness (canonical) ->
        ``[B, n]`` shares, clerk i in column i."""
        zero = torch.zeros((secrets.shape[0], 1), dtype=torch.int64)
        values = torch.cat([zero, secrets.to(torch.int64), randomness.to(torch.int64)], dim=1)
        return values @ self.share_matrix % self.p

    def lagrange(self, indices) -> torch.Tensor:
        """``[s, k]``: secrets = shares of the clerks ``indices`` @ this."""
        indices = [int(i) for i in indices]
        if len(set(indices)) != len(indices) or not all(0 <= i < self.n for i in indices):
            raise ValueError("clerk indices must be distinct and below n")
        if len(indices) < self.threshold:
            raise ValueError(f"{len(indices)} clerks; reconstruction takes {self.threshold}")
        p = self.p
        exps = torch.tensor([0] + [i + 1 for i in indices], dtype=torch.int64)
        xs = _pow_mod(torch.tensor(self.w_shares), exps, p)  # the public point 1 first
        ys = _pow_mod(torch.tensor(self.w_secrets), torch.arange(1, self.k + 1), p)
        diff = (xs[:, None] - xs[None, :]) % p
        diff.fill_diagonal_(1)
        yx = (ys[None, :] - xs[:, None]) % p  # [s + 1, k], never 0: the roots' orders are coprime
        den = torch.ones_like(xs)
        for j in range(len(xs)):
            den = den * diff[:, j] % p
        num = torch.ones_like(ys)
        for j in range(len(xs)):
            num = num * yx[j] % p
        basis = num[None, :] * _pow_mod(yx * den[:, None] % p, torch.tensor(p - 2), p) % p
        return basis[1:]  # the public point's value is 0

    def reconstruct(self, shares: torch.Tensor, indices) -> torch.Tensor:
        """``[B, s]`` shares of the clerks ``indices`` -> ``[B, k]`` secrets."""
        return shares.to(torch.int64) @ self.lagrange(indices) % self.p
