"""Secret-sharing schemes: additive and packed Shamir (host protocol layer).

A copy of the reference package's ``sharing`` module, kept so that the port
imports nothing of it. Capabilities mirrored from the upstream Rust client:

- additive sharing with Rust signed-remainder semantics;
- packed Shamir via two NTTs, compatible with the external
  ``threshold-secret-sharing`` crate's parameterisation, with the verified
  p=433 / k=3 / n=8 / t=4 parameter vector;
- dimension batching with tail zero-padding and output truncation;
- the shared modular-sum combiner.

Device formulation
------------------

Everything in this module is linear over F_p, so the device path collapses
into batched modular matmuls with precomputed matrices:

- ``shares[B, n]   = ext_values[B, m] @ share_matrix[m, n]``
- ``secrets[B, k]  = shares[B, s] @ reconstruct_matrix(indices)[s, k]``

where ``m = threshold + secret_count + 1`` holds ``[0, secrets, randomness]``
in the omega_secrets evaluation domain, and the share matrix composes
(inverse radix-2 NTT) -> (zero-pad) -> (forward radix-3 NTT) -> (drop the
point-1 column). The scheme fixes the polynomial's value at point 1 to zero,
which is why reconstruction needs only ``threshold + secret_count`` real
shares — the point ``(1, 0)`` is public and linearity preserves it under
aggregation.

This module computes those matrices host-side (exact python ints); the
device code in :mod:`sda_tpu_torch.ops` consumes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from sda_tpu_torch.fields import PrimeField, trunc_add_mod, trunc_mod
from sda_tpu_torch.ntt import intt_matrix, ntt_matrix
from sda_tpu_torch.utils.errors import Invalid

__all__ = ["AdditiveScheme", "PackedShamirScheme", "DeviceSchemeSpec", "lagrange_matrix"]


def _combine_fold(share_vectors, modulus: int) -> np.ndarray:
    """Clerk-side combine: sequential signed fold of combiner.rs:20-27.

    For shares in the protocol's trunc domain ``(-m, m)`` — everything an
    honest participant produces — the wire-level representative matches
    the reference bit-for-bit. Out-of-domain i64 values (hostile wire)
    are pre-reduced before folding, which preserves congruence mod m but
    may pick a different representative than Rust's wrapping fold would
    for the same adversarial bytes. Exact in int64 for any
    ``modulus < 2**63`` via :func:`sda_tpu_torch.fields.trunc_add_mod` (a plain
    int64 fold wraps at 63-bit production primes); >63-bit moduli fall
    back to python-int (object) arithmetic.
    """
    share_vectors = list(share_vectors)
    if not share_vectors:
        return np.zeros(0, dtype=np.int64)
    d = len(share_vectors[0])
    if modulus < (1 << 63):
        acc = np.zeros(d, dtype=np.int64)
        for sv in share_vectors:
            if len(sv) != d:
                raise Invalid("Wrong dimension")
            sv = np.asarray(sv, dtype=np.int64)
            # trunc_add_mod's exactness needs |values| < m; wire shares can
            # carry any i64 a hostile participant encodes, so pre-reduce
            # out-of-domain vectors (congruence-preserving; honest inputs
            # never pay this)
            if sv.size and not (
                int(sv.min()) > -modulus and int(sv.max()) < modulus
            ):
                sv = trunc_mod(np.asarray(sv, dtype=object), modulus).astype(
                    np.int64
                )
            acc = trunc_add_mod(acc, sv, modulus)
        return acc
    acc = np.zeros(d, dtype=object)
    for sv in share_vectors:
        if len(sv) != d:
            raise Invalid("Wrong dimension")
        acc = trunc_mod(acc + np.asarray(sv, dtype=object), modulus)
    return acc


@dataclass(frozen=True)
class DeviceSchemeSpec:
    """Everything the device engine needs about a sharing scheme.

    Both schemes are linear, so both reduce to the same two matrices over
    F_p (used by :mod:`sda_tpu_torch.engine` in limb/Montgomery form):

    - ``shares[B, n] = concat(secrets[B, k], randomness[B, r]) @ share_matrix``
    - ``secrets[B, k] = shares[B, n] @ reconstruct_matrix``  (all-shares path)

    Packed Shamir also carries its two roots, so that the device can
    reconstruct from any ``k + r`` of the ``n`` clerks
    (:meth:`subset_matrix`); the additive scheme needs every share.
    """

    modulus: int
    secret_count: int  # k: secrets packed per batch row
    share_count: int  # n: one share per committee clerk
    randomness_count: int  # r: fresh uniform elements per batch row
    share_matrix: np.ndarray  # [k + r, n] object/int64 canonical
    reconstruct_matrix: np.ndarray  # [n, k]
    omega_secrets: int | None = None  # packed Shamir: the secrets' root
    omega_shares: int | None = None  # ... and the shares' root

    def subset_matrix(self, indices) -> np.ndarray:
        """``L[s, k]`` with ``secrets = shares[indices] @ L``: packed
        Shamir's Lagrange matrix for the clerks ``indices``, any
        ``k + r`` or more of them (:func:`lagrange_matrix`)."""
        if self.omega_shares is None:
            raise Invalid("the scheme reconstructs from every share only")
        return lagrange_matrix(self.modulus, self.omega_secrets, self.omega_shares,
                               self.secret_count, self.secret_count + self.randomness_count,
                               indices)


def _lagrange_basis(p: int, xs, ys) -> np.ndarray:
    """``[len(xs), len(ys)]`` object ints: the Lagrange basis polynomial of
    each point of ``xs`` evaluated at each of ``ys``, mod p."""
    cols = []
    for y in ys:
        col = []
        for i in range(len(xs)):
            num, den = 1, 1
            for j in range(len(xs)):
                if i == j:
                    continue
                num = num * ((y - xs[j]) % p) % p
                den = den * ((xs[i] - xs[j]) % p) % p
            col.append(num * pow(den, -1, p) % p)
        cols.append(col)
    return np.array(cols, dtype=object).T


def _prod_mod(a: np.ndarray, p: int) -> np.ndarray:
    """Product mod p over the last axis of canonical int64 ``a`` (p < 2^31)."""
    out = np.ones(a.shape[:-1], dtype=np.int64)
    for j in range(a.shape[-1]):
        out = out * a[..., j] % p
    return out


def _inv_mod(a: np.ndarray, p: int) -> np.ndarray:
    """Elementwise inverse mod prime p of nonzero canonical int64 ``a`` (p <
    2^31): ``a^(p-2)`` by square and multiply."""
    out, base, e = np.ones_like(a), a % p, p - 2
    while e:
        if e & 1:
            out = out * base % p
        base = base * base % p
        e >>= 1
    return out


def lagrange_matrix(modulus: int, omega_secrets: int, omega_shares: int, secret_count: int,
                    threshold: int, indices) -> np.ndarray:
    """Packed Shamir's Lagrange matrix ``L[s, k]`` for the clerks
    ``indices`` (``secrets = shares[indices] @ L``), any ``threshold`` or
    more of them: canonical, in vectorised int64 for a prime below 2^31
    (every product of two residues below 2^62), object ints above.

    Interpolation points ``x_0 = 1`` (the public zero) and ``x_i =
    omega_shares**(index_i + 1)``; the basis at ``y_e = omega_secrets**e``
    is ``prod_j (y_e - x_j) / ((y_e - x_i) prod_{j != i} (x_i - x_j))``,
    the first factor shared by every point."""
    indices = [int(i) for i in indices]
    if len(set(indices)) != len(indices):
        raise Invalid("duplicate share indices")
    if len(indices) < threshold:
        raise Invalid("Not enough shares to reconstruct")
    p = int(modulus)
    xs = np.array([1] + [pow(int(omega_shares), i + 1, p) for i in indices], dtype=object)
    ys = np.array([pow(int(omega_secrets), e, p) for e in range(1, secret_count + 1)],
                  dtype=object)
    yx = (ys[None, :] - xs[:, None]) % p  # [s + 1, k]
    if p >= (1 << 31) or not yx.all():
        # wide fields, or a secret point among the shares' points
        return PrimeField(p).asarray(_lagrange_basis(p, list(xs), list(ys))[1:, :])
    xs, yx = xs.astype(np.int64), yx.astype(np.int64)
    diff = (xs[:, None] - xs[None, :]) % p
    np.fill_diagonal(diff, 1)
    den = _prod_mod(diff, p)  # [s + 1]
    num = _prod_mod(yx.T, p)  # [k]: prod over every point
    lag = num[None, :] * _inv_mod(yx * den[:, None] % p, p) % p
    # drop the row of the public point (value 0): rows 1.. map the shares
    return lag[1:]


# --------------------------------------------------------------------------
# Additive sharing
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AdditiveScheme:
    """n-out-of-n additive sharing over Z_m.

    ``share_count - 1`` uniform shares plus a correction share; reconstruction
    is the modular sum of all shares. Shares are signed i64 representatives in
    ``(-m, m)`` exactly like the reference (the correction share may be
    negative, additive.rs:47).
    """

    share_count: int
    modulus: int

    @property
    def input_size(self) -> int:
        return 1

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def privacy_threshold(self) -> int:
        return self.share_count - 1

    @property
    def reconstruction_threshold(self) -> int:
        return self.share_count

    def share_vector(self, secrets, rng: np.random.Generator | None = None) -> np.ndarray:
        """Share a d-dim vector: returns ``[share_count, d]`` (one row per clerk).

        Row j is the per-clerk share vector the reference's batching layer
        produces (batched.rs:46-49; each "batch" is a single element here).
        """
        f = PrimeField(self.modulus)
        secrets = np.asarray(secrets, dtype=f.dtype)
        d = secrets.shape[0]
        shares = f.sample((self.share_count - 1, d), rng=rng)
        if f.small:
            total = shares.sum(axis=0, dtype=np.int64)
        else:
            total = np.sum(np.asarray(shares, dtype=object), axis=0)
        last = trunc_mod(secrets - total, self.modulus)
        return np.concatenate([shares, last[None, :]], axis=0)

    def combine(self, share_vectors) -> np.ndarray:
        """Clerk-side combine: element-wise modular sum across participants.

        Reproduces the sequential signed fold of combiner.rs:20-27 so the
        wire-level representative matches the reference bit-for-bit for
        in-domain shares (see :func:`_combine_fold` for the hostile-wire
        caveat).
        """
        return _combine_fold(share_vectors, self.modulus)

    def reconstruct(self, indexed_shares, dimension: int | None = None) -> np.ndarray:
        """Recipient-side reconstruction: modular sum over clerk vectors.

        ``indexed_shares``: list of ``(clerk_index, per_clerk_vector)``;
        indices are ignored for the additive scheme (additive.rs:55-73).
        """
        vectors = [np.asarray(v) for _, v in indexed_shares]
        return self.combine(vectors)

    def device_spec(self) -> DeviceSchemeSpec:
        """Additive sharing as the unified linear form.

        ``ext = [secret, r_1..r_{n-1}]``; share j < n-1 is ``r_j`` and the
        last share is ``secret - sum(r_j)`` (additive.rs:42-48), i.e. a
        ``[n, n]`` permutation-like matrix with a final ``-1`` column.
        """
        n = self.share_count
        f = PrimeField(self.modulus)
        mat = np.zeros((n, n), dtype=f.dtype)
        mat[0, n - 1] = 1  # secret flows into the last share
        for j in range(1, n):
            mat[j, j - 1] = 1  # randomness r_j is share j-1
            mat[j, n - 1] = self.modulus - 1  # ... and subtracts from the last
        rec = np.ones((n, 1), dtype=f.dtype)  # reconstruction = plain sum
        return DeviceSchemeSpec(
            modulus=self.modulus,
            secret_count=1,
            share_count=n,
            randomness_count=n - 1,
            share_matrix=f.asarray(mat),
            reconstruct_matrix=f.asarray(rec),
        )


# --------------------------------------------------------------------------
# Packed Shamir sharing
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PackedShamirScheme:
    """Packed Shamir sharing via a two-NTT linear pipeline.

    Parameters follow the upstream protocol's scheme descriptor:
    ``secret_count`` values are packed per polynomial; ``omega_secrets`` has
    order ``secret_count + privacy_threshold + 1`` (radix-2 smooth) and
    ``omega_shares`` order ``share_count + 1`` (radix-3 smooth).
    """

    secret_count: int
    share_count: int
    privacy_threshold: int
    prime_modulus: int
    omega_secrets: int
    omega_shares: int

    def __post_init__(self):
        f = self.field
        m, n1 = self.m, self.share_count + 1
        if pow(int(self.omega_secrets), m, f.p) != 1:
            raise Invalid("omega_secrets order does not divide secret_count+threshold+1")
        if pow(int(self.omega_shares), n1, f.p) != 1:
            raise Invalid("omega_shares order does not divide share_count+1")

    @property
    def field(self) -> PrimeField:
        return PrimeField(self.prime_modulus)

    @property
    def m(self) -> int:
        """Size of the secrets-domain transform: threshold + secret_count + 1."""
        return self.privacy_threshold + self.secret_count + 1

    @property
    def input_size(self) -> int:
        return self.secret_count

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def reconstruction_threshold(self) -> int:
        """Minimum shares to reconstruct (crypto.rs:151): t + k.

        One fewer than the polynomial's ``degree+1`` because every sharing
        fixes the public point ``(1, 0)``.
        """
        return self.privacy_threshold + self.secret_count

    # ------------------------------------------------------------ matrices

    @cached_property
    def share_matrix(self) -> np.ndarray:
        """``M[m, share_count]`` with ``shares = ext_values @ M``.

        ``ext_values[B, m] = [0 | secrets(k) | randomness(t)]`` laid out in the
        omega_secrets evaluation domain.  M composes: inverse NTT (size m,
        omega_secrets) -> zero-pad coefficients to n+1 -> forward NTT (size
        n+1, omega_shares) -> drop evaluation at point 1 (column 0).
        """
        f = self.field
        m, n1 = self.m, self.share_count + 1
        w_inv = intt_matrix(f, self.omega_secrets, m)          # [m, m] evals->coeffs
        v3 = ntt_matrix(f, self.omega_shares, n1)              # [n1, n1] coeffs->evals
        mat = f.matmul(w_inv, v3[:m, :])                       # [m, n1]
        return mat[:, 1:]                                      # drop point-1 column

    @cached_property
    def full_reconstruct_matrix(self) -> np.ndarray:
        """``R[share_count, secret_count]`` for the all-shares fast path.

        With every share present, reconstruction is linear: prepend the public
        zero at point 1, inverse radix-3 NTT to coefficients, truncate to m
        (degree bound), forward radix-2 NTT, read secrets at positions 1..k.
        Row 0 of the inverse matrix multiplies the public zero so it drops out.
        """
        f = self.field
        m, n1 = self.m, self.share_count + 1
        w3_inv = intt_matrix(f, self.omega_shares, n1)         # [n1, n1] evals->coeffs
        v2 = ntt_matrix(f, self.omega_secrets, m)              # [m, m] coeffs->evals
        mat = f.matmul(w3_inv[:, :m], v2)                      # [n1, m]
        return mat[1:, 1 : self.secret_count + 1]              # [n, k]

    def reconstruct_matrix(self, indices) -> np.ndarray:
        """Lagrange matrix ``L[s, k]`` for an arbitrary share subset.

        ``secrets = shares[indices] @ L``. Points are
        ``x_i = omega_shares**(index_i + 1)`` plus the public point ``(1, 0)``
        (which contributes nothing to the matrix but does consume one
        interpolation degree of freedom — hence ``t + k`` shares suffice for a
        degree ``t + k`` polynomial). Built by :func:`lagrange_matrix`.
        """
        return self.field.asarray(lagrange_matrix(
            self.prime_modulus, self.omega_secrets, self.omega_shares, self.secret_count,
            self.reconstruction_threshold, indices))

    # ----------------------------------------------------------- operations

    def share_batch(self, secrets_batch, rng: np.random.Generator | None = None) -> np.ndarray:
        """Share ``[B, secret_count]`` batches -> ``[B, share_count]`` shares."""
        f = self.field
        secrets_batch = f.asarray(secrets_batch)
        b = secrets_batch.shape[0]
        randomness = f.sample((b, self.privacy_threshold), rng=rng)
        zero = np.zeros((b, 1), dtype=f.dtype)
        ext = np.concatenate([zero, f.canon(secrets_batch), randomness], axis=1)
        return f.matmul(ext, self.share_matrix)

    def share_vector(self, secrets, rng: np.random.Generator | None = None) -> np.ndarray:
        """Share a d-dim vector: returns ``[share_count, ceil(d/k)]``.

        Implements the reference batching layer: chop into ``ceil(d/k)``
        batches, zero-pad the tail (batched.rs:37-43), transpose so row j is
        clerk j's share vector (batched.rs:46-49).
        """
        f = self.field
        secrets = f.canon(np.asarray(secrets))
        d = secrets.shape[0]
        k = self.secret_count
        nb = -(-d // k)
        padded = np.zeros(nb * k, dtype=f.dtype)
        padded[:d] = secrets
        shares = self.share_batch(padded.reshape(nb, k), rng=rng)  # [nb, n]
        return shares.T.copy()  # [n, nb]

    def combine(self, share_vectors) -> np.ndarray:
        """Clerk-side combine (same modular sum as additive; combiner.rs)."""
        return _combine_fold(share_vectors, self.prime_modulus)

    def reconstruct(self, indexed_shares, dimension: int) -> np.ndarray:
        """Recipient-side reconstruction from per-clerk vectors.

        ``indexed_shares``: list of ``(clerk_index, vector[ceil(d/k)])``.
        Uses the all-shares NTT fast path when possible, otherwise the
        Lagrange matrix; truncates zero-padding to ``dimension``
        (batched.rs:68-99).
        """
        f = self.field
        if len(indexed_shares) < self.reconstruction_threshold:
            raise Invalid("Not enough shares to reconstruct")
        indices = [i for i, _ in indexed_shares]
        mat_shares = f.canon(np.stack([np.asarray(v) for _, v in indexed_shares], axis=1))
        # mat_shares: [nb, s] — batch rows, one column per provided clerk
        if sorted(indices) == list(range(self.share_count)):
            # all shares present: reorder columns into clerk order and use the
            # NTT fast-path matrix (rows are clerk order 0..n-1)
            order = np.argsort(indices)
            secrets = f.matmul(mat_shares[:, order], self.full_reconstruct_matrix)
        else:
            mat = self.reconstruct_matrix(indices)
            secrets = f.matmul(mat_shares, mat)
        flat = secrets.reshape(-1)
        return flat[:dimension]

    def device_spec(self) -> DeviceSchemeSpec:
        """Packed Shamir as the unified linear form.

        ``ext = [secrets(k), randomness(t)]``: the fixed zero at point 1
        contributes nothing, so its row of :attr:`share_matrix` is dropped.
        """
        return DeviceSchemeSpec(
            modulus=self.prime_modulus,
            secret_count=self.secret_count,
            share_count=self.share_count,
            randomness_count=self.privacy_threshold,
            share_matrix=self.share_matrix[1:, :],
            reconstruct_matrix=self.full_reconstruct_matrix,
            omega_secrets=int(self.omega_secrets),
            omega_shares=int(self.omega_shares),
        )
