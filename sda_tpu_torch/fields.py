"""Prime-field arithmetic for secure aggregation (host side, numpy only).

A copy of the reference package's ``fields`` module, kept so that the
port imports nothing of it. Device field math
lives in :mod:`sda_tpu_torch.ops`.

Two things matter for parity with the upstream Rust protocol:

1. **Rust remainder semantics.** Shares fold with Rust's signed ``%``
   (truncated division, sign of the dividend) and only normalise to a
   positive representative at the very edge. :func:`trunc_mod` reproduces
   that operator; device kernels work in the canonical domain ``[0, p)`` and
   results agree after :func:`positive`.
2. **Arbitrary moduli up to (and beyond) 64 bits.** int64 fast paths serve
   ``p < 2**31`` (all products fit int64); larger moduli use exact
   python-int (object-dtype) arrays.
"""

from __future__ import annotations

import os
import secrets as _secrets
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

# Module-level indirection so tests can pin that protocol-path randomness
# really comes from the OS CSPRNG (and nothing else).
_urandom = os.urandom

__all__ = [
    "trunc_mod",
    "trunc_add_mod",
    "trunc_sub_mod",
    "positive",
    "PrimeField",
    "element_order",
    "find_prime_field",
    "find_special_prime_field",
]


def trunc_mod(a, m):
    """Rust/C-style signed remainder: result has the sign of the dividend.

    numpy's ``%`` is floor-mod; ``np.fmod`` implements truncated remainder for
    integer dtypes, matching Rust's ``%`` on i64.
    """
    if isinstance(a, (int, np.integer)) and isinstance(m, (int, np.integer)):
        a, m = int(a), int(m)
        r = abs(a) % abs(m)
        return r if a >= 0 else -r
    a = np.asarray(a)
    if a.dtype == object:
        m = int(m)
        vec = np.vectorize(lambda x: (abs(x) % m) if x >= 0 else -(abs(x) % m), otypes=[object])
        return vec(a)
    return np.fmod(a, m)


def trunc_add_mod(a, b, m: int) -> np.ndarray:
    """Exact ``trunc_mod(a + b, m)`` without int64 overflow.

    Precondition: ``|a|, |b| < m < 2**63`` element-wise. A plain int64
    ``trunc_mod(a + b, m)`` wraps once ``a + b`` crosses ``2**63``, so the
    fold is split by operand sign:

    - both ``>= 0``: sum fits uint64 (< 2m < 2**64); one conditional subtract.
    - mixed signs: ``a + b`` is in ``(-m, m)`` and fits int64 exactly.
    - both ``< 0``: ``w = (a + m) + b`` is in ``(-m, m]``; the truncated
      remainder is ``w`` when ``w <= 0`` else ``w - m``.

    Unused lanes of each branch may wrap silently; ``np.where`` discards them.
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    m64 = np.int64(m)
    m_u = np.uint64(m)
    a_neg = a < 0
    b_neg = b < 0
    s_u = a.astype(np.uint64) + b.astype(np.uint64)
    both_pos = np.where(s_u >= m_u, s_u - m_u, s_u).astype(np.int64)
    mixed = a + b
    w = (a + m64) + b
    both_neg = np.where(w <= 0, w, w - m64)
    return np.where(
        a_neg & b_neg, both_neg, np.where(a_neg ^ b_neg, mixed, both_pos)
    )


# Calls of trunc_sub_mod that took its one-pass route (both operands canonical).
trunc_sub_canonical_launches = 0


def trunc_sub_mod(a, b, m: int) -> np.ndarray:
    """Exact ``trunc_mod(a - b, m)`` without int64 overflow (see
    :func:`trunc_add_mod`; precondition ``|a|, |b| < m < 2**63``).

    When the arrays show both operands canonical, in ``[0, m)``, ``a - b``
    lies in ``(-m, m)`` and is already the truncated remainder: one pass.
    Anything else, empty arrays included, takes :func:`trunc_add_mod`'s sign
    split; both routes give the same values.
    """
    global trunc_sub_canonical_launches
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if (a.size and b.size and int(a.min()) >= 0 and int(b.min()) >= 0
            and int(a.max()) < m and int(b.max()) < m):
        trunc_sub_canonical_launches += 1
        return a - b
    return trunc_add_mod(a, -b, m)


def positive(values, modulus):
    """Map representatives from ``(-m, m)`` to canonical ``[0, m)``: add
    ``m`` to negative entries (the upstream recipient's ``positive()``)."""
    if isinstance(values, (int, np.integer)):
        v = int(values)
        return v + int(modulus) if v < 0 else v
    arr = np.asarray(values)
    if arr.dtype == object:
        m = int(modulus)
        return np.vectorize(lambda x: x + m if x < 0 else x, otypes=[object])(arr)
    return np.where(arr < 0, arr + modulus, arr)


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = _secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclass(frozen=True)
class PrimeField:
    """Arithmetic mod a prime ``p`` with dtype-adaptive numpy ops.

    All public ops take/return values in the canonical domain ``[0, p)``
    (int64 arrays for ``p < 2**31``; object arrays of python ints otherwise).
    """

    p: int

    def __post_init__(self):
        if self.p < 2:
            raise ValueError("modulus must be >= 2")

    # p < 2**31: products of canonical elements fit in int64 exactly.
    @property
    def small(self) -> bool:
        return self.p < (1 << 31)

    @property
    def dtype(self):
        return np.int64 if self.small else object

    def asarray(self, values) -> np.ndarray:
        return np.asarray(values, dtype=self.dtype)

    def canon(self, values) -> np.ndarray:
        """Reduce arbitrary integers into ``[0, p)`` (floor-mod)."""
        if self.small:
            return np.asarray(values, dtype=np.int64) % self.p
        arr = np.asarray(values, dtype=object)
        return np.vectorize(lambda x: int(x) % self.p, otypes=[object])(arr)

    def add(self, a, b):
        return self.canon(self.asarray(a) + self.asarray(b))

    def sub(self, a, b):
        return self.canon(self.asarray(a) - self.asarray(b))

    def neg(self, a):
        return self.canon(-self.asarray(a))

    def mul(self, a, b):
        if self.small:
            return (np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)) % self.p
        a = np.asarray(a, dtype=object)
        b = np.asarray(b, dtype=object)
        return np.vectorize(lambda x, y: (int(x) * int(y)) % self.p, otypes=[object])(a, b)

    def matmul(self, a, b):
        """Exact modular matmul (host reference for the device kernels)."""
        if self.small:
            a = np.asarray(a, dtype=np.int64)
            b = np.asarray(b, dtype=np.int64)
            # guard against int64 overflow for large inner dims
            if a.shape[-1] * (self.p - 1) ** 2 < (1 << 63):
                return (a @ b) % self.p
        a = np.asarray(a, dtype=object)
        b = np.asarray(b, dtype=object)
        out = a @ b
        return np.vectorize(lambda x: int(x) % self.p, otypes=[object])(out)

    def pow(self, base, exp: int):
        base = self.asarray(base)
        if base.ndim == 0:
            return pow(int(base), int(exp) % (self.p - 1) if exp >= 0 else exp, self.p)
        otype = np.int64 if self.small else object
        return np.vectorize(lambda x: pow(int(x), int(exp), self.p), otypes=[otype])(base)

    def inv(self, a):
        a = self.asarray(a)
        if a.ndim == 0:
            return pow(int(a), -1, self.p)
        otype = np.int64 if self.small else object
        return np.vectorize(lambda x: pow(int(x), -1, self.p), otypes=[otype])(a)

    def sum(self, a, axis=None):
        a = self.asarray(a)
        if self.small:
            # chunked accumulation to avoid int64 overflow on long axes
            n = a.shape[axis] if axis is not None else a.size
            max_terms = (1 << 62) // max(self.p, 1)
            if n <= max_terms:
                return np.sum(a, axis=axis, dtype=np.int64) % self.p
        a = np.asarray(a, dtype=object)
        s = np.sum(a, axis=axis)
        if isinstance(s, np.ndarray):
            return np.vectorize(lambda x: int(x) % self.p, otypes=[object])(s)
        return int(s) % self.p

    # ------------------------------------------------------------------ RNG

    def sample(self, shape, rng: np.random.Generator | None = None) -> np.ndarray:
        """Uniform elements of ``[0, p)``.

        With ``rng=None`` (the protocol path) bytes come from
        :func:`os.urandom` — never a statistical PRG: small fields use
        vectorised zone-rejection on u64 draws (exactly uniform), large
        fields floor-mod ``bitlen(p)+64``-bit draws (bias < 2^-64). Pass a
        seeded numpy Generator only for reproducible tests.
        """
        count = int(np.prod(shape)) if shape else 1
        if self.small:
            if rng is None:
                out = np.empty(count, dtype=np.uint64)
                filled = 0
                zone = (1 << 64) - ((1 << 64) % self.p)  # rejection zone
                while filled < count:
                    need = count - filled
                    draws = np.frombuffer(
                        _urandom((need + 4) * 8), dtype=np.uint64
                    )
                    draws = draws[draws < np.uint64(zone)][:need]
                    out[filled : filled + draws.size] = draws
                    filled += draws.size
                return (out % np.uint64(self.p)).astype(np.int64).reshape(shape)
            return rng.integers(0, self.p, size=shape, dtype=np.int64)
        # rejection-free big-int sampling: draw ceil(log2 p)+64 bits, floor-mod
        nbytes = (self.p.bit_length() + 64 + 7) // 8
        raw = _urandom(count * nbytes) if rng is None else rng.bytes(count * nbytes)
        vals = [
            int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little") % self.p
            for i in range(count)
        ]
        return np.array(vals, dtype=object).reshape(shape)

    # ------------------------------------------------------- root utilities

    def element_order(self, x: int) -> int:
        return element_order(int(x), self.p)

    def find_element_of_order(self, n: int) -> int:
        """Find an element of exact multiplicative order ``n`` (n | p-1)."""
        if (self.p - 1) % n != 0:
            raise ValueError(f"{n} does not divide p-1={self.p - 1}")
        cofactor = (self.p - 1) // n
        factors = _factorise(n)
        for g in range(2, 10_000):
            x = pow(g, cofactor, self.p)
            if x == 1:
                continue
            if all(pow(x, n // q, self.p) != 1 for q in factors):
                return x
        raise RuntimeError("no element of requested order found")


@lru_cache(maxsize=None)
def _factorise(n: int) -> tuple[int, ...]:
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return tuple(out)


def element_order(x: int, p: int) -> int:
    """Multiplicative order of ``x`` mod prime ``p``."""
    order = p - 1
    for q in _factorise(p - 1):
        while order % q == 0 and pow(x, order // q, p) == 1:
            order //= q
    return order


def find_prime_field(min_bits: int, order2: int, order3: int) -> tuple[int, int, int]:
    """Find ``(p, omega_secrets, omega_shares)`` for a packed-Shamir config.

    ``p`` is the smallest prime of at least ``min_bits`` bits with
    ``order2 * order3 | p - 1`` where ``order2 = 2**a`` and ``order3 = 3**b``
    (the two-radix split forced by the scheme's parameters, as in the
    p=433 test vector with ord(354)=8, ord(150)=9).
    """
    step = order2 * order3
    k = max(1, ((1 << (min_bits - 1)) // step))
    while True:
        p = k * step + 1
        if p.bit_length() >= min_bits and _is_probable_prime(p):
            f = PrimeField(p)
            w2 = f.find_element_of_order(order2)
            w3 = f.find_element_of_order(order3)
            return p, int(w2), int(w3)
        k += 1


def find_special_prime_field(
    bits: int, order2: int, order3: int, max_c: int = 1 << 13
) -> tuple[int, int, int]:
    """Pseudo-Mersenne variant of :func:`find_prime_field`: the largest
    prime ``p = 2^bits - c`` (smallest ``c``) with ``order2 * order3 |
    p - 1``.

    For such primes ``x mod p`` is two shift-multiply-add folds plus one
    conditional subtract (``2^bits ≡ c``), which replaces the Montgomery
    machinery in device epilogues. The scheme itself accepts any odd prime;
    this only selects a fast one.
    """
    step = order2 * order3
    for c in range(1, max_c):
        p = (1 << bits) - c
        if p % step == 1 and _is_probable_prime(p):
            f = PrimeField(p)
            return p, int(f.find_element_of_order(order2)), int(
                f.find_element_of_order(order3)
            )
    raise ValueError(
        f"no 2^{bits}-c prime with {step} | p-1 for c < {max_c}"
    )
