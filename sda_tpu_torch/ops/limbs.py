"""Multi-limb Montgomery arithmetic on 16-bit limbs, as torch tensor code.

Port of the reference package's ``ops/limbs.py``. Field elements are
tensors of ``L`` 16-bit limbs (``L = 2`` for moduli below 2**32, ``4`` for
64-bit primes, ``8`` for 128-bit moduli) and modular multiplication is CIOS
Montgomery reduction with word size 2**16.

**Integer representation.** The reference keeps limbs in uint32 lanes and
relies on u32 wrap-around. torch on the CPU has no uint32 ``+``, ``-``,
``>>`` or ``>``, so every limb and u32 lane here is an **int64** tensor.
In this module no value ever leaves ``[-2**17, 2**32)``, so int64 carries
it exactly; the one place where the reference depends on a wrap — the
borrow flag of :meth:`LimbContext._cond_sub`, read as bit 16 of a negative
difference — gives the same bit under int64's two's complement. Code that
does depend on mod-2**32 wrap (the byte-limb kernel's carry chains) masks
with ``& 0xFFFFFFFF`` explicitly.

The Montgomery trick that removes all domain conversions from the hot path:
keep the *precomputed transform matrices* in Montgomery form (``M~ = M*R``)
and the data in normal form; then ``mont_mul(a, M~) = a*M mod p`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["LimbContext", "to_limbs", "from_limbs", "limbs_for_modulus", "limbs_from_numpy"]

_W = 16
_MASK = (1 << _W) - 1


def limbs_for_modulus(p: int) -> int:
    """Smallest supported limb count whose range exceeds ``p``."""
    for L in (2, 4, 8):
        if p < (1 << (_W * L)):
            return L
    raise ValueError("modulus too large (max 128 bits)")


def to_limbs(values, L: int) -> np.ndarray:
    """Host conversion: integers -> ``[..., L]`` uint32 16-bit limbs."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    out = np.zeros((flat.size, L), dtype=np.uint32)
    for i, v in enumerate(flat):
        v = int(v)
        if v < 0:
            raise ValueError("to_limbs requires canonical non-negative values")
        for j in range(L):
            out[i, j] = v & _MASK
            v >>= _W
        if v:
            raise ValueError("value does not fit limb count")
    return out.reshape(arr.shape + (L,))


def from_limbs(limbs) -> np.ndarray:
    """Host conversion: ``[..., L]`` limbs (tensor or array) -> object array
    of python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs)
    L = arr.shape[-1]
    flat = arr.reshape(-1, L)
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        v = 0
        for j in reversed(range(L)):
            v = (v << _W) | int(flat[i, j])
        out[i] = v
    return out.reshape(arr.shape[:-1])


def limbs_from_numpy(u32_array, device="cpu") -> torch.Tensor:
    """A limb array from the reference package (uint32, any shape) -> the
    port's int64 limb tensor on ``device``."""
    arr = np.asarray(u32_array)
    if arr.dtype == object or arr.dtype.kind not in "iu":
        raise ValueError("limbs_from_numpy expects an integer limb array")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


@dataclass(frozen=True)
class LimbContext:
    """Precomputed constants for one modulus: use as the device field handle.

    ``p_limbs``: the modulus as limbs; ``p_inv_w = -p^{-1} mod 2^16`` (the
    Montgomery quotient constant); ``r2`` = R^2 mod p for to-Montgomery
    conversion; ``r_mod_p`` = R mod p.
    """

    p: int
    L: int
    p_limbs: tuple
    p_inv_w: int
    r2: tuple
    r_mod_p: tuple

    @classmethod
    def create(cls, p: int, L: int | None = None) -> "LimbContext":
        if L is None:
            L = limbs_for_modulus(p)
        if p % 2 == 0:
            raise ValueError("Montgomery arithmetic requires an odd modulus")
        R = 1 << (_W * L)
        p_inv_w = (-pow(p, -1, 1 << _W)) % (1 << _W)
        r2 = pow(R, 2, p)
        return cls(
            p=p,
            L=L,
            p_limbs=tuple(int(x) for x in to_limbs([p], L)[0]),
            p_inv_w=p_inv_w,
            r2=tuple(int(x) for x in to_limbs([r2], L)[0]),
            r_mod_p=tuple(int(x) for x in to_limbs([R % p], L)[0]),
        )

    @classmethod
    def create_add_only(cls, p: int, L: int | None = None) -> "LimbContext":
        """Context for add/sub/sum only: works for even moduli too (the
        additive scheme allows any group order; Montgomery needs odd)."""
        if p % 2 == 1:
            return cls.create(p, L)
        if L is None:
            L = limbs_for_modulus(p)
        return cls(
            p=p,
            L=L,
            p_limbs=tuple(int(x) for x in to_limbs([p], L)[0]),
            p_inv_w=0,  # mont ops are invalid for even p; add/sub never use it
            r2=(0,) * L,
            r_mod_p=tuple(int(x) for x in to_limbs([(1 << (_W * L)) % p], L)[0]),
        )

    # ------------------------------------------------------------- helpers

    def _split(self, x):
        """[..., L] tensor -> list of L [...] int64 lanes."""
        x = x.to(torch.int64)
        return [x[..., j] for j in range(self.L)]

    @staticmethod
    def _join(lanes):
        return torch.stack(lanes, dim=-1)

    def _const(self, limbs, like):
        return torch.tensor(limbs, dtype=torch.int64, device=like.device)

    # ------------------------------------------------------ add / subtract

    def add_mod(self, a, b):
        """``(a + b) mod p`` on ``[..., L]`` limb tensors (canonical inputs)."""
        a, b = torch.broadcast_tensors(a, b)
        return self._join(self.add_mod_lanes(self._split(a), self._split(b)))

    def add_mod_lanes(self, av, bv):
        """Lane-list form: L same-shaped tensors in, L out."""
        s, carry = [], torch.zeros_like(av[0])
        for j in range(self.L):
            t = av[j] + bv[j] + carry
            s.append(t & _MASK)
            carry = t >> _W
        return self._cond_sub(s, carry)

    def _cond_sub(self, s, carry):
        """Subtract p if (carry, s) >= p; s is a list of L lanes.

        The borrow flag is bit 16 of ``s - p - borrow``: the reference reads
        it from a wrapped uint32, int64 two's complement gives the same bit
        (a negative difference lies in ``[-2**16, 0)``)."""
        d, borrow = [], torch.zeros_like(s[0])
        for j in range(self.L):
            t = s[j] - self.p_limbs[j] - borrow
            d.append(t & _MASK)
            borrow = (t >> _W) & 1
        need = (carry > 0) | (borrow == 0)  # s >= p
        return [torch.where(need, d[j], s[j]) for j in range(self.L)]

    def sub_mod(self, a, b):
        """``(a - b) mod p`` on limb tensors."""
        a, b = torch.broadcast_tensors(a, b)
        av, bv = self._split(a), self._split(b)
        d, borrow = [], torch.zeros_like(av[0])
        for j in range(self.L):
            t = av[j] - bv[j] - borrow
            d.append(t & _MASK)
            borrow = (t >> _W) & 1
        # if borrowed, add p back
        s, carry = [], torch.zeros_like(av[0])
        for j in range(self.L):
            t = d[j] + self.p_limbs[j] + carry
            s.append(t & _MASK)
            carry = t >> _W
        wrapped = borrow == 1
        return self._join([torch.where(wrapped, s[j], d[j]) for j in range(self.L)])

    # -------------------------------------------------------- montgomery

    def mont_mul(self, a, b):
        """CIOS Montgomery product: ``a * b * R^{-1} mod p``.

        With ``b`` pre-scaled by R (Montgomery form) this computes the plain
        modular product of normal-domain ``a``. Inputs must be canonical
        (< p); output is canonical. Broadcasting over leading axes works.
        """
        shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        av = [x.expand(shape) for x in self._split(a)]
        bv = [x.expand(shape) for x in self._split(b)]
        return self._join(self.mont_mul_lanes(av, bv))

    def mont_mul_lanes(self, av, bv):
        """Lane-list CIOS Montgomery product (see :meth:`mont_mul`)."""
        T = self.mont_mul_lanes_raw(av, bv)
        return self._cond_sub(T[: self.L], T[self.L])

    def mont_mul_lanes_raw(self, av, bv):
        """CIOS product WITHOUT the final conditional subtract.

        Returns ``L + 1`` lane columns representing a value < 2p (the top
        column is 0 or 1). Every intermediate stays below 2**32, as in the
        reference's uint32 lanes.
        """
        L = self.L
        zero = torch.zeros_like(av[0])
        T = [zero] * (L + 2)
        for i in range(L):
            # multiply-accumulate row i
            c = zero
            for j in range(L):
                t = T[j] + av[i] * bv[j] + c  # exact: max 2^32 - 1
                T[j] = t & _MASK
                c = t >> _W
            t = T[L] + c
            T[L] = t & _MASK
            T[L + 1] = T[L + 1] + (t >> _W)
            # Montgomery reduction step for limb 0
            mq = (T[0] * self.p_inv_w) & _MASK
            t = T[0] + mq * self.p_limbs[0]
            c = t >> _W
            for j in range(1, L):
                t = T[j] + mq * self.p_limbs[j] + c
                T[j - 1] = t & _MASK
                c = t >> _W
            t = T[L] + c
            T[L - 1] = t & _MASK
            T[L] = T[L + 1] + (t >> _W)
            T[L + 1] = zero
        # raw result in T[0..L]: value < 2p, top column in {0, 1}
        return T[: L + 1]

    def to_mont(self, a):
        """Normal -> Montgomery domain (multiply by R via the r2 constant)."""
        return self.mont_mul(a, self._const(self.r2, a))

    def from_mont(self, a):
        """Montgomery -> normal domain (multiply by 1)."""
        return self.mont_mul(a, self._const((1,) + (0,) * (self.L - 1), a))

    # ----------------------------------------------------------- mod sums

    def sum_mod(self, x, axis: int):
        """Modular sum along ``axis`` of a ``[..., L]`` limb tensor.

        Tree reduction of ``add_mod`` keeps every intermediate canonical.
        """
        axis = axis % x.dim()
        n = x.shape[axis]
        while n > 1:
            half = n // 2
            acc = self.add_mod(x.narrow(axis, 0, half), x.narrow(axis, half, half))
            if n % 2:
                acc = torch.cat([acc, x.narrow(axis, 2 * half, 1).to(torch.int64)], dim=axis)
            x, n = acc, acc.shape[axis]
        return x.squeeze(axis).to(torch.int64)

    # --------------------------------------------------- host conversions

    def encode(self, values, device="cpu") -> torch.Tensor:
        """Host: ints -> ``[..., L]`` limb tensor of their residues mod p."""
        vals = np.vectorize(lambda v: int(v) % self.p, otypes=[object])(
            np.asarray(values, dtype=object)
        )
        return limbs_from_numpy(to_limbs(vals, self.L), device)

    def encode_mont(self, values, device="cpu") -> torch.Tensor:
        """Host: ints -> Montgomery-form limb tensor."""
        R = 1 << (_W * self.L)
        vals = np.vectorize(lambda v: (int(v) * R) % self.p, otypes=[object])(
            np.asarray(values, dtype=object)
        )
        return limbs_from_numpy(to_limbs(vals, self.L), device)

    def decode(self, limb_tensor) -> np.ndarray:
        """Host: limb tensor -> object array of canonical ints."""
        return from_limbs(limb_tensor)

    def encode_i64(self, values, device="cpu") -> torch.Tensor:
        """Vectorised int64 path (p < 2**63): ints -> residue limbs."""
        if self.p >= (1 << 63):
            raise ValueError("encode_i64 requires a modulus below 2**63")
        arr = torch.as_tensor(np.asarray(values, dtype=np.int64), device=device) % self.p
        return torch.stack([(arr >> (_W * j)) & _MASK for j in range(self.L)], dim=-1)

    def recombine_i64(self, limb_tensor) -> torch.Tensor:
        """Canonical limbs -> int64 tensor of their values, on the limbs'
        own device (p < 2**63); nothing waits for the device."""
        if self.p >= (1 << 63):
            raise ValueError("the int64 recombine requires a modulus below 2**63")
        arr = torch.as_tensor(limb_tensor).to(torch.int64)
        out = torch.zeros(arr.shape[:-1], dtype=torch.int64, device=arr.device)
        for j in reversed(range(self.L)):
            out = (out << _W) | arr[..., j]
        return out

    def decode_i64(self, limb_tensor) -> np.ndarray:
        """Vectorised limbs -> int64 numpy array (p < 2**63)."""
        return self.recombine_i64(limb_tensor).cpu().numpy()
