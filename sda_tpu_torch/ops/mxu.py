"""7-bit-limb modular matmul: the limb convolution folded into an int8 matmul.

Port of the reference package's ``ops/mxu.py`` (kernel generation 3, its
plain-product half). The share transform and the reconstruction are ``y =
x @ M mod p`` with a tiny ``M`` and an enormous batch axis. This module
routes the products through one integer matrix product:

- Field elements are split into **7-bit limbs stored as int8**: every
  product of two limbs fits 14 bits, and tens of thousands of them add up
  exactly in an int32 accumulator.
- Multiplication by a *constant* is linear over the limbs of the other
  operand, ``x * c = sum_l1 x_l1 * (c << 7*l1)``, so the whole map from
  input limbs to raw product columns is one integer matrix::

      bigM[(j, l1), (i, lo)] = limb_{lo-l1}(M[j, i])

  and ``x7[B, m*L7] @ bigM -> acc[B, n*C]`` computes every product
  ``x[j] * M[j, i]`` and their sum over ``j``. Summing participants is just
  more rows in the contraction (the clerk combine).
- An epilogue renormalises each output's redundant base-2^7 columns: carry
  propagation, regrouping into chunks of ``floor(log2 p / 7)`` limbs (each
  canonical by construction), and one Montgomery multiply per chunk by
  ``2^(7*chunk*t) mod p``.

Bound: every output column receives at most ``K = rows(bigM)`` products of
two 7-bit values, so ``K * 127^2 < 2^31``, i.e. ``K <= 133152``.

The contraction itself is a plain integer matrix product, which the
reference leaves to XLA; here it goes to ``torch._int_mm`` (int8 x int8 ->
int32) on the card, and to float64 on the CPU, exact because every sum
stays below 2^31. u32 lanes are int64 tensors, as everywhere in the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sda_tpu_torch.ops.limbs import LimbContext, to_limbs

__all__ = ["MAX_CONTRACTION", "MxuContext", "limbs7_for", "limbs7_host", "mxu_modmat"]

_W7 = 7
_MASK7 = (1 << _W7) - 1
_W16 = 16
_MASK16 = (1 << _W16) - 1
_M32 = 0xFFFFFFFF
# max contraction length such that K * 127 * 127 < 2**31 (int32 accumulator)
MAX_CONTRACTION = (1 << 31) // (_MASK7 * _MASK7)


def limbs7_for(p: int) -> int:
    """Limb count for canonical values (< p) in 7-bit limbs."""
    return -(-p.bit_length() // _W7)


def limbs7_host(values, L7: int) -> np.ndarray:
    """Host: object/int array -> ``[..., L7]`` int8 7-bit limbs."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    out = np.zeros((flat.size, L7), dtype=np.int8)
    for i, v in enumerate(flat):
        v = int(v)
        if v < 0:
            raise ValueError("limbs7_host requires non-negative values")
        for j in range(L7):
            out[i, j] = v & _MASK7
            v >>= _W7
        if v:
            raise ValueError("value does not fit limb count")
    return out.reshape(arr.shape + (L7,))


def _int_mm_shape(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The zero-padded ``(M, K, N)`` that ``torch._int_mm`` takes on the
    card: K and N multiples of 8 (its own rule) and M a multiple of 32. At
    M = 8 mod 16 (1,000 rows, or the 333,336 of a participant's
    ``share_mxu`` at 1,000,002 dimensions) cuBLASLt on the H100 returned
    CUBLAS_STATUS_NOT_SUPPORTED."""
    return max(32, -(-m // 32) * 32), -(-k // 8) * 8, -(-n // 8) * 8


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a[M, K] @ b[K, N]`` of int8 operands whose sums stay below
    2^31, as int64. On the card: ``torch._int_mm``, with the operands
    zero-padded to :func:`_int_mm_shape`. On the CPU: float64, exact since
    every sum is below 2^53."""
    if a.device.type != "cuda":
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _int_mm_shape(m, k, n)
    a = torch.nn.functional.pad(a.to(torch.int8), (0, kp - k, 0, mp - m)).contiguous()
    b = torch.nn.functional.pad(b.to(torch.int8), (0, np_ - n, 0, kp - k)).contiguous()
    return torch._int_mm(a, b)[:m, :n].to(torch.int64)


@dataclass(frozen=True)
class MxuContext:
    """Per-modulus constants for the 7-bit int8 path.

    ``L7``: canonical limb count; ``chunk``: 7-bit limbs per reduction chunk
    (chosen so a chunk's value ``< 2^(7*chunk) <= p`` is canonical by
    construction).
    """

    ctx: LimbContext
    L7: int
    chunk: int

    @classmethod
    def create(cls, ctx: LimbContext) -> "MxuContext":
        p = ctx.p
        if p.bit_length() <= _W7:
            raise ValueError("modulus too small for 7-bit limb chunking")
        chunk = (p.bit_length() - 1) // _W7  # 2^(7*chunk) <= p
        return cls(ctx=ctx, L7=limbs7_for(p), chunk=chunk)

    # ------------------------------------------------------------ matrices

    def matrix_int8(self, m_normal, in_limbs) -> np.ndarray:
        """Build ``bigM[sum(in_limbs), n * out_cols]`` int8.

        ``m_normal``: ``[m, n]`` canonical (NOT Montgomery) matrix entries.
        ``in_limbs``: per-input-slot limb count — ``L7`` for canonical
        inputs, ``2*L7`` for raw double-width randomness (see
        :meth:`raw_limbs`). Row order is slot-major: ``(j, l1)``.
        """
        m_normal = np.asarray(m_normal, dtype=object)
        m, n = m_normal.shape
        if len(in_limbs) != m:
            raise ValueError("in_limbs must give a limb count per matrix row")
        cols = self.out_cols(in_limbs)
        mlimbs = limbs7_host(m_normal, self.L7)  # [m, n, L7]
        big = np.zeros((sum(in_limbs), n * cols), dtype=np.int8)
        row = 0
        for j in range(m):
            for l1 in range(in_limbs[j]):
                for i in range(n):
                    big[row, i * cols + l1 : i * cols + l1 + self.L7] = mlimbs[j, i]
                row += 1
        return big

    def out_cols(self, in_limbs) -> int:
        """Redundant output columns per matrix column."""
        return max(in_limbs) + self.L7 - 1

    # ------------------------------------------------------- limb reshape

    def limbs7_from_16(self, x16, dim: int = -1) -> torch.Tensor:
        """``[..., L16]`` 16-bit limbs -> ``[..., L7]`` int8 7-bit limbs (pure
        bit regrouping). ``dim`` is the limb axis of both: a limb-major
        ``[n, L16, T]`` tensor gives ``[n, L7, T]`` planes with no transpose."""
        L16 = self.ctx.L
        out = []
        for l in range(self.L7):
            o = _W7 * l
            w, sh = o // _W16, o % _W16
            v = x16.select(dim, w).to(torch.int64) >> sh
            if sh + _W7 > _W16 and w + 1 < L16:
                v = v | (x16.select(dim, w + 1).to(torch.int64) << (_W16 - sh))
            out.append((v & _MASK7).to(torch.int8))
        return torch.stack(out, dim=dim)

    def raw_limbs(self, bits_u32) -> torch.Tensor:
        """``[..., W]`` u32 random words (int64) -> ``[..., 2*L7]`` int8.

        Reads the words little-endian and slices ``2*L7`` 7-bit limbs — a
        uniform value in ``[0, 2^(14*L7))`` whose residue mod p has bias
        ``<= p / 2^(7*L7)``. Linearity makes non-canonical sharing
        randomness harmless: shares are reduced mod p downstream.
        """
        need = 2 * self.L7
        W = bits_u32.shape[-1]
        if W * 32 < need * _W7:
            raise ValueError("not enough random words for raw limbs")
        bits_u32 = bits_u32.to(torch.int64)
        out = []
        for l in range(need):
            o = _W7 * l
            w, sh = o // 32, o % 32
            v = bits_u32[..., w] >> sh
            if sh + _W7 > 32 and w + 1 < W:
                v = v | ((bits_u32[..., w + 1] << (32 - sh)) & _M32)
            out.append(v & _MASK7)
        return torch.stack(out, dim=-1).to(torch.int8)

    @property
    def raw_words(self) -> int:
        """u32 words needed per raw-randomness element."""
        return -(-(2 * self.L7 * _W7) // 32)

    # ----------------------------------------------------------- epilogue

    def _chunk_consts(self, n_chunks: int) -> np.ndarray:
        """Montgomery-form ``2^(7*chunk*t) mod p`` for ``t < n_chunks``, as
        ``[n_chunks, L16]`` uint32 limbs."""
        p, R = self.ctx.p, 1 << (_W16 * self.ctx.L)
        vals = [(pow(2, _W7 * self.chunk * t, p) * R) % p for t in range(n_chunks)]
        return to_limbs(np.array(vals, dtype=object), self.ctx.L)

    def reduce_columns(self, cols) -> torch.Tensor:
        """``[..., C]`` non-negative redundant base-2^7 columns (each below
        2^31) -> canonical ``[..., L16]`` int64 limbs of ``sum cols[c] *
        2^(7c) mod p``."""
        ctx = self.ctx
        C = cols.shape[-1]
        cols = cols.to(torch.int64)
        # 1. carry-propagate to 7-bit limbs (carry < 2^25 at every step)
        limbs, carry = [], torch.zeros(cols.shape[:-1], dtype=torch.int64, device=cols.device)
        for c in range(C):
            t = cols[..., c] + carry
            limbs.append(t & _MASK7)
            carry = t >> _W7
        for _ in range(4):  # residual carry < 2^25 -> four more limbs
            limbs.append(carry & _MASK7)
            carry = carry >> _W7
        # 2. regroup into canonical chunks of `chunk` limbs, as L16 limbs
        n_chunks = -(-len(limbs) // self.chunk)
        consts = self._chunk_consts(n_chunks).astype(np.int64)
        acc = None
        for t in range(n_chunks):
            lanes16 = [torch.zeros_like(limbs[0]) for _ in range(ctx.L)]
            for j, b in enumerate(limbs[t * self.chunk : (t + 1) * self.chunk]):
                o = _W7 * j
                w, sh = o // _W16, o % _W16
                lanes16[w] = lanes16[w] | ((b << sh) & _MASK16)
                if sh + _W7 > _W16 and w + 1 < ctx.L:
                    lanes16[w + 1] = lanes16[w + 1] | (b >> (_W16 - sh))
            # 3. fold: chunk_t * 2^(7*chunk*t) mod p via one Montgomery multiply
            term = ctx.mont_mul_lanes(lanes16, [int(consts[t, l]) for l in range(ctx.L)])
            acc = term if acc is None else ctx.add_mod_lanes(acc, term)
        return torch.stack(acc, dim=-1)


def mxu_modmat(mxu: MxuContext, x7, big_int8, n: int, cols: int) -> torch.Tensor:
    """``x7[..., K] int8 @ big[K, n*cols] -> [..., n, L16]`` canonical limbs.

    ``x7`` rows are the concatenated 7-bit limbs of the input slots (layout
    must match the ``in_limbs`` used to build ``big_int8``). Raises past the
    int32-accumulator bound on the contraction length.
    """
    K = x7.shape[-1]
    if K > MAX_CONTRACTION:
        raise ValueError(
            f"contraction length {K} exceeds the int32 accumulator bound "
            f"{MAX_CONTRACTION}; chunk the batch/participant axis"
        )
    big = torch.as_tensor(big_int8, device=x7.device)
    lead = x7.shape[:-1]
    acc = _int8_matmul(x7.reshape(-1, K), big)
    return mxu.reduce_columns(acc.reshape(*lead, n, cols))
