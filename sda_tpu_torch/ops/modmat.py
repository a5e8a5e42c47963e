"""Batched modular matmul and combine on limb tensors.

Port of the reference package's ``ops/modmat.py``. These are the plain
(CIOS Montgomery) forms of the framework's three hot paths:

- share generation: ``shares[B, n] = ext[B, m] @ M[m, n] mod p``;
- clerk combine: modular sum over the participant axis;
- reconstruction: ``secrets[B, k] = shares[B, n] @ R[n, k] mod p``.

All functions take ``[..., L]`` int64 limb tensors (see
:mod:`sda_tpu_torch.ops.limbs`); matrices must be in Montgomery form
(``ctx.encode_mont``) so no domain conversions appear on the hot path.
"""

from __future__ import annotations

import torch

from sda_tpu_torch.ops.limbs import LimbContext

__all__ = ["modmat", "combine", "uniform_limbs"]


def modmat(ctx: LimbContext, a, m_mont):
    """``a[..., B, m, L] @ m_mont[m, n, L] -> [..., B, n, L]`` modular matmul.

    ``m_mont`` is in Montgomery form, ``a`` in normal form; the output is in
    normal form (mont_mul cancels the R factor). The contraction is a Python
    loop over the small inner dimension ``m``; each step is a Montgomery
    multiply/accumulate over the whole batch.
    """
    acc = None
    for j in range(m_mont.shape[0]):
        prod = ctx.mont_mul(a[..., j, None, :], m_mont[j])
        acc = prod if acc is None else ctx.add_mod(acc, prod)
    return acc


def combine(ctx: LimbContext, shares, axis: int = 0):
    """Modular sum over the participant axis (the clerk combine)."""
    return ctx.sum_mod(shares, axis=axis)


def uniform_limbs(ctx: LimbContext, generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform field elements ``[*shape, L]`` drawn from ``generator``.

    Draws ``2L`` 16-bit limbs (double width) and reduces exactly mod p,
    leaving statistical bias <= p / 2**(32*L). The tensor lies on the
    generator's device. Protocol-critical randomness comes from the host OS
    RNG; this is the bulk/benchmark path.
    """
    L = ctx.L
    device = generator.device
    bits = torch.randint(
        0, 1 << 32, tuple(shape) + (L,), dtype=torch.int64,
        generator=generator, device=device,
    )
    x0 = bits & 0xFFFF  # [..., L] limbs
    x1 = bits >> 16
    r2 = torch.tensor(ctx.r2, dtype=torch.int64, device=device)
    one = torch.zeros(L, dtype=torch.int64, device=device)
    one[0] = 1  # normal-domain 1
    # x mod p = (x1 * R + x0) mod p
    a = ctx.mont_mul(x1, r2)  # x1 * R mod p
    y = ctx.mont_mul(x0, r2)  # x0 * R mod p
    b = ctx.mont_mul(y, one)  # x0 mod p
    return ctx.add_mod(a, b)
