"""Fused share + combine on planar u32 tiles: kernel generation 1 (CIOS).

Port of the reference package's ``ops/pallas_kernels.py``. The name is the
reference's module name (its kernels were written in Pallas); here the
kernel is hand-written CUDA C++ (``csrc/planar_cios.cu``) with its plain
PyTorch version beside its launcher.

Per batch position (a lane) and participant, the kernel computes every
share product ``ext_j * M[j, i]`` as a raw CIOS Montgomery product (value
below 2p, ``L + 1`` 16-bit columns) against the Montgomery-form share
matrix, and adds the columns of all products and participants with plain
u32 adds: a column stays below ``P * m * 2^16``, so the guard ``P * m <
2^15`` keeps it exact. Each clerk's column sum is renormalised once at the
end: carry-propagate, split ``V = V_hi * R + V_lo``, three Montgomery
multiplies. Shares never leave the kernel.

Layout: the reference's planar ``[P, slots, L, NBp/128, 128]`` u32 tiles
(here int32 holding the u32 bits); the output is ``[n, L, NBp/128, 128]``.

**Randomness.** With ``k`` slots per participant the kernel draws the ``r``
sharing-randomness elements itself, as the reference's ``_uniform_lanes``
does: ``L`` u32 words per element, split into 16-bit halves, the element
``(x1 * R + x0) mod p`` exactly. The TPU's generator cannot be reproduced;
here word ``w = s * L + l`` of randomness slot ``s`` at (lane,
participant) is output word ``w % 4`` of Philox4x32-10 with key ``(seed
mod 2^32, 0)`` and counter ``(lane, participant, w // 4, 7)``, ``lane`` the
global lane index (the fourth word, 7, keeps this stream apart from the
other kernels'). The kernel and the plain version use the same mapping and
agree bit for bit. With ``k + r`` slots the caller's randomness is used.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sda_tpu_torch.ops.limbs import LimbContext
from sda_tpu_torch.ops.mxu8 import philox_words

__all__ = [
    "fused_share_combine_planar",
    "planar_from_batched",
    "batched_from_planar",
    "KERNEL_VARIANTS",
]

_MASK = 0xFFFF
_M32 = 0xFFFFFFFF
_PHILOX_TAG = 7  # fourth Philox counter word of this kernel's stream

# Launches of the CUDA kernel (one per call on a CUDA tensor).
fused_planar_launches = 0

KERNEL_VARIANTS = {"planar_cios": ("planar_cios.cu", ())}


def planar_from_batched(x, rows: int) -> torch.Tensor:
    """``[P, NB, k, L] -> [P, k, L, NBp/128, 128]`` int32 with zero padding.

    ``NBp`` is ``NB`` rounded up to ``rows * 128`` (one kernel tile of the
    reference). Zero batches are inert: they share the zero vector and are
    sliced off after reconstruction. One copy: the transpose, the cast and
    the padding go into a single new tensor.
    """
    p, nb, k, L = x.shape
    nbp = -(-nb // (rows * 128)) * rows * 128
    planar = torch.zeros((p, k, L, nbp), dtype=torch.int32, device=x.device)
    planar[..., :nb] = x.permute(0, 2, 3, 1)
    return planar.view(p, k, L, nbp // 128, 128)


def batched_from_planar(y, nb: int) -> torch.Tensor:
    """``[n, L, NBp/128, 128] -> [NB, n, L]`` (slicing the padding off)."""
    n, L, nbr, _ = y.shape
    return y.reshape(n, L, nbr * 128).permute(2, 0, 1)[:nb]


def _scalar_table(ctx: LimbContext, m_mont: torch.Tensor, device) -> torch.Tensor:
    """``[m + 2, n * L]`` int32: the Montgomery-form share matrix rows, then
    ``r2`` (first L entries) and the normal-domain one; then the L limbs of
    p. The kernel copies it to shared memory."""
    m, n, L = m_mont.shape
    aux = np.zeros((2, n * L), dtype=np.int64)
    aux[0, :L] = ctx.r2
    aux[1, 0] = 1
    return torch.cat([
        torch.as_tensor(m_mont, device=device).reshape(m * n * L).to(torch.int64),
        torch.from_numpy(np.concatenate([aux.reshape(-1), np.asarray(ctx.p_limbs)])).to(device),
    ]).to(torch.int32)


def _uniform_lanes(ctx: LimbContext, words, r2, one):
    """One uniform field element per lane position, as an L-lane list:
    ``words`` are the element's L u32 words (int64 tensors), each split into
    16-bit halves ``x1 = w >> 16`` and ``x0 = w & 0xFFFF``; the result is
    ``(x1 * R + x0) mod p``, exactly."""
    x0 = [w & _MASK for w in words]
    x1 = [w >> 16 for w in words]
    a = ctx.mont_mul_lanes(x1, r2)
    y = ctx.mont_mul_lanes(x0, r2)
    b = ctx.mont_mul_lanes(y, one)
    return ctx.add_mod_lanes(a, b)


def _rand_words(n_words: int, seed: int, lanes: torch.Tensor, p_count: int):
    """The first ``n_words`` PRNG words ``[P, n_words, T]`` (int64, u32
    values) of every (participant, lane)."""
    parts = torch.arange(p_count, dtype=torch.int64, device=lanes.device)
    return philox_words(seed, lanes, parts, n_words, _PHILOX_TAG)


def _renormalise(ctx: LimbContext, cols, r2, one):
    """``L + 1`` redundant u32 column sums -> canonical L lanes: carry, split
    ``V = V_hi * R + V_lo``, reduce with three Montgomery multiplies."""
    L = ctx.L
    zero = torch.zeros_like(cols[0])
    carry, limbs = zero, []
    for c in range(L + 1):
        t = cols[c] + carry
        limbs.append(t & _MASK)
        carry = t >> 16
    v_lo = limbs[:L]
    v_hi = [limbs[L], carry] + [zero] * (L - 2)
    a = ctx.mont_mul_lanes(v_hi, r2)  # V_hi * R mod p
    y = ctx.mont_mul_lanes(v_lo, r2)  # V_lo * R mod p
    b = ctx.mont_mul_lanes(y, one)  # V_lo mod p
    return ctx.add_mod_lanes(a, b)


def _fused_planar_plain_block(ctx, sec, table, k, m, n, has_prng, seed, lane0):
    """Lanes ``[lane0, lane0 + T)``: ``sec`` ``[P, slots, L, T]`` int64."""
    L = ctx.L
    P, T = sec.shape[0], sec.shape[-1]
    r2 = [table[(m * n) * L + l] for l in range(L)]
    one = [table[(m * n + n) * L + l] for l in range(L)]
    ext = [[sec[:, j, l] for l in range(L)] for j in range(sec.shape[1])]
    if has_prng and m > k:
        lanes = torch.arange(lane0, lane0 + T, dtype=torch.int64, device=sec.device)
        words = _rand_words((m - k) * L, seed, lanes, P)
        for s in range(m - k):
            ext.append(_uniform_lanes(ctx, [words[:, s * L + l] for l in range(L)], r2, one))
    out = []
    for i in range(n):
        acc = None
        for j in range(m):
            b = [table[(j * n + i) * L + l] for l in range(L)]
            raw = ctx.mont_mul_lanes_raw(ext[j], b)  # L + 1 columns, value < 2p
            acc = raw if acc is None else [a + r for a, r in zip(acc, raw)]
        out.append(torch.stack(_renormalise(ctx, [c.sum(dim=0) for c in acc], r2, one)))
    return torch.stack(out)  # [n, L, T]


def _fused_share_combine_planar_plain(ctx, sec, table, k, m, n, has_prng, seed):
    """The fused function in plain int64 tensor code (any device), in blocks
    of lanes that bound the intermediates to about 2^25 elements each."""
    P, _, L, nbp = sec.shape
    block = max(1, min(nbp, (1 << 25) // max(P * m, 1)))
    t = table.to(torch.int64) & _M32
    out = torch.empty((n, L, nbp), dtype=torch.int32, device=sec.device)
    for l0 in range(0, nbp, block):
        l1 = min(nbp, l0 + block)
        out[:, :, l0:l1] = _fused_planar_plain_block(
            ctx, sec[..., l0:l1].to(torch.int64) & _M32, t, k, m, n, has_prng, seed, l0
        ).to(torch.int32)
    return out


def _launch_planar_kernel(ctx, sec, table, p_count, slots, k, m, n, has_prng, seed):
    """One launch of ``csrc/planar_cios.cu`` on the current stream."""
    global fused_planar_launches
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    if sec.dtype != torch.int32 or not sec.is_contiguous():
        raise ValueError("secrets_planar must be a contiguous int32 tensor on the card")
    if n > 8 or ctx.L not in (2, 4, 8):
        raise ValueError("the planar kernel takes at most 8 clerks and L in (2, 4, 8)")
    lib = load_kernel_library(*KERNEL_VARIANTS["planar_cios"])
    fn = lib.sda_planar_cios
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbp = sec.shape[-1] * sec.shape[-2]
    params = np.array([
        p_count, slots, k, m, n, ctx.L, nbp, int(has_prng),
        np.uint32(seed & _M32).view(np.int32), ctx.p_inv_w,
    ], dtype=np.int32)
    out = torch.empty((n, ctx.L, nbp), dtype=torch.int32, device=sec.device)
    with torch.cuda.device(sec.device):
        stream = torch.cuda.current_stream(sec.device).cuda_stream
        err = fn(sec.data_ptr(), table.data_ptr(), out.data_ptr(), len(params),
                 params.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"planar_cios kernel launch failed: cudaError {err}")
    fused_planar_launches += 1
    return out


def fused_share_combine_planar(
    ctx: LimbContext,
    secrets_planar,  # [P, slots, L, NBR, 128] u32 limbs (int32 or int64)
    m_mont,  # [m, n, L] Montgomery-form share matrix
    rand_count: int,
    seed: int = 0,
    rows: int = 8,
) -> torch.Tensor:
    """Fused share generation + combine on planar tiles; returns ``[n, L,
    NBR, 128]`` int32 canonical limbs of every clerk's sum.

    If ``slots == k`` (``m - rand_count``), randomness is drawn in the kernel
    from ``seed``; if ``slots == m``, the caller supplied randomness
    (protocol path) and the PRNG is unused. On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernel or raises.
    """
    p_count, slots, L, nbr, lanes = secrets_planar.shape
    if lanes != 128:
        raise ValueError("last axis must be 128 lanes")
    if nbr % rows:
        raise ValueError(f"NBR={nbr} must be a multiple of rows={rows}")
    m, n = m_mont.shape[0], m_mont.shape[1]
    if slots == m:
        has_prng, k = False, m - rand_count
    elif slots == m - rand_count:
        has_prng, k = True, slots
    else:
        raise ValueError("secrets slot count matches neither k nor k+r")
    if p_count * m >= (1 << 15):
        raise ValueError(
            "participants * scheme_size must stay below 2^15 per kernel pass "
            "(redundant-accumulation bound); chunk the participant axis"
        )
    dev = secrets_planar.device
    table = _scalar_table(ctx, m_mont, dev)
    seed = int(seed)
    if dev.type == "cuda":
        sec = secrets_planar.to(torch.int32).contiguous()
        out = _launch_planar_kernel(ctx, sec, table, p_count, slots, k, m, n, has_prng, seed)
    elif dev.type == "cpu":
        sec = secrets_planar.reshape(p_count, slots, L, nbr * 128)
        out = _fused_share_combine_planar_plain(ctx, sec, table, k, m, n, has_prng, seed & _M32)
    else:
        raise ValueError(f"unsupported device {dev}")
    return out.view(n, L, nbr, 128)
