"""Byte-limb (base-256) fused share + combine (+ reconstruct).

Port of the reference package's ``ops/mxu8.py`` (kernel generation 4). The
algebra is the reference's:

1. **Byte limbs.** Field elements stream as ``L8 = 2 * L`` raw bytes, the
   canonical 16-bit limbs split in half; each byte is an int8 operand.
2. **Biased digits.** Every operand byte is stored ``b ^ 0x80`` (``b - 128``
   as int8) and every matrix entry ``e`` as ``e - 128``; a ones column in the
   matrix recovers the exact unbiased contraction::

       true[col] = acc[col] + 128 * acc[ones] + C[col],
       C[col]    = 128 * sum_rows e[row, col]

3. **Base-256 epilogue.** A uint32 carry chain turns the biased int32
   accumulator into base-256 digits; with fused reconstruction those digits
   feed a second contraction directly, and only its result is folded to
   canonical 16-bit limbs (pseudo-Mersenne fold or Montgomery chunk fold).
4. **u16-field randomness sums.** In PRNG mode each participant's sharing
   randomness is drawn in full in the kernel and summed over participants as
   two u16 fields per 32-bit word; the field sums, re-split into biased
   bytes, meet one participant-count-independent matrix.

Layout: batch positions are lanes; secrets arrive ``[P*slots*L8, NBP]``
int8 (participant-major, then slot, then byte); the output is
``[L * n_out, NBP]`` int32 canonical 16-bit limbs, limb-major.

**Randomness.** The TPU kernel drew words from the TPU's own generator,
seeded with ``seed + program_id``; its bits cannot be reproduced. Here every
word comes from Philox4x32-10 with key ``(seed mod 2^32, 0)`` and counter
``(lane, draw, group, 0)``: ``lane`` is the global lane index, ``draw`` the
participant draw in ``[0, rand_participants)`` and ``group`` the word group;
PRNG word ``w`` of a (lane, draw) is output word ``w % 4`` of group
``w // 4``. No two lanes, draws or words share a counter, and the result does
not depend on how lanes are tiled. The CUDA kernel and the plain version
below use this same mapping, so they agree bit for bit in PRNG mode too.

**Past one launch's participants.** The uint32 carry chain bounds the
operand rows one pipeline pass can sum (65,793, see :func:`mxu8_plan`).
Two variants of the kernel go past it, as the reference's do:

- ``n_chunks > 1`` (B2): ``sec_planar`` stacks ``n_chunks`` chunks of
  ``p_count`` participants along its rows; each chunk runs the whole
  single-chunk pipeline, their canonical results are added mod p, and the
  sum is written once, by ONE call. On the card that call splits each
  128-lane block's K tiles and randomness draws ``S`` ways across blocks
  (:func:`split_ranges`, :func:`chunked_splits`), sums the int32 partials
  in a workspace and runs the epilogue in a second kernel; ``splits=``
  gives the plain version the same partition, whose wrap-around sums equal
  the unsplit ones.
- ``acc_in`` (B3): this launch's canonical result is added mod p onto
  ``acc_in`` in place, and ``acc_in`` itself is returned. This is the
  port's form of the reference's ``input_output_aliases`` and its donated
  accumulator: the host-driven streaming loop keeps one running buffer.

**Wide plans** (:func:`is_wide`: more than ``MAX_MT_ROWS`` output rows, as
a committee of hundreds of clerks has) run combine-only and one chunk a
call, on a variant of their own (``csrc/mxu8.cu`` mode 3): the randomness
operand drawn once per call, the output rows tiled over the grid, wgmma
where one participant's columns of ``bigs`` fit in shared memory. Its
arithmetic is B1's and B3's, so the plain version serves it unchanged.

**Randomness per chunk.** Chunk ``c`` of a chunked call with seed ``s``
draws with key ``((s + c * grid_t) mod 2^32, 0)``, ``grid_t = NBP //
lanes``: the seed the reference's streaming loop passes for chunk ``c``
(``seed0 + grid_size * c``) and the offset its chunked body adds. So chunk
0 draws B1's stream, and a chunked call with seed ``s`` and the streaming
loop with ``seed0 = s`` draw the same randomness chunk for chunk: their
combined outputs (no reconstruction) are bit-equal in PRNG mode.

**Integer representation.** The plain version carries every u32 lane in
int64 and masks with ``& 0xFFFFFFFF`` wherever the reference relies on
uint32 wrap: the carry chains (``_true_chain``), the three-op randomness
accumulate and the Philox multiplies, which are split into 16-bit halves
because a 32x32-bit product does not fit signed int64.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from sda_tpu_torch.ops.limbs import LimbContext, to_limbs

__all__ = [
    "Mxu8Context",
    "fused_share_combine_mxu8",
    "mxu8_plan",
    "run_mxu8",
    "planar8_from_batched",
    "batched_from_planar_lm",
    "limbs8_host",
    "philox4x32_10",
    "philox_words",
    "KERNEL_VARIANTS",
    "kernel_mt",
    "kernel_occupancy",
    "split_ranges",
    "chunked_splits",
    "launch_splits",
    "is_wide",
]

_W8 = 8
_MASK8 = (1 << _W8) - 1
_W16 = 16
_MASK16 = (1 << _W16) - 1
_M32 = 0xFFFFFFFF
_BIAS = 128
# the uint32 carry chain's bound on summed rows (see fused_share_combine_mxu8)
_MAX_RAND_PARTICIPANTS = 65793

# the kernels' K tile (rows) and ring depth (csrc/mxu8.cu: kKT, kStages)
KT = 64
RING_STAGES = 4
# output rows (n * L8 + 1) that B1-B3's MT tiles hold (csrc/mxu8.cu: kMaxMT);
# wider plans run the wide variant
MAX_MT_ROWS = 192

# Launches of each variant of the CUDA kernel (one per call on a CUDA
# tensor): B1 single chunk, B2 chunked (a memset and two kernels), B3
# accumulate; B1 and B3 on wide plans (the randomness kernel in PRNG mode,
# then the wide kernel) count apart, as mxu8_wide_launches.
mxu8_launches = 0
mxu8_chunked_launches = 0
mxu8_acc_launches = 0
mxu8_wide_launches = 0

# Each variant is its own build of csrc/mxu8.cu: name -> (source, defines).
KERNEL_VARIANTS = {
    "mxu8_fused": ("mxu8.cu", ("SDA_MXU8_MODE=0",)),
    "mxu8_acc": ("mxu8.cu", ("SDA_MXU8_MODE=1",)),
    "mxu8_chunked": ("mxu8.cu", ("SDA_MXU8_MODE=2",)),
    "mxu8_wide": ("mxu8.cu", ("SDA_MXU8_MODE=3",)),
}


def limbs8_host(values, L8: int) -> np.ndarray:
    """Host: object/int array -> ``[..., L8]`` uint8 byte limbs."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    out = np.zeros((flat.size, L8), dtype=np.uint8)
    for i, v in enumerate(flat):
        v = int(v)
        if v < 0:
            raise ValueError("limbs8_host requires non-negative values")
        for j in range(L8):
            out[i, j] = v & _MASK8
            v >>= _W8
        if v:
            raise ValueError("value does not fit limb count")
    return out.reshape(arr.shape + (L8,))


@dataclass(frozen=True)
class Mxu8Context:
    """Per-modulus constants for the byte-limb path.

    ``L8``: bytes per canonical element (``2 * ctx.L``); ``chunk8``: bytes per
    canonical-by-construction chunk (``2^(8*chunk8) <= p``); ``L16r``: u16
    randomness limbs per sharing-randomness slot (the fold width, see
    :meth:`create`); ``special``: ``(e, c)`` when ``p = 2^e - c`` with small c.
    """

    ctx: LimbContext
    L8: int
    chunk8: int
    L16r: int
    special: tuple[int, int] | None = None

    @classmethod
    def create(cls, ctx: LimbContext, rand_fold_k: int = 1) -> "Mxu8Context":
        p = ctx.p
        if p.bit_length() <= _W8:
            raise ValueError("modulus too small for byte-limb chunking")
        e = p.bit_length()
        c = (1 << e) - p
        # pseudo-Mersenne fast reduction: c must keep the per-half products
        # in u32, and bit e must live inside the lanes
        special = (e, c) if c < (1 << 14) and e < _W16 * ctx.L else None
        # Randomness-fold width. Folding a uniform b-bit draw mod p has
        # total-variation bias ~rem/2^b with rem = 2^b mod p. For
        # pseudo-Mersenne p = 2^e - c the bias is a staircase in b: ~c/2^e
        # for b in [e, 2e - log2(c)), then ~(c/2^e)^2; e-sized width steps
        # square it. rand_fold_k=1 takes the minimal width b = k*e rounded up
        # to u16 limbs (bias ~2^-53 at the 63-bit production prime, ~2^-116
        # at the 128-bit one); rand_fold_k=2 restores b >= 2e at double the
        # PRNG cost. This randomness serves device-trust benchmark/serving
        # sharing only; host-CSPRNG randomness (the protocol path) never uses
        # it. Generic primes keep 64 guard bits (bias <= 2^-64).
        if rand_fold_k < 1:
            raise ValueError("rand_fold_k must be >= 1")
        if special is not None:
            L16r = -(-(rand_fold_k * e + 1) // _W16)
        else:
            L16r = -(-(p.bit_length() + 64) // _W16) + (rand_fold_k - 1) * (
                -(-p.bit_length() // _W16)
            )
        return cls(
            ctx=ctx,
            L8=2 * ctx.L,
            chunk8=(p.bit_length() - 1) // _W8,
            L16r=L16r,
            special=special,
        )

    @property
    def rand_words(self) -> int:
        """u32 PRNG words per (participant, randomness slot): two u16
        randomness limbs per word."""
        return -(-self.L16r // 2)


def planar8_from_batched(mxu8: Mxu8Context, x16, lanes: int) -> torch.Tensor:
    """``[P, NB, s, L] limbs -> [P*s*L8, NBP] int8`` biased planar bytes.

    ``NBP`` rounds ``NB`` up to a multiple of ``lanes``. Padding lanes hold
    biased zero (-128), which the ones-column algebra treats as the value 0
    exactly. Row order is participant-major, then slot, then byte.
    """
    p, nb, s, _ = x16.shape
    x16 = x16.to(torch.int64)
    # biased byte b ^ 0x80 read as int8 is b - 128
    x8 = torch.stack(
        [((x16[..., j // 2] >> (_W8 * (j % 2))) & _MASK8) - _BIAS for j in range(mxu8.L8)],
        dim=-1,
    ).to(torch.int8)  # [P, NB, s, L8]
    nbp = -(-nb // lanes) * lanes
    if nbp != nb:
        x8 = torch.nn.functional.pad(x8, (0, 0, 0, 0, 0, nbp - nb), value=-_BIAS)
    return x8.permute(0, 2, 3, 1).reshape(p * s * mxu8.L8, nbp).contiguous()


def batched_from_planar_lm(y, nb: int, n_out: int) -> torch.Tensor:
    """``[L * n_out, NBP] -> [NB, n_out, L]`` (limb-major output back to the
    batched layout, slicing the lane padding off)."""
    L = y.shape[0] // n_out
    return y.reshape(L, n_out, -1).permute(2, 1, 0)[:nb]


# ------------------------------------------------------- matrix builders


def _reduced_row8(mxu8: Mxu8Context, m_col, shift: int) -> np.ndarray:
    """Unbiased entries ``limb8_l2(m_col[i] * 2^shift mod p)``: ``[n*L8]``
    uint8 for every output column ``(i, l2)``."""
    p = mxu8.ctx.p
    vals = [(int(v) * pow(2, shift, p)) % p for v in m_col]
    return limbs8_host(np.array(vals, dtype=object), mxu8.L8).reshape(-1)


def _reduced_rows8(mxu8: Mxu8Context, m_rows, shifts) -> np.ndarray:
    """:func:`_reduced_row8` of each row of ``m_rows`` ``[R, n]`` (canonical
    entries) with its shift: ``[R, n*L8]`` uint8. In int64 below p = 2^31,
    where every product of two residues is below 2^62; else row by row in
    Python ints."""
    p, L8 = mxu8.ctx.p, mxu8.L8
    if p >= (1 << 31):
        return np.stack([_reduced_row8(mxu8, row, int(s)) for row, s in zip(m_rows, shifts)])
    scale = np.array([pow(2, int(s), p) for s in shifts], dtype=np.int64)
    vals = np.asarray(m_rows, dtype=np.int64).reshape(len(scale), -1) * scale[:, None] % p
    limbs = (vals[..., None] >> (_W8 * np.arange(L8, dtype=np.int64))) & _MASK8
    return limbs.astype(np.uint8).reshape(len(scale), -1)


def _finish_big8(e_cols: np.ndarray, n_pad: int):
    """Unbiased entry matrix ``[rows, n*L8]`` -> (biased int8 ``[n_pad,
    rows]`` with the ones column at ``n*L8``, per-column bias constant
    ``C = 128 * colsum(e)`` as int64 ``[n*L8]``)."""
    rows, cols = e_cols.shape
    if cols + 1 > n_pad:
        raise ValueError("n_pad too small")
    big = np.zeros((n_pad, rows), dtype=np.int8)
    big[:cols] = (e_cols ^ np.uint8(_BIAS)).view(np.int8).T  # b ^ 0x80 read as int8 is b - 128
    big[cols] = 1  # ones column: acc[ones] = sum of biased operand values
    C = _BIAS * e_cols.sum(axis=0, dtype=np.int64)
    return big, C


def _big8_slots(mxu8: Mxu8Context, m_normal, slot_rows, n_pad: int,
                limb_major: bool = False):
    """Reduced biased ``big^T [n_pad, rows]`` for per-slot byte operands.

    Row for (slot ``j``, byte ``l1``) holds ``limb8_l2(M[j,i]*2^(8*l1) mod
    p) - 128`` at column ``(i, l2)``. ``limb_major`` orders rows ``(l1,
    j)``; the default is ``(j, l1)``, slot-major, matching
    :func:`planar8_from_batched`.
    """
    m_normal = np.asarray(m_normal, dtype=object)
    L8 = mxu8.L8
    slots = sorted(set(slot_rows))
    # every distinct (slot, byte) row once, then gathered in operand order
    uniq = _reduced_rows8(mxu8, m_normal[[j for j in slots for _ in range(L8)]],
                          [_W8 * l1 for _ in slots for l1 in range(L8)])
    at = {j: i * L8 for i, j in enumerate(slots)}
    if limb_major:
        order = [at[j] + l1 for l1 in range(L8) for j in slot_rows]
    else:
        order = [at[j] + l1 for j in slot_rows for l1 in range(L8)]
    return _finish_big8(uniq[order], n_pad)  # [rows, n*L8] before the finish


def _big8_randsum(mxu8: Mxu8Context, m_normal, k: int, rand_count: int,
                  n_pad: int, words_per_p: int, n_bytes: int):
    """Reduced biased matrix for the summed-randomness operand.

    The kernel sums each PRNG word's two u16 halves over participants
    (``accE`` = low halves = u16 limb ``2w``, ``accO`` = high = ``2w + 1``)
    and re-splits each field sum into ``n_bytes`` biased bytes. Row ``(c,
    parity, w)`` of the operand therefore carries u16 limb ``f = 2w +
    parity`` of randomness slot ``k + f // L16r`` with weight ``2^(16*(f %
    L16r) + 8*c)``. Limb positions past ``rand_count * L16r`` are padding
    (true entry 0).
    """
    m_normal = np.asarray(m_normal, dtype=object)
    n = m_normal.shape[1]
    L16r = mxu8.L16r
    keys: dict[tuple[int, int], int] = {}  # (slot, shift) -> row of the distinct rows
    order = []
    for c in range(n_bytes):
        for parity in (0, 1):
            for w in range(words_per_p):
                f = 2 * w + parity
                if f >= rand_count * L16r:
                    order.append(-1)  # padding: the zero row
                    continue
                key = (k + f // L16r, _W16 * (f % L16r) + _W8 * c)
                order.append(keys.setdefault(key, len(keys)))
    uniq = np.zeros((len(keys) + 1, n * mxu8.L8), dtype=np.uint8)
    if keys:
        uniq[:-1] = _reduced_rows8(mxu8, m_normal[[s for s, _ in keys]], [sh for _, sh in keys])
    return _finish_big8(uniq[order], n_pad)


def _big8_stage2(mxu8: Mxu8Context, rec, n: int, n2: int, n_res1: int,
                 n_pad2: int):
    """Stage-2 (reconstruction) matrix: limb-major rows over the stage-1
    carry-chain output (``L8 + n_res1`` bytes per clerk)."""
    rec = np.asarray(rec, dtype=object)
    rows = [(i, _W8 * l1) for l1 in range(mxu8.L8 + n_res1) for i in range(n)]
    e = _reduced_rows8(mxu8, rec[[i for i, _ in rows]], [s for _, s in rows])
    return _finish_big8(e, n_pad2)


def _chunk_consts8(mxu8: Mxu8Context, n_chunks: int) -> np.ndarray:
    """``[n_chunks, L]`` uint32: Montgomery-form ``2^(8*chunk8*t)``."""
    ctx = mxu8.ctx
    R = 1 << (_W16 * ctx.L)
    vals = [
        (pow(2, _W8 * mxu8.chunk8 * t, ctx.p) * R) % ctx.p for t in range(n_chunks)
    ]
    return to_limbs(np.array(vals, dtype=object), ctx.L).astype(np.uint32)


def _residual_limbs(row_bound: int) -> int:
    """Byte limbs needed for the steady-state carry of a chain whose
    columns are bounded by ``row_bound`` (carry ``<= row_bound / 255``)."""
    return max(1, -(-((row_bound // 255) + 1).bit_length() // _W8))


# ------------------------------------------------------------------ Philox

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for ``a`` in ``[0, 2^32)``
    (int64) and a 32-bit constant ``m``, from 16-bit half products: the full
    product does not fit signed int64."""
    a_lo, a_hi = a & _MASK16, a >> _W16
    m_lo, m_hi = m & _MASK16, m >> _W16
    mid = a_hi * m_lo + a_lo * m_hi  # < 2^33
    t = a_lo * m_lo + ((mid & _MASK16) << _W16)  # < 2^33
    hi = (a_hi * m_hi + (mid >> _W16) + (t >> 32)) & _M32
    return hi, t & _M32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors.

    ``counter``: four broadcastable tensors of u32 values; ``key``: two
    python ints. Returns the four output words (int64, in ``[0, 2^32)``).
    """
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key[0] & _M32, key[1] & _M32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seed: int, lanes: torch.Tensor, draws: torch.Tensor, n_words: int,
                 tag: int) -> torch.Tensor:
    """The first ``n_words`` PRNG words ``[D, n_words, T]`` (int64, u32
    values) of every (draw, lane) for the global lane indices ``lanes``
    ``[T]`` and draws ``draws`` ``[D]``: word ``w`` is output word ``w % 4``
    of Philox4x32-10 with key ``(seed, 0)`` at counter ``(lane, draw, w //
    4, tag)``. The port's kernels share this mapping and differ in ``tag``."""
    groups = -(-n_words // 4)
    dev = lanes.device
    group = torch.arange(groups, dtype=torch.int64, device=dev)[None, :, None]
    words = philox4x32_10(
        (lanes[None, None, :], draws[:, None, None], group,
         torch.full((), tag, dtype=torch.int64, device=dev)),
        (seed, 0),
    )
    return torch.stack(words, dim=2).reshape(draws.shape[0], groups * 4, -1)[:, :n_words]


def _rand_operand(plan: "Mxu8Plan", seed: int, lanes: torch.Tensor,
                  draw_ranges=None) -> torch.Tensor:
    """Biased randomness operand ``[Kr, T]`` (int64 values ``b - 128``) for
    the global lane indices ``lanes``: u16-field sums of every draw's PRNG
    words, in the ``(c, parity, w)`` row order of :func:`_big8_randsum`.
    ``draw_ranges`` (default: all draws) cuts the draws into ranges whose
    u32 sums are added with wrap-around, as B2's split blocks add theirs."""
    accR = accO = 0
    for j0, j1 in draw_ranges or [(0, plan.rp)]:
        draws = torch.arange(j0, j1, dtype=torch.int64, device=lanes.device)
        words = philox_words(seed, lanes, draws, plan.words_per_p, 0)  # [j1 - j0, wpp, T]
        accR = (accR + (words.sum(dim=0) & _M32)) & _M32
        accO = (accO + ((words >> _W16).sum(dim=0) & _M32)) & _M32
    # accR = sum(lo) + 2^16 sum(hi) mod 2^32 and sum(lo) < 2^32: exact
    accE = (accR - (accO << _W16)) & _M32
    parts = []
    for c in range(plan.n_bytes):
        for s in (accE, accO):
            parts.append(((s >> (_W8 * c)) & _MASK8) - _BIAS)
    return torch.cat(parts, dim=0)


# ------------------------------------------------------- B2's partition


def split_ranges(per_chunk: int, n_chunks: int, splits: int) -> list[list[tuple[int, int, int]]]:
    """B2's partition of one lane block's work: for each split ``s`` of
    ``splits``, its pieces ``(chunk, begin, end)`` of the flattened list of
    ``n_chunks * per_chunk`` (chunk, item) pairs, pairs ``[s * total //
    splits, (s + 1) * total // splits)`` cut where a chunk ends. Items are
    K tiles of ``KT`` rows or randomness draws; ``csrc/mxu8.cu``
    (``for_pieces``) and ``csrc/probes.cu`` (T3) cut them the same way."""
    if splits < 1:
        raise ValueError("splits must be >= 1")
    total = per_chunk * n_chunks
    out = []
    for s in range(splits):
        i, end, pieces = total * s // splits, total * (s + 1) // splits, []
        while i < end:
            c, b = divmod(i, per_chunk)
            e = min(per_chunk, b + end - i)
            pieces.append((c, b, e))
            i += e - b
        out.append(pieces)
    return out


def _pieces_by_chunk(per_chunk: int, n_chunks: int, splits: int | None):
    """``[chunk][(begin, end), ...]``: every split's pieces of each chunk
    (one whole range per chunk when ``splits`` is None)."""
    if splits is None:
        return [[(0, per_chunk)] for _ in range(n_chunks)]
    out = [[] for _ in range(n_chunks)]
    for pieces in split_ranges(per_chunk, n_chunks, splits):
        for c, b, e in pieces:
            out[c].append((b, e))
    return out


def chunked_splits(lane_blocks: int, tiles_per_chunk: int, n_chunks: int, sms: int,
                   blocks_per_sm: int) -> int:
    """The split count ``S`` of a B2 launch: as many splits as put
    ``lane_blocks * S`` blocks on the card's ``sms * blocks_per_sm`` slots
    in one wave (a second, partial wave would double the time of its
    blocks' lane blocks), at least 1, and no more than leave each split a
    ring's worth (``RING_STAGES``) of K tiles."""
    slots = sms * max(1, blocks_per_sm)
    return max(1, min(slots // max(1, lane_blocks), tiles_per_chunk * n_chunks // RING_STAGES))


# ------------------------------------------------------------------- plan


@dataclass(frozen=True)
class Mxu8Plan:
    """Everything one fused call needs besides its operand and seed: the
    biased matrices and constant tables on the operand's device, and the
    shapes the kernel and its plain version read."""

    mxu8: Mxu8Context
    n: int  # clerks (stage-1 outputs)
    n_out: int  # n, or k2 with fused reconstruction
    rows: int  # operand rows of one chunk
    period: int  # operand rows of one participant: bigs's columns repeat with it
    n_chunks: int  # chunks stacked along the operand's rows
    n_pad: int
    rp: int  # randomness draws summed per slot (0: caller randomness)
    words_per_p: int
    n_bytes: int
    n_res1: int
    n2: int
    n_res2: int
    use_special: bool
    bigs: torch.Tensor  # [n_pad, rows] int8
    bigr: torch.Tensor  # [n_pad, Kr_pad] int8, zero columns past Kr
    Kr: int
    big2: torch.Tensor  # [n_pad2, (L8 + n_res1) * n] int8
    c1: torch.Tensor  # [n, L8] int64
    c2: torch.Tensor  # [n2, L8] int64
    consts: torch.Tensor  # [n_consts, L] int64
    tables: torch.Tensor  # c1 | c2 | consts | p limbs, as uint32 bits in int32


def mxu8_plan(
    mxu8: Mxu8Context,
    share_matrix,
    rows: int,
    p_count: int,
    k: int,
    rand_count: int,
    reconstruct_matrix=None,
    pg: int | None = None,
    rand_participants: int | None = None,
    device="cpu",
    n_chunks: int = 1,
) -> Mxu8Plan:
    """Build the matrices and constants of one fused configuration
    (``n_chunks`` chunks of ``rows`` operand rows each) on ``device``; the
    guards are the reference's, the carry-chain bound is per chunk."""
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    m = k + rand_count
    share_matrix = np.asarray(share_matrix, dtype=object)
    n = share_matrix.shape[1]
    L8, L = mxu8.L8, mxu8.ctx.L
    if rows == p_count * k * L8:
        has_prng = True
    elif rows == p_count * m * L8:
        has_prng = False
    else:
        raise ValueError("sec_planar rows match neither k nor k+r slots")

    rp = words_per_p = n_bytes = 0
    if has_prng and rand_count:
        # rand_participants: independent randomness draws summed per slot.
        # Default p_count mirrors the protocol workload; 1 is the
        # combined-draw serving mode (a sum of P uniform draws mod p is one
        # uniform draw, sound only inside the fused combine's trust model).
        rp = p_count if rand_participants is None else rand_participants
        if rp < 1:
            raise ValueError("rand_participants must be >= 1")
        if rp > _MAX_RAND_PARTICIPANTS:
            raise ValueError("rand_participants exceeds the u16-field sum bound (65793)")
        words_per_p = rand_count * mxu8.rand_words
        n_bytes = max(2, -(-((rp * _MASK16).bit_length()) // _W8))
        # pg (participants per TPU PRNG draw) keeps the reference's guard;
        # the counter-based generator here draws every participant alike
        if pg is not None and rp % pg:
            raise ValueError("pg must divide rand_participants")

    slots = list(range(k)) if has_prng else list(range(m))
    n_pad = -(-(n * L8 + 1) // 32) * 32
    # one participant's columns; every participant's are the same (tiled on
    # the device below), and so is each one's share of the bias constants
    bigs, C1 = _big8_slots(mxu8, share_matrix, slots, n_pad)
    C1 = C1 * p_count
    Kr = 0
    bigr = np.zeros((n_pad, 32), dtype=np.int8)
    if rp:
        bigr_u, Cr = _big8_randsum(
            mxu8, share_matrix, k, rand_count, n_pad, words_per_p, n_bytes
        )
        C1 = C1 + Cr
        Kr = bigr_u.shape[1]
        bigr = np.zeros((n_pad, -(-Kr // 32) * 32), dtype=np.int8)
        bigr[:, :Kr] = bigr_u

    # Every row adds at most 255*255 to a column's unbiased value and the
    # uint32 carry chain needs column + incoming carry < 2^32, so
    # K_rows * (255^2 + 255) < 2^32, i.e. K_rows <= 65793.
    K_rows = bigs.shape[1] * p_count + Kr
    row_bound = K_rows * _MASK8 * _MASK8
    if K_rows * (_MASK8 * _MASK8 + _MASK8) >= (1 << 32):
        raise ValueError(
            "participants * scheme_size exceeds the uint32 carry-chain "
            "bound; chunk the participant axis (n_chunks / engine "
            "streaming path)"
        )
    n_res1 = _residual_limbs(row_bound)
    C1 = C1.reshape(n, L8)

    n2 = n_res2 = 0
    C2 = np.zeros((0, L8), dtype=np.int64)
    big2 = np.zeros((32, 32), dtype=np.int8)
    if reconstruct_matrix is not None:
        rec = np.asarray(reconstruct_matrix, dtype=object)
        if rec.shape[0] != n:
            raise ValueError("reconstruct_matrix rows must equal share count")
        n2 = rec.shape[1]
        n_pad2 = -(-(n2 * L8 + 1) // 32) * 32
        big2, C2 = _big8_stage2(mxu8, rec, n, n2, n_res1, n_pad2)
        n_res2 = _residual_limbs(big2.shape[1] * _MASK8 * _MASK8)
        C2 = C2.reshape(n2, L8)

    n_limbs = (L8 + n_res2) if n2 else (L8 + n_res1)
    consts = _chunk_consts8(mxu8, -(-n_limbs // mxu8.chunk8))
    use_special = mxu8.special is not None and _W8 * n_limbs - mxu8.special[0] <= 31
    table = np.concatenate([
        C1.reshape(-1), C2.reshape(-1), consts.reshape(-1).astype(np.int64),
        np.asarray(mxu8.ctx.p_limbs, dtype=np.int64),
    ]).astype(np.uint32).view(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Mxu8Plan(
        mxu8=mxu8, n=n, n_out=n2 if n2 else n, rows=rows, period=rows // p_count,
        n_chunks=n_chunks, n_pad=n_pad,
        rp=rp, words_per_p=words_per_p, n_bytes=n_bytes, n_res1=n_res1,
        n2=n2, n_res2=n_res2, use_special=use_special,
        bigs=dev(bigs).repeat(1, p_count), bigr=dev(bigr), Kr=Kr, big2=dev(big2),
        c1=dev(C1.astype(np.int64)), c2=dev(C2.astype(np.int64)),
        consts=dev(consts.astype(np.int64)), tables=dev(table),
    )


# ------------------------------------------------------- the plain version


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` for int8-range operands, through float64:
    every product is below 2^14 and every sum below 2^31, far inside the
    2^53 of float64's exact integers, so any summation order is exact."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _true_chain(acc_cols, c_ref, s128, n_res: int):
    """Biased accumulator columns ``[n, L8, T]`` -> ``L8 + n_res`` byte limbs
    ``[n, T]`` of ``true[i] = sum_c (acc[i,c] + C[i,c] + s128) * 2^(8c)``.

    The chain runs in uint32 arithmetic (int64 masked to 32 bits): the
    biased accumulator wraps to its residue mod 2^32, and since every true
    column value is non-negative and below 2^32, the mod-2^32 sum is the
    true value exactly.
    """
    acc_u = acc_cols & _M32
    limbs = []
    carry = torch.zeros_like(s128)
    for c in range(acc_cols.shape[1]):
        t = (acc_u[:, c, :] + c_ref[:, c : c + 1] + s128 + carry) & _M32
        limbs.append(t & _MASK8)
        carry = t >> _W8
    for _ in range(n_res):
        limbs.append(carry & _MASK8)
        carry = carry >> _W8
    return limbs


def _shl32(x, s: int):
    """uint32 ``x << s`` (0 once ``s >= 32``, as a u32 shift gives)."""
    return (x << s) & _M32 if s < 32 else torch.zeros_like(x)


def _fold8_special(mxu8: Mxu8Context, limbs):
    """Pseudo-Mersenne canonicalisation (``p = 2^e - c``): byte limbs -> L
    16-bit lanes. ``V = lo + 2^e * hi ≡ lo + c * hi``; two fold rounds bring
    any ``V < 2^(e+31)`` under ``2^e + c``, one conditional subtract lands in
    ``[0, p)``."""
    ctx = mxu8.ctx
    e, c = mxu8.special
    L = ctx.L
    zero = torch.zeros_like(limbs[0])
    lanes = []
    for w in range(-(-len(limbs) // 2)):
        v = limbs[2 * w]
        if 2 * w + 1 < len(limbs):
            v = v | (limbs[2 * w + 1] << _W8)
        lanes.append(v)
    wE, sh = e // _W16, e % _W16
    for _round in range(2):
        hi = lanes[wE] >> sh
        bits = _W16 - sh
        for w in range(wE + 1, len(lanes)):
            hi = hi | _shl32(lanes[w], bits)
            bits += _W16
        lanes = lanes[:wE] + [lanes[wE] & ((1 << sh) - 1)]
        lanes += [zero] * (L - len(lanes))
        # V mod p = lo + hi*c; halves keep every product inside u32
        add0 = (hi & _MASK16) * c
        add1 = (hi >> _W16) * c
        incoming = (add0 & _MASK16, (add0 >> _W16) + (add1 & _MASK16), add1 >> _W16)
        carry = zero
        for w in range(L):
            t = lanes[w] + (incoming[w] if w < 3 else zero) + carry
            lanes[w] = t & _MASK16
            carry = t >> _W16
    return ctx._cond_sub(lanes[:L], zero)


def _fold8(plan: Mxu8Plan, limbs):
    """Byte limbs (list of ``[n, T]``) -> canonical L 16-bit lanes.

    Chunks of ``chunk8`` bytes are canonical by construction; each regroups
    into 16-bit lanes (two bytes per lane) and folds with one Montgomery
    multiply by ``2^(8*chunk8*t)``; pseudo-Mersenne moduli take the
    multiply-free :func:`_fold8_special` when the value is narrow enough.
    """
    mxu8 = plan.mxu8
    if plan.use_special:
        return _fold8_special(mxu8, limbs)
    ctx = mxu8.ctx
    zero = torch.zeros_like(limbs[0])
    res = None
    for t in range(-(-len(limbs) // mxu8.chunk8)):
        group = limbs[t * mxu8.chunk8 : (t + 1) * mxu8.chunk8]
        lanes16 = [zero] * ctx.L
        for j, b in enumerate(group):
            lanes16[j // 2] = lanes16[j // 2] | (b << (_W8 * (j % 2)))
        term = ctx.mont_mul_lanes(lanes16, [plan.consts[t, l] for l in range(ctx.L)])
        res = term if res is None else ctx.add_mod_lanes(res, term)
    return res


def _plain_block(plan: Mxu8Plan, sec: torch.Tensor, seed: int, lane0: int, row_ranges,
                 draw_ranges) -> torch.Tensor:
    mxu8 = plan.mxu8
    n, L8 = plan.n, mxu8.L8
    # the int32 partials of the row ranges, added with wrap-around
    acc = 0
    for r0, r1 in row_ranges:
        acc = (acc + (_dot(plan.bigs[:, r0:r1], sec[r0:r1]) & _M32)) & _M32  # [n_pad, T]
    if plan.Kr:
        lanes = torch.arange(lane0, lane0 + sec.shape[1], dtype=torch.int64, device=sec.device)
        rand = _rand_operand(plan, seed, lanes, draw_ranges)
        acc = (acc + _dot(plan.bigr[:, : plan.Kr], rand)) & _M32
    s128 = (acc[n * L8] * _BIAS) & _M32  # ones column
    limbs = _true_chain(acc[: n * L8].reshape(n, L8, -1), plan.c1, s128, plan.n_res1)
    if plan.n2:
        # fused reconstruction: stage-1 bytes, limb-major, feed stage 2
        c8 = torch.cat([b - _BIAS for b in limbs], dim=0)
        acc2 = _dot(plan.big2, c8)
        s128_2 = (acc2[plan.n2 * L8] * _BIAS) & _M32
        limbs = _true_chain(
            acc2[: plan.n2 * L8].reshape(plan.n2, L8, -1), plan.c2, s128_2, plan.n_res2
        )
    return torch.cat(_fold8(plan, limbs), dim=0).to(torch.int32)


def _plain_chunk(plan: Mxu8Plan, sec: torch.Tensor, seed: int, row_ranges=None,
                 draw_ranges=None) -> torch.Tensor:
    """One chunk's pipeline, its operand rows and draws summed over
    ``row_ranges`` and ``draw_ranges`` (default: one range each). Lanes are
    independent, so they run in blocks that bound the float64 operand and
    the Philox intermediates to about 2^27 elements each."""
    nbp = sec.shape[1]
    row_ranges = row_ranges or [(0, plan.rows)]
    groups = -(-plan.words_per_p // 4) if plan.rp else 0
    block = max(1, min(nbp, (1 << 27) // max(plan.rows, 4 * plan.rp * groups, 1)))
    out = torch.empty((plan.mxu8.ctx.L * plan.n_out, nbp), dtype=torch.int32, device=sec.device)
    for l0 in range(0, nbp, block):
        l1 = min(nbp, l0 + block)
        out[:, l0:l1] = _plain_block(plan, sec[:, l0:l1], seed, l0, row_ranges, draw_ranges)
    return out


def _add_mod_lm(plan: Mxu8Plan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a + b) mod p`` of two limb-major ``[L * n_out, NBP]`` outputs."""
    n_out, L = plan.n_out, plan.mxu8.ctx.L

    def lanes(x):
        return [x[l * n_out : (l + 1) * n_out].to(torch.int64) for l in range(L)]

    return torch.cat(plan.mxu8.ctx.add_mod_lanes(lanes(a), lanes(b)), dim=0).to(torch.int32)


def _fused_share_combine_mxu8_plain(
    plan: Mxu8Plan, sec: torch.Tensor, seed: int, seed_stride: int = 0, acc_in=None,
    splits: int | None = None,
) -> torch.Tensor:
    """The fused function in plain int64 tensor code (any device): the
    CUDA kernel's arithmetic, step for step, with the same Philox mapping.
    Chunk ``c`` of ``plan.n_chunks`` draws with seed ``seed + c *
    seed_stride``; the chunks' canonical results are added mod p. With
    ``acc_in`` the result is added onto ``acc_in`` in place, and ``acc_in``
    is returned. ``splits``: B2's partition into that many splits of each
    chunk's K tiles and draws (:func:`split_ranges`), each piece's partial
    sums added with wrap-around; the result does not depend on it."""
    rows = plan.rows
    tiles = _pieces_by_chunk(-(-rows // KT), plan.n_chunks, splits)
    draws = _pieces_by_chunk(plan.rp, plan.n_chunks, splits)
    out = None
    for c in range(plan.n_chunks):
        row_ranges = [(b * KT, min(e * KT, rows)) for b, e in tiles[c]]
        res = _plain_chunk(plan, sec[c * rows : (c + 1) * rows], (seed + c * seed_stride) & _M32,
                           row_ranges, draws[c])
        out = res if out is None else _add_mod_lm(plan, out, res)
    if acc_in is None:
        return out
    acc_in.copy_(_add_mod_lm(plan, acc_in, out))
    return acc_in


# ------------------------------------------------------------------ kernel


def _kernel_params(plan: Mxu8Plan, nbp: int, seed: int, seed_stride: int) -> np.ndarray:
    """The kernel's ``Params`` as ``csrc/mxu8.cu`` reads them: int32, in
    field order, the seeds as their 32-bit patterns."""
    mxu8 = plan.mxu8
    L, L8 = mxu8.ctx.L, mxu8.L8
    e, c = mxu8.special or (0, 0)
    off_c2 = plan.n * L8
    off_consts = off_c2 + plan.n2 * L8
    off_p = off_consts + plan.consts.shape[0] * L
    return np.array([
        plan.rows, nbp, plan.n_pad, plan.Kr, plan.bigr.shape[1], plan.n, L8,
        plan.n_res1, plan.n2, plan.big2.shape[0], plan.big2.shape[1], plan.n_res2,
        L, mxu8.chunk8, int(plan.use_special), e, c, mxu8.ctx.p_inv_w,
        plan.rp, plan.words_per_p, plan.n_bytes,
        np.uint32(seed & _M32).view(np.int32), 0, off_c2, off_consts, off_p,
        plan.consts.shape[0], plan.n_chunks, np.uint32(seed_stride & _M32).view(np.int32),
    ], dtype=np.int32)


def is_wide(plan: Mxu8Plan) -> bool:
    """Whether the plan's ``n * L8 + 1`` output rows exceed what B1-B3's MT
    tiles hold: it then runs the wide variant, combine-only and one chunk a
    call."""
    return plan.n * plan.mxu8.L8 + 1 > MAX_MT_ROWS


def _variant(plan: Mxu8Plan, acc: bool) -> str:
    if is_wide(plan):
        return "mxu8_wide"
    return "mxu8_chunked" if plan.n_chunks > 1 else "mxu8_acc" if acc else "mxu8_fused"


def kernel_mt(plan: Mxu8Plan) -> int:
    """The ``MT`` template instance of ``csrc/mxu8.cu`` that a launch with
    this plan runs: the m16 tiles of the ``n * L8`` output rows before the
    ones row, which the kernel sums apart."""
    return -(-(plan.n * plan.mxu8.L8) // 16)


def _ws_rows(plan: Mxu8Plan) -> int:
    """Rows of one chunk's slab of B2's workspace: the stage-1 rows and the
    ones row, then the draws' u32 sums accR and accO of each PRNG word."""
    return plan.n * plan.mxu8.L8 + 1 + (2 * plan.words_per_p if plan.Kr else 0)


def _launch_mxu8_kernel(
    plan: Mxu8Plan, sec: torch.Tensor, seed: int, seed_stride: int, acc_in, splits
) -> torch.Tensor:
    """One call of ``csrc/mxu8.cu`` on the current stream: the chunked
    variant (B2: a memset, the split kernel and the epilogue kernel) when
    the plan has several chunks, the accumulate variant (B3) with
    ``acc_in``, else the single-chunk kernel (B1); a wide plan runs the
    wide variant (:func:`_launch_wide`)."""
    global mxu8_launches, mxu8_chunked_launches, mxu8_acc_launches
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    if sec.dtype != torch.int8 or sec.dim() != 2 or not sec.is_contiguous():
        raise ValueError("sec_planar must be a contiguous 2-D int8 tensor")
    if plan.bigs.device != sec.device:
        raise ValueError("the plan's tensors lie on another device than sec_planar")
    mxu8 = plan.mxu8
    if is_wide(plan):
        return _launch_wide(plan, sec, seed, acc_in)
    variant = _variant(plan, acc_in is not None)
    lib = load_kernel_library(*KERNEL_VARIANTS[variant])
    nbp = sec.shape[1]
    params = _kernel_params(plan, nbp, seed, seed_stride)
    if acc_in is None:
        out = torch.empty((mxu8.ctx.L * plan.n_out, nbp), dtype=torch.int32, device=sec.device)
    else:
        out = acc_in  # B3 reads the running sums from out and adds onto them
    with torch.cuda.device(sec.device):
        stream = torch.cuda.current_stream(sec.device).cuda_stream
        args = [sec.data_ptr(), plan.bigs.data_ptr(), plan.bigr.data_ptr(),
                plan.big2.data_ptr(), plan.tables.data_ptr()]
        if variant == "mxu8_chunked":
            if splits is None:
                splits = launch_splits(plan, nbp, sec.device)
            ws = torch.empty(plan.n_chunks * _ws_rows(plan) * (-(-nbp // 4) * 4),
                             dtype=torch.int32, device=sec.device)
            fn = lib.sda_mxu8_chunked
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*args, ws.data_ptr(), out.data_ptr(), params.ctypes.data, len(params),
                     splits, stream)
        else:
            fn = lib.sda_mxu8_fused
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(*args, out.data_ptr(), params.ctypes.data, len(params), stream)
    if err != 0:
        raise RuntimeError(f"{variant} kernel launch failed: cudaError {err}")
    if variant == "mxu8_chunked":
        mxu8_chunked_launches += 1
    elif variant == "mxu8_acc":
        mxu8_acc_launches += 1
    else:
        mxu8_launches += 1
    return out


def _launch_wide(plan: Mxu8Plan, sec: torch.Tensor, seed: int, acc_in) -> torch.Tensor:
    """B1, or B3 with ``acc_in``, on a wide plan (``csrc/mxu8.cu`` mode 3):
    in PRNG mode the randomness kernel draws the operand into a scratch
    ``[Kr_pad, NBP]`` int8 tensor, then the wide kernel tiles the output
    rows over the grid."""
    global mxu8_wide_launches
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    if plan.n2 or plan.n_chunks > 1:
        raise ValueError(
            f"n * L8 + 1 = {plan.n * plan.mxu8.L8 + 1} > {MAX_MT_ROWS} output rows: the kernel "
            "runs such plans combine-only (reconstruct in a launch of its own) and one chunk a "
            "call (stream the chunks)")
    lib = load_kernel_library(*KERNEL_VARIANTS["mxu8_wide"])
    nbp = sec.shape[1]
    params = _kernel_params(plan, nbp, seed, 0)
    out = acc_in if acc_in is not None else torch.empty(
        (plan.mxu8.ctx.L * plan.n, nbp), dtype=torch.int32, device=sec.device)
    rand8 = (torch.empty((plan.bigr.shape[1], nbp), dtype=torch.int8, device=sec.device)
             if plan.Kr else None)
    with torch.cuda.device(sec.device):
        stream = torch.cuda.current_stream(sec.device).cuda_stream
        fn = lib.sda_mxu8_wide
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(sec.data_ptr(), plan.bigs.data_ptr(), plan.bigr.data_ptr(),
                 rand8.data_ptr() if rand8 is not None else None, plan.tables.data_ptr(),
                 out.data_ptr(), params.ctypes.data, len(params), plan.period,
                 int(acc_in is not None), stream)
    if err != 0:
        raise RuntimeError(f"mxu8_wide kernel launch failed: cudaError {err}")
    mxu8_wide_launches += 1
    return out


def kernel_occupancy(plan: Mxu8Plan, nbp: int, acc: bool = False,
                     epilogue: bool = False) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, resident blocks per SM)
    of the kernel launch a CUDA call of ``run_mxu8`` with this plan makes at
    ``nbp`` lanes (``acc``: with ``acc_in``; a chunked plan: its split
    kernel, or with ``epilogue`` its epilogue kernel), from the CUDA
    runtime's occupancy calculator on the current device. Launches
    nothing."""
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    if is_wide(plan):
        raise ValueError("a wide plan's launch has no occupancy query")
    variant = _variant(plan, acc)
    fn = load_kernel_library(*KERNEL_VARIANTS[variant]).sda_mxu8_occupancy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    params = _kernel_params(plan, nbp, 0, 0)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(params.ctypes.data, len(params), int(epilogue), ctypes.byref(smem),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{variant} occupancy query failed: cudaError {err}")
    return smem.value, blocks.value


_splits_cache: dict[tuple, int] = {}


def launch_splits(plan: Mxu8Plan, nbp: int, device) -> int:
    """The split count a CUDA call of ``run_mxu8`` with this chunked plan
    launches at ``nbp`` lanes on ``device``: :func:`chunked_splits` of its
    lane blocks and K tiles, the card's SM count and the split kernel's
    blocks per SM (:func:`kernel_occupancy`, which depends on the plan
    only through its ``n * L8`` stage-1 rows)."""
    device = torch.device(device)
    key = (nbp, plan.rows, plan.n_chunks, plan.n * plan.mxu8.L8, device.index)
    got = _splits_cache.get(key)
    if got is None:
        with torch.cuda.device(device):
            _, blocks = kernel_occupancy(plan, nbp)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = chunked_splits(-(-nbp // 128), -(-plan.rows // KT), plan.n_chunks, sms, blocks)
        _splits_cache[key] = got
    return got


def run_mxu8(
    plan: Mxu8Plan, sec_planar: torch.Tensor, seed: int = 0, lanes: int | None = None,
    acc_in=None, splits: int | None = None,
) -> torch.Tensor:
    """Run a planned fused call: the CUDA kernels for a CUDA tensor, the
    plain version for a CPU tensor.

    ``sec_planar`` holds ``plan.n_chunks`` chunks of ``plan.rows`` rows. A
    chunked plan needs ``lanes``: chunk ``c`` draws with seed ``seed + c *
    (NBP // lanes)`` (module docstring). ``acc_in`` (single-chunk plans
    only): ``[L * n_out, NBP]`` int32 canonical running sums, updated in
    place and returned. ``splits`` (chunked plans only): B2's split count,
    the card's own choice (:func:`launch_splits`) by default; the plain
    version sums over the same partition when it is given.
    """
    all_rows, nbp = sec_planar.shape
    if all_rows != plan.rows * plan.n_chunks:
        raise ValueError("sec_planar rows do not match the plan")
    if lanes is not None and nbp % lanes:
        raise ValueError(f"NBP={nbp} must be a multiple of lanes={lanes}")
    if plan.n_chunks > 1 and lanes is None:
        raise ValueError("a chunked plan needs lanes (the per-chunk seed stride is NBP // lanes)")
    if splits is not None and (plan.n_chunks == 1 or splits < 1):
        raise ValueError("splits (>= 1) applies to chunked plans only")
    seed_stride = nbp // lanes if plan.n_chunks > 1 else 0
    if acc_in is not None:
        if plan.n_chunks != 1:
            raise ValueError("acc_in accumulation requires n_chunks == 1")
        if (acc_in.dtype != torch.int32 or tuple(acc_in.shape) != (plan.mxu8.ctx.L * plan.n_out, nbp)
                or acc_in.device != sec_planar.device or not acc_in.is_contiguous()):
            raise ValueError(
                "acc_in must be a contiguous int32 [L * n_out, NBP] tensor on sec_planar's device"
            )
    seed = int(seed)
    if sec_planar.device.type == "cuda":
        return _launch_mxu8_kernel(plan, sec_planar, seed, seed_stride, acc_in, splits)
    if sec_planar.device.type == "cpu":
        return _fused_share_combine_mxu8_plain(plan, sec_planar, seed, seed_stride, acc_in,
                                               splits)
    raise ValueError(f"unsupported device {sec_planar.device}")


def fused_share_combine_mxu8(
    mxu8: Mxu8Context,
    share_matrix,  # [m, n] canonical (normal-domain) host matrix
    sec_planar,  # [n_chunks*P*slots*L8, NBP] int8 biased (slots = k or m)
    p_count: int,
    k: int,
    rand_count: int,
    seed=0,
    lanes: int = 1024,
    reconstruct_matrix=None,  # optional [n, k2]: fuse the second modmat
    pg: int | None = None,
    n_chunks: int = 1,
    acc_in=None,  # optional [L*n_out, NBP] int32: running canonical sums
    rand_participants: int | None = None,
) -> torch.Tensor:
    """Byte-limb fused share + combine (+ optional fused reconstruct).

    Returns ``[L * n_out, NBP]`` int32 canonical 16-bit limbs, limb-major:
    row ``l * n_out + i`` is limb ``l`` of output ``i`` (``n_out = n``, or
    ``k2`` with ``reconstruct_matrix``). If ``sec_planar`` carries ``k``
    slots per participant, sharing randomness is drawn in the kernel from
    ``seed`` (see the module docstring); with ``k + rand_count`` slots the
    caller's randomness is used and the PRNG is not. ``rand_participants``
    is the number of randomness draws summed per slot (default
    ``p_count``). ``pg`` is kept for the reference's signature and guard.

    ``n_chunks > 1``: ``sec_planar`` stacks that many ``p_count``-participant
    chunks along its rows and the whole job runs as ONE call (B2); each
    chunk stays inside the carry-chain bound, and with
    ``reconstruct_matrix`` each chunk is reconstructed before the sum (the
    reconstruction is linear). Total participants: ``n_chunks * p_count``.

    ``acc_in``: running canonical sums for host-driven streaming (B3): this
    call's result is added onto ``acc_in`` in place and ``acc_in`` itself
    is returned (the reference aliases the buffer to its output and donates
    it). Callers that reuse the old sums pass a clone. Mutually exclusive
    with ``n_chunks > 1``.
    """
    if acc_in is not None and n_chunks != 1:
        raise ValueError("acc_in accumulation requires n_chunks == 1")
    all_rows = sec_planar.shape[0]
    if all_rows % n_chunks:
        raise ValueError("sec_planar rows must divide evenly into n_chunks")
    plan = mxu8_plan(
        mxu8, share_matrix, all_rows // n_chunks, p_count, k, rand_count,
        reconstruct_matrix=reconstruct_matrix, pg=pg,
        rand_participants=rand_participants, device=sec_planar.device, n_chunks=n_chunks,
    )
    return run_mxu8(plan, sec_planar, seed, lanes=lanes, acc_in=acc_in)
