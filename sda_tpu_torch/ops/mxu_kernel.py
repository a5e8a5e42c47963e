"""7-bit-limb fused share + combine (+ reconstruct): kernel generation 3.

Port of the reference package's ``ops/mxu_kernel.py``. The algebra is the
reference's:

1. **One integer contraction.** Multiplying every participant's ext vector
   by the share matrix and summing over participants is one int8 matrix
   product once field elements are split into 7-bit limbs
   (:mod:`sda_tpu_torch.ops.mxu`).
2. **Reduced big matrix.** The limb shift is pre-multiplied into the matrix
   mod p: the kernel contracts against ``bigM[(j,l1),(i,l2)] =
   limb_l2(M[j,i] * 2^(7*l1) mod p)``, so each clerk needs only ``L7``
   accumulator columns. An epilogue carries them to ``L7 + 4`` 7-bit limbs,
   regroups those into chunks of ``chunk`` limbs (each canonical by
   construction) and folds the chunks with one Montgomery multiply each.
3. **Raw randomness.** Sharing randomness is drawn raw, ``2 * L7`` uniform
   7-bit limbs per element (bias ``<= 2^-(7*L7)``), inside the kernel. When
   the participant count splits into equal groups of at most 129
   (``rand-sum`` mode) the limbs are summed over each group first, in 14-bit
   carry-save fields of u32 words; the sums, re-split into (lo, hi) 7-bit
   limbs, meet one participant-count-independent matrix
   (:func:`_big_rows_randsum`). Otherwise (``grouped`` mode) every
   participant's limbs are contracted against its own matrix columns.
4. **Fused reconstruction** (``reconstruct_matrix``): the canonical
   per-clerk sums are re-split into limb-major 7-bit planes and contracted
   against the reduced reconstruction matrix, so share, combine and
   reconstruct are one launch.

Layout: batch positions are lanes. Secrets arrive ``[P*slots*L7, NBP]`` int8
(participant-major, then slot, then limb); the output is ``[n_out, L16,
NBP]`` int32 holding the canonical u32 limbs, or ``[n_out, L7, NBP]`` int8
7-bit limbs with ``out7``.

**Randomness.** The TPU kernel drew words from the TPU's own generator,
seeded with ``seed + program_id``; its bits cannot be reproduced. Here every
word comes from Philox4x32-10 with key ``(seed mod 2^32, 0)`` and counter
``(lane, participant, group, 6)``: ``lane`` is the global lane index,
``participant`` the participant in ``[0, P)`` and ``group`` the word group;
PRNG word ``w`` of a (lane, participant) is output word ``w % 4`` of group
``w // 4`` (the fourth word, 6, keeps this stream apart from the other
kernels'). Participant ``p``'s raw limb ``i`` (``i < rand_count * 2 *
L7``, slot ``i // (2*L7)``, limb ``i % (2*L7)`` of that slot) is ``(word[i
// 4] >> 7 * (i % 4)) & 127``. Both randomness modes contract exactly these
limbs, and the mapping does not depend on how lanes are tiled. The CUDA
kernel and the plain version below use it alike, so they agree bit for bit
in PRNG mode too. The reference's column permutation and VMEM group budget
of the grouped mode are TPU layout and are not carried over.

**Integer representation.** The plain version carries every u32 lane in
int64; the contraction runs in float64, exact because every sum stays below
2^31 (the ``K_total * 127^2 < 2^31`` guard).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from sda_tpu_torch.ops.mxu import MxuContext, limbs7_host
from sda_tpu_torch.ops.mxu8 import _dot, philox_words

__all__ = [
    "fused_share_combine_mxu",
    "mxu_plan",
    "run_mxu",
    "planar7_from_batched",
    "batched_from_planar16",
    "KERNEL_VARIANTS",
    "kernel_occupancy",
]

_W7 = 7
_MASK7 = (1 << _W7) - 1
_M32 = 0xFFFFFFFF
_PHILOX_TAG = 6  # fourth Philox counter word of this kernel's stream
_CARRY_SAVE_GROUP = 129  # 129 * 127 < 2^14: a 14-bit carry-save field cannot overflow
_RAND_BLOCK_ROWS = 256  # grouped mode: randomness operand rows per block, at most

# Launches of the CUDA kernel (one per call on a CUDA tensor).
mxu_fused_launches = 0

KERNEL_VARIANTS = {"mxu7_fused": ("mxu7.cu", ())}


def planar7_from_batched(mxu: MxuContext, x16, lanes: int) -> torch.Tensor:
    """``[P, NB, s, L16] limbs -> [P*s*L7, NBP] int8`` transposed planar limbs.

    ``NBP`` rounds ``NB`` up to a multiple of ``lanes`` (zero batches are
    inert). Row order is participant-major, then slot, then limb — matching
    :func:`_big_rows`.
    """
    p, nb, s, _ = x16.shape
    x7 = mxu.limbs7_from_16(x16)  # [P, NB, s, L7]
    nbp = -(-nb // lanes) * lanes
    if nbp != nb:
        x7 = torch.nn.functional.pad(x7, (0, 0, 0, 0, 0, nbp - nb))
    return x7.permute(0, 2, 3, 1).reshape(p * s * mxu.L7, nbp).contiguous()


def batched_from_planar16(y, nb: int) -> torch.Tensor:
    """``[n, L16, NBP] -> [NB, n, L16]`` (slicing the lane padding off)."""
    return y.permute(2, 0, 1)[:nb]


# ------------------------------------------------------- matrix builders


def _reduced_row(mxu: MxuContext, m_col, shift: int) -> np.ndarray:
    """One big-matrix row: ``limb_l2(m_col[i] * 2^shift mod p)`` flattened to
    ``[n * L7]`` int8, for every output column ``(i, l2)``."""
    p = mxu.ctx.p
    vals = [(int(v) * pow(2, shift, p)) % p for v in m_col]
    return limbs7_host(np.array(vals, dtype=object), mxu.L7).reshape(-1)


def _big_rows(mxu: MxuContext, m_normal, slot_rows, in_limbs, n_pad: int,
              limb_major: bool = False) -> np.ndarray:
    """Reduced ``bigM^T [n_pad, rows]`` int8 for the given slot subset.

    ``slot_rows``: indices into ``m_normal`` rows, repeated participant-major
    by the caller. ``in_limbs``: limb count per listed slot. Output rows are
    ``(i, l2)``-major with stride ``L7`` per clerk, padded to ``n_pad``; the
    entry for input row ``(j, l1)`` is ``limb_l2(M[j,i] * 2^(7*l1) mod p)``.
    ``limb_major`` orders the input rows ``(l1, j)`` instead (uniform
    ``in_limbs`` only): the layout of the fused reconstruction's planes.
    """
    m_normal = np.asarray(m_normal, dtype=object)
    n = m_normal.shape[1]
    L7 = mxu.L7
    if n * L7 > n_pad:
        raise ValueError("n_pad too small")
    big = np.zeros((n_pad, sum(in_limbs)), dtype=np.int8)
    cache: dict[tuple[int, int], np.ndarray] = {}

    def reduced(j, l1):
        got = cache.get((j, l1))
        if got is None:
            got = _reduced_row(mxu, m_normal[j], _W7 * l1)
            cache[(j, l1)] = got
        return got

    if limb_major:
        if len(set(in_limbs)) != 1:
            raise ValueError("limb_major needs a uniform limb count")
        order = [(j, l1) for l1 in range(in_limbs[0]) for j in slot_rows]
    else:
        order = [(j, l1) for j, limbs in zip(slot_rows, in_limbs) for l1 in range(limbs)]
    for row, (j, l1) in enumerate(order):
        big[: n * L7, row] = reduced(j, l1)
    return big


def _big_rows_randsum(mxu: MxuContext, m_normal, k: int, rand_count: int,
                      n_pad: int, words_per_p: int) -> np.ndarray:
    """Reduced ``bigRsum^T [n_pad, 8 * words_per_p]`` for summed randomness.

    Row ``(b*2 + carry) * words_per_p + w`` of the summed-randomness operand
    carries raw limb position ``idx = 4*w + b`` (four 7-bit limbs per u32
    word) with weight ``2^(7*(idx % 2L7 + carry))``; its entries are
    ``limb_l2(M[slot, i] * 2^(7*(l1 + carry)) mod p)``. Positions past
    ``rand_count * 2L7`` (word padding) stay zero.
    """
    m_normal = np.asarray(m_normal, dtype=object)
    n = m_normal.shape[1]
    L7 = mxu.L7
    r2l = 2 * L7  # raw double-width limbs per rand slot
    big = np.zeros((n_pad, 8 * words_per_p), dtype=np.int8)
    cache: dict[tuple[int, int], np.ndarray] = {}
    for idx in range(rand_count * r2l):
        slot, l1 = k + idx // r2l, idx % r2l
        w, b = idx // 4, idx % 4
        for carry in (0, 1):
            col = (b * 2 + carry) * words_per_p + w
            got = cache.get((slot, l1 + carry))
            if got is None:
                got = _reduced_row(mxu, m_normal[slot], _W7 * (l1 + carry))
                cache[(slot, l1 + carry)] = got
            big[: n * L7, col] = got
    return big


def _chunk_consts_u32(mxu: MxuContext, n_chunks: int) -> np.ndarray:
    """``[n_chunks, L16]`` uint32: Montgomery-form ``2^(7*chunk*t)``."""
    return mxu._chunk_consts(n_chunks).astype(np.uint32)


# ------------------------------------------------------------------- plan


@dataclass(frozen=True)
class MxuPlan:
    """Everything one fused call needs besides its operand and seed: the
    reduced matrices and constants on the operand's device, and the shapes
    the kernel and its plain version read.

    Randomness runs in ``n_blocks`` blocks of ``kb`` operand rows. Rand-sum
    mode: block ``g`` is carry-save group ``g`` (``gsize`` participants) and
    every block meets the same ``bigr`` columns ``[0, kb)``. Grouped mode:
    block ``b`` holds participants ``[b*pb, (b+1)*pb)``, ``RL`` rows each,
    and meets ``bigr`` columns ``[b*kb, (b+1)*kb)``."""

    mxu: MxuContext
    n: int  # clerks (stage-1 outputs)
    n_out: int  # n, or k2 with fused reconstruction
    rows: int  # operand rows
    p_count: int
    rand_mode: str  # "none", "sum" or "grouped"
    words_per_p: int  # PRNG words per participant
    RL: int  # raw randomness limbs per participant
    gsize: int  # rand-sum: participants per carry-save group
    pb: int  # grouped: participants per block
    n_blocks: int
    kb: int  # operand rows per randomness block (multiple of 32)
    out7: bool
    n2: int
    n_pad: int
    bigs: torch.Tensor  # [n_pad, lda] int8, zero columns past rows
    bigr: torch.Tensor  # [n_pad, kb] (sum) or [n_pad, n_blocks * kb] (grouped)
    big2: torch.Tensor  # [n_pad2, n * L7] int8
    n_consts: int  # rows of the Montgomery chunk-constant table
    tables: torch.Tensor  # chunk constants [n_consts, L16] | p limbs, as uint32 bits in int32


def mxu_plan(
    mxu: MxuContext,
    share_matrix,
    rows: int,
    p_count: int,
    k: int,
    rand_count: int,
    out7: bool = False,
    reconstruct_matrix=None,
    device="cpu",
) -> MxuPlan:
    """Build the matrices and constants of one fused configuration on
    ``device``. The guards are the reference's."""
    m = k + rand_count
    share_matrix = np.asarray(share_matrix, dtype=object)
    n = share_matrix.shape[1]
    L7 = mxu.L7
    if rows == p_count * k * L7:
        has_prng = True
    elif rows == p_count * m * L7:
        has_prng = False
    else:
        raise ValueError("sec_planar rows match neither k nor k+r slots")

    # rand-sum mode: equal carry-save groups of at most 129 participants
    rand_sum = None
    if has_prng and rand_count:
        groups = -(-p_count // _CARRY_SAVE_GROUP)
        if p_count % groups == 0:
            rand_sum = groups

    RL = rand_count * 2 * L7 if has_prng else 0
    words_per_p = -(-RL // 4)
    n_pad = -(-(n * L7) // 32) * 32
    # contraction / accumulator bound (int32): K * 127^2 < 2^31
    if rand_sum:
        # summed randomness contracts over 8 * words_per_p rows per group,
        # each lo/hi carry limb <= 127 like any other operand
        K_total = p_count * k * L7 + rand_sum * 8 * words_per_p
    else:
        K_total = p_count * (k * L7 + rand_count * (2 * L7 if has_prng else L7))
    if K_total * _MASK7 * _MASK7 >= (1 << 31):
        raise ValueError(
            "participants * scheme_size exceeds the int32 accumulator bound; "
            "chunk the participant axis (engine streaming path)"
        )

    sec_slots = list(range(k)) if has_prng else list(range(m))
    lda = -(-rows // 32) * 32
    bigs = np.zeros((n_pad, lda), dtype=np.int8)
    bigs[:, :rows] = _big_rows(
        mxu, share_matrix, [j for _ in range(p_count) for j in sec_slots],
        [L7] * (p_count * len(sec_slots)), n_pad,
    )
    rand_mode, gsize, pb, n_blocks, kb = "none", 0, 0, 0, 0
    bigr = np.zeros((n_pad, 32), dtype=np.int8)
    if rand_sum:
        rand_mode, gsize, n_blocks = "sum", p_count // rand_sum, rand_sum
        kb = -(-(8 * words_per_p) // 32) * 32
        bigr = np.zeros((n_pad, kb), dtype=np.int8)
        bigr[:, : 8 * words_per_p] = _big_rows_randsum(
            mxu, share_matrix, k, rand_count, n_pad, words_per_p
        )
    elif RL:
        rand_mode = "grouped"
        pb = max(1, _RAND_BLOCK_ROWS // RL)
        n_blocks = -(-p_count // pb)
        kb = -(-(pb * RL) // 32) * 32
        one = _big_rows(  # columns (participant, slot, limb), as the reference's
            mxu, share_matrix, [k + j for _ in range(p_count) for j in range(rand_count)],
            [2 * L7] * (p_count * rand_count), n_pad,
        )
        bigr = np.zeros((n_pad, n_blocks * kb), dtype=np.int8)
        for b in range(n_blocks):
            cols = one[:, b * pb * RL : min(p_count, (b + 1) * pb) * RL]
            bigr[:, b * kb : b * kb + cols.shape[1]] = cols

    n2 = 0
    big2 = np.zeros((32, 32), dtype=np.int8)
    if reconstruct_matrix is not None:
        if out7:
            raise ValueError("out7 and reconstruct_matrix are exclusive")
        rec = np.asarray(reconstruct_matrix, dtype=object)
        if rec.shape[0] != n:
            raise ValueError("reconstruct_matrix rows must equal share count")
        n2 = rec.shape[1]
        n_pad2 = -(-(n2 * L7) // 32) * 32
        big2 = _big_rows(mxu, rec, list(range(n)), [L7] * n, n_pad2, limb_major=True)
    # both stages fold (L7 + 4)-limb accumulators -> one shared const table
    consts = _chunk_consts_u32(mxu, -(-(L7 + 4) // mxu.chunk))
    table = np.concatenate([
        consts.reshape(-1).astype(np.int64), np.asarray(mxu.ctx.p_limbs, dtype=np.int64),
    ]).astype(np.uint32).view(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return MxuPlan(
        mxu=mxu, n=n, n_out=n2 if n2 else n, rows=rows, p_count=p_count,
        rand_mode=rand_mode, words_per_p=words_per_p, RL=RL, gsize=gsize, pb=pb,
        n_blocks=n_blocks, kb=kb, out7=out7, n2=n2, n_pad=n_pad,
        bigs=dev(bigs), bigr=dev(bigr), big2=dev(big2), n_consts=consts.shape[0],
        tables=dev(table),
    )


# ------------------------------------------------------- the plain version


def _participant_words(plan: MxuPlan, seed: int, lanes: torch.Tensor, p0: int, p1: int):
    """PRNG words ``[p1 - p0, words_per_p, T]`` (int64, u32 values) of
    participants ``[p0, p1)`` at the global lanes ``lanes``."""
    parts = torch.arange(p0, p1, dtype=torch.int64, device=lanes.device)
    return philox_words(seed, lanes, parts, plan.words_per_p, _PHILOX_TAG)


def _raw_limbs(words: torch.Tensor) -> torch.Tensor:
    """``[np, W, T]`` words -> ``[np, 4 * W, T]`` raw 7-bit limbs, limb ``i``
    from word ``i // 4`` at bit ``7 * (i % 4)``."""
    limbs = torch.stack([(words >> (_W7 * b)) & _MASK7 for b in range(4)], dim=2)
    return limbs.reshape(words.shape[0], 4 * words.shape[1], -1)


def _rand_block(plan: MxuPlan, seed: int, lanes: torch.Tensor, blk: int) -> torch.Tensor:
    """Randomness operand block ``blk``: ``[kb, T]`` int64 7-bit values."""
    T = lanes.shape[0]
    out = torch.zeros((plan.kb, T), dtype=torch.int64, device=lanes.device)
    wpp = plan.words_per_p
    if plan.rand_mode == "sum":
        p0 = blk * plan.gsize
        words = _participant_words(plan, seed, lanes, p0, p0 + plan.gsize)
        # the kernel's carry-save packing: limbs 0/2 of every word in accE's
        # 14-bit fields, limbs 1/3 in accO's; no field exceeds 129 * 127
        mask2 = _MASK7 | (_MASK7 << 14)
        accE = (words & mask2).sum(dim=0)
        accO = ((words >> _W7) & mask2).sum(dim=0)
        sums = [accE & 0x3FFF, accO & 0x3FFF, accE >> 14, accO >> 14]
        for b, s in enumerate(sums):
            out[(2 * b) * wpp : (2 * b + 1) * wpp] = s & _MASK7
            out[(2 * b + 1) * wpp : (2 * b + 2) * wpp] = s >> _W7
        return out
    p0 = blk * plan.pb
    p1 = min(plan.p_count, p0 + plan.pb)
    limbs = _raw_limbs(_participant_words(plan, seed, lanes, p0, p1))[:, : plan.RL]
    out[: (p1 - p0) * plan.RL] = limbs.reshape((p1 - p0) * plan.RL, T)
    return out


def _plain_block(plan: MxuPlan, sec: torch.Tensor, seed: int, lane0: int) -> torch.Tensor:
    mxu = plan.mxu
    n, L7, T = plan.n, mxu.L7, sec.shape[1]
    acc = _dot(plan.bigs[: n * L7, : plan.rows], sec)  # [n * L7, T]
    if plan.rand_mode != "none":
        lanes = torch.arange(lane0, lane0 + T, dtype=torch.int64, device=sec.device)
        for blk in range(plan.n_blocks):
            c0 = 0 if plan.rand_mode == "sum" else blk * plan.kb
            acc = acc + _dot(plan.bigr[: n * L7, c0 : c0 + plan.kb],
                             _rand_block(plan, seed, lanes, blk))
    # the epilogue: carry, chunk regroup, Montgomery fold -> [n, T, L16]
    res = mxu.reduce_columns(acc.reshape(n, L7, T).transpose(1, 2))
    if plan.n2:
        # fused reconstruction: limb-major (l1, clerk) 7-bit planes feed stage 2
        c7 = mxu.limbs7_from_16(res).permute(2, 0, 1).reshape(L7 * n, T)
        acc2 = _dot(plan.big2[: plan.n2 * L7], c7)
        res = mxu.reduce_columns(acc2.reshape(plan.n2, L7, T).transpose(1, 2))
    if plan.out7:
        return mxu.limbs7_from_16(res).permute(0, 2, 1)
    return res.permute(0, 2, 1).to(torch.int32)


def _fused_share_combine_mxu_plain(plan: MxuPlan, sec: torch.Tensor, seed: int) -> torch.Tensor:
    """The fused function in plain tensor code (any device): the CUDA
    kernel's arithmetic, block for block, with the same Philox mapping.
    Lanes are independent, so they run in blocks that bound the float64
    operand and the Philox intermediates to about 2^27 elements each."""
    nbp = sec.shape[1]
    per_lane = max(plan.rows, 16 * max(plan.gsize, plan.pb) * plan.words_per_p, plan.kb, 1)
    block = max(1, min(nbp, (1 << 27) // per_lane))
    out_limbs = plan.mxu.L7 if plan.out7 else plan.mxu.ctx.L
    out = torch.empty((plan.n_out, out_limbs, nbp),
                      dtype=torch.int8 if plan.out7 else torch.int32, device=sec.device)
    for l0 in range(0, nbp, block):
        l1 = min(nbp, l0 + block)
        out[:, :, l0:l1] = _plain_block(plan, sec[:, l0:l1], seed & _M32, l0)
    return out


# ------------------------------------------------------------------ kernel


def _kernel_params(plan: MxuPlan, nbp: int, seed: int) -> np.ndarray:
    """The kernel's ``Params`` as ``csrc/mxu7.cu`` reads them: int32, in
    field order, the seed as its 32-bit pattern."""
    mxu = plan.mxu
    L = mxu.ctx.L
    mode = {"none": 0, "sum": 1, "grouped": 2}[plan.rand_mode]
    return np.array([
        plan.rows, plan.bigs.shape[1], nbp, plan.n_pad, plan.n, mxu.L7, L, mxu.chunk,
        plan.n_consts, mxu.ctx.p_inv_w, plan.n2, int(plan.out7), mode, plan.p_count,
        plan.words_per_p, plan.RL, plan.gsize, plan.pb, plan.n_blocks, plan.kb,
        plan.bigr.shape[1], np.uint32(seed & _M32).view(np.int32),
        0, plan.n_consts * L,
    ], dtype=np.int32)


def kernel_mt(plan: MxuPlan) -> int:
    """The ``MT`` template instance of ``csrc/mxu7.cu`` that a launch with
    this plan runs: the m16 tiles of the ``n * L7`` accumulator rows."""
    return -(-(plan.n * plan.mxu.L7) // 16)


def _launch_mxu_kernel(plan: MxuPlan, sec: torch.Tensor, seed: int) -> torch.Tensor:
    """One launch of ``csrc/mxu7.cu`` on the current stream."""
    global mxu_fused_launches
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    if sec.dtype != torch.int8 or sec.dim() != 2 or not sec.is_contiguous():
        raise ValueError("sec_planar must be a contiguous 2-D int8 tensor")
    if plan.bigs.device != sec.device:
        raise ValueError("the plan's tensors lie on another device than sec_planar")
    mxu = plan.mxu
    if kernel_mt(plan) > 12 or mxu.L7 + 4 > 32 or mxu.ctx.L not in (2, 4, 8):
        raise ValueError("n * L7 > 192 accumulator rows, L7 > 28 or L not 2, 4 or 8: "
                         "not supported by the kernel")
    lib = load_kernel_library(*KERNEL_VARIANTS["mxu7_fused"])
    fn = lib.sda_mxu7_fused
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbp = sec.shape[1]
    params = _kernel_params(plan, nbp, seed)
    out_limbs = mxu.L7 if plan.out7 else mxu.ctx.L
    out = torch.empty((plan.n_out, out_limbs, nbp),
                      dtype=torch.int8 if plan.out7 else torch.int32, device=sec.device)
    with torch.cuda.device(sec.device):
        stream = torch.cuda.current_stream(sec.device).cuda_stream
        err = fn(
            sec.data_ptr(), plan.bigs.data_ptr(), plan.bigr.data_ptr(), plan.big2.data_ptr(),
            plan.tables.data_ptr(), out.data_ptr(), len(params), params.ctypes.data, stream,
        )
    if err != 0:
        raise RuntimeError(f"mxu7_fused kernel launch failed: cudaError {err}")
    mxu_fused_launches += 1
    return out


def kernel_occupancy(plan: MxuPlan, nbp: int) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, resident blocks per SM)
    of the kernel launch a CUDA call of ``run_mxu`` with this plan makes at
    ``nbp`` lanes, from the CUDA runtime's occupancy calculator on the
    current device. Launches nothing."""
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    fn = load_kernel_library(*KERNEL_VARIANTS["mxu7_fused"]).sda_mxu7_occupancy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    params = _kernel_params(plan, nbp, 0)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(params.ctypes.data, len(params), ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"mxu7_fused occupancy query failed: cudaError {err}")
    return smem.value, blocks.value


def run_mxu(plan: MxuPlan, sec_planar: torch.Tensor, seed: int = 0,
            lanes: int | None = None) -> torch.Tensor:
    """Run a planned fused call: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    rows, nbp = sec_planar.shape
    if rows != plan.rows:
        raise ValueError("sec_planar rows do not match the plan")
    if lanes is not None and nbp % lanes:
        raise ValueError(f"NBP={nbp} must be a multiple of lanes={lanes}")
    seed = int(seed)
    if sec_planar.device.type == "cuda":
        return _launch_mxu_kernel(plan, sec_planar, seed)
    if sec_planar.device.type == "cpu":
        return _fused_share_combine_mxu_plain(plan, sec_planar, seed)
    raise ValueError(f"unsupported device {sec_planar.device}")


def fused_share_combine_mxu(
    mxu: MxuContext,
    share_matrix,  # [m, n] canonical (normal-domain) host matrix
    sec_planar,  # [P*slots*L7, NBP] int8 (slots = k or k + rand_count)
    p_count: int,
    k: int,
    rand_count: int,
    seed=0,
    lanes: int = 512,
    out7: bool = False,
    reconstruct_matrix=None,  # optional [n, k2]: fuse a second modmat
) -> torch.Tensor:
    """Fused 7-bit share + combine. Returns ``[n, L16, NBP]`` int32 canonical
    limbs, or ``[n, L7, NBP]`` int8 canonical 7-bit limbs with ``out7``
    (ready to feed back in as the input of a follow-up call: reconstruction
    is the same modular matmul with ``p_count=1``, ``k=n``,
    ``rand_count=0``). With ``reconstruct_matrix`` the second modmat runs in
    the same launch and the result is ``[k2, L16, NBP]``.

    If ``sec_planar`` carries ``k`` slots per participant, randomness is
    drawn raw in the kernel from ``seed`` (module docstring); if it carries
    ``k + rand_count`` slots (the caller's canonical randomness, the
    protocol path), the PRNG is unused.
    """
    nbp = sec_planar.shape[1]
    if nbp % lanes:
        raise ValueError(f"NBP={nbp} must be a multiple of lanes={lanes}")
    plan = mxu_plan(
        mxu, share_matrix, sec_planar.shape[0], p_count, k, rand_count, out7=out7,
        reconstruct_matrix=reconstruct_matrix, device=sec_planar.device,
    )
    return run_mxu(plan, sec_planar, seed, lanes=lanes)
