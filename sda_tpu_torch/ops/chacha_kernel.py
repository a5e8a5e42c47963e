"""Device ChaCha mask expansion (bit-exact rand-0.3 streams).

Port of the reference package's ``ops/chacha_kernel.py``. The recipient of
a ChaCha-masked aggregation re-expands every participant's uploaded seed
into a full d-dimensional mask and folds the masks mod p. At federated
scale (10k+ participants x 1M dimensions) that is ~10^10 draws, a device
workload. Two hand-written CUDA kernels (``csrc/chacha.cu``) carry it, each
with its plain PyTorch version beside its launcher:

1. **B4** (``chacha_keystream``): the ChaCha20 keystream of every (seed,
   block counter), rand 0.3's core (20 rounds, counter in word 12, key =
   seed words zero-padded). The chunk route pairs its words into 64-bit
   draws (hi = the FIRST word), reduces each draw ``v mod p`` in limb
   Montgomery (``_genrange_reduce``, torch tensor code, as the reference
   leaves it to XLA) and folds the masks with ``sum_mod``.
2. **B5** (``fold_masks_device``): keystream, draw pairing and the fold
   over seeds in ONE launch with no intermediate in device memory, for
   pseudo-Mersenne moduli. The fold is mod p and ``v mod p ≡ v``, so the
   raw draws' u16 limbs are summed and reduced once at the end.

**Rejections.** rand 0.3 *skips* draws in the zone ``v >= 2^64 - (2^64 mod
m)`` (probability ~m/2^64). Both routes count the zone hits per seed;
:func:`combine_masks_device` re-expands the (expected ~zero) affected
seeds with the exact host path of :mod:`sda_tpu_torch.chacha`.

**Integer representation.** Keystream words leave the kernels as int32
tensors holding the u32 bit patterns; the plain versions carry u32 values
in int64 and mask with ``& 0xFFFFFFFF`` after every add and rotate.

Each entry point runs on ``cuda`` unless given another ``device``: on a CPU
device it runs the plain version, on a CUDA device it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sda_tpu_torch import chacha
from sda_tpu_torch.fields import trunc_add_mod
from sda_tpu_torch.ops.limbs import LimbContext
from sda_tpu_torch.utils.device import resolve_device
from sda_tpu_torch.utils.logging import span

__all__ = [
    "chacha_keystream",
    "expand_masks_device",
    "fold_masks_device",
    "combine_masks_device",
    "KERNEL_VARIANTS",
]

_M32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# one fused-fold call: the per-(dimension, limb) sums S * 0xFFFF stay below
# 2^30, inside the kernel's u32 accumulators (and the carry below 2^15)
_FOLD_SEED_CAP = 16384
# the chunk route keeps its [chunk, d, L] mask block around this size
_CHUNK_BUDGET_BYTES = 2 * 10**9

# Launches of each kernel (one per call on a CUDA device).
chacha_keystream_launches = 0
chacha_fold_launches = 0
# Groups of the fused route whose limbs were recombined to int64 on the
# device, before the one copy to the host.
fold_recombine_device_launches = 0

# The kernels' build of csrc/chacha.cu: name -> (source, defines).
KERNEL_VARIANTS = {"chacha": ("chacha.cu", ())}


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values in int64."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> int32 bit patterns."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def _key_words(seed_words) -> np.ndarray:
    """Seeds (an ``[S, w]`` array, or S rows of w words) -> ``[S, 8]``
    uint32 keys: each seed's first 8 words as u32, zero-padded (rand 0.3's
    key)."""
    words = np.asarray(seed_words, dtype=np.int64)[..., :8] & _M32
    keys = np.zeros((len(words), 8), dtype=np.uint32)
    keys[:, : words.shape[-1]] = words
    return keys


def _key_tensor(seed_words, device: torch.device) -> torch.Tensor:
    """``[S, 8]`` int32 key tensor (u32 bit patterns) on ``device``."""
    return torch.from_numpy(_key_words(seed_words).view(np.int32)).to(device)


def _zone(modulus: int) -> tuple[int, int]:
    """(hi, lo) u32 words of the first rejected draw ``2^64 - (2^64 mod m)``."""
    zone = ((1 << 64) - ((1 << 64) % modulus)) & ((1 << 64) - 1)
    return zone >> 32, zone & _M32


def _library():
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    lib = load_kernel_library(*KERNEL_VARIANTS["chacha"])
    lib.sda_chacha_keystream.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_void_p]
    lib.sda_chacha_keystream.restype = ctypes.c_int
    lib.sda_chacha_fold.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
    ]
    lib.sda_chacha_fold.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------ B4 keystream


def _rotl(x, k: int):
    return ((x << k) & _M32) | (x >> (32 - k))


def _quarter(x, a, b, c, d):
    x[a] = (x[a] + x[b]) & _M32
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & _M32
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & _M32
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & _M32
    x[b] = _rotl(x[b] ^ x[c], 7)


def _chacha_blocks_plain(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """The plain version of the ChaCha20 core: ``keys`` ``[S, 8]`` and
    ``counters`` ``[B]`` (int64, u32 values) -> ``[S, B, 16]`` int64 u32
    keystream words of every (seed, counter)."""
    shape = (keys.shape[0], counters.shape[0])
    zero = torch.zeros(shape, dtype=torch.int64, device=keys.device)
    x = [zero + c for c in _CONSTANTS]
    x += [zero + keys[:, w : w + 1] for w in range(8)]
    x += [zero + counters[None, :], zero, zero, zero]
    init = list(x)
    for _ in range(10):  # 20 rounds
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return torch.stack([(x[w] + init[w]) & _M32 for w in range(16)], dim=-1)


def _keystream_plain(keys: torch.Tensor, nblocks: int) -> torch.Tensor:
    """B4's plain version: ``[S, 8]`` int32 keys -> ``[S, nblocks, 16]``
    int32 words (any device)."""
    counters = torch.arange(nblocks, dtype=torch.int64, device=keys.device)
    return _i32(_chacha_blocks_plain(_u32(keys), counters))


def _launch_keystream(keys: torch.Tensor, nblocks: int) -> torch.Tensor:
    """One launch of B4 on the current stream."""
    global chacha_keystream_launches
    s = keys.shape[0]
    out = torch.empty((s, nblocks, 16), dtype=torch.int32, device=keys.device)
    if s == 0 or nblocks == 0:
        return out
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.sda_chacha_keystream(keys.data_ptr(), out.data_ptr(), s, nblocks, stream)
    if err != 0:
        raise RuntimeError(f"chacha_keystream kernel launch failed: cudaError {err}")
    chacha_keystream_launches += 1
    return out


def chacha_keystream(seed_words, nblocks: int, device=None) -> torch.Tensor:
    """Keystream for many seeds: ``[S, 8]`` u32 keys -> ``[S, nblocks, 16]``
    int32 tensor of u32 bit patterns on ``device`` (B4 on a CUDA device,
    its plain version on the CPU)."""
    if not 0 <= nblocks < (1 << 32):
        raise ValueError("chacha_keystream keeps the block counter in one word (nblocks < 2^32)")
    dev = resolve_device(device)
    with span("sda.chacha.keys"):
        keys = _key_tensor(seed_words, dev)
    if dev.type == "cuda":
        return _launch_keystream(keys, nblocks)
    if dev.type == "cpu":
        return _keystream_plain(keys, nblocks)
    raise ValueError(f"unsupported device {dev}")


# ------------------------------------------------------- chunk-route masks


def _genrange_reduce(ctx: LimbContext, hi, lo):
    """Exact ``(hi * 2^32 + lo) mod p`` on int64 u32 tensors via limb
    Montgomery; returns an L-lane list of canonical limbs."""
    L = ctx.L
    r2 = list(ctx.r2)
    one = [1] + [0] * (L - 1)
    v4 = [lo & _MASK16, lo >> 16, hi & _MASK16, hi >> 16]
    if L == 2:
        # v = x1 * R + x0 with R = 2^32: two halves of two limbs each
        x0, x1 = v4[:2], v4[2:]
        a = ctx.mont_mul_lanes(x1, r2)  # x1 * R mod p
        y = ctx.mont_mul_lanes(x0, r2)
        b = ctx.mont_mul_lanes(y, one)  # x0 mod p
        return ctx.add_mod_lanes(a, b)
    if L == 4:
        # v < R = 2^64: reduce directly with two Montgomery multiplies
        y = ctx.mont_mul_lanes(v4, r2)
        return ctx.mont_mul_lanes(y, one)
    # L == 8: p >= 2^64 > v, already canonical
    return v4 + [torch.zeros_like(hi)] * (L - 4)


def _masks_from_stream(ctx: LimbContext, stream: torch.Tensor, dimension: int):
    """Keystream ``[S, nblocks, 16]`` -> (masks ``[S, d, L]`` int64
    canonical limbs, per-seed rejection counts ``[S]``)."""
    words = stream.reshape(stream.shape[0], -1)
    hi = _u32(words[:, 0::2][:, :dimension])
    lo = _u32(words[:, 1::2][:, :dimension])
    zone_hi, zone_lo = _zone(ctx.p)
    rejected = (hi > zone_hi) | ((hi == zone_hi) & (lo >= zone_lo))
    counts = rejected.sum(dim=1)
    return torch.stack(_genrange_reduce(ctx, hi, lo), dim=-1), counts


def expand_masks_device(seed_words, dimension: int, modulus: int, device=None):
    """Device mask expansion: ``[S]`` seeds -> (masks ``[S, d, L]`` int64
    canonical limbs, per-seed rejection counts ``[S]``), both on ``device``.

    Bit-exact with :func:`sda_tpu_torch.chacha.expand_masks` for every seed
    whose rejection count is zero (callers re-do the rare others on host).
    """
    if modulus % 2 == 0:
        raise ValueError("device expansion requires an odd modulus")
    dev = resolve_device(device)
    ctx = LimbContext.create(modulus)
    nblocks = -(-2 * dimension // 16)
    return _masks_from_stream(ctx, chacha_keystream(seed_words, nblocks, device=dev), dimension)


# ------------------------------------------------------------- B5 the fold


def _fold_e_bits(ctx: LimbContext, lanes, e: int, cp: int):
    """Canonicalise a 4-u16-limb value < 2^64 mod p = 2^e - cp (e <= 63):
    two rounds of ``lo + cp * hi`` then a conditional subtract."""
    zero = torch.zeros_like(lanes[0])
    wE, sh = e // 16, e % 16
    for _ in range(2):
        hi = lanes[wE] >> sh
        bits = 16 - sh
        for w in range(wE + 1, 4):
            hi = hi | (lanes[w] << bits)
            bits += 16
        lanes = lanes[:wE] + [lanes[wE] & ((1 << sh) - 1)]
        lanes += [zero] * (4 - len(lanes))
        add = hi * cp
        incoming = (add & _MASK16, add >> 16)
        carry = zero
        for w in range(4):
            t = lanes[w] + (incoming[w] if w < 2 else zero) + carry
            lanes[w] = t & _MASK16
            carry = t >> 16
    return ctx._cond_sub(lanes, zero)


def _fold_finalize(limb_sums: torch.Tensor, modulus: int) -> torch.Tensor:
    """Limb sums ``[d, 4]`` (int64, each < 2^30) -> ``[d, 4]`` canonical
    limbs of ``sum_j limb_sums[:, j] * 2^(16 j) mod p`` for the
    pseudo-Mersenne ``p = 2^e - cp``: carry propagation into a 64-bit value
    plus ``carry * 2^64``, the carry term as two u16-half products of ``K =
    2^64 mod p`` (the reference's u32 algebra, which a direct product
    wrapped for e below ~60), both terms folded and added mod p."""
    e = modulus.bit_length()
    cp = (1 << e) - modulus
    l16 = []
    carry = torch.zeros_like(limb_sums[:, 0])
    for j in range(4):
        t = limb_sums[:, j] + carry
        l16.append(t & _MASK16)
        carry = t >> 16
    K = cp << (64 - e)
    p_lo = carry * (K & _MASK16)
    p_hi = carry * (K >> 16)
    e0 = p_lo & _MASK16
    r1 = (p_lo >> 16) + (p_hi & _MASK16)
    e1 = r1 & _MASK16
    r2 = (r1 >> 16) + (p_hi >> 16)
    ev = [e0, e1, r2 & _MASK16, r2 >> 16]
    ctx = LimbContext.create(modulus)
    summed = ctx.add_mod_lanes(_fold_e_bits(ctx, l16, e, cp), _fold_e_bits(ctx, ev, e, cp))
    return torch.stack(summed, dim=-1)


def _fold_plain(keys: torch.Tensor, dimension: int, modulus: int):
    """B5's plain version (any device): ``[S, 8]`` int32 keys -> (``[d, 4]``
    int32 canonical limbs, ``[S]`` int32 rejection counts). Seeds run in
    groups that keep each state word's tensor near 2^20 elements."""
    keys = _u32(keys)
    s = keys.shape[0]
    nb = -(-dimension // 8)
    counters = torch.arange(nb, dtype=torch.int64, device=keys.device)
    sums = torch.zeros((dimension, 4), dtype=torch.int64, device=keys.device)
    rej = torch.zeros(s, dtype=torch.int64, device=keys.device)
    zone_hi, zone_lo = _zone(modulus)
    step = max(1, (1 << 20) // max(1, nb))
    for s0 in range(0, s, step):
        blocks = _chacha_blocks_plain(keys[s0 : s0 + step], counters)
        draws = blocks.reshape(blocks.shape[0], nb * 8, 2)[:, :dimension]
        hi, lo = draws[..., 0], draws[..., 1]
        sums += torch.stack([lo & _MASK16, lo >> 16, hi & _MASK16, hi >> 16], dim=-1).sum(dim=0)
        rejected = (hi > zone_hi) | ((hi == zone_hi) & (lo >= zone_lo))
        rej[s0 : s0 + step] = rejected.sum(dim=1)
    return _fold_finalize(sums, modulus).to(torch.int32), rej.to(torch.int32)


def _launch_fold(keys: torch.Tensor, dimension: int, modulus: int):
    """One launch of B5 on the current stream."""
    global chacha_fold_launches
    s = keys.shape[0]
    e = modulus.bit_length()
    K = ((1 << e) - modulus) << (64 - e)
    zone_hi, zone_lo = _zone(modulus)
    limbs = torch.empty((dimension, 4), dtype=torch.int32, device=keys.device)
    rej = torch.zeros(s, dtype=torch.int32, device=keys.device)
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.sda_chacha_fold(keys.data_ptr(), limbs.data_ptr(), rej.data_ptr(), s,
                                  dimension, modulus, K, zone_hi, zone_lo, stream)
    if err != 0:
        raise RuntimeError(f"chacha_fold kernel launch failed: cudaError {err}")
    chacha_fold_launches += 1
    return limbs, rej


def fold_masks_device(seed_words, dimension: int, modulus: int, device=None):
    """Fused federated-scale ChaCha mask fold for pseudo-Mersenne moduli.

    ``[S]`` seeds -> (combined canonical limbs ``[d, 4]`` int32 on
    ``device``, per-seed rejection counts ``[S]`` numpy). On a CUDA device
    the keystream, draw pairing and the fold over seeds are ONE launch of
    B5. Requires ``p = 2^e - c`` with ``e <= 63`` and ``c < 2^14``;
    callers fall back to :func:`combine_masks_device`'s chunk route
    otherwise. At most 16384 seeds per call.
    """
    e = modulus.bit_length()
    cp = (1 << e) - modulus
    if (e > 63 or cp >= (1 << 14) or modulus % 2 == 0
            or LimbContext.create(modulus).L != 4):
        raise ValueError("fold_masks_device requires an odd pseudo-Mersenne "
                         "modulus with e <= 63 (4 u16 limbs)")
    if len(seed_words) > _FOLD_SEED_CAP:
        raise ValueError("fold_masks_device caps at 16384 seeds per call "
                         "(u32 limb-sum bound); group larger sets")
    dev = resolve_device(device)
    with span("sda.chacha.keys"):
        keys = _key_tensor(seed_words, dev)
    if dimension == 0:
        limbs = torch.zeros((0, 4), dtype=torch.int32, device=dev)
        return limbs, np.zeros(keys.shape[0], dtype=np.int32)
    with span("sda.chacha.fold"):
        if dev.type == "cuda":
            limbs, rej = _launch_fold(keys, dimension, modulus)
        elif dev.type == "cpu":
            limbs, rej = _fold_plain(keys, dimension, modulus)
        else:
            raise ValueError(f"unsupported device {dev}")
    with span("sda.chacha.wait"):
        return limbs, rej.cpu().numpy()


# ---------------------------------------------------------------- combine


def _fix_up(out: np.ndarray, wrong_rows, exact_rows, modulus: int) -> np.ndarray:
    """``out`` with each rejected seed's no-skip row (``wrong_rows``, what the
    device folded) traded for its exact host row (``exact_rows``), mod
    ``modulus``. The arithmetic is in python ints, because the intermediate
    sums cross 2^63; the result is int64 below a modulus of 2^63, object ints
    above."""
    o = out.astype(object)
    for wrong, exact in zip(wrong_rows, exact_rows):
        o = (o - wrong.astype(object) + exact.astype(object)) % modulus
    return o.astype(np.int64) if modulus < (1 << 63) else o


def combine_masks_device(seed_words, dimension: int, modulus: int, fixup_host: bool = True,
                         seed_chunk: int | None = None, device=None):
    """Recipient-side combine: fold all participants' masks mod m.

    ``seed_words``: an ``[S, w]`` array of the seeds' u32 words, or S rows of
    w words. Returns (combined mask ``[d]``, list of seed indices whose
    streams hit a gen_range rejection). On every route the mask is numpy
    int64 below a modulus of 2^63 and object ints above, as
    ``decode_output``'s values. Two routes:

    - **fused** (B5): on a CUDA device, with ``S >= 512``, a
      pseudo-Mersenne modulus with ``e <= 63``, and no ``seed_chunk``
      given. Groups of 16384 seeds, one launch each, each group's limbs
      recombined to int64 on the device and folded on the host with
      ``trunc_add_mod``.
    - **chunk** (B4 + ``_genrange_reduce`` + ``sum_mod``): everything
      else. Seeds stream through the device in ``seed_chunk``-sized blocks
      sized so the ``[chunk, d, L]`` mask block stays ~2 GB (10k seeds x
      1M dimensions is 80+ GB of masks that must never exist at once). The
      reference's ``rows`` (its kernel's seed tile) has no counterpart here.

    With ``fixup_host`` (default) the combined mask is ALREADY exact: the
    device's no-skip masks of the affected seeds are subtracted and their
    exact host expansion (:mod:`sda_tpu_torch.chacha`, which skips rejected
    draws) added back — a per-bad-seed cost, not an all-seeds redo. With
    ``fixup_host=False`` the caller owns the no-skip semantics of the bad
    seeds.
    """
    dev = resolve_device(device)
    ctx = LimbContext.create(modulus)
    S = len(seed_words)
    if S == 0:
        return np.zeros(dimension, dtype=np.int64 if modulus < (1 << 63) else object), []
    e = modulus.bit_length()
    cp = (1 << e) - modulus
    if (seed_chunk is None and S >= 512
            and e <= 63 and cp < (1 << 14) and modulus % 2 == 1
            and ctx.L == 4 and dev.type == "cuda"):
        return _combine_fused(ctx, seed_words, dimension, fixup_host, dev)
    return _combine_chunked(ctx, seed_words, dimension, fixup_host, seed_chunk, dev)


def _combine_fused(ctx: LimbContext, seed_words, dimension: int, fixup_host: bool, dev):
    global fold_recombine_device_launches
    modulus = ctx.p
    out = None
    bad: list[int] = []
    for start in range(0, len(seed_words), _FOLD_SEED_CAP):
        limbs, rej = fold_masks_device(seed_words[start : start + _FOLD_SEED_CAP], dimension,
                                       modulus, device=dev)
        bad.extend(start + int(i) for i in np.nonzero(rej)[0])
        with span("sda.chacha.recombine"):
            # canonical < 2^63 on this route: the int64 values are made where
            # the limbs are, so half the bytes cross to the host
            values = ctx.recombine_i64(limbs)
            fold_recombine_device_launches += 1
        with span("sda.chacha.wait"):
            part = values.cpu().numpy()
        if out is not None:
            with span("sda.chacha.recombine"):
                part = trunc_add_mod(out, part, modulus)
        out = part
    if bad and fixup_host:
        with span("sda.chacha.fixup"):
            seeds = [seed_words[i] for i in bad]
            out = _fix_up(out, chacha.expand_masks_noskip(seeds, dimension, modulus),
                          chacha.expand_masks(seeds, dimension, modulus), modulus)
    return out, bad


def _combine_chunked(ctx: LimbContext, seed_words, dimension: int, fixup_host: bool,
                     seed_chunk: int | None, dev):
    S = len(seed_words)
    if seed_chunk is None:
        seed_chunk = max(128, _CHUNK_BUDGET_BYTES // max(1, dimension * 4 * ctx.L))
    seed_chunk = min(seed_chunk, max(1, S))
    acc = None
    bad: list[int] = []
    wrong_rows: list[torch.Tensor] = []
    for start in range(0, S, seed_chunk):
        masks, rejects = expand_masks_device(seed_words[start : start + seed_chunk], dimension,
                                             ctx.p, device=dev)
        partial = ctx.sum_mod(masks, axis=0)
        acc = partial if acc is None else ctx.add_mod(acc, partial)
        with span("sda.chacha.wait"):
            rejected = torch.nonzero(rejects).flatten().tolist()
        for i in rejected:
            bad.append(start + i)
            if fixup_host:
                wrong_rows.append(masks[i].cpu())
        del masks
    decode = ctx.decode_i64 if ctx.p < (1 << 63) else ctx.decode
    with span("sda.chacha.recombine"):
        out = decode(acc)
    if bad and fixup_host:
        with span("sda.chacha.fixup"):
            exact = chacha.expand_masks([seed_words[i] for i in bad], dimension, ctx.p)
            out = _fix_up(out, [decode(row) for row in wrong_rows], exact, ctx.p)
    return out, bad
