"""Bit-exact reimplementation of `rand 0.3`'s ChaChaRng + gen_range (numpy).

A copy of the reference package's ``chacha`` module, kept so that the port
imports nothing of it. The ChaCha masking scheme expands a small uploaded
seed into a full mask stream on both the participant and the recipient
side. To interoperate bit for bit with the upstream protocol it reproduces:

- the rand 0.3 ChaCha core: 20 rounds, 128-bit block counter occupying state
  words 12..15, key = first 8 seed words zero-padded;
- ``next_u64 = (next_u32 << 32) | next_u32``;
- ``gen_range(0, m)`` for i64: zone rejection with
  ``zone = u64::MAX - u64::MAX % m`` then ``v % m``.

In the port this module is the host oracle of the device expansion
(:mod:`sda_tpu_torch.ops.chacha_kernel`), the host fold of the maskers and
the exact path for the rare seeds whose streams hit a rejection.
:func:`expand_masks` expands through the native library's
``sda_chacha_expand_masks`` (``native/chacha.cpp``, built from the sources
at its first call by :func:`sda_tpu_torch.utils.varint.native_library`,
never at import) under the reference's guards, and through numpy where the
library cannot be built or the guards refuse; ``expansions`` counts the
calls each route served.
"""

from __future__ import annotations

import ctypes
import secrets as _secrets

import numpy as np

__all__ = [
    "ChaChaRng",
    "chacha_core_blocks",
    "new_seed",
    "expand_masks",
    "expand_masks_noskip",
    "expansions",
]

_U32 = np.uint32
_U64_MAX = (1 << 64) - 1
_CONSTANTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=_U32)
_ROUNDS = 20

# calls of expand_masks served by each route
expansions = {"native": 0, "numpy": 0}


def _rotl(x, k):
    return (x << _U32(k)) | (x >> _U32(32 - k))


def _quarter(state, a, b, c, d):
    # rand 0.3 chacha.rs quarter_round! (16/12/8/7 rotations)
    state[a] += state[b]; state[d] ^= state[a]; state[d] = _rotl(state[d], 16)
    state[c] += state[d]; state[b] ^= state[c]; state[b] = _rotl(state[b], 12)
    state[a] += state[b]; state[d] ^= state[a]; state[d] = _rotl(state[d], 8)
    state[c] += state[d]; state[b] ^= state[c]; state[b] = _rotl(state[b], 7)


def chacha_core_blocks(states: np.ndarray) -> np.ndarray:
    """Run the ChaCha20 core on ``[..., 16]`` u32 input states (vectorised)."""
    x = [states[..., i].copy() for i in range(16)]
    with np.errstate(over="ignore"):
        for _ in range(_ROUNDS // 2):
            # column round
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            # diagonal round
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        out = np.stack(x, axis=-1)
        out += states
    return out


def _initial_state(seed_words) -> np.ndarray:
    key = np.zeros(8, dtype=_U32)
    seed = np.asarray(seed_words, dtype=np.uint64).astype(_U32)
    key[: min(8, len(seed))] = seed[:8]
    state = np.zeros(16, dtype=_U32)
    state[0:4] = _CONSTANTS
    state[4:12] = key
    return state


class ChaChaRng:
    """Scalar rand-0.3-compatible ChaCha RNG (exact stream + gen_range)."""

    def __init__(self, seed_words):
        self.state = _initial_state(seed_words)
        self.buffer = np.zeros(16, dtype=_U32)
        self.index = 16

    def _update(self):
        self.buffer = chacha_core_blocks(self.state[None, :])[0]
        self.index = 0
        with np.errstate(over="ignore"):
            for i in range(12, 16):  # 128-bit counter with carry
                self.state[i] += _U32(1)
                if self.state[i] != 0:
                    break

    def next_u32(self) -> int:
        if self.index == 16:
            self._update()
        v = int(self.buffer[self.index])
        self.index += 1
        return v

    def next_u64(self) -> int:
        hi = self.next_u32()
        lo = self.next_u32()
        return (hi << 32) | lo

    def gen_range_i64(self, low: int, high: int) -> int:
        """rand 0.3 ``Range::new(low, high).ind_sample`` for i64."""
        rng_span = (high - low) & _U64_MAX
        zone = _U64_MAX - _U64_MAX % rng_span
        while True:
            v = self.next_u64()
            if v < zone:
                return low + (v % rng_span)


def new_seed(seed_bitsize: int, rng: np.random.Generator | None = None) -> list[int]:
    """Fresh seed as u32 words: from the OS CSPRNG (the protocol path), or
    from ``rng``, a seeded numpy Generator, for reproducible runs only."""
    words = (seed_bitsize + 31) // 32
    if rng is not None:
        return [int(w) for w in rng.integers(0, 1 << 32, size=words, dtype=np.uint64)]
    return [_secrets.randbits(32) for _ in range(words)]


def _raw_draws(seeds, dimension: int) -> np.ndarray:
    """``[S, dimension]`` u64 raw draws ``hi << 32 | lo`` (hi = first word)."""
    s = len(seeds)
    nblocks = -(-2 * dimension // 16)
    states = np.stack([_initial_state(w) for w in seeds])  # [S, 16]
    blocks = np.broadcast_to(states[:, None, :], (s, nblocks, 16)).copy()
    counters = np.arange(nblocks, dtype=np.uint64)
    blocks[:, :, 12] = (counters & 0xFFFFFFFF).astype(_U32)[None, :]
    blocks[:, :, 13] = (counters >> np.uint64(32)).astype(_U32)[None, :]
    stream = chacha_core_blocks(blocks).reshape(s, nblocks * 16)  # u32 stream
    hi = stream[:, 0::2].astype(np.uint64)
    lo = stream[:, 1::2].astype(np.uint64)
    return ((hi << np.uint64(32)) | lo)[:, :dimension]


def expand_masks_noskip(seeds, dimension: int, modulus: int) -> np.ndarray:
    """Device-semantics expansion: every draw is ``v % m`` with NO
    rejection skipping (the device fold sums raw draws, which is
    congruent). Used to back out a rejection-hit seed's device
    contribution before adding the exact host expansion back."""
    seeds = list(seeds)
    s = len(seeds)
    if s == 0 or dimension == 0:
        return np.zeros((s, dimension), dtype=np.int64)
    return (_raw_draws(seeds, dimension) % np.uint64(modulus)).astype(np.int64)


def _native_expand():
    """``sda_chacha_expand_masks`` from the native library with its
    argument types declared, or ``None`` where the library cannot be built
    or loaded or lacks it."""
    from sda_tpu_torch.utils.varint import native_library

    lib = native_library()
    fn = getattr(lib, "sda_chacha_expand_masks", None) if lib is not None else None
    if fn is not None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
        ]
    return fn


def expand_masks(seeds, dimension: int, modulus: int) -> np.ndarray:
    """Expand ``[S]`` seeds (each a u32 word list) into ``[S, dimension]`` masks.

    Each mask element is one ``gen_range(0, m)`` draw (two u32 words),
    matching the reference's sequential expansion. The native expansion
    runs when there are seeds, ``dimension > 0``, ``0 < modulus < 2^63``
    and every seed has the same number of words, and returns when it
    reports success; it handles rejections inline. Otherwise numpy runs,
    vectorised over seeds: a seed whose draws hit a rejection (probability
    ~m/2**64 per draw) is redone on the exact scalar path, the others keep
    the vectorised draws.
    """
    seeds = list(seeds)
    s = len(seeds)
    if s and dimension > 0 and 0 < modulus < (1 << 63) and len({len(w) for w in seeds}) == 1:
        native = _native_expand()
        if native is not None:
            words = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint32))
            out = np.empty((s, dimension), dtype=np.int64)
            rc = native(
                words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                words.shape[0],
                words.shape[1],
                dimension,
                modulus,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if rc == 0:
                expansions["native"] += 1
                return out
    expansions["numpy"] += 1
    return _expand_masks_numpy(seeds, dimension, modulus)


def _expand_masks_numpy(seeds, dimension: int, modulus: int) -> np.ndarray:
    """:func:`expand_masks` through numpy alone."""
    s = len(seeds)
    if s == 0 or dimension == 0:
        return np.zeros((s, dimension), dtype=np.int64)
    zone = _U64_MAX - _U64_MAX % modulus
    draws = _raw_draws(seeds, dimension)
    out = (draws % np.uint64(modulus)).astype(np.int64)
    for i in np.nonzero((draws >= zone).any(axis=1))[0]:
        # exact-but-slow fallback for the astronomically rare rejection case
        rng = ChaChaRng(seeds[i])
        out[i] = [rng.gen_range_i64(0, modulus) for _ in range(dimension)]
    return out
