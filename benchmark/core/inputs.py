"""The inputs of every round, made from ``--seed``.

The program and the reference are handed the same inputs: participant
values, written as little-endian 16-bit limbs, in resident chunks of a
fixed number of participants; the ChaCha seed words of each round; and the
sharing-randomness seed of each round. Each is drawn from its own stream,
keyed by the run's seed and by what it is for, so that a chunk or a round
can be made again alone and comes out the same.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# participants made by one generator call; the set-up and the reference
# both make a chunk in blocks of this size, so the values agree
BLOCK = 64

_VALUES, _SEEDS, _KERNEL_SEED, _SAMPLE, _CHUNKS = 1, 2, 3, 4, 5


def _key(seed: int, *tags: int) -> int:
    """A 63-bit key for one stream. ``seed`` is any whole number."""
    state = np.random.SeedSequence([seed % (1 << 64), *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def numpy_rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(_key(seed, *tags))


def limb_count(value_bits: int) -> int:
    return -(-value_bits // 16)


def participant_limbs(seed: int, chunk: int, block: int, count: int, dimension: int,
                      value_bits: int, device) -> torch.Tensor:
    """``[count, dimension, limbs]`` int64 16-bit limbs of the values of
    ``count`` participants (block ``block`` of chunk ``chunk``), each value
    uniform below ``2**value_bits``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_key(seed, _VALUES, chunk, block))
    limbs = limb_count(value_bits)
    out = torch.randint(0, 1 << 16, (count, dimension, limbs), generator=gen,
                        dtype=torch.int64, device=device)
    top_bits = value_bits - 16 * (limbs - 1)
    out[..., limbs - 1] &= (1 << top_bits) - 1
    return out


def chunk_blocks(chunk_participants: int):
    """``(block index, participants)`` of the blocks that make one chunk."""
    return [(b, min(BLOCK, chunk_participants - b * BLOCK))
            for b in range(-(-chunk_participants // BLOCK))]


def multiset(index: int, size: int, kinds: int) -> list[int]:
    """The ``index``-th multiset of ``size`` draws from ``kinds`` chunks, in
    lexicographic order, as a sorted list (``index`` below
    ``comb(size + kinds - 1, size)``)."""
    out, lo = [], 0
    for i in range(size):
        rest = size - i - 1
        for c in range(lo, kinds):
            count = math.comb(rest + kinds - c - 1, rest)
            if index < count:
                out.append(c)
                lo = c
                break
            index -= count
    return out


_WALK_BLOCK = 1024


@functools.lru_cache(maxsize=64)
def _walk(seed: int, states: int, block: int) -> tuple:
    """The walk's states for rounds ``block * 1024`` onwards: each round
    steps from the last by 1 to ``states - 1``, drawn from the seed, so no
    round repeats the one before it."""
    start = (int(numpy_rng(seed, _CHUNKS).integers(0, states)) if block == 0
             else _walk(seed, states, block - 1)[-1])
    steps = numpy_rng(seed, _CHUNKS, block).integers(1, states, size=_WALK_BLOCK)
    return tuple(int(v) for v in (start + np.cumsum(steps)) % states)


def round_chunks(seed: int, round_index: int, per_round: int, resident: int) -> list[int]:
    """The resident chunks a round aggregates: a multiset of ``per_round``
    of them (a chunk may come more than once), drawn from the seed by a walk
    over every such multiset, so that each round's cohort, and its sum,
    differs from the round's before it."""
    states = math.comb(per_round + resident - 1, per_round)
    if states < 2:
        raise ValueError(f"{per_round} of {resident} resident chunks make one cohort only")
    index = _walk(seed, states, round_index // _WALK_BLOCK)[round_index % _WALK_BLOCK]
    return multiset(index, per_round, resident)


def round_seed_words(seed: int, round_index: int, seeds: int, words: int) -> np.ndarray:
    """``[seeds, words]`` int64 u32 words: one ChaCha seed per participant."""
    return numpy_rng(seed, _SEEDS, round_index).integers(0, 1 << 32, size=(seeds, words),
                                                         dtype=np.int64)


def round_kernel_seed(seed: int, round_index: int) -> int:
    """The seed of a round's sharing randomness."""
    return int(numpy_rng(seed, _KERNEL_SEED, round_index).integers(0, 1 << 31))


class Sample:
    """The rounds whose answers are compared: ``count`` of those offered,
    drawn from the seed by reservoir sampling, so that only the answers to
    be compared are kept through the window."""

    def __init__(self, seed: int, count: int):
        self.count, self.seen = int(count), 0
        self.rng = numpy_rng(seed, _SAMPLE)
        self.slots: list = []

    def offer(self, round_index: int, answer) -> None:
        self.seen += 1
        if len(self.slots) < self.count:
            self.slots.append((round_index, answer))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.count:
            self.slots[j] = (round_index, answer)

    def kept(self) -> dict:
        """The kept answers by round."""
        return dict(sorted(self.slots, key=lambda s: s[0]))
