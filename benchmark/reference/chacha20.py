"""ChaCha masks, in plain PyTorch: the recipient's combined mask, worked out
again from the participants' seeds.

The ChaCha masking scheme expands each participant's seed with the
``rand`` 0.3 crate's ``ChaChaRng`` and draws every mask element with
``gen_range(0, m)``:

- the ChaCha20 block function (RFC 7539 section 2.3), 20 rounds; the key is
  the seed's first 8 u32 words, zero-padded; state words 12..15 hold a
  128-bit block counter starting at 0 (no nonce);
- the stream's words are taken in order; a 64-bit draw is
  ``first << 32 | second``;
- ``gen_range(0, m)`` rejects a draw ``v >= zone``, ``zone = 2**64 - (2**64
  mod m)`` (``u64::MAX - u64::MAX % m``), and takes the next one; otherwise
  it gives ``v mod m``.

The combined mask is the sum of all masks mod m. Since ``v mod m = v`` mod
m, the sum of the raw draws is summed here, as two int64 sums of 32-bit
words, and reduced once. A seed whose first ``d`` draws hold a rejected one
(probability about ``2**64 mod m`` over ``2**64`` a draw) is worked out
again alone, with the rejected draws skipped.

u32 words are carried in int64 tensors and masked after every add and
rotate. ``precision="float64"`` sums the draws in float64 instead: the
control, one precision below the exact sum.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
KEY_WORDS = 8
DRAWS_PER_BLOCK = 8


def _rotl(x, k: int):
    return ((x << k) & M32) | (x >> (32 - k))


def _quarter(x, a, b, c, d):
    x[a] = (x[a] + x[b]) & M32
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & M32
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & M32
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & M32
    x[b] = _rotl(x[b] ^ x[c], 7)


def block_function(state: list) -> list:
    """The ChaCha20 block function on 16 same-shaped int64 tensors of u32
    words: 10 double rounds, then the input added word by word."""
    x = list(state)
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(x[w] + state[w]) & M32 for w in range(16)]


def key_tensor(seed_words: np.ndarray, device) -> torch.Tensor:
    """``[S, 8]`` int64 keys: each seed's first 8 u32 words, zero-padded."""
    words = np.asarray(seed_words, dtype=np.int64) & M32
    keys = np.zeros((words.shape[0], KEY_WORDS), dtype=np.int64)
    n = min(KEY_WORDS, words.shape[1])
    keys[:, :n] = words[:, :n]
    return torch.from_numpy(keys).to(device)


def stream_words(keys: torch.Tensor, first_block: int, blocks: int) -> list:
    """16 ``[S, blocks]`` tensors: words of blocks ``first_block`` onwards."""
    if first_block + blocks > (1 << 32):
        raise ValueError("the block counter stays in one word here")
    shape = (keys.shape[0], blocks)
    zero = torch.zeros(shape, dtype=torch.int64, device=keys.device)
    counter = torch.arange(first_block, first_block + blocks, dtype=torch.int64,
                           device=keys.device)
    state = [zero + c for c in CONSTANTS]
    state += [zero + keys[:, w : w + 1] for w in range(KEY_WORDS)]
    state += [zero + counter[None, :], zero, zero, zero]
    return block_function(state)


def zone(modulus: int) -> int:
    return (1 << 64) - ((1 << 64) % modulus)


def _word_pairs(key: torch.Tensor, first_block: int, blocks: int) -> np.ndarray:
    """``[blocks * 8, 2]`` int64: one seed's draws' (first, second) words."""
    words = torch.stack(stream_words(key[None], first_block, blocks), dim=-1)[0]
    return words.cpu().numpy().reshape(-1, 2)


def _draws(pairs: np.ndarray) -> np.ndarray:
    return (pairs[:, 0].astype(object) << 32) | pairs[:, 1].astype(object)


def _exact_draws(key: torch.Tensor, count: int, modulus: int) -> np.ndarray:
    """One seed's first ``count`` accepted raw draws, as Python ints."""
    limit = zone(modulus)
    kept: list[np.ndarray] = []
    have, first = 0, 0
    while have < count:
        blocks = -(-(count - have) // DRAWS_PER_BLOCK) + 1
        v = _draws(_word_pairs(key, first, blocks))
        v = v[v < limit]
        kept.append(v)
        have += len(v)
        first += blocks
    return np.concatenate(kept)[:count]


def combined_mask(seed_words: np.ndarray, dimension: int, modulus: int, device,
                  precision: str = "exact", batch: int = 1 << 24) -> np.ndarray:
    """The sum mod ``modulus`` of every seed's mask: an object array of
    Python ints (``"exact"``), or float64 (``"float64"``, the control)."""
    keys = key_tensor(seed_words, device)
    seeds = keys.shape[0]
    blocks = -(-dimension // DRAWS_PER_BLOCK)
    limit = zone(modulus)
    zh, zl = limit >> 32, limit & M32
    exact = precision == "exact"
    dtype = torch.int64 if exact else torch.float64
    hi_sum = torch.zeros((blocks, DRAWS_PER_BLOCK), dtype=dtype, device=device)
    lo_sum = torch.zeros_like(hi_sum)
    bad = torch.zeros(seeds, dtype=torch.bool, device=device)
    step = max(1, batch // max(1, seeds))
    for first in range(0, blocks, step):
        n = min(step, blocks - first)
        words = stream_words(keys, first, n)
        for t in range(DRAWS_PER_BLOCK):
            hi, lo = words[2 * t], words[2 * t + 1]
            drawn = (first + torch.arange(n, device=device)) * DRAWS_PER_BLOCK + t < dimension
            rejected = ((hi > zh) | ((hi == zh) & (lo >= zl))) & drawn[None, :]
            bad |= rejected.any(dim=1)
            keep = drawn.to(dtype)
            if exact:
                hi_sum[first : first + n, t] += hi.sum(dim=0) * keep
                lo_sum[first : first + n, t] += lo.sum(dim=0) * keep
            else:
                v = hi.to(torch.float64) * float(1 << 32) + lo.to(torch.float64)
                hi_sum[first : first + n, t] += v.sum(dim=0) * keep
        del words
    hi_sum = hi_sum.reshape(-1)[:dimension].cpu().numpy()
    lo_sum = lo_sum.reshape(-1)[:dimension].cpu().numpy()
    if not exact:
        return np.fmod(hi_sum, float(modulus))
    total = (hi_sum.astype(object) << 32) + lo_sum.astype(object)
    for s in torch.nonzero(bad).flatten().tolist():
        noskip = _draws(_word_pairs(keys[s], 0, blocks))[:dimension]
        total = total - noskip + _exact_draws(keys[s], dimension, modulus)
    return total % modulus
