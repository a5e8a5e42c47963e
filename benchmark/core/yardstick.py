"""The yardstick: the card table and the least work of a round.

Every bound here is worked out from a configuration's shapes and the card
table below, never from the built kernels, so the same work reads the same
bound whatever implements it.

- The aggregation reads every participant element once at the field's byte
  width and writes the revealed vector once; its bound is those bytes over
  the HBM rate. Padding, accumulators and the implementation's own layout
  are not counted.
- The ChaCha mask expansion runs ChaCha20 once for every 64-byte block of
  every seed's stream: 80 quarter rounds of 12 32-bit operations (a rotate
  counts as one) and 16 final adds, 976 operations a block. Each 64-bit
  draw is two 32-bit words, so a block gives 8 draws, and the fold adds
  each word into a running sum once (16 operations a block). Its bound is
  those operations over the SMs' 32-bit issue rate at the published boost
  clock.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet: HBM3 bandwidth, SMs, 32-bit lanes an SM
# issues a clock (4 schedulers x 32), boost clock. Fixed here so that the
# yardstick does not move with the card a run lands on.
CARD = {
    "name": "NVIDIA H100 SXM",
    "hbm_bytes_per_s": 3.35e12,
    "sms": 132,
    "issue_lanes": 128,
    "sm_mhz": 1980.0,
}

CHACHA_BLOCK_OPS = 976
CHACHA_WORDS_PER_BLOCK = 16
WORDS_PER_DRAW = 2
FOLD_OPS_PER_WORD = 1


def field_bytes(field_bits: int) -> int:
    """Bytes of one field element: whole 64-bit words (8 at 63 bits, 16 at
    127 bits)."""
    return 8 * -(-field_bits // 64)


def aggregate_bytes(participants: int, dimension: int, field_bits: int) -> int:
    """Participant elements read once and the revealed vector written once."""
    width = field_bytes(field_bits)
    return participants * dimension * width + dimension * width


def aggregate_bound_s(participants: int, dimension: int, field_bits: int) -> float:
    return aggregate_bytes(participants, dimension, field_bits) / CARD["hbm_bytes_per_s"]


def chacha_blocks(dimension: int) -> int:
    """ChaCha20 blocks of one seed's stream for ``dimension`` draws."""
    draws_per_block = CHACHA_WORDS_PER_BLOCK // WORDS_PER_DRAW
    return -(-dimension // draws_per_block)


def chacha_ops(seeds: int, dimension: int) -> int:
    per_block = CHACHA_BLOCK_OPS + CHACHA_WORDS_PER_BLOCK * FOLD_OPS_PER_WORD
    return seeds * chacha_blocks(dimension) * per_block


def chacha_bound_s(seeds: int, dimension: int) -> float:
    rate = CARD["sms"] * CARD["issue_lanes"] * CARD["sm_mhz"] * 1e6
    return chacha_ops(seeds, dimension) / rate
