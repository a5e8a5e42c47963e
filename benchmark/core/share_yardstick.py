"""The yardstick of the sharing contraction: the least time of a round's
share + combine on the card, from shapes alone.

A round shares ``participants`` vectors of ``dimension`` elements among
``share_count`` clerks in batches of ``secret_count``. Its least work is
the larger of two bounds, each over the card table of
:mod:`benchmark.core.yardstick` and the H100 SXM's dense int8 tensor rate:

- bytes: every participant element read once at 4 bytes (a 20-bit
  element's whole 32-bit word) and the revealed vector written once, over
  the HBM rate;
- operations: each batch of ``secret_count`` secrets meets each of the
  ``share_count`` clerks' columns of the sharing matrix, byte by byte:
  ``participants * ceil(dimension / secret_count) * secret_count *
  share_count * ceil(field_bits / 8)^2`` int8 multiply-adds. The sharing
  randomness, padding and the implementation's own layout are not counted,
  so the same work reads the same bound whatever implements it.
"""

from __future__ import annotations

from benchmark.core.yardstick import CARD

# NVIDIA H100 SXM, data sheet: 1,979 dense int8 tera-operations a second,
# one multiply-add being two operations
INT8_MACS_PER_S = 989.5e12
ELEMENT_BYTES = 4


def share_bytes(participants: int, dimension: int) -> int:
    return (participants + 1) * dimension * ELEMENT_BYTES


def share_macs(participants: int, dimension: int, secret_count: int, share_count: int,
               field_bits: int) -> int:
    batches = -(-dimension // secret_count)
    field_bytes = -(-field_bits // 8)
    return participants * batches * secret_count * share_count * field_bytes ** 2


def share_bound_s(participants: int, dimension: int, secret_count: int, share_count: int,
                  field_bits: int) -> float:
    return max(share_bytes(participants, dimension) / CARD["hbm_bytes_per_s"],
               share_macs(participants, dimension, secret_count, share_count, field_bits)
               / INT8_MACS_PER_S)
