"""The byte-limb path past one launch's participant bound, against sda_tpu.

Chunked (``n_chunks > 1``, kernel B2) and accumulating (``acc_in``, kernel
B3) calls of the port's plain version are held to the reference's
interpret-mode Pallas kernels by exact limb equality in caller-randomness
mode; so are the engine's streaming, chunked and lane-batch entry points.
PRNG mode is held to its own contract: a chunked call and the streaming
loop at the same seed draw the same randomness, and both reveal the
participant sum.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.engine import TpuAggregationEngine
from sda_tpu.fields import find_prime_field, find_special_prime_field
from sda_tpu.ops import mxu8 as ref_m8
from sda_tpu.sharing import PackedShamirScheme
from sda_tpu_torch.engine import TorchAggregationEngine, limbs_from_numpy, spec_from_numpy
from sda_tpu_torch.ops import mxu8 as t_m8

ENGINES = ["p433", "p62", "p63special", "p127special"]
# the engine entry points are compared at the moduli of the port's models
# (FederatedAggregation.packed_64bit and packed_128bit); the kernel-level
# tests cover all four
MODEL_ENGINES = ["p63special", "p127special"]
LANES = 8


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference engine, port engine on the CPU) for one modulus."""
    p, w2, w3, dim = {
        "p433": (433, 354, 150, 21),
        "p62": (*find_prime_field(62, 8, 9), 24),
        "p63special": (*find_special_prime_field(63, 8, 9), 24),
        "p127special": (*find_special_prime_field(127, 8, 9), 24),
    }[name]
    ref = TpuAggregationEngine(PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), dim)
    s = ref.spec
    spec = spec_from_numpy(s.modulus, s.secret_count, s.share_count, s.randomness_count,
                           s.share_matrix, s.reconstruct_matrix)
    return ref, TorchAggregationEngine(spec, dim, device="cpu")


def _stacked_ext(name, n_chunks, P, seed):
    """Caller-randomness planar operands of ``n_chunks * P`` participants,
    chunks stacked along the rows: (reference jnp array, port tensor, the
    secrets as limbs)."""
    ref, eng = _pair(name)
    rng = np.random.default_rng(seed)
    secrets = ref.encode_secrets(
        rng.integers(0, min(ref.ctx.p, 1 << 62), size=(n_chunks * P, ref.dimension))
    )
    ext = np.concatenate([secrets, ref.random_ext(n_chunks * P, rng=rng)], axis=2)
    return (ref_m8.planar8_from_batched(ref.mxu8, jnp.asarray(ext), LANES),
            eng.planar8_ext(limbs_from_numpy(ext), LANES), limbs_from_numpy(secrets))


def _same(want, got):
    return np.array_equal(np.asarray(want).astype(np.int64), got.to(torch.int64).numpy())


@functools.lru_cache(maxsize=None)
def _chunked_case(name, fused_rec):
    """A 3-chunk caller-randomness case: (port operand, the reference's
    interpret-mode chunked kernel's output)."""
    ref, _ = _pair(name)
    n_chunks, P = 3, 2
    e8, t8, _ = _stacked_ext(name, n_chunks, P, 5 + fused_rec)
    want = ref_m8.fused_share_combine_mxu8(
        ref.mxu8, ref.spec.share_matrix, e8, P, 3, 4, lanes=LANES, n_chunks=n_chunks,
        reconstruct_matrix=ref.spec.reconstruct_matrix if fused_rec else None, interpret=True,
    )
    return t8, np.asarray(want)


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("fused_rec", [False, True], ids=["combined", "reconstructed"])
def test_plain_chunked_matches_reference(name, fused_rec):
    _, eng = _pair(name)
    n_chunks, P = 3, 2
    t8, want = _chunked_case(name, fused_rec)
    got = t_m8.fused_share_combine_mxu8(
        eng.mxu8, eng.spec.share_matrix, t8, P, 3, 4, lanes=LANES, n_chunks=n_chunks,
        reconstruct_matrix=eng.spec.reconstruct_matrix if fused_rec else None,
    )
    assert got.dtype == torch.int32 and _same(want, got)


@pytest.mark.parametrize("name", ENGINES)
def test_plain_acc_matches_reference(name):
    """acc_in: the port adds onto the caller's buffer in place and returns
    it; the sums equal the reference's aliased accumulate."""
    ref, eng = _pair(name)
    P = 2
    e8, t8, _ = _stacked_ext(name, 2, P, 8)
    rows = e8.shape[0] // 2
    # a non-zero canonical running sum: the first chunk's combined shares
    acc = t_m8.fused_share_combine_mxu8(
        eng.mxu8, eng.spec.share_matrix, t8[:rows].contiguous(), P, 3, 4, lanes=LANES,
    )
    before = acc.clone()
    want = ref_m8.fused_share_combine_mxu8(
        ref.mxu8, ref.spec.share_matrix, e8[rows:], P, 3, 4, lanes=LANES,
        acc_in=jnp.asarray(before.numpy().astype(np.uint32)), interpret=True,
    )
    got = t_m8.fused_share_combine_mxu8(
        eng.mxu8, eng.spec.share_matrix, t8[rows:].contiguous(), P, 3, 4, lanes=LANES, acc_in=acc,
    )
    assert got is acc and _same(want, got)
    # the sums really are this call's result added onto the old buffer
    alone = t_m8.fused_share_combine_mxu8(
        eng.mxu8, eng.spec.share_matrix, t8[rows:].contiguous(), P, 3, 4, lanes=LANES,
    )
    plan = t_m8.mxu8_plan(eng.mxu8, eng.spec.share_matrix, rows, P, 3, 4)
    assert torch.equal(t_m8._add_mod_lm(plan, before, alone), got)


@pytest.mark.parametrize("name", MODEL_ENGINES)
def test_engine_streaming_and_chunked_match_reference(name):
    ref, eng = _pair(name)
    n_chunks, P = 3, 2
    e8, t8, secrets = _stacked_ext(name, n_chunks, P, 9)
    rows = e8.shape[0] // n_chunks
    want = ref.aggregate_mxu8_kernel_streaming(
        [e8[i * rows : (i + 1) * rows] for i in range(n_chunks)], P, seed0=3, lanes=LANES
    )
    # chunks as tensors and as callables f(i)
    got = eng.aggregate_mxu8_kernel_streaming(
        [lambda i: t8[i * rows : (i + 1) * rows]] * n_chunks, P, seed0=3, lanes=LANES
    )
    assert got.shape == (eng.nb, 3, eng.ctx.L) and _same(want, got)
    want_c = ref.aggregate_mxu8_kernel_chunked(e8, n_chunks, P, lanes=LANES)
    got_c = eng.aggregate_mxu8_kernel_chunked(t8, n_chunks, P, lanes=LANES)
    assert _same(want_c, got_c)
    assert torch.equal(got_c.to(torch.int64), eng.ctx.sum_mod(secrets, axis=0))


@pytest.mark.parametrize("name", MODEL_ENGINES)
def test_engine_lane_batch_jobs_match_reference(name):
    ref, eng = _pair(name)
    n_jobs, P = 3, 2
    e8, t8, secrets = _stacked_ext(name, n_jobs, P, 17)
    rows = e8.shape[0] // n_jobs
    want_b = ref.concat_jobs_lanes([e8[i * rows : (i + 1) * rows] for i in range(n_jobs)])
    got_b = eng.concat_jobs_lanes([t8[i * rows : (i + 1) * rows] for i in range(n_jobs)])
    assert np.array_equal(np.asarray(want_b), got_b.numpy())
    sums = eng.ctx.sum_mod(secrets.reshape(n_jobs, P, *secrets.shape[1:]), axis=1)
    for combined in (False, True):
        want = ref.aggregate_mxu8_kernel_jobs(want_b, 0, P, n_jobs, lanes=LANES,
                                              combined_randomness=combined)
        got = eng.aggregate_mxu8_kernel_jobs(got_b, 0, P, n_jobs, lanes=LANES,
                                             combined_randomness=combined)
        assert got.shape == (n_jobs, eng.nb, 3, eng.ctx.L) and _same(want, got)
        assert torch.equal(got.to(torch.int64), sums)


@pytest.mark.parametrize("name", ENGINES)
def test_prng_chunked_equals_streaming(name):
    """PRNG mode: chunk c of a chunked call draws with seed s + c * (NBP //
    lanes), the seed the streaming loop gives chunk c, so the two combined
    outputs are bit-equal; both reveal the participant sum, and the
    combined-draw serving mode reveals it too."""
    _, eng = _pair(name)
    n_chunks, P, seed = 3, 2, 41
    rng = np.random.default_rng(21)
    secrets = eng.encode_secrets(
        rng.integers(0, min(eng.ctx.p, 1 << 62), size=(n_chunks * P, eng.dimension))
    )
    sec8 = eng.planar8_secrets(secrets, LANES)
    rows = sec8.shape[0] // n_chunks
    chunks = [sec8[i * rows : (i + 1) * rows] for i in range(n_chunks)]
    M = eng.spec.share_matrix
    chunked = t_m8.fused_share_combine_mxu8(eng.mxu8, M, sec8, P, 3, 4, seed=seed, lanes=LANES,
                                            n_chunks=n_chunks)
    grid_t = sec8.shape[1] // LANES
    acc = t_m8.fused_share_combine_mxu8(eng.mxu8, M, chunks[0], P, 3, 4, seed=seed, lanes=LANES)
    for c in range(1, n_chunks):
        t_m8.fused_share_combine_mxu8(eng.mxu8, M, chunks[c], P, 3, 4, seed=seed + c * grid_t,
                                      lanes=LANES, acc_in=acc)
    assert torch.equal(chunked, acc)
    # the randomness is really drawn per chunk: another seed moves the shares
    other = t_m8.fused_share_combine_mxu8(eng.mxu8, M, sec8, P, 3, 4, seed=seed + 1, lanes=LANES,
                                          n_chunks=n_chunks)
    assert not torch.equal(chunked, other)
    total = eng.ctx.sum_mod(secrets, axis=0)
    assert torch.equal(eng.reconstruct_planar8(acc, LANES).to(torch.int64), total)
    for out in (
        eng.aggregate_mxu8_kernel_chunked(sec8, n_chunks, P, seed=seed, lanes=LANES),
        eng.aggregate_mxu8_kernel_streaming(chunks, P, seed0=seed, lanes=LANES),
    ):
        assert torch.equal(out.to(torch.int64), total)
    jobs = eng.aggregate_mxu8_kernel_jobs(eng.concat_jobs_lanes(chunks), seed, P, n_chunks,
                                          lanes=LANES, combined_randomness=True)
    sums = eng.ctx.sum_mod(secrets.reshape(n_chunks, P, *secrets.shape[1:]), axis=1)
    assert torch.equal(jobs.to(torch.int64), sums)


def test_reconstruct_planar8_matches_cios():
    """The one-launch reconstruction of canonical combined shares equals the
    CIOS reconstruction of the same shares."""
    _, eng = _pair("p127special")
    rng = np.random.default_rng(4)
    enc = eng.encode_secrets(rng.integers(0, 1 << 62, size=(3, eng.dimension)))
    comb = eng.mxu8_kernel_combined(eng.planar8_ext(torch.cat([enc, eng.random_ext(3, rng=rng)],
                                                               dim=2), LANES), 0, 3, LANES)
    shares = t_m8.batched_from_planar_lm(comb, eng.nb, 8).to(torch.int64)
    assert torch.equal(eng.reconstruct_planar8(comb, LANES).to(torch.int64),
                       eng.reconstruct(shares))


def test_chunked_guards():
    _, eng = _pair("p62")
    M, mxu8 = eng.spec.share_matrix, eng.mxu8
    ok = torch.zeros((2 * 3 * 8, 8), dtype=torch.int8)
    acc = torch.zeros((4 * 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="acc_in accumulation requires"):
        t_m8.fused_share_combine_mxu8(mxu8, M, torch.cat([ok, ok]), 2, 3, 4, lanes=8,
                                      n_chunks=2, acc_in=acc)
    with pytest.raises(ValueError, match="divide evenly into n_chunks"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok[:40], 2, 3, 4, lanes=8, n_chunks=3)
    with pytest.raises(ValueError, match="acc_in must be"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, acc_in=acc[:, :4])
    with pytest.raises(ValueError, match="acc_in must be"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, acc_in=acc.to(torch.int64))
    # the carry-chain bound holds per chunk: 2 x 1,500 participants plan,
    # one chunk of 3,000 does not
    plan = t_m8.mxu8_plan(mxu8, M, 1500 * 3 * 8, 1500, 3, 4, n_chunks=2)
    assert (plan.rows, plan.n_chunks) == (36000, 2)
    with pytest.raises(ValueError, match="carry-chain bound"):
        t_m8.mxu8_plan(mxu8, M, 3000 * 3 * 8, 3000, 3, 4, n_chunks=2)
    with pytest.raises(ValueError, match="n_chunks must be >= 1"):
        t_m8.mxu8_plan(mxu8, M, 48, 2, 3, 4, n_chunks=0)
    chunked = t_m8.mxu8_plan(mxu8, M, 48, 2, 3, 4, n_chunks=2)
    with pytest.raises(ValueError, match="needs lanes"):
        t_m8.run_mxu8(chunked, torch.cat([ok, ok]), 0)
    with pytest.raises(ValueError, match="rows do not match"):
        t_m8.run_mxu8(chunked, ok, 0, lanes=8)
    with pytest.raises(ValueError, match="at least one chunk"):
        eng.aggregate_mxu8_kernel_streaming([], 2, lanes=8)
    with pytest.raises(ValueError, match="share the planar shape"):
        eng.concat_jobs_lanes([ok, ok[:, :4]])
    with pytest.raises(ValueError, match="divide evenly into jobs"):
        eng.aggregate_mxu8_kernel_jobs(torch.cat([ok, ok], dim=1), 0, 2, 3, lanes=8)


# ------------------------------------------------- B2's split K (partition)


def test_chunked_splits_fill_the_card_in_one_wave():
    """Config 3 (NBP 3,584: 28 lane blocks; 2 chunks of 384 K tiles) on 132
    SMs at 2 blocks per SM: S = 9, 252 blocks, as many as fit the 264
    slots in one wave and more than the SM count. The headline's 2,608
    lane blocks fill the card alone: S = 1."""
    s = t_m8.chunked_splits(28, 384, 2, 132, 2)
    assert s == 9
    assert 28 * s <= 132 * 2 < 28 * (s + 1) and 28 * s >= 132
    assert t_m8.chunked_splits(2608, 288, 1, 132, 2) == 1
    # no split shorter than the ring: 3 tiles in all leave one split
    assert t_m8.chunked_splits(1, 1, 3, 132, 2) == 1
    assert t_m8.chunked_splits(1, 4, 3, 132, 2) == 3
    # a card that takes one block per SM halves the slots
    assert t_m8.chunked_splits(28, 384, 2, 132, 1) == 4


@pytest.mark.parametrize("per_chunk,n_chunks", [(7, 3), (384, 2), (5, 1), (1, 3), (13, 4)])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 60])
def test_split_ranges_cover_every_item_once(per_chunk, n_chunks, splits):
    ranges = t_m8.split_ranges(per_chunk, n_chunks, splits)
    assert len(ranges) == splits
    seen = [(c, i) for pieces in ranges for c, b, e in pieces for i in range(b, e)]
    # every (chunk, item) exactly once, in the flattened order
    assert seen == [(c, i) for c in range(n_chunks) for i in range(per_chunk)]
    total = per_chunk * n_chunks
    for pieces in ranges:
        assert all(0 <= b < e <= per_chunk for _, b, e in pieces)
        # a piece per chunk the range touches, cut at chunk ends
        assert len({c for c, _, _ in pieces}) == len(pieces)
        size = sum(e - b for _, b, e in pieces)
        assert total // splits <= size <= -(-total // splits)
    with pytest.raises(ValueError, match="splits must be >= 1"):
        t_m8.split_ranges(4, 2, 0)


SPLITS = [1, 2, 3, 7, 50]


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("fused_rec", [False, True], ids=["combined", "reconstructed"])
def test_plain_chunked_splits_match_reference(name, fused_rec):
    """B2's partition in the plain version: the int32 partials of every
    split's (chunk, tile range) pieces, added with wrap-around, equal the
    unsplit plain version and the reference's interpret-mode chunked
    kernel, for split counts that divide the 3 x ceil(K / 64) tiles
    unevenly, cross chunk ends, and exceed the tiles (50)."""
    _, eng = _pair(name)
    n_chunks, P = 3, 2
    t8, want = _chunked_case(name, fused_rec)
    rec = eng.spec.reconstruct_matrix if fused_rec else None
    plan = t_m8.mxu8_plan(eng.mxu8, eng.spec.share_matrix, t8.shape[0] // n_chunks, P, 3, 4,
                          reconstruct_matrix=rec, n_chunks=n_chunks)
    whole = t_m8.run_mxu8(plan, t8, 0, lanes=LANES)
    assert _same(want, whole)
    for splits in SPLITS:
        got = t_m8.run_mxu8(plan, t8, 0, lanes=LANES, splits=splits)
        assert torch.equal(got, whole), splits


@pytest.mark.parametrize("name", ["p433", "p127special"])
def test_prng_chunked_splits_equal_streaming(name):
    """PRNG mode with B2's partition: each split sums its share of the
    (chunk, draw) pairs (6 draws here, so 7 and 50 splits leave some
    without any), and the u32 sums meet before the byte extraction; the
    result still equals the streaming loop at the same seed."""
    _, eng = _pair(name)
    n_chunks, P, seed = 3, 2, 43
    rng = np.random.default_rng(22)
    secrets = eng.encode_secrets(
        rng.integers(0, min(eng.ctx.p, 1 << 62), size=(n_chunks * P, eng.dimension))
    )
    sec8 = eng.planar8_secrets(secrets, LANES)
    rows = sec8.shape[0] // n_chunks
    M = eng.spec.share_matrix
    grid_t = sec8.shape[1] // LANES
    acc = t_m8.fused_share_combine_mxu8(eng.mxu8, M, sec8[:rows], P, 3, 4, seed=seed, lanes=LANES)
    for c in range(1, n_chunks):
        t_m8.fused_share_combine_mxu8(eng.mxu8, M, sec8[c * rows : (c + 1) * rows], P, 3, 4,
                                      seed=seed + c * grid_t, lanes=LANES, acc_in=acc)
    chunked = t_m8.mxu8_plan(eng.mxu8, M, rows, P, 3, 4, n_chunks=n_chunks)
    for splits in SPLITS:
        got = t_m8.run_mxu8(chunked, sec8, seed, lanes=LANES, splits=splits)
        assert torch.equal(got, acc), splits
    plan = t_m8.mxu8_plan(eng.mxu8, M, rows, P, 3, 4, n_chunks=n_chunks,
                          reconstruct_matrix=eng.spec.reconstruct_matrix)
    out = t_m8.run_mxu8(plan, sec8, seed, lanes=LANES, splits=7)
    assert torch.equal(t_m8.batched_from_planar_lm(out, eng.nb, 3).to(torch.int64),
                       eng.ctx.sum_mod(secrets, axis=0))



@pytest.mark.parametrize("name", ["p433", "p127special"])
def test_plain_chunked_reconstructs_more_outputs_than_clerks(name):
    """A reconstruction matrix with more columns than clerks (11 from 8),
    which the card's chunked kernel takes in passes of n outputs: the plain
    version, whole and split, equals the chunked combine without
    reconstruction followed by that matrix mod p on the host."""
    from sda_tpu_torch.ops.limbs import from_limbs

    _, eng = _pair(name)
    n_chunks, P, n2 = 3, 2, 11
    t8 = _chunked_case(name, False)[0]
    p, n, L = eng.ctx.p, eng.spec.share_count, eng.ctx.L
    rng = np.random.default_rng(31)
    rec = np.array([[int(v) % p for v in row] for row in rng.integers(0, 1 << 62, size=(n, n2))],
                   dtype=object)
    args = (eng.mxu8, eng.spec.share_matrix, t8.shape[0] // n_chunks, P, 3, 4)
    combined = t_m8.run_mxu8(t_m8.mxu8_plan(*args, n_chunks=n_chunks), t8, 0, lanes=LANES)
    plan = t_m8.mxu8_plan(*args, reconstruct_matrix=rec, n_chunks=n_chunks)

    def values(out, n_out):  # [L * n_out, NBP] limb-major -> [n_out, NBP] ints
        return from_limbs(out.to(torch.int64).reshape(L, n_out, -1).permute(1, 2, 0))

    v = values(combined, n)
    want = np.array([[sum(int(v[i, b]) * int(rec[i, j]) for i in range(n)) % p
                      for b in range(v.shape[1])] for j in range(n2)], dtype=object)
    for splits in (None, 2):
        got = values(t_m8.run_mxu8(plan, t8, 0, lanes=LANES, splits=splits), n2)
        assert np.array_equal(got, want), splits


def test_splits_guards():
    _, eng = _pair("p62")
    M = eng.spec.share_matrix
    ok = torch.zeros((2 * 3 * 8, 8), dtype=torch.int8)
    single = t_m8.mxu8_plan(eng.mxu8, M, 48, 2, 3, 4)
    with pytest.raises(ValueError, match="chunked plans only"):
        t_m8.run_mxu8(single, ok, 0, lanes=8, splits=2)
    chunked = t_m8.mxu8_plan(eng.mxu8, M, 48, 2, 3, 4, n_chunks=2)
    with pytest.raises(ValueError, match="chunked plans only"):
        t_m8.run_mxu8(chunked, torch.cat([ok, ok]), 0, lanes=8, splits=0)
