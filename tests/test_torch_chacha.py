"""The port's ChaCha mask reveal (host oracle, B4/B5 plain versions and the
combine routes) against sda_tpu.

Inputs come from numpy seeds; every comparison is exact integer equality.
The reference's interpret-mode kernels are slow on the CPU, so they run
only at the smallest sizes (3 seeds x 4 blocks, 5 seeds x 40 dimensions,
7 seeds x 64 dimensions); elsewhere the port is held against the
reference's host oracle (``sda_tpu.chacha``, ``sda_tpu.fields``).
"""

from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from sda_tpu import chacha as ref_chacha
from sda_tpu.fields import find_prime_field, find_special_prime_field
from sda_tpu.fields import trunc_add_mod as ref_trunc_add_mod
from sda_tpu.ops import chacha_kernel as ref_ck
from sda_tpu.ops.limbs import LimbContext as RefLimbContext
from sda_tpu_torch import chacha
from sda_tpu_torch.ops import chacha_kernel as ck
from sda_tpu_torch.ops.limbs import LimbContext

P63 = find_special_prime_field(63, 8, 9)[0]  # 2^63 - 871
P55 = find_special_prime_field(55, 8, 9)[0]  # 2^55 - 55
P62 = find_prime_field(62, 8, 9)[0]  # generic 62-bit prime, ~1/8 of draws rejected
FORCED = (1 << 62) + 1  # rejection probability ~1/4 per draw
U64_MAX = (1 << 64) - 1


def _seeds(n, seed=0, words=4):
    rng = np.random.default_rng(seed)
    return [chacha.new_seed(32 * words, rng) for _ in range(n)]


def _host_fold(seeds, d, p):
    """The reference's host oracle: exact expansion, folded mod p."""
    acc = np.zeros(d, dtype=np.int64)
    for row in ref_chacha.expand_masks(seeds, d, p):
        acc = ref_trunc_add_mod(acc, row, p)
    return acc.tolist()


def _raw_draws(seeds, d):
    """Each seed's first ``d`` raw 64-bit draws, from the reference's
    scalar generator."""
    rngs = [ref_chacha.ChaChaRng(w) for w in seeds]
    return [[rng.next_u64() for _ in range(d)] for rng in rngs]


def _value(limbs):
    """``[..., 4]`` canonical limbs -> python ints."""
    la = np.asarray(limbs).astype(np.int64)
    return (la[..., 0] | (la[..., 1] << 16) | (la[..., 2] << 32) | (la[..., 3] << 48)).tolist()


# ------------------------------------------------------------ host oracle


@pytest.mark.parametrize(
    "words,draws",
    [([0] * 8, 40), ([1, 2, 3, 4], 40), ([0xFFFFFFFF] * 4, 20)],
    ids=["zero_seed", "counter_carry", "all_ones"],
)
def test_rng_stream_matches_reference(words, draws):
    """The RFC zero-seed stream and streams across block boundaries (the
    counter carry of test_crypto_host)."""
    got, want = chacha.ChaChaRng(words), ref_chacha.ChaChaRng(words)
    assert [got.next_u32() for _ in range(draws)] == [want.next_u32() for _ in range(draws)]
    assert [got.next_u64() for _ in range(5)] == [want.next_u64() for _ in range(5)]
    if words == [0] * 8:
        first = chacha.ChaChaRng(words)
        assert [first.next_u32() for _ in range(4)] == [0xADE0B876, 0x903DF1A0, 0xE56A5D40,
                                                        0x28BD8653]


def test_rng_gen_range_scalar_fallback_matches_reference():
    """At m = 2^62 + 1 a quarter of the draws are rejected and redrawn."""
    got, want = chacha.ChaChaRng([5, 6, 7, 8]), ref_chacha.ChaChaRng([5, 6, 7, 8])
    assert [got.gen_range_i64(0, FORCED) for _ in range(40)] == [
        want.gen_range_i64(0, FORCED) for _ in range(40)
    ]


@pytest.mark.parametrize("modulus", [433, (1 << 61) - 1, P62, FORCED],
                         ids=["p433", "p61", "p62", "forced"])
def test_expand_masks_matches_reference(modulus):
    seeds = _seeds(5, seed=1)
    assert np.array_equal(chacha.expand_masks(seeds, 33, modulus),
                          ref_chacha.expand_masks(seeds, 33, modulus))
    assert np.array_equal(chacha.expand_masks_noskip(seeds, 33, modulus),
                          ref_chacha.expand_masks_noskip(seeds, 33, modulus))


def test_chacha_core_matches_public_djb_vectors():
    """The first two keystream blocks of the all-zero key, zero counter:
    D. J. Bernstein's published ChaCha20 test vector, byte for byte."""
    r = chacha.ChaChaRng([0] * 8)
    stream = b"".join(int(r.next_u32()).to_bytes(4, "little") for _ in range(32))
    assert stream[:64].hex() == (
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
        "da41597c5157488d7724e03fb8d84a376a43b8f41518a11cc387b669b2ee6586")
    assert stream[64:128].hex() == (
        "9f07e7be5551387a98ba977c732d080dcb0f29a048e3656912c6533e32ee7aed"
        "29b721769ce64e43d57133b074d839d531ed1f28510afb45ace10a1f4b794d6f")


def test_expand_masks_matches_the_scalar_generator():
    """Each row of the batch expansion is the scalar generator's
    ``gen_range_i64(0, m)`` draws from the same seed."""
    seeds = _seeds(5, seed=4)
    batch = chacha.expand_masks(seeds, 33, 433)
    for row, words in zip(batch, seeds):
        rng = chacha.ChaChaRng(words)
        assert row.tolist() == [rng.gen_range_i64(0, 433) for _ in range(33)]


def test_new_seed_from_a_generator_is_reproducible():
    a = chacha.new_seed(128, np.random.default_rng(3))
    assert a == chacha.new_seed(128, np.random.default_rng(3))
    assert len(a) == 4 and all(0 <= w < (1 << 32) for w in a)
    assert len(chacha.new_seed(128)) == 4


# --------------------------------------------------------- B4 (keystream)


def test_keystream_matches_reference_kernel():
    seeds = np.arange(24, dtype=np.uint32).reshape(3, 8)
    want = np.asarray(ref_ck.chacha_keystream(seeds, nblocks=4, rows=1, interpret=True))
    got = ck.chacha_keystream(seeds, 4, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 4, 16)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("form", ["list", "int64_array"])
def test_keystream_rfc_vector_and_ragged_counters(form):
    """The seeds as u32 word lists, or as the ``[S, 4]`` int64 array the
    masker hands on (words of 2^31 and above kept as u32 values, or as their
    negative i64 twins): the same keys, the same stream."""
    got = ck.chacha_keystream(np.zeros((1, 8), np.uint32), 1, device="cpu")
    assert (got[0, 0, :4].to(torch.int64) & 0xFFFFFFFF).tolist() == [
        0xADE0B876, 0x903DF1A0, 0xE56A5D40, 0x28BD8653]
    seeds = _seeds(3, seed=2)
    given = seeds
    if form == "int64_array":
        given = np.array(seeds, dtype=np.int64)
        assert given.shape == (3, 4) and (given >= 1 << 31).any()
        keys = ck._key_words(seeds)
        assert np.array_equal(ck._key_words(given), keys)
        assert np.array_equal(ck._key_words(np.where(given >= 1 << 31, given - (1 << 32), given)),
                              keys)
    got = ck.chacha_keystream(given, 37, device="cpu").numpy().view(np.uint32)
    for s, words in enumerate(seeds):
        rng = ref_chacha.ChaChaRng(words)
        assert got[s].reshape(-1).tolist() == [rng.next_u32() for _ in range(37 * 16)]


def test_keystream_guard():
    with pytest.raises(ValueError, match="nblocks"):
        ck.chacha_keystream([[1, 2]], 1 << 32, device="cpu")


# ------------------------------------------------- chunk-route expansion


def test_expand_masks_device_matches_reference_kernel():
    seeds = _seeds(5, seed=3)
    want_m, want_r = ref_ck.expand_masks_device(seeds, 40, 433, rows=1, interpret=True)
    got_m, got_r = ck.expand_masks_device(seeds, 40, 433, device="cpu")
    assert np.array_equal(got_m.numpy(), np.asarray(want_m).astype(np.int64))
    assert got_r.tolist() == np.asarray(want_r).tolist()


@pytest.mark.parametrize("modulus", [(1 << 31) - 1, (1 << 61) - 1, P62, FORCED],
                         ids=["p31", "p61", "p62", "forced"])
def test_expand_masks_device_matches_noskip(modulus):
    seeds = _seeds(6, seed=4)
    d = 40
    masks, counts = ck.expand_masks_device(seeds, d, modulus, device="cpu")
    got = RefLimbContext.create(modulus).decode(masks.numpy().astype(np.uint32))
    want = ref_chacha.expand_masks_noskip(seeds, d, modulus)
    assert [[int(v) for v in row] for row in got] == want.tolist()
    zone = U64_MAX - U64_MAX % modulus
    assert counts.tolist() == [sum(v >= zone for v in row) for row in _raw_draws(seeds, d)]
    if modulus in (P62, FORCED):
        assert counts.sum() > 0  # the rejection count is exercised


def test_expand_masks_device_wide_modulus_keeps_raw_draws():
    """L = 8 (p >= 2^64): every draw is already canonical."""
    p = (1 << 64) + 13
    seeds = _seeds(2, seed=5)
    masks, _ = ck.expand_masks_device(seeds, 12, p, device="cpu")
    assert masks.shape == (2, 12, 8)
    assert [[int(v) for v in row] for row in LimbContext.create(p).decode(masks)] == (
        _raw_draws(seeds, 12))


def test_expand_masks_device_rejects_even_modulus():
    with pytest.raises(ValueError):
        ck.expand_masks_device([[1, 2, 3, 4]], 8, 256, device="cpu")


# --------------------------------------------------------- B5 (the fold)


@pytest.mark.parametrize("modulus,d", [(P63, 264), (P55, 264), (P63, 261)],
                         ids=["e63", "e55", "e63_ragged"])
def test_fold_matches_host_oracle(modulus, d):
    """S = 1,100 seeds; e = 55 guards the carry*K product that wrapped in
    u32 for e below ~60; d = 261 leaves the last counter 5 draws."""
    seeds = _seeds(1100, seed=6)
    limbs, rej = ck.fold_masks_device(seeds, d, modulus, device="cpu")
    assert limbs.dtype == torch.int32 and tuple(limbs.shape) == (d, 4)
    assert int(limbs.min()) >= 0 and int(limbs.max()) <= 0xFFFF
    assert _value(limbs.numpy()) == _host_fold(seeds, d, modulus)
    assert rej.tolist() == [0] * 1100


@pytest.mark.parametrize("modulus,d", [(P63, 264), (P55, 261)], ids=["e63", "e55_ragged"])
def test_recombine_of_the_fold_limbs_equals_the_host_widen(modulus, d):
    """The fused route's recombine (``recombine_i64``, on the limbs' own
    device) against the host widen-shift-or it replaced, on B5's plain
    limbs; ``decode_i64`` on the same limbs still gives the reference's."""
    ctx = LimbContext.create(modulus)
    limbs, _ = ck.fold_masks_device(_seeds(600, seed=15), d, modulus, device="cpu")
    limbs = torch.cat([limbs, ctx.encode_i64([0, 1, modulus - 1]).to(torch.int32)])
    got = ctx.recombine_i64(limbs)
    assert got.dtype == torch.int64 and got.device == limbs.device
    assert tuple(got.shape) == (d + 3,)
    widened = _value(limbs.numpy())
    assert got.tolist() == widened and widened[-3:] == [0, 1, modulus - 1]
    decoded = ctx.decode_i64(limbs)
    assert decoded.dtype == np.int64
    assert decoded.tolist() == widened == RefLimbContext.create(modulus).decode_i64(
        limbs.numpy()).tolist()


@pytest.mark.parametrize("e", [49, 55, 61, 63])
def test_fold_finalize_at_the_extremes(e):
    p = find_special_prime_field(e, 8, 9)[0]
    rng = np.random.default_rng(e)
    top = 16384 * 0xFFFF
    sums = np.stack([
        np.zeros(4, dtype=np.int64),
        np.full(4, top, dtype=np.int64),
        np.array([top, 0, top, 0], dtype=np.int64),
        np.array([0, 0, 0, top], dtype=np.int64),
        *rng.integers(0, top + 1, size=(12, 4), dtype=np.int64),
    ])
    got = _value(ck._fold_finalize(torch.from_numpy(sums), p).numpy())
    want = [sum(int(s) << (16 * j) for j, s in enumerate(row)) % p for row in sums]
    assert got == want


def test_fold_rejection_count_in_range_only():
    """The fold counts zone hits of draws below the dimension, per seed,
    as the expansion does (checked at a modulus the fold cannot take, on
    its plain version)."""
    seeds = _seeds(7, seed=7)
    keys = ck._key_tensor(seeds, torch.device("cpu"))
    d = 21  # ragged: the last counter has 5 of its 8 draws in range
    zone_hi, zone_lo = ck._zone(P62)
    with mock.patch.object(ck, "_fold_finalize", lambda sums, modulus: sums):
        _, rej = ck._fold_plain(keys, d, P62)
    _, counts = ck.expand_masks_device(seeds, d, P62, device="cpu")
    assert rej.tolist() == counts.tolist() and counts.sum() > 0
    assert (zone_hi << 32 | zone_lo) == U64_MAX - U64_MAX % P62


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda: ck.fold_masks_device([chacha.new_seed(128)], 8, FORCED, device="cpu"),
         "pseudo-Mersenne"),
        (lambda: ck.fold_masks_device([chacha.new_seed(128)], 8, (1 << 64) - 59, device="cpu"),
         "pseudo-Mersenne"),
        (lambda: ck.fold_masks_device([[0] * 4] * 16385, 8, P63, device="cpu"), "16384 seeds"),
        (lambda: ck.fold_masks_device([[0] * 4], 8, 1 << 40, device="cpu"), "pseudo-Mersenne"),
    ],
    ids=["not_pseudo_mersenne", "e64", "seed_cap", "even"],
)
def test_fold_guards_match_reference(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ---------------------------------------------------------------- combine


def test_combine_matches_reference():
    seeds = _seeds(7, seed=8)
    want, want_bad = ref_ck.combine_masks_device(seeds, 64, 433, rows=1, interpret=True)
    got, bad = ck.combine_masks_device(seeds, 64, 433, device="cpu")
    assert bad == want_bad == []
    assert [int(x) for x in got] == [int(x) for x in want] == _host_fold(seeds, 64, 433)
    assert got.dtype == np.int64


def test_combine_seed_chunk_streaming_matches_one_pass():
    seeds = _seeds(11, seed=9)
    modulus = (1 << 61) - 1
    one, bad1 = ck.combine_masks_device(seeds, 96, modulus, seed_chunk=len(seeds), device="cpu")
    chunked, bad2 = ck.combine_masks_device(seeds, 96, modulus, seed_chunk=4, device="cpu")
    assert bad1 == bad2 == []
    assert [int(x) for x in one] == [int(x) for x in chunked] == _host_fold(seeds, 96, modulus)


def test_combine_forced_rejection_fixup_is_exact():
    seeds = _seeds(6, seed=10)
    _, bad = ck.combine_masks_device(seeds, 48, FORCED, fixup_host=False, device="cpu")
    assert bad, "the modulus was supposed to force gen_range rejections"
    got, bad2 = ck.combine_masks_device(seeds, 48, FORCED, device="cpu")
    assert bad2 == bad
    assert [int(x) for x in got] == _host_fold(seeds, 48, FORCED)


def test_fused_dispatch_skipped_on_cpu():
    """A CPU device never takes the fused route, whatever the seed count."""
    seeds = _seeds(520, seed=11)
    with mock.patch.object(ck, "fold_masks_device",
                           side_effect=AssertionError("fused route must not run on cpu")):
        out, bad = ck.combine_masks_device(seeds, 16, P63, device="cpu")
    assert bad == [] and [int(x) for x in out] == _host_fold(seeds, 16, P63)


def _cuda_by_default(device=None):
    """``resolve_device`` on a machine that has a card (none is touched)."""
    return torch.device("cuda" if device is None else device)


def _fold_on_cpu(calls):
    real = ck.fold_masks_device

    def fold(seed_words, dimension, modulus, device=None):
        assert torch.device(device).type == "cuda"
        calls.append(len(seed_words))
        return real(seed_words, dimension, modulus, device="cpu")

    return fold


def test_fused_dispatch_on_a_cuda_device_groups_by_16384():
    """On a CUDA device S >= 512 at a pseudo-Mersenne modulus takes the
    fused route in groups of 16384 seeds (the fold itself runs its plain
    version here)."""
    seeds = _seeds(16_500, seed=12)
    calls = []
    before = ck.fold_recombine_device_launches
    with mock.patch.object(ck, "resolve_device", _cuda_by_default), \
            mock.patch.object(ck, "fold_masks_device", _fold_on_cpu(calls)):
        out, bad = ck.combine_masks_device(seeds, 8, P63)
    assert calls == [16384, 116]
    assert ck.fold_recombine_device_launches - before == 2
    assert out.dtype == np.int64 and bad == []
    assert out.tolist() == _host_fold(seeds, 8, P63)


def _traded(rows, modulus):
    """Other canonical masks in place of ``rows``: ``3 v + 7 mod p``."""
    return np.array([[(int(v) * 3 + 7) % modulus for v in row] for row in rows], dtype=object)


def test_fused_route_fixup_is_exact():
    """The fused route's per-bad-seed host fix-up: the fold reports zone
    hits for three seeds (a pseudo-Mersenne p never hits at this size), and
    their exact expansion is replaced by other canonical masks, so the
    result must trade exactly those seeds' rows, across 2^63."""
    seeds = _seeds(512, seed=14)
    d, bad_seeds = 16, [3, 200, 511]
    real_fold, real_expand = ck.fold_masks_device, chacha.expand_masks

    def fold(seed_words, dimension, modulus, device=None):
        limbs, rej = real_fold(seed_words, dimension, modulus, device="cpu")
        rej[bad_seeds] = [1, 2, 1]
        return limbs, rej

    with mock.patch.object(ck, "resolve_device", _cuda_by_default), \
            mock.patch.object(ck, "fold_masks_device", fold), \
            mock.patch.object(chacha, "expand_masks",
                              lambda s, dim, m: _traded(real_expand(s, dim, m), m)):
        out, bad = ck.combine_masks_device(seeds, d, P63)
    assert bad == bad_seeds
    rows = ref_chacha.expand_masks_noskip(seeds, d, P63)
    rows[bad_seeds] = _traded(rows[bad_seeds], P63).astype(np.int64)
    acc = np.zeros(d, dtype=np.int64)
    for row in rows:
        acc = ref_trunc_add_mod(acc, row, P63)
    assert [int(x) for x in out] == acc.tolist() != _host_fold(seeds, d, P63)


@pytest.mark.parametrize(
    "kwargs,n_seeds,modulus",
    [({"seed_chunk": 600}, 512, P63), ({}, 511, P63), ({}, 512, P62)],
    ids=["seed_chunk", "few_seeds", "not_pseudo_mersenne"],
)
def test_fused_dispatch_rule_on_a_cuda_device(kwargs, n_seeds, modulus):
    """Each condition of the rule keeps a CUDA device on the chunk route
    (checked with the chunk route's launches stubbed out)."""
    seeds = _seeds(n_seeds, seed=13)
    with mock.patch.object(ck, "resolve_device", _cuda_by_default), \
            mock.patch.object(ck, "fold_masks_device",
                              side_effect=AssertionError("fused route taken")), \
            mock.patch.object(ck, "chacha_keystream",
                              lambda seeds, nb, device=None: ck._keystream_plain(
                                  ck._key_tensor(seeds, torch.device("cpu")), nb)):
        out, bad = ck.combine_masks_device(seeds, 8, modulus, **kwargs)
    assert [int(x) for x in out] == _host_fold(seeds, 8, modulus)


@pytest.mark.parametrize("route", ["fused", "fused_rejected", "chunk", "chunk_forced", "empty"])
def test_combine_returns_int64_on_every_route(route):
    """Below a modulus of 2^63 every route returns numpy int64 ``[d]``, equal
    to the host fold: the fused route (a card faked, the fold's plain
    version), and again with every seed counted rejected under a lowered
    zone and its exact mask traded for another, so the fix-up's sums cross
    2^63; the chunk route, and again at 2^62 + 1, whose draws are rejected;
    no seeds."""
    d, modulus, n = {"fused": (16, P63, 512), "fused_rejected": (16, P63, 512),
                     "chunk": (16, P63, 6), "chunk_forced": (48, FORCED, 6),
                     "empty": (16, P63, 0)}[route]
    seeds = _seeds(n, seed=15)
    want = _host_fold(seeds, d, modulus)
    calls = []
    with ExitStack() as stack:
        if route.startswith("fused"):
            stack.enter_context(mock.patch.object(ck, "resolve_device", _cuda_by_default))
            stack.enter_context(mock.patch.object(ck, "fold_masks_device", _fold_on_cpu(calls)))
        if route == "fused_rejected":
            real_expand = chacha.expand_masks
            stack.enter_context(mock.patch.object(ck, "_zone", lambda m: (0x40000000, 0)))
            stack.enter_context(mock.patch.object(
                chacha, "expand_masks", lambda s, dim, m: _traded(real_expand(s, dim, m), m)))
            traded = _traded(ref_chacha.expand_masks(seeds, d, modulus), modulus)
            want = [sum(int(v) for v in col) % modulus for col in traded.T]
            assert want != _host_fold(seeds, d, modulus)
        out, bad = ck.combine_masks_device(seeds, d, modulus,
                                           device=None if route.startswith("fused") else "cpu")
    assert isinstance(out, np.ndarray) and out.dtype == np.int64 and out.shape == (d,)
    assert out.tolist() == want
    assert calls == ([n] if route.startswith("fused") else [])
    assert bad == (list(range(n)) if route in ("fused_rejected", "chunk_forced") else [])
