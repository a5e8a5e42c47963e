"""sda_tpu_torch.ops.pallas_kernels and the engine's gen-1 entry points
against sda_tpu (interpret mode on CPU).

The fused planar CIOS function's plain version (what a CPU tensor runs) is
held to the JAX reference by exact limb equality with the caller's
randomness; PRNG mode is held to the reveal identity and to a python-int
replay of its combined output from the documented Philox mapping.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.engine import TpuAggregationEngine
from sda_tpu.fields import find_prime_field
from sda_tpu.ops import pallas_kernels as ref_pk
from sda_tpu.sharing import AdditiveScheme, PackedShamirScheme
from sda_tpu_torch.engine import TorchAggregationEngine, limbs_from_numpy, spec_from_numpy
from sda_tpu_torch.ops import pallas_kernels as t_pk
from sda_tpu_torch.ops.mxu8 import philox4x32_10

REF = dict(secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
           omega_secrets=354, omega_shares=150)
SCHEMES = {
    "packed433": lambda: PackedShamirScheme(**REF),
    "additive61": lambda: AdditiveScheme(share_count=4, modulus=(1 << 61) - 1),
    "p62": lambda: PackedShamirScheme(3, 8, 4, *find_prime_field(62, 8, 9)),
    "p126": lambda: PackedShamirScheme(3, 8, 4, *find_prime_field(126, 8, 9)),
}


@functools.lru_cache(maxsize=None)
def _pair(name, dim=24):
    """(reference engine, port engine on the CPU) for one scheme."""
    ref = TpuAggregationEngine(SCHEMES[name]().device_spec(), dim)
    s = ref.spec
    spec = spec_from_numpy(s.modulus, s.secret_count, s.share_count, s.randomness_count,
                           s.share_matrix, s.reconstruct_matrix)
    return ref, TorchAggregationEngine(spec, dim, device="cpu")


def _ext(ref, P, seed):
    rng = np.random.default_rng(seed)
    secrets = ref.encode_secrets(
        rng.integers(0, min(ref.spec.modulus, 1 << 31), size=(P, ref.dimension)))
    return secrets, np.concatenate([secrets, ref.random_ext(P, rng=rng)], axis=2)


def _expected(ref, secrets):
    """The revealed sum the reference decodes, as limbs ``[nb, k, L]``."""
    return limbs_from_numpy(ref.ctx.sum_mod(jnp.asarray(secrets), axis=0))


@pytest.mark.parametrize("name", ["packed433", "additive61"])
def test_fused_ext_matches_reference(name):
    """Caller randomness: plain version == interpret-mode Pallas kernel,
    limb for limb, and the reveal is the participant sum."""
    ref, eng = _pair(name)
    P = 5
    secrets, ext = _ext(ref, P, 1)
    want = ref.aggregate_fused_ext(jnp.asarray(ext), rows=1, interpret=True)
    got = eng.aggregate_fused_ext(limbs_from_numpy(ext), rows=1)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert torch.equal(got, _expected(ref, secrets))


def test_planar_layouts_and_table_match_reference():
    ref, eng = _pair("p62")
    _, ext = _ext(ref, 3, 2)
    want = ref_pk.planar_from_batched(jnp.asarray(ext), rows=2)
    got = t_pk.planar_from_batched(limbs_from_numpy(ext), rows=2)
    assert got.dtype == torch.int32 and tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    y = np.arange(8 * 4 * 2 * 128).reshape(8, 4, 2, 128)
    assert np.array_equal(np.asarray(ref_pk.batched_from_planar(jnp.asarray(y), 200)),
                          t_pk.batched_from_planar(torch.from_numpy(y), 200).numpy())
    table = t_pk._scalar_table(eng.ctx, eng.share_mat, "cpu").numpy()
    m, n, L = eng.share_mat.shape
    assert np.array_equal(table[: m * n * L], np.asarray(ref.share_mat).reshape(-1))
    assert table[m * n * L : m * n * L + L].tolist() == list(ref.ctx.r2)
    assert table[(m + 1) * n * L] == 1 and table[-L:].tolist() == list(ref.ctx.p_limbs)


def test_fused_tile_padding():
    """NB not a multiple of the tile: the padding batches are inert."""
    ref, eng = _pair("packed433", 10)  # nb = 4
    secrets, ext = _ext(ref, 3, 3)
    got = eng.aggregate_fused_ext(limbs_from_numpy(ext), rows=1)
    golden = ref.aggregate(jnp.asarray(ext[..., :3, :]), jnp.asarray(ext[..., 3:, :]))
    assert np.array_equal(np.asarray(golden).astype(np.int64), got.numpy())
    expect = [int(sum(int(v) for v in col)) % 433
              for col in ref.ctx.decode(secrets).reshape(3, -1)[:, :10].T]
    assert [int(x) for x in eng.decode_output(got)] == expect


@pytest.mark.parametrize("name", ["packed433", "additive61"])
def test_streaming_matches_single_pass(name):
    """Chunked participant streaming equals the one-shot fused result, in
    both randomness modes."""
    ref, eng = _pair(name, 9)
    secrets, ext = _ext(ref, 6, 4)
    e = limbs_from_numpy(ext)
    one_shot = eng.aggregate_fused_ext(e, rows=1)
    streamed = eng.aggregate_fused_streaming([e[:2], lambda i: e[2:4], e[4:]], rows=1)
    assert torch.equal(one_shot, streamed)
    assert torch.equal(streamed, _expected(ref, secrets))
    s = limbs_from_numpy(secrets)
    prng = eng.aggregate_fused_streaming([s[:3], s[3:]], seed0=7, rows=1)
    assert torch.equal(prng, _expected(ref, secrets))


def test_fused_rejects_bad_shapes():
    ref, eng = _pair("packed433", 12)
    f = t_pk.fused_share_combine_planar
    for shape, rows, what in [((2, 7, 2, 1, 64), 1, "128 lanes"),
                              ((2, 5, 2, 1, 128), 1, "neither k nor k"),
                              ((2, 7, 2, 3, 128), 2, "multiple of rows")]:
        with pytest.raises(ValueError, match=what):
            f(eng.ctx, torch.zeros(shape, dtype=torch.int32), eng.share_mat, 4, rows=rows)
        if rows == 1:  # the reference raises on the same shapes
            with pytest.raises(ValueError):
                ref_pk.fused_share_combine_planar(ref.ctx, jnp.zeros(shape, jnp.uint32),
                                                  ref.share_mat, 4, interpret=True)
    with pytest.raises(ValueError, match="below 2\\^15"):
        f(eng.ctx, torch.zeros((4700, 3, 2, 1, 128), dtype=torch.int32), eng.share_mat, 4, rows=1)
    with pytest.raises(ValueError, match="unsupported device"):
        f(eng.ctx, torch.zeros((2, 7, 2, 1, 128), dtype=torch.int32, device="meta"),
          eng.share_mat, 4, rows=1)


@pytest.mark.parametrize("name", ["packed433", "additive61", "p62", "p126"])
def test_prng_mode_reveals_participant_sum(name):
    """In-kernel randomness cancels at reconstruction; the combined shares
    depend on the seed."""
    ref, eng = _pair(name)
    secrets, _ = _ext(ref, 4, 5)
    s = limbs_from_numpy(secrets)
    assert torch.equal(eng.aggregate_fused(s, seed=42, rows=1), _expected(ref, secrets))
    comb = [eng._fused_combined(s, seed, 1) for seed in (1, 2)]
    assert not torch.equal(comb[0], comb[1])


def test_prng_counter_mapping_known_answer():
    """B7's mapping: word w of (lane, participant) is output word w % 4 of
    Philox4x32-10 at counter (lane, participant, w // 4, 7), key (seed, 0)."""
    words = t_pk._rand_words(16, 12345, torch.tensor([4, 5]), 4)  # [P, 16, T]
    assert [int(w) for w in words[3, 4:8, 1]] == [0x47479654, 0xF72C180F, 0x0941ACE9, 0x8A2E8DED]
    got = philox4x32_10(tuple(torch.tensor(v) for v in (5, 3, 1, 7)), (12345, 0))
    assert [int(w) for w in got] == [int(w) for w in words[3, 4:8, 1]]


@pytest.mark.parametrize("name", ["packed433", "p62", "p126"])
def test_randomness_replay_exact(name):
    """The combined planar output in PRNG mode equals sum_p ext_p . M mod p,
    where randomness slot s of participant p at lane b is (x1 * R + x0) mod
    p, x1 and x0 the high and low 16-bit halves of its L Philox words (word
    s * L + l). A reveal cannot see a randomness error; this replay can."""
    _, eng = _pair(name)
    ctx, spec = eng.ctx, eng.spec
    k, r, n, L, p = spec.secret_count, spec.randomness_count, spec.share_count, ctx.L, ctx.p
    P, seed = 5, 2024
    rng = random.Random(P + L)
    vals = [[[rng.randrange(p) for _ in range(k)] for _ in range(eng.nb)] for _ in range(P)]
    secrets = ctx.encode(np.array(vals, dtype=object))
    planar = t_pk.planar_from_batched(secrets, rows=1)
    out = t_pk.fused_share_combine_planar(ctx, planar, eng.share_mat, r, seed=seed, rows=1)
    nbp = planar.shape[-2] * 128
    got = ctx.decode(out.reshape(n, L, nbp).permute(0, 2, 1)).tolist()  # [n][NBP]
    words = t_pk._rand_words(r * L, seed, torch.arange(nbp), P).tolist()  # [P][r*L][NBP]
    M = [[int(v) for v in row] for row in spec.share_matrix]
    R = 1 << (16 * L)
    for b in list(range(eng.nb)) + [nbp - 1]:  # the batches and a padding lane
        ext = []
        for q in range(P):
            row = list(vals[q][b]) if b < eng.nb else [0] * k
            for s in range(r):
                ws = [words[q][s * L + l][b] for l in range(L)]
                x1 = sum((w >> 16) << (16 * l) for l, w in enumerate(ws))
                x0 = sum((w & 0xFFFF) << (16 * l) for l, w in enumerate(ws))
                row.append((x1 * R + x0) % p)
            ext.append(row)
        for i in range(n):
            want = sum(row[j] * M[j][i] for row in ext for j in range(k + r)) % p
            assert got[i][b] == want, f"lane {b} clerk {i}"
