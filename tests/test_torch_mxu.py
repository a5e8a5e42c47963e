"""sda_tpu_torch.ops.mxu / ops.mxu_kernel and the engine's gen-3 entry
points against sda_tpu (interpret mode on CPU).

Caller-randomness mode (k + r slots) is held to the JAX reference by exact
limb equality: the 7-bit int8 modmat, the fused kernel's plain version
(combined, out7, fused reconstruction, reconstruct-only) and the engine's
kernel and streaming entry points. PRNG mode cannot match the TPU's
generator: it is held to the reveal identity, and — because any
randomness error of the form R*u cancels at reconstruction — to a replay of
the combined output with python ints from the documented Philox mapping.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.engine import TpuAggregationEngine
from sda_tpu.fields import find_prime_field
from sda_tpu.models import FederatedAggregation as RefModel
from sda_tpu.ops import mxu as ref_mxu
from sda_tpu.ops import mxu_kernel as ref_mk
from sda_tpu.ops.limbs import LimbContext as RefLimbs
from sda_tpu.sharing import AdditiveScheme, PackedShamirScheme
from sda_tpu_torch.engine import TorchAggregationEngine, limbs_from_numpy, spec_from_numpy
from sda_tpu_torch.ops import mxu as t_mxu
from sda_tpu_torch.ops import mxu_kernel as t_mk
from sda_tpu_torch.ops.limbs import LimbContext

M32 = 0xFFFFFFFF


def _port(ref: TpuAggregationEngine, dim: int) -> TorchAggregationEngine:
    s = ref.spec
    spec = spec_from_numpy(s.modulus, s.secret_count, s.share_count, s.randomness_count,
                           s.share_matrix, s.reconstruct_matrix)
    return TorchAggregationEngine(spec, dim, device="cpu")


@functools.lru_cache(maxsize=None)
def _pair(name, dim=24):
    """(reference engine, port engine on the CPU) for one field / scheme."""
    if name == "p128":
        ref = RefModel.packed_128bit(dimension=dim).engine
    elif name == "additive61":
        ref = TpuAggregationEngine(
            AdditiveScheme(share_count=4, modulus=(1 << 61) - 1).device_spec(), dim)
    elif name == "p433":
        ref = TpuAggregationEngine(PackedShamirScheme(3, 8, 4, 433, 354, 150).device_spec(), dim)
    else:
        bits = int(name[1:])
        p, w2, w3 = find_prime_field(bits, 8, 9)
        ref = TpuAggregationEngine(PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), dim)
    return ref, _port(ref, dim)


def _ext(ref, P, seed):
    """(secrets, ext) host limb arrays from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    secrets = ref.encode_secrets(rng.integers(0, min(ref.ctx.p, 1 << 62), size=(P, ref.dimension)))
    return secrets, np.concatenate([secrets, ref.random_ext(P, rng=rng)], axis=2)


def _same(want, got):
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))


# ----------------------------------------------------------- ops/mxu.py


@pytest.mark.parametrize("bits", [10, 30, 62], ids=["p10", "p30", "p62"])
def test_mxu_modmat_matches_reference(bits):
    p, _, _ = find_prime_field(bits, 8, 9)
    rng = np.random.default_rng(bits)
    ref = ref_mxu.MxuContext.create(RefLimbs.create(p))
    got_mxu = t_mxu.MxuContext.create(LimbContext.create(p))
    assert (got_mxu.L7, got_mxu.chunk, got_mxu.raw_words) == (ref.L7, ref.chunk, ref.raw_words)
    m, n, B = 7, 8, 64
    M = np.array([[int(rng.integers(0, p)) for _ in range(n)] for _ in range(m)], dtype=object)
    x = np.array([[int(rng.integers(0, p)) for _ in range(m)] for _ in range(B)], dtype=object)
    big = ref.matrix_int8(M, [ref.L7] * m)
    assert np.array_equal(got_mxu.matrix_int8(M, [ref.L7] * m), big)
    x7 = ref_mxu.limbs7_host(x, ref.L7).reshape(B, m * ref.L7)
    assert np.array_equal(t_mxu.limbs7_host(x, ref.L7).reshape(B, -1), x7)
    cols = ref.out_cols([ref.L7] * m)
    want = ref_mxu.mxu_modmat(ref, jnp.asarray(x7), big, n, cols)
    got = t_mxu.mxu_modmat(got_mxu, torch.from_numpy(x7), big, n, cols)
    _same(want, got)
    assert [int(v) for v in got_mxu.ctx.decode(got)[0]] == [
        sum(int(x[0][j]) * int(M[j][i]) for j in range(m)) % p for i in range(n)
    ]


def test_mxu_modmat_raw_randomness_slots():
    """Double-width (non-canonical) slots reduce to the exact residue, as in
    the reference."""
    p, _, _ = find_prime_field(62, 8, 9)
    mxu = t_mxu.MxuContext.create(LimbContext.create(p))
    ref = ref_mxu.MxuContext.create(RefLimbs.create(p))
    r = random.Random(7)
    m, n, B = 4, 8, 32
    M = np.array([[r.randrange(p) for _ in range(n)] for _ in range(m)], dtype=object)
    xraw = np.array([[r.randrange(1 << (14 * mxu.L7)) for _ in range(m)] for _ in range(B)],
                    dtype=object)
    x7 = t_mxu.limbs7_host(xraw, 2 * mxu.L7).reshape(B, m * 2 * mxu.L7)
    big = mxu.matrix_int8(M, [2 * mxu.L7] * m)
    cols = mxu.out_cols([2 * mxu.L7] * m)
    got = t_mxu.mxu_modmat(mxu, torch.from_numpy(x7), big, n, cols)
    _same(ref_mxu.mxu_modmat(ref, jnp.asarray(x7), big, n, cols), got)
    expect = [[sum(int(xraw[b][j]) * int(M[j][i]) for j in range(m)) % p for i in range(n)]
              for b in range(B)]
    assert mxu.ctx.decode(got).tolist() == expect


@pytest.mark.parametrize("name", ["p10", "p62", "p126"])
def test_limb_reshapes_and_matrix_builders_match_reference(name):
    ref, eng = _pair(name)
    M, L7, n = ref.spec.share_matrix, ref.mxu.L7, 8
    n_pad = -(-(n * L7) // 32) * 32
    for got, want in [
        (t_mk._big_rows(eng.mxu, M, [0, 1, 2, 0, 1, 2], [L7] * 6, n_pad),
         ref_mk._big_rows(ref.mxu, M, [0, 1, 2, 0, 1, 2], [L7] * 6, n_pad)),
        (t_mk._big_rows(eng.mxu, M, [3, 4, 5, 6], [2 * L7] * 4, n_pad),
         ref_mk._big_rows(ref.mxu, M, [3, 4, 5, 6], [2 * L7] * 4, n_pad)),
        (t_mk._big_rows(eng.mxu, ref.spec.reconstruct_matrix, list(range(8)), [L7] * 8, 64,
                        limb_major=True),
         ref_mk._big_rows(ref.mxu, ref.spec.reconstruct_matrix, list(range(8)), [L7] * 8, 64,
                          limb_major=True)),
        (t_mk._big_rows_randsum(eng.mxu, M, 3, 4, n_pad, 2 * L7),
         ref_mk._big_rows_randsum(ref.mxu, M, 3, 4, n_pad, 2 * L7)),
        (t_mk._chunk_consts_u32(eng.mxu, 4), ref_mk._chunk_consts_u32(ref.mxu, 4)),
        (eng.mxu._chunk_consts(3), ref.mxu._chunk_consts(3)),
    ]:
        assert np.array_equal(got, want)
    _, ext = _ext(ref, 3, 4)
    want7 = ref_mk.planar7_from_batched(ref.mxu, jnp.asarray(ext), 16)
    _same(want7, eng.planar7_ext(limbs_from_numpy(ext), lanes=16))
    bits = np.random.default_rng(5).integers(0, 1 << 32, size=(6, ref.mxu.raw_words),
                                             dtype=np.uint64).astype(np.uint32)
    _same(ref.mxu.raw_limbs(jnp.asarray(bits)),
          eng.mxu.raw_limbs(torch.from_numpy(bits.astype(np.int64))))
    back = t_mk.batched_from_planar16(torch.arange(8 * 4 * 16).reshape(8, 4, 16), 10)
    _same(ref_mk.batched_from_planar16(jnp.arange(8 * 4 * 16).reshape(8, 4, 16), 10), back)


def test_share_mxu_matches_reference_and_cios():
    """Per-participant canonical shares (the protocol's bulk path)."""
    ref, eng = _pair("p62")
    _, ext = _ext(ref, 4, 6)
    got = eng.share_mxu(limbs_from_numpy(ext))
    _same(ref.share_mxu(jnp.asarray(ext)), got)
    assert torch.equal(got, eng.share(limbs_from_numpy(ext)))


def test_aggregate_mxu_paths_match_reference():
    """The plain-product route: the caller-randomness aggregate is bit-equal
    to the reference's; with raw randomness from a generator (PRNG) every
    variant reveals the participant sum."""
    ref, eng = _pair("p62")
    secrets, ext = _ext(ref, 5, 7)
    _same(ref.aggregate_mxu_ext(jnp.asarray(ext)), eng.aggregate_mxu_ext(limbs_from_numpy(ext)))
    sec = limbs_from_numpy(secrets)
    want = eng.ctx.sum_mod(sec, axis=0)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(eng.aggregate_mxu(sec, gen), want)
    assert torch.equal(eng.aggregate_mxu_streaming([sec[:2], lambda i: sec[2:]], gen), want)
    comb = [eng.mxu_combined_from_key(sec, torch.Generator().manual_seed(s)) for s in (1, 2)]
    assert not torch.equal(comb[0], comb[1])  # the randomness is really drawn


# ---------------------------------------------------- ops/mxu_kernel.py


@pytest.mark.parametrize("mode", ["combined", "out7", "reconstructed"])
def test_fused_ext_matches_reference(mode):
    """Caller randomness (k + r slots): plain version == interpret-mode
    Pallas kernel, limb for limb."""
    ref, eng = _pair("p62")
    P = 4
    _, ext = _ext(ref, P, 8)
    kw_ref = {"out7": mode == "out7"}
    kw = dict(kw_ref)
    if mode == "reconstructed":
        kw_ref["reconstruct_matrix"] = ref.spec.reconstruct_matrix
        kw["reconstruct_matrix"] = eng.spec.reconstruct_matrix
    want = ref_mk.fused_share_combine_mxu(
        ref.mxu, ref.spec.share_matrix, ref.planar7_ext(jnp.asarray(ext), lanes=128), P, 3, 4,
        lanes=128, interpret=True, **kw_ref,
    )
    got = t_mk.fused_share_combine_mxu(
        eng.mxu, eng.spec.share_matrix, eng.planar7_ext(limbs_from_numpy(ext), lanes=128),
        P, 3, 4, lanes=128, **kw,
    )
    assert got.dtype == (torch.int8 if mode == "out7" else torch.int32)
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    _same(want, got)


def test_reconstruct_only_matches_reference():
    """The reconstruct call (p_count=1, slots=n, no randomness)."""
    ref, eng = _pair("p62")
    rng = np.random.default_rng(9)
    combined = ref.ctx.encode(np.array(
        [[int(rng.integers(0, 1 << 62)) for _ in range(8)] for _ in range(ref.nb)], dtype=object))
    c7_ref = ref_mk.planar7_from_batched(ref.mxu, jnp.asarray(combined)[None], lanes=128)
    want = ref_mk.fused_share_combine_mxu(ref.mxu, ref.spec.reconstruct_matrix, c7_ref, 1, 8, 0,
                                          lanes=128, interpret=True)
    c7 = t_mk.planar7_from_batched(eng.mxu, limbs_from_numpy(combined)[None], lanes=128)
    got = t_mk.fused_share_combine_mxu(eng.mxu, eng.spec.reconstruct_matrix, c7, 1, 8, 0,
                                       lanes=128)
    _same(want, got)
    assert torch.equal(t_mk.batched_from_planar16(got, eng.nb).to(torch.int64),
                       eng.reconstruct(limbs_from_numpy(combined)))


@pytest.mark.parametrize("name", ["p128", "additive61", "p433"])
def test_aggregate_mxu_kernel_ext_other_fields(name):
    """The 128-bit field (L7 = 18, L16 = 8), the additive scheme mod 2^61 - 1
    and p433 through aggregate_mxu_kernel, bit-equal to the reference."""
    ref, eng = _pair(name)
    P = 3
    secrets, ext = _ext(ref, P, 10)
    want = ref.aggregate_mxu_kernel(ref.planar7_ext(jnp.asarray(ext), lanes=128), seed=0,
                                    p_count=P, lanes=128)
    got = eng.aggregate_mxu_kernel(eng.planar7_ext(limbs_from_numpy(ext), lanes=128), 0, P,
                                   lanes=128)
    _same(want, got)
    assert torch.equal(got.to(torch.int64), eng.ctx.sum_mod(limbs_from_numpy(secrets), axis=0))


def test_aggregate_mxu_kernel_and_streaming_match_reference():
    """aggregate_mxu_kernel and aggregate_mxu_kernel_streaming with
    planar7_ext chunks: bit-equal to the reference's outputs."""
    ref, eng = _pair("p62", 30)
    p_chunk, n_chunks = 3, 3
    secrets, ext = _ext(ref, p_chunk * n_chunks, 11)
    ref_chunks = [ref.planar7_ext(jnp.asarray(ext[i * p_chunk : (i + 1) * p_chunk]), lanes=128)
                  for i in range(n_chunks)]
    chunks = [eng.planar7_ext(limbs_from_numpy(ext[i * p_chunk : (i + 1) * p_chunk]), lanes=128)
              for i in range(n_chunks)]
    want = ref.aggregate_mxu_kernel_streaming(ref_chunks, p_chunk, seed0=0, lanes=128)
    got = eng.aggregate_mxu_kernel_streaming([chunks[0], lambda i: chunks[i], chunks[2]],
                                             p_chunk, lanes=128)
    _same(want, got)
    whole = eng.aggregate_mxu_kernel(eng.planar7_ext(limbs_from_numpy(ext), lanes=128), 0,
                                     p_chunk * n_chunks, lanes=128)
    assert torch.equal(whole, got)
    assert torch.equal(got.to(torch.int64), eng.ctx.sum_mod(limbs_from_numpy(secrets), axis=0))


@pytest.mark.parametrize("P,mode", [(6, "sum"), (131, "grouped")])
def test_prng_mode_reveals_participant_sum(P, mode):
    """In-kernel randomness cancels at reconstruction: P = 6 takes the
    rand-sum mode, P = 131 (groups 2, odd) the grouped mode."""
    _, eng = _pair("p62")
    rng = np.random.default_rng(12)
    secrets = eng.encode_secrets(rng.integers(0, 1 << 62, size=(P, eng.dimension)))
    sec7 = eng.planar7_secrets(secrets, lanes=16)
    assert eng._plan7("share", sec7.shape[0], P, sec7.device).rand_mode == mode
    want = eng.ctx.sum_mod(secrets, axis=0)
    assert torch.equal(eng.aggregate_mxu_kernel(sec7, 99, P, lanes=16).to(torch.int64), want)
    half = P // 2
    chunks = [eng.planar7_secrets(secrets[:half], lanes=16),
              eng.planar7_secrets(secrets[half : 2 * half], lanes=16)]
    streamed = eng.aggregate_mxu_kernel_streaming(chunks, half, seed0=5, lanes=16)
    assert torch.equal(streamed.to(torch.int64), eng.ctx.sum_mod(secrets[: 2 * half], axis=0))
    comb = [eng.mxu_kernel_combined(sec7, s, P, lanes=16) for s in (1, 2)]
    assert not torch.equal(comb[0], comb[1])  # the randomness is really drawn


def _philox_by_definition(ctr, key):
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
    return c


def test_prng_counter_mapping_known_answer():
    """B6's mapping: word w of (lane, participant) is output word w % 4 of
    Philox4x32-10 at counter (lane, participant, w // 4, 6), key (seed, 0)."""
    _, eng = _pair("p62")
    plan = t_mk.mxu_plan(eng.mxu, eng.spec.share_matrix, 4 * 3 * eng.mxu.L7, 4, 3, 4)
    assert plan.words_per_p == 18
    words = t_mk._participant_words(plan, 12345, torch.tensor([4, 5]), 2, 4)  # [2, 18, 2]
    assert [int(w) for w in words[1, 4:8, 1]] == [0xC05CE37C, 0x14488B50, 0x7DD4D99F, 0xBC7F76B2]
    for part in (2, 3):
        for lane in (4, 5):
            want = []
            for g in range(5):
                want += _philox_by_definition((lane, part, g, 6), (12345, 0))
            assert [int(w) for w in words[part - 2, :, lane - 4]] == want[:18]


def _decode_planar(ctx, out):
    """``[n, L, NBP]`` limbs -> python ints ``[n][NBP]``."""
    return ctx.decode(out.permute(0, 2, 1)).tolist()


@pytest.mark.parametrize("P", [6, 131], ids=["randsum", "grouped"])
@pytest.mark.parametrize("bits", [10, 62, 126], ids=["p10", "p62", "p126"])
def test_randomness_replay_exact(bits, P):
    """B6's combined output (no reconstruction) in PRNG mode equals
    sum_p (secrets_p . M + raw_p . M_rand) mod p, with raw_p rebuilt in
    python ints from the Philox words under the documented mapping: raw limb
    i of participant p is (word[i // 4] >> 7 * (i % 4)) & 127. A reveal
    cannot see a randomness error; this replay can."""
    _, eng = _pair(f"p{bits}")
    spec, mxu, ctx = eng.spec, eng.mxu, eng.ctx
    k, r, n, L7, p = spec.secret_count, spec.randomness_count, spec.share_count, mxu.L7, ctx.p
    rng = random.Random(bits + P)
    vals = [[[rng.randrange(p) for _ in range(k)] for _ in range(eng.nb)] for _ in range(P)]
    secrets = ctx.encode(np.array(vals, dtype=object))
    sec7 = eng.planar7_secrets(secrets, lanes=8)
    seed = 4242
    plan = eng._plan7("combine", sec7.shape[0], P, sec7.device)
    assert plan.rand_mode == ("sum" if P == 6 else "grouped")
    got = _decode_planar(ctx, eng.mxu_kernel_combined(sec7, seed, P, lanes=8))
    nbp = sec7.shape[1]
    words = t_mk._participant_words(plan, seed, torch.arange(nbp), 0, P).tolist()  # [P][wpp][NBP]
    M = [[int(v) for v in row] for row in spec.share_matrix]
    r2l = 2 * L7
    for b in range(nbp):
        # every participant's ext row at lane b: k secrets, r raw randomness values
        ext = []
        for q in range(P):
            row = list(vals[q][b]) if b < eng.nb else [0] * k
            for s in range(r):
                v = 0
                for l1 in range(r2l):
                    idx = s * r2l + l1
                    v |= ((words[q][idx // 4][b] >> (7 * (idx % 4))) & 127) << (7 * l1)
                row.append(v)
            ext.append(row)
        for i in range(n):
            want = sum(row[j] * M[j][i] for row in ext for j in range(k + r)) % p
            assert got[i][b] == want, f"lane {b} clerk {i}"


def test_guards_match_reference():
    ref, eng = _pair("p62")
    M, L7 = eng.spec.share_matrix, eng.mxu.L7
    ok = torch.zeros((2 * 3 * L7, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of lanes"):
        t_mk.fused_share_combine_mxu(eng.mxu, M, ok, 2, 3, 4, lanes=256)
    with pytest.raises(ValueError, match="neither k nor k\\+r"):
        t_mk.fused_share_combine_mxu(eng.mxu, M, ok[:-1], 2, 3, 4, lanes=128)
    with pytest.raises(ValueError, match="int32 accumulator bound"):
        big = torch.zeros((5000 * 3 * L7, 8), dtype=torch.int8)
        t_mk.fused_share_combine_mxu(eng.mxu, M, big, 5000, 3, 4, lanes=8)
    with pytest.raises(ValueError, match="exclusive"):
        t_mk.fused_share_combine_mxu(eng.mxu, M, ok, 2, 3, 4, lanes=128, out7=True,
                                     reconstruct_matrix=eng.spec.reconstruct_matrix)
    with pytest.raises(ValueError, match="rows must equal share count"):
        t_mk.fused_share_combine_mxu(eng.mxu, M, ok, 2, 3, 4, lanes=128,
                                     reconstruct_matrix=eng.spec.reconstruct_matrix[:4])
    with pytest.raises(ValueError, match="n_pad too small"):
        t_mk._big_rows(eng.mxu, M, [0], [L7], 32)
    with pytest.raises(ValueError, match="accumulator bound"):
        t_mxu.mxu_modmat(eng.mxu, torch.zeros((1, 140000), dtype=torch.int8),
                         np.zeros((140000, 8), dtype=np.int8), 1, 8)
    with pytest.raises(ValueError, match="too small"):
        t_mxu.MxuContext.create(LimbContext.create(127))
    # the reference raises on the same inputs
    with pytest.raises(ValueError, match="int32 accumulator bound"):
        ref_mk.fused_share_combine_mxu(ref.mxu, ref.spec.share_matrix,
                                       jnp.zeros((5000 * 3 * L7, 8), jnp.int8), 5000, 3, 4,
                                       lanes=8, interpret=True)
    # a tensor on neither the CPU nor the card takes no route at all
    plan = t_mk.mxu_plan(eng.mxu, M, ok.shape[0], 2, 3, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        t_mk.run_mxu(plan, torch.empty(ok.shape, dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("dim,lanes,P", [(300, 100, 2), (303, 101, 2), (24, 128, 1)],
                         ids=["nbp100", "nbp101", "k_below_one_tile"])
def test_fused_ext_ring_edges_match_reference(dim, lanes, P):
    """The shapes at the edges of the CUDA kernel's K ring, in caller-
    randomness mode with fused reconstruction: NBP 100 and 101 (the 4-byte
    and byte copies of the operand; one grid step of NBP lanes here) and
    K = 63 rows, below one 64-row tile (P = 1). The plain version equals the
    interpret-mode Pallas kernel limb for limb; the lane tiling does not
    change the function."""
    ref, eng = _pair("p62", dim)
    _, ext = _ext(ref, P, 16)
    sec_ref = ref.planar7_ext(jnp.asarray(ext), lanes=lanes)
    sec = eng.planar7_ext(limbs_from_numpy(ext), lanes=lanes)
    assert tuple(sec.shape) == tuple(sec_ref.shape) == (P * 7 * eng.mxu.L7, -(-eng.nb // lanes) * lanes)
    want = ref_mk.fused_share_combine_mxu(
        ref.mxu, ref.spec.share_matrix, sec_ref, P, 3, 4, lanes=lanes, interpret=True,
        reconstruct_matrix=ref.spec.reconstruct_matrix,
    )
    got = t_mk.fused_share_combine_mxu(eng.mxu, eng.spec.share_matrix, sec, P, 3, 4, lanes=lanes,
                                       reconstruct_matrix=eng.spec.reconstruct_matrix)
    _same(want, got)


def test_kernel_params_follow_the_kernels_field_order():
    """The int32 array the launcher passes is csrc/mxu7.cu's Params field by
    field: as many entries as kNParams, each at the index the kernel's
    parser reads it from, the seed as its 32-bit pattern."""
    import re
    from pathlib import Path

    src = (Path(t_mk.__file__).parent / "csrc" / "mxu7.cu").read_text()
    n_params = int(re.search(r"constexpr int kNParams = (\d+);", src).group(1))
    fields = {name: int(i) for name, i in re.findall(r"p\.(\w+) = (?:\(uint32_t\))?v\[(\d+)\];", src)}
    assert sorted(fields.values()) == list(range(n_params))
    _, eng = _pair("p62")
    mxu, spec = eng.mxu, eng.spec
    rows = 131 * 3 * mxu.L7
    plan = t_mk.mxu_plan(mxu, spec.share_matrix, rows, 131, 3, 4,
                         reconstruct_matrix=spec.reconstruct_matrix)
    assert plan.rand_mode == "grouped"
    v = t_mk._kernel_params(plan, 4096, -1)
    assert v.dtype == np.int32 and len(v) == n_params
    want = {"K": rows, "lda": plan.bigs.shape[1], "nbp": 4096, "n_pad": plan.n_pad, "n": 8,
            "L7": mxu.L7, "L": eng.ctx.L, "chunk": mxu.chunk, "n_consts": plan.n_consts,
            "n2": 3, "out7": 0, "mode": 2, "P": 131, "wpp": plan.words_per_p, "RL": plan.RL,
            "gsize": 0, "pb": plan.pb, "n_blocks": plan.n_blocks, "kb": plan.kb,
            "bigr_cols": plan.bigr.shape[1], "off_consts": 0, "off_p": plan.n_consts * eng.ctx.L}
    assert {k: int(v[fields[k]]) for k in want} == want
    assert int(np.uint32(v[fields["seed"]])) == 0xFFFFFFFF
    assert t_mk.kernel_mt(plan) == 5  # 8 clerks x 9 limbs: 72 accumulator rows


def test_philox_call_ops_read_the_mode_s_generator_loop(monkeypatch):
    """chip_smoke's Philox issue term for B6 counts the body of the one
    innermost generator loop of the plan's randomness mode: without a
    shared-memory store in rand-sum mode, with one in grouped mode; a
    listing with two rand-sum loops is refused."""
    from types import SimpleNamespace

    import chip_smoke
    from sda_tpu_torch.ops import sass

    mul = " R4, R2, -0x2daee0ad, RZ"
    instrs = [
        (0x00, "MOV", " R1, R2"),
        (0x10, "IMMA.16832.S8.S8", " R8, R12, R16, R8"),  # K loop 0x10-0x30
        (0x20, "BAR.SYNC.DEFER_BLOCKING", " 0x0"),
        (0x30, "BRA", " 0x10"),
        (0x40, "IMAD.WIDE.U32", mul),  # rand-sum loop 0x40-0x80
        (0x50, "LOP3.LUT", " R5, R4, R3, RZ, 0x96, !PT"),
        (0x60, "IMAD.IADD", " R6, R5, 0x1, R6"),
        (0x70, "ISETP.GE.AND", " P0, PT, R6, R9, PT"),
        (0x80, "BRA", " 0x40"),
        (0x90, "STS", " [R10], R6"),  # outside the loop: the exchange store
        (0xa0, "IMAD.WIDE.U32", mul),  # grouped loop 0xa0-0xe0
        (0xb0, "LOP3.LUT", " R5, R4, R3, RZ, 0x96, !PT"),
        (0xc0, "STS.U8", " [R11], R5"),
        (0xd0, "ISETP.GE.AND", " P1, PT, R7, R9, PT"),
        (0xe0, "BRA", " 0xa0"),
    ]
    monkeypatch.setattr(sass, "sass_listing", lambda *a: {"MT5": instrs})

    def plan(mode):
        return SimpleNamespace(rand_mode=mode, n=8, mxu=SimpleNamespace(L7=9))

    assert chip_smoke._philox_call_ops(plan("sum")) == 5
    assert chip_smoke._philox_call_ops(plan("grouped")) == 5
    assert chip_smoke._philox_call_ops(plan("none")) == 0
    twice = instrs + [(0xf0, "IMAD.WIDE.U32", mul), (0x100, "BRA", " 0xf0")]
    monkeypatch.setattr(sass, "sass_listing", lambda *a: {"MT5": twice})
    with pytest.raises(AssertionError, match="found 2 sum-mode Philox loops"):
        chip_smoke._philox_call_ops(plan("sum"))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (1000, 64, 136), (333334, 64, 136), (1024, 63, 130)])
def test_int_mm_operands_pad_rows_to_32(m, k, n):
    """The card's int8 matmul pads its operands to more than 16 rows in a
    multiple of 32 and K, N to multiples of 8: cuBLASLt refused 1,000 and
    333,336 rows (the participant's share_mxu at 1,000,002 dimensions) on
    the H100. The zero padding leaves the product as it is."""
    mp, kp, np_ = t_mxu._int_mm_shape(m, k, n)
    assert mp >= max(m, 32) and mp % 32 == 0 and mp - m < 32
    assert kp >= k and kp % 8 == 0 and kp - k < 8 and np_ >= n and np_ % 8 == 0 and np_ - n < 8
    rng = np.random.default_rng(m)
    a = torch.as_tensor(rng.integers(-128, 128, size=(min(m, 40), k), dtype=np.int8))
    b = torch.as_tensor(rng.integers(-128, 128, size=(k, n), dtype=np.int8))
    pad_a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - a.shape[0]))
    pad_b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    want = a.to(torch.int64) @ b.to(torch.int64)
    assert torch.equal(t_mxu._int8_matmul(pad_a, pad_b)[: a.shape[0], :n], want)
