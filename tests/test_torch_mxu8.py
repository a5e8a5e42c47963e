"""sda_tpu_torch.ops.mxu8 against sda_tpu.ops.mxu8 (interpret mode on CPU).

The byte-limb fused function's plain version (what a CPU tensor runs) is
held to the JAX reference by exact limb equality in caller-randomness mode
(k + r slots), with and without fused reconstruction, at the four moduli of
tests/test_mxu8.py. PRNG mode cannot match the TPU's generator; it is held
to the reveal identity (reconstruction returns the participant sum) and its
Philox generator to published known-answer vectors.
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
from sda_tpu_torch.ops.limbs import LimbContext

ENGINES = ["p433", "p62", "p63special", "p127special"]


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


def _ext(ref, P, seed):
    rng = np.random.default_rng(seed)
    secrets = ref.encode_secrets(rng.integers(0, min(ref.ctx.p, 1 << 62), size=(P, ref.dimension)))
    return secrets, np.concatenate([secrets, ref.random_ext(P, rng=rng)], axis=2)


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("fold_k", [1, 2])
def test_context_matches_reference(name, fold_k):
    ref, eng = _pair(name)
    want = ref_m8.Mxu8Context.create(ref.ctx, rand_fold_k=fold_k)
    got = t_m8.Mxu8Context.create(eng.ctx, rand_fold_k=fold_k)
    assert (got.L8, got.chunk8, got.L16r, got.special, got.rand_words) == (
        want.L8, want.chunk8, want.L16r, want.special, want.rand_words
    )


@pytest.mark.parametrize("name", ENGINES)
def test_matrix_builders_match_reference(name):
    ref, eng = _pair(name)
    M = ref.spec.share_matrix
    k, r, n = 3, 4, 8
    L8 = ref.mxu8.L8
    n_pad = -(-(n * L8 + 1) // 32) * 32
    n_pad2 = -(-(k * L8 + 1) // 32) * 32
    for got, want in [
        (t_m8._big8_slots(eng.mxu8, M, [0, 1, 2, 0, 1, 2], n_pad),
         ref_m8._big8_slots(ref.mxu8, M, [0, 1, 2, 0, 1, 2], n_pad)),
        (t_m8._big8_slots(eng.mxu8, M, [0, 1, 2, 3], n_pad, limb_major=True),
         ref_m8._big8_slots(ref.mxu8, M, [0, 1, 2, 3], n_pad, limb_major=True)),
        (t_m8._big8_randsum(eng.mxu8, M, k, r, n_pad, r * eng.mxu8.rand_words, 3),
         ref_m8._big8_randsum(ref.mxu8, M, k, r, n_pad, r * ref.mxu8.rand_words, 3)),
        (t_m8._big8_stage2(eng.mxu8, ref.spec.reconstruct_matrix, n, k, 3, n_pad2),
         ref_m8._big8_stage2(ref.mxu8, ref.spec.reconstruct_matrix, n, k, 3, n_pad2)),
    ]:
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(t_m8._chunk_consts8(eng.mxu8, 3), ref_m8._chunk_consts8(ref.mxu8, 3))
    for bound in (1, 255, 65025 * 96, 65025 * 65793):
        assert t_m8._residual_limbs(bound) == ref_m8._residual_limbs(bound)
    vals = np.array([0, 1, ref.ctx.p - 1], dtype=object)
    assert np.array_equal(t_m8.limbs8_host(vals, L8), ref_m8.limbs8_host(vals, L8))


@pytest.mark.parametrize("name", ENGINES)
def test_planar8_matches_reference(name):
    ref, eng = _pair(name)
    _, ext = _ext(ref, 3, 0)
    want = ref_m8.planar8_from_batched(ref.mxu8, jnp.asarray(ext), 8)
    got = eng.planar8_ext(limbs_from_numpy(ext), lanes=8)
    assert got.dtype == torch.int8
    assert np.array_equal(np.asarray(want), got.numpy())
    back = t_m8.batched_from_planar_lm(torch.arange(4 * 3 * 16).reshape(12, 16), 10, 3)
    want_back = ref_m8.batched_from_planar_lm(jnp.arange(4 * 3 * 16).reshape(12, 16), 10, 3)
    assert np.array_equal(np.asarray(want_back), back.numpy())


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("fused_rec", [False, True], ids=["combined", "reconstructed"])
def test_plain_fused_ext_matches_reference(name, fused_rec):
    """Caller randomness (k + r slots): plain version == interpret-mode
    Pallas kernel, limb for limb."""
    ref, eng = _pair(name)
    spec = ref.spec
    P = 3
    _, ext = _ext(ref, P, 1 + fused_rec)
    rec = spec.reconstruct_matrix if fused_rec else None
    want = ref_m8.fused_share_combine_mxu8(
        ref.mxu8, spec.share_matrix, ref_m8.planar8_from_batched(ref.mxu8, jnp.asarray(ext), 8),
        P, 3, 4, lanes=8, reconstruct_matrix=rec, interpret=True,
    )
    got = t_m8.fused_share_combine_mxu8(
        eng.mxu8, eng.spec.share_matrix, eng.planar8_ext(limbs_from_numpy(ext), 8),
        P, 3, 4, lanes=8, reconstruct_matrix=eng.spec.reconstruct_matrix if fused_rec else None,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("rp", [None, 1], ids=["rp=P", "rp=1"])
def test_prng_mode_reveals_participant_sum(name, rp):
    """PRNG mode: in-kernel randomness cancels at reconstruction, so the
    fused output equals the modular sum of the secrets (bench.py's check)."""
    _, eng = _pair(name)
    P = 4
    rng = np.random.default_rng(7)
    secrets = eng.encode_secrets(rng.integers(0, min(eng.ctx.p, 1 << 62), size=(P, eng.dimension)))
    sec8 = eng.planar8_secrets(secrets, lanes=8)
    out = t_m8.fused_share_combine_mxu8(
        eng.mxu8, eng.spec.share_matrix, sec8, P, 3, 4, seed=99, lanes=8,
        reconstruct_matrix=eng.spec.reconstruct_matrix, rand_participants=rp,
    )
    got = t_m8.batched_from_planar_lm(out, eng.nb, 3)
    assert torch.equal(got.to(torch.int64), eng.ctx.sum_mod(secrets, axis=0))
    # the combined shares do depend on the seed (randomness is really drawn)
    comb = [
        t_m8.fused_share_combine_mxu8(eng.mxu8, eng.spec.share_matrix, sec8, P, 3, 4,
                                      seed=s, lanes=8, rand_participants=rp)
        for s in (1, 2)
    ]
    assert not torch.equal(comb[0], comb[1])


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors, computed
    from the algorithm's definition with python ints as well."""
    M = 0xFFFFFFFF

    def by_definition(ctr, key):
        c, (k0, k1) = list(ctr), key
        for r in range(10):
            if r:
                k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
            p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M, (p0 >> 32) ^ c[3] ^ k1, p0 & M]
        return c

    vectors = [
        ((0, 0, 0, 0), (0, 0), [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
        ((M, M, M, M), (M, M), [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
    ]
    for ctr, key, want in vectors:
        got = t_m8.philox4x32_10(tuple(torch.tensor(v) for v in ctr), key)
        assert [int(x) for x in got] == want == by_definition(ctr, key)
    rng = np.random.default_rng(0)
    ctrs = rng.integers(0, 1 << 32, size=(4, 50), dtype=np.int64)
    got = t_m8.philox4x32_10(tuple(torch.from_numpy(c) for c in ctrs), (12345, 678))
    for i in range(50):
        want = by_definition(tuple(int(c[i]) for c in ctrs), (12345, 678))
        assert [int(g[i]) for g in got] == want


def test_randomness_operand_three_op_accumulate():
    """The randomness operand's biased bytes equal the direct u16-field sums
    of the Philox words of every draw, with each (lane, draw, word) taken
    from its own counter."""
    _, eng = _pair("p63special")
    plan = t_m8.mxu8_plan(eng.mxu8, eng.spec.share_matrix, 5 * 3 * 8, 5, 3, 4)
    lanes = torch.arange(40, 46)
    op = t_m8._rand_operand(plan, 77, lanes)  # [Kr, T]
    wpp, nb = plan.words_per_p, plan.n_bytes
    for t, lane in enumerate(lanes.tolist()):
        words = []
        for j in range(plan.rp):
            row = []
            for g in range(-(-wpp // 4)):
                out = t_m8.philox4x32_10(tuple(torch.tensor(v) for v in (lane, j, g, 0)), (77, 0))
                row += [int(x) for x in out]
            words.append(row[:wpp])
        for w in range(wpp):
            lo = sum(words[j][w] & 0xFFFF for j in range(plan.rp))
            hi = sum(words[j][w] >> 16 for j in range(plan.rp))
            for c in range(nb):
                assert int(op[(2 * c) * wpp + w, t]) == ((lo >> (8 * c)) & 0xFF) - 128
                assert int(op[(2 * c + 1) * wpp + w, t]) == ((hi >> (8 * c)) & 0xFF) - 128


def test_uint32_chain_exact_above_int31():
    """True column values above 2^31 (but under the carry-chain bound) stay
    exact: 1,100 participants of saturated operands, fused reconstruction."""
    p64, w2, w3 = find_prime_field(62, 8, 9)
    spec = PackedShamirScheme(3, 8, 4, p64, w2, w3).device_spec()
    eng = TorchAggregationEngine(spec, 6, device="cpu")
    P = 1100
    enc = eng.encode_secrets(np.full((P, 6), (1 << 48) - 1, dtype=np.int64))
    ext = torch.cat([enc, eng.random_ext(P, rng=np.random.default_rng(3))], dim=2)
    out = eng.planar8_ext(ext, lanes=8)
    got = t_m8.fused_share_combine_mxu8(
        eng.mxu8, spec.share_matrix, out, P, 3, 4, lanes=8,
        reconstruct_matrix=spec.reconstruct_matrix,
    )
    assert torch.equal(t_m8.batched_from_planar_lm(got, eng.nb, 3).to(torch.int64),
                       eng.ctx.sum_mod(enc, axis=0))


def test_guards_match_reference():
    _, eng = _pair("p62")
    M, mxu8 = eng.spec.share_matrix, eng.mxu8
    ok = torch.zeros((2 * 3 * 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of lanes"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=16)
    with pytest.raises(ValueError, match="neither k nor k\\+r"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok[:40], 2, 3, 4, lanes=8)
    with pytest.raises(ValueError, match="carry-chain bound"):
        big = torch.zeros((3000 * 3 * 8, 8), dtype=torch.int8)
        t_m8.fused_share_combine_mxu8(mxu8, M, big, 3000, 3, 4, lanes=8)
    with pytest.raises(ValueError, match="rand_participants must be >= 1"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, rand_participants=0)
    with pytest.raises(ValueError, match="pg must divide"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, pg=3)
    with pytest.raises(ValueError, match="acc_in accumulation requires"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, n_chunks=2, acc_in=ok)
    # n_chunks > 1 and acc_in are supported (kernels B2 and B3); acc_in is
    # updated in place and returned, and must be an int32 output-shaped tensor
    out = t_m8.fused_share_combine_mxu8(mxu8, M, torch.cat([ok, ok]), 2, 3, 4, lanes=8, n_chunks=2)
    assert out.shape == (eng.ctx.L * 8, 8) and out.dtype == torch.int32
    acc = torch.zeros_like(out)
    assert t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, acc_in=acc) is acc
    with pytest.raises(ValueError, match="acc_in must be"):
        t_m8.fused_share_combine_mxu8(mxu8, M, ok, 2, 3, 4, lanes=8, acc_in=ok)
    with pytest.raises(ValueError, match="too small"):
        t_m8.Mxu8Context.create(LimbContext.create(251))


def test_kernel_params_follow_the_kernels_field_order():
    """The int32 array the launcher passes is csrc/mxu8.cu's Params field by
    field: as many entries as kNParams, each at the index the kernel's
    parser reads it from, the seeds as their 32-bit patterns."""
    import re
    from pathlib import Path

    src = (Path(t_m8.__file__).parent / "csrc" / "mxu8.cu").read_text()
    n_params = int(re.search(r"constexpr int kNParams = (\d+);", src).group(1))
    fields = {name: int(i) for name, i in re.findall(r"p\.(\w+) = (?:\(uint32_t\))?v\[(\d+)\];", src)}
    assert sorted(fields.values()) == list(range(n_params))
    _, eng = _pair("p63special")
    spec = eng.spec
    rows = 5 * spec.secret_count * eng.mxu8.L8
    plan = t_m8.mxu8_plan(eng.mxu8, spec.share_matrix, rows, 5, spec.secret_count,
                          spec.randomness_count, reconstruct_matrix=spec.reconstruct_matrix,
                          n_chunks=2)
    v = t_m8._kernel_params(plan, 4096, -1, 3 << 30)
    assert v.dtype == np.int32 and len(v) == n_params
    want = {"K": rows, "nbp": 4096, "n_chunks": 2, "rp": 5, "wpp": plan.words_per_p,
            "Kr": plan.Kr, "Kr_pad": plan.bigr.shape[1], "n2": plan.n2,
            "rows2": plan.big2.shape[1], "n_bytes": plan.n_bytes, "L8": eng.mxu8.L8}
    assert {k: int(v[fields[k]]) for k in want} == want
    assert int(np.uint32(v[fields["seed"]])) == 0xFFFFFFFF
    assert int(np.uint32(v[fields["seed_stride"]])) == 3 << 30


def test_philox_call_ops_read_the_one_draw_loop(monkeypatch):
    """The Philox issue term for B1-B3 (``tools._common``, which
    chip_smoke's bounds use) counts the body of the one innermost loop
    around the generator, and refuses a listing with two."""
    from sda_tpu_torch.ops import sass
    from sda_tpu_torch.tools import _common

    mul = " R4, R2, -0x2daee0ad, RZ"
    instrs = [
        (0x00, "MOV", " R1, R2"),
        (0x10, "IMMA.16832.S8.S8", " R8, R12, R16, R8"),  # K loop 0x10-0x30
        (0x20, "BAR.SYNC.DEFER_BLOCKING", " 0x0"),
        (0x30, "BRA", " 0x10"),
        (0x40, "IMAD.WIDE.U32", mul),  # draw loop 0x40-0x90
        (0x50, "LOP3.LUT", " R5, R4, R3, RZ, 0x96, !PT"),
        (0x60, "IADD3", " R6, R6, 0x1, RZ"),
        (0x70, "IADD3", " R7, R7, 0x1, RZ"),
        (0x80, "ISETP.GE.AND", " P0, PT, R6, R9, PT"),
        (0x90, "BRA", " 0x40"),
    ]
    monkeypatch.setattr(sass, "sass_listing", lambda *a: {"MT4": instrs})
    assert _common.mxu8_philox_call_ops("mxu8_fused", 4) == 6
    twice = instrs + [(0xa0, "IMAD.WIDE.U32", mul), (0xb0, "BRA", " 0xa0")]
    monkeypatch.setattr(sass, "sass_listing", lambda *a: {"MT4": twice})
    with pytest.raises(AssertionError, match="found 2 Philox loops"):
        _common.mxu8_philox_call_ops("mxu8_fused", 4)
