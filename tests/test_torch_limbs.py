"""sda_tpu_torch.ops.limbs against sda_tpu.ops.limbs: exact limb equality.

The same numpy inputs go through the JAX reference and the torch port for
L = 2, 4 and 8 (the moduli of tests/test_limbs.py); every output limb must
be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.ops import limbs as ref_limbs
from sda_tpu_torch.ops import limbs as t_limbs
from sda_tpu_torch.ops.limbs import limbs_from_numpy

MODULI = [
    433,  # reference test-vector field (L=2)
    (1 << 31) - 1,  # Mersenne 31 (L=2)
    2305843009213694257,  # 62-bit prime (L=4)
    (1 << 89) - 1,  # 89-bit Mersenne (L=8)
    (1 << 127) - 1,  # 127-bit Mersenne (L=8)
]


def _values(p, seed, count=64, mult=0x9E3779B97F4A7C15):
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(0, min(p, 2**62))) % p for _ in range(count)]
    if p > 2**62:  # exercise high limbs too
        vals = [(v * mult + 7) % p for v in vals]
    # edge values: 0, 1, p - 1
    return vals[:-3] + [0, 1, p - 1]


def _pair(ctx, vals):
    arr = ref_limbs.to_limbs(np.array(vals, dtype=object), ctx.L)
    return jnp.asarray(arr), limbs_from_numpy(arr)


def _same(ref_out, port_out):
    return np.array_equal(np.asarray(ref_out).astype(np.int64), port_out.numpy())


@pytest.mark.parametrize("p", MODULI)
def test_context_matches_reference(p):
    ref = ref_limbs.LimbContext.create(p)
    got = t_limbs.LimbContext.create(p)
    assert (got.L, got.p_limbs, got.p_inv_w, got.r2, got.r_mod_p) == (
        ref.L, ref.p_limbs, ref.p_inv_w, ref.r2, ref.r_mod_p
    )
    assert t_limbs.limbs_for_modulus(p) == ref_limbs.limbs_for_modulus(p)


@pytest.mark.parametrize("p", MODULI)
def test_add_sub_mont_mul_match_reference(p):
    ref = ref_limbs.LimbContext.create(p)
    ctx = t_limbs.LimbContext.create(p)
    a_ref, a = _pair(ref, _values(p, 1))
    b_ref, b = _pair(ref, _values(p, 2, mult=0xC2B2AE3D27D4EB4F))
    assert _same(ref.add_mod(a_ref, b_ref), ctx.add_mod(a, b))
    assert _same(ref.sub_mod(a_ref, b_ref), ctx.sub_mod(a, b))
    assert _same(ref.sub_mod(b_ref, a_ref), ctx.sub_mod(b, a))
    vals_b = [int(x) for x in ref_limbs.from_limbs(np.asarray(b_ref))]
    bm_ref = jnp.asarray(ref.encode_mont(np.array(vals_b, dtype=object)))
    bm = ctx.encode_mont(np.array(vals_b, dtype=object))
    assert _same(bm_ref, bm)
    assert _same(ref.mont_mul(a_ref, bm_ref), ctx.mont_mul(a, bm))
    assert _same(ref.to_mont(a_ref), ctx.to_mont(a))
    assert _same(ref.from_mont(a_ref), ctx.from_mont(a))
    # the raw CIOS columns and the lane-list forms
    av, bv = [a[..., j] for j in range(ctx.L)], [bm[..., j] for j in range(ctx.L)]
    ra = [a_ref[..., j] for j in range(ref.L)]
    rb = [bm_ref[..., j] for j in range(ref.L)]
    for got, want in zip(ctx.mont_mul_lanes_raw(av, bv), ref.mont_mul_lanes_raw(ra, rb)):
        assert _same(want, got)
    for got, want in zip(ctx.add_mod_lanes(av, bv), ref.add_mod_lanes(ra, rb)):
        assert _same(want, got)


@pytest.mark.parametrize("p", [433, 2305843009213694257, (1 << 127) - 1])
def test_sum_mod_matches_reference(p):
    ref = ref_limbs.LimbContext.create(p)
    ctx = t_limbs.LimbContext.create(p)
    vals = np.array(_values(p, 3, count=33 * 7), dtype=object).reshape(33, 7)
    arr = ref_limbs.to_limbs(vals, ref.L)
    for axis in (0, 1):
        assert _same(ref.sum_mod(jnp.asarray(arr), axis=axis),
                     ctx.sum_mod(limbs_from_numpy(arr), axis=axis))


@pytest.mark.parametrize("p", [433, (1 << 31) - 1, 2305843009213694257, (1 << 63) - 25])
def test_encode_decode_i64_match_reference(p):
    ref = ref_limbs.LimbContext.create(p)
    ctx = t_limbs.LimbContext.create(p)
    rng = np.random.default_rng(4)
    x = rng.integers(-(1 << 62), 1 << 62, size=(5, 9), dtype=np.int64)
    x[0, :3] = [0, -1, np.iinfo(np.int64).max]
    enc_ref = ref.encode_i64(x)
    enc = ctx.encode_i64(x)
    assert np.array_equal(enc_ref.astype(np.int64), enc.numpy())
    assert np.array_equal(ref.decode_i64(enc_ref), ctx.decode_i64(enc))
    assert np.array_equal(ref.encode(x.astype(object)).astype(np.int64), ctx.encode(x.astype(object)).numpy())
    assert [int(v) for v in ctx.decode(enc).reshape(-1)] == [int(v) % p for v in x.reshape(-1)]


def test_host_conversions_match_reference():
    vals = np.array([0, 1, 433, (1 << 64) - 1, (1 << 127) - 1], dtype=object)
    arr = t_limbs.to_limbs(vals, 8)
    assert np.array_equal(arr, ref_limbs.to_limbs(vals, 8))
    assert list(t_limbs.from_limbs(torch.from_numpy(arr.astype(np.int64)))) == list(vals)
    with pytest.raises(ValueError):
        t_limbs.to_limbs([1 << 32], 2)
    with pytest.raises(ValueError):
        t_limbs.limbs_for_modulus(1 << 130)
    with pytest.raises(ValueError):
        t_limbs.LimbContext.create(434)
    even = t_limbs.LimbContext.create_add_only(434)
    ref_even = ref_limbs.LimbContext.create_add_only(434)
    assert (even.p_limbs, even.r_mod_p) == (ref_even.p_limbs, ref_even.r_mod_p)
