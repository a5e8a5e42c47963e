"""sda_tpu_torch.ops.modmat against sda_tpu.ops.modmat: exact limb equality.

``uniform_limbs`` draws from a different generator than the reference, so it
is held to its range and rough uniformity only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.ops import limbs as ref_limbs
from sda_tpu.ops import modmat as ref_modmat
from sda_tpu_torch.ops import limbs as t_limbs
from sda_tpu_torch.ops import modmat as t_modmat
from sda_tpu_torch.ops.limbs import limbs_from_numpy


@pytest.mark.parametrize("p", [433, (1 << 61) - 1, (1 << 127) - 1])
def test_modmat_and_combine_match_reference(p):
    ref = ref_limbs.LimbContext.create(p)
    ctx = t_limbs.LimbContext.create(p)
    rng = np.random.default_rng(5)
    P, B, m, n = 3, 17, 5, 4
    a_vals = np.array(
        [int(x) % p for x in rng.integers(0, 2**61, size=P * B * m)], dtype=object
    ).reshape(P, B, m)
    m_vals = np.array(
        [int(x) % p for x in rng.integers(0, 2**61, size=m * n)], dtype=object
    ).reshape(m, n)
    a = ref.encode(a_vals)
    mm = ref.encode_mont(m_vals)
    want = ref_modmat.modmat(ref, jnp.asarray(a), jnp.asarray(mm))
    got = t_modmat.modmat(ctx, limbs_from_numpy(a), ctx.encode_mont(m_vals))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    want_c = ref_modmat.combine(ref, want, axis=0)
    got_c = t_modmat.combine(ctx, got, axis=0)
    assert np.array_equal(np.asarray(want_c).astype(np.int64), got_c.numpy())


def test_uniform_limbs_range():
    p = 2305843009213694257
    ctx = t_limbs.LimbContext.create(p)
    gen = torch.Generator()
    gen.manual_seed(0)
    out = t_modmat.uniform_limbs(ctx, gen, (1000,))
    assert out.shape == (1000, ctx.L)
    vals = [int(x) for x in t_limbs.from_limbs(out)]
    assert all(0 <= v < p for v in vals)
    # rough uniformity: mean within 5% of p/2
    assert abs(sum(vals) / len(vals) - p / 2) < 0.05 * p
