"""The port's slice as a whole (engine and model) against sda_tpu.

Schemes are built in the JAX package, their matrices carried across with
``spec_from_numpy``, and the same numpy secrets and randomness go through
both engines; every comparison is exact limb equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sda_tpu.engine import TpuAggregationEngine
from sda_tpu.sharing import AdditiveScheme, PackedShamirScheme
from sda_tpu_torch.engine import TorchAggregationEngine, limbs_from_numpy, spec_from_numpy
from sda_tpu_torch.models import FederatedAggregation

REF = dict(
    secret_count=3,
    share_count=8,
    privacy_threshold=4,
    prime_modulus=433,
    omega_secrets=354,
    omega_shares=150,
)

SCHEMES = [
    pytest.param(PackedShamirScheme(**REF), id="packed433"),
    pytest.param(AdditiveScheme(share_count=5, modulus=433), id="additive433"),
    pytest.param(AdditiveScheme(share_count=3, modulus=(1 << 61) - 1), id="additive61bit"),
]


def _engines(scheme, d):
    ref = TpuAggregationEngine(scheme.device_spec(), d)
    s = ref.spec
    spec = spec_from_numpy(s.modulus, s.secret_count, s.share_count, s.randomness_count,
                           s.share_matrix, s.reconstruct_matrix)
    return ref, TorchAggregationEngine(spec, d, device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_engine_aggregate_matches_reference(scheme):
    d, p_count = 10, 6
    ref, eng = _engines(scheme, d)
    modulus = ref.spec.modulus
    rng = np.random.default_rng(0)
    secrets = rng.integers(0, min(modulus, 2**31), size=(p_count, d))
    enc = ref.encode_secrets(secrets.astype(object))
    rand = ref.random_ext(p_count, rng=rng)
    assert np.array_equal(enc.astype(np.int64), eng.encode_secrets(secrets).numpy())
    ext = np.concatenate([enc, rand], axis=2)
    want_shares = ref.share(jnp.asarray(ext))
    got_shares = eng.share(limbs_from_numpy(ext))
    assert np.array_equal(np.asarray(want_shares).astype(np.int64), got_shares.numpy())
    want = ref.aggregate(jnp.asarray(enc), jnp.asarray(rand))
    got = eng.aggregate(limbs_from_numpy(enc), limbs_from_numpy(rand))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert [int(x) for x in eng.decode_output(got)] == [
        int(x) % modulus for x in secrets.sum(axis=0)
    ]
    assert [int(x) for x in eng.decode_output(got)] == [
        int(x) for x in ref.decode_output(np.asarray(want))
    ]


def _reveal_both(model, d):
    """The reference's and the port's ``decode_output`` of one output limb
    array of ``model`` at dimension ``d``: values 0, 1 and p - 1 at both
    ends (the last real element among them), random residues between, the
    padding past ``d`` nonzero so a missed truncation shows."""
    from sda_tpu import models as ref_models

    ref = getattr(ref_models.FederatedAggregation, model)(dimension=d).engine
    eng = getattr(FederatedAggregation, model)(dimension=d, device="cpu").engine
    p = ref.ctx.p
    vals = np.random.default_rng(d).integers(0, 1 << 62, size=eng.nb * 3).astype(object)
    vals[:3] = [0, 1, p - 1]
    vals[d - 3 : d] = [p - 1, 1, 0]
    vals[d:] = p - 1
    limbs = ref.ctx.encode(vals.reshape(eng.nb, 3))
    return ref.decode_output(limbs), eng.decode_output(limbs_from_numpy(limbs))


@pytest.mark.parametrize("model,d,dtype", [
    pytest.param("packed_64bit", 10, np.int64, id="64bit-pad2"),
    pytest.param("packed_64bit", 11, np.int64, id="64bit-pad1"),
    pytest.param("packed_128bit", 10, object, id="128bit-pad2"),
])
def test_decode_output_dtype_and_values_match_reference(model, d, dtype):
    """Below a modulus of 2^63 the reveal is an int64 ``[d]`` array, at
    2^127 - 1495 object ints; either way the reference's values, element for
    element, padding truncated."""
    want, got = _reveal_both(model, d)
    assert got.dtype == dtype
    assert got.shape == (d,)
    assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("model,rise", [("packed_64bit", 1), ("packed_128bit", 0)])
def test_decode_i64_launches_counts_the_int64_route(model, rise):
    from sda_tpu_torch import engine as port_engine

    before = port_engine.decode_i64_launches
    _reveal_both(model, 10)
    assert port_engine.decode_i64_launches - before == rise


def _encode_both(values, monkeypatch):
    """``values`` through the reference's and the port's ``encode_secrets``
    at ``packed_64bit(dimension=3)`` (p = 2^63 - 871); also whether the
    port took its vectorised int64 path."""
    from sda_tpu.models import FederatedAggregation as RefAggregation

    ref = RefAggregation.packed_64bit(dimension=3).engine
    eng = FederatedAggregation.packed_64bit(dimension=3, device="cpu").engine
    assert eng.ctx.p == (1 << 63) - 871
    calls = []
    fast = type(eng.ctx).encode_i64
    monkeypatch.setattr(type(eng.ctx), "encode_i64",
                        lambda *a, **kw: calls.append(1) or fast(*a, **kw))
    want = np.asarray(ref.encode_secrets(values)).astype(np.int64)
    return want, eng.encode_secrets(values).numpy(), bool(calls)


def test_encode_secrets_uint64_past_int64_matches_reference(monkeypatch):
    """uint64 values of 2^63 and more are reduced mod p as the reference
    reduces them (they used to wrap to negatives on the int64 path)."""
    from sda_tpu_torch.ops.limbs import LimbContext

    values = np.array([[1 << 63, (1 << 64) - 1, 5]], dtype=np.uint64)
    want, got, fast = _encode_both(values, monkeypatch)
    assert np.array_equal(got, want)
    assert not fast
    ctx = LimbContext.create((1 << 63) - 871)
    assert [int(x) for x in ctx.decode_i64(got.reshape(-1, 4))] == [871, 1741, 5]


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.uint32])
def test_encode_secrets_int_arrays_take_the_fast_path(dtype, monkeypatch):
    """Integer arrays whose values fit int64 keep the vectorised path and
    equal the reference."""
    values = np.array([[0, 12345, (1 << 31) - 1]], dtype=dtype)
    want, got, fast = _encode_both(values, monkeypatch)
    assert np.array_equal(got, want)
    assert fast


def test_stage_outputs_reconstruct_on_host():
    """Device shares decode to values the host scheme reconstructs."""
    import torch

    from sda_tpu_torch.fields import positive
    from sda_tpu_torch.sharing import PackedShamirScheme as PortScheme

    scheme = PortScheme(**REF)
    eng = TorchAggregationEngine(scheme.device_spec(), 4, device="cpu")
    enc = eng.encode_secrets(np.array([[1, 2, 3, 4]]))
    rand = eng.random_ext(1, rng=np.random.default_rng(1))
    shares = eng.share(torch.cat([enc, rand], dim=2))
    per_clerk = eng.decode_shares(shares)[0].T  # [n, nb]
    out = scheme.reconstruct([(i, per_clerk[i]) for i in range(8)], dimension=4)
    assert [int(x) for x in positive(out, 433)] == [1, 2, 3, 4]


@pytest.mark.parametrize("rp_lanes", [(5, 8), (2, 16)])
def test_aggregate_mxu8_kernel_cpu_reveals_sum(rp_lanes):
    """The one-launch byte-limb path (plain version on the CPU) reveals the
    modular participant sum; the combined-only entry point reconstructs to
    the same values through the CIOS path."""
    import torch

    from sda_tpu_torch.ops.mxu8 import batched_from_planar_lm

    P, lanes = rp_lanes
    model = FederatedAggregation.packed_64bit(dimension=40, device="cpu")
    eng = model.engine
    rng = np.random.default_rng(P)
    secrets = eng.encode_secrets(rng.integers(0, 1 << 62, size=(P, 40)))
    sec8 = eng.planar8_secrets(secrets, lanes=lanes)
    out = eng.aggregate_mxu8_kernel(sec8, 5, p_count=P, lanes=lanes)
    assert out.shape == (eng.nb, 3, eng.ctx.L)
    want = eng.ctx.sum_mod(secrets, axis=0)
    assert torch.equal(out.to(torch.int64), want)
    comb = eng.mxu8_kernel_combined(sec8, 5, p_count=P, lanes=lanes)
    combined = batched_from_planar_lm(comb, eng.nb, 8).to(torch.int64)
    assert torch.equal(eng.reconstruct(combined), want)


def test_federated_model_masked_reveal():
    model = FederatedAggregation.packed_64bit(dimension=64, device="cpu")
    secrets, gen = model.example_inputs(participants=8, seed=1)
    revealed = model.reveal(model.forward(secrets, gen))
    raw = np.random.default_rng(1).integers(0, min(model.scheme_modulus, 1 << 31), size=(8, 64))
    assert [int(x) for x in revealed] == [int(x) % model.scheme_modulus for x in raw.sum(axis=0)]


def test_federated_model_128bit():
    model = FederatedAggregation.packed_128bit(dimension=12, device="cpu")
    assert model.engine.ctx.L == 8
    secrets, gen = model.example_inputs(participants=4, seed=2)
    revealed = model.reveal(model.forward(secrets, gen))
    raw = np.random.default_rng(2).integers(0, min(model.scheme_modulus, 1 << 31), size=(4, 12))
    assert [int(x) for x in revealed] == [int(x) % model.scheme_modulus for x in raw.sum(axis=0)]


def test_federated_additive_small_and_from_key():
    import torch

    model = FederatedAggregation.additive_small(device="cpu")
    assert model.engine.mxu8 is not None  # odd 433 > 7 bits
    secrets, gen = model.example_inputs(participants=3, seed=4)
    out = model.engine.aggregate_from_key(secrets, gen)
    raw = np.random.default_rng(4).integers(0, 433, size=(3, 10))
    assert [int(x) for x in model.reveal(out)] == [int(x) % 433 for x in raw.sum(axis=0)]
    assert isinstance(gen, torch.Generator)
