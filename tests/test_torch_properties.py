"""Property-based tests (hypothesis) of the port's arithmetic and wire
layers: the twin of ``tests/test_properties.py`` on ``sda_tpu_torch``.

Every drawn input goes through the port and through the reference
(``sda_tpu.fields``, ``sda_tpu.utils.varint``, ``sda_tpu.sharing``,
``sda_tpu.protocol``), and the two must agree exactly, besides the
properties themselves:

- ``trunc_add_mod`` / ``trunc_sub_mod`` equal the python-int
  truncated-remainder oracle for every sign and any modulus below 2^63;
- the varint codec is the identity on any i64 vector, native and numpy,
  and its bytes are the reference's;
- additive sharing reconstructs the modular sum for any share count,
  modulus (odd or even) and secrets;
- packed Shamir share -> combine -> reconstruct is the modular sum over
  generated fields, from all shares and from a random minimal subset;
- an Aggregation's JSON round-trips, and its canonical bytes are the
  reference's.
"""

import json

import numpy as np
from hypothesis import given, settings, strategies as st

from sda_tpu import fields as ref_fields
from sda_tpu import protocol as ref_proto
from sda_tpu import sharing as ref_sharing
from sda_tpu.utils import varint as ref_varint
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.fields import find_prime_field, positive, trunc_add_mod, trunc_sub_mod
from sda_tpu_torch.sharing import AdditiveScheme, PackedShamirScheme
from sda_tpu_torch.utils import varint


def _oracle_trunc(v: int, m: int) -> int:
    r = abs(v) % m
    return r if v >= 0 else -r


moduli = st.one_of(
    st.integers(min_value=2, max_value=1 << 16),
    st.integers(min_value=(1 << 62) - 4096, max_value=(1 << 63) - 1),
    st.just((1 << 63) - 871),
)


@settings(max_examples=200, deadline=None)
@given(st.data(), moduli)
def test_trunc_add_sub_mod_property(data, m):
    a = np.array([data.draw(st.integers(min_value=-(m - 1), max_value=m - 1))], dtype=np.int64)
    b = np.array([data.draw(st.integers(min_value=-(m - 1), max_value=m - 1))], dtype=np.int64)
    got_add, got_sub = int(trunc_add_mod(a, b, m)[0]), int(trunc_sub_mod(a, b, m)[0])
    assert got_add == _oracle_trunc(int(a[0]) + int(b[0]), m)
    assert got_sub == _oracle_trunc(int(a[0]) - int(b[0]), m)
    assert got_add == int(ref_fields.trunc_add_mod(a, b, m)[0])
    assert got_sub == int(ref_fields.trunc_sub_mod(a, b, m)[0])


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(min_value=-(1 << 63), max_value=(1 << 63) - 1), max_size=40))
def test_varint_roundtrip_property(values):
    arr = np.array(values, dtype=np.int64)
    wire = varint.encode_varints(arr)
    assert wire == ref_varint.encode_varints(arr)
    assert varint.decode_varints(wire).tolist() == values
    saved, varint._NATIVE = varint._NATIVE, None  # the numpy route
    try:
        assert varint.encode_varints(arr) == wire
        assert varint.decode_varints(wire).tolist() == values
    finally:
        varint._NATIVE = saved


@settings(max_examples=50, deadline=None)
@given(
    st.integers(min_value=2, max_value=8),  # share_count
    st.one_of(st.integers(min_value=2, max_value=1 << 16), st.just((1 << 63) - 871),
              st.integers(min_value=1 << 62, max_value=(1 << 62) + 4096)),  # odd or even
    st.integers(min_value=1, max_value=12),  # dimension
    st.integers(min_value=1, max_value=5),  # participants
    st.integers(min_value=0, max_value=2**32),  # rng seed
)
def test_additive_roundtrip_property(n, m, d, parts, seed):
    sch = AdditiveScheme(share_count=n, modulus=m)
    ref = ref_sharing.AdditiveScheme(share_count=n, modulus=m)
    rng = np.random.default_rng(seed)
    secrets = [rng.integers(0, m, size=d, dtype=np.int64) for _ in range(parts)]
    shares = [sch.share_vector(s, rng=rng) for s in secrets]
    combined = [(j, sch.combine([sh[j] for sh in shares])) for j in range(n)]
    assert [c.tolist() for _, c in combined] == [
        ref.combine([sh[j] for sh in shares]).tolist() for j in range(n)]
    out = sch.reconstruct(combined, dimension=d)
    assert out.tolist() == ref.reconstruct(combined, dimension=d).tolist()
    assert [int(x) for x in positive(out, m)] == [
        sum(int(s[i]) for s in secrets) % m for i in range(d)]


@settings(max_examples=15, deadline=None)
@given(
    st.sampled_from([(3, 8, 4), (2, 8, 3), (1, 8, 2), (3, 26, 10)]),
    st.integers(min_value=10, max_value=40),  # min field bits
    st.integers(min_value=1, max_value=8),  # dimension
    st.integers(min_value=1, max_value=4),  # participants
    st.integers(min_value=0, max_value=2**32),
)
def test_packed_shamir_roundtrip_property(kp, bits, d, parts, seed):
    k, n, t = kp
    p, w2, w3 = find_prime_field(bits, k + t + 1, n + 1)
    assert (p, w2, w3) == ref_fields.find_prime_field(bits, k + t + 1, n + 1)
    params = dict(secret_count=k, share_count=n, privacy_threshold=t, prime_modulus=p,
                  omega_secrets=w2, omega_shares=w3)
    sch, ref = PackedShamirScheme(**params), ref_sharing.PackedShamirScheme(**params)
    rng = np.random.default_rng(seed)
    secrets = [rng.integers(0, p, size=d, dtype=np.int64) for _ in range(parts)]
    shares = [sch.share_vector(s, rng=rng) for s in secrets]
    combined = [(j, sch.combine([sh[j] for sh in shares])) for j in range(n)]
    want = [sum(int(s[i]) for s in secrets) % p for i in range(d)]
    out = sch.reconstruct(combined, dimension=d)
    assert [int(x) for x in positive(out, p)] == want
    assert out.tolist() == ref.reconstruct(combined, dimension=d).tolist()
    subset = [combined[j] for j in sorted(rng.permutation(n)[: sch.reconstruction_threshold])]
    out2 = sch.reconstruct(subset, dimension=d)
    assert [int(x) for x in positive(out2, p)] == want
    assert out2.tolist() == ref.reconstruct(subset, dimension=d).tolist()


_schemes = st.one_of(
    st.just(proto.NoMasking()),
    st.builds(proto.FullMasking, modulus=st.integers(2, (1 << 63) - 1)),
    st.builds(proto.ChaChaMasking, modulus=st.integers(2, (1 << 63) - 1),
              dimension=st.integers(1, 1 << 20), seed_bitsize=st.sampled_from([128, 256])),
)
_sharing = st.one_of(
    st.builds(proto.AdditiveSharing, share_count=st.integers(1, 64),
              modulus=st.integers(2, (1 << 63) - 1)),
    st.builds(proto.PackedShamirSharing, secret_count=st.integers(1, 8),
              share_count=st.integers(2, 64), privacy_threshold=st.integers(1, 16),
              prime_modulus=st.integers(3, (1 << 63) - 1),
              omega_secrets=st.integers(2, 1 << 32), omega_shares=st.integers(2, 1 << 32)),
)


@settings(max_examples=100, deadline=None)
@given(st.text(min_size=0, max_size=30), st.integers(1, 1 << 31),
       st.integers(2, (1 << 63) - 1), _schemes, _sharing)
def test_aggregation_serde_roundtrip_property(title, dim, modulus, mask, share):
    agg = proto.Aggregation(
        id=proto.new_id(), title=title, vector_dimension=dim, modulus=modulus,
        recipient=proto.new_id(), recipient_key=proto.new_id(),
        masking_scheme=mask, committee_sharing_scheme=share,
    )
    assert proto.Aggregation.from_obj(agg.to_obj()) == agg
    wire = proto.canonical(agg)
    assert proto.Aggregation.from_obj(json.loads(wire.decode())) == agg
    assert wire == ref_proto.canonical(ref_proto.Aggregation.from_obj(json.loads(wire)))
