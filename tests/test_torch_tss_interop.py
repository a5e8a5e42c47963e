"""The port's packed Shamir against the tss v0.2 algorithm: the twin of
``tests/test_tss_interop.py`` on ``sda_tpu_torch``.

With the same injected randomness, the port's shares equal, point for
point, those of the independent Lagrange oracle (``tests/tss_oracle.py``)
and of ``sda_tpu.sharing``, at the reference's p = 433 vector and at a
64-bit prime; each reconstructs the other's shares, from every threshold
subset. The recipient's device reconstruction (``SdaClient.
_device_reconstruct`` on the CPU: the engine's matmul for the full set,
``modmat`` on the subset's Lagrange matrix otherwise) reveals the same sum
from each of those subsets, at p = 433 and at the production prime.
"""

from itertools import combinations

import numpy as np
import pytest

from sda_tpu import sharing as ref_sharing
from sda_tpu_torch.fields import find_prime_field, find_special_prime_field, positive
from sda_tpu_torch.server import new_memory_server
from sda_tpu_torch.sharing import PackedShamirScheme
from tests.tss_oracle import oracle_reconstruct, oracle_share

from .test_torch_client import make_client

P433 = dict(secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
            omega_secrets=354, omega_shares=150)


def _params(p, w2, w3):
    return dict(secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=p,
                omega_secrets=w2, omega_shares=w3)


CONFIGS = {"p433": P433, "p64bit": _params(*find_prime_field(64, 8, 9))}
SUBSETS = list(combinations(range(8), 7)) + [tuple(range(8))]


def _rand_elems(rng, p, count):
    """Uniform python ints in [0, p) for any p."""
    nbytes = (p.bit_length() + 64 + 7) // 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(count)]


def _share_with_randomness(scheme, secrets, randomness):
    """``[0 | secrets | randomness] @ share_matrix`` (what share_batch does)."""
    f = scheme.field
    ext = np.concatenate([np.zeros(1, dtype=f.dtype), f.canon(secrets),
                          f.canon(randomness)])[None, :]
    return [int(x) for x in f.matmul(ext, scheme.share_matrix)[0]]


def _oracle_params(scheme):
    return dict(secret_count=scheme.secret_count, share_count=scheme.share_count,
                threshold=scheme.privacy_threshold, prime=scheme.prime_modulus,
                omega_secrets=scheme.omega_secrets, omega_shares=scheme.omega_shares)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_share_values_match_oracle_point_for_point(config):
    scheme = PackedShamirScheme(**CONFIGS[config])
    ref = ref_sharing.PackedShamirScheme(**CONFIGS[config])
    assert np.asarray(scheme.share_matrix).tolist() == np.asarray(ref.share_matrix).tolist()
    rng = np.random.default_rng(7)
    op = _oracle_params(scheme)
    for _ in range(8):
        secrets = _rand_elems(rng, scheme.prime_modulus, 3)
        randomness = _rand_elems(rng, scheme.prime_modulus, 4)
        ours = _share_with_randomness(scheme, secrets, randomness)
        assert ours == oracle_share(secrets, randomness, **op)
        assert ours == _share_with_randomness(ref, secrets, randomness)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_oracle_reconstructs_our_shares_and_vice_versa(config):
    scheme = PackedShamirScheme(**CONFIGS[config])
    rng = np.random.default_rng(11)
    op = _oracle_params(scheme)
    secrets = _rand_elems(rng, scheme.prime_modulus, 3)
    randomness = _rand_elems(rng, scheme.prime_modulus, 4)
    ours = _share_with_randomness(scheme, secrets, randomness)
    assert oracle_reconstruct(list(range(8)), ours, **op) == secrets
    subset = list(range(1, 8))  # any t + k of n suffice
    assert oracle_reconstruct(subset, [ours[i] for i in subset], **op) == secrets
    theirs = oracle_share(secrets, randomness, **op)
    batches = np.array(theirs, dtype=object).reshape(8, 1)
    full = scheme.reconstruct([(i, batches[i]) for i in range(8)], dimension=3)
    assert [int(x) for x in full] == secrets
    sub = scheme.reconstruct([(i, batches[i]) for i in subset], dimension=3)
    assert [int(x) for x in sub] == secrets


def test_reconstruct_limit_enforced_like_tss():
    scheme = PackedShamirScheme(**P433)
    with pytest.raises(AssertionError):
        oracle_reconstruct([0, 1, 2], [1, 2, 3], **_oracle_params(scheme))
    assert scheme.reconstruction_threshold == 7  # t + k


def _aggregate(participants, seed):
    """Several participants' oracle sharings at p = 433, summed: (combined
    shares, the secrets' sum)."""
    op = _oracle_params(PackedShamirScheme(**P433))
    rng = np.random.default_rng(seed)
    parts = [(_rand_elems(rng, 433, 3), _rand_elems(rng, 433, 4)) for _ in range(participants)]
    sharings = [oracle_share(s, r, **op) for s, r in parts]
    combined = [sum(sh[i] for sh in sharings) % 433 for i in range(8)]
    return combined, [sum(s[j] for s, _ in parts) % 433 for j in range(3)]


def test_every_threshold_subset_reveals_identically():
    """All 8 threshold subsets and the full set reconstruct the same
    aggregate through the port's subset path, the reference's and the
    oracle."""
    scheme = PackedShamirScheme(**P433)
    ref = ref_sharing.PackedShamirScheme(**P433)
    combined, want = _aggregate(4, 13)
    batches = np.array(combined, dtype=object).reshape(8, 1)
    assert len(SUBSETS) == 9
    for subset in SUBSETS:
        shares = [(i, batches[i]) for i in subset]
        assert [int(x) for x in scheme.reconstruct(shares, dimension=3)] == want, subset
        assert [int(x) for x in ref.reconstruct(shares, dimension=3)] == want, subset
        assert oracle_reconstruct(list(subset), [combined[i] for i in subset],
                                  **_oracle_params(scheme)) == want, subset
        assert (np.asarray(scheme.reconstruct_matrix(list(subset))).tolist()
                == np.asarray(ref.reconstruct_matrix(list(subset))).tolist())


def test_linearity_matches_aggregated_reveal():
    """The sum of two sharings reconstructs to the sum."""
    op = _oracle_params(PackedShamirScheme(**P433))
    rng = np.random.default_rng(3)
    s1, s2 = _rand_elems(rng, 433, 3), _rand_elems(rng, 433, 3)
    r1, r2 = _rand_elems(rng, 433, 4), _rand_elems(rng, 433, 4)
    combined = [(a + b) % 433 for a, b in zip(oracle_share(s1, r1, **op),
                                              oracle_share(s2, r2, **op))]
    assert oracle_reconstruct(list(range(8)), combined, **op) == [
        (a + b) % 433 for a, b in zip(s1, s2)]


@pytest.mark.parametrize("prime", ["p433", "p63"])
@pytest.mark.parametrize("subset", SUBSETS, ids=lambda s: "".join(map(str, s)))
def test_device_reconstruction_of_every_threshold_subset(subset, prime):
    """The recipient's device reconstruction (the CPU's plain torch code)
    of each subset equals the port's and the reference's host
    reconstruction and the participants' sum."""
    params = P433 if prime == "p433" else _params(*find_special_prime_field(63, 8, 9))
    scheme, ref = PackedShamirScheme(**params), ref_sharing.PackedShamirScheme(**params)
    p, d = scheme.prime_modulus, 10
    rng = np.random.default_rng(len(subset) * 31 + subset[0])
    secrets = [rng.integers(0, min(p, 1 << 62), size=d, dtype=np.int64) for _ in range(3)]
    sharings = [scheme.share_vector(s) for s in secrets]
    combined = [(j, scheme.combine([sh[j] for sh in sharings])) for j in range(8)]
    shares = [combined[j] for j in subset]
    client = make_client(new_memory_server(), device_bulk_threshold=1)
    got = positive(client._device_reconstruct(scheme, shares, d), p).tolist()
    want = [sum(int(s[i]) for s in secrets) % p for i in range(d)]
    assert got == want
    assert positive(scheme.reconstruct(shares, dimension=d), p).tolist() == want
    assert positive(ref.reconstruct(shares, dimension=d), p).tolist() == want
