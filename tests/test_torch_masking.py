"""The port's reveal-side masking layer (maskers, routing, device_combine,
trunc_sub_mod) against sda_tpu.

Inputs come from numpy seeds; every comparison is exact integer equality.
Decisions are pinned against recorded probe values, as the reference's
routing tests pin them:
- a tunneled dev box: host fold ~2.5 GB/s, host->device link ~0.025 GB/s;
- a PCIe-attached production host: link ~16 GB/s.
"""

import numpy as np
import pytest
import torch

from sda_tpu import masking as ref_masking
from sda_tpu.engine import device_combine as ref_device_combine
from sda_tpu.fields import find_special_prime_field
from sda_tpu.fields import trunc_add_mod as ref_trunc_add_mod
from sda_tpu.fields import trunc_sub_mod as ref_trunc_sub_mod
from sda_tpu_torch import chacha, engine, fields, routing
from sda_tpu_torch.engine import device_combine
from sda_tpu_torch.fields import positive, trunc_add_mod, trunc_sub_mod
from sda_tpu_torch.masking import ChaChaMasker, FullMasker, NoneMasker
from sda_tpu_torch.routing import Probe, RoutingPolicy, default_policy, set_probe
from sda_tpu_torch.utils.errors import Invalid

P63 = find_special_prime_field(63, 8, 9)[0]
FORCED = (1 << 62) + 1

TUNNEL = Probe(host_fold_gbs=2.5, link_gbs=0.025, device_backend="cuda")
PCIE = Probe(host_fold_gbs=2.5, link_gbs=16.0, device_backend="cuda")
NO_DEV = Probe(host_fold_gbs=2.5, link_gbs=None, device_backend=None)
CPU_ONLY = Probe(host_fold_gbs=2.5, link_gbs=40.0, device_backend="cpu")
BULK = 1 << 24  # comfortably above the default floor


def _seeds_i64(n, seed):
    rng = np.random.default_rng(seed)
    return [np.array(chacha.new_seed(128, rng), dtype=np.int64) for _ in range(n)]


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize(
    "probe,fullmask,chacha_route,clerk",
    [
        (TUNNEL, "host", "device", "host"),  # slow link: only seeds may cross it
        (PCIE, "device", "device", "device"),
        (NO_DEV, "host", "host", "host"),
        (CPU_ONLY, "host", "host", "host"),  # memcpy is not a link
    ],
    ids=["tunnel", "pcie", "no_device", "cpu_only"],
)
def test_route_decisions_from_recorded_probes(probe, fullmask, chacha_route, clerk):
    pol = RoutingPolicy(probe)
    assert pol.fullmask_combine(10_000, BULK) == fullmask
    assert pol.chacha_combine(10_000, BULK) == chacha_route
    assert pol.clerk_fallback_combine(BULK) == clerk


def test_size_floor_keeps_small_jobs_on_host():
    pol = RoutingPolicy(PCIE, bulk_floor=1 << 20)
    assert pol.fullmask_combine(10, 100) == "host"
    assert pol.chacha_combine(10, 100) == "host"
    assert pol.clerk_fallback_combine(1000) == "host"


def test_forced_policies():
    dev, host = RoutingPolicy.force("device"), RoutingPolicy.force("host")
    assert dev.fullmask_combine(1, 1) == dev.chacha_combine(1, 1) == "device"
    assert host.fullmask_combine(1 << 20, 1 << 10) == host.chacha_combine(1 << 20, 1 << 10) == "host"
    with pytest.raises(ValueError):
        RoutingPolicy.force("sideways")


def test_cpu_only_probe_has_no_device(monkeypatch):
    """On a machine whose torch sees no card the measured probe has no
    link and no backend (the CPU tests run there; with a card they fake
    its absence)."""
    monkeypatch.setattr(routing.torch.cuda, "is_available", lambda: False)
    probe = routing.measure_probe()
    assert probe.link_gbs is None and probe.device_backend is None
    assert not probe.has_device and probe.host_fold_gbs > 0
    assert RoutingPolicy(probe).chacha_combine(10_000, BULK) == "host"


def test_probe_env_override(monkeypatch):
    set_probe(None)
    monkeypatch.setenv("SDA_HOST_FOLD_GBS", "2.5")
    monkeypatch.setenv("SDA_LINK_GBS", "16.0")
    try:
        probe = routing.current_probe()
        assert probe.source == "env"
        assert probe.link_gbs == 16.0 and probe.host_fold_gbs == 2.5
        assert RoutingPolicy(probe).fullmask_combine(10_000, BULK) == "device"
    finally:
        set_probe(None)


def test_probe_env_fold_only_still_measures_link(monkeypatch):
    set_probe(None)
    monkeypatch.setenv("SDA_HOST_FOLD_GBS", "2.5")
    monkeypatch.delenv("SDA_LINK_GBS", raising=False)
    try:
        measured = []
        real = routing._measure_link
        monkeypatch.setattr(routing, "_measure_link",
                            lambda *a, **k: measured.append(1) or real(*a, **k))
        probe = routing.current_probe()
        assert measured, "_measure_link was not called for a fold-only config"
        assert probe.host_fold_gbs == 2.5
    finally:
        set_probe(None)


def test_deprecated_threshold_no_longer_forces_direction(monkeypatch):
    """With the tunnel probe injected, the legacy ``device_bulk_threshold=1``
    masker stays on the host fold."""
    set_probe(TUNNEL)
    try:
        called = []
        monkeypatch.setattr(engine, "device_combine",
                            lambda *a, **k: called.append(1) or np.zeros(4, dtype=np.int64))
        rng = np.random.default_rng(0)
        masks = [rng.integers(0, 10_007, size=4, dtype=np.int64) for _ in range(3)]
        out = FullMasker(10_007, device_bulk_threshold=1).combine(masks)
        assert not called
        assert out.tolist() == (np.sum(masks, axis=0) % 10_007).tolist()
        assert default_policy(bulk_floor=1).fullmask_combine(3, 4) == "host"
    finally:
        set_probe(None)


# ---------------------------------------------------------------- maskers


def test_none_masker_matches_reference():
    got, want = NoneMasker(), ref_masking.NoneMasker()
    secrets = np.arange(6, dtype=np.int64)
    for a, b in zip(got.mask(secrets), want.mask(secrets)):
        assert np.array_equal(a, b)
    assert got.combine([[], []]).tolist() == want.combine([[], []]).tolist() == []
    assert got.unmask((np.zeros(0), secrets)).tolist() == secrets.tolist()
    with pytest.raises(Invalid):
        got.combine([[1]])


@pytest.mark.parametrize("modulus", [433, (1 << 61) - 1, P63, (1 << 64) + 13],
                         ids=["p433", "p61", "p63", "p64plus"])
def test_full_masker_matches_reference(modulus):
    rng = np.random.default_rng(1)
    d = 33
    masks = [np.array([int(v) for v in rng.integers(0, min(modulus, 1 << 63), size=d)],
                      dtype=np.int64 if modulus < (1 << 63) else object) for _ in range(9)]
    got = FullMasker(modulus, device="cpu").combine(masks)
    want = ref_masking.FullMasker(modulus).combine(masks)
    assert [int(x) for x in got] == [int(x) for x in want]
    masked = masks[0]
    assert [int(x) for x in FullMasker(modulus).unmask((masks[1], masked))] == [
        int(x) for x in ref_masking.FullMasker(modulus).unmask((masks[1], masked))]
    # the pad round-trips
    secrets = np.arange(d, dtype=np.int64)
    mask, masked = FullMasker(modulus).mask(secrets)
    assert [int(x) for x in positive(FullMasker(modulus).unmask((mask, masked)), modulus)] == (
        secrets.tolist())


def test_full_masker_roundtrip_and_aggregation_property():
    """The pad stays inside (-m, m) and unmasks to the secrets; the sum of
    two masked vectors minus the combined masks is the sum of the secrets
    (the reference's [11, 22, 33, 44])."""
    m = FullMasker(433, device="cpu")
    mask, masked = m.mask(np.array([0, 1, 432, 100]))
    assert (np.abs(masked) < 433).all()
    assert positive(m.unmask((mask, masked)), 433).tolist() == [0, 1, 432, 100]
    k1, m1 = m.mask(np.array([1, 2, 3, 4]))
    k2, m2 = m.mask(np.array([10, 20, 30, 40]))
    masked_sum = trunc_add_mod(np.asarray(m1, dtype=np.int64), np.asarray(m2, dtype=np.int64),
                               433)
    out = m.unmask((m.combine([k1, k2]), masked_sum))
    assert positive(out, 433).tolist() == [11, 22, 33, 44]


def test_chacha_masker_uploads_seed_not_mask():
    """The mask a participant uploads is its 128-bit seed (4 words), which
    the combine re-expands; a vector of the wrong length, or seeds of
    unequal lengths, are refused."""
    m = ChaChaMasker(modulus=433, dimension=50, seed_bitsize=128, device="cpu")
    seed, masked = m.mask(np.arange(50))
    assert len(seed) == 4
    assert positive(m.unmask((m.combine([seed]), masked)), 433).tolist() == list(range(50))
    with pytest.raises(Invalid):
        m.mask(np.arange(49))
    with pytest.raises(Invalid, match="seed length"):
        m.combine([seed, seed[:3]])


def test_full_masker_out_of_domain_wire_masks_match_reference():
    p = 10_007
    masks = [np.array([-(1 << 62), 5, (1 << 62) + 3, -7], dtype=np.int64),
             np.array([1, -2, 3, -4], dtype=np.int64)]
    got = FullMasker(p, device="cpu").combine(masks)
    assert got.tolist() == ref_masking.FullMasker(p).combine(masks).tolist()
    with pytest.raises(Invalid):
        FullMasker(p, device="cpu").combine([np.zeros(3), np.zeros(4)])


@pytest.mark.parametrize("modulus", [433, P63, FORCED], ids=["p433", "p63", "forced"])
def test_chacha_masker_combine_matches_reference(modulus):
    seeds = _seeds_i64(5, seed=2)
    got = ChaChaMasker(modulus, 40, 128, device="cpu").combine(seeds)
    want = ref_masking.ChaChaMasker(modulus, 40, 128).combine(seeds)
    assert got.dtype == np.int64 and got.tolist() == want.tolist()


def test_chacha_masker_63bit_prime_end_to_end():
    """The 63-bit overflow case of the reference's tests: 4 participants at
    p = 2^63 - 871, reveal = sum of secrets."""
    d = 64
    m = ChaChaMasker(modulus=P63, dimension=d, seed_bitsize=128, device="cpu")
    secrets = [np.arange(d, dtype=np.int64) * (i + 1) for i in range(4)]
    seeds, maskeds = zip(*(m.mask(s) for s in secrets))
    combined = m.combine(list(seeds))
    assert combined.tolist() == ref_masking.ChaChaMasker(P63, d, 128).combine(list(seeds)).tolist()
    masked_sum = np.zeros(d, dtype=np.int64)
    for mk in maskeds:
        masked_sum = trunc_add_mod(masked_sum, mk, P63)
    got = m.unmask((combined, masked_sum))
    assert got.tolist() == ref_masking.ChaChaMasker(P63, d, 128).unmask(
        (combined, masked_sum)).tolist()
    want = [(sum(int(s[j]) for s in secrets)) % P63 for j in range(d)]
    assert [int(x) for x in positive(got, P63)] == want
    with pytest.raises(Invalid):
        m.mask(np.zeros(d + 1, dtype=np.int64))


@pytest.mark.parametrize("modulus", [433, P63, FORCED], ids=["p433", "p63", "forced"])
def test_chacha_masker_forced_device_route_on_cpu(modulus):
    """The device route, run on the CPU (the chunk route's plain versions),
    equals the reference's host combine — at 2^62 + 1 through the per-seed
    rejection fix-up."""
    seeds = _seeds_i64(6, seed=3)
    dev = ChaChaMasker(modulus, 48, 128, routing=RoutingPolicy.force("device"), device="cpu")
    want = ref_masking.ChaChaMasker(modulus, 48, 128).combine(seeds)
    assert dev.combine(seeds).tolist() == want.tolist()


def test_maskers_take_the_device_route_on_the_card_by_default(monkeypatch):
    """With no routing and the default device, both reveals run the device
    route (a card is faked; the routes run their plain versions);
    ``device="cpu"`` keeps the host fold."""
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.utils import device as device_util

    calls = []
    real_combine, real_chacha = engine.device_combine, ck.combine_masks_device
    monkeypatch.setattr(device_util, "resolve_device",
                        lambda device=None: torch.device("cuda" if device is None else device))
    monkeypatch.setattr(engine, "device_combine", lambda m, vecs, device=None: (
        calls.append(("full", device)) or real_combine(m, vecs, device="cpu")))
    monkeypatch.setattr(ck, "combine_masks_device", lambda seeds, d, m, device=None: (
        calls.append(("chacha", device)) or real_chacha(seeds, d, m, device="cpu")))
    p = (1 << 61) - 1
    masks = list(np.random.default_rng(8).integers(0, p, size=(4, 24), dtype=np.int64))
    seeds = _seeds_i64(3, seed=9)
    full, cha = FullMasker(p).combine(masks), ChaChaMasker(p, 24, 128).combine(seeds)
    assert calls == [("full", None), ("chacha", None)]
    assert full.tolist() == ref_masking.FullMasker(p).combine(masks).tolist()
    assert cha.tolist() == ref_masking.ChaChaMasker(p, 24, 128).combine(seeds).tolist()
    FullMasker(p, device="cpu").combine(masks)
    ChaChaMasker(p, 24, 128, device="cpu").combine(seeds)
    assert len(calls) == 2


def test_full_masker_forced_device_route_on_cpu():
    p = (1 << 61) - 1
    rng = np.random.default_rng(4)
    masks = [rng.integers(0, p, size=33, dtype=np.int64) for _ in range(9)]
    dev = FullMasker(p, routing=RoutingPolicy.force("device"), device="cpu").combine(masks)
    assert dev.tolist() == ref_masking.FullMasker(p).combine(masks).tolist()


# ---------------------------------------------------------- device_combine


def _reference_combine(modulus, vectors, chunk_size=256):
    return ref_device_combine(modulus, list(vectors), chunk_size=chunk_size).tolist()


@pytest.mark.parametrize("modulus", [433, 10_000, (1 << 61) - 1, P63],
                         ids=["p433", "even", "p61", "p63"])
def test_device_combine_matches_reference_on_negatives(modulus):
    rng = np.random.default_rng(5)
    vecs = [rng.integers(-modulus + 1, modulus, size=17, dtype=np.int64) for _ in range(11)]
    got = device_combine(modulus, vecs, device="cpu")
    assert got.dtype == np.int64
    assert got.tolist() == _reference_combine(modulus, vecs)
    assert got.tolist() == [sum(int(v[j]) for v in vecs) % modulus for j in range(17)]


def test_device_combine_out_of_domain_takes_the_host_floor_mod(monkeypatch):
    """Only a chunk holding values outside (-p, p) takes the host floor-mod."""
    p = 10_007
    calls = []
    real = engine._host_floor_mod
    monkeypatch.setattr(engine, "_host_floor_mod",
                        lambda arr, m: calls.append(arr.shape) or real(arr, m))
    clean = [np.array([1, -2, 3], dtype=np.int64)] * 4
    hostile = [np.array([-(1 << 63), (1 << 63) - 1, 12_345_678], dtype=np.int64)] + clean[:3]
    got = device_combine(p, clean + hostile, chunk_size=4, device="cpu")
    assert calls == [(4, 3)]
    assert got.tolist() == _reference_combine(p, clean + hostile, chunk_size=4)


def test_device_combine_ragged_tail_and_generator():
    p = P63
    rng = np.random.default_rng(6)
    vecs = [rng.integers(-p + 1, p, size=9, dtype=np.int64) for _ in range(23)]
    want = [sum(int(v[j]) for v in vecs) % p for j in range(9)]

    def gen():
        yield from vecs

    got = device_combine(p, gen(), chunk_size=5, device="cpu")
    assert got.tolist() == want == _reference_combine(p, vecs, chunk_size=5)
    assert device_combine(p, vecs[:3], chunk_size=5, device="cpu").tolist() == (
        _reference_combine(p, vecs[:3], chunk_size=5))


def test_device_combine_guards():
    with pytest.raises(ValueError, match="at least one"):
        device_combine(433, [], device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*63"):
        device_combine(1 << 63, [[1]], device="cpu")


def test_trunc_sub_mod_matches_reference():
    m = P63
    rng = np.random.default_rng(7)
    a = rng.integers(-m + 1, m, size=64, dtype=np.int64)
    b = np.roll(a, 17)
    got = trunc_sub_mod(a, b, m)
    assert got.tolist() == ref_trunc_sub_mod(a, b, m).tolist()
    assert [int(x) for x in got] == [
        (abs(int(x) - int(y)) % m) * (1 if int(x) >= int(y) else -1) for x, y in zip(a, b)]


def _operands(case, m):
    rng = np.random.default_rng(23)
    edges = np.array([0, 1, m - 1], dtype=np.int64)
    canon = np.concatenate([np.repeat(edges, 3), rng.integers(0, m, size=55, dtype=np.int64)])
    other = np.concatenate([np.tile(edges, 3), rng.integers(0, m, size=55, dtype=np.int64)])
    neg = -rng.integers(1, m, size=canon.size, dtype=np.int64)
    return {
        "canonical": (canon, other),
        "canonical_scalar_b": (canon, np.int64(m - 1)),
        "a_negative": (neg, other),
        "b_negative": (canon, neg),
        "both_negative": (neg, np.roll(neg, 5)),
        "empty": (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)),
    }[case]


@pytest.mark.parametrize("case,one_pass", [
    ("canonical", True), ("canonical_scalar_b", True), ("a_negative", False),
    ("b_negative", False), ("both_negative", False), ("empty", False),
])
def test_trunc_sub_mod_one_pass_on_canonical_operands(case, one_pass):
    """Operands both in [0, m), as the unmask's are, take the one-pass
    subtract and count it; any other operands take the sign split. Either
    way the values are the general path's and the reference's, and
    trunc_add_mod's are unchanged."""
    m = P63
    a, b = _operands(case, m)
    before = fields.trunc_sub_canonical_launches
    got = trunc_sub_mod(a, b, m)
    assert fields.trunc_sub_canonical_launches - before == int(one_pass)
    general = trunc_add_mod(a, -np.asarray(b, dtype=np.int64), m)
    assert got.dtype == np.int64 and got.shape == general.shape
    assert got.tolist() == general.tolist() == ref_trunc_sub_mod(a, b, m).tolist()
    want = [(abs(x - y) % m) * (1 if x >= y else -1)
            for x, y in zip(a.tolist(), np.broadcast_to(b, a.shape).tolist())]
    assert got.tolist() == want
    assert trunc_add_mod(a, b, m).tolist() == ref_trunc_add_mod(a, b, m).tolist()


def test_chacha_unmask_takes_int64_as_it_is(monkeypatch):
    """The reveal as int64 and as object ints unmask to the same int64
    values in (-p, p); the int64 one reaches the subtraction uncopied."""
    from sda_tpu_torch import masking

    m = P63
    rng = np.random.default_rng(11)
    masked = np.concatenate([[0, 1, m - 1], rng.integers(0, m, size=61)])
    masker = ChaChaMasker(m, masked.size, 128, device="cpu")
    mask = masker.combine(_seeds_i64(3, 5))
    seen = []
    sub = masking.trunc_sub_mod
    monkeypatch.setattr(masking, "trunc_sub_mod", lambda a, b, mod: seen.append(a) or sub(a, b, mod))
    got = masker.unmask((mask, masked))
    assert np.shares_memory(seen[0], masked)
    from_object = masker.unmask((mask, masked.astype(object)))
    assert got.dtype == from_object.dtype == np.int64
    assert got.tolist() == from_object.tolist()
    assert ((got > -m) & (got < m)).all()
    assert positive(got, m).tolist() == [(int(x) - int(y)) % m for x, y in zip(masked, mask)]
