"""The 728-clerk committee of ``FederatedAggregation.packed_tss728`` (the
threshold-secret-sharing crate's packed example: 100 secrets, threshold
155, p = 746,497) on the CPU at d = 1,000: the per-clerk shares against the
plain reference of the benchmark, the reveal from any 255 clerks, and the
plans that stay on the narrow kernel."""

import numpy as np
import pytest
import torch

from benchmark.reference.packed_shamir import PackedShamir
from sda_tpu.sharing import PackedShamirScheme as RefScheme
from sda_tpu_torch import engine as engine_mod
from sda_tpu_torch.models import FederatedAggregation
from sda_tpu_torch.ops import mxu8 as m8
from sda_tpu_torch.sharing import PackedShamirScheme
from sda_tpu_torch.utils.errors import Invalid

D, LANES = 1000, 128
SCHEME = dict(secret_count=100, share_count=728, privacy_threshold=155, prime_modulus=746_497,
              omega_secrets=95_660, omega_shares=610_121)


@pytest.fixture(scope="module")
def eng():
    return FederatedAggregation.packed_tss728(dimension=D, device="cpu").engine


@pytest.fixture(scope="module")
def streamed(eng):
    """Two chunks of two participants' values below 2^19, their planar
    bytes and the sum mod p they owe."""
    rng = np.random.default_rng(22)
    vals = [rng.integers(0, 1 << 19, size=(2, D)) for _ in range(2)]
    chunks = [eng.planar8_secrets(eng.encode_secrets(v), LANES) for v in vals]
    return chunks, sum(v.sum(axis=0) for v in vals) % eng.spec.modulus


def _reveal(eng, out) -> np.ndarray:
    return np.asarray(eng.decode_output(out), dtype=np.int64)


def test_the_scheme_is_the_published_one(eng):
    s = eng.spec
    assert (s.modulus, s.secret_count, s.share_count, s.randomness_count) == (746_497, 100, 728,
                                                                              155)
    assert (s.omega_secrets, s.omega_shares) == (95_660, 610_121)
    assert eng.mxu8.special is None and eng.mxu8.L16r == 6  # a generic prime's fold


def test_combined_shares_equal_the_plain_reference(eng):
    """Three participants with the caller's randomness: the clerks' combined
    shares from the byte-limb plain version equal the reference sharing's
    sums."""
    ref = PackedShamir(SCHEME["prime_modulus"], 100, 728, 155, 95_660, 610_121)
    gen = torch.Generator().manual_seed(3)
    P, nb, p = 3, eng.nb, ref.p
    secrets = torch.randint(0, 1 << 19, (P, nb * 100), generator=gen, dtype=torch.int64)
    secrets[:, D:] = 0
    rand = torch.randint(0, p, (P, nb, 155), generator=gen, dtype=torch.int64)
    ext = torch.cat([eng.ctx.encode_i64(secrets.reshape(P, nb, 100).numpy(), "cpu"),
                     eng.ctx.encode_i64(rand.numpy(), "cpu")], dim=2)
    comb = eng.mxu8_kernel_combined(eng.planar8_ext(ext, LANES), 0, P, LANES)  # [L * n, NBP]
    got = (comb[:728].to(torch.int64) + (comb[728:].to(torch.int64) << 16))[:, :nb].T  # [nb, n]
    want = sum(ref.share(secrets[i].reshape(nb, 100), rand[i]) for i in range(P)) % p
    assert torch.equal(got, want)


def test_threshold_reveal_from_any_255(eng, streamed):
    chunks, want = streamed
    before = engine_mod.subset_reconstruct_launches
    rng = np.random.default_rng(8)
    subsets = [sorted(rng.choice(728, 255, replace=False).tolist()) for _ in range(3)]
    for clerks in subsets + [list(range(728))]:
        out = eng.aggregate_mxu8_kernel_streaming(chunks, 2, seed0=9, lanes=LANES, clerks=clerks)
        assert np.array_equal(_reveal(eng, out), want)
    assert engine_mod.subset_reconstruct_launches == before + 4
    full = eng.aggregate_mxu8_kernel_streaming(chunks, 2, seed0=9, lanes=LANES)
    assert np.array_equal(_reveal(eng, full), want)


def test_threshold_reveal_through_the_mesh(eng, streamed):
    """``aggregate_mxu8_degraded`` delegates to the engine's threshold
    reconstruction: a world of one on the CPU."""
    import torch.distributed as dist

    from sda_tpu_torch.parallel import ShardedAggregationPipeline, make_mesh

    chunks, want = streamed
    clerks = sorted(np.random.default_rng(9).choice(728, 255, replace=False).tolist())
    try:
        pipe = ShardedAggregationPipeline(eng, make_mesh({"p": 1, "d": 1, "c": 1}, "cpu"))
        out = pipe.aggregate_mxu8_streaming(chunks, seed0=4, indices=clerks)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(_reveal(eng, out[: eng.nb]), want)


def test_fewer_than_255_clerks_raise(eng, streamed):
    chunks, _ = streamed
    with pytest.raises(Invalid, match="Not enough shares"):
        eng.aggregate_mxu8_kernel_streaming(chunks, 2, lanes=LANES, clerks=list(range(254)))
    with pytest.raises(Invalid, match="duplicate"):
        eng.reconstruct_planar8(torch.zeros((2 * 728, LANES), dtype=torch.int32), LANES,
                                clerks=[0] * 255)


def test_int64_subset_matrix_equals_the_object_one(eng):
    """The int64 subset Lagrange matrix, which the engine's plans and the
    scheme's ``reconstruct_matrix`` both take, against the reference
    package's in Python ints."""
    clerks = sorted(np.random.default_rng(10).choice(728, 255, replace=False).tolist())
    fast = eng.spec.subset_matrix(clerks)
    assert fast.dtype == np.int64
    want = np.asarray(RefScheme(**SCHEME).reconstruct_matrix(clerks), dtype=object)
    assert fast.tolist() == want.tolist()
    assert np.array_equal(PackedShamirScheme(**SCHEME).reconstruct_matrix(clerks), fast)


def test_the_mesh_refuses_another_subset_matrix(eng, streamed):
    """The mesh takes the reference pipeline's ``subset_matrix`` only when
    it is the scheme's own for the clerks."""
    import torch.distributed as dist

    from sda_tpu_torch.parallel import ShardedAggregationPipeline, make_mesh

    chunks, _ = streamed
    clerks = list(range(255))
    other = eng.spec.subset_matrix(list(range(1, 256)))
    try:
        pipe = ShardedAggregationPipeline(eng, make_mesh({"p": 1, "d": 1, "c": 1}, "cpu"))
        with pytest.raises(ValueError, match="not the scheme's Lagrange matrix"):
            pipe.aggregate_mxu8_streaming(chunks, seed0=4, indices=clerks, subset_matrix=other)
    finally:
        dist.destroy_process_group()


def test_subset_plans_are_kept_least_recently_used(eng):
    plans = [eng.subset_plan(tuple(range(i, i + 255)), torch.device("cpu"))
             for i in range(engine_mod.SUBSET_PLANS + 1)]
    assert len(eng._subset_plans) == engine_mod.SUBSET_PLANS
    assert eng.subset_plan(tuple(range(1, 256)), torch.device("cpu")) is plans[1]
    assert (tuple(range(0, 255)), torch.device("cpu")) not in eng._subset_plans


def test_narrow_plans_keep_their_kernel(eng):
    """An 8-clerk plan (65 output rows) stays on B1/B3; the 728-clerk plan
    (2,913 rows) and its reconstruction (401) take the wide variant."""
    narrow = FederatedAggregation.packed_64bit(dimension=30, device="cpu").engine
    plan = narrow._plan("combine", 4 * 3 * 8, 4, torch.device("cpu"))
    assert not m8.is_wide(plan)
    assert (m8._variant(plan, False), m8._variant(plan, True)) == ("mxu8_fused", "mxu8_acc")
    wide = eng._plan("combine", 2 * 100 * 4, 2, torch.device("cpu"))
    rec = eng.subset_plan(tuple(range(255)), torch.device("cpu"))
    assert m8.is_wide(wide) and m8.is_wide(rec)
    assert m8._variant(wide, True) == m8._variant(rec, False) == "mxu8_wide"
    assert wide.period == 400 and wide.n * wide.mxu8.L8 + 1 == 2913
