"""The port's spans (``utils.logging.span``): off, a shared no-op; under
``torch.profiler``, named ranges of one small recipient round, each inside
its parent, and the round's answers the same either way."""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sda_tpu_torch.masking import ChaChaMasker
from sda_tpu_torch.models import FederatedAggregation
from sda_tpu_torch.ops import chacha_kernel as ck
from sda_tpu_torch.ops import cuda_build
from sda_tpu_torch.routing import RoutingPolicy
from sda_tpu_torch.utils.logging import span

D, P, LANES = 40, 4, 8
# each span's parent: the innermost program span whose interval holds it
# (a plan is built in the call that first needs it)
PARENT = {
    "sda.engine.aggregate": None,
    "sda.mxu8.plan": ("sda.engine.aggregate", "sda.engine.reconstruct"),
    "sda.engine.reconstruct": "sda.engine.aggregate",
    "sda.masking.combine": None,
    "sda.chacha.keys": "sda.masking.combine",
    "sda.chacha.fold": "sda.masking.combine",
    "sda.chacha.wait": "sda.masking.combine",
    "sda.chacha.recombine": "sda.masking.combine",
    "sda.engine.decode": None,
    "sda.engine.decode.wait": "sda.engine.decode",
    "sda.engine.decode.to_object": "sda.engine.decode",
    "sda.masking.unmask": None,
    "sda.masking.unmask.from_object": "sda.masking.unmask",
    "sda.masking.unmask.sub": "sda.masking.unmask",
}
ROUND = {"sda.engine.aggregate", "sda.mxu8.plan", "sda.masking.combine", "sda.chacha.keys",
         "sda.engine.decode", "sda.engine.decode.wait", "sda.engine.decode.to_object",
         "sda.masking.unmask", "sda.masking.unmask.from_object", "sda.masking.unmask.sub"}
ROUTES = {
    "host": {"sda.chacha.recombine"},
    "chunk": {"sda.chacha.wait", "sda.chacha.recombine"},
    "fused": {"sda.chacha.fold", "sda.chacha.wait", "sda.chacha.recombine"},
}


def _cuda_by_default(device=None):
    """``resolve_device`` on a machine that has a card (none is touched)."""
    return torch.device("cuda" if device is None else device)


_REAL_FOLD = ck.fold_masks_device


def _fold_on_cpu(seed_words, dimension, modulus, device=None):
    assert torch.device(device).type == "cuda"
    return _REAL_FOLD(seed_words, dimension, modulus, device="cpu")


def _masker(route, modulus):
    if route == "host":
        return ChaChaMasker(modulus, D, 128, device="cpu")
    return ChaChaMasker(modulus, D, 128, routing=RoutingPolicy.force("device"),
                        device="cuda" if route == "fused" else "cpu")


def _round(route, streaming=False):
    """One recipient round at a tiny size: a fresh engine (so its plan is
    built), the aggregation, the seeds' combine by ``route``, decode and
    unmask. The fused route needs 512 seeds; its fold runs the plain
    version."""
    eng = FederatedAggregation.packed_64bit(dimension=D, device="cpu").engine
    rng = np.random.default_rng(7)
    sec8 = eng.planar8_secrets(eng.encode_secrets(rng.integers(0, 1 << 62, size=(P, D))), LANES)
    seeds = [rng.integers(0, 1 << 32, size=4).astype(np.int64)
             for _ in range(512 if route == "fused" else 6)]
    masker = _masker(route, eng.spec.modulus)
    with mock.patch.object(ck, "resolve_device", _cuda_by_default), \
            mock.patch.object(ck, "fold_masks_device", _fold_on_cpu):
        if streaming:
            out = eng.aggregate_mxu8_kernel_streaming([sec8, sec8], P, seed0=3, lanes=LANES)
        else:
            out = eng.aggregate_mxu8_kernel(sec8, 3, p_count=P, lanes=LANES)
        mask = masker.combine(seeds)
    vals = eng.decode_output(out)
    return masker.unmask((mask, vals))


def _program_ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("sda.")]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    return got, _program_ranges(prof)


def _parent(rng, ranges):
    """The innermost other range whose interval holds ``rng``."""
    name, s, e = rng
    holding = [(re - rs, rn) for rn, rs, re in ranges
               if (rn, rs, re) != rng and rs <= s and e <= re]
    return min(holding)[1] if holding else None


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    off = span("sda.test.a")
    assert off is span("sda.test.b")
    with off:
        pass
    _round("host")


def test_on_a_span_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("sda.test.outer"):
            with span("sda.test.inner"):
                pass
    ranges = _program_ranges(prof)
    assert [r[0] for r in ranges].count("sda.test.inner") == 1
    (inner,) = [r for r in ranges if r[0] == "sda.test.inner"]
    assert _parent(inner, ranges) == "sda.test.outer"
    assert span("sda.test.after") is span("sda.test.again")


@pytest.mark.parametrize("streaming", [False, True], ids=["single", "streaming"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_round_records_its_spans_inside_their_parents(route, streaming):
    _, ranges = _traced(lambda: _round(route, streaming))
    names = {r[0] for r in ranges}
    want = ROUND | ROUTES[route] | ({"sda.engine.reconstruct"} if streaming else set())
    assert names == want
    for rng in ranges:
        parent = PARENT[rng[0]]
        assert _parent(rng, ranges) in (parent if isinstance(parent, tuple) else (parent,)), rng
    # one span of each call: the engine's and the masker's calls
    for top in ("sda.engine.aggregate", "sda.masking.combine", "sda.engine.decode",
                "sda.masking.unmask"):
        assert [r[0] for r in ranges].count(top) == 1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_round_answers_the_same_traced_or_not(route):
    plain = _round(route, streaming=True)
    traced, ranges = _traced(lambda: _round(route, streaming=True))
    assert ranges
    assert plain.dtype == traced.dtype == np.int64
    assert np.array_equal(plain, traced)


def test_a_kernel_library_is_spanned_only_when_it_loads(monkeypatch, tmp_path):
    lib = tmp_path / "chacha_0.so"
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build_kernel_libraries", lambda variants: [lib])
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("loaded", path))
    got, ranges = _traced(lambda: [cuda_build.load_kernel_library("chacha.cu")
                                   for _ in range(3)])
    assert got == [("loaded", str(lib))] * 3
    assert [r[0] for r in ranges] == ["sda.kernel.load"]


def test_a_threshold_reveal_records_its_subset_spans():
    """A reveal from 7 of 8 clerks: its finish in
    ``sda.engine.reconstruct.subset`` inside the reconstruction, the subset
    plan's build in ``sda.sharing.lagrange`` inside that on a miss only, and
    ``subset_reconstruct_launches`` counting each finish."""
    from sda_tpu_torch import engine as engine_mod

    eng = FederatedAggregation.packed_64bit(dimension=D, device="cpu").engine
    sec8 = eng.planar8_secrets(eng.encode_secrets(
        np.random.default_rng(7).integers(0, 1 << 62, size=(P, D))), LANES)

    def reveal(clerks=None):
        out = eng.aggregate_mxu8_kernel_streaming([sec8, sec8], P, seed0=3, lanes=LANES,
                                                  clerks=clerks)
        return eng.decode_output(out)

    clerks = [0, 1, 2, 4, 5, 6, 7]
    before = engine_mod.subset_reconstruct_launches
    got, first = _traced(lambda: reveal(clerks))
    again, second = _traced(lambda: reveal(clerks))
    assert engine_mod.subset_reconstruct_launches == before + 2
    assert np.array_equal(got, reveal()) and np.array_equal(got, again)
    names = [r[0] for r in first]
    assert names.count("sda.engine.reconstruct.subset") == names.count("sda.sharing.lagrange") == 1
    for rng in first:
        if rng[0] == "sda.engine.reconstruct.subset":
            assert _parent(rng, first) == "sda.engine.reconstruct"
        if rng[0] == "sda.sharing.lagrange":
            assert _parent(rng, first) == "sda.engine.reconstruct.subset"
    names = [r[0] for r in second]
    assert "sda.sharing.lagrange" not in names and "sda.engine.reconstruct.subset" in names


def test_the_launch_counters_name_the_wide_variant():
    """``mxu8_wide_launches`` and ``subset_reconstruct_launches`` are module
    integers named ``*_launches``, so the benchmark's ``routes:`` line
    prints them; the plain version on the CPU launches nothing."""
    from sda_tpu_torch import engine as engine_mod
    from sda_tpu_torch.ops import mxu8 as m8

    assert type(m8.mxu8_wide_launches) is int
    assert type(engine_mod.subset_reconstruct_launches) is int
    before = m8.mxu8_wide_launches
    _round("host", streaming=True)
    assert m8.mxu8_wide_launches == before
