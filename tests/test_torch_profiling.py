"""The port's card spec and per-kernel breakdown
(``sda_tpu_torch.utils.profiling``) against the reference's chip spec and
roofline (``sda_tpu.utils.profiling``).

- ``detect_card`` finds the H100 SXM by the name the card reports, and an
  unknown card keeps its name with the H100 SXM's ceilings, as the
  reference's ``detect_chip`` does for chips;
- ``roofline(card=H100_SXM)`` gives today's numbers for the headline's
  bytes and operations (the bound ``chip_smoke.py`` prints, 1.8420 ms), and
  the reference's roofline on a chip spec with the same ceilings agrees;
- ``_breakdown_from_events`` sums, sorts and demangles, and raises on an
  empty trace and on a count that is not a multiple of the calls traced;
- ``trace_problem`` also refuses a trace whose activity starts before the
  runtime call that launched it (beyond the clocks' jitter);
- ``device_breakdown``, ``profile_calls`` and ``detect_card()`` raise
  with no card.
"""

import pytest
import torch

from sda_tpu_torch.utils import profiling
from sda_tpu_torch.utils.profiling import H100_SXM, CardSpec, detect_card, roofline


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"])
def test_detect_card_finds_the_h100_sxm(name):
    assert detect_card(name) is H100_SXM


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-40GB", "NVIDIA H100 PCIe"])
def test_detect_card_keeps_an_unknown_cards_name(name):
    card = detect_card(name)
    assert card.name == f"{name} (unknown; H100 SXM ceilings)"
    assert (card.hbm_bytes_per_s, card.int8_ops_per_s, card.sms, card.issue_lanes) == (
        H100_SXM.hbm_bytes_per_s, H100_SXM.int8_ops_per_s, H100_SXM.sms, H100_SXM.issue_lanes)


def test_card_spec_holds_the_constants_in_use():
    assert H100_SXM == CardSpec("NVIDIA H100 SXM", profiling.PEAK_BYTES, profiling.PEAK_INT8,
                                profiling.SMS, profiling.ISSUE_LANES)
    assert (H100_SXM.hbm_bytes_per_s, H100_SXM.int8_ops_per_s) == (3.35e12, 1.979e15)
    assert (H100_SXM.sms, H100_SXM.issue_lanes) == (132, 128)


def test_roofline_on_the_card_spec_gives_the_headline_bound():
    """The headline launch (768 x 1,000,002 at p = 2^63 - 871, lanes 1024):
    its bytes and int8 operations from the plan give 1.8420 ms (bytes),
    with or without the card spec named, and the Philox term on the card's
    issue rate as chip_smoke.py counts it."""
    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.tools._common import bound, mxu8_cost

    engine = FederatedAggregation.packed_64bit(dimension=1_000_002, device="cpu").engine
    rows = 768 * engine.spec.secret_count * engine.mxu8.L8
    nbp = -(-engine.nb // 1024) * 1024
    nbytes, ops = mxu8_cost(engine._plan("share", rows, 768, engine.device), nbp)
    rep = roofline(1e-3, hbm_bytes=nbytes, int8_ops=ops, card=H100_SXM)
    assert rep == roofline(1e-3, hbm_bytes=nbytes, int8_ops=ops)
    assert rep["card"] == "NVIDIA H100 SXM" and rep["binding_resource"] == "hbm"
    assert rep["speed_of_light_s"] == nbytes / 3.35e12
    assert f"{rep['speed_of_light_s'] * 1e3:.4f}" == "1.8420"
    assert bound([(nbytes, ops)]) == (rep["speed_of_light_s"] * 1e3, "bytes")
    int32 = roofline(1e-3, int32_ops=45 * 1e9, sm_mhz=1980.0, card=H100_SXM)
    assert int32["speed_of_light_s"] == 45 * 1e9 / (132 * 128 * 1980.0 * 1e6)


def test_roofline_agrees_with_the_reference_on_equal_ceilings():
    from sda_tpu.utils.profiling import ChipSpec
    from sda_tpu.utils.profiling import roofline as ref_roofline

    chip = ChipSpec(name="same ceilings", hbm_gbps=3350.0, int8_tops=1979.0, vpu_gops=1.0)
    for hbm, ops in ((6.17e9, 2.0e12), (1.0e6, 1.9e15)):
        want = ref_roofline(2e-3, hbm_bytes=hbm, mxu_int8_ops=ops, chip=chip)
        got = roofline(2e-3, hbm_bytes=hbm, int8_ops=ops, card=H100_SXM)
        assert got["speed_of_light_s"] == pytest.approx(want["speed_of_light_s"], rel=1e-12)
        assert round(got["fraction_of_sol"], 4) == want["fraction_of_sol"]
        assert {"hbm": "hbm", "int8": "mxu_int8"}[got["binding_resource"]] == \
            want["binding_resource"]


def test_breakdown_sums_sorts_and_demangles():
    events = [
        ("void mxu8_fused_kernel<4>(signed char const*, Params)", 0.0, 5000.0, 1),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >"
         "(int, at::native::FillFunctor<int>, at::detail::Array<char*, 1>)", 5000.0, 5010.0, 2),
        ("Memset (Device)", 5010.0, 5012.0, 3),
        ("void (anonymous namespace)::mxu8_fused_kernel<1>(signed char const*)", 6000.0, 6300.0,
         4),
    ] * 5
    got = profiling._breakdown_from_events(events, 5)
    assert list(got) == ["mxu8_fused_kernel", "vectorized_elementwise_kernel", "Memset"]
    assert got == {"mxu8_fused_kernel": pytest.approx(5.3),
                   "vectorized_elementwise_kernel": pytest.approx(0.01),
                   "Memset": pytest.approx(0.002)}
    assert profiling.kernel_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_breakdown_raises_on_a_count_that_is_not_a_multiple_of_the_calls():
    # five calls of a step that launches the kernel twice, one call's pair
    # missing from the trace: the under-read the check exists for
    pair = [("void mxu8_fused_kernel<4>(Params)", 0.0, 4900.0, 1),
            ("void mxu8_fused_kernel<1>(Params)", 4900.0, 5200.0, 2)]
    memsets = [("Memset (Device)", 0.0, 2.0, 3)] * 5
    with pytest.raises(RuntimeError, match="mxu8_fused_kernel 8"):
        profiling._breakdown_from_events(pair * 4 + memsets, 5)
    whole = profiling._breakdown_from_events(pair * 5 + memsets, 5)
    assert whole["mxu8_fused_kernel"] == pytest.approx(5.2)
    with pytest.raises(RuntimeError, match="no device activity"):
        profiling._breakdown_from_events([], 5)


def test_trace_problem_refuses_an_activity_before_its_launch():
    name = "void mxu8_fused_kernel<4>(Params)"
    launches = {11: 100.0, 12: 5300.0, 99: 0.0}
    good = [(name, 120.0, 5220.0, 11), (name, 5300.5, 10400.0, 12)]
    assert profiling.trace_problem(good, launches, 2) is None
    jitter = [(name, 95.0, 5100.0, 11), good[1]]  # 5 us early: the clocks' jitter
    assert profiling.trace_problem(jitter, launches, 2) is None
    early = [(name, -94.0, 4883.0, 11), good[1]]  # 194 us before its launch
    assert "1 device activities start before the call that launched them, by up to 194.0" \
        in profiling.trace_problem(early, launches, 2)
    assert "not a multiple" in profiling.trace_problem(good[:1], launches, 2)
    assert profiling.trace_problem([(name, 0.0, 1.0, None)], {}, 1) is None  # no launch known


def test_breakdown_and_detection_need_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_breakdown(lambda i: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.profile_calls(lambda i: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_card()
