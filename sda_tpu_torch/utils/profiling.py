"""Device-time measurement and the H100 roofline.

Port of the reference package's ``utils/profiling.py``:

- :func:`cuda_time` times one call on the device, as the median, minimum
  and maximum over several timed calls after warm-up. Each call is
  bracketed by its own pair of CUDA events, so the spread is per call.
- :func:`cuda_time_samples` is the counterpart of the reference's
  ``device_time_samples``: ``samples`` independent windows of ``iters``
  calls each, every call with its own integer (fold it into a seed), and
  the median, minimum and maximum of the windows' per-call times.
  The reference's ``device_time`` and ``device_time_samples`` read a JAX
  profiler trace; these two are their counterparts on CUDA events.
- :func:`device_breakdown` is the reference's per-kernel split: the device
  milliseconds per call of each kernel in a ``torch.profiler`` trace, held
  to the number of calls traced.
- :func:`roofline` turns (bytes, int8 tensor-core operations, 32-bit
  instructions) into the achieved fraction of each of a card's ceilings
  (:class:`CardSpec`; :func:`detect_card` finds the attached card's) and
  names the binding one.
- :func:`card_line` and :func:`max_sm_mhz` read the card's name, power
  limit and maximum SM clock from ``nvidia-smi``.

There is no CPU fallback: a time is a device time or it is not measured.
"""

from __future__ import annotations

import collections
import re
import statistics
import subprocess
import time
from dataclasses import dataclass, replace

import torch

__all__ = [
    "DeviceTiming",
    "cuda_time",
    "cuda_time_samples",
    "device_breakdown",
    "profile_calls",
    "device_activities",
    "trace_problem",
    "kernel_name",
    "roofline",
    "CardSpec",
    "H100_SXM",
    "detect_card",
    "card_line",
    "max_sm_mhz",
    "PEAK_BYTES",
    "PEAK_INT8",
    "SMS",
    "ISSUE_LANES",
    "WARMUP_CALLS",
]

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor-core ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1.979e15
# 32-bit instruction issue: 132 SMs, 4 schedulers each issuing one warp
# instruction (32 lanes) a clock
SMS = 132
ISSUE_LANES = 128
# SM clocks the stream spins before each window of cuda_time_samples,
# and the untimed calls it makes first
_QUEUE_CYCLES = 20_000_000
WARMUP_CALLS = 1
# tiny kernels of the throwaway profiler session before each traced one;
# the sessions profile_calls tries (on an H100, 3 of 50 sessions of config
# 3's B2 call had activities 33-180 us before their launches, and once
# three sessions in a row did); how far (us) a device activity may seem to
# start before its launch (the two clocks' jitter)
_WARMUP_KERNELS = 64
_ATTEMPTS = 6
_LAUNCH_SLACK_US = 10.0


@dataclass(frozen=True)
class DeviceTiming:
    median_ms: float
    min_ms: float
    max_ms: float
    samples_ms: tuple


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device: no CUDA device is available")


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> DeviceTiming:
    """Time ``fn(i)`` on the current CUDA stream. ``fn`` receives a fresh
    integer per call (fold it into a seed so no two calls are the same)."""
    _require_cuda()
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    samples = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(warmup + i)
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop))
    return DeviceTiming(
        median_ms=statistics.median(samples),
        min_ms=min(samples),
        max_ms=max(samples),
        samples_ms=tuple(samples),
    )


def cuda_time_samples(fn, samples: int = 5, iters: int = 3) -> DeviceTiming:
    """Per-call device time over ``samples`` independent windows of
    ``iters`` back-to-back calls, after ``WARMUP_CALLS`` untimed ones: each
    window is bracketed by one pair of events and gives one per-call time
    (its span over ``iters``); returns the median, minimum and maximum of
    the windows. Every call, warm-up included, gets a distinct integer.

    Before each window the stream spins for ``_QUEUE_CYCLES`` SM clocks
    (about 10 ms), so the host has queued the whole window before the card
    reaches it: the span is the card's own time for the calls, not the
    host's time to submit them (which is what a launch of a few
    microseconds would otherwise measure)."""
    _require_cuda()
    for i in range(WARMUP_CALLS):
        fn(i)
    torch.cuda.synchronize()
    per_call = []
    for s in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_QUEUE_CYCLES)
        start.record()
        for i in range(iters):
            fn(WARMUP_CALLS + s * iters + i)
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return DeviceTiming(
        median_ms=statistics.median(per_call),
        min_ms=min(per_call),
        max_ms=max(per_call),
        samples_ms=tuple(per_call),
    )


def device_breakdown(fn, iters: int = 5) -> dict:
    """Per-call device milliseconds of each kernel ``fn`` launches:
    ``{kernel_name: ms}``, largest first. One untraced call, then ``iters``
    calls (``fn(i)``, each with its own integer) under ``torch.profiler``
    with CPU and CUDA activities (:func:`profile_calls`); every device
    activity is summed under its :func:`kernel_name`.

    Raises when no whole trace was taken (:func:`trace_problem`): a kernel
    that ran a whole number of times a call but was recorded fewer times
    has dropped out of the trace, and its sum would read low.
    """
    prof, _ = profile_calls(fn, iters)
    return _breakdown_from_events(device_activities(prof), iters)


def profile_calls(fn, iters: int = 5):
    """``(profile, host seconds)`` of ``iters`` calls ``fn(3000 + i)``
    after one untraced call ``fn(0)``: a ``torch.profiler`` profile (CPU
    and CUDA activities) of the calls and a sync, and the host clock around
    them. Read the profile's ``events()`` or ``key_averages()``.

    Late in a long process a plain session lost the first device
    activities of its trace, though their launches were recorded (on an
    NVIDIA H100 80GB HBM3 at 700 W: none at the start of ``chip_smoke.py``,
    one in 16 after 150 s, eight by its end), and now and then its
    timestamps were off; a session opened with no device work since the
    last one lost none. So each traced session opens right after a
    throwaway one in which the card runs ``_WARMUP_KERNELS`` tiny kernels,
    and the first of up to ``_ATTEMPTS`` sessions whose trace is whole
    (:func:`trace_problem`) is returned. Raises when none is."""
    from torch.profiler import ProfilerActivity, profile

    _require_cuda()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn(0)
    torch.cuda.synchronize()
    for _attempt in range(_ATTEMPTS):
        with profile(activities=activities):
            warm = torch.zeros(1, device=torch.cuda.current_device())
            for _ in range(_WARMUP_KERNELS):
                warm.add_(1)
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(iters):
                fn(3000 + i)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        problem = trace_problem(device_activities(prof), _launch_starts(prof), iters)
        if problem is None:
            return prof, seconds
    raise RuntimeError(f"no whole profiler trace in {_ATTEMPTS} sessions: {problem}")


def device_activities(prof) -> list:
    """``(name, start us, end us, correlation id)`` of every device activity
    in a finished profile, without the profiler's annotations of user
    ranges."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end, e.id) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def _launch_starts(prof) -> dict:
    """``{correlation id: start us}`` of the CUDA runtime and driver calls
    in a finished profile (``cudaLaunchKernel``, ``cudaMemsetAsync``, ...)."""
    from torch.autograd import DeviceType

    return {e.id: e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("cu")}


def trace_problem(activities, launches: dict, iters: int) -> str | None:
    """What is wrong with the trace of ``iters`` calls, or ``None``: no
    device activity; a kernel name whose count is not a multiple of
    ``iters``; or an activity that starts more than ``_LAUNCH_SLACK_US``
    before the runtime call that launched it (``launches``, by correlation
    id), which the device cannot do: the trace's clock is off."""
    count = collections.Counter(kernel_name(name) for name, *_ in activities)
    if not count:
        return "the trace holds no device activity"
    off = {name: n for name, n in count.items() if n % iters}
    if off:
        return (f"device activities recorded a number of times that is not a multiple of the "
                f"{iters} calls traced (a call dropped out of the trace): "
                + ", ".join(f"{name} {n}" for name, n in sorted(off.items())))
    early = [launches[corr] - start for _, start, _, corr in activities
             if corr in launches and start < launches[corr] - _LAUNCH_SLACK_US]
    if early:
        return (f"{len(early)} device activities start before the call that launched them, by up "
                f"to {max(early):.1f} us")
    return None


def kernel_name(name: str) -> str:
    """A device activity's short name: a kernel's bare function name,
    without its return type, namespaces, template arguments and parameters
    (``void mxu8_fused_kernel<4, true>(...)`` reads ``mxu8_fused_kernel``),
    or a copy's or memset's kind (``Memset``)."""
    plain = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", plain, maxsplit=1)[0].split("::")[-1].strip()


def _breakdown_from_events(activities, iters: int) -> dict:
    """``{kernel_name: ms per call}``, largest first, from the device
    activities (:func:`device_activities`) of ``iters`` calls; raises on a
    trace that :func:`trace_problem` refuses for its counts."""
    problem = trace_problem(activities, {}, iters)
    if problem is not None:
        raise RuntimeError(problem)
    total_us = collections.Counter()
    for name, start, end, _ in activities:
        total_us[kernel_name(name)] += end - start
    return {name: us / 1e3 / iters for name, us in total_us.most_common()}


@dataclass(frozen=True)
class CardSpec:
    """Peak ceilings of one card (data-sheet numbers, dense)."""

    name: str
    hbm_bytes_per_s: float
    int8_ops_per_s: float
    sms: int
    issue_lanes: int  # 32-bit instructions an SM issues a clock (4 schedulers x 32 lanes)


H100_SXM = CardSpec(name="NVIDIA H100 SXM", hbm_bytes_per_s=PEAK_BYTES,
                    int8_ops_per_s=PEAK_INT8, sms=SMS, issue_lanes=ISSUE_LANES)

# what torch.cuda.get_device_name() says of each card in the table, lower case
_CARD_SPECS = {
    "h100 80gb hbm3": H100_SXM,
    "h100 sxm": H100_SXM,
}


def detect_card(name: str | None = None) -> CardSpec:
    """The :class:`CardSpec` of the card named ``name``, or of the attached
    card (``torch.cuda.get_device_name()``) when ``name`` is None.

    The longest key of the table found in the name wins. An unknown card
    keeps its name with "(unknown; H100 SXM ceilings)" appended, so that
    fractions reported against it are visibly approximate."""
    if name is None:
        _require_cuda()
        name = torch.cuda.get_device_name()
    kind = name.lower()
    keys = [key for key in _CARD_SPECS if key in kind]
    if keys:
        return _CARD_SPECS[max(keys, key=len)]
    return replace(H100_SXM, name=f"{name} (unknown; H100 SXM ceilings)")


def roofline(seconds: float, hbm_bytes: float = 0.0, int8_ops: float = 0.0,
             int32_ops: float = 0.0, sm_mhz: float | None = None,
             card: CardSpec | None = None) -> dict:
    """Achieved fraction of each of ``card``'s ceilings (the H100 SXM's when
    None) and the binding one: bytes over the HBM rate, int8 tensor-core
    operations (a multiply-add counts 2) over the int8 rate, 32-bit
    instructions over SMs x issue lanes x the maximum SM clock (``sm_mhz``,
    read from the card when not given and only when ``int32_ops`` is
    non-zero)."""
    card = card or H100_SXM
    if int32_ops and sm_mhz is None:
        sm_mhz = max_sm_mhz()
    floors = {
        "hbm": hbm_bytes / card.hbm_bytes_per_s,
        "int8": int8_ops / card.int8_ops_per_s,
        "int32": int32_ops / (card.sms * card.issue_lanes * sm_mhz * 1e6) if int32_ops else 0.0,
    }
    floor_s = max(floors.values())
    return {
        "card": card.name,
        "seconds": seconds,
        "utilization": {k: v / seconds if seconds else 0.0 for k, v in floors.items()},
        "binding_resource": max(floors, key=floors.get),
        "speed_of_light_s": floor_s,
        "fraction_of_sol": floor_s / seconds if seconds else 0.0,
    }


def _nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    return _nvidia_smi("name,power.limit")


def max_sm_mhz() -> float:
    """The card's maximum SM clock in MHz."""
    return float(_nvidia_smi("clocks.max.sm", units=False))
