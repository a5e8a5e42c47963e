"""Device-time measurement and the H100 roofline.

Port of the reference package's ``utils/profiling.py``:

- :func:`cuda_time` times one call on the device, as the median, minimum
  and maximum over several timed calls after warm-up. Each call is
  bracketed by its own pair of CUDA events, so the spread is per call.
- :func:`cuda_time_samples` is the counterpart of the reference's
  ``device_time_samples``: ``samples`` independent windows of ``iters``
  calls each, every call with its own integer (fold it into a seed), and
  the median, minimum and maximum of the windows' per-call times.
- :func:`roofline` turns (bytes, int8 tensor-core operations, 32-bit
  instructions) into the achieved fraction of each of the card's ceilings
  and names the binding one.
- :func:`card_line` and :func:`max_sm_mhz` read the card's name, power
  limit and maximum SM clock from ``nvidia-smi``.

There is no CPU fallback: a time is a device time or it is not measured.
"""

from __future__ import annotations

import statistics
import subprocess
from dataclasses import dataclass

import torch

__all__ = [
    "DeviceTiming",
    "cuda_time",
    "cuda_time_samples",
    "roofline",
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


def roofline(seconds: float, hbm_bytes: float = 0.0, int8_ops: float = 0.0,
             int32_ops: float = 0.0, sm_mhz: float | None = None) -> dict:
    """Achieved fraction of each H100 ceiling and the binding one: bytes
    over 3.35 TB/s, int8 tensor-core operations (a multiply-add counts 2)
    over 1,979 TOPS, 32-bit instructions over 132 SMs x 128 lanes x the
    maximum SM clock (``sm_mhz``, read from the card when not given and
    only when ``int32_ops`` is non-zero)."""
    if int32_ops and sm_mhz is None:
        sm_mhz = max_sm_mhz()
    floors = {
        "hbm": hbm_bytes / PEAK_BYTES,
        "int8": int8_ops / PEAK_INT8,
        "int32": int32_ops / (SMS * ISSUE_LANES * sm_mhz * 1e6) if int32_ops else 0.0,
    }
    floor_s = max(floors.values())
    return {
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
