"""Device-time measurement on the card with CUDA events.

Port of the reference package's ``utils/profiling.py``, reduced to what the
port measures so far: the time of one call on the device, as the median,
minimum and maximum over several timed calls after warm-up. Each call is
bracketed by its own pair of events, so the spread is per call. There is
no CPU fallback: a time is a device time or it is not measured.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import torch

__all__ = ["DeviceTiming", "cuda_time"]


@dataclass(frozen=True)
class DeviceTiming:
    median_ms: float
    min_ms: float
    max_ms: float
    samples_ms: tuple


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> DeviceTiming:
    """Time ``fn(i)`` on the current CUDA stream. ``fn`` receives a fresh
    integer per call (fold it into a seed so no two calls are the same)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
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
