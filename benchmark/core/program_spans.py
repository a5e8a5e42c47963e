"""The program's own spans in a traced run, and what they say.

``sda_tpu_torch`` names the phases of its round with ``utils.logging.span``
(``sda.<module>.<phase>``): ``torch.profiler`` ranges on the host, on the
clock of the card's activities, each inside the span that encloses it. Here
they are read beside a :class:`benchmark.core.trace.TraceReading`: a
span's self time, and the card's idle time split by the innermost span the
host was in. The traced rounds do not collect them yet (§ 7 of PERF.md); a
program without spans leaves both empty.
"""

from __future__ import annotations

import collections

PREFIX = "sda."
OUTSIDE = "outside"


def program_ranges(prof) -> list:
    """The host ranges of a finished profiler session whose names start
    with ``sda.``: ``(name, start, end)`` in microseconds."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]


def _union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def self_seconds(ranges: list, name: str) -> float:
    """The summed self time of the ranges named ``name``: each one's length
    less the part of it that the other ranges inside it cover."""
    total = 0.0
    for rng in ranges:
        n, s, e = rng
        if n == name:
            inner = [(rs, re) for rn, rs, re in ranges
                     if (rn, rs, re) != rng and s <= rs and re <= e]
            total += (e - s) - _union(inner)
    return total / 1e6


def seconds(ranges: list, name: str) -> float:
    """The summed length of the ranges named ``name``."""
    return sum(e - s for n, s, e in ranges if n == name) / 1e6


def idle_by_span(reading, ranges: list, within: list | None = None) -> dict:
    """The card's idle seconds in the reading's window, by the innermost
    program range open over each idle stretch, split where ranges start or
    end; :data:`OUTSIDE` where none is. ``within``: ``(start, end)``
    intervals that bound the count (the benchmark's call spans), else the
    whole window."""
    w = reading.window
    if w is None:
        return {}
    edges = [w[0]] + [t for iv in reading._busy() for t in iv] + [w[1]]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    if within is not None:
        idle = [(max(s, ws), min(e, we)) for s, e in idle for ws, we in within
                if min(e, we) > max(s, ws)]
    cuts = sorted({t for _, s, e in ranges for t in (s, e)})
    out: dict = collections.defaultdict(float)
    for s, e in idle:
        points = [s] + [t for t in cuts if s < t < e] + [e]
        for a, b in zip(points, points[1:]):
            open_ = [(re - rs, rn) for rn, rs, re in ranges if rs <= a and b <= re]
            out[min(open_)[1] if open_ else OUTSIDE] += (b - a) / 1e6
    return dict(out)
