"""The traced rounds: a ``torch.profiler`` trace of a few rounds and what the
per-layer metrics read from it.

The session handling is a copy of the program's ``utils/profiling.py``
(``profile_calls``, ``device_activities``, ``trace_problem``,
``kernel_name``), kept here so that the yardstick does not move with the
program: late in a long process a plain session lost the first device
activities of its trace, so each traced session opens right after a
throwaway one, and a trace whose counts are not whole, or whose activities
start before their launches, is taken again; where no attempt gives a whole
trace, the run is refused.
"""

from __future__ import annotations

import collections
import re
import sys
import time
from dataclasses import dataclass, field

import torch

_WARMUP_KERNELS = 64
_ATTEMPTS = 4
_LAUNCH_SLACK_US = 10.0
ROUND = "round"


class Spans:
    """The benchmark's own spans around its calls into the program's layers.
    Off, they cost nothing; on, each is a profiler range that ends with a
    device synchronize, and its host-clock length is kept by name."""

    def __init__(self, traced: bool, device=None):
        self.traced = traced
        self.sync = traced and device is not None and torch.device(device).type == "cuda"
        self.seconds: dict[str, list[float]] = collections.defaultdict(list)

    def __call__(self, name: str):
        return _Span(self, name) if self.traced else _NO_SPAN


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.spans.sync and exc[0] is None:
            torch.cuda.synchronize()
        self.spans.seconds[self.name].append(time.perf_counter() - self.t0)
        self.range.__exit__(*exc)
        return False


def kernel_name(name: str) -> str:
    """A device activity's short name: a kernel's bare function name, or a
    copy's or memset's kind."""
    plain = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", plain, maxsplit=1)[0].split("::")[-1].strip()


def _activities(prof, labels) -> list:
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end, e.id) for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name not in labels
            and not getattr(e, "is_user_annotation", False)]


def _launch_starts(prof) -> dict:
    from torch.autograd import DeviceType

    return {e.id: e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("cu")}


def _ranges(prof, labels) -> list:
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name in labels]


class TraceRefused(RuntimeError):
    """No attempt gave a whole trace: nothing is read from a broken one."""


def trace_problem(activities, launches: dict, rounds: int, device: bool = True) -> str | None:
    """What makes a trace of ``rounds`` rounds not whole, or ``None``.
    ``device``: the rounds ran on a card, so the trace must hold its work."""
    count = collections.Counter(kernel_name(a[0]) for a in activities)
    if not count:
        return "the trace holds no device activity" if device else None
    off = {name: n for name, n in count.items() if n % rounds}
    if off:
        return ("device activities recorded a number of times that is not a multiple of the "
                f"{rounds} rounds traced: " + ", ".join(f"{k} {n}" for k, n in sorted(off.items())))
    early = [launches[corr] - start for _, start, _, corr in activities
             if corr in launches and start < launches[corr] - _LAUNCH_SLACK_US]
    if early:
        return (f"{len(early)} device activities start before their launches, by up to "
                f"{max(early):.1f} us")
    return None


@dataclass
class TraceReading:
    """What the traced rounds left: device activities and the benchmark's
    ranges on the profiler's clock (microseconds), and each span's
    host-clock seconds."""

    rounds: int
    activities: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    problem: str | None = None

    @property
    def window(self) -> tuple[float, float] | None:
        rounds = [(s, e) for name, s, e in self.ranges if name == ROUND]
        if not rounds:
            return None
        return min(s for s, _ in rounds), max(e for _, e in rounds)

    def window_seconds(self) -> float:
        w = self.window
        return (w[1] - w[0]) / 1e6 if w else 0.0

    def _busy(self) -> list[tuple[float, float]]:
        """The union of the device intervals inside the window."""
        w = self.window
        if w is None:
            return []
        spans = sorted((max(s, w[0]), min(e, w[1])) for _, s, e, _ in self.activities
                       if e > w[0] and s < w[1])
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e6

    def kernel_seconds(self, prefix: str) -> float:
        """Device seconds of the activities whose short name starts with
        ``prefix``."""
        return sum(e - s for name, s, e, _ in self.activities
                   if kernel_name(name).startswith(prefix)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        total = collections.Counter()
        for name, s, e, _ in self.activities:
            total[kernel_name(name)] += (e - s) / 1e6
        return [[name, sec] for name, sec in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle stretches of the device in the window, each named
        by the innermost benchmark span open at its middle."""
        w = self.window
        if w is None:
            return []
        edges = [w[0]] + [t for iv in self._busy() for t in iv] + [w[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named = []
        for s, e in gaps:
            mid = (s + e) / 2
            open_ = [(r[2] - r[1], r[0]) for r in self.ranges
                     if r[0] != ROUND and r[1] <= mid <= r[2]]
            named.append([min(open_)[1] if open_ else "between", (e - s) / 1e6])
        return sorted(named, key=lambda g: -g[1])[:top]


def traced_rounds(run_one, rounds: list, device, labels) -> tuple:
    """Trace the rounds ``rounds`` (their inputs, made beforehand), each
    ``run_one(input, spans)`` inside a ``round`` range; when a trace is not
    whole, take it again with the same rounds, and raise
    :class:`TraceRefused` after the last attempt. Returns the reading, the
    outputs by round and the index of the next round."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    labels = set(labels) | {ROUND}
    for attempt in range(_ATTEMPTS if cuda else 1):
        if cuda:
            with profile(activities=activities):
                warm = torch.zeros(1, device=device)
                for _ in range(_WARMUP_KERNELS):
                    warm.add_(1)
                torch.cuda.synchronize()
        spans = Spans(True, device)
        outputs = {}
        with profile(activities=activities) as prof:
            for inp in rounds:
                with torch.profiler.record_function(ROUND):
                    outputs[inp.index] = run_one(inp, spans)
            if cuda:
                torch.cuda.synchronize()
        acts = _activities(prof, labels)
        problem = trace_problem(acts, _launch_starts(prof), len(rounds), device=cuda)
        reading = TraceReading(rounds=len(rounds), activities=acts, ranges=_ranges(prof, labels),
                               spans=dict(spans.seconds), problem=problem)
        if problem is None:
            return reading, outputs, rounds[-1].index + 1
        print(f"trace attempt {attempt + 1}: {problem}", file=sys.stderr, flush=True)
    raise TraceRefused(f"no whole trace in {attempt + 1} attempts: {problem}")
