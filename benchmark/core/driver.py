"""One run of a cell: the program set up, warmed up and driven round after
round, as the recipient of a secure aggregation drives it; then the rounds
compared with the reference, and the result line.

A round is four calls into the program: the engine's aggregation (through
the traffic's route), the masker's combine of the round's seeds, the
engine's decode, and the masker's unmask; a configuration without masking
makes only the two engine calls. It ends when the revealed vector is on
the host as the program returns it. Rounds run back to back: one
recipient, a closed loop.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.core import inputs, spec, trace
from benchmark.reference.round import ReferenceRound

SPAN_NAMES = ("aggregate", "mask_combine", "decode", "unmask")
# the window's inputs are made in set-up for this many times the rounds that
# the fastest warm-up round's pace fits in the window; any beyond are made
# in the window
AHEAD = 2.0


@dataclass
class RoundInput:
    index: int
    chunks: list
    kernel_seed: int
    seed_words: np.ndarray | None


def round_input(cell, seed: int, k: int) -> RoundInput:
    traffic, cfg = cell.traffic, cell.config
    chunk = int(traffic["chunk"])
    per_round = int(traffic["participants"]) // chunk
    resident = int(cfg["resident_participants"]) // chunk
    words = None
    if cell.masking:
        words = inputs.round_seed_words(seed, k, per_round * chunk,
                                        -(-int(cell.masking["seed_bits"]) // 32))
    return RoundInput(k, inputs.round_chunks(seed, k, per_round, resident),
                      inputs.round_kernel_seed(seed, k), words)


class ResidentChunks:
    """The participants' data as the program holds it on the device: each
    resident chunk made from the seed's values, by blocks of participants,
    through the engine's own planar encoding, and stacked along the rows
    (participant-major, as the engine's calls take them)."""

    def __init__(self, engine, cell, seed: int, device):
        cfg, traffic = cell.config, cell.traffic
        self.chunk = int(traffic["chunk"])
        resident = int(cfg["resident_participants"]) // self.chunk
        lanes = int(traffic["lanes"])
        d, k = int(cfg["dimension"]), engine.spec.secret_count
        self.data = None
        row = 0
        for c in range(resident):
            for block, count in inputs.chunk_blocks(self.chunk):
                limbs = inputs.participant_limbs(seed, c, block, count, d, int(cfg["value_bits"]),
                                                 device)
                if limbs.shape[-1] != engine.ctx.L:
                    raise ValueError(f"the engine takes {engine.ctx.L} limbs, the values have "
                                     f"{limbs.shape[-1]}")
                padded = torch.nn.functional.pad(limbs, (0, 0, 0, engine.nb * k - d))
                planar = engine.planar8_secrets(padded.reshape(count, engine.nb, k, -1), lanes)
                del limbs, padded
                if self.data is None:
                    self.rows = planar.shape[0] // count * self.chunk
                    self.data = torch.empty((resident * self.rows, planar.shape[1]),
                                            dtype=planar.dtype, device=device)
                self.data[row : row + planar.shape[0]] = planar
                row += planar.shape[0]
                del planar

    def chunk_rows(self, c: int) -> torch.Tensor:
        return self.data[c * self.rows : (c + 1) * self.rows]


def _resolve(path: str):
    module, attr = path.split(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


class ProgramSystem:
    """The port under test (``config["program"]``), as the recipient calls it."""

    def __init__(self, cell, seed: int, device):
        cfg, traffic = cell.config, cell.traffic
        model = _resolve(cfg["program"])(dimension=int(cfg["dimension"]), device=device)
        self.engine = model.engine
        s = self.engine.spec
        stated = (int(cfg["modulus"]), int(cfg["secret_count"]), int(cfg["share_count"]))
        if (s.modulus, s.secret_count, s.share_count) != stated:
            raise ValueError(f"the program's scheme {(s.modulus, s.secret_count, s.share_count)} "
                             f"is not the configuration's {stated}")
        self.route = spec.load_module("routes", traffic["route"])
        self.chunk, self.lanes = int(traffic["chunk"]), int(traffic["lanes"])
        t = time.perf_counter()
        self.store = ResidentChunks(self.engine, cell, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.store_s = time.perf_counter() - t
        self.masker = None
        if cell.masking:
            masker = _resolve(cell.masking["program"])
            self.masker = masker(s.modulus, int(cfg["dimension"]), int(cell.masking["seed_bits"]),
                                 device=device)

    def aggregate(self, inp: RoundInput):
        return self.route.aggregate(self.engine, self.store, inp.chunks, self.chunk,
                                    inp.kernel_seed, self.lanes)

    def combine(self, inp: RoundInput):
        return self.masker.combine(inp.seed_words)

    def decode(self, out):
        return self.engine.decode_output(out)

    def unmask(self, mask, vals):
        return self.masker.unmask((mask, vals))

    def close(self):
        self.store = self.engine = self.masker = None


def run_round(system, inp: RoundInput, spans):
    with spans("aggregate"):
        out = system.aggregate(inp)
    mask = None
    if inp.seed_words is not None:
        with spans("mask_combine"):
            mask = system.combine(inp)
    with spans("decode"):
        vals = system.decode(out)
    if inp.seed_words is not None:
        with spans("unmask"):
            vals = system.unmask(mask, vals)
    return vals


def launch_counts() -> dict:
    """The program's launch counters (module integers named ``*_launches``)."""
    out = {}
    for name, module in list(sys.modules.items()):
        if name.startswith("sda_tpu_torch.") and module is not None:
            for attr, value in vars(module).items():
                if attr.endswith("_launches") and type(value) is int:
                    out[attr] = value
    return out


@dataclass
class Record:
    """What a run measured; the metric readers take what they need."""

    cell: object
    setup_s: float
    rounds: int = 0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    trace: object = None


def count_wrong(got, expected: np.ndarray, modulus: int) -> int:
    """Elements of a round's answer that are not the expected value: a
    representative in ``(-p, p)`` of the expected residue."""
    g = np.asarray(got).astype(object)
    if g.shape != expected.shape:
        return len(expected)
    bad = (g <= -modulus) | (g >= modulus) | (np.where(g < 0, g + modulus, g) != expected)
    return int(np.count_nonzero(bad.astype(bool)))


def check_rounds(cell, seed: int, device, kept: dict, rounds: int) -> dict:
    """Compare the answers kept by the sample (``kept``, by round) with the
    reference; returns the numbers compared, each with its limit. A round
    that raised is counted as failed already."""
    ref = ReferenceRound(cell, seed, device)
    wrong = wrong_rounds = 0
    for k, got in kept.items():
        n = count_wrong(got, ref.answer(k), ref.modulus)
        wrong += n
        wrong_rounds += n > 0
    print(f"check: rounds {len(kept)} of {rounds} compared with the reference",
          file=sys.stderr, flush=True)
    return {"wrong_elements": {"value": wrong, "limit": 0},
            "wrong_rounds": {"value": wrong_rounds, "limit": 0}}


def _metrics(entries: list, record: Record) -> dict:
    out = {}
    for m in entries:
        value = spec.load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def window_inputs(cell, seed: int, first: int, seconds: float, warm: list) -> list:
    """The inputs of the rounds from ``first`` on that the window can reach
    at ``AHEAD`` times the fastest warm-up round's pace."""
    count = math.ceil(seconds / max(min(warm), 1e-6) * AHEAD) + 1
    return [round_input(cell, seed, first + i) for i in range(count)]


def setup_line(setup_s: float, phases: dict) -> str:
    """The set-up's phases in seconds, and the rest of it named ``other``:
    together they are ``setup_s``."""
    parts = dict(phases, other=setup_s - sum(phases.values()))
    return ("setup: " + ", ".join(f"{name} {s:.3f}" for name, s in parts.items())
            + f" = {setup_s:.3f} s")


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t0: float | None = None,
             system_factory=ProgramSystem, phases: dict | None = None, probe=None):
    """Run one cell; returns ``(result, checks)``. ``system_factory(cell,
    seed, device)`` builds what the rounds call: the program, or a stand-in
    in the tests. ``phases``: the set-up's seconds before this call, by
    name; ``probe(when)``, if given, is called just before the window opens
    and just after it closes, outside both the set-up and the window."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = dict(phases or {})
    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic = cell.traffic
    t = time.perf_counter()
    system = system_factory(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    store_s = getattr(system, "store_s", 0.0)
    phases["program"] = time.perf_counter() - t - store_s
    phases["store"] = store_s
    t = time.perf_counter()
    off = trace.Spans(False)
    k = 0
    failed = 0

    def one(inp, spans):
        nonlocal failed
        try:
            return run_round(system, inp, spans)
        except Exception as exc:  # a round that raises is a failed round
            failed += 1
            print(f"round {inp.index} failed: {exc!r}", file=sys.stderr, flush=True)
            return None

    warm = []
    for _ in range(int(traffic["warmup_rounds"])):
        before = launch_counts()
        r0 = time.perf_counter()
        one(round_input(cell, seed, k), off)
        warm.append(time.perf_counter() - r0)
        if k == 0:
            after = launch_counts()
            print("routes: " + ", ".join(f"{n} {after[n] - before.get(n, 0)}"
                                         for n in sorted(after)), flush=True)
        k += 1
    warm_failed, failed = failed, 0
    # the window's inputs and its latencies' places are made here, so that
    # the window allocates nothing of the harness's own between the
    # program's calls (nor frees: the sample holds what it replaces)
    ahead = [] if traced or not warm else window_inputs(cell, seed, k, seconds, warm)
    latencies = [0.0] * len(ahead)
    sample = inputs.Sample(seed, traffic["check_rounds"])
    if cuda:
        torch.cuda.synchronize()
    # set-up's objects stay out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    record = Record(cell=cell, setup_s=time.perf_counter() - t0)
    phases["warmup"] = time.perf_counter() - t
    print(setup_line(record.setup_s, phases), file=sys.stderr, flush=True)
    if probe is not None:
        probe("before")

    def keep(k, answer):
        if answer is not None:
            sample.offer(k, answer)

    if traced:
        reading, outputs, k = trace.traced_rounds(
            one, [round_input(cell, seed, k + i) for i in range(int(traffic["trace_rounds"]))],
            device, SPAN_NAMES)
        for r, answer in outputs.items():
            keep(r, answer)
        record.trace, record.spans, record.rounds = reading, reading.spans, len(outputs)
        del outputs
    else:
        start = time.perf_counter()
        while True:
            i = record.rounds
            inp = ahead[i] if i < len(ahead) else round_input(cell, seed, k)
            r0 = time.perf_counter()
            answer = one(inp, off)
            r1 = time.perf_counter()
            keep(k, answer)
            del answer, inp
            if i < len(latencies):
                latencies[i] = r1 - r0
            else:
                latencies.append(r1 - r0)
            record.rounds += 1
            k += 1
            if r1 - start >= seconds:
                break
        record.window_s = r1 - start
        record.latencies_s = latencies[: record.rounds]
    del ahead
    sample.release()
    if probe is not None:
        probe("after")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    metrics = _metrics(cell.per_layer if traced else cell.end_to_end, record)
    spread = ""
    if len(record.latencies_s) >= 10:
        q = np.percentile(np.array(record.latencies_s) * 1e3, [10, 50, 90])
        half = len(record.latencies_s) // 2
        means = [sum(x) / len(x) * 1e3 for x in (record.latencies_s[:half],
                                                 record.latencies_s[half:])]
        tenths = " ".join(f"{x.mean() * 1e3:.1f}"
                          for x in np.array_split(np.array(record.latencies_s), 10))
        spread = (f" (latency p10 {q[0]:.3f} p50 {q[1]:.3f} p90 {q[2]:.3f} ms; mean of the "
                  f"first half {means[0]:.3f}, of the second {means[1]:.3f} ms; of each tenth "
                  f"{tenths})")
    print(f"run: set-up {record.setup_s:.3f} s, {record.rounds} rounds"
          + ("" if traced else f" in {record.window_s:.3f} s") + spread
          + f", {failed} failed, peak {peak} bytes", file=sys.stderr, flush=True)
    r0 = time.perf_counter()
    checks = check_rounds(cell, seed, device, sample.kept(), record.rounds)
    print(f"check: the reference took {time.perf_counter() - r0:.3f} s", file=sys.stderr,
          flush=True)
    wrong_rounds = checks["wrong_rounds"]["value"]
    result = {
        "correct": warm_failed == failed == 0 and all(c["value"] <= c["limit"]
                                                      for c in checks.values()),
        "attempted": record.rounds,
        "failed": failed + wrong_rounds,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if traced:
        result["device"]["busy_s"] = record.trace.busy_seconds()
        result["device"]["window_s"] = record.trace.window_seconds()
        result["breakdown"] = {"device_ops": record.trace.device_ops(),
                               "idle_gaps": record.trace.idle_gaps()}
    result["checks"] = checks
    return result, checks
