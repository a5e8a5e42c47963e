"""What the measurement tools and ``chip_smoke.py`` share: synthetic planar
operands, the reveal check, the byte-limb kernel's cost model and bounds
(bytes and int8 operations; with the Philox issue term counted from the
built kernel's SASS), device-or-nothing timing, and the artifact writer.

Port of the ``bench.py`` internals the reference's tools import
(``_make_planar_secrets``, ``_reveal_check_slice``, ``_mxu8_model``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from sda_tpu_torch.ops.probes import xor_words
from sda_tpu_torch.utils.profiling import (
    H100_SXM,
    WARMUP_CALLS,
    card_line,
    cuda_time_samples,
    roofline,
)

__all__ = [
    "make_planar_secrets",
    "reveal_check_slice",
    "mxu8_cost",
    "bound",
    "mxu8_bound",
    "mxu8_philox_calls",
    "timed",
    "timed_calls",
    "seconds",
    "median_s",
    "check_sink",
    "card_fields",
    "write_artifact",
    "MEASUREMENTS_DIR",
]

MEASUREMENTS_DIR = Path(__file__).resolve().parents[2] / "build" / "measurements"


def make_planar_secrets(engine, seed, rows: int, nbp: int) -> torch.Tensor:
    """The participation matrix synthesised on the engine's device in the
    byte-limb kernel's biased planar layout, from ``seed`` (an int, or a
    ``torch.Generator`` on that device). The top byte of each element is
    masked to 4 bits, so every element is canonical (< 2^(8*L8-4) < p)."""
    L8 = engine.mxu8.L8
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=engine.device)
        gen.manual_seed(seed)
    d = torch.empty((rows, nbp), dtype=torch.uint8, device=engine.device).random_(generator=gen)
    d.view(rows // L8, L8, nbp)[:, L8 - 1] &= 0x0F
    d ^= 0x80
    return d.view(torch.int8)


def reveal_check_slice(engine, sec8, out, p_count: int, width: int = 128, times: int = 1,
                       what: str = "headline"):
    """The kernel's reveal ``out`` ``[nb, k, L]`` on the first ``width``
    batch positions against ``times`` x the modular sum of the
    participants' secrets decoded from ``sec8`` (``times`` > 1: the same
    chunk streamed that often). Raises on a mismatch."""
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    width = min(width, engine.nb)
    d = sec8[:, :width].cpu().to(torch.int64) + 128  # unbiased bytes
    d = d.reshape(p_count, k, L8, width)
    x16 = torch.stack([d[:, :, 2 * w] + (d[:, :, 2 * w + 1] << 8) for w in range(L)], dim=-1)
    once = engine.ctx.sum_mod(x16.permute(0, 2, 1, 3), axis=0)  # [width, k, L]
    ref = once
    for _ in range(times - 1):
        ref = engine.ctx.add_mod(ref, once)
    if not torch.equal(out[:width].cpu().to(torch.int64), ref):
        raise AssertionError(f"{what} reveal != modular participant sum")


def mxu8_cost(plan, nbp: int, acc: bool = False):
    """(bytes, int8 operations) of one byte-limb launch: every chunk of the
    operand, the matrices and tables read once, the output written once
    (and, for B3, the running sums read once), and the padded
    contractions."""
    L = plan.mxu8.ctx.L
    in_bytes = (plan.rows * plan.n_chunks * nbp + plan.bigs.numel() + plan.bigr.numel()
                + plan.big2.numel() + 4 * plan.tables.numel())
    out_bytes = 4 * L * plan.n_out * nbp * (2 if acc else 1)
    ops = 2.0 * plan.n_pad * (plan.rows + plan.Kr) * nbp
    if plan.n2:
        ops += 2.0 * plan.big2.shape[0] * plan.big2.shape[1] * nbp
    return in_bytes + out_bytes, ops * plan.n_chunks


def bound(costs):
    """The least time (ms) for launches of the given (bytes, ops): the
    larger of bytes over the HBM rate and int8 operations over the
    tensor-core rate (:func:`roofline`), and which of the two it is."""
    rep = roofline(1.0, hbm_bytes=sum(b for b, _ in costs), int8_ops=sum(o for _, o in costs))
    by = "bytes" if rep["binding_resource"] == "hbm" else "operations"
    return rep["speed_of_light_s"] * 1e3, by


def mxu8_philox_calls(plan, nbp: int) -> float:
    """Philox calls of one byte-limb launch: one per lane, randomness draw
    and group of four words, in every chunk."""
    return float(nbp) * plan.rp * -(-plan.words_per_p // 4) * plan.n_chunks


def mxu8_philox_call_ops(variant: str, mt: int) -> int:
    """SASS instructions per Philox call of a built mxu8 variant's MT
    instance: the body of the one innermost loop around the generator (the
    draw loop after the K loop is not unrolled: one call per iteration)."""
    from sda_tpu_torch.ops.mxu8 import KERNEL_VARIANTS
    from sda_tpu_torch.ops.sass import innermost_philox_loops, sass_listing

    bodies = innermost_philox_loops(sass_listing(*KERNEL_VARIANTS[variant])[f"MT{mt}"])
    if len(bodies) != 1:
        raise AssertionError(f"found {len(bodies)} Philox loops in {variant} MT{mt}'s SASS, not 1")
    return len(bodies[0])


def mxu8_bound(plan, nbp: int, mhz: float, acc: bool = False, card=H100_SXM):
    """A B1/B2/B3 launch's least time on the card: the largest of its bytes
    over the HBM rate, its int8 operations over the tensor-core rate
    (:func:`mxu8_cost`) and its Philox calls (one per lane, draw and word
    group of every chunk) times the launched instance's SASS instructions
    per call over the SMs' issue rate at ``mhz``. Needs the built kernel.
    Returns (ms, "bytes" or "operations", the three parts in ms,
    instructions per call)."""
    from sda_tpu_torch.ops.mxu8 import _variant, kernel_mt

    nbytes, ops = mxu8_cost(plan, nbp, acc=acc)
    calls = mxu8_philox_calls(plan, nbp)
    call_ops = mxu8_philox_call_ops(_variant(plan, acc), kernel_mt(plan)) if calls else 0
    parts = {"bytes": nbytes / card.hbm_bytes_per_s * 1e3, "int8": ops / card.int8_ops_per_s * 1e3,
             "philox": calls * call_ops / (card.sms * card.issue_lanes * mhz * 1e6) * 1e3}
    bound_ms = max(parts.values())
    return bound_ms, "bytes" if parts["bytes"] == bound_ms else "operations", parts, call_ops


def timed(fn, device: torch.device, samples: int, iters: int):
    """:func:`cuda_time_samples` of ``fn`` on the card; on the CPU one call,
    so the checks around it run, and ``None``: nothing is measured."""
    if device.type == "cuda":
        return cuda_time_samples(fn, samples=samples, iters=iters)
    fn(0)
    return None


def timed_calls(samples: int, iters: int) -> int:
    """The calls of ``fn`` that one :func:`timed` on the card makes."""
    return WARMUP_CALLS + samples * iters


def seconds(timing):
    """``{"median", "min", "max", "n"}`` in seconds, as the reference's
    artifacts hold them, or ``None`` for a run that measured nothing."""
    if timing is None:
        return None
    return {"median": timing.median_ms / 1e3, "min": timing.min_ms / 1e3,
            "max": timing.max_ms / 1e3, "n": len(timing.samples_ms)}


def median_s(timing):
    """The median per-call time in seconds, or ``None`` (nothing measured)."""
    return None if timing is None else timing.median_ms / 1e3


def check_sink(probe_out, x):
    """A probe's sinks (``probe_out[1]``) must XOR to the XOR of its input's
    words: the proof that the probe read every byte."""
    got, want = xor_words(probe_out[1]), xor_words(x)
    if got != want:
        raise AssertionError(f"probe sink XOR {got:#x} != input XOR {want:#x}")


def card_fields(device: torch.device) -> dict:
    """Where the numbers of an artifact come from: the card's name and power
    limit (nvidia-smi) on a CUDA device, or a CPU run that measured nothing."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device), "card": card_line()}
    return {"device": "cpu", "card": None,
            "note_device": "CPU run: checks only, no time measured"}


def write_artifact(name: str, artifact: dict) -> Path:
    """Write ``artifact`` to ``build/measurements/<name>.json``; return the
    path."""
    MEASUREMENTS_DIR.mkdir(parents=True, exist_ok=True)
    path = MEASUREMENTS_DIR / f"{name}.json"
    path.write_text(json.dumps(artifact, indent=2))
    return path
