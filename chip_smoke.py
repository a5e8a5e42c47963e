#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sda_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: compile every kernel of the main path from ``sda_tpu_torch/ops/csrc``
   (set-up) and print the card's name and power limit;
2. compare: at a mid shape (16 participants, 3,000 dimensions, lanes=1024)
   run the fused byte-limb kernel on the card and its plain version on CPU
   copies of the same inputs, in caller-randomness and PRNG mode, with and
   without fused reconstruction, with rand_participants = P and 1, at four
   moduli; every output must be bit-equal;
3. headline: ``FederatedAggregation.packed_64bit(dimension=1_000_002)`` with
   768 participants through ``engine.aggregate_mxu8_kernel``: one step with
   the launch counter reset before and read after, the reveal checked on
   the first 128 lanes against the modular participant sum, the plain
   version run on the card at the same shape and compared, then timed
   steps with CUDA events;
4. forward: the CIOS ``forward`` of the same model at 32 participants must
   reveal the numpy sum mod p.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HEADLINE_DIM = 1_000_002
HEADLINE_P = 768
LANES = 1024
# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor-core ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1.979e15


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def phase_build():
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    t0 = time.perf_counter()
    load_kernel_library("mxu8.cu")
    return time.perf_counter() - t0


def _engines(dimension: int):
    """Packed Shamir (3, 8, 4) engines at the four moduli of the reference's
    byte-limb tests: p433, a generic 62-bit prime, 2^63 - 871, 2^127 - 1495."""
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.fields import find_prime_field, find_special_prime_field
    from sda_tpu_torch.sharing import PackedShamirScheme

    params = {
        "p433": (433, 354, 150),
        "p62": find_prime_field(62, 8, 9),
        "p63special": find_special_prime_field(63, 8, 9),
        "p127special": find_special_prime_field(127, 8, 9),
    }
    return {
        name: TorchAggregationEngine(
            PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), dimension, device="cuda"
        )
        for name, (p, w2, w3) in params.items()
    }


def phase_compare(P: int = 16, dimension: int = 3000):
    """Kernel (card) against plain version (CPU) at the mid shape. Returns
    (cases, max_abs_err, kernel ms and plain ms of the PRNG + reconstruct
    case at 2^63 - 871)."""
    import numpy as np
    import torch

    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.utils.profiling import cuda_time

    cases, max_err, mid = 0, 0, {}
    for name, eng in _engines(dimension).items():
        spec, ctx = eng.spec, eng.ctx
        rng = np.random.default_rng(11)
        secrets = eng.encode_secrets(rng.integers(0, min(ctx.p, 1 << 62), size=(P, dimension)))
        ext = torch.cat([secrets, eng.random_ext(P, rng=rng)], dim=2)
        modes = [
            ("ext", eng.planar8_ext(ext, LANES), None),
            ("prng", eng.planar8_secrets(secrets, LANES), None),
            ("prng_rp1", eng.planar8_secrets(secrets, LANES), 1),
        ]
        for mode, sec8, rp in modes:
            for rec in (None, spec.reconstruct_matrix):
                plan = m8.mxu8_plan(
                    eng.mxu8, spec.share_matrix, sec8.shape[0], P, spec.secret_count,
                    spec.randomness_count, reconstruct_matrix=rec, rand_participants=rp,
                    device="cuda",
                )
                plan_cpu = m8.mxu8_plan(
                    eng.mxu8, spec.share_matrix, sec8.shape[0], P, spec.secret_count,
                    spec.randomness_count, reconstruct_matrix=rec, rand_participants=rp,
                )
                seed = 1234 + cases
                got = m8.run_mxu8(plan, sec8, seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = m8.run_mxu8(plan_cpu, sec8.cpu(), seed)
                plain_s = time.perf_counter() - t0
                err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(
                        f"kernel != plain at {name} {mode} rec={rec is not None}: max err {err}"
                    )
                if rec is not None and mode != "ext":
                    # PRNG mode: the reconstruction reveals the participant sum
                    out = m8.batched_from_planar_lm(got, eng.nb, spec.secret_count)
                    if not torch.equal(out.to(torch.int64), ctx.sum_mod(secrets, axis=0)):
                        raise AssertionError(f"reveal != modular sum at {name} {mode}")
                if name == "p63special" and mode == "prng" and rec is not None:
                    t = cuda_time(lambda i: m8.run_mxu8(plan, sec8, i), iters=10, warmup=2)
                    mid = {"kernel_ms": t.median_ms, "plain_cpu_ms": plain_s * 1e3,
                           "shape": f"P={P} dim={dimension} NBP={sec8.shape[1]}"}
                cases += 1
    return cases, max_err, mid


def _planar_secrets(rows: int, nbp: int, L8: int, seed: int):
    """The participation matrix synthesised on the card in the kernel's
    biased planar layout; the top byte of each element is masked to 4 bits
    so every element is canonical (< 2^(8*L8-4) < p)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    d = torch.empty((rows, nbp), dtype=torch.uint8, device="cuda").random_(generator=gen)
    d.view(rows // L8, L8, nbp)[:, L8 - 1] &= 0x0F
    d ^= 0x80
    return d.view(torch.int8)


def _reveal_check(engine, sec8, out, p_count: int, width: int = 128):
    """The kernel's reveal on the first ``width`` batch positions against
    the modular sum of the participants' secrets decoded from ``sec8``."""
    import torch

    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    d = sec8[:, :width].cpu().to(torch.int64) + 128  # unbiased bytes
    d = d.reshape(p_count, k, L8, width)
    x16 = torch.stack([d[:, :, 2 * w] + (d[:, :, 2 * w + 1] << 8) for w in range(L)], dim=-1)
    ref = engine.ctx.sum_mod(x16.permute(0, 2, 1, 3), axis=0)  # [width, k, L]
    if not torch.equal(out[:width].cpu().to(torch.int64), ref):
        raise AssertionError("headline reveal != modular participant sum")


def phase_headline(iters: int = 20):
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.utils.profiling import cuda_time

    model = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM)
    engine = model.engine
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    nbp = -(-engine.nb // LANES) * LANES
    rows = HEADLINE_P * k * L8
    sec8 = _planar_secrets(rows, nbp, L8, seed=7)
    torch.cuda.synchronize()

    # the main path: one aggregation step, counted
    m8.mxu8_launches = 0
    out = engine.aggregate_mxu8_kernel(sec8, 0, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    launches = m8.mxu8_launches
    if launches < 1:
        raise AssertionError("the headline step did not launch the mxu8 kernel")
    if tuple(out.shape) != (engine.nb, k, L) or int(out.max()) > 0xFFFF or int(out.min()) < 0:
        raise AssertionError(f"headline output has shape {tuple(out.shape)} or limbs out of range")
    _reveal_check(engine, sec8, out, HEADLINE_P)

    # the plain version at the same shape, on the card, against the kernel
    plan = next(iter(engine._plans.values()))
    raw = m8.run_mxu8(plan, sec8, 0)
    t_plain = cuda_time(lambda i: m8._fused_share_combine_mxu8_plain(plan, sec8, 0), iters=1, warmup=0)
    plain = m8._fused_share_combine_mxu8_plain(plan, sec8, 0)
    err = int((raw.to(torch.int64) - plain.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"headline kernel != plain version: max err {err}")

    t = cuda_time(
        lambda i: engine.aggregate_mxu8_kernel(sec8, i, p_count=HEADLINE_P, lanes=LANES),
        iters=iters, warmup=3,
    )
    # end to end: back-to-back steps on the host clock, one final sync
    t0 = time.perf_counter()
    for i in range(iters):
        engine.aggregate_mxu8_kernel(sec8, i, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    # breakdown: the same launch with one randomness draw per slot instead
    # of 768 (the combined-draw mode) leaves the Philox stream 1/768 as long
    plan_rp1 = m8.mxu8_plan(
        engine.mxu8, engine.spec.share_matrix, rows, HEADLINE_P, k,
        engine.spec.randomness_count, reconstruct_matrix=engine.spec.reconstruct_matrix,
        rand_participants=1, device="cuda",
    )
    t_rp1 = cuda_time(lambda i: m8.run_mxu8(plan_rp1, sec8, i), iters=iters, warmup=3)
    in_bytes = (sec8.numel() + plan.bigs.numel() + plan.bigr.numel() + plan.big2.numel()
                + 4 * plan.tables.numel())
    out_bytes = 4 * raw.numel()
    ops = 2.0 * plan.n_pad * (plan.rows + plan.Kr) * nbp
    ops += 2.0 * plan.big2.shape[0] * plan.big2.shape[1] * nbp
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_INT8 * 1e3
    philox_words = float(nbp) * plan.rp * plan.words_per_p
    return {
        "launches": launches, "timing": t, "plain_ms": t_plain.median_ms, "max_abs_err": err,
        "step_ms": step_ms, "rp1_ms": t_rp1.median_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": in_bytes + out_bytes, "int8_ops": ops, "philox_words": philox_words,
        "shape": f"P={HEADLINE_P} dim={HEADLINE_DIM} rows={rows} NBP={nbp}",
    }


def phase_forward(participants: int = 32):
    import numpy as np
    import torch

    from sda_tpu_torch.models import FederatedAggregation

    model = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM)
    secrets, gen = model.example_inputs(participants=participants, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.forward(secrets, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    revealed = model.reveal(out)
    raw = np.random.default_rng(3).integers(
        0, min(model.scheme_modulus, 1 << 31), size=(participants, HEADLINE_DIM)
    )
    expect = raw.sum(axis=0) % model.scheme_modulus
    if not np.array_equal(revealed.astype(np.int64), expect):
        raise AssertionError("CIOS forward reveal != numpy sum mod p")
    return seconds


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "sda_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    card = _card_line()
    name = torch.cuda.get_device_name(0)
    build_s = phase_build()
    print(f"build: {build_s:.1f} s (nvcc, sm_90a)", flush=True)

    cases, cmp_err, mid = phase_compare()
    print(f"compare: {cases} kernel/plain cases bit-equal at the mid shape ({mid['shape']}): "
          f"kernel {mid['kernel_ms']:.4f} ms, plain (CPU) {mid['plain_cpu_ms']:.1f} ms", flush=True)

    h = phase_headline()
    t = h["timing"]
    print(f"headline: {h['shape']} on {card}: median {t.median_ms:.4f} ms "
          f"(min {t.min_ms:.4f}, max {t.max_ms:.4f}, {len(t.samples_ms)} steps), "
          f"{HEADLINE_P / (t.median_ms / 1e3):.0f} aggregations/s; bound {h['bound_ms']:.4f} ms "
          f"({h['bound_by']}); plain on card {h['plain_ms']:.1f} ms; launches {h['launches']}",
          flush=True)
    print(f"headline: back-to-back step {h['step_ms']:.4f} ms on the host clock "
          f"(device idle share {max(0.0, 1 - t.median_ms / h['step_ms']):.4f}); "
          f"with rand_participants=1 {h['rp1_ms']:.4f} ms", flush=True)

    fwd_s = phase_forward()
    print(f"forward: CIOS forward, 32 x {HEADLINE_DIM}, revealed exactly in {fwd_s:.3f} s", flush=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "mxu8_fused",
        "route": "cuda",
        "source": "sda_tpu_torch/ops/csrc/mxu8.cu",
        "replaces": "sda_tpu/ops/mxu8.py:454",
        "launches": h["launches"],
        "max_abs_err": max(cmp_err, h["max_abs_err"]),
        "ms": t.median_ms,
        "min_ms": t.min_ms,
        "max_ms": t.max_ms,
        "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"],
        "library_ms": None,
        "shape": h["shape"],
        "step_ms": h["step_ms"],
        "rand_participants_1_ms": h["rp1_ms"],
        "mid_kernel_ms": mid["kernel_ms"],
        "mid_plain_cpu_ms": mid["plain_cpu_ms"],
        "mid_shape": mid["shape"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
