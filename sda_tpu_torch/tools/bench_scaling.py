"""Mesh scaling benchmark: weak scaling at 1, 2, 4, ... devices, and the
config-5 split of a streaming step into its chunk loop and its finish.

    python -m sda_tpu_torch.tools.bench_scaling [--devices 8] [--dim-per-device 6144]
        [--participants-per-device 8] [--streaming-chunks 0] [--cpu-mesh]

Port of the reference repository's root ``bench_scaling.py``, over
:class:`~sda_tpu_torch.parallel.ShardedAggregationPipeline` at
p = 2^63 - 871 (packed Shamir 3 of 8, privacy threshold 4):

- **weak scaling**: for each ``n`` in 1, 2, 4, ... up to ``--devices``, a
  fresh world of ``n`` ranks runs ``n x --participants-per-device``
  participants at ``3 x --dim-per-device`` dimensions on the mesh
  ``{"p": n, "d": 1, "c": 1}``. On the card each step is
  ``aggregate_mxu8`` (B1 per shard, a B1 reconstruction), timed with CUDA
  events; on gloo ranks it is the CIOS ``aggregate_from_key``, timed on
  the host clock. The efficiency is the reference's: on cards, the rate
  over ``n`` x the one-device rate; on gloo ranks, which share one host,
  ``n`` x the one-rank time over the time;
- **the config-5 split** (``--streaming-chunks C``): ``C`` chunks of
  ``n x --participants-per-device`` participants through
  ``mxu8_partials``, one device buffer re-read by every chunk (B1 on the
  first, B3 on the rest, no collective in the loop), then the finish (the
  modular all-reduce and a B1 reconstruction). It reports the loop's and
  the finish's times, the finish's share, the rate of field operations and
  the all-reduce's payload, under the reference's names.

The card is the default, and with too few cards it uses those there are,
as the reference does; ``--cpu-mesh`` is the only way onto gloo ranks, and
nothing drops to the CPU on its own. Each world of ranks is a fresh
process group (:func:`~sda_tpu_torch.parallel.launch.spawn_ranks`). The
last line of output is one JSON object with the platform, the card's name
and power limit, and the rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from sda_tpu_torch.utils.profiling import DeviceTiming

__all__ = ["weak_case", "config5_case", "time_calls", "time_config5", "weak_row", "config5_row",
           "main"]

LANES = 512  # the planar lane width of the reference's kernel steps
STEP_ITERS = 5  # weak-scaling steps timed, after one untimed
LOOP_ITERS, FINISH_ITERS = 3, 5  # config-5 loops and finishes timed, after one untimed


def _scheme():
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.sharing import PackedShamirScheme

    p, w2, w3 = find_special_prime_field(63, 8, 9)
    return PackedShamirScheme(3, 8, 4, p, w2, w3)


def _pipeline(mesh, dimension: int):
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.parallel import ShardedAggregationPipeline

    engine = TorchAggregationEngine(_scheme().device_spec(), dimension, device=mesh.device_type)
    return ShardedAggregationPipeline(engine, mesh)


def _planar_secrets(engine, seed: int, p_count: int):
    """``p_count`` participants' secrets, synthesised on the engine's device
    in the byte-limb kernel's planar layout (``LANES`` wide)."""
    from sda_tpu_torch.tools._common import make_planar_secrets

    nbp = -(-engine.nb // LANES) * LANES
    return make_planar_secrets(engine, seed, p_count * engine.spec.secret_count
                               * engine.mxu8.L8, nbp)


@dataclasses.dataclass
class WeakCase:
    """One weak-scaling row's step on this rank: ``step(i)`` at seed ``i``
    returns the global ``[NBP, k, L]`` (card) or ``[nb, k, L]`` (CPU)."""

    pipe: object
    step: object
    inputs: torch.Tensor  # planar secrets (card) or limbs ``[P, nb, k, L]`` (CPU)
    p_count: int
    fieldops: float


def weak_case(mesh, participants_per_device: int, dim_per_device: int) -> WeakCase:
    """The weak-scaling step of a world of ``mesh.size()`` ranks."""
    from sda_tpu_torch.ops.modmat import uniform_limbs

    n_dev = mesh.size()
    p_count = participants_per_device * n_dev
    pipe = _pipeline(mesh, 3 * dim_per_device)
    engine, spec = pipe.engine, pipe.engine.spec
    if mesh.device_type == "cuda":
        inputs = _planar_secrets(engine, 0, p_count)
        step = lambda i: pipe.aggregate_mxu8(inputs, i)  # noqa: E731
    else:  # the CIOS step: every rank draws the same randomness from seed i
        inputs = uniform_limbs(engine.ctx, torch.Generator().manual_seed(0),
                               (p_count, engine.nb, spec.secret_count))
        step = lambda i: pipe.aggregate_from_key(  # noqa: E731
            inputs, torch.Generator().manual_seed(i + 1))
    # field operations per step: share matmul + combine + reconstruct
    m, n, k = spec.secret_count + spec.randomness_count, spec.share_count, spec.secret_count
    fieldops = p_count * engine.nb * (2 * m * n + n) + engine.nb * 2 * n * k
    return WeakCase(pipe, step, inputs, p_count, float(fieldops))


@dataclasses.dataclass
class Config5Case:
    """The config-5 streaming step on this rank: ``loop(s)`` runs the chunk
    loop at seeds ``s * chunks + i`` and returns this shard's running sums;
    ``finish(acc)`` all-reduces and reconstructs them."""

    pipe: object
    planar: torch.Tensor
    p_chunk: int
    chunks: int
    fieldops: float
    payload_bytes: int

    def loop(self, s: int):
        return self.pipe.mxu8_partials([self.planar] * self.chunks, self.chunks * s)

    def finish(self, acc):
        return self.pipe._mxu8_finish(acc)


def config5_case(mesh, participants_per_device: int, dim_per_device: int,
                 chunks: int) -> Config5Case:
    """``chunks`` chunks of ``mesh.size() x participants_per_device``
    participants, one planar buffer re-read by every chunk."""
    p_chunk = participants_per_device * mesh.size()
    pipe = _pipeline(mesh, 3 * dim_per_device)
    engine, spec = pipe.engine, pipe.engine.spec
    planar = _planar_secrets(engine, 1, p_chunk)
    m, n = spec.secret_count + spec.randomness_count, spec.share_count
    fieldops = p_chunk * chunks * engine.nb * (2 * m * n + n)
    payload = n * engine.nb * engine.ctx.L * 4  # per-shard all-reduce payload
    return Config5Case(pipe, planar, p_chunk, chunks, float(fieldops), payload)


def time_calls(fn, device_type: str, iters: int, warmup: int = 1) -> DeviceTiming:
    """Per-call time of ``fn(i)``: CUDA events on the card; on gloo ranks
    the host clock between barriers (every rank waits for the slowest)."""
    if device_type == "cuda":
        from sda_tpu_torch.utils.profiling import cuda_time

        return cuda_time(fn, iters=iters, warmup=warmup)
    import statistics

    import torch.distributed as dist

    for i in range(warmup):
        fn(i)
    samples = []
    for i in range(iters):
        dist.barrier()
        t0 = time.perf_counter()
        fn(warmup + i)
        dist.barrier()
        samples.append((time.perf_counter() - t0) * 1e3)
    return DeviceTiming(statistics.median(samples), min(samples), max(samples), tuple(samples))


def time_config5(case: Config5Case, acc, device_type: str):
    """``(loop, finish)`` timings: ``LOOP_ITERS`` chunk loops at fresh seeds
    (the caller has run one already) and ``FINISH_ITERS`` finishes of its
    sums ``acc`` after one untimed."""
    loop = time_calls(lambda i: case.loop(i + 1), device_type, LOOP_ITERS, warmup=0)
    finish = time_calls(lambda i: case.finish(acc), device_type, FINISH_ITERS)
    return loop, finish


def weak_row(seconds: float, fieldops: float, n_dev: int, base, device_type: str) -> dict:
    """One weak-scaling row against ``base``, the one-device row's
    ``(seconds, rate)`` (``None`` for that row itself)."""
    rate = fieldops / seconds
    base_s, base_rate = base or (seconds, rate)
    if device_type == "cuda":
        eff = rate / (base_rate * n_dev)  # ideal: constant time as devices grow with work
    else:
        eff = base_s * n_dev / seconds  # one shared host: ideal time grows n-fold
    return {"ms_per_step": seconds * 1e3, "gfieldops_per_s": rate / 1e9,
            "weak_scaling_efficiency": eff}


def config5_row(case: Config5Case, loop_s: float, finish_s: float) -> dict:
    engine = case.pipe.engine
    return {
        "participants": case.p_chunk * case.chunks,
        "dimension": engine.dimension,
        "chunks": case.chunks,
        "chunk_loop_ms": loop_s * 1e3,
        "finish_ms": finish_s * 1e3,
        "comm_fraction": finish_s / (loop_s + finish_s),
        "gfieldops_per_s": case.fieldops / (loop_s + finish_s) / 1e9,
        "allreduce_payload_mb": case.payload_bytes / 1e6,
    }


def _mesh(device_type: str):
    import torch.distributed as dist

    from sda_tpu_torch.parallel import make_mesh

    return make_mesh({"p": dist.get_world_size(), "d": 1, "c": 1}, device_type)


def _weak_rank(participants_per_device: int, dim_per_device: int, device_type: str) -> dict:
    case = weak_case(_mesh(device_type), participants_per_device, dim_per_device)
    t = time_calls(case.step, device_type, STEP_ITERS)
    return {"seconds": t.median_ms / 1e3, "fieldops": case.fieldops}


def _config5_rank(participants_per_device: int, dim_per_device: int, chunks: int,
                  device_type: str) -> dict:
    case = config5_case(_mesh(device_type), participants_per_device, dim_per_device, chunks)
    loop, finish = time_config5(case, case.loop(0), device_type)
    return config5_row(case, loop.median_ms / 1e3, finish.median_ms / 1e3)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench_scaling", description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--dim-per-device", type=int, default=6144)
    ap.add_argument("--participants-per-device", type=int, default=8)
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="gloo ranks on the CPU (default: the cards)")
    ap.add_argument("--streaming-chunks", type=int, default=0,
                    help="also run the config-5 streaming x sharded step with this many "
                         "participant chunks")
    return ap


def main(argv=None) -> int:
    from sda_tpu_torch.parallel.launch import spawn_ranks

    args = build_parser().parse_args(argv)
    device_type = "cpu" if args.cpu_mesh else "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --cpu-mesh for gloo ranks")
        max_dev = min(args.devices, torch.cuda.device_count())
    else:
        max_dev = args.devices
    ppd, dpd = args.participants_per_device, args.dim_per_device

    results, base = {}, None
    n_dev = 1
    while n_dev <= max_dev:
        r = spawn_ranks(_weak_rank, n_dev, (ppd, dpd, device_type), device_type)[0]
        row = weak_row(r["seconds"], r["fieldops"], n_dev, base, device_type)
        base = base or (r["seconds"], r["fieldops"] / r["seconds"])
        results[n_dev] = row
        print(f"# {n_dev} devices: {row['ms_per_step']:.4f} ms/step, "
              f"{row['gfieldops_per_s']:.4f} Gfield-ops/s, efficiency "
              f"{row['weak_scaling_efficiency']:.1%}", file=sys.stderr)
        n_dev *= 2

    streaming = None
    if args.streaming_chunks > 0:
        streaming = spawn_ranks(_config5_rank, max_dev,
                                (ppd, dpd, args.streaming_chunks, device_type), device_type)[0]
        print(f"# streaming x sharded ({max_dev} dev, {streaming['chunks']} chunks, "
              f"{streaming['participants']} participants x {streaming['dimension']} dim): loop "
              f"{streaming['chunk_loop_ms']:.4f} ms + finish {streaming['finish_ms']:.4f} ms "
              f"(comm fraction {streaming['comm_fraction']:.2%})", file=sys.stderr)

    if device_type == "cuda":
        from sda_tpu_torch.utils.profiling import card_line

        where = {"platform": "gpu", "device": torch.cuda.get_device_name(0), "card": card_line()}
    else:
        where = {"platform": "cpu", "device": "cpu", "card": None}
    print(json.dumps({
        "metric": "weak-scaling efficiency of sharded aggregation (mesh)",
        **where,
        "results": results,
        **({"streaming_sharded": streaming} if streaming else {}),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
