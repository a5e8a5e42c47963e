"""Driver entry points: the flagship forward step and a multi-device dryrun.

Port of the reference repository's root ``__graft_entry__.py``:

- :func:`entry` returns the flagship workload's forward step
  (packed-Shamir secure aggregation over a 64-bit prime field) and its
  example inputs, on the card unless the caller asks for the CPU;
- :func:`dryrun_multichip` builds an ``n_devices`` mesh over the
  parallelism axes (participants x dimension x clerks), runs every path
  of the sharded pipeline once on tiny shapes (the CIOS step with its
  all-to-all transposition, the gen-3 and gen-4 kernel steps and streams,
  two degraded committees, a lane batch of two jobs) and checks each
  reveal exactly.

The mesh runs SPMD, one process per device. A world of one on the card
needs no launcher; a larger mesh runs on every rank of a process group the
caller has already started (``torchrun``, or
:func:`sda_tpu_torch.parallel.launch.spawn_ranks`). Unlike the reference,
nothing drops to the CPU on its own: ``device_type="cpu"`` is the only way
onto gloo ranks.

    python -m sda_tpu_torch.graft_entry [n_devices] [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """``(fn, example_args)``: the flagship forward step at 16 participants
    x 1,024 dimensions and its inputs (secrets and a seeded generator), on
    ``device`` (the card by default)."""
    from sda_tpu_torch.models import FederatedAggregation

    model = FederatedAggregation.packed_64bit(dimension=1024, device=device)
    secrets, generator = model.example_inputs(participants=16, seed=0)
    return model.forward, (secrets, generator)


def _mesh_shape(n_devices: int) -> dict[str, int]:
    """Factor n into (p, d, c) with c | 8 (the committee size)."""
    shapes = {
        1: {"p": 1, "d": 1, "c": 1},
        2: {"p": 2, "d": 1, "c": 1},
        4: {"p": 2, "d": 1, "c": 2},
        8: {"p": 2, "d": 2, "c": 2},
        16: {"p": 4, "d": 2, "c": 2},
        32: {"p": 4, "d": 2, "c": 4},
        64: {"p": 8, "d": 2, "c": 4},
    }
    if n_devices in shapes:
        return shapes[n_devices]
    # generic fallback: all devices on the participant axis
    return {"p": n_devices, "d": 1, "c": 1}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device_type: str | None = None) -> None:
    """Every path of the sharded pipeline once on an ``n_devices`` mesh
    (``_mesh_shape``), each reveal exact. ``device_type`` ``None`` means
    ``cuda``, which needs ``n_devices`` cards and raises otherwise. For
    ``n_devices > 1`` the process group must be up with that many ranks;
    a world of one is made here if none exists, and closed again."""
    import torch.distributed as dist

    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.fields import find_prime_field
    from sda_tpu_torch.parallel import ShardedAggregationPipeline, make_mesh
    from sda_tpu_torch.sharing import PackedShamirScheme

    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {torch.cuda.device_count()}; "
                           "pass device_type='cpu' to run gloo ranks on the CPU")
    if dist.is_initialized() and dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun of {n_devices} devices in a world of "
                         f"{dist.get_world_size()} ranks")
    own_world = not dist.is_initialized()
    axes = _mesh_shape(n_devices)
    mesh = make_mesh(axes, device_type)
    rank = dist.get_rank()
    try:
        p64, w2, w3 = find_prime_field(62, 8, 9)
        scheme = PackedShamirScheme(
            secret_count=3, share_count=8, privacy_threshold=4,
            prime_modulus=p64, omega_secrets=w2, omega_shares=w3,
        )
        # tiny but axis-divisible shapes: participants and batches divide the mesh
        p_count = 4 * axes["p"] * axes["c"]
        dim = 3 * 2 * axes["d"]  # nb = 2*d-axis batches
        engine = TorchAggregationEngine(scheme.device_spec(), dim, device=device_type)
        pipe = ShardedAggregationPipeline(engine, mesh)
        lanes = 128 * axes["d"]

        rng = np.random.default_rng(0)
        secrets = rng.integers(0, 1 << 31, size=(p_count, dim))
        enc = engine.encode_secrets(secrets)
        rand = engine.random_ext(p_count, rng=rng)
        expect = [int(x) % p64 for x in secrets.astype(object).sum(axis=0)]

        def reveal(out):
            return [int(x) for x in engine.decode_output(out)]

        # the CIOS step: share matmul, transposition, combine, reconstruction
        _require(reveal(pipe.aggregate(enc, rand)) == expect, "multichip dryrun reveal mismatch")
        # the gen-3 kernel step (B6 per shard, modular all-reduce, B6 reconstruction)
        ext_all = torch.cat([enc, rand], dim=2)
        out_mxu = pipe.aggregate_mxu_ext(engine.planar7_ext(ext_all, lanes=lanes))
        _require(reveal(out_mxu) == expect, "multichip MXU-kernel reveal mismatch")
        # the streaming x sharded step (BASELINE config 5: participant chunks
        # stream through per-device fused combines, one final all-reduce)
        half = p_count // 2
        chunks = [engine.planar7_ext(ext_all[i * half:(i + 1) * half], lanes=lanes)
                  for i in range(2)]
        out_stream = pipe.aggregate_mxu_streaming(chunks, ext=True)
        _require(reveal(out_stream) == expect, "multichip streaming reveal mismatch")
        # the gen-4 byte-limb step (B1, then B3), streaming in two chunks
        chunks8 = [engine.planar8_ext(ext_all[i * half:(i + 1) * half], lanes=lanes)
                   for i in range(2)]
        out8 = pipe.aggregate_mxu8_streaming(chunks8, ext=True)
        _require(reveal(out8) == expect, "multichip mxu8 streaming reveal mismatch")
        # degraded committees: drop share_count - reconstruction_threshold = 1
        # clerk; each subset reveals the same aggregate through its Lagrange
        # matrix applied by the same kernel
        _require(scheme.share_count - scheme.reconstruction_threshold >= 1,
                 "the scheme leaves no clerk to drop")
        for subset in ([i for i in range(scheme.share_count) if i != 0],
                       [i for i in range(scheme.share_count) if i != 5]):
            out_deg = pipe.aggregate_mxu8_streaming(
                chunks8, ext=True, indices=subset,
                subset_matrix=scheme.reconstruct_matrix(subset))
            _require(reveal(out_deg) == expect, f"degraded-committee reveal mismatch {subset}")
        # lane-batched serving: two jobs share one sharded launch; each job's
        # slice reveals its own participant sum
        secrets_b = rng.integers(0, 1 << 31, size=(p_count, dim))
        ext_b = torch.cat([engine.encode_secrets(secrets_b),
                           engine.random_ext(p_count, rng=rng)], dim=2)
        job_a = engine.planar8_ext(ext_all, lanes=lanes)
        job_b = engine.planar8_ext(ext_b, lanes=lanes)
        out_lb = pipe.aggregate_mxu8_streaming([engine.concat_jobs_lanes([job_a, job_b])],
                                               ext=True)
        nbp_job = job_a.shape[1]
        expect_b = [int(x) % p64 for x in secrets_b.astype(object).sum(axis=0)]
        for j, want in enumerate((expect, expect_b)):
            got = reveal(out_lb[j * nbp_job: j * nbp_job + engine.nb])
            _require(got == want, f"lane-batched job {j} reveal mismatch")
    finally:
        if own_world:
            dist.destroy_process_group()
    if rank == 0:
        print(
            f"dryrun_multichip OK: mesh={axes} participants={p_count} dim={dim} "
            f"field=64-bit prime ({p64}); jnp + MXU-kernel + streaming-sharded "
            f"+ byte-limb (gen-4) paths agree; degraded-committee (P4, 2 subsets) "
            f"+ lane-batched serving steps exact on the mesh"
        )


def _dryrun_rank(n_devices: int, device_type: str) -> None:
    dryrun_multichip(n_devices, device_type)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="graft_entry", description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if args.n_devices == 1:
        dryrun_multichip(1, device_type)
    else:
        from sda_tpu_torch.parallel.launch import spawn_ranks

        spawn_ranks(_dryrun_rank, args.n_devices, (args.n_devices, device_type), device_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
