"""Run a function in a fresh process group of ``world`` ranks on one host.

The mesh runs SPMD, one process per device, and a process group cannot be
resized, so each world size the drivers need (the weak-scaling rows, a
multi-device dryrun) gets its own group of spawned processes:

- ``cpu``: gloo ranks, one CPU process each;
- ``cuda``: NCCL ranks, rank ``i`` on card ``i``; the host must have
  ``world`` cards, or it raises before anything starts.

The ranks meet through a ``FileStore`` in a temporary directory (no TCP
port). The whole group has a time limit: a rank that fails, exits with no
result or outlasts the limit fails the call, and every rank still alive is
terminated, so a hung rank never waits forever.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch

__all__ = ["spawn_ranks", "RANK_TIMEOUT_S"]

RANK_TIMEOUT_S = 600.0


def _rank_main(rank, world, store_path, device_type, timeout, fn, args, out_q):
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout))
        out_q.put((rank, "ok", fn(*args)))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), device_type: str | None = None,
                timeout: float = RANK_TIMEOUT_S) -> dict:
    """Call ``fn(*args)`` on every rank of a new ``world``-rank process
    group (``device_type`` ``"cpu"``: gloo, ``"cuda"``: NCCL; ``None``
    means ``cuda``, as in :func:`make_mesh`) and return ``{rank: result}``.
    ``fn`` and ``args`` must pickle (a module-level function). Raises if a
    rank raises, exits with no result, or the group outlasts ``timeout``
    seconds."""
    device_type = "cuda" if device_type is None else device_type
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', not {device_type!r}")
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"a world of {world} NCCL ranks needs {world} CUDA devices, "
                           f"this host has {torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="sda-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world, store, device_type, timeout, fn, tuple(args),
                                   out_q))
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        got = {}
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world:
                try:
                    rank, status, payload = out_q.get(timeout=1.0)
                except queue.Empty:
                    missing = sorted(set(range(world)) - set(got))
                    dead = [r for r in missing if procs[r].exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited with no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {missing} gave no result within "
                                           f"{timeout} s") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            for proc in procs:
                proc.join(timeout=30)
            if any(proc.is_alive() for proc in procs):
                raise RuntimeError("a rank did not exit after giving its result")
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
    return got
