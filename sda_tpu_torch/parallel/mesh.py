"""Mesh construction and the sharded aggregation pipeline.

Port of the reference package's ``parallel/mesh.py``. Participants are
sharded over the mesh axes ``"p"`` and ``"c"`` jointly (data parallel),
packed batches or lanes over ``"d"``, and committee shares over ``"c"``
(the clerk axis). The plain step is:

1. local share generation (the CIOS modular matmul, no communication);
2. an all-to-all over ``"c"`` that regroups the shares so each rank of the
   clerk axis owns its clerks' slices (the server-side transposition);
3. the local combine over resident participants, then ``psum_mod`` over
   ``"p"`` (the clerk combine);
4. an all-gather of the clerk axis and the local reconstruction.

The kernel steps run the fused share + combine kernels on each shard's
participants (B6 for the 7-bit path, B1 for the byte-limb path, B3 for the
byte-limb streaming loop's later chunks), all-reduce the per-clerk partial
sums modularly over ``"p"`` and ``"c"``, and reconstruct with one more
launch of the same kernel.

The reference runs this single-controller, one ``shard_map`` over the
mesh. Here it is SPMD: one process per device under ``torch.distributed``,
each running the same calls. The API contract is the reference's as its
callers see it:

- every entry point takes **global** tensors, and each rank reads its own
  block (:meth:`ShardedAggregationPipeline.shard_planar`), as
  ``jax.device_put`` onto the reference's ``NamedSharding`` does;
- every entry point returns the **global** output on every rank: ``[nb, k,
  L]`` for the plain step, ``[NBP, k, L]`` for the kernel steps (slice to
  ``engine.nb`` rows), with one tiled all-gather over ``"d"`` at the end.

On one device every axis has size 1 and no collective runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from sda_tpu_torch.engine import TorchAggregationEngine
from sda_tpu_torch.ops.modmat import modmat, uniform_limbs
from sda_tpu_torch.ops.mxu8 import run_mxu8
from sda_tpu_torch.ops.mxu_kernel import run_mxu
from sda_tpu_torch.parallel.collectives import all_gather_axis, all_to_all_axis, psum_mod

__all__ = ["make_mesh", "local_seed", "ShardedAggregationPipeline"]

_AXES = ("p", "d", "c")
_LANES_MAX = 512  # the reference's per-shard lane width: min(512, NBP_loc)
_INT32 = 1 << 31


def make_mesh(axis_sizes: dict[str, int], device_type: str | None = None):
    """A named ``DeviceMesh``, e.g. ``make_mesh({"p": 2, "d": 2, "c": 2})``,
    with ``mesh_dim_names`` in the order given.

    ``device_type`` ``None`` means ``cuda``, which raises with no card:
    nothing drops to the CPU on its own. The mesh's size must equal the
    world size. A one-device mesh with no process group creates a world of
    one itself (NCCL on ``cuda``, gloo on ``cpu``, through a ``HashStore``),
    so one card needs no launcher; a larger mesh needs the caller to have
    initialised the group (``torchrun``, or ``init_process_group``).
    """
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[n]) for n in names)
    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' to run on the CPU"
        )
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a mesh of {size} devices needs an initialised process group of {size} ranks "
                "(torchrun, or torch.distributed.init_process_group)"
            )
        if device_type == "cuda":
            torch.cuda.init()  # the world of one runs on the current device
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != size:
        raise ValueError(f"the mesh has {size} devices but the world has "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def local_seed(seed: int, idx: int, n_shards: int, grid_n: int) -> int:
    """The PRNG seed of participant shard ``idx`` of ``n_shards`` whose launch
    covers ``grid_n`` lane blocks, for the caller's ``seed``: the
    reference's collision-free window schedule in Python ints.

    Every shard gets a disjoint ``grid_n``-wide window and every seed a
    disjoint ``n_shards * grid_n``-wide one; the seed is folded into
    ``[0, 2^31 // stride)`` first, so the result fits int32. The port's
    kernels key Philox with it, so each shard draws its own stream."""
    seed = int(seed)
    if not -_INT32 <= seed < _INT32:
        raise ValueError(f"seed {seed} does not fit int32")
    windows = min(max(1, _INT32 // (n_shards * grid_n)), _INT32 - 1)
    return ((seed % windows) * n_shards + idx) * grid_n


class ShardedAggregationPipeline:
    """The aggregation step over a ``(p, d, c)`` mesh, one rank per device.

    ``engine`` runs on the mesh's device type; each rank builds its own."""

    def __init__(self, engine: TorchAggregationEngine, mesh):
        if tuple(sorted(mesh.mesh_dim_names or ())) != tuple(sorted(_AXES)):
            raise ValueError(f"the mesh needs the axes {_AXES}, not {mesh.mesh_dim_names}")
        if engine.device.type != mesh.device_type:
            raise ValueError(f"the engine runs on {engine.device.type}, the mesh on "
                             f"{mesh.device_type}")
        self.engine = engine
        self.mesh = mesh
        self.axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n_c = self.axes["c"]
        if engine.spec.share_count % n_c != 0:
            raise ValueError("clerk axis size must divide share_count")
        self.n_shards = self.axes["p"] * n_c
        self.shard_index = mesh.get_local_rank("p") * n_c + mesh.get_local_rank("c")

    # ------------------------------------------------------------ sharding

    def shard_planar(self, x):
        """This rank's block of a global tensor, on the engine's device:
        dimension 0 (participant rows) over ``("p", "c")`` row-major, in
        the order of :attr:`shard_index`, and dimension 1 (lanes or
        batches) over ``"d"``."""
        n_d = self.axes["d"]
        rows, cols = x.shape[0], x.shape[1]
        if rows % self.n_shards or cols % n_d:
            raise ValueError(f"a tensor of shape {tuple(x.shape)} does not divide over "
                             f"{self.n_shards} participant shards and {n_d} lane shards")
        r, c = rows // self.n_shards, cols // n_d
        d = self.mesh.get_local_rank("d")
        block = x[self.shard_index * r : (self.shard_index + 1) * r, d * c : (d + 1) * c]
        return block.to(self.engine.device).contiguous()

    def shard_inputs(self, secrets_limbs):
        """This rank's block of ``[P, nb, s, L]`` limbs: participants over
        ``("p", "c")``, batches over ``"d"``."""
        return self.shard_planar(secrets_limbs)

    def _local_seed(self, seed, nbp: int, lanes: int) -> int:
        return local_seed(seed, self.shard_index, self.n_shards, nbp // lanes)

    def _psum_shards(self, x):
        """Modular all-reduce of a ``[..., L]`` partial sum over the
        participant shards."""
        ctx = self.engine.ctx
        return psum_mod(ctx, psum_mod(ctx, x, self.mesh, "p"), self.mesh, "c")

    # ----------------------------------------------- plain (CIOS) step

    def aggregate(self, secrets_limbs, randomness_limbs):
        """``[P, nb, k, L]`` secrets + ``[P, nb, r, L]`` randomness (global)
        -> the combined ``[nb, k, L]``."""
        eng, ctx, mesh = self.engine, self.engine.ctx, self.mesh
        ext = torch.cat([self.shard_inputs(secrets_limbs).to(torch.int64),
                         self.shard_inputs(randomness_limbs).to(torch.int64)], dim=2)
        shares = modmat(ctx, ext, eng.share_mat)  # [P_loc, nb_loc, n, L]
        # the transposition: each rank of "c" keeps its clerks' shares for
        # n_c x more participants, [P_loc * n_c, nb_loc, n / n_c, L]
        shares = all_to_all_axis(shares, mesh, "c", split_dim=2, concat_dim=0)
        combined = psum_mod(ctx, ctx.sum_mod(shares, axis=0), mesh, "p")
        combined = all_gather_axis(combined, mesh, "c", 1)  # [nb_loc, n, L]
        return all_gather_axis(modmat(ctx, combined, eng.rec_mat), mesh, "d", 0)

    def aggregate_from_key(self, secrets_limbs, generator: torch.Generator):
        """:meth:`aggregate` with the randomness drawn from ``generator`` on
        the engine's device. Every rank draws the whole ``[P, nb, r, L]``
        block and keeps its own part, so the caller seeds the generator
        alike on every rank."""
        rand_shape = tuple(secrets_limbs.shape[:2]) + (self.engine.spec.randomness_count,)
        return self.aggregate(secrets_limbs, uniform_limbs(self.engine.ctx, generator, rand_shape))

    # ------------------------------------------------ gen-3 (B6) steps

    def _mxu_partial(self, sec7, seed, slots: int):
        """This shard's per-clerk sums ``[n, L, NBP_loc]`` (int32) of one
        planar chunk through B6. ``slots`` is ``k`` (randomness from the
        kernel's PRNG) or ``k + r`` (the caller's)."""
        eng = self.engine
        L7 = eng._require_mxu().L7
        x = self.shard_planar(sec7)
        rows, nbp = x.shape
        if rows % (slots * L7):
            raise ValueError(f"{rows} planar rows are not whole participants of {slots} slots")
        lanes = min(_LANES_MAX, nbp)
        plan = eng._plan7("combine", rows, rows // (slots * L7), x.device)
        return run_mxu(plan, x, self._local_seed(seed, nbp, lanes), lanes=lanes)

    def _mxu_finish(self, part):
        """All-reduce the partial sums, reconstruct through one B6 launch and
        gather: ``[NBP, k, L]``."""
        eng = self.engine
        mxu = eng._require_mxu()
        x = self._psum_shards(part.permute(0, 2, 1))  # [n, NBP_loc, L] canonical
        nbp = x.shape[1]
        # 7-bit planes straight from the limb-major layout: [n * L7, NBP_loc]
        c7 = mxu.limbs7_from_16(x.permute(0, 2, 1), dim=1).reshape(-1, nbp)
        plan = eng._plan7("reconstruct", c7.shape[0], 1, c7.device)
        rec = run_mxu(plan, c7, 0, lanes=min(_LANES_MAX, nbp))  # [k, L, NBP_loc]
        return all_gather_axis(rec.permute(2, 0, 1), self.mesh, "d", 0)

    def aggregate_mxu(self, sec7, seed):
        """``[P*k*L7, NBP]`` int8 planar secrets (``engine.planar7_secrets``),
        randomness from the kernel's PRNG with a seed per shard
        (:func:`local_seed`). Returns ``[NBP, k, L]``."""
        return self._mxu_finish(self._mxu_partial(sec7, seed, self.engine.spec.secret_count))

    def aggregate_mxu_ext(self, ext7):
        """The caller's randomness: ``[P*(k+r)*L7, NBP]`` planar."""
        spec = self.engine.spec
        return self._mxu_finish(self._mxu_partial(ext7, 0, spec.secret_count
                                                  + spec.randomness_count))

    def aggregate_mxu_streaming(self, chunks, seed0: int = 0, ext: bool = False):
        """Participant streaming on the mesh: ``chunks`` yields global planar
        tensors ``[P_chunk*slots*L7, NBP]`` (or callables ``f(i)``). Chunk
        ``i`` runs B6 on each shard at seed ``seed0 + 7919*i`` and adds onto
        the shard's local sums (torch ``add_mod``, no collective in the
        loop); one all-reduce and one B6 reconstruction finish. ``ext``
        selects the caller's randomness (the protocol path); the PRNG seed
        schedule decorrelates benchmarks and is no CSPRNG. Returns ``[NBP,
        k, L]``."""
        spec, ctx = self.engine.spec, self.engine.ctx
        slots = spec.secret_count + (spec.randomness_count if ext else 0)
        acc = None
        for i, chunk in enumerate(chunks):
            sec7 = chunk(i) if callable(chunk) else chunk
            part = self._mxu_partial(sec7, seed0 + 7919 * i, slots)
            if acc is None:
                acc = part
            else:  # int32 lanes hold every step of the canonical add exactly
                acc = torch.stack(ctx.add_mod_lanes(acc.unbind(1), part.unbind(1)), dim=1)
        if acc is None:
            raise ValueError("aggregate_mxu_streaming requires at least one chunk")
        return self._mxu_finish(acc)

    # ------------------------------------------- gen-4 (B1, B3) steps

    def mxu8_partials(self, chunks, seed0: int = 0, ext: bool = False):
        """The byte-limb chunk loop: ``chunks`` yields global biased planar
        tensors ``[P_chunk*slots*L8, NBP]`` (or callables ``f(i)``); chunk
        ``i`` runs at seed ``seed0 + i`` (per shard, :func:`local_seed`).
        The first chunk's sums come from B1, every later chunk adds onto the
        same buffer in the kernel (B3). Returns this shard's running
        per-clerk sums ``[L*n, NBP_loc]`` int32, limb-major: what
        :meth:`aggregate_mxu8_degraded` finishes."""
        eng, spec = self.engine, self.engine.spec
        L8 = eng._require_mxu8().L8
        slots = spec.secret_count + (spec.randomness_count if ext else 0)
        acc = None
        for i, chunk in enumerate(chunks):
            sec8 = chunk(i) if callable(chunk) else chunk
            x = self.shard_planar(sec8)
            rows, nbp = x.shape
            if rows % (slots * L8):
                raise ValueError(f"{rows} planar rows are not whole participants of {slots} slots")
            lanes = min(_LANES_MAX, nbp)
            plan = eng._plan("combine", rows, rows // (slots * L8), x.device)
            acc = run_mxu8(plan, x, self._local_seed(seed0 + i, nbp, lanes), lanes=lanes,
                           acc_in=acc)
        if acc is None:
            raise ValueError("aggregate_mxu8_streaming requires at least one chunk")
        return acc

    def _mxu8_finish(self, part, clerks=None):
        """All-reduce the partial sums, reconstruct through the engine's
        :meth:`~sda_tpu_torch.engine.TorchAggregationEngine.reconstruct_lm`
        (from the ``clerks`` rows alone when given) and gather: ``[NBP, k2,
        L]``."""
        eng, L = self.engine, self.engine.ctx.L
        x = self._psum_shards(part.reshape(L, eng.spec.share_count, -1).permute(1, 2, 0))
        nbp = x.shape[1]
        comb = x.permute(2, 0, 1).reshape(-1, nbp)  # limb-major [L * n, NBP_loc]
        rec = eng.reconstruct_lm(comb, min(_LANES_MAX, nbp), clerks)
        return all_gather_axis(rec.reshape(L, -1, nbp).permute(2, 1, 0), self.mesh, "d", 0)

    def aggregate_mxu8(self, sec8, seed):
        """One gen-4 step: ``sec8`` ``[P*k*L8, NBP]`` biased planar bytes
        (``engine.planar8_secrets``), randomness from the kernel's PRNG with
        a seed per shard; B1 per shard, then a B1 reconstruction. Returns
        ``[NBP, k, L]``."""
        return self._mxu8_finish(self.mxu8_partials([sec8], seed))

    def aggregate_mxu8_streaming(self, chunks, seed0: int = 0, ext: bool = False,
                                 indices=None, subset_matrix=None):
        """Streaming gen-4 aggregation on the mesh (:meth:`mxu8_partials`),
        one all-reduce and one B1 reconstruction. ``ext`` selects the
        caller's randomness (the protocol path). ``indices`` +
        ``subset_matrix``: finish from a degraded committee
        (:meth:`aggregate_mxu8_degraded`). Returns ``[NBP, k, L]``."""
        part = self.mxu8_partials(chunks, seed0, ext)
        if indices is not None:
            return self.aggregate_mxu8_degraded(part, indices, subset_matrix)
        return self._mxu8_finish(part)

    def aggregate_mxu8_degraded(self, part, indices, subset_matrix=None):
        """Finish from a degraded committee: reconstruct from the ``indices``
        clerks only (any ``reconstruction_threshold`` of ``share_count``)
        with the scheme's subset Lagrange matrix, the engine's threshold
        reconstruction (its subset plans, cached by ``indices``), through
        the same launch as the full finish. ``subset_matrix``, when given
        (the reference pipeline's argument,
        ``PackedShamirScheme.reconstruct_matrix(indices)``), must equal the
        matrix the engine builds from the scheme. ``part`` is this rank's
        partial sums from :meth:`mxu8_partials`. Returns ``[NBP, k2, L]``."""
        if subset_matrix is not None and not np.array_equal(
                np.asarray(subset_matrix, dtype=object),
                np.asarray(self.engine.spec.subset_matrix(indices), dtype=object)):
            raise ValueError("subset_matrix is not the scheme's Lagrange matrix for indices")
        return self._mxu8_finish(part, indices)
