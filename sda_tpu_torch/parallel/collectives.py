"""Modular collectives over the axes of a ``DeviceMesh``.

Port of the reference package's ``parallel/collectives.py``. A plain
all-reduce adds limbs as integers and leaves a redundant, carry-delayed
representation; these collectives exchange tensors with the other ranks of
one mesh axis and add them with the limb context's modular adds, so every
cross-device reduction stays canonical mod p.

They are SPMD calls: every rank of the axis calls them with a tensor of the
same shape. Each returns ``x`` itself when its axis has size 1, so a world
of one device runs no collective at all. ``x`` holds ``[..., L]`` limb
tensors (limb axis last), as :class:`~sda_tpu_torch.ops.limbs.LimbContext`
takes them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sda_tpu_torch.ops.limbs import LimbContext

__all__ = ["psum_mod", "reduce_scatter_mod", "all_gather_axis", "all_to_all_axis"]


def _exchange(x: torch.Tensor, group, peer: int) -> torch.Tensor:
    """Send ``x`` to the axis rank ``peer`` and receive its tensor of the
    same shape (one paired send and receive)."""
    x = x.contiguous()
    other = torch.empty_like(x)
    peer = dist.get_global_rank(group, peer)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer, group),
        dist.P2POp(dist.irecv, other, peer, group),
    ])
    for req in reqs:
        req.wait()
    return other


def _gather(x: torch.Tensor, group, n: int) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def psum_mod(ctx: LimbContext, x, mesh, axis: str):
    """All-reduce modular sum over the mesh axis ``axis``.

    ``log2(n)`` exchange + ``add_mod`` steps (recursive doubling) on an axis
    whose size is a power of two; any other size gathers the axis and sums
    it locally. Both leave the same canonical limbs on every rank.
    """
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    group = mesh.get_group(axis)
    if n & (n - 1) == 0:
        me = mesh.get_local_rank(axis)
        shift = 1
        while shift < n:
            x = ctx.add_mod(x, _exchange(x, group, me ^ shift))
            shift <<= 1
        return x
    return ctx.sum_mod(torch.stack(_gather(x, group, n)), axis=0)


def reduce_scatter_mod(ctx: LimbContext, x, mesh, axis: str, scatter_axis: int):
    """Reduce-scatter modular sum: rank ``i`` of ``axis`` ends with slice
    ``i`` of the reduced tensor along ``scatter_axis`` (recursive halving on
    a power-of-two axis, else the all-reduce and a slice).

    This is the collective that lands each clerk's jobs on its own device:
    the server-side transposition.
    """
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    size = x.shape[scatter_axis]
    if size % n != 0:
        raise ValueError("scatter axis not divisible by axis size")
    me = mesh.get_local_rank(axis)
    if n & (n - 1) != 0:
        full = psum_mod(ctx, x, mesh, axis)
        return full.narrow(scatter_axis, me * (size // n), size // n)
    # recursive halving: at each step send the half this rank does not keep
    # to the partner across that bit, and add the partner's half of the one
    # it keeps
    group = mesh.get_group(axis)
    step = n >> 1
    while step >= 1:
        lo, hi = x.split(x.shape[scatter_axis] // 2, dim=scatter_axis)
        keep_hi = (me & step) > 0
        kept, outgoing = (hi, lo) if keep_hi else (lo, hi)
        x = ctx.add_mod(kept, _exchange(outgoing, group, me ^ step))
        step >>= 1
    return x


def all_gather_axis(x, mesh, axis: str, dim: int):
    """Tiled all-gather over the mesh axis ``axis``: the ranks' tensors
    concatenated along ``dim`` in axis order."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    return torch.cat(_gather(x, mesh.get_group(axis), n), dim=dim)


def all_to_all_axis(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """Tiled all-to-all over the mesh axis ``axis``: ``x`` is cut into ``n``
    equal pieces along ``split_dim``, piece ``j`` goes to axis rank ``j``,
    and the pieces received are concatenated along ``concat_dim`` in the
    order of their senders."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    if x.shape[split_dim] % n != 0:
        raise ValueError("split axis not divisible by axis size")
    pieces = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    got = torch.empty_like(pieces)
    dist.all_to_all_single(got, pieces, group=mesh.get_group(axis))
    return torch.cat(got.unbind(0), dim=concat_dim)
