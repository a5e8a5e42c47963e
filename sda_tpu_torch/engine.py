"""The bulk secure-aggregation executor, on PyTorch tensors.

Port of the reference package's ``engine.py``. The pipeline mirrors the
protocol's call stacks with the host/device boundary drawn at the field
math:

- participant side: share generation (the per-participant NTT pipeline
  folded into one modular matmul);
- clerk side: the combine (modular sum over participants);
- recipient side: reconstruction (inverse transform matmul).

Four kernel generations compute it. The plain CIOS route (``share`` /
``combine`` / ``reconstruct`` / ``aggregate``) is limb-tensor code on any
device. The kernel routes run share generation with in-kernel randomness,
the combine and (mostly) the reconstruction in hand-written CUDA kernels —
on a CPU tensor, in their plain versions:

- gen 1, CIOS on planar u32 tiles (:mod:`sda_tpu_torch.ops.pallas_kernels`,
  B7): ``aggregate_fused``, ``aggregate_fused_ext`` and
  ``aggregate_fused_streaming``, each followed by the CIOS ``reconstruct``;
- gen 3, 7-bit int8 limbs (:mod:`sda_tpu_torch.ops.mxu_kernel`, B6):
  ``aggregate_mxu_kernel`` (one launch with fused reconstruction),
  ``mxu_kernel_combined`` and ``aggregate_mxu_kernel_streaming`` (one launch
  per chunk, a torch ``add_mod``, one reconstruction launch); beside them
  the plain-product route of :mod:`sda_tpu_torch.ops.mxu` (``aggregate_mxu``,
  ``aggregate_mxu_ext``, ``aggregate_mxu_streaming``, ``share_mxu``), whose
  int8 matmul is ``torch._int_mm`` on the card;
- gen 4, byte limbs (:mod:`sda_tpu_torch.ops.mxu8`):

  - ``aggregate_mxu8_kernel``: one participant chunk, one launch (B1);
  - ``aggregate_mxu8_kernel_chunked``: stacked chunks, one call (B2: the
    K work split across blocks, then an epilogue kernel);
  - ``aggregate_mxu8_kernel_streaming``: chunks from the host, one launch
    each onto one running accumulator (B1, then B3), then
    ``reconstruct_planar8`` (B1), from every clerk or from the clerks that
    reported (``clerks=``, any threshold of them, through the scheme's
    subset Lagrange matrix);
  - ``concat_jobs_lanes`` + ``aggregate_mxu8_kernel_jobs``: many same-shape
    small jobs side by side on the lane axis, one launch (B1).

:func:`device_combine` is the bulk modular sum of many int64 vectors (the
clerk combine, and the Full-mask reveal of :mod:`sda_tpu_torch.masking`)
as plain int64 tensor code on the device.

The engine runs on ``cuda`` unless the caller passes another device.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import cached_property

import numpy as np
import torch

from sda_tpu_torch.fields import PrimeField
from sda_tpu_torch.ops.limbs import LimbContext, limbs_from_numpy
from sda_tpu_torch.ops.modmat import combine, modmat, uniform_limbs
from sda_tpu_torch.ops.mxu import MxuContext, mxu_modmat
from sda_tpu_torch.ops.mxu_kernel import (
    batched_from_planar16,
    mxu_plan,
    planar7_from_batched,
    run_mxu,
)
from sda_tpu_torch.ops.mxu8 import (
    Mxu8Context,
    batched_from_planar_lm,
    mxu8_plan,
    planar8_from_batched,
    run_mxu8,
)
from sda_tpu_torch.ops.pallas_kernels import (
    batched_from_planar,
    fused_share_combine_planar,
    planar_from_batched,
)
from sda_tpu_torch.sharing import DeviceSchemeSpec
from sda_tpu_torch.utils.device import resolve_device
from sda_tpu_torch.utils.logging import span

__all__ = [
    "TorchAggregationEngine",
    "device_combine",
    "limbs_from_numpy",
    "spec_from_numpy",
]

# decode_output calls that took the int64 route (below a modulus of 2^63):
# each launches the limbs' recombine and one copy to the host.
decode_i64_launches = 0
# reconstructions from a subset of the clerks (one kernel launch each)
subset_reconstruct_launches = 0
# subset plans an engine keeps, the least recently used dropped first
SUBSET_PLANS = 8


def _add_mod_i64(a: torch.Tensor, b: torch.Tensor, modulus: int) -> torch.Tensor:
    """``(a + b) mod p`` of canonical int64 tensors, ``p < 2**63``, with no
    overflow: ``a - (p - b)`` lies in ``(-p, p)``."""
    s = a - (modulus - b)
    return torch.where(s < 0, s + modulus, s)


def _sum_mod_i64(x: torch.Tensor, modulus: int) -> torch.Tensor:
    """Modular sum over axis 0 of canonical int64 ``[C, d]``: a tree of
    :func:`_add_mod_i64`, every intermediate canonical."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = _add_mod_i64(x[:half], x[half : 2 * half], modulus)
        x = torch.cat([s, x[2 * half :]]) if x.shape[0] % 2 else s
    return x[0]


def _host_floor_mod(arr: np.ndarray, modulus: int) -> np.ndarray:
    """Exact host floor-mod of a chunk holding values outside ``(-p, p)``."""
    return np.ascontiguousarray(arr % modulus)


def device_combine(modulus: int, share_vectors, chunk_size: int = 256, device=None) -> np.ndarray:
    """Bulk modular sum of many vectors on the device.

    The clerk-side sum of many participants' share vectors, and the
    Full-mask reveal's sum of every participant's mask. Returns canonical
    ``[0, p)`` int64 values, protocol-equivalent to the reference's signed
    fold (representatives may differ; reveal-side ``positive()`` agrees).
    Odd or even modulus, any width below 2**63.

    ``share_vectors`` may be any iterable (including a generator draining
    decryptions): vectors stream through the device accumulator in
    ``chunk_size``-vector chunks, so peak host memory is O(chunk_size x
    dimension). The tail chunk is summed at its own length: the reference
    zero-pads it to keep one compiled XLA shape, which eager torch does
    not need.

    The reference staged each chunk as (lo, hi) u32 pairs because the TPU
    has no int64; the card has it, so each chunk ships as int64, trunc-
    domain negatives in ``(-p, 0)`` become canonical by adding p, and the
    chunk is summed with exact int64 modular adds. Values outside ``(-p,
    p)`` (never produced by the protocol, possible from a hostile wire) take
    a host floor-mod for that chunk first; in-domain chunks never do.
    """
    if modulus >= (1 << 63):
        raise ValueError("device_combine requires a modulus below 2**63")
    dev = resolve_device(device)
    acc = None

    def flush(acc, buf):
        arr = np.ascontiguousarray(np.asarray(buf, dtype=np.int64))
        # min/max (not abs: abs(INT64_MIN) wraps) guard the (-p, p) domain
        if arr.size and not (int(arr.min()) > -modulus and int(arr.max()) < modulus):
            arr = _host_floor_mod(arr, modulus)
        x = torch.from_numpy(arr).to(dev)
        part = _sum_mod_i64(torch.where(x < 0, x + modulus, x), modulus)
        return part if acc is None else _add_mod_i64(acc, part, modulus)

    buf: list[np.ndarray] = []
    for v in share_vectors:
        buf.append(np.asarray(v, dtype=np.int64))
        if len(buf) == chunk_size:
            acc = flush(acc, buf)
            buf = []
    if buf:
        acc = flush(acc, buf)
    if acc is None:
        raise ValueError("device_combine requires at least one share vector")
    return acc.cpu().numpy()


def spec_from_numpy(modulus, secret_count, share_count, randomness_count,
                    share_matrix, reconstruct_matrix) -> DeviceSchemeSpec:
    """A scheme spec from plain values (e.g. the fields of another
    package's spec): matrices become object arrays of python ints."""
    return DeviceSchemeSpec(
        modulus=int(modulus),
        secret_count=int(secret_count),
        share_count=int(share_count),
        randomness_count=int(randomness_count),
        share_matrix=np.vectorize(int, otypes=[object])(np.asarray(share_matrix, dtype=object)),
        reconstruct_matrix=np.vectorize(int, otypes=[object])(
            np.asarray(reconstruct_matrix, dtype=object)
        ),
    )


class TorchAggregationEngine:
    """Bulk executor for one (scheme, dimension) configuration.

    Data layout: secrets ``[P, d]`` become ``[P, nb, k, L]`` int64 limb
    tensors (``nb = ceil(d/k)`` batches of ``k`` packed secrets). Shares are
    ``[P, nb, n, L]``; the clerk axis ``n`` is the distribution axis.
    """

    def __init__(self, spec: DeviceSchemeSpec, dimension: int, device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.dimension = dimension
        self.ctx = LimbContext.create(spec.modulus)
        self.nb = -(-dimension // spec.secret_count)
        # 7-bit and byte-limb kernel paths: odd moduli wider than 7 bits. The
        # matrices each path needs are built on its first use (below): at
        # hundreds of clerks, in Python ints, they take seconds.
        self.mxu: MxuContext | None = None
        self.mxu8: Mxu8Context | None = None
        if spec.modulus % 2 == 1 and spec.modulus.bit_length() > 7:
            self.mxu = MxuContext.create(self.ctx)
            self.mxu8 = Mxu8Context.create(self.ctx)
        self._big_tiles: dict = {}
        self._plans: dict = {}
        self._subset_plans: OrderedDict = OrderedDict()

    # Montgomery-form matrices on the device; mont_mul(normal, mont) = product
    @cached_property
    def share_mat(self) -> torch.Tensor:
        return self.ctx.encode_mont(self.spec.share_matrix, self.device)

    @cached_property
    def rec_mat(self) -> torch.Tensor:
        return self.ctx.encode_mont(self.spec.reconstruct_matrix, self.device)

    # the gen-3 slot matrices: raw double-width randomness slots (PRNG) and
    # canonical slots, each with its output columns
    def _slots(self, kind: str) -> list[int]:
        L7, k, r = self._require_mxu().L7, self.spec.secret_count, self.spec.randomness_count
        return [L7] * k + ([2 * L7] * r if kind == "raw" else [L7] * r)

    @cached_property
    def _big_raw(self) -> np.ndarray:
        return self._require_mxu().matrix_int8(self.spec.share_matrix, self._slots("raw"))

    @cached_property
    def _big_can(self) -> np.ndarray:
        return self._require_mxu().matrix_int8(self.spec.share_matrix, self._slots("can"))

    @cached_property
    def _cols_raw(self):
        return self._require_mxu().out_cols(self._slots("raw"))

    @cached_property
    def _cols_can(self):
        return self._require_mxu().out_cols(self._slots("can"))

    # ---------------------------------------------------- CIOS limb path

    def share(self, ext):
        """``[P, nb, k+r, L] -> [P, nb, n, L]``."""
        return modmat(self.ctx, ext, self.share_mat)

    def combine(self, shares):
        """``[P, nb, n, L] -> [nb, n, L]``."""
        return combine(self.ctx, shares, axis=0)

    def reconstruct(self, combined):
        """``[nb, n, L] -> [nb, k, L]``."""
        return modmat(self.ctx, combined, self.rec_mat)

    def aggregate(self, secrets, randomness):
        ext = torch.cat([secrets.to(torch.int64), randomness.to(torch.int64)], dim=2)
        return self.reconstruct(self.combine(self.share(ext)))

    def aggregate_from_key(self, secrets, generator: torch.Generator):
        rand = uniform_limbs(
            self.ctx, generator, tuple(secrets.shape[:2]) + (self.spec.randomness_count,)
        )
        return self.aggregate(secrets, rand)

    # ------------------------------------------ gen-1 CIOS planar kernel (B7)

    def _fused_combined(self, x, seed, rows: int):
        """One participant chunk ``[P, nb, slots, L]`` through B7 -> the
        per-clerk combined shares ``[nb, n, L]``. ``slots == k`` draws the
        randomness in the kernel from ``seed``; ``k + r`` slots carry the
        caller's."""
        planar = planar_from_batched(x, rows)
        out = fused_share_combine_planar(
            self.ctx, planar, self.share_mat, self.spec.randomness_count,
            seed=int(seed), rows=rows,
        )
        return batched_from_planar(out, self.nb)

    def aggregate_fused(self, secrets, seed, rows: int = 8):
        """Share + combine in one B7 launch (randomness drawn in the kernel),
        then the CIOS reconstruction. ``secrets`` ``[P, nb, k, L]``."""
        return self.reconstruct(self._fused_combined(secrets, seed, rows))

    def aggregate_fused_ext(self, ext, rows: int = 8):
        """B7 with the caller's (host-CSPRNG) randomness: ``ext`` ``[P, nb,
        k + r, L]``; then the CIOS reconstruction."""
        return self.reconstruct(self._fused_combined(ext, 0, rows))

    def aggregate_fused_streaming(self, chunks, seed0: int = 0, rows: int = 8):
        """Participant streaming: ``chunks`` yields ``[P_chunk, nb, slots, L]``
        tensors (or callables ``f(i)``); chunk ``i`` runs B7 with seed
        ``seed0 + i``, the per-clerk sums add mod p across chunks, and the
        CIOS reconstruction reveals."""
        acc = None
        for i, chunk in enumerate(chunks):
            x = chunk(i) if callable(chunk) else chunk
            part = self._fused_combined(x, seed0 + i, rows)
            acc = part if acc is None else self.ctx.add_mod(acc, part)
        if acc is None:
            raise ValueError("aggregate_fused_streaming requires at least one chunk")
        return self.reconstruct(acc)

    # ---------------------------------------------- gen-3 7-bit int8 path

    def _require_mxu(self) -> MxuContext:
        if self.mxu is None:
            raise ValueError("the 7-bit path needs an odd modulus wider than 7 bits")
        return self.mxu

    def _tiled_big(self, kind: str, p_count: int, device) -> torch.Tensor:
        """The slot matrix tiled ``p_count`` times along its rows, cached on
        ``device``: ``kind`` ``"raw"`` (PRNG) or ``"can"`` (caller)."""
        key = (kind, p_count, device)
        got = self._big_tiles.get(key)
        if got is None:
            one = self._big_raw if kind == "raw" else self._big_can
            got = torch.from_numpy(np.concatenate([one] * p_count, axis=0)).to(device)
            self._big_tiles[key] = got
        return got

    def mxu_combined_from_key(self, secrets, generator: torch.Generator):
        """``[P, nb, k, L]`` secrets -> per-clerk combined shares ``[nb, n,
        L]``: raw double-width randomness from ``generator`` (on the
        secrets' device), one int8 matmul, the carry/Montgomery epilogue."""
        mxu, spec = self._require_mxu(), self.spec
        P, k, r, L7 = secrets.shape[0], spec.secret_count, spec.randomness_count, mxu.L7
        big = self._tiled_big("raw", P, secrets.device)
        s7 = mxu.limbs7_from_16(secrets).reshape(P, self.nb, k * L7)
        bits = torch.randint(0, 1 << 32, (P, self.nb, r, mxu.raw_words), dtype=torch.int64,
                             generator=generator, device=secrets.device)
        r7 = mxu.raw_limbs(bits).reshape(P, self.nb, r * 2 * L7)
        ext = torch.cat([s7, r7], dim=-1)  # [P, nb, S]
        extT = ext.permute(1, 0, 2).reshape(self.nb, -1)
        return mxu_modmat(mxu, extT, big, spec.share_count, self._cols_raw)

    def _mxu_combined_ext(self, ext):
        mxu, spec = self._require_mxu(), self.spec
        P = ext.shape[0]
        e7 = mxu.limbs7_from_16(ext).reshape(P, self.nb, -1)
        extT = e7.permute(1, 0, 2).reshape(self.nb, -1)
        big = self._tiled_big("can", P, ext.device)
        return mxu_modmat(mxu, extT, big, spec.share_count, self._cols_can)

    def aggregate_mxu(self, secrets, generator: torch.Generator):
        """Share + combine as one int8 matmul, then the CIOS reconstruction.
        Sharing randomness is drawn double-width raw (bias <= 2^-(7*L7));
        the protocol path with host-CSPRNG randomness is
        :meth:`aggregate_mxu_ext`."""
        return self.reconstruct(self.mxu_combined_from_key(secrets, generator))

    def aggregate_mxu_ext(self, ext):
        """:meth:`aggregate_mxu` with the caller's canonical randomness:
        ``ext`` ``[P, nb, k + r, L]``."""
        return self.reconstruct(self._mxu_combined_ext(ext))

    def aggregate_mxu_streaming(self, chunks, generator: torch.Generator):
        """Participant streaming on the int8 matmul: per-chunk combined sums
        add mod p across chunks (each chunk draws its randomness from
        ``generator`` in turn)."""
        acc = None
        for i, chunk in enumerate(chunks):
            x = chunk(i) if callable(chunk) else chunk
            part = self.mxu_combined_from_key(x, generator)
            acc = part if acc is None else self.ctx.add_mod(acc, part)
        if acc is None:
            raise ValueError("aggregate_mxu_streaming requires at least one chunk")
        return self.reconstruct(acc)

    def share_mxu(self, ext):
        """Per-participant canonical shares on the int8 matmul (the
        protocol's bulk path: each participant's shares are encrypted and
        uploaded separately). ``ext`` ``[P, nb, k + r, L] -> [P, nb, n, L]``."""
        mxu, spec = self._require_mxu(), self.spec
        P = ext.shape[0]
        e7 = mxu.limbs7_from_16(ext).reshape(P * self.nb, -1)
        big = self._tiled_big("can", 1, ext.device)
        out = mxu_modmat(mxu, e7, big, spec.share_count, self._cols_can)
        return out.reshape(P, self.nb, spec.share_count, self.ctx.L)

    def planar7_secrets(self, secrets, lanes: int = 1024):
        """``[P, nb, k, L] -> [P*k*L7, NBP]`` int8 planar 7-bit limbs."""
        return planar7_from_batched(self._require_mxu(), secrets, lanes)

    def planar7_ext(self, ext, lanes: int = 1024):
        """Caller-randomness layout: ``[P, nb, k+r, L] -> [P*(k+r)*L7, NBP]``."""
        return planar7_from_batched(self._require_mxu(), ext, lanes)

    def _plan7(self, matrix: str, rows: int, p_count: int, device):
        """The cached B6 plan: ``matrix`` ``"share"`` (share + combine with
        fused reconstruction), ``"combine"`` or ``"reconstruct"``."""
        key = ("mxu7", matrix, rows, p_count, device)
        plan = self._plans.get(key)
        if plan is None:
            mxu, spec = self._require_mxu(), self.spec
            if matrix == "reconstruct":
                # the same modular matmul: p_count=1, slots=n, no randomness
                plan = mxu_plan(mxu, spec.reconstruct_matrix, rows, 1, spec.share_count, 0,
                                device=device)
            else:
                plan = mxu_plan(
                    mxu, spec.share_matrix, rows, p_count, spec.secret_count,
                    spec.randomness_count,
                    reconstruct_matrix=spec.reconstruct_matrix if matrix == "share" else None,
                    device=device,
                )
            self._plans[key] = plan
        return plan

    def aggregate_mxu_kernel(self, sec7, seed, p_count: int, lanes: int = 1024):
        """Share + combine + reconstruct in ONE launch of B6; ``sec7`` from
        :meth:`planar7_secrets` (or :meth:`planar7_ext`); returns ``[nb, k,
        L]`` int32 limbs."""
        plan = self._plan7("share", sec7.shape[0], p_count, sec7.device)
        return batched_from_planar16(run_mxu(plan, sec7, seed, lanes=lanes), self.nb)

    def mxu_kernel_combined(self, sec7, seed, p_count: int, lanes: int = 1024):
        """The same launch without reconstruction: per-clerk combined
        shares, ``[n, L, NBP]``."""
        plan = self._plan7("combine", sec7.shape[0], p_count, sec7.device)
        return run_mxu(plan, sec7, seed, lanes=lanes)

    def _reconstruct_planar16(self, comb16, lanes: int):
        """``[n, L, NBP]`` canonical combined shares -> ``[nb, k, L]`` through
        one B6 launch with one "participant", the n clerks as slots and no
        randomness."""
        mxu = self._require_mxu()
        c7 = mxu.limbs7_from_16(comb16.permute(0, 2, 1))  # [n, NBP, L7]
        c7 = c7.permute(0, 2, 1).reshape(-1, comb16.shape[-1]).contiguous()
        plan = self._plan7("reconstruct", c7.shape[0], 1, c7.device)
        return batched_from_planar16(run_mxu(plan, c7, 0, lanes=lanes), self.nb)

    def aggregate_mxu_kernel_streaming(self, chunks, p_chunk: int, seed0: int = 0,
                                       lanes: int = 1024):
        """Past one launch's participant bound: ``chunks`` yields
        ``[p_chunk*k*L7, NBP]`` planar tensors (or callables ``f(i)``). Chunk
        ``i`` runs B6 without reconstruction at seed ``seed0 + 7919*i``, the
        canonical per-clerk sums add mod p (torch code), and one more B6
        launch reconstructs."""
        acc = None
        for i, chunk in enumerate(chunks):
            sec7 = chunk(i) if callable(chunk) else chunk
            part = self.mxu_kernel_combined(sec7, seed0 + 7919 * i, p_chunk, lanes)
            if acc is None:
                acc = part
            else:  # int32 lanes hold every step of the canonical add exactly
                acc = torch.stack(self.ctx.add_mod_lanes(acc.unbind(1), part.unbind(1)), dim=1)
        if acc is None:
            raise ValueError("aggregate_mxu_kernel_streaming requires at least one chunk")
        return self._reconstruct_planar16(acc, lanes)

    # --------------------------------------------- byte-limb kernel path

    def _require_mxu8(self) -> Mxu8Context:
        if self.mxu8 is None:
            raise ValueError("the byte-limb path needs an odd modulus wider than 7 bits")
        return self.mxu8

    def planar8_secrets(self, secrets, lanes: int = 1024):
        """``[P, nb, k, L] -> [P*k*L8, NBP]`` int8 biased planar bytes."""
        return planar8_from_batched(self._require_mxu8(), secrets, lanes)

    def planar8_ext(self, ext, lanes: int = 1024):
        """Caller-randomness layout: ``[P, nb, k+r, L] -> planar``."""
        return planar8_from_batched(self._require_mxu8(), ext, lanes)

    def _plan(self, matrix: str, rows: int, p_count: int, device, n_chunks: int = 1,
              rand_participants: int | None = None):
        """The cached plan of one configuration. ``matrix`` is ``"share"``
        (share + combine, with fused reconstruction), ``"combine"`` (share +
        combine) or ``"reconstruct"`` (the reconstruction alone). The key
        holds everything the plan is built from; B1 and B3 launches of one
        shape share a plan, since B3 differs only at run time (acc_in)."""
        key = (matrix, rows, p_count, n_chunks, rand_participants, device)
        plan = self._plans.get(key)
        if plan is None:
            with span("sda.mxu8.plan"):
                mxu8, spec = self._require_mxu8(), self.spec
                if matrix == "reconstruct":
                    # the same modular matmul: p_count=1, slots=n, no randomness
                    plan = mxu8_plan(mxu8, spec.reconstruct_matrix, rows, 1, spec.share_count,
                                     0, device=device)
                else:
                    plan = mxu8_plan(
                        mxu8, spec.share_matrix, rows, p_count, spec.secret_count,
                        spec.randomness_count,
                        reconstruct_matrix=spec.reconstruct_matrix if matrix == "share" else None,
                        rand_participants=rand_participants, device=device, n_chunks=n_chunks,
                    )
            self._plans[key] = plan
        return plan

    def _fused(self, sec8, seed, p_count: int, lanes: int, reconstruct: bool,
               n_chunks: int = 1, acc_in=None, rand_participants: int | None = None):
        rows = sec8.shape[0]
        if rows % n_chunks:
            raise ValueError("sec_planar rows must divide evenly into n_chunks")
        plan = self._plan("share" if reconstruct else "combine", rows // n_chunks, p_count,
                          sec8.device, n_chunks, rand_participants)
        return run_mxu8(plan, sec8, int(seed), lanes=lanes, acc_in=acc_in)

    def aggregate_mxu8_kernel(self, sec8, seed, p_count: int, lanes: int = 1024):
        """Share + combine + reconstruct in ONE launch of the byte-limb
        kernel; ``sec8`` from :meth:`planar8_secrets`; returns ``[nb, k, L]``
        int32 limbs."""
        with span("sda.engine.aggregate"):
            out = self._fused(sec8, seed, p_count, lanes, reconstruct=True)
            return batched_from_planar_lm(out, self.nb, self.spec.secret_count)

    def mxu8_kernel_combined(self, sec8, seed, p_count: int, lanes: int = 1024):
        """The same launch without reconstruction: per-clerk combined
        shares, ``[L * n, NBP]`` limb-major."""
        return self._fused(sec8, seed, p_count, lanes, reconstruct=False)

    def subset_plan(self, clerks, device):
        """The reconstruction plan from the clerks ``clerks`` (a tuple of
        indices, in the order of the shares' rows): the scheme's subset
        Lagrange matrix (``spec.subset_matrix``) as one modular matmul with
        one "participant" and the clerks as slots. Built in int64 on a
        miss; the engine keeps the :data:`SUBSET_PLANS` used last."""
        key = (clerks, device)
        plan = self._subset_plans.get(key)
        if plan is not None:
            self._subset_plans.move_to_end(key)
            return plan
        with span("sda.sharing.lagrange"):
            mxu8 = self._require_mxu8()
            s = len(clerks)
            plan = mxu8_plan(mxu8, self.spec.subset_matrix(clerks), s * mxu8.L8, 1, s, 0,
                             device=device)
        self._subset_plans[key] = plan
        while len(self._subset_plans) > SUBSET_PLANS:
            self._subset_plans.popitem(last=False)
        return plan

    def reconstruct_lm(self, comb, lanes: int = 1024, clerks=None):
        """``[L * n, NBP]`` canonical combined shares -> ``[L * k, NBP]``
        limb-major secrets through one launch: the reconstruction is the
        same modular matmul with one "participant", the clerks as slots and
        no randomness. ``clerks``: reconstruct from these clerks' rows only
        (any ``k + r`` or more of the ``n``), with :meth:`subset_plan`."""
        global subset_reconstruct_launches
        mxu8 = self._require_mxu8()
        n, L = self.spec.share_count, self.ctx.L
        if clerks is None:
            plan = self._plan("reconstruct", n * mxu8.L8, 1, comb.device)
            return run_mxu8(plan, self._clerk_bytes(comb, n), 0, lanes=lanes)
        with span("sda.engine.reconstruct.subset"):
            clerks = tuple(int(i) for i in clerks)
            if not all(0 <= i < n for i in clerks):
                raise ValueError(f"clerk indices must lie in [0, {n})")
            plan = self.subset_plan(clerks, comb.device)
            rows = torch.tensor([l * n + i for l in range(L) for i in clerks], device=comb.device)
            out = run_mxu8(plan, self._clerk_bytes(comb.index_select(0, rows), len(clerks)), 0,
                           lanes=lanes)
            subset_reconstruct_launches += 1
            return out

    def _clerk_bytes(self, comb, s: int) -> torch.Tensor:
        """``[L * s, NBP]`` limb-major canonical shares of ``s`` clerks ->
        ``[s * L8, NBP]`` int8 biased bytes, slot-major rows (clerk i, byte
        j), the reconstruction's operand."""
        L8 = self._require_mxu8().L8
        comb = comb.to(torch.int64)
        return torch.stack(
            [((comb[(j // 2) * s : (j // 2 + 1) * s] >> (8 * (j % 2))) & 0xFF) - 128
             for j in range(L8)],
            dim=1,
        ).to(torch.int8).reshape(s * L8, -1)

    def reconstruct_planar8(self, comb, lanes: int = 1024, clerks=None):
        """``[L * n, NBP]`` canonical combined shares -> ``[nb, k, L]``
        (:meth:`reconstruct_lm`), from every clerk or from ``clerks``."""
        out = self.reconstruct_lm(comb, lanes, clerks)
        return batched_from_planar_lm(out, self.nb, self.spec.secret_count)

    def aggregate_mxu8_kernel_streaming(self, chunks, p_chunk: int, seed0: int = 0,
                                        lanes: int = 1024, clerks=None):
        """Past one launch's participant bound, with chunks from the host:
        ``chunks`` yields ``[p_chunk*k*L8, NBP]`` planar tensors (or
        callables ``f(i)``). The first chunk's canonical per-clerk sums come
        from B1, every later chunk adds onto the same buffer in place (B3),
        and :meth:`reconstruct_planar8` reveals, from the clerks ``clerks``
        alone when given (the recipient's threshold reveal). Chunk ``i``
        draws with seed ``seed0 + (NBP // lanes) * i``, as the reference's
        loop does."""
        with span("sda.engine.aggregate"):
            acc = None
            grid_size = None
            for i, chunk in enumerate(chunks):
                sec8 = chunk(i) if callable(chunk) else chunk
                if grid_size is None:
                    grid_size = sec8.shape[-1] // lanes
                seed_i = seed0 + grid_size * i
                acc = self._fused(sec8, seed_i, p_chunk, lanes, reconstruct=False, acc_in=acc)
            if acc is None:
                raise ValueError("aggregate_mxu8_kernel_streaming requires at least one chunk")
            with span("sda.engine.reconstruct"):
                return self.reconstruct_planar8(acc, lanes, clerks)

    def aggregate_mxu8_kernel_chunked(self, sec8_stacked, n_chunks: int, p_chunk: int,
                                      seed: int = 0, lanes: int = 1024):
        """A whole multi-chunk job in ONE call (B2) with fused
        reconstruction: ``sec8_stacked`` stacks ``n_chunks`` planar chunks of
        ``p_chunk`` participants along its rows. Returns ``[nb, k, L]``."""
        with span("sda.engine.aggregate"):
            out = self._fused(sec8_stacked, seed, p_chunk, lanes, reconstruct=True,
                              n_chunks=n_chunks)
            return batched_from_planar_lm(out, self.nb, self.spec.secret_count)

    # ------------------------------------------------- lane-batch serving

    @staticmethod
    def concat_jobs_lanes(planar_jobs):
        """Concatenate same-shape planar jobs along the lane (batch) axis.
        Lanes are independent, so each job's result stays exact when many
        same-scheme jobs share one launch. Shapes must be identical (same
        participant count, slot layout and lane padding): otherwise the
        even per-job split would cut across job boundaries."""
        planar_jobs = list(planar_jobs)
        if not planar_jobs:
            raise ValueError("concat_jobs_lanes needs at least one job")
        shape = planar_jobs[0].shape
        if any(j.shape != shape for j in planar_jobs):
            raise ValueError("lane-batched jobs must share the planar shape")
        return torch.cat(planar_jobs, dim=1)

    def aggregate_mxu8_kernel_jobs(self, sec8_batched, seed, p_count: int, n_jobs: int,
                                   lanes: int = 1024, combined_randomness: bool = False):
        """``n_jobs`` lane-concatenated jobs (from :meth:`concat_jobs_lanes`)
        through ONE launch; returns ``[n_jobs, nb, k, L]``, row ``i`` job
        ``i``.

        ``combined_randomness``: one equivalent randomness draw per slot
        instead of ``p_count`` (``rand_participants=1``). A sum of uniform
        draws mod p is uniform, and only the combined result leaves the
        kernel, so this is sound within the fused combine's trust model;
        never use it where per-participant shares are emitted."""
        nbp_total = sec8_batched.shape[1]
        if nbp_total % n_jobs:
            raise ValueError("batched lane width must divide evenly into jobs")
        with span("sda.engine.aggregate"):
            out = self._fused(sec8_batched, seed, p_count, lanes, reconstruct=True,
                              rand_participants=1 if combined_randomness else None)
            k, L = self.spec.secret_count, self.ctx.L
            full = out.reshape(L, k, nbp_total).permute(2, 1, 0)
            return full.reshape(n_jobs, nbp_total // n_jobs, k, L)[:, : self.nb]

    # ------------------------------------------------------ host edges

    def encode_secrets(self, secrets) -> torch.Tensor:
        """``[P, d]`` ints -> ``[P, nb, k, L]`` limb tensor on the engine's
        device (zero-padding the tail batch). Integer numpy input whose
        values fit int64 takes the vectorised int64 path below a 63-bit
        modulus; uint64 values of 2^63 and more take the object path, which
        reduces the true value mod p."""
        arr = np.asarray(secrets)
        p_count, d = arr.shape
        if d != self.dimension:
            raise ValueError("dimension mismatch")
        k = self.spec.secret_count
        fits_i64 = arr.dtype.kind == "i" or (
            arr.dtype.kind == "u" and (arr.dtype.itemsize < 8 or arr.size == 0 or arr.max() < (1 << 63))
        )
        if fits_i64 and self.ctx.p < (1 << 63):
            padded = np.zeros((p_count, self.nb * k), dtype=np.int64)
            padded[:, :d] = arr
            return self.ctx.encode_i64(padded.reshape(p_count, self.nb, k), self.device)
        padded = np.zeros((p_count, self.nb * k), dtype=object)
        padded[:, :d] = np.asarray(secrets, dtype=object)
        return self.ctx.encode(padded.reshape(p_count, self.nb, k), self.device)

    def random_ext(self, p_count: int, rng: np.random.Generator | None = None) -> torch.Tensor:
        """Host-CSPRNG randomness block ``[P, nb, r, L]`` (protocol path)."""
        f = PrimeField(self.spec.modulus)
        r = f.sample((p_count, self.nb, self.spec.randomness_count), rng=rng)
        return self.ctx.encode(r, self.device)

    def decode_output(self, out_limbs) -> np.ndarray:
        """``[nb, k, L]`` -> the revealed ``[d]`` vector, truncating padding:
        int64 below a modulus of 2^63 (every residue fits), object ints at
        wider moduli."""
        global decode_i64_launches
        with span("sda.engine.decode"):
            if self.ctx.p >= (1 << 63):
                with span("sda.engine.decode.to_object"):
                    return self.ctx.decode(out_limbs).reshape(-1)[: self.dimension]
            # the limbs' recombine launches, then the .cpu() that waits for
            # the aggregation and copies
            with span("sda.engine.decode.wait"):
                vals = self.ctx.decode_i64(out_limbs)
            decode_i64_launches += 1
            with span("sda.engine.decode.to_object"):
                return vals.reshape(-1)[: self.dimension]

    def decode_shares(self, shares_limbs) -> np.ndarray:
        """``[..., n, L]`` -> object ints (for wire encoding per clerk)."""
        return self.ctx.decode(shares_limbs)
