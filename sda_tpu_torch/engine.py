"""The bulk secure-aggregation executor, on PyTorch tensors.

Port of the reference package's ``engine.py`` (main-path half). The
pipeline mirrors the protocol's call stacks with the host/device boundary
drawn at the field math:

- participant side: share generation (the per-participant NTT pipeline
  folded into one modular matmul);
- clerk side: the combine (modular sum over participants);
- recipient side: reconstruction (inverse transform matmul).

Two routes compute it. The plain CIOS route (``share`` / ``combine`` /
``reconstruct`` / ``aggregate``) is limb-tensor code on any device. The
byte-limb route (``aggregate_mxu8_kernel``) runs share generation with
in-kernel randomness, the combine and the reconstruction in one launch of
the hand-written CUDA kernel of :mod:`sda_tpu_torch.ops.mxu8` — on a CPU
tensor, in that kernel's plain version.

The engine runs on ``cuda`` unless the caller passes another device.
"""

from __future__ import annotations

import numpy as np
import torch

from sda_tpu_torch.fields import PrimeField
from sda_tpu_torch.ops.limbs import LimbContext, limbs_from_numpy
from sda_tpu_torch.ops.modmat import combine, modmat, uniform_limbs
from sda_tpu_torch.ops.mxu8 import (
    Mxu8Context,
    batched_from_planar_lm,
    mxu8_plan,
    planar8_from_batched,
    run_mxu8,
)
from sda_tpu_torch.sharing import DeviceSchemeSpec

__all__ = [
    "TorchAggregationEngine",
    "limbs_from_numpy",
    "resolve_device",
    "spec_from_numpy",
]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: nothing
    drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


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
        # Montgomery-form matrices on the device; mont_mul(normal, mont) = product
        self.share_mat = self.ctx.encode_mont(spec.share_matrix, self.device)
        self.rec_mat = self.ctx.encode_mont(spec.reconstruct_matrix, self.device)
        # byte-limb kernel path: odd moduli wider than 7 bits
        self.mxu8: Mxu8Context | None = None
        if spec.modulus % 2 == 1 and spec.modulus.bit_length() > 7:
            self.mxu8 = Mxu8Context.create(self.ctx)
        self._plans: dict = {}

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

    def _fused(self, sec8, seed, p_count: int, lanes: int, reconstruct: bool):
        mxu8 = self._require_mxu8()
        rows, nbp = sec8.shape
        if nbp % lanes:
            raise ValueError(f"NBP={nbp} must be a multiple of lanes={lanes}")
        key = (rows, p_count, reconstruct, sec8.device)
        plan = self._plans.get(key)
        if plan is None:
            spec = self.spec
            plan = mxu8_plan(
                mxu8, spec.share_matrix, rows, p_count, spec.secret_count,
                spec.randomness_count,
                reconstruct_matrix=spec.reconstruct_matrix if reconstruct else None,
                device=sec8.device,
            )
            self._plans[key] = plan
        return run_mxu8(plan, sec8, int(seed))

    def aggregate_mxu8_kernel(self, sec8, seed, p_count: int, lanes: int = 1024):
        """Share + combine + reconstruct in ONE launch of the byte-limb
        kernel; ``sec8`` from :meth:`planar8_secrets`; returns ``[nb, k, L]``
        int32 limbs."""
        out = self._fused(sec8, seed, p_count, lanes, reconstruct=True)
        return batched_from_planar_lm(out, self.nb, self.spec.secret_count)

    def mxu8_kernel_combined(self, sec8, seed, p_count: int, lanes: int = 1024):
        """The same launch without reconstruction: per-clerk combined
        shares, ``[L * n, NBP]`` limb-major."""
        return self._fused(sec8, seed, p_count, lanes, reconstruct=False)

    # ------------------------------------------------------ host edges

    def encode_secrets(self, secrets) -> torch.Tensor:
        """``[P, d]`` ints -> ``[P, nb, k, L]`` limb tensor on the engine's
        device (zero-padding the tail batch). Integer numpy input below a
        63-bit modulus takes the vectorised int64 path."""
        arr = np.asarray(secrets)
        p_count, d = arr.shape
        if d != self.dimension:
            raise ValueError("dimension mismatch")
        k = self.spec.secret_count
        if arr.dtype.kind in "iu" and self.ctx.p < (1 << 63):
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
        """``[nb, k, L]`` -> the revealed ``[d]`` vector (object ints,
        truncating padding)."""
        if self.ctx.p < (1 << 63):
            vals = self.ctx.decode_i64(out_limbs).astype(object)
        else:
            vals = self.ctx.decode(out_limbs)
        return vals.reshape(-1)[: self.dimension]

    def decode_shares(self, shares_limbs) -> np.ndarray:
        """``[..., n, L]`` -> object ints (for wire encoding per clerk)."""
        return self.ctx.decode(shares_limbs)
