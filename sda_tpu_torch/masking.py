"""Masking schemes: None / Full / ChaCha.

Port of the reference package's ``masking`` module. Semantics mirror the
upstream protocol's maskers:

- None: empty mask, pass-through.
- Full: additive one-time pad; the participant uploads the full mask
  (encrypted for the recipient), the recipient sums all masks and subtracts.
- ChaCha: the participant uploads only a small PRG *seed* (as i64 words);
  the recipient re-expands every seed — a bandwidth/compute trade.

All signed arithmetic uses Rust truncated remainders; values stay in
``(-m, m)`` until ``positive()`` at the reveal edge.

The reveal-side combines run on the card by default: with no ``routing``
and the default ``device``, the Full masker sums through
:func:`sda_tpu_torch.engine.device_combine` and the ChaCha masker
re-expands through
:func:`sda_tpu_torch.ops.chacha_kernel.combine_masks_device`, and both
raise when there is no card. ``device="cpu"`` (with no ``routing``) or
``RoutingPolicy.force("host")`` keeps the reference's host fold; any other
:class:`sda_tpu_torch.routing.RoutingPolicy` decides per call. The factory
:func:`masker_for_scheme` builds the masker a protocol scheme descriptor
names.
"""

from __future__ import annotations

import numpy as np

from sda_tpu_torch import chacha
from sda_tpu_torch.fields import PrimeField, trunc_add_mod, trunc_mod, trunc_sub_mod
from sda_tpu_torch.utils.errors import Invalid
from sda_tpu_torch.utils.logging import span

__all__ = ["NoneMasker", "FullMasker", "ChaChaMasker", "masker_for_scheme"]


class NoneMasker:
    """No masking: secrets are shared directly with the clerks."""

    def mask(self, secrets):
        return np.zeros(0, dtype=np.int64), np.asarray(secrets, dtype=np.int64).copy()

    def combine(self, masks):
        for m in masks:
            if len(m) != 0:
                raise Invalid("unexpected non-empty mask for None masking")
        return np.zeros(0, dtype=np.int64)

    def unmask(self, mask_and_masked):
        mask, masked = mask_and_masked
        if len(mask) != 0:
            raise Invalid("unexpected non-empty mask for None masking")
        return np.asarray(masked).copy()


def _policy(routing, device_bulk_threshold, device):
    """Effective routing policy: explicit > deprecated-threshold-as-floor >
    the device route when ``device`` is the card (the default; it raises
    when there is none) > None, the host fold, when the caller asked for
    the CPU (reference parity, no probe overhead)."""
    from sda_tpu_torch.routing import RoutingPolicy, default_policy
    from sda_tpu_torch.utils.device import resolve_device

    if routing is not None:
        return routing
    if device_bulk_threshold is not None:
        return default_policy(bulk_floor=device_bulk_threshold)
    if resolve_device(device).type == "cuda":
        return RoutingPolicy.force("device")
    return None


class FullMasker:
    """Full-entropy additive pad.

    ``routing``: a :class:`sda_tpu_torch.routing.RoutingPolicy` deciding
    whether :meth:`combine` — the reveal-side loop that sums every
    participant's full-length mask — streams the mask vectors through the
    device accumulator (:func:`sda_tpu_torch.engine.device_combine`) or
    stays on the host fold. The P x d mask bytes must cross the host->card
    link exactly once, so the device wins only when the link outruns the
    host fold. Masks are canonical ``[0, p)``, so the device's canonical
    sum is bit-identical to the host fold.

    ``device_bulk_threshold`` (deprecated) supplies only the policy's size
    floor. ``device``: where the device route runs (the card by default);
    with no ``routing`` it takes the device route on the card and the host
    fold on ``"cpu"``.
    """

    def __init__(self, modulus: int, device_bulk_threshold: int | None = None, routing=None,
                 device=None):
        self.modulus = modulus
        self._field = PrimeField(modulus)
        self.device_bulk_threshold = device_bulk_threshold
        self.routing = routing
        self.device = device

    # folds are exact in int64 via trunc_add_mod for any p < 2**63; only
    # genuinely >63-bit moduli pay for python-int (object) arithmetic.
    @property
    def _i64_ok(self) -> bool:
        return self.modulus < (1 << 63)

    def mask(self, secrets):
        secrets = np.asarray(secrets)
        masks = self._field.sample(secrets.shape)
        if self._i64_ok:
            masks = np.asarray(masks, dtype=np.int64)
            masked = trunc_add_mod(secrets, masks, self.modulus)
        else:
            masked = trunc_mod(secrets + masks, self.modulus)
        return masks, masked

    def combine(self, masks):
        masks = list(masks)
        if not masks:
            return np.zeros(0, dtype=np.int64)
        d = len(masks[0])
        for m in masks:
            if len(m) != d:
                raise Invalid("mask dimension mismatch")
        policy = (_policy(self.routing, self.device_bulk_threshold, self.device)
                  if self._i64_ok else None)
        if policy is not None and policy.fullmask_combine(len(masks), d) == "device":
            from sda_tpu_torch.engine import device_combine

            return device_combine(self.modulus, masks, device=self.device)
        if self._i64_ok:
            acc = np.zeros(d, dtype=np.int64)
            for m in masks:
                m = np.asarray(m, dtype=np.int64)
                # decrypted wire masks can carry any i64; pre-reduce
                # out-of-domain vectors so trunc_add_mod stays exact
                if m.size and not (
                    int(m.min()) > -self.modulus and int(m.max()) < self.modulus
                ):
                    m = trunc_mod(np.asarray(m, dtype=object), self.modulus).astype(np.int64)
                acc = trunc_add_mod(acc, m, self.modulus)
            return acc
        acc = np.zeros(d, dtype=object)
        for m in masks:
            acc = trunc_mod(acc + np.asarray(m, dtype=object), self.modulus)
        return acc

    def unmask(self, mask_and_masked):
        mask, masked = mask_and_masked
        if len(mask) != len(masked):
            raise Invalid("mask/masked dimension mismatch")
        if self._i64_ok:
            return trunc_sub_mod(
                np.asarray(masked, dtype=np.int64),
                np.asarray(mask, dtype=np.int64),
                self.modulus,
            )
        return trunc_mod(np.asarray(masked) - np.asarray(mask), self.modulus)


class ChaChaMasker:
    """Seed-compressed masking: upload the PRG seed, not the mask.

    ``routing``: a :class:`sda_tpu_torch.routing.RoutingPolicy`; when it
    picks the device (any card — only P seeds cross the link, the
    d-element expansions happen on the card), :meth:`combine` re-expands
    the seeds on ``device`` (:mod:`sda_tpu_torch.ops.chacha_kernel`). Seeds
    whose streams hit a gen_range rejection get a per-seed exact host
    fix-up there — the result is bit-identical either way. With no
    ``routing`` the device route runs whenever ``device`` is the card (the
    default), and ``device="cpu"`` keeps the host fold.
    ``device_bulk_threshold`` (deprecated) supplies only the size floor.
    """

    def __init__(self, modulus: int, dimension: int, seed_bitsize: int,
                 device_bulk_threshold: int | None = None, routing=None, device=None):
        self.modulus = modulus
        self.dimension = dimension
        self.seed_bitsize = seed_bitsize
        self.device_bulk_threshold = device_bulk_threshold
        self.routing = routing
        self.device = device

    def mask(self, secrets):
        secrets = np.asarray(secrets)
        if secrets.shape[0] != self.dimension:
            raise Invalid("input dimension does not match masking scheme")
        seed_words = chacha.new_seed(self.seed_bitsize)
        mask = chacha.expand_masks([seed_words], self.dimension, self.modulus)[0]
        # overflow-safe even at 63-bit production primes (masks are
        # uniform in [0, p), so a plain int64 add can cross 2**63)
        masked = trunc_add_mod(secrets, np.asarray(mask, dtype=np.int64), self.modulus)
        # the uploaded "mask" is the seed, widened to i64 words
        return np.array(seed_words, dtype=np.int64), masked

    def combine(self, seeds_as_i64):
        with span("sda.masking.combine"):
            with span("sda.chacha.keys"):
                # re-expand every participant's seed and fold; the i64 words'
                # u32 values, one [S, w] array for either route
                try:
                    words = np.asarray(seeds_as_i64, dtype=np.int64) & 0xFFFFFFFF
                except ValueError:
                    raise Invalid("seed length mismatch") from None
            if len(words) == 0:
                return np.zeros(self.dimension, dtype=np.int64)
            policy = _policy(self.routing, self.device_bulk_threshold, self.device)
            if (
                policy is not None
                and self.modulus % 2 == 1
                and policy.chacha_combine(len(words), self.dimension) == "device"
            ):
                from sda_tpu_torch.ops.chacha_kernel import combine_masks_device

                return combine_masks_device(words, self.dimension, self.modulus,
                                            device=self.device)[0]
            masks = chacha.expand_masks(words, self.dimension, self.modulus)
            with span("sda.chacha.recombine"):
                acc = np.zeros(self.dimension, dtype=np.int64)
                for row in masks:
                    # rows are uniform in [0, p): overflow-safe fold required at
                    # 63-bit production primes
                    acc = trunc_add_mod(acc, np.asarray(row, dtype=np.int64), self.modulus)
            return acc

    def unmask(self, mask_and_masked):
        with span("sda.masking.unmask"):
            mask, masked = mask_and_masked
            if len(mask) != len(masked):
                raise Invalid("mask/masked dimension mismatch")
            with span("sda.masking.unmask.from_object"):
                masked = np.asarray(masked, dtype=np.int64)
            with span("sda.masking.unmask.sub"):
                return trunc_sub_mod(masked, np.asarray(mask, dtype=np.int64), self.modulus)


def masker_for_scheme(scheme, device_bulk_threshold: int | None = None,
                      routing=None, device=None):
    """Factory mirroring CryptoModule's masker construction (masking/mod.rs:33-52).

    ``routing`` (a :class:`sda_tpu_torch.routing.RoutingPolicy`) forwards to
    maskers with a device bulk path (ChaCha seed re-expansion and the
    Full-mask combine, both at reveal time); ``device_bulk_threshold`` is
    the deprecated knob that now maps onto the policy's size floor only;
    ``device`` is where their device route runs (the card unless ``"cpu"``).
    """
    from sda_tpu_torch import protocol as proto

    if isinstance(scheme, proto.NoMasking):
        return NoneMasker()
    if isinstance(scheme, proto.FullMasking):
        return FullMasker(
            scheme.modulus,
            device_bulk_threshold=device_bulk_threshold,
            routing=routing,
            device=device,
        )
    if isinstance(scheme, proto.ChaChaMasking):
        return ChaChaMasker(
            scheme.modulus,
            scheme.dimension,
            scheme.seed_bitsize,
            device_bulk_threshold=device_bulk_threshold,
            routing=routing,
            device=device,
        )
    raise Invalid(f"unknown masking scheme: {scheme!r}")
