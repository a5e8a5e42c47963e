"""Measured host-vs-device routing policy for the bulk data paths.

Port of the reference package's ``routing`` module. One raw size knob used
to gate host-vs-device decisions whose correct answers are opposite on the
same host; this module derives each decision from two measured rates:

- ``host_fold_gbs`` — the host's modular fold (``fields.trunc_add_mod``)
  throughput in GB/s of folded payload;
- ``link_gbs`` — effective host->card transfer bandwidth (``None`` when no
  card is usable).

Rates come from a one-time micro-probe (:func:`measure_probe`), from
config (env ``SDA_HOST_FOLD_GBS`` / ``SDA_LINK_GBS``), or from an injected
:class:`Probe` (:func:`set_probe`). Decisions:

| Path | Rule | Why |
|---|---|---|
| clerk combine | fused native first; fallback device iff ``link > host_fold`` | both bulk routes pay identical seal_open cost; the residual choice is fold-at-host vs ship-then-fold |
| Full-mask combine | device iff ``link > host_fold`` | P x d mask bytes must cross the link exactly once; host fold reads them from RAM instead |
| ChaCha combine | device iff a card exists | traffic is P seeds (KBs); expansion is compute the device wins by orders of magnitude |

All decisions additionally require the workload to clear a size floor
(launch/dispatch overhead dominates below it).

``device_backend`` is ``"cuda"`` when torch sees a card and ``None`` on a
machine with only a CPU.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

__all__ = [
    "Probe",
    "RoutingPolicy",
    "measure_probe",
    "current_probe",
    "set_probe",
    "default_policy",
]


@dataclass(frozen=True)
class Probe:
    """Measured (or configured) host rates a routing decision needs."""

    host_fold_gbs: float  # trunc_add_mod fold rate, GB/s of payload folded
    link_gbs: float | None  # host->card bandwidth; None = no usable card
    device_backend: str | None = None  # "cuda" when a card exists
    source: str = "recorded"  # "measured" | "env" | "recorded" | "injected"

    @property
    def has_device(self) -> bool:
        return self.link_gbs is not None and self.device_backend not in (None, "cpu")


def _measure_host_fold(n: int = 1 << 21, reps: int = 3) -> float:
    """Fold rate of the overflow-safe host accumulate (GB/s of payload)."""
    from sda_tpu_torch.fields import trunc_add_mod

    p = (1 << 61) - 1
    rng = np.random.default_rng(0)
    a = rng.integers(0, p, size=n, dtype=np.int64)
    b = rng.integers(0, p, size=n, dtype=np.int64)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        a = trunc_add_mod(a, b, p)
        best = min(best, time.perf_counter() - t0)
    return n * 8 / best / 1e9


def _measure_link(nbytes: int = 8 << 20, reps: int = 2):
    """Effective host->card bandwidth (GB/s) and ``"cuda"``, or (None,
    None) when torch sees no card (a "transfer" on the host measures
    memcpy, not a link — routing must not mistake it for an accelerator)."""
    if not torch.cuda.is_available():
        return None, None
    buf = torch.zeros(nbytes // 8, dtype=torch.int64)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        buf.to("cuda")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return nbytes / best / 1e9, "cuda"


def measure_probe() -> Probe:
    """One-time micro-probe of both rates."""
    link, backend = _measure_link()
    return Probe(
        host_fold_gbs=_measure_host_fold(),
        link_gbs=link,
        device_backend=backend,
        source="measured",
    )


_PROBE: Probe | None = None


def set_probe(probe: Probe | None) -> None:
    """Inject a recorded/config probe (None reverts to lazy measurement)."""
    global _PROBE
    _PROBE = None if probe is None else replace(probe, source="injected")


def current_probe() -> Probe:
    """Cached probe: injected > env-configured > measured (lazy, once)."""
    global _PROBE
    if _PROBE is not None:
        return _PROBE
    env_fold = os.environ.get("SDA_HOST_FOLD_GBS")
    env_link = os.environ.get("SDA_LINK_GBS")
    if env_fold or env_link:
        # each rate independently comes from config or from its probe — a
        # fold-only config must NOT imply "no accelerator" (that would
        # silently disable every device route on a host that merely pinned
        # its fold rate)
        if env_link:
            link, backend = float(env_link), "env"
        else:
            link, backend = _measure_link()
        _PROBE = Probe(
            host_fold_gbs=float(env_fold) if env_fold else _measure_host_fold(),
            link_gbs=link,
            device_backend=backend,
            source="env",
        )
    else:
        _PROBE = measure_probe()
    return _PROBE


@dataclass(frozen=True)
class RoutingPolicy:
    """Per-path route decisions from a :class:`Probe`.

    ``bulk_floor``: element count below which every path stays on the
    host/sequential route (launch + dispatch overhead territory). The
    deprecated ``device_bulk_threshold`` knob maps onto this floor ONLY —
    it no longer forces a direction.
    """

    probe: Probe
    bulk_floor: int = 1 << 20

    # -- forced policies (benchmarks / explicit operator override) --------
    @classmethod
    def force(cls, route: str) -> "RoutingPolicy":
        """A policy that answers ``route`` for every masker decision —
        for benchmarks that must measure a specific route, not for
        production configs."""
        if route == "device":
            probe = Probe(host_fold_gbs=0.0, link_gbs=float("inf"),
                          device_backend="forced", source="injected")
            return cls(probe=probe, bulk_floor=0)
        if route == "host":
            probe = Probe(host_fold_gbs=float("inf"), link_gbs=None,
                          device_backend=None, source="injected")
            return cls(probe=probe, bulk_floor=0)
        raise ValueError(f"unknown forced route: {route}")

    # ------------------------------------------------------- decisions
    def fullmask_combine(self, participants: int, dimension: int) -> str:
        """'device' | 'host'. The P x d int64 mask payload crosses the
        link exactly once on the device route; the host fold reads the
        same bytes from RAM at ``host_fold_gbs``. Device wins iff the
        link is the faster pipe (and the job clears the floor)."""
        p = self.probe
        if participants * dimension < max(1, self.bulk_floor):
            return "host"
        if not p.has_device:  # incl. the cpu backend: memcpy is not a link
            return "host"
        return "device" if p.link_gbs > p.host_fold_gbs else "host"

    def chacha_combine(self, n_seeds: int, dimension: int) -> str:
        """'device' | 'host'. Only P seeds (KBs) cross the link; the
        d-element expansion of every seed happens on the card — so any
        card wins once the job clears the floor. (The rejection-path
        fix-up stays exact either way: only the affected seeds are redone
        on the host.)"""
        if n_seeds * dimension < max(1, self.bulk_floor):
            return "host"
        return "device" if self.probe.has_device else "host"

    def clerk_fallback_combine(self, est_elements: int) -> str:
        """'device' | 'host' for the clerk fallback when the fused native
        open+combine cannot run: the python fold vs streaming the decoded
        shares through the device accumulator — the same link-vs-fold
        comparison as the Full-mask combine."""
        p = self.probe
        if est_elements < max(1, self.bulk_floor):
            return "host"
        if not p.has_device:  # incl. the cpu backend: memcpy is not a link
            return "host"
        return "device" if p.link_gbs > p.host_fold_gbs else "host"


def default_policy(bulk_floor: int | None = None) -> RoutingPolicy:
    """Policy over the cached probe. Callers holding a deprecated
    ``device_bulk_threshold`` pass it as ``bulk_floor`` — it keeps its
    size-floor meaning but no longer forces the device direction."""
    return RoutingPolicy(
        probe=current_probe(),
        bulk_floor=1 << 20 if bulk_floor is None else bulk_floor,
    )
