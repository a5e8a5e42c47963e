"""The clerk-combine routing crossover: the fused native route against the
streamed device route, on real sealed boxes.

    python3 -m sda_tpu_torch.tools.measure_combine_crossover

Port of the reference's ``tools/measure_combine_crossover.py``. Both bulk
routes of :meth:`sda_tpu_torch.client.SdaClient.process_clerking_job` pay
the same ``seal_open`` cost (the port's own, ``sda_tpu_torch/native/nacl.cpp``); they
differ in what follows it:

- **fused native** (:meth:`ShareDecryptor.open_combine`): varint decode and
  the modular accumulate in the same C++ pass, no materialisation;
- **streamed device** (``_streamed_decrypt`` +
  :func:`sda_tpu_torch.engine.device_combine`): the native batch open and
  decode, then the host-to-card copy and the accumulate on the card, one
  chunk ahead.

Both FULL paths (opens included) are timed on the host clock at the
reference's four job sizes, their results must agree, and the first size
at which the device route wins is reported. It needs the port's native
library (:mod:`sda_tpu_torch.ops.native_build`, built on first use). The port's
``DEVICE_COMBINE_CROSSOVER`` keeps the reference's value; this tool
records this host's figure. Writes
``build/measurements/CROSSOVER.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from sda_tpu_torch.tools._common import card_fields, write_artifact
from sda_tpu_torch.utils.device import resolve_device

__all__ = ["measure", "main", "SHAPES"]

# (boxes, elements per box): config-2-like through config-4-like jobs
SHAPES = ((1000, 334), (1000, 3334), (2000, 8334), (1000, 33334))


def measure(shapes=SHAPES, device=None) -> dict:
    from sda_tpu_torch import protocol as proto
    from sda_tpu_torch import sodium
    from sda_tpu_torch.client import _streamed_decrypt
    from sda_tpu_torch.client.crypto import ShareDecryptor
    from sda_tpu_torch.engine import device_combine
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.utils.varint import encode_varints

    device = resolve_device(device)
    p, _, _ = find_special_prime_field(63, 8, 9)
    ek, dk = sodium.box_keypair()
    dec = ShareDecryptor(ek, dk)
    rng = np.random.default_rng(0)
    rows = []
    for n_boxes, d in shapes:
        vec = rng.integers(0, 1 << 62, size=d, dtype=np.int64) % p
        boxes = [proto.Encryption(data=sodium.seal(encode_varints(vec), ek))
                 for _ in range(n_boxes)]
        total = n_boxes * d

        t0 = time.perf_counter()
        fused = dec.open_combine(boxes, p, d)
        t_fused = time.perf_counter() - t0
        if fused is None:
            raise RuntimeError(f"the modulus {p} is outside the fused route's range")

        # warm the device route (allocator, first copy) at this dimension
        device_combine(p, _streamed_decrypt(dec, boxes[:256]), device=device)
        t0 = time.perf_counter()
        dev = device_combine(p, _streamed_decrypt(dec, boxes), device=device)
        t_dev = time.perf_counter() - t0
        if not np.array_equal(np.asarray(dev) % p, np.asarray(fused) % p):
            raise AssertionError(f"the device route != the fused route at {n_boxes} x {d}")
        if not np.array_equal(np.asarray(fused) % p, (vec.astype(object) * n_boxes) % p):
            raise AssertionError(f"the fused route != {n_boxes} x the vector mod p")

        row = {
            "boxes": n_boxes,
            "elements_per_box": d,
            "total_elements": total,
            "fused_native_s": t_fused,
            "streamed_device_s": t_dev,
            "fused_elements_per_s": total / t_fused,
            "device_elements_per_s": total / t_dev,
            "winner": "device" if t_dev < t_fused else "fused_native",
        }
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)

    crossover = next((r["total_elements"] for r in rows if r["winner"] == "device"), None)
    where = card_fields(device)
    if device.type == "cpu":
        where["note_device"] = "CPU run: both routes on the host, host-clock times, no card"
    return {
        "metric": "clerk combine routing crossover (total share elements, host clock)",
        **where,
        "host_cores": os.cpu_count(),
        "rows": rows,
        "observed_crossover_elements": crossover,
        "note": (
            "both routes pay the same seal_open cost; the race is the host decode + "
            "accumulate against decode + host-to-device copy + accumulate on the device "
            "named in 'device'. Times are on the host clock around each whole route."
        ),
    }


def main() -> int:
    try:
        artifact = measure()
    except RuntimeError as err:
        print(f"measure_combine_crossover: {err}", file=sys.stderr)
        return 1
    path = write_artifact("CROSSOVER", artifact)
    print(json.dumps(artifact))
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
