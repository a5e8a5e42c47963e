"""sda_tpu_torch: the secure-aggregation framework on PyTorch and CUDA.

A port of the JAX/Pallas package ``sda_tpu`` to one NVIDIA H100. It keeps
the reference's module names so that each counterpart is easy to find, and
imports nothing of it (nor JAX): what it needs from the reference's host
modules it keeps as its own copies.

Layer map (bottom-up):

- :mod:`sda_tpu_torch.utils`    error types, the device rule
  (``utils.device.resolve_device``), spans, timing and profiling, varints
- :mod:`sda_tpu_torch.fields`   prime-field arithmetic (host numpy)
- :mod:`sda_tpu_torch.ntt`      number-theoretic transforms and their matrices
- :mod:`sda_tpu_torch.sharing`  additive & packed-Shamir schemes and their
  device spec
- :mod:`sda_tpu_torch.chacha`   rand-0.3 ChaCha streams (host oracle: the
  native library's expansion, numpy where it cannot run)
- :mod:`sda_tpu_torch.ops`      limb arithmetic, the CIOS and 7-bit
  modmats, the fused kernels of generations 1, 3 and 4 and the ChaCha mask
  kernels (CUDA C++ under ``ops/csrc``)
- :mod:`sda_tpu_torch.engine`   the bulk aggregation executor and
  ``device_combine``
- :mod:`sda_tpu_torch.parallel` the multi-device pipeline: a ``(p, d, c)``
  ``DeviceMesh`` and modular collectives over ``torch.distributed``
- :mod:`sda_tpu_torch.routing`  measured host-vs-device route decisions
- :mod:`sda_tpu_torch.masking`  None / Full / ChaCha maskers
- :mod:`sda_tpu_torch.models`   the federated-aggregation workload
- :mod:`sda_tpu_torch.protocol`, :mod:`sda_tpu_torch.sodium`,
  :mod:`sda_tpu_torch.client`, :mod:`sda_tpu_torch.service`,
  :mod:`sda_tpu_torch.stores`, :mod:`sda_tpu_torch.server` the protocol's
  host plane: wire resources, sealed boxes and signatures, the participant
  / clerk / recipient client and the in-process server
- :mod:`sda_tpu_torch.http`, :mod:`sda_tpu_torch.stores_mongo`,
  :mod:`sda_tpu_torch.cli`, :mod:`sda_tpu_torch.server_cli`,
  :mod:`sda_tpu_torch.params` the same host plane over REST, on MongoDB
  and from the command line (``sda``, ``sdad``, the parameter finder)
- :mod:`sda_tpu_torch.graft_entry` the flagship forward step and the
  multi-device dryrun
- :mod:`sda_tpu_torch.tools`    the measurement tools (the floor probes of
  :mod:`sda_tpu_torch.ops.probes`, the combine crossover, the mesh scaling
  benchmark and its artifact, the headline roofline)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from sda_tpu_torch.utils.errors import (
    Invalid,
    InvalidCredentials,
    PermissionDenied,
    SdaError,
)

__all__ = [
    "SdaError",
    "PermissionDenied",
    "InvalidCredentials",
    "Invalid",
    "__version__",
]
