"""Device compute for modular field math.

- :mod:`sda_tpu_torch.ops.limbs`  — 16-bit-limb Montgomery arithmetic on
  int64 tensors.
- :mod:`sda_tpu_torch.ops.modmat` — batched modular matmul / combine built
  on limbs.
- :mod:`sda_tpu_torch.ops.mxu8`   — the byte-limb fused share + combine
  (+ reconstruct): a hand-written CUDA kernel and its plain version.
- :mod:`sda_tpu_torch.ops.chacha_kernel` — the ChaCha mask expansion and
  fold: two hand-written CUDA kernels and their plain versions.
"""
