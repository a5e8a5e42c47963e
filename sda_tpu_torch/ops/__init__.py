"""Device compute for modular field math.

- :mod:`sda_tpu_torch.ops.limbs`  — 16-bit-limb Montgomery arithmetic on
  int64 tensors.
- :mod:`sda_tpu_torch.ops.modmat` — batched modular matmul / combine built
  on limbs.
- :mod:`sda_tpu_torch.ops.mxu`    — the 7-bit int8 modmat (one integer
  matrix product and a carry/Montgomery epilogue).
- :mod:`sda_tpu_torch.ops.mxu_kernel` — the 7-bit fused share + combine
  (+ reconstruct), kernel generation 3: a hand-written CUDA kernel and its
  plain version.
- :mod:`sda_tpu_torch.ops.pallas_kernels` — the CIOS fused share + combine
  on planar tiles, kernel generation 1 (the reference's module name): a
  hand-written CUDA kernel and its plain version.
- :mod:`sda_tpu_torch.ops.mxu8`   — the byte-limb fused share + combine
  (+ reconstruct): a hand-written CUDA kernel and its plain version.
- :mod:`sda_tpu_torch.ops.chacha_kernel` — the ChaCha mask expansion and
  fold: two hand-written CUDA kernels and their plain versions.
- :mod:`sda_tpu_torch.ops.probes` — the floor probes of the measurement
  tools: hand-written CUDA kernels that move a kernel's bytes through its
  grid and nothing else, and their plain versions.
- :mod:`sda_tpu_torch.ops.cuda_build` / :mod:`sda_tpu_torch.ops.native_build`
  — build and load the CUDA kernels and the host-side native library at
  first use.
- :mod:`sda_tpu_torch.ops.sass` — the built kernels' SASS and the loops
  the integer bounds count.
"""
