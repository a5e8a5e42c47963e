// Floor probes for Hopper (sm_90a): kernels that move a real kernel's bytes
// through the real kernel's grid and do nothing else, so a step's time
// splits into a launch floor, a copy floor and kernel work.
//
//   T1, T2  replace tools/measure_latency_floor.py:76 and
//           tools/measure_lane_batch_floor.py:100 (noop_kernel): the floor
//           of one B1 launch (csrc/mxu8.cu) at the config-2 single job (T1)
//           and at the 512-job lane batch (T2). One block of 256 threads per
//           kT = 128 lanes, exactly B1's grid (mxu8.cu: launch<MT>): block b
//           reads the column slice [b * 128, (b + 1) * 128) of every row of
//           the [rows, nbp] int8 planar operand (a row stride of nbp bytes),
//           the slice B1 stages, and writes its [out_rows, 128] tile of the
//           uint32 output.
//   T3      replaces tools/measure_config3_variants.py:126: the floor of one
//           B2 call, through B2's split grid (csrc/mxu8.cu, SDA_MXU8_MODE=2,
//           mxu8_split_kernel): nbp / 128 lane blocks x S splits. Block (lane
//           block b, split s) reads the column slice of b for the 64-row
//           tiles [s * total / S, (s + 1) * total / S) of the flattened list
//           of n_chunks * ceil(rows / 64) (chunk, tile) pairs, cut where a
//           chunk ends, as B2's split s does; split 0 writes the lane
//           block's output tile once. The caller passes B2's S.
//   T1'     replaces tools/measure_latency_floor.py:93: the bare launch
//           floor. One block reads a 1 KB input and writes 4 KB.
//
// How a probe differs from the TPU kernel, on purpose: the TPU's BlockSpec
// copied each input block into VMEM whether the body read it or not. A GPU
// kernel moves nothing it does not load, and the compiler drops loads whose
// results go unused. So every probe loads its whole input tile with 16-byte
// vector loads, folds the loaded words into an XOR, and writes one XOR word
// per block to `sink` beside the seed-filled output; the XOR of the sinks
// equals the XOR of the whole input read as uint32 words, which the caller
// checks (T3: one sink word per block, blockIdx.x = s * lane_blocks + b,
// B2's block order). The output is filled with `seed` (distinct per timed
// call).
//
// Bound on the H100 SXM: bytes only (input read once, output and sink
// written once) over 3.35 TB/s. A probe does ~1 instruction per 16 loaded
// bytes, far under the issue rate. Its design keeps 4 independent 16-byte
// loads in flight per thread (32 rows of the tile per step of 256 threads,
// 4 steps unrolled) and nothing else; what it cannot do anything about is
// B1's grid: nbp / 128 blocks, 3 at the single job (T1), and B2's (T3).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;        // lanes per block (B1/B2's tile)
constexpr int kThreads = 256;  // threads per block (B1/B2's block)
constexpr int kVec = 16;       // bytes per load
constexpr int kRowThreads = kT / kVec;           // 8 threads cover a row's slice
constexpr int kRowsPerStep = kThreads / kRowThreads;  // 32 rows per step
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t xor4(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

// XOR of `v` over the block, written by thread 0 to *dst.
__device__ __forceinline__ void block_xor_to(uint32_t v, uint32_t* dst) {
  __shared__ uint32_t warp_xor[kThreads / 32];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, s);
  if ((threadIdx.x & 31) == 0) warp_xor[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t x = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) x ^= warp_xor[w];
    *dst = x;
  }
}

constexpr int kTileRows = 64;  // B2's K tile

// XOR of rows [r_begin, r_end) of the column slice at col: each thread its
// own rows, 4 independent 16-byte loads in flight.
__device__ __forceinline__ uint32_t xor_rows(const int8_t* x, int r_begin, int r_end, int nbp,
                                             size_t col) {
  uint32_t acc = 0;
  int r = r_begin + threadIdx.x / kRowThreads;
  for (; r + (kUnroll - 1) * kRowsPerStep < r_end; r += kUnroll * kRowsPerStep) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = *reinterpret_cast<const uint4*>(x + (size_t)(r + u * kRowsPerStep) * nbp + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc ^= xor4(v[u]);
  }
  for (; r < r_end; r += kRowsPerStep)
    acc ^= xor4(*reinterpret_cast<const uint4*>(x + (size_t)r * nbp + col));
  return acc;
}

// T1 / T2 (SPLIT = false: one block per lane block, every row) and T3
// (SPLIT = true: lane_blocks x splits blocks, B2's pieces). x: [n_chunks *
// rows, nbp] int8; out: [out_rows, nbp] uint32; sink: one word per block.
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
probe_lanes_kernel(const int8_t* __restrict__ x, int rows, int n_chunks, int splits, int nbp,
                   uint32_t* __restrict__ out, int out_rows, uint32_t seed,
                   uint32_t* __restrict__ sink) {
  const int tid = threadIdx.x;
  const int lane_blocks = nbp / kT;
  const int s = blockIdx.x / lane_blocks, lane0 = (blockIdx.x % lane_blocks) * kT;
  const size_t col = (size_t)lane0 + kVec * (tid % kRowThreads);
  uint32_t acc = 0;
  if constexpr (SPLIT) {
    const int tiles = (rows + kTileRows - 1) / kTileRows;
    const long long total = (long long)tiles * n_chunks;
    long long i = total * s / splits;
    const long long end = total * (s + 1) / splits;
    while (i < end) {
      const int c = (int)(i / tiles), b = (int)(i % tiles);
      const int e = (int)min((long long)tiles, b + (end - i));
      acc ^= xor_rows(x + (size_t)c * rows * nbp, b * kTileRows, min(e * kTileRows, rows), nbp,
                      col);
      i += e - b;
    }
  } else {
    acc = xor_rows(x, 0, rows, nbp, col);
  }
  // the output tile, once: out_rows x 128 words, 32 uint4 stores per row
  if (s == 0) {
    const uint4 s4 = make_uint4(seed, seed, seed, seed);
    for (int i = tid; i < out_rows * (kT / 4); i += kThreads) {
      const int row = i / (kT / 4), c4 = i % (kT / 4);
      *reinterpret_cast<uint4*>(out + (size_t)row * nbp + lane0 + 4 * c4) = s4;
    }
  }
  block_xor_to(acc, sink + blockIdx.x);
}

// T1': one block; x holds n_in16 16-byte words, out n_out4 uint4 words.
__global__ void __launch_bounds__(kThreads)
probe_bare_kernel(const int8_t* __restrict__ x, int n_in16, uint32_t* __restrict__ out,
                  int n_out4, uint32_t seed, uint32_t* __restrict__ sink) {
  uint32_t acc = 0;
  for (int i = threadIdx.x; i < n_in16; i += kThreads)
    acc ^= xor4(reinterpret_cast<const uint4*>(x)[i]);
  const uint4 s4 = make_uint4(seed, seed, seed, seed);
  for (int i = threadIdx.x; i < n_out4; i += kThreads) reinterpret_cast<uint4*>(out)[i] = s4;
  block_xor_to(acc, sink);
}

}  // namespace

// x: [n_chunks * rows, nbp] int8 (nbp a multiple of 128, rows >= 1);
// out: [out_rows, nbp] uint32; sink: [splits * nbp / 128] uint32. split != 0
// runs T3 on B2's split grid (any n_chunks, splits >= 1), else T1/T2's
// single pass (n_chunks and splits must be 1). Returns a cudaError_t.
extern "C" int sda_probe_lanes(const void* x, int rows, int n_chunks, int nbp, void* out,
                               int out_rows, unsigned int seed, void* sink, int split,
                               int splits, void* stream) {
  if (rows < 1 || n_chunks < 1 || splits < 1 || nbp < kT || nbp % kT || out_rows < 0 ||
      (!split && (n_chunks != 1 || splits != 1)))
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const int8_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  auto* sk = static_cast<uint32_t*>(sink);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nbp / kT * splits);
  if (split)
    probe_lanes_kernel<true>
        <<<grid, kThreads, 0, st>>>(xi, rows, n_chunks, splits, nbp, o, out_rows, seed, sk);
  else
    probe_lanes_kernel<false>
        <<<grid, kThreads, 0, st>>>(xi, rows, 1, 1, nbp, o, out_rows, seed, sk);
  return (int)cudaGetLastError();
}

// x: n_in_bytes (a multiple of 16) int8; out: n_out_words (a multiple of 4)
// uint32; sink: 1 uint32. Returns a cudaError_t.
extern "C" int sda_probe_bare(const void* x, int n_in_bytes, void* out, int n_out_words,
                              unsigned int seed, void* sink, void* stream) {
  if (n_in_bytes < 0 || n_in_bytes % kVec || n_out_words < 0 || n_out_words % 4)
    return (int)cudaErrorInvalidValue;
  probe_bare_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), n_in_bytes / kVec, static_cast<uint32_t*>(out),
      n_out_words / 4, seed, static_cast<uint32_t*>(sink));
  return (int)cudaGetLastError();
}
