// rand-0.3 ChaCha20 mask expansion for Hopper (sm_90a): two kernels.
//
//   B4  chacha_keystream_kernel, replaces sda_tpu/ops/chacha_kernel.py::
//       _chacha_kernel: the keystream of every (seed, block counter),
//       [S, 8] u32 keys -> [S, nblocks, 16] u32 words.
//   B5  chacha_fold_kernel, replaces sda_tpu/ops/chacha_kernel.py::
//       _chacha_fold_kernel: the same blocks, paired into 64-bit draws
//       (hi = the FIRST word of each pair), whose four u16 limbs are summed
//       over every seed, plus each seed's count of draws in the gen_range
//       rejection zone, and the sums' reduction to canonical limbs mod the
//       pseudo-Mersenne p = 2^e - c. No keystream word reaches device memory.
//
// The ChaCha state is rand 0.3's core: the four constants, the key (the
// seed's first 8 words, zero-padded by the caller), word 12 = the block
// counter, words 13..15 = 0 (the wrapper keeps counters below 2^32); 20
// rounds, then the input state is added back.
//
// What bounds them. A block of 16 words costs 976 32-bit operations (10
// double rounds of 8 quarter rounds of 4 adds, 4 xors and 4 rotates, plus
// the 16 final adds); the rotates are __funnelshift_l, one SHF each. ptxas
// emits the adds as IMAD, which issue on the FMA pipe beside the 64-lane
// INT32 pipe that runs the xors (LOP3) and rotates, so the ceiling is the
// SM's instruction issue: 132 SMs x 128 lanes a clock. Per byte written B4
// does 976 / 64 = 15 operations, so on the H100 it is bound by that issue
// rate, not by device memory; B5 writes 16 bytes per dimension and reads 32
// bytes per seed, so it is bound by issue by three orders of magnitude.
// Neither touches the tensor cores. The designs do what they can for
// issue: every state word lives in a register (the round loop is fully
// unrolled), the rotates are single instructions, the per-draw work of B5
// is four adds onto register accumulators and a compare, and nothing waits
// on memory in the round loop.
//
// B4 design: one thread per (seed, block counter). Block x covers 256
// consecutive counters, grid y walks the seeds (a grid-stride loop past
// 65,535). The 16 output words of a thread leave as four 16-byte stores, so
// a warp writes 2 KB of consecutive memory; the key, the same for the whole
// block, is read from L2 as two 16-byte loads.
//
// B5 design. The TPU ran the seed axis as a sequential grid dimension with
// a VMEM accumulator and reduced the 128 seed lanes in XLA afterwards.
// Blocks on the card run in no order, so here each block owns ONE block
// counter, i.e. 8 dimensions, and its 256 threads stride over the seeds,
// each keeping the 32 u16-limb sums (8 draws x 4 limbs) in registers. Each
// sum stays below 16,384 * 2^16 = 2^30 (the caller's seed cap), so u32
// holds it and the order of the adds does not matter: the result is
// bit-equal to the plain version's. At the end one reduction across the
// block (warp shuffles, then shared memory across the 8 warps) and the
// epilogue: carry propagation of the limb sums into a 64-bit value plus a
// carry (value = v64 + carry * 2^64), reduced exactly with 64-bit integer
// arithmetic, (v64 mod p + carry * K mod p) mod p with K = 2^64 mod p =
// c * 2^(64-e) (carry < 2^15, K < 2^45, so the product fits). A rejection
// hit adds to its seed's count with an integer atomicAdd, only on a hit;
// draws past the last dimension (the ragged last counter) count nothing.
// The keys (32 bytes a seed, 320 KB at 10,000 seeds) stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// "expand 32-byte k"
constexpr uint32_t kC0 = 0x61707865u, kC1 = 0x3320646Eu, kC2 = 0x79622D32u, kC3 = 0x6B206574u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) { return __funnelshift_l(x, x, k); }

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// x = ChaCha20(key, counter) + input state: one 64-byte keystream block.
__device__ __forceinline__ void chacha_block(const uint32_t (&k)[8], uint32_t counter,
                                             uint32_t (&x)[16]) {
  x[0] = kC0; x[1] = kC1; x[2] = kC2; x[3] = kC3;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[4 + i] = k[i];
  x[12] = counter;
  x[13] = x[14] = x[15] = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
  x[0] += kC0; x[1] += kC1; x[2] += kC2; x[3] += kC3;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[4 + i] += k[i];
  x[12] += counter;
}

__device__ __forceinline__ void load_key(const uint32_t* __restrict__ keys, int64_t s,
                                         uint32_t (&k)[8]) {
  const uint4* kp = reinterpret_cast<const uint4*>(keys + s * 8);
  const uint4 a = __ldg(kp), b = __ldg(kp + 1);
  k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
  k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
chacha_keystream_kernel(const uint32_t* __restrict__ keys, uint4* __restrict__ out, int64_t S,
                        int64_t nblocks) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= nblocks) return;
  for (int64_t s = blockIdx.y; s < S; s += gridDim.y) {
    uint32_t k[8], x[16];
    load_key(keys, s, k);
    chacha_block(k, (uint32_t)b, x);
    uint4* o = out + (s * nblocks + b) * 4;
    o[0] = make_uint4(x[0], x[1], x[2], x[3]);
    o[1] = make_uint4(x[4], x[5], x[6], x[7]);
    o[2] = make_uint4(x[8], x[9], x[10], x[11]);
    o[3] = make_uint4(x[12], x[13], x[14], x[15]);
  }
}

__global__ void __launch_bounds__(kThreads)
chacha_fold_kernel(const uint32_t* __restrict__ keys, int32_t* __restrict__ limbs,
                   int32_t* __restrict__ rej, int64_t S, int64_t d, uint64_t p, uint64_t K,
                   uint32_t zone_hi, uint32_t zone_lo) {
  const uint32_t counter = blockIdx.x;
  const int64_t dim0 = (int64_t)counter * 8;
  const int ndraw = (int)(d - dim0 < 8 ? d - dim0 : 8);
  // acc[4 * j + l]: u16 limb l (lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16)
  // of draw j, summed over this thread's seeds
  uint32_t acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0u;
  for (int64_t s = threadIdx.x; s < S; s += kThreads) {
    uint32_t k[8], x[16];
    load_key(keys, s, k);
    chacha_block(k, counter, x);
    int hits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t hi = x[2 * j], lo = x[2 * j + 1];
      acc[4 * j + 0] += lo & 0xFFFFu;
      acc[4 * j + 1] += lo >> 16;
      acc[4 * j + 2] += hi & 0xFFFFu;
      acc[4 * j + 3] += hi >> 16;
      hits += (j < ndraw) & ((hi > zone_hi) | ((hi == zone_hi) & (lo >= zone_lo)));
    }
    if (hits) atomicAdd(rej + s, hits);
  }

  __shared__ uint32_t part[kThreads / 32][32];
  __shared__ uint32_t total[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) part[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    uint32_t v = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += part[w][threadIdx.x];
    total[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < ndraw) {
    const int j = threadIdx.x;
    uint64_t t = total[4 * j], v64 = t & 0xFFFFu, carry = t >> 16;
#pragma unroll
    for (int l = 1; l < 4; ++l) {
      t = total[4 * j + l] + carry;
      v64 |= (t & 0xFFFFu) << (16 * l);
      carry = t >> 16;
    }
    uint64_t r = v64 % p + (carry * K) % p;  // both terms < p < 2^63
    if (r >= p) r -= p;
    int32_t* o = limbs + (dim0 + j) * 4;
#pragma unroll
    for (int l = 0; l < 4; ++l) o[l] = (int32_t)((r >> (16 * l)) & 0xFFFFu);
  }
}

}  // namespace

// keys: [S, 8] u32; out: [S, nblocks, 16] u32. Returns a cudaError_t.
extern "C" int sda_chacha_keystream(const void* keys, void* out, int64_t S, int64_t nblocks,
                                    void* stream) {
  if (S <= 0 || nblocks <= 0 || nblocks >= (int64_t(1) << 32)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nblocks + kThreads - 1) / kThreads),
                  (unsigned)(S < 65535 ? S : 65535));
  chacha_keystream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint4*>(out), S, nblocks);
  return (int)cudaGetLastError();
}

// keys: [S, 8] u32; limbs: [d, 4] canonical u16 limbs (int32); rej: [S]
// int32, zeroed by the caller. p = 2^e - c (e <= 63), K = 2^64 mod p, the
// rejection zone starts at zone_hi * 2^32 + zone_lo. Returns a cudaError_t.
extern "C" int sda_chacha_fold(const void* keys, void* limbs, void* rej, int64_t S, int64_t d,
                               uint64_t p, uint64_t K, uint32_t zone_hi, uint32_t zone_lo,
                               void* stream) {
  const int64_t counters = (d + 7) / 8;
  if (S < 0 || S > 16384 || d <= 0 || counters >= (int64_t(1) << 31) || p >> 63)
    return (int)cudaErrorInvalidValue;
  chacha_fold_kernel<<<(unsigned)counters, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(limbs),
      static_cast<int32_t*>(rej), S, d, p, K, zone_hi, zone_lo);
  return (int)cudaGetLastError();
}
