// Fused share + combine on planar u32 tiles for Hopper (sm_90a): CIOS
// Montgomery products on the CUDA cores.
//
// Replaces sda_tpu/ops/pallas_kernels.py::_fused_planar_kernel (B7, kernel
// generation 1). One thread per lane (batch position); the participant loop
// runs inside the thread, where the TPU ran a fori_loop over a VMEM block.
// Per participant q and slot j the thread
//   * loads the L limbs of ext_j (secrets [P, slots, L, NBP], coalesced
//     across the warp's lanes), or, in PRNG mode (slots == k), draws the
//     randomness element of slot j >= k: L Philox words, 16-bit halves x1 and
//     x0, (x1 * R + x0) mod p by three Montgomery multiplies (the reference's
//     _uniform_lanes);
//   * adds the raw CIOS product ext_j * M[j, i] (value < 2p, L + 1 columns of
//     16 bits) for every clerk i onto n * (L + 1) u32 accumulators in
//     registers. A column stays below P * m * 2^16 < 2^31 under the wrapper's
//     P * m < 2^15 guard, so plain u32 adds are exact.
// At the end each clerk's columns are renormalised as the reference does:
// carry, split V = V_hi * R + V_lo, three Montgomery multiplies, one modular
// add; canonical limbs go to out [n, L, NBP].
//
// The share matrix (Montgomery form, [m, n, L]), the r2 and one rows and the
// limbs of p are copied to shared memory at the start of each block; every
// thread of a warp reads the same word, a broadcast.
//
// Randomness: Philox4x32-10 (sda_common.cuh), key = (seed, 0), counter =
// (global lane, participant, word group, 7); PRNG word w of a (lane,
// participant) is output word w % 4 of group w / 4, and word s * L + l is limb
// l of randomness slot s. The plain version in ops/pallas_kernels.py uses the same mapping.
//
// Bounds on the H100 SXM at the gen-1 headline (768 participants, 1,000,002
// dims, p = 2^63 - 871, L = 4, PRNG): the planar operand is 768 x 3 x 4 x
// 333,824 u32 = 12.3 GB, 3.7 ms at 3.35 TB/s; the arithmetic is 56 raw CIOS
// products (L (2L + 1) = 36 multiplies each) and 4 randomness elements (3
// Montgomery multiplies and one Philox call each) per (lane, participant).
// The L = 4 instance's participant loop issues 9,182 SASS instructions per
// (lane, participant): 2.35e12 in all, 70.4 ms at 132 SMs x 128 issue lanes
// x 1980 MHz, 19 times the bytes. Of them 5,803 run on the INT32 pipe
// (LOP3, LEA, SHF, IADD3), whose 64 lanes per SM take 88.9 ms for them, and
// 2,876 are IMAD forms on the FMA pipe. So the kernel is bound by integer
// issue, and this code by its INT32 pipe. This design does nothing about
// that yet: the CIOS loop is the reference's, unrolled per limb
// count (L = 2, 4, 8 are template instances; the clerk loop is unrolled to 8
// with a uniform guard so the accumulators stay in registers).

#include <cstdint>
#include <cuda_runtime.h>

#include "sda_common.cuh"

namespace {

using sda::philox4x32_10;

constexpr int kThreads = 128;
constexpr int kMaxN = 8;  // clerks
constexpr int kNParams = 10;
constexpr uint32_t kTag = 7u;  // fourth Philox counter word of this kernel

struct Params {
  int P;         // participants
  int slots;     // slots per participant in the operand (k or m)
  int k;         // secret slots
  int m;         // k + r
  int n;         // clerks
  int L;         // 16-bit limbs
  int nbp;       // lanes
  int has_prng;  // draw the r randomness slots in the kernel
  uint32_t seed;
  uint32_t p_inv_w;  // -p^-1 mod 2^16
};

// Raw CIOS product: T[0..L] = the value a * b * 2^(-16L) mod p plus 0 or p
// (below 2p), in 16-bit columns (T[L] is 0 or 1). Every step fits uint32.
template <int L>
__device__ __forceinline__ void cios_raw(const uint32_t (&a)[L], const uint32_t* b,
                                         const uint32_t* pl, uint32_t p_inv_w,
                                         uint32_t (&T)[L + 2]) {
#pragma unroll
  for (int j = 0; j < L + 2; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint32_t c = 0, t;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      t = T[j] + a[i] * b[j] + c;
      T[j] = t & 0xFFFFu;
      c = t >> 16;
    }
    t = T[L] + c;
    T[L] = t & 0xFFFFu;
    T[L + 1] += t >> 16;
    const uint32_t mq = (T[0] * p_inv_w) & 0xFFFFu;
    t = T[0] + mq * pl[0];
    c = t >> 16;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      t = T[j] + mq * pl[j] + c;
      T[j - 1] = t & 0xFFFFu;
      c = t >> 16;
    }
    t = T[L] + c;
    T[L - 1] = t & 0xFFFFu;
    T[L] = T[L + 1] + (t >> 16);
    T[L + 1] = 0;
  }
}

// Subtract p if (carry, s) >= p.
template <int L>
__device__ __forceinline__ void cond_sub(uint32_t (&s)[L], uint32_t carry, const uint32_t* pl) {
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t t = s[j] - pl[j] - borrow;
    d[j] = t & 0xFFFFu;
    borrow = (t >> 16) & 1u;
  }
  const bool take = carry > 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = take ? d[j] : s[j];
}

template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[L], const uint32_t* b,
                                         const uint32_t* pl, uint32_t p_inv_w,
                                         uint32_t (&out)[L]) {
  uint32_t T[L + 2];
  cios_raw<L>(a, b, pl, p_inv_w, T);
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = T[j];
  cond_sub<L>(out, T[L], pl);
}

template <int L>
__device__ __forceinline__ void add_mod(uint32_t (&a)[L], const uint32_t (&b)[L],
                                        const uint32_t* pl) {
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t t = a[j] + b[j] + carry;
    a[j] = t & 0xFFFFu;
    carry = t >> 16;
  }
  cond_sub<L>(a, carry, pl);
}

// Randomness slot s of participant q at lane gl: L PRNG words -> one uniform
// element (x1 * R + x0) mod p.
template <int L>
__device__ __forceinline__ void uniform_element(const Params& p, int gl, int q, int s,
                                                const uint32_t* r2, const uint32_t* one,
                                                const uint32_t* pl, uint32_t (&e)[L]) {
  uint32_t w[L];
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int g = 0; g < L / 4; ++g) {
      uint32_t c[4] = {(uint32_t)gl, (uint32_t)q, (uint32_t)(s * (L / 4) + g), kTag};
      philox4x32_10(c, p.seed, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[4 * g + j] = c[j];
    }
  } else {  // L == 2: two slots share one Philox call
    uint32_t c[4] = {(uint32_t)gl, (uint32_t)q, (uint32_t)(s / 2), kTag};
    philox4x32_10(c, p.seed, 0u);
    const bool upper = s & 1;
    w[0] = upper ? c[2] : c[0];
    w[1] = upper ? c[3] : c[1];
  }
  uint32_t x0[L], x1[L], a[L], y[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    x0[l] = w[l] & 0xFFFFu;
    x1[l] = w[l] >> 16;
  }
  mont_mul<L>(x1, r2, pl, p.p_inv_w, a);  // x1 * R mod p
  mont_mul<L>(x0, r2, pl, p.p_inv_w, y);  // x0 * R mod p
  mont_mul<L>(y, one, pl, p.p_inv_w, e);  // x0 mod p
  add_mod<L>(e, a, pl);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
planar_cios_kernel(const uint32_t* __restrict__ sec, const uint32_t* __restrict__ table,
                   uint32_t* __restrict__ out, Params p) {
  extern __shared__ uint32_t sT[];
  const int tsize = (p.m + 2) * p.n * L + L;
  for (int i = threadIdx.x; i < tsize; i += kThreads) sT[i] = table[i];
  __syncthreads();
  const int gl = blockIdx.x * kThreads + threadIdx.x;
  if (gl >= p.nbp) return;
  const uint32_t* r2 = sT + p.m * p.n * L;
  const uint32_t* one = r2 + p.n * L;
  const uint32_t* pl = one + p.n * L;
  const size_t nbp = (size_t)p.nbp;

  uint32_t acc[kMaxN][L + 1];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i)
#pragma unroll
    for (int c = 0; c <= L; ++c) acc[i][c] = 0;

  for (int q = 0; q < p.P; ++q) {
    for (int j = 0; j < p.m; ++j) {
      uint32_t e[L];
      if (j < p.slots) {
        const uint32_t* src = sec + (size_t)(q * p.slots + j) * L * nbp + gl;
#pragma unroll
        for (int l = 0; l < L; ++l) e[l] = src[l * nbp];
      } else {
        uniform_element<L>(p, gl, q, j - p.k, r2, one, pl, e);
      }
      const uint32_t* mj = sT + j * p.n * L;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < p.n) {
          uint32_t T[L + 2];
          cios_raw<L>(e, mj + i * L, pl, p.p_inv_w, T);
#pragma unroll
          for (int c = 0; c <= L; ++c) acc[i][c] += T[c];
        }
      }
    }
  }

  // renormalise each clerk's redundant column sum into canonical limbs
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < p.n) {
      uint32_t v_lo[L], v_hi[L], a[L], y[L], b[L];
      uint32_t carry = 0;
#pragma unroll
      for (int c = 0; c < L; ++c) {
        const uint32_t t = acc[i][c] + carry;
        v_lo[c] = t & 0xFFFFu;
        carry = t >> 16;
      }
      const uint32_t t = acc[i][L] + carry;
#pragma unroll
      for (int c = 0; c < L; ++c) v_hi[c] = 0;
      v_hi[0] = t & 0xFFFFu;
      v_hi[1] = t >> 16;
      mont_mul<L>(v_hi, r2, pl, p.p_inv_w, a);  // V_hi * R mod p
      mont_mul<L>(v_lo, r2, pl, p.p_inv_w, y);  // V_lo * R mod p
      mont_mul<L>(y, one, pl, p.p_inv_w, b);    // V_lo mod p
      add_mod<L>(a, b, pl);
#pragma unroll
      for (int l = 0; l < L; ++l) out[(size_t)(i * L + l) * nbp + gl] = a[l];
    }
  }
}

template <int L>
int launch(const uint32_t* sec, const uint32_t* table, uint32_t* out, const Params& p,
           cudaStream_t stream) {
  const size_t smem = (size_t)((p.m + 2) * p.n * L + L) * sizeof(uint32_t);
  const dim3 grid((p.nbp + kThreads - 1) / kThreads);
  planar_cios_kernel<L><<<grid, kThreads, smem, stream>>>(sec, table, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. iparams holds the kNParams ints of Params in field order
// (seed as its 32-bit pattern). sec is [P, slots, L, NBP] u32, table the
// [(m + 2) * n * L + L] u32 scalar table (matrix, r2 row, one row, p), out
// [n, L, NBP] u32. Returns a cudaError_t (0 on success).
extern "C" int sda_planar_cios(const void* sec, const void* table, void* out, int n_iparams,
                               const void* iparams, void* stream) {
  if (n_iparams != kNParams) return (int)cudaErrorInvalidValue;
  const int* v = static_cast<const int*>(iparams);
  Params p;
  p.P = v[0];
  p.slots = v[1];
  p.k = v[2];
  p.m = v[3];
  p.n = v[4];
  p.L = v[5];
  p.nbp = v[6];
  p.has_prng = v[7];
  p.seed = (uint32_t)v[8];
  p.p_inv_w = (uint32_t)v[9];
  if (p.n < 1 || p.n > kMaxN || p.m < p.slots || p.slots < 1 ||
      (p.has_prng ? p.slots != p.k : p.slots != p.m) ||
      (long long)p.P * p.m >= (1 << 15) || p.nbp < 1)
    return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const uint32_t*>(sec);
  const auto* t = static_cast<const uint32_t*>(table);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (p.L) {
    case 2: return launch<2>(s, t, o, p, st);
    case 4: return launch<4>(s, t, o, p, st);
    case 8: return launch<8>(s, t, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
