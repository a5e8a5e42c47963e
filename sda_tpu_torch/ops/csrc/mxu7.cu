// Fused 7-bit-limb share + combine (+ reconstruct) for Hopper (sm_90a).
//
// Replaces sda_tpu/ops/mxu_kernel.py::_mxu_fused_kernel (B6, kernel
// generation 3). Per lane (batch position) b it computes
//
//   acc[:, b]  = bigS^T . sec[:, b]          unbiased 7-bit int8 x int8 -> int32
//              + bigR^T . rand[:, b]         in-kernel randomness (PRNG mode)
//   res        = carry to L7 + 4 seven-bit limbs, regroup into chunk-limb
//                canonical pieces (16-bit lanes), Montgomery-multiply piece t
//                by 2^(7*chunk*t) * R mod p, add the pieces mod p
//   [stage 2]  acc2 = big2^T . planes(res), limb-major 7-bit planes of the
//              canonical sums; res = the same epilogue on acc2
//   out        = res as u32 limbs [n_out, L, NBP], or its 7-bit planes
//                [n_out, L7, NBP] int8 (out7)
//
// Operands are unbiased limbs in [0, 127] and every matrix entry is a limb
// of a canonical value, so the int32 accumulator is exact under the
// wrapper's K_total * 127^2 < 2^31 guard: no ones column, no bias constants.
//
// Randomness (PRNG mode): Philox4x32-10 (sda_common.cuh), key = (seed, 0),
// counter = (global lane, participant, word group, 6); output word q of a
// call is PRNG word 4 * group + q of that (lane, participant), and raw limb i
// of the participant is (word[i / 4] >> 7 * (i % 4)) & 127. It runs in
// n_blocks blocks, each generated into shared memory and contracted against
// bigR by the same MMA path:
//   mode 1 (rand-sum): block g sums the raw limbs of carry-save group g
//     (gsize <= 129 participants) in two u32 words per PRNG word, limbs 0/2
//     in accE's 14-bit fields and limbs 1/3 in accO's (129 * 127 < 2^14,
//     carry-free), and re-splits each field sum into (lo, hi) 7-bit limbs:
//     row (2b + c) * wpp + w. Every block meets the same bigR columns.
//   mode 2 (grouped): block b holds participants [b * pb, (b + 1) * pb), RL
//     raw limbs each, row (participant - b * pb) * RL + i, against bigR
//     columns [b * kb, (b + 1) * kb).
//
// Design (first, simple, correct cut), B1's (csrc/mxu8.cu; the staging and
// MMA helpers are shared through sda_common.cuh):
//   * One block of 256 threads (8 warps) per tile of kT = 128 lanes; blocks
//     are independent, and the PRNG mapping does not depend on the tiling.
//   * The contraction runs on the int8 tensor cores with
//     mma.sync.m16n8k32.s32.s8.s8.s32: each warp owns 16 lanes and all MT m16
//     tiles of accumulator rows (n * L7 <= 192). K streams in tiles of 64
//     rows; bigS's tile is staged in shared memory as is, sec's tile is
//     transposed to K-contiguous while it is staged (4x4 byte transposes
//     with __byte_perm).
//   * Epilogue: the accumulator is spilled to shared memory over the staging
//     area; two threads per lane run the carry chains, the chunk fold, the
//     optional stage-2 contraction (n2 * L7 x n * L7, scalar, against big2
//     read through the L1 cache) and the output writes.
//
// Bounds on the H100 SXM at the gen-3 headline (768 participants, 1,000,002
// dims, p = 2^63 - 871, PRNG, fused reconstruction): sec is 20,736 x 333,824
// int8 = 6.92 GB, read once: 2.07 ms at 3.35 TB/s; the contraction is
// 2 * 72 * 21,600 * 333,824 = 1.04e12 int8 operations, 0.53 ms at 1,979
// TOPS; the randomness is 768 participants x 5 Philox calls per lane, 1.28e9
// calls. The rand-sum generator loop issues 59 SASS instructions per call
// (ptxas hoists the rounds' work on the counter words that do not change
// with the participant; the count includes the carry-save sums), 2.26 ms at
// 132 SMs x 128 issue lanes x 1980 MHz. So the kernel is bound by the
// Philox issue, just above the bytes. This design does nothing yet about
// either: the generator runs
// after the secrets' contraction instead of beside it (the TPU overlapped
// them), one thread owns a (lane, word group) for a whole carry-save group
// so 640 work items share 256 threads unevenly, and the sec stream has no
// cp.async/TMA pipelining. Those are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "sda_common.cuh"

namespace {

using namespace sda;  // Philox, limb arithmetic, the int8 MMA pipeline (kT, kThreads, kKT, kSA)

constexpr int kMaxLimbs = 32;  // 7-bit limbs of one carry chain (L7 + 4)
constexpr int kNParams = 24;
constexpr uint32_t kTag = 6u;  // fourth Philox counter word of this kernel
constexpr uint32_t kMask2 = 127u | (127u << 14);

struct Params {
  int K;          // sec rows (participants x slots x L7)
  int lda;        // bigS row stride (K rounded up to 32)
  int nbp;        // lanes
  int n_pad;      // rows of bigS / bigR
  int n;          // clerks (stage-1 outputs)
  int L7;         // 7-bit limbs per element
  int L;          // 16-bit limbs per element
  int chunk;      // 7-bit limbs per canonical-by-construction chunk
  int n_consts;   // rows of the Montgomery constant table
  int p_inv_w;    // -p^-1 mod 2^16
  int n2;         // stage-2 outputs (0: no fused reconstruction)
  int out7;       // write 7-bit planes instead of u32 limbs
  int mode;       // randomness: 0 none, 1 rand-sum, 2 grouped
  int P;          // participants
  int wpp;        // PRNG words per participant
  int RL;         // raw randomness limbs per participant
  int gsize;      // rand-sum: participants per carry-save group
  int pb;         // grouped: participants per block
  int n_blocks;   // randomness blocks
  int kb;         // randomness operand rows per block (multiple of 32)
  int bigr_cols;  // bigR row stride
  uint32_t seed;
  int off_consts;  // offsets into the uint32 constant table
  int off_p;
};

// ------------------------------------------------------------ epilogue

// L7 non-negative accumulator columns (weights 2^(7c)) -> canonical L lanes:
// carry to 7-bit limbs (the residual carry is below 2^25: four more limbs),
// regroup each chunk of `chunk` limbs into 16-bit lanes, fold chunk t with one
// Montgomery multiply by 2^(7*chunk*t) * R mod p, add the terms mod p.
__device__ void reduce_cols(const uint32_t* cols, const Params& p, const uint32_t* consts,
                            const uint32_t* pl, uint32_t* res) {
  const int L = p.L, nl = p.L7 + 4;
  uint32_t limbs[kMaxLimbs];
  uint32_t carry = 0;
  for (int c = 0; c < p.L7; ++c) {
    const uint32_t t = cols[c] + carry;
    limbs[c] = t & 127u;
    carry = t >> 7;
  }
  for (int r = 0; r < 4; ++r) {
    limbs[p.L7 + r] = carry & 127u;
    carry >>= 7;
  }
  uint32_t lanes16[kMaxL], term[kMaxL];
  const int nch = (nl + p.chunk - 1) / p.chunk;
  for (int t = 0; t < nch; ++t) {
    for (int j = 0; j < L; ++j) lanes16[j] = 0;
    for (int j = 0; j < p.chunk && t * p.chunk + j < nl; ++j) {
      const uint32_t b = limbs[t * p.chunk + j];
      const int o = 7 * j, w = o / 16, sh = o % 16;
      lanes16[w] |= (b << sh) & 0xFFFFu;
      if (sh + 7 > 16 && w + 1 < L) lanes16[w + 1] |= b >> (16 - sh);
    }
    mont_mul(lanes16, consts + t * L, t ? term : res, pl, (uint32_t)p.p_inv_w, L);
    if (t) add_mod(res, term, pl, L);
  }
}

// Bits [7 * l7, 7 * l7 + 7) of a canonical value held as L 16-bit lanes.
__device__ __forceinline__ uint32_t plane7(const uint32_t* res, int l7, int L) {
  const int o = 7 * l7, w = o / 16, sh = o % 16;
  uint32_t v = res[w] >> sh;
  if (sh + 7 > 16 && w + 1 < L) v |= res[w + 1] << (16 - sh);
  return v & 127u;
}

__device__ void store(const uint32_t* res, const Params& p, void* out, int i, int gl) {
  if (p.out7) {
    int8_t* o = static_cast<int8_t*>(out);
    for (int l7 = 0; l7 < p.L7; ++l7)
      o[(size_t)(i * p.L7 + l7) * p.nbp + gl] = (int8_t)plane7(res, l7, p.L);
  } else {
    int32_t* o = static_cast<int32_t*>(out);
    for (int l = 0; l < p.L; ++l) o[(size_t)(i * p.L + l) * p.nbp + gl] = (int32_t)res[l];
  }
}

// Randomness block blk, written transposed into sB ([lane][row], stride sb):
// rows [0, kb), zero past the block's used rows.
__device__ void rand_block(int8_t* sB, int sb, const Params& p, int blk, int lane0, int tid) {
  const int G = (p.wpp + 3) / 4;  // Philox calls per (lane, participant)
  int used;
  if (p.mode == 1) {
    used = 8 * p.wpp;
    const int p0 = blk * p.gsize;
    for (int idx = tid; idx < kT * G; idx += kThreads) {
      const int ll = idx % kT, q = idx / kT, gl = lane0 + ll;
      uint32_t accE[4] = {0, 0, 0, 0}, accO[4] = {0, 0, 0, 0};
      if (gl < p.nbp) {
        for (int j = 0; j < p.gsize; ++j) {
          uint32_t c[4] = {(uint32_t)gl, (uint32_t)(p0 + j), (uint32_t)q, kTag};
          philox4x32_10(c, p.seed, 0u);
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            accE[w4] += c[w4] & kMask2;
            accO[w4] += (c[w4] >> 7) & kMask2;
          }
        }
      }
      int8_t* row = sB + ll * sb;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        const int w = 4 * q + w4;
        if (w >= p.wpp) continue;
        const uint32_t s[4] = {accE[w4] & 0x3FFFu, accO[w4] & 0x3FFFu, accE[w4] >> 14,
                               accO[w4] >> 14};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          row[(2 * b) * p.wpp + w] = (int8_t)(s[b] & 127u);
          row[(2 * b + 1) * p.wpp + w] = (int8_t)(s[b] >> 7);
        }
      }
    }
  } else {
    const int p0 = blk * p.pb;
    const int np = min(p.P - p0, p.pb);
    used = np * p.RL;
    for (int idx = tid; idx < kT * np * G; idx += kThreads) {
      const int ll = idx % kT, rest = idx / kT, q = rest % G, pp = rest / G;
      const int gl = lane0 + ll;
      uint32_t c[4] = {(uint32_t)gl, (uint32_t)(p0 + pp), (uint32_t)q, kTag};
      if (gl < p.nbp)
        philox4x32_10(c, p.seed, 0u);
      else
        c[0] = c[1] = c[2] = c[3] = 0u;
      int8_t* row = sB + ll * sb + pp * p.RL;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 16 * q + 4 * w4 + b;
          if (i < p.RL) row[i] = (int8_t)((c[w4] >> (7 * b)) & 127u);
        }
    }
  }
  const int pad = p.kb - used;
  for (int idx = tid; idx < kT * pad; idx += kThreads) sB[(idx / pad) * sb + used + idx % pad] = 0;
}

// ------------------------------------------------------------------ kernel

template <int MT>
__global__ void __launch_bounds__(kThreads)
mxu7_fused_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                  const int8_t* __restrict__ bigr, const int8_t* __restrict__ big2,
                  const uint32_t* __restrict__ tables, void* __restrict__ out, Params p, int sb,
                  int region_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + MT * 16 * kSA;
  int32_t* sAcc = reinterpret_cast<int32_t*>(smem);  // over the staging area, after the MMAs
  uint8_t* sC7 = smem + region_a;                     // stage-2 planes [n * L7][kT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lane0 = blockIdx.x * kT;
  const int rows_used = p.n * p.L7;

  int acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  // stage 1: bigS^T . sec
  for (int k0 = 0; k0 < p.K; k0 += kKT) {
    __syncthreads();
    load_a_tile(sA, bigs, p.lda, p.n_pad, MT * 16, k0, tid);
    load_b_tile(sB, sb, sec, p.K, p.nbp, k0, lane0, tid);
    __syncthreads();
    const int ksteps = (min(kKT, p.K - k0) + 31) / 32;
    mma_chunk<MT>(acc, sA, sB, sb, 0, ksteps, warp, lane);
  }

  // in-kernel randomness: each block generated into sB, then bigR^T . block
  for (int blk = 0; blk < p.n_blocks; ++blk) {
    __syncthreads();
    rand_block(sB, sb, p, blk, lane0, tid);
    const int c0 = p.mode == 1 ? 0 : blk * p.kb;
    for (int kc = 0; kc < p.kb; kc += kKT) {
      __syncthreads();
      load_a_tile(sA, bigr, p.bigr_cols, p.n_pad, MT * 16, c0 + kc, tid);
      __syncthreads();
      mma_chunk<MT>(acc, sA, sB, sb, kc, min(kKT, p.kb - kc) / 32, warp, lane);
    }
  }
  __syncthreads();  // every warp is done with sA / sB before the spill

  // spill the accumulator: c0/c1 at row g, c2/c3 at row g + 8
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = mt * 16 + g, col = warp * 16 + nt * 8 + 2 * t;
        if (r < rows_used) {
          sAcc[r * kT + col] = acc[mt][nt][0];
          sAcc[r * kT + col + 1] = acc[mt][nt][1];
        }
        if (r + 8 < rows_used) {
          sAcc[(r + 8) * kT + col] = acc[mt][nt][2];
          sAcc[(r + 8) * kT + col + 1] = acc[mt][nt][3];
        }
      }
  }
  __syncthreads();

  // epilogue: two threads per lane
  const int ll = tid % kT, half = tid / kT, gl = lane0 + ll;
  const uint32_t* consts = tables + p.off_consts;
  const uint32_t* pl = tables + p.off_p;
  uint32_t cols[kMaxLimbs], res[kMaxL];
  for (int i = half; i < p.n; i += kThreads / kT) {
    for (int c = 0; c < p.L7; ++c) cols[c] = (uint32_t)sAcc[(i * p.L7 + c) * kT + ll];
    reduce_cols(cols, p, consts, pl, res);
    if (p.n2) {
      for (int l1 = 0; l1 < p.L7; ++l1)
        sC7[(l1 * p.n + i) * kT + ll] = (uint8_t)plane7(res, l1, p.L);
    } else if (gl < p.nbp) {
      store(res, p, out, i, gl);
    }
  }
  if (p.n2) {
    __syncthreads();
    const int rows2 = p.n * p.L7;
    for (int i2 = half; i2 < p.n2; i2 += kThreads / kT) {
      for (int c = 0; c < p.L7; ++c) {
        const int8_t* row = big2 + (size_t)(i2 * p.L7 + c) * rows2;
        int a = 0;
        for (int q = 0; q < rows2; ++q) a += row[q] * (int)sC7[q * kT + ll];
        cols[c] = (uint32_t)a;
      }
      reduce_cols(cols, p, consts, pl, res);
      if (gl < p.nbp) store(res, p, out, i2, gl);
    }
  }
}

template <int MT>
int launch(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, const int8_t* big2,
           const uint32_t* tables, void* out, const Params& p, cudaStream_t stream) {
  const int sb = (p.kb > kKT ? p.kb : kKT) + 16;  // == 16 mod 32
  const int staging = MT * 16 * kSA + kT * sb;
  const int spill = p.n * p.L7 * kT * (int)sizeof(int32_t);
  const int region_a = ((staging > spill ? staging : spill) + 15) & ~15;
  const size_t smem = (size_t)region_a + (p.n2 ? (size_t)p.n * p.L7 * kT : 0);
  cudaError_t err = cudaFuncSetAttribute(mxu7_fused_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nbp + kT - 1) / kT);
  mxu7_fused_kernel<MT><<<grid, kThreads, smem, stream>>>(sec, bigs, bigr, big2, tables, out, p,
                                                          sb, region_a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. iparams holds the kNParams ints of Params in field order
// (seed as its 32-bit pattern). out is int32 [n_out, L, NBP], or int8
// [n_out, L7, NBP] with out7. Returns a cudaError_t (0 on success).
extern "C" int sda_mxu7_fused(const void* sec, const void* bigs, const void* bigr,
                              const void* big2, const void* tables, void* out, int n_iparams,
                              const void* iparams, void* stream) {
  if (n_iparams != kNParams) return (int)cudaErrorInvalidValue;
  const int* v = static_cast<const int*>(iparams);
  Params p;
  p.K = v[0];
  p.lda = v[1];
  p.nbp = v[2];
  p.n_pad = v[3];
  p.n = v[4];
  p.L7 = v[5];
  p.L = v[6];
  p.chunk = v[7];
  p.n_consts = v[8];
  p.p_inv_w = v[9];
  p.n2 = v[10];
  p.out7 = v[11];
  p.mode = v[12];
  p.P = v[13];
  p.wpp = v[14];
  p.RL = v[15];
  p.gsize = v[16];
  p.pb = v[17];
  p.n_blocks = v[18];
  p.kb = v[19];
  p.bigr_cols = v[20];
  p.seed = (uint32_t)v[21];
  p.off_consts = v[22];
  p.off_p = v[23];
  if (p.L > kMaxL || p.L7 + 4 > kMaxLimbs || (p.lda & 31) || (p.bigr_cols & 31) || (p.kb & 31) ||
      p.mode < 0 || p.mode > 2 || (p.mode && p.n_blocks < 1) || (p.n2 && p.out7) ||
      p.n_consts * p.chunk < p.L7 + 4)
    return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const int8_t*>(sec);
  const auto* a = static_cast<const int8_t*>(bigs);
  const auto* r = static_cast<const int8_t*>(bigr);
  const auto* b2 = static_cast<const int8_t*>(big2);
  const auto* tb = static_cast<const uint32_t*>(tables);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((p.n * p.L7 + 15) / 16) {
    case 1: return launch<1>(s, a, r, b2, tb, out, p, st);
    case 2: return launch<2>(s, a, r, b2, tb, out, p, st);
    case 3: return launch<3>(s, a, r, b2, tb, out, p, st);
    case 4: return launch<4>(s, a, r, b2, tb, out, p, st);
    case 5: return launch<5>(s, a, r, b2, tb, out, p, st);
    case 6: return launch<6>(s, a, r, b2, tb, out, p, st);
    case 7: return launch<7>(s, a, r, b2, tb, out, p, st);
    case 8: return launch<8>(s, a, r, b2, tb, out, p, st);
    case 9: return launch<9>(s, a, r, b2, tb, out, p, st);
    case 10: return launch<10>(s, a, r, b2, tb, out, p, st);
    case 11: return launch<11>(s, a, r, b2, tb, out, p, st);
    case 12: return launch<12>(s, a, r, b2, tb, out, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
