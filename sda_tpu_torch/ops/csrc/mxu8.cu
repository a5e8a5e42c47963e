// Fused byte-limb share + combine (+ reconstruct) for Hopper (sm_90a), in
// three variants of one kernel body, chosen at build time by SDA_MXU8_MODE
// (one shared library per variant, see ops/cuda_build.py):
//
//   0  B1, replaces sda_tpu/ops/mxu8.py::_mxu8_kernel: one participant chunk,
//      the canonical result written to out.
//   1  B3, replaces sda_tpu/ops/mxu8.py::_mxu8_kernel_acc (host-driven
//      streaming): B1, then the canonical result is added mod p onto out,
//      which holds the running sums on entry (the caller's acc_in: the same
//      buffer is input and output). Each thread reads its own limbs of out
//      before it stores their sum to the same addresses, so the in-place
//      update needs no synchronisation.
//   2  B2, replaces sda_tpu/ops/mxu8.py::_mxu8_kernel_chunked: n_chunks
//      stacked participant chunks reduced in ONE launch. The TPU walked the
//      chunks as a sequential grid axis with a VMEM accumulator; here each
//      block loops over the chunks itself, runs B1's whole pipeline on rows
//      [c * K, (c + 1) * K) (offsets in size_t: c * K * nbp passes 2^31),
//      adds the canonical limbs mod p into a shared-memory accumulator
//      (L * n_out * 128 lanes * 4 B, 32 KB at 128-bit without
//      reconstruction) and writes out once, after the last chunk.
//      Chunk c draws its randomness with key seed + c * seed_stride.
//
// Every variant computes, per lane (batch position) b and chunk:
//
//   acc[:, b]  = bigS^T . sec[:, b]                  biased int8 x int8 -> int32
//              + bigR^T . rand2[:, b]                in-kernel randomness (PRNG mode)
//   bytes      = u32 carry chain of acc (bias constants C1, 128 * acc[ones])
//   [stage 2]  acc2 = big2^T . (bytes - 128), second chain (constants C2)
//   out[l * n_out + i, b] = limb l of the canonical result i (pseudo-Mersenne
//                           fold, or Montgomery chunk fold)
//
// Design (first, simple, correct cut):
//   * One block of 256 threads (8 warps) per tile of kT = 128 lanes; blocks
//     are independent (the TPU grid carried nothing across lane blocks
//     either; B2's chunk reduction stays inside the block).
//   * Stage-1 contraction on the int8 tensor cores with
//     mma.sync.m16n8k32.s32.s8.s8.s32. Each warp owns 16 lanes (two n8
//     tiles) and all MT m16 tiles of output rows. K streams in tiles of 64
//     rows: bigS's tile is staged in shared memory as is (rows are K
//     contiguous), and sec's tile, which is lane-contiguous in device memory,
//     is transposed to K-contiguous while it is staged (4x4 byte transposes
//     with __byte_perm), so the 6 GB operand is never transposed in memory.
//   * Randomness: Philox4x32-10 (sda_common.cuh), one stream per
//     (lane, participant draw, word group): key = (seed, 0), counter =
//     (global lane, draw, word group, 0); output word q of a call is PRNG
//     word 4 * group + q of that (lane, draw). Per word: accR += w,
//     accO += w >> 16, then accE = accR - (accO << 16), all uint32. The
//     biased bytes of accE / accO, in the (c, parity, w) row order of the
//     randomness-sum matrix, are the B operand of a second MMA pass against
//     bigR.
//   * Epilogue: the accumulator is spilled to shared memory; two threads per
//     lane run the carry chains, the optional stage-2 contraction (88 x 25 at
//     the headline, scalar), the fold, and the limb-major output writes.
//
// Bounds on the H100 SXM. B1 at the headline (768 participants, 1,000,002
// dims, p = 2^63 - 871): sec is 18,432 x 333,824 int8 = 6.15 GB read once,
// about 1.84 ms at 3.35 TB/s; the contractions are 1.19e12 int8 operations,
// about 0.6 ms at 1,979 TOPS; the randomness is 2.05e9 Philox words on the
// CUDA cores. B3 adds a read and a write of the running sums (43 MB at that
// shape) to B1's bytes. B2 reads every chunk once; at the 128-bit config-3
// shape (2 x 512 participants, NBP 3,584) sec is 0.176 GB, so its bound is
// about 0.05 ms, but 3,584 lanes make only 28 blocks for 132 SMs, so the
// kernel is bound by too few blocks long before bytes. This design does
// nothing yet about these bounds: no cp.async/TMA pipelining of the sec
// stream, no wgmma, no split of K across blocks for narrow jobs, and a full
// ten-round Philox per four words. Those are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "sda_common.cuh"

namespace {

using namespace sda;  // Philox, limb arithmetic, the int8 MMA pipeline (kT, kThreads, kKT, kSA)

constexpr int kMaxB = 32;      // bytes per chain (L8 + residual limbs)
constexpr int kMaxW = 16;      // 16-bit lanes regrouped from a chain
constexpr int kMaxMT = 12;     // m16 tiles of output rows (n * L8 + 1 <= 192)
constexpr int kNParams = 29;

constexpr int kPlain = 0;    // B1
constexpr int kAcc = 1;      // B3
constexpr int kChunked = 2;  // B2
#ifndef SDA_MXU8_MODE
#define SDA_MXU8_MODE 0
#endif
constexpr int kMode = SDA_MXU8_MODE;
static_assert(kMode == kPlain || kMode == kAcc || kMode == kChunked, "SDA_MXU8_MODE is 0, 1 or 2");

struct Params {
  int K;         // sec rows (participants x slots x L8)
  int nbp;       // lanes
  int n_pad;     // rows of bigS / bigR
  int Kr;        // randomness operand rows (0: caller randomness, no PRNG)
  int Kr_pad;    // bigR columns as stored (multiple of 32)
  int n;         // clerks (stage-1 outputs)
  int L8;        // bytes per element
  int n_res1;    // residual carry bytes of the stage-1 chain
  int n2;        // stage-2 outputs (0: no fused reconstruction)
  int n_pad2;    // rows of big2
  int rows2;     // stage-2 operand rows = (L8 + n_res1) * n
  int n_res2;    // residual carry bytes of the stage-2 chain
  int L;         // 16-bit limbs per element
  int chunk8;    // bytes per canonical-by-construction chunk
  int use_special;
  int sp_e;      // p = 2^sp_e - sp_c when use_special
  int sp_c;
  int p_inv_w;   // -p^-1 mod 2^16
  int rp;        // randomness draws summed per slot
  int wpp;       // PRNG words per draw
  int n_bytes;   // bytes per randomness field sum
  uint32_t seed;
  int off_c1;    // offsets into the uint32 constant table
  int off_c2;
  int off_consts;
  int off_p;
  int n_consts;
  int n_chunks;          // stacked chunks of K rows (B2; 1 otherwise)
  uint32_t seed_stride;  // chunk c draws with key seed + c * seed_stride (B2)
};

__device__ __forceinline__ uint32_t byte_of(uint32_t x, int c) {
  return c < 4 ? (x >> (8 * c)) & 0xFFu : 0u;
}

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s) {
  return s >= 32 ? 0u : x << s;
}

// ------------------------------------------------------------ folds

// Pseudo-Mersenne canonicalisation (p = 2^e - c): byte limbs -> L lanes.
__device__ void fold_special(const uint32_t* bytes, int nb, const Params& p,
                             const uint32_t* pl, uint32_t* out) {
  const int L = p.L, e = p.sp_e;
  const uint32_t c = (uint32_t)p.sp_c;
  uint32_t ln[kMaxW];
  int nl = (nb + 1) / 2;
  for (int w = 0; w < nl; ++w)
    ln[w] = bytes[2 * w] | (2 * w + 1 < nb ? bytes[2 * w + 1] << 8 : 0u);
  const int wE = e / 16, sh = e % 16;
  for (int round = 0; round < 2; ++round) {
    uint32_t hi = ln[wE] >> sh;
    int bits = 16 - sh;
    for (int w = wE + 1; w < nl; ++w) {
      hi |= shl32(ln[w], bits);
      bits += 16;
    }
    ln[wE] &= (1u << sh) - 1u;
    for (int w = wE + 1; w < L; ++w) ln[w] = 0;
    nl = L;
    // V mod p = lo + hi * c; 16-bit halves keep every product inside u32
    const uint32_t add0 = (hi & 0xFFFFu) * c, add1 = (hi >> 16) * c;
    const uint32_t inc[3] = {add0 & 0xFFFFu, (add0 >> 16) + (add1 & 0xFFFFu), add1 >> 16};
    uint32_t carry = 0;
    for (int w = 0; w < L; ++w) {
      const uint32_t t = ln[w] + (w < 3 ? inc[w] : 0u) + carry;
      ln[w] = t & 0xFFFFu;
      carry = t >> 16;
    }
  }
  cond_sub(ln, 0u, pl, L);
  for (int j = 0; j < L; ++j) out[j] = ln[j];
}

// Montgomery chunk fold: chunk t of chunk8 bytes times Montgomery-form 2^(8*chunk8*t).
__device__ void fold_mont(const uint32_t* bytes, int nb, const Params& p, const uint32_t* pl,
                          const uint32_t* consts, uint32_t* out) {
  const int L = p.L;
  const int nch = (nb + p.chunk8 - 1) / p.chunk8;
  uint32_t lanes16[kMaxL], term[kMaxL];
  for (int t = 0; t < nch; ++t) {
    for (int j = 0; j < L; ++j) lanes16[j] = 0;
    for (int j = 0; j < p.chunk8 && t * p.chunk8 + j < nb; ++j)
      lanes16[j / 2] |= bytes[t * p.chunk8 + j] << (8 * (j % 2));
    mont_mul(lanes16, consts + t * L, t ? term : out, pl, (uint32_t)p.p_inv_w, L);
    if (t) add_mod(out, term, pl, L);
  }
}

__device__ void fold_and_store(const uint32_t* bytes, int nb, const Params& p,
                               const uint32_t* tables, int32_t* out, int n_out, int i, int lane) {
  uint32_t res[kMaxL];
  const uint32_t* pl = tables + p.off_p;
  if (p.use_special)
    fold_special(bytes, nb, p, pl, res);
  else
    fold_mont(bytes, nb, p, pl, tables + p.off_consts, res);
  for (int l = 0; l < p.L; ++l)
    out[(size_t)(l * n_out + i) * p.nbp + lane] = (int32_t)res[l];
}

// B2 and B3's form of fold_and_store for lane ll of the block (global lane
// gl); B1 calls fold_and_store itself, so its code is what it was before
// the variants existed. B3 adds the canonical limbs mod p onto the limbs
// out holds; B2 adds them mod p into the shared-memory accumulator
// sCanon ([L][n_out][kT]) and stores the sum only for the last chunk. Each
// (i, ll) belongs to one thread for the whole launch, so neither the
// accumulator nor out needs a barrier between its read and its write.
template <int MODE>
__device__ void fold_and_emit(const uint32_t* bytes, int nb, const Params& p,
                              const uint32_t* tables, int32_t* out, uint32_t* sCanon, int n_out,
                              int i, int ll, int gl, bool first, bool last) {
  uint32_t res[kMaxL];
  const uint32_t* pl = tables + p.off_p;
  if (p.use_special)
    fold_special(bytes, nb, p, pl, res);
  else
    fold_mont(bytes, nb, p, pl, tables + p.off_consts, res);
  if constexpr (MODE == kChunked) {
    if (!first) {
      uint32_t prev[kMaxL];
      for (int l = 0; l < p.L; ++l) prev[l] = sCanon[(l * n_out + i) * kT + ll];
      add_mod(res, prev, pl, p.L);
    }
    if (!last) {
      for (int l = 0; l < p.L; ++l) sCanon[(l * n_out + i) * kT + ll] = res[l];
      return;
    }
  }
  if constexpr (MODE == kAcc) {
    uint32_t prev[kMaxL];
    for (int l = 0; l < p.L; ++l) prev[l] = (uint32_t)out[(size_t)(l * n_out + i) * p.nbp + gl];
    add_mod(res, prev, pl, p.L);
  }
  for (int l = 0; l < p.L; ++l)
    out[(size_t)(l * n_out + i) * p.nbp + gl] = (int32_t)res[l];
}

// ------------------------------------------------------------------ kernel

template <int MT, int MODE>
__global__ void __launch_bounds__(kThreads)
mxu8_fused_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                  const int8_t* __restrict__ bigr, const int8_t* __restrict__ big2,
                  const uint32_t* __restrict__ tables, int32_t* __restrict__ out, Params p,
                  int sb, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + MT * 16 * kSA;
  uint8_t* sB1 = smem;  // stage-1 bytes for stage 2, reuses the tiles' space
  int32_t* sAcc = reinterpret_cast<int32_t*>(smem + stage_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lane0 = blockIdx.x * kT;
  const int rows_used = p.n * p.L8 + 1;
  const int n_out = p.n2 ? p.n2 : p.n;
  // B2's canonical accumulator, past the spill area
  uint32_t* sCanon = reinterpret_cast<uint32_t*>(sAcc + rows_used * kT);
  const int nch = MODE == kChunked ? p.n_chunks : 1;

  for (int ch = 0; ch < nch; ++ch) {
    const int8_t* sec_c = MODE == kChunked ? sec + (size_t)ch * p.K * p.nbp : sec;
    const uint32_t seed_c = MODE == kChunked ? p.seed + (uint32_t)ch * p.seed_stride : p.seed;
    const bool first = ch == 0, last = ch == nch - 1;

    int acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

    // stage 1: bigS^T . sec (the barrier at the top of each tile also
    // orders the previous chunk's epilogue before this chunk's staging)
    for (int k0 = 0; k0 < p.K; k0 += kKT) {
      __syncthreads();
      load_a_tile(sA, bigs, p.K, p.n_pad, MT * 16, k0, tid);
      load_b_tile(sB, sb, sec_c, p.K, p.nbp, k0, lane0, tid);
      __syncthreads();
      const int ksteps = (min(kKT, p.K - k0) + 31) / 32;
      mma_chunk<MT>(acc, sA, sB, sb, 0, ksteps, warp, lane);
    }

    // in-kernel randomness: u16-field sums over rp draws -> biased bytes
    if (p.Kr > 0) {
      __syncthreads();
      const int groups = (p.wpp + 3) / 4;
      for (int idx = tid; idx < kT * groups; idx += kThreads) {
        const int ll = idx % kT, g = idx / kT, gl = lane0 + ll;
        uint32_t accR[4] = {0, 0, 0, 0}, accO[4] = {0, 0, 0, 0};
        if (gl < p.nbp) {
          for (int j = 0; j < p.rp; ++j) {
            uint32_t c[4] = {(uint32_t)gl, (uint32_t)j, (uint32_t)g, 0u};
            philox4x32_10(c, seed_c, 0u);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              accR[q] += c[q];
              accO[q] += c[q] >> 16;
            }
          }
        }
        int8_t* row = sB + ll * sb;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int w = 4 * g + q;
          if (w >= p.wpp) continue;
          // accR = sum(lo) + 2^16 sum(hi) mod 2^32 and sum(lo) < 2^32: exact
          const uint32_t accE = accR[q] - (accO[q] << 16);
          for (int cb = 0; cb < p.n_bytes; ++cb) {
            row[(2 * cb) * p.wpp + w] = (int8_t)(byte_of(accE, cb) ^ 0x80u);
            row[(2 * cb + 1) * p.wpp + w] = (int8_t)(byte_of(accO[q], cb) ^ 0x80u);
          }
        }
      }
      for (int kc = 0; kc < p.Kr_pad; kc += kKT) {
        __syncthreads();
        load_a_tile(sA, bigr, p.Kr_pad, p.n_pad, MT * 16, kc, tid);
        __syncthreads();
        mma_chunk<MT>(acc, sA, sB, sb, kc, min(kKT, p.Kr_pad - kc) / 32, warp, lane);
      }
    }

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
    const int L8 = p.L8;
    const uint32_t* c1 = tables + p.off_c1;
    uint32_t bytes[kMaxB];
    const uint32_t s128 = (uint32_t)sAcc[(p.n * L8) * kT + ll] * 128u;
    for (int i = half; i < p.n; i += kThreads / kT) {
      uint32_t carry = 0;
      for (int c = 0; c < L8; ++c) {
        const uint32_t t = (uint32_t)sAcc[(i * L8 + c) * kT + ll] + c1[i * L8 + c] + s128 + carry;
        bytes[c] = t & 0xFFu;
        carry = t >> 8;
      }
      for (int r = 0; r < p.n_res1; ++r) {
        bytes[L8 + r] = carry & 0xFFu;
        carry >>= 8;
      }
      if (p.n2) {
        for (int l1 = 0; l1 < L8 + p.n_res1; ++l1) sB1[(l1 * p.n + i) * kT + ll] = (uint8_t)bytes[l1];
      } else if (gl < p.nbp) {
        if constexpr (MODE == kPlain)
          fold_and_store(bytes, L8 + p.n_res1, p, tables, out, p.n, i, gl);
        else
          fold_and_emit<MODE>(bytes, L8 + p.n_res1, p, tables, out, sCanon, n_out, i, ll, gl,
                              first, last);
      }
    }
    if (p.n2) {
      __syncthreads();
      const uint32_t* c2 = tables + p.off_c2;
      const int8_t* ones_row = big2 + (size_t)(p.n2 * L8) * p.rows2;
      int ones = 0;
      for (int q = 0; q < p.rows2; ++q) ones += ones_row[q] * ((int)sB1[q * kT + ll] - 128);
      const uint32_t s128_2 = (uint32_t)ones * 128u;
      for (int i2 = half; i2 < p.n2; i2 += kThreads / kT) {
        uint32_t carry = 0;
        for (int c = 0; c < L8; ++c) {
          const int8_t* row = big2 + (size_t)(i2 * L8 + c) * p.rows2;
          int a = 0;
          for (int q = 0; q < p.rows2; ++q) a += row[q] * ((int)sB1[q * kT + ll] - 128);
          const uint32_t t = (uint32_t)a + c2[i2 * L8 + c] + s128_2 + carry;
          bytes[c] = t & 0xFFu;
          carry = t >> 8;
        }
        for (int r = 0; r < p.n_res2; ++r) {
          bytes[L8 + r] = carry & 0xFFu;
          carry >>= 8;
        }
        if (gl < p.nbp) {
          if constexpr (MODE == kPlain)
            fold_and_store(bytes, L8 + p.n_res2, p, tables, out, p.n2, i2, gl);
          else
            fold_and_emit<MODE>(bytes, L8 + p.n_res2, p, tables, out, sCanon, n_out, i2, ll, gl,
                                first, last);
        }
      }
    }
  }
}

template <int MT>
int launch(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, const int8_t* big2,
           const uint32_t* tables, int32_t* out, const Params& p, cudaStream_t stream) {
  const int sb = (p.Kr_pad > kKT ? p.Kr_pad : kKT) + 16;  // == 16 mod 32
  int stage_bytes = MT * 16 * kSA + kT * sb;
  const int b1_bytes = p.n2 ? p.rows2 * kT : 0;
  if (b1_bytes > stage_bytes) stage_bytes = b1_bytes;
  stage_bytes = (stage_bytes + 15) & ~15;
  size_t smem = (size_t)stage_bytes + (size_t)(p.n * p.L8 + 1) * kT * sizeof(int32_t);
  if (kMode == kChunked) smem += (size_t)p.L * (p.n2 ? p.n2 : p.n) * kT * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(mxu8_fused_kernel<MT, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nbp + kT - 1) / kT);
  mxu8_fused_kernel<MT, kMode><<<grid, kThreads, smem, stream>>>(sec, bigs, bigr, big2, tables,
                                                                 out, p, sb, stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point of the variant this library was built as (SDA_MXU8_MODE).
// iparams holds the kNParams ints of Params in field order (seed and
// seed_stride as their 32-bit patterns). For B3, out holds the running sums
// on entry. Returns a cudaError_t (0 on success).
extern "C" int sda_mxu8_fused(const void* sec, const void* bigs, const void* bigr,
                              const void* big2, const void* tables, void* out,
                              const void* iparams, int n_iparams, void* stream) {
  if (n_iparams != kNParams) return (int)cudaErrorInvalidValue;
  const int* v = static_cast<const int*>(iparams);
  Params p;
  p.K = v[0];
  p.nbp = v[1];
  p.n_pad = v[2];
  p.Kr = v[3];
  p.Kr_pad = v[4];
  p.n = v[5];
  p.L8 = v[6];
  p.n_res1 = v[7];
  p.n2 = v[8];
  p.n_pad2 = v[9];
  p.rows2 = v[10];
  p.n_res2 = v[11];
  p.L = v[12];
  p.chunk8 = v[13];
  p.use_special = v[14];
  p.sp_e = v[15];
  p.sp_c = v[16];
  p.p_inv_w = v[17];
  p.rp = v[18];
  p.wpp = v[19];
  p.n_bytes = v[20];
  p.seed = (uint32_t)v[21];
  p.off_c1 = v[22];
  p.off_c2 = v[23];
  p.off_consts = v[24];
  p.off_p = v[25];
  p.n_consts = v[26];
  p.n_chunks = v[27];
  p.seed_stride = (uint32_t)v[28];
  if (p.n_chunks < 1 || (kMode != kChunked && p.n_chunks != 1)) return (int)cudaErrorInvalidValue;
  if (p.L > kMaxL || p.L8 + (p.n_res1 > p.n_res2 ? p.n_res1 : p.n_res2) > kMaxB ||
      (p.K & 3) || (p.Kr_pad & 31))
    return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const int8_t*>(sec);
  const auto* a = static_cast<const int8_t*>(bigs);
  const auto* r = static_cast<const int8_t*>(bigr);
  const auto* b2 = static_cast<const int8_t*>(big2);
  const auto* tb = static_cast<const uint32_t*>(tables);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((p.n * p.L8 + 1 + 15) / 16) {
    case 1: return launch<1>(s, a, r, b2, tb, o, p, st);
    case 2: return launch<2>(s, a, r, b2, tb, o, p, st);
    case 3: return launch<3>(s, a, r, b2, tb, o, p, st);
    case 4: return launch<4>(s, a, r, b2, tb, o, p, st);
    case 5: return launch<5>(s, a, r, b2, tb, o, p, st);
    case 6: return launch<6>(s, a, r, b2, tb, o, p, st);
    case 7: return launch<7>(s, a, r, b2, tb, o, p, st);
    case 8: return launch<8>(s, a, r, b2, tb, o, p, st);
    case 9: return launch<9>(s, a, r, b2, tb, o, p, st);
    case 10: return launch<10>(s, a, r, b2, tb, o, p, st);
    case 11: return launch<11>(s, a, r, b2, tb, o, p, st);
    case 12: return launch<12>(s, a, r, b2, tb, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
