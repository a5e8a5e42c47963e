// Fused byte-limb share + combine (+ reconstruct) for Hopper (sm_90a), in
// three variants of one kernel body, chosen at build time by SDA_MXU8_MODE
// (one shared library per variant, see ops/cuda_build.py):
//
//   0  B1, replaces sda_tpu/ops/mxu8.py::_mxu8_kernel (:454): one participant chunk,
//      the canonical result written to out.
//   1  B3, replaces sda_tpu/ops/mxu8.py::_mxu8_kernel_acc (:474, host-driven
//      streaming): B1, then the canonical result is added mod p onto out,
//      which holds the running sums on entry (the caller's acc_in: the same
//      buffer is input and output). Each thread reads its own limbs of out
//      before it stores their sum to the same addresses, so the in-place
//      update needs no synchronisation.
//   2  B2, replaces sda_tpu/ops/mxu8.py::_mxu8_kernel_chunked (:496): n_chunks
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
// Design:
//   * One block of 256 threads (8 warps) per tile of kT = 128 lanes; blocks
//     are independent (the TPU grid carried nothing across lane blocks
//     either; B2's chunk reduction stays inside the block).
//   * Stage-1 contraction on the int8 tensor cores with
//     mma.sync.m16n8k32.s32.s8.s8.s32. Each warp owns 16 lanes (two n8
//     tiles) and the MT m16 tiles of the n * L8 output rows before the
//     all-ones row of bigS (MT = 4 at 64 bits). K streams in tiles of kKT =
//     64 rows through a ring of kStages = 4 shared-memory stages
//     (sda_common.cuh, "cp.async ring"), three in flight while the MMA runs
//     on the fourth, with one block barrier per tile. A stage holds the raw
//     sec tile (64 rows x 128 lanes, lane-contiguous as in device memory,
//     16-byte cp.async.cg, zero-filled past K and past NBP) and its 64
//     columns of bigS's MT * 16 rows and ones row (16-byte copies from L2;
//     8 or 4 when K is not a multiple of 16). Each warp transposes its own
//     16 lanes of the landed raw tile into the K-contiguous sB rows that
//     mma.sync reads (4x4 byte transposes with __byte_perm, a __syncwarp, no
//     block barrier), so the 6 GB operand is never transposed in memory;
//     the same transposed words give the ones row's sums with dp4a, which
//     spares the MMA a fifth m16 tile at 64 bits.
//   * Randomness: Philox4x32-10 (sda_common.cuh), one stream per
//     (lane, participant draw, word group): key = (seed, 0), counter =
//     (global lane, draw, word group, 0); output word q of a call is PRNG
//     word 4 * group + q of that (lane, draw). Per word: accR += w,
//     accO += w >> 16, then accE = accR - (accO << 16), all uint32. The
//     biased bytes of accE / accO, in the (c, parity, w) row order of the
//     randomness-sum matrix, are the B operand of a second MMA pass against
//     bigR (its ones row again with dp4a). The draws run after the K loop:
//     spread over the loop instead (each tile making its share of them, the
//     sums in registers) they made every tile's iteration, barrier to
//     barrier, carry the generator's multiplies too, and the kernel was
//     slower on the H100 (PERF.md, the kernel's findings).
//   * Epilogue: the accumulator is spilled to shared memory (over the ring);
//     two threads per lane run the carry chains, the optional stage-2
//     contraction (88 x 25 at the headline, scalar), the fold, and the
//     limb-major output writes.
//
// Bounds on the H100 SXM. B1 at the headline (768 participants, 1,000,002
// dims, p = 2^63 - 871): sec is 18,432 x 333,824 int8 = 6.15 GB read once,
// about 1.84 ms at 3.35 TB/s; the contractions are 1.19e12 int8 operations,
// about 0.6 ms at 1,979 TOPS; the randomness is 5.13e8 Philox calls (768
// draws x 2 word groups per lane), about 0.7 ms of instruction issue at 128
// lanes a clock per SM, so bytes bound it. The kernel before the ring
// loaded each tile with plain loads, then a barrier, then the MMA, with
// nothing in flight during the MMA: 8.1 ms, while a copy probe through the
// same grid and tile (T2) streams at 2.98 TB/s. With the ring the K loop
// no longer waits on memory round trips; what holds it now (a timing
// breakdown on the card) is the loop's own work, one phase after another
// between the barriers: the MMA and its fragment loads, the copies, the
// transposes. B3 adds a read and a write of the running sums (43 MB at
// that shape) to B1's bytes. B2 reads every chunk once; at the 128-bit
// config-3 shape (2 x 512 participants, NBP 3,584) sec is 0.176 GB, so its
// bound is about 0.05 ms, but 3,584 lanes make only 28 blocks for 132 SMs,
// so the kernel is bound by too few blocks long before bytes; a split of K
// across blocks is later work.

#include <cstdint>
#include <type_traits>

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

constexpr int kStages = 4;  // ring depth: three tiles in flight beside the MMA

// Shared memory of one block (host and device agree through this struct):
//   [sCanon (B2 only)] [union]
//   union, in the K loop and the bigR pass: [ring: kStages stages of
//     (raw sec tile | bigS slice: MT * 16 rows, then the ones row)]
//     [sB: kT rows x sb bytes]
//   union, in the epilogue: [sAcc: spilled accumulator] [sB1: stage-2 bytes]
struct Layout {
  int sb;           // sB row stride (== 16 mod 32)
  int stage_bytes;  // one ring stage
  int canon_bytes;  // B2's canonical accumulator
  int spill_bytes;  // sAcc
  int smem;         // the whole block
  int vec_a;        // bigS copy width: 16, 8 or 4
  int vec_b;        // sec copy width: 16, 4 or 1
};

template <int MT>
Layout make_layout(const Params& p, const void* sec, const void* bigs) {
  Layout l;
  l.sb = (p.Kr_pad > kKT ? p.Kr_pad : kKT) + 16;
  l.stage_bytes = kRawBytes + (MT * 16 + 1) * kSA;
  l.canon_bytes = kMode == kChunked ? p.L * (p.n2 ? p.n2 : p.n) * kT * 4 : 0;
  l.spill_bytes = (p.n * p.L8 + 1) * kT * 4;
  const int loop_bytes = kStages * l.stage_bytes + kT * l.sb;
  const int epi_bytes = l.spill_bytes + (p.n2 ? p.rows2 * kT : 0);
  l.smem = l.canon_bytes + ((loop_bytes > epi_bytes ? loop_bytes : epi_bytes) + 15) / 16 * 16;
  const auto a = reinterpret_cast<uintptr_t>(bigs), s = reinterpret_cast<uintptr_t>(sec);
  l.vec_a = (p.K % 16 == 0 && a % 16 == 0) ? 16 : (p.K % 8 == 0 && a % 8 == 0) ? 8 : 4;
  l.vec_b = (p.nbp % 16 == 0 && s % 16 == 0) ? 16 : (p.nbp % 4 == 0 && s % 4 == 0) ? 4 : 1;
  return l;
}

// Start the copies of K tile tt (sec rows and bigS columns [tt * kKT, +kKT):
// bigS rows [0, MT * 16) and the ones row n * L8) into its ring stage.
template <int MT>
__device__ __forceinline__ void issue_tile(unsigned char* ring, const Layout& lay,
                                           const int8_t* sec, const int8_t* bigs, const Params& p,
                                           int tt, int lane0, int tid) {
  int8_t* raw = reinterpret_cast<int8_t*>(ring + (tt % kStages) * lay.stage_bytes);
  const int k0 = tt * kKT;
  if (lay.vec_b == 16)
    ring_load_raw<16>(raw, sec, p.K, p.nbp, k0, lane0, tid);
  else if (lay.vec_b == 4)
    ring_load_raw<4>(raw, sec, p.K, p.nbp, k0, lane0, tid);
  else
    ring_load_raw<1>(raw, sec, p.K, p.nbp, k0, lane0, tid);
  int8_t* sA = raw + kRawBytes;
  const int ones = p.n * p.L8;
  if (lay.vec_a == 16)
    ring_load_a<16>(sA, bigs, p.K, MT * 16, ones, k0, tid);
  else if (lay.vec_a == 8)
    ring_load_a<8>(sA, bigs, p.K, MT * 16, ones, k0, tid);
  else
    ring_load_a<4>(sA, bigs, p.K, MT * 16, ones, k0, tid);
}

template <int MT, int MODE>
__global__ void __launch_bounds__(kThreads)
mxu8_fused_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                  const int8_t* __restrict__ bigr, const int8_t* __restrict__ big2,
                  const uint32_t* __restrict__ tables, int32_t* __restrict__ out, Params p,
                  Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  // B2's canonical accumulator, kept across chunks; the union after it
  uint32_t* sCanon = reinterpret_cast<uint32_t*>(smem);
  unsigned char* un = smem + lay.canon_bytes;
  unsigned char* ring = un;
  int8_t* sB = reinterpret_cast<int8_t*>(un + kStages * lay.stage_bytes);
  int32_t* sAcc = reinterpret_cast<int32_t*>(un);
  uint8_t* sB1 = un + lay.spill_bytes;  // stage-1 bytes for stage 2
  const int sb = lay.sb;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lane0 = blockIdx.x * kT;
  const int ones_row = p.n * p.L8;  // the all-ones row of bigS and bigR, the last one used
  const int n_out = p.n2 ? p.n2 : p.n;
  const int nch = MODE == kChunked ? p.n_chunks : 1;
  const int T = (p.K + kKT - 1) / kKT;
  const int groups = (p.wpp + 3) / 4;

  for (int ch = 0; ch < nch; ++ch) {
    const int8_t* sec_c = MODE == kChunked ? sec + (size_t)ch * p.K * p.nbp : sec;
    const uint32_t seed_c = MODE == kChunked ? p.seed + (uint32_t)ch * p.seed_stride : p.seed;
    const bool first = ch == 0, last = ch == nch - 1;
    // the previous chunk's epilogue is done with the union
    if (!first) __syncthreads();

    int acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
    // the ones row's sums for lanes 16 warp + 4 (lane & 3) + x, over this
    // thread's k quads (dp4a in the transpose; the MMA covers rows < MT * 16)
    int ones[4] = {0, 0, 0, 0};

    // stage 1: bigS^T . sec through the ring
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < T) issue_tile<MT>(ring, lay, sec_c, bigs, p, s, lane0, tid);
      cp_async_commit();
    }
    for (int t = 0; t < T; ++t) {
      cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
      __syncthreads();               // ... every thread's, and tile t - 1's stage is free
      if (t + kStages - 1 < T) issue_tile<MT>(ring, lay, sec_c, bigs, p, t + kStages - 1, lane0, tid);
      cp_async_commit();
      const int8_t* raw = reinterpret_cast<const int8_t*>(ring + (t % kStages) * lay.stage_bytes);
      ring_transpose_b(sB, sb, raw, raw + kRawBytes + MT * 16 * kSA, ones, warp, lane);
      __syncwarp();
      mma_chunk<MT>(acc, raw + kRawBytes, sB, sb, 0, (min(kKT, p.K - t * kKT) + 31) / 32, warp,
                    lane);
    }
    cp_async_wait<0>();
    // every thread of a lane quad's column (lane & 3) holds part of its sums
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) ones[x] += __shfl_xor_sync(0xFFFFFFFFu, ones[x], m);

    // in-kernel randomness: u16-field sums over rp draws -> biased bytes
    int rand_ones = 0;
    if (p.Kr > 0) {
      __syncthreads();  // every warp is done with its sB rows
      for (int idx = tid; idx < kT * groups; idx += kThreads) {
        const int ll = idx % kT, g = idx / kT, gl = lane0 + ll;
        uint32_t accR[4] = {0, 0, 0, 0}, accO[4] = {0, 0, 0, 0};
        if (gl < p.nbp) {
          // one call per iteration: chip_smoke.py counts this loop's SASS
#pragma unroll 1
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
      int8_t* sA = reinterpret_cast<int8_t*>(ring + kRawBytes);  // stage 0's bigS slice
      for (int kc = 0; kc < p.Kr_pad; kc += kKT) {
        __syncthreads();
        load_a_tile(sA, bigr, p.Kr_pad, p.n_pad, MT * 16, kc, tid);
        __syncthreads();
        mma_chunk<MT>(acc, sA, sB, sb, kc, min(kKT, p.Kr_pad - kc) / 32, warp, lane);
      }
      // the ones row of bigR against lane tid's randomness bytes
      if (tid < kT) {
        const int* w1 = reinterpret_cast<const int*>(bigr + (size_t)ones_row * p.Kr_pad);
        const int* b = reinterpret_cast<const int*>(sB + tid * sb);
        for (int c = 0; c < p.Kr_pad / 4; ++c) rand_ones = __dp4a(b[c], w1[c], rand_ones);
      }
    }
    __syncthreads();  // the spill below overwrites the ring and sB

    // spill the accumulator: c0/c1 at row g, c2/c3 at row g + 8; the ones
    // row from the dp4a sums (and, in PRNG mode, bigR's part added after)
    {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = mt * 16 + g, col = warp * 16 + nt * 8 + 2 * t;
          if (r < ones_row) {
            sAcc[r * kT + col] = acc[mt][nt][0];
            sAcc[r * kT + col + 1] = acc[mt][nt][1];
          }
          if (r + 8 < ones_row) {
            sAcc[(r + 8) * kT + col] = acc[mt][nt][2];
            sAcc[(r + 8) * kT + col + 1] = acc[mt][nt][3];
          }
        }
      if (g == 0)
#pragma unroll
        for (int x = 0; x < 4; ++x) sAcc[ones_row * kT + warp * 16 + 4 * t + x] = ones[x];
    }
    __syncthreads();
    if (p.Kr > 0) {
      if (tid < kT) sAcc[ones_row * kT + tid] += rand_ones;
      __syncthreads();
    }
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
int set_smem(const Layout& lay) {
  return (int)cudaFuncSetAttribute(mxu8_fused_kernel<MT, kMode>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
}

template <int MT>
int launch(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, const int8_t* big2,
           const uint32_t* tables, int32_t* out, const Params& p, cudaStream_t stream) {
  const Layout lay = make_layout<MT>(p, sec, bigs);
  const int err = set_smem<MT>(lay);
  if (err) return err;
  const dim3 grid((p.nbp + kT - 1) / kT);
  mxu8_fused_kernel<MT, kMode><<<grid, kThreads, lay.smem, stream>>>(sec, bigs, bigr, big2, tables,
                                                                     out, p, lay);
  return (int)cudaGetLastError();
}

template <int MT>
int occupancy(const Params& p, int* smem_bytes, int* blocks_per_sm) {
  const Layout lay = make_layout<MT>(p, nullptr, nullptr);
  const int err = set_smem<MT>(lay);
  if (err) return err;
  *smem_bytes = lay.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mxu8_fused_kernel<MT, kMode>, kThreads, lay.smem);
}

// f(std::integral_constant<int, MT>) for the m16 tiles of output rows the
// MMA computes: the n * L8 rows before the ones row (the ones row itself,
// the last of at most 192, is summed with dp4a).
template <typename F>
int with_mt(const Params& p, F&& f) {
  if (p.n * p.L8 + 1 > 192) return (int)cudaErrorInvalidValue;
  switch ((p.n * p.L8 + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// iparams (kNParams ints of Params in field order) -> p; a cudaError_t.
int parse_params(const void* iparams, int n_iparams, Params& p) {
  if (n_iparams != kNParams) return (int)cudaErrorInvalidValue;
  const int* v = static_cast<const int*>(iparams);
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
      p.K < 4 || (p.K & 3) || (p.Kr_pad & 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// C entry point of the variant this library was built as (SDA_MXU8_MODE).
// iparams holds the kNParams ints of Params in field order (seed and
// seed_stride as their 32-bit patterns). For B3, out holds the running sums
// on entry. Returns a cudaError_t (0 on success).
extern "C" int sda_mxu8_fused(const void* sec, const void* bigs, const void* bigr,
                              const void* big2, const void* tables, void* out,
                              const void* iparams, int n_iparams, void* stream) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  const auto* s = static_cast<const int8_t*>(sec);
  const auto* a = static_cast<const int8_t*>(bigs);
  const auto* r = static_cast<const int8_t*>(bigr);
  const auto* b2 = static_cast<const int8_t*>(big2);
  const auto* tb = static_cast<const uint32_t*>(tables);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return with_mt(p, [&](auto mt) { return launch<decltype(mt)::value>(s, a, r, b2, tb, o, p, st); });
}

// The launch configuration sda_mxu8_fused would use for these parameters:
// dynamic shared memory per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int sda_mxu8_occupancy(const void* iparams, int n_iparams, int* smem_bytes,
                                  int* blocks_per_sm) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  return with_mt(p, [&](auto mt) {
    return occupancy<decltype(mt)::value>(p, smem_bytes, blocks_per_sm);
  });
}
