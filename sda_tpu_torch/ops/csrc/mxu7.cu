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
// Design, B1's (csrc/mxu8.cu; the ring and MMA helpers are shared through
// sda_common.cuh):
//   * One block of 256 threads (8 warps) per tile of kT = 128 lanes; blocks
//     are independent, and the PRNG mapping does not depend on the tiling.
//   * The contraction runs on the int8 tensor cores with
//     mma.sync.m16n8k32.s32.s8.s8.s32: each warp owns 16 lanes and all MT m16
//     tiles of accumulator rows (n * L7 <= 192). K streams in tiles of kKT =
//     64 rows through a ring of kStages = 4 shared-memory stages, three in
//     flight while the MMA runs on the fourth, with one block barrier per
//     tile. A stage holds the raw sec tile (64 rows x 128 lanes,
//     lane-contiguous as in device memory, 16-byte cp.async.cg, zero-filled
//     past K and past NBP; 4-byte or byte copies when NBP or the address is
//     not 16-aligned) and its 64 columns of bigS's MT * 16 rows. Each warp
//     transposes its own 16 lanes of the landed raw tile into the
//     K-contiguous sB rows that mma.sync reads (4x4 byte transposes with
//     __byte_perm, a __syncwarp, no block barrier). B6 has no ones row, so
//     the ring runs without mxu8's extra bigS row and dp4a sums.
//   * The randomness blocks follow the K loop: each is generated into sB
//     (rows kb wide, hence sB's stride max(kb, kKT) + 16) and contracted
//     against bigR's columns, whose tiles are copied with cp.async while
//     the generator runs (in rand-sum mode once per launch: every block
//     meets the same columns). The rand-sum generator splits each
//     carry-save group's participants between the two halves of the block,
//     so every thread makes the same number of Philox calls (5 x 64 per
//     group at the headline), and the halves' sums meet in shared memory.
//     The draws are not spread over the K loop: on B1 that made every
//     tile's iteration carry the generator's multiplies and measured slower
//     (PERF.md, the findings on B1).
//   * Epilogue: the accumulator is spilled to shared memory over the ring;
//     two threads per lane run the carry chains, the chunk fold, the
//     optional stage-2 contraction (n2 * L7 x n * L7 with dp4a, big2 and
//     the planes staged past the spill, its n2 * L7 columns split over both
//     threads of a lane) and the output writes, instantiated for L = 2, 4
//     and 8 so that the Montgomery helpers unroll and no per-lane array
//     leaves the registers.
//
// Bounds on the H100 SXM at the gen-3 headline (768 participants, 1,000,002
// dims, p = 2^63 - 871, PRNG, fused reconstruction): sec is 20,736 x 333,824
// int8 = 6.92 GB, read once: 2.07 ms at 3.35 TB/s; the contraction is
// 2 * 72 * 21,600 * 333,824 = 1.04e12 int8 operations, 0.53 ms at 1,979
// TOPS; the randomness is 768 participants x 5 Philox calls per lane, 1.28e9
// calls. chip_smoke.py counts the rand-sum generator loop's SASS
// instructions per call (one call per iteration; ptxas hoists the rounds'
// work on the counter words that do not change with the participant; the
// count includes the carry-save sums, which add whole words and mask only
// accO's) and sets them against 132 SMs x 128 issue lanes at the maximum
// clock: 53 per call, 2.03 ms, so the bytes bound the kernel by a little.
// On the card (PERF.md, the findings on B6) the K loop and the randomness
// passes take about 4 ms each and add up; the generator issues at about
// 0.6 of that rate.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "sda_common.cuh"

namespace {

using namespace sda;  // Philox, limb arithmetic, the int8 MMA pipeline (kT, kThreads, kKT, kSA)

constexpr int kMaxLimbs = 32;  // 7-bit limbs of one carry chain (L7 + 4)
constexpr int kNParams = 24;
constexpr uint32_t kTag = 6u;  // fourth Philox counter word of this kernel
constexpr uint32_t kMask2 = 127u | (127u << 14);
static_assert(kThreads == 2 * kT, "rand_block splits the block into two halves of kT threads");

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
//
// The epilogue's functions take the 16-bit lane count L (2, 4 or 8, what
// LimbContext chooses) as a constant: the Montgomery helpers of
// sda_common.cuh then unroll and every per-lane array stays in registers;
// values move between 7-bit limbs and 16-bit lanes through one 128-bit
// integer, so no array is indexed at run time.

using u128 = unsigned __int128;

// Lanes [0, L) of v: bits [16 w, 16 w + 16).
__device__ __forceinline__ void lanes_of(u128 v, uint32_t* lanes, int L) {
#pragma unroll
  for (int w = 0; w < kMaxL; ++w)
    if (w < L) lanes[w] = (uint32_t)(v >> (16 * w)) & 0xFFFFu;
}

// The value held in the L 16-bit lanes of res.
__device__ __forceinline__ u128 value_of(const uint32_t* res, int L) {
  u128 v = 0;
#pragma unroll
  for (int w = 0; w < kMaxL; ++w)
    if (w < L) v |= (u128)res[w] << (16 * w);
  return v;
}

// L7 non-negative accumulator columns col[c * kT] (weights 2^(7c)) ->
// canonical L lanes: carry to 7-bit limbs (the residual carry is below
// 2^25: four more limbs), gather each chunk of `chunk` limbs (bits beyond
// 16 L dropped), fold chunk t with one Montgomery multiply by
// 2^(7*chunk*t) * R mod p, add the terms mod p.
template <int L>
__device__ __forceinline__ void reduce_cols(const int32_t* col, const Params& p,
                                            const uint32_t* consts, const uint32_t* pl,
                                            uint32_t (&res)[kMaxL]) {
  const int nl = p.L7 + 4;
  u128 v = 0;
  uint32_t carry = 0;
  int j = 0, t = 0;
  for (int c = 0; c < nl; ++c) {
    uint32_t b;
    if (c < p.L7) {
      const uint32_t s = (uint32_t)col[c * kT] + carry;
      b = s & 127u;
      carry = s >> 7;
    } else {
      b = carry & 127u;
      carry >>= 7;
    }
    v |= (u128)b << (7 * j);
    if (++j == p.chunk || c == nl - 1) {
      uint32_t lanes16[kMaxL];
      lanes_of(v, lanes16, L);
      if (t == 0) {
        mont_mul(lanes16, consts, res, pl, (uint32_t)p.p_inv_w, L);
      } else {
        uint32_t term[kMaxL];
        mont_mul(lanes16, consts + t * L, term, pl, (uint32_t)p.p_inv_w, L);
        add_mod(res, term, pl, L);
      }
      ++t;
      j = 0;
      v = 0;
    }
  }
}

// Bits [7 * l7, 7 * l7 + 7) of a canonical value (zero past its 128 bits).
__device__ __forceinline__ uint32_t plane7(u128 v, int l7) {
  return 7 * l7 < 128 ? (uint32_t)(v >> (7 * l7)) & 127u : 0u;
}

template <int L>
__device__ __forceinline__ void store(const uint32_t (&res)[kMaxL], const Params& p, void* out,
                                      int i, int gl) {
  if (p.out7) {
    int8_t* o = static_cast<int8_t*>(out);
    const u128 v = value_of(res, L);
    for (int l7 = 0; l7 < p.L7; ++l7) o[(size_t)(i * p.L7 + l7) * p.nbp + gl] = (int8_t)plane7(v, l7);
  } else {
    int32_t* o = static_cast<int32_t*>(out);
#pragma unroll
    for (int l = 0; l < kMaxL; ++l)
      if (l < L) o[(size_t)(i * L + l) * p.nbp + gl] = (int32_t)res[l];
  }
}

// The epilogue of one block, two threads per lane, after the accumulator's
// spill: the stage-1 chains and folds of the n clerks' rows; with fused
// reconstruction, their limb-major 7-bit planes (sC7: plane q of lane ll is
// byte q % 4 of word (q / 4) * kT + ll) and big2 staged in shared memory
// (sBig2: rows of q4 words, zero past n * L7), then the n2 * L7 stage-2
// columns, four planes per dp4a, split over both threads of a lane and
// written over sAcc once every thread has read its stage-1 rows, and their
// chains and folds.
template <int L>
__device__ void epilogue(const Params& p, int32_t* sAcc, uint8_t* sC7, const int8_t* big2,
                         const uint32_t* tables, void* out, int lane0, int tid) {
  const int ll = tid % kT, half = tid / kT, gl = lane0 + ll;
  const uint32_t* consts = tables + p.off_consts;
  const uint32_t* pl = tables + p.off_p;
  const int rows2 = p.n * p.L7, q4 = (rows2 + 3) / 4;
  int8_t* sBig2 = reinterpret_cast<int8_t*>(sC7 + 4 * q4 * kT);
  if (p.n2)
    for (int idx = tid; idx < p.n2 * p.L7 * 4 * q4; idx += kThreads) {
      const int r = idx / (4 * q4), q = idx % (4 * q4);
      sBig2[idx] = q < rows2 ? big2[(size_t)r * rows2 + q] : (int8_t)0;
    }
  uint32_t res[kMaxL];
  for (int i = half; i < p.n; i += kThreads / kT) {
    reduce_cols<L>(sAcc + i * p.L7 * kT + ll, p, consts, pl, res);
    if (p.n2) {
      const u128 v = value_of(res, L);
      for (int l1 = 0; l1 < p.L7; ++l1) {
        const int q = l1 * p.n + i;
        sC7[((q >> 2) * kT + ll) * 4 + (q & 3)] = (uint8_t)plane7(v, l1);
      }
    } else if (gl < p.nbp) {
      store<L>(res, p, out, i, gl);
    }
  }
  if (!p.n2) return;
  __syncthreads();  // sC7 and sBig2 are complete, and sAcc's stage-1 rows are read
  const uint32_t* sC7w = reinterpret_cast<const uint32_t*>(sC7) + ll;
  for (int idx = half; idx < p.n2 * p.L7; idx += kThreads / kT) {
    const int* row = reinterpret_cast<const int*>(sBig2) + idx * q4;
    int a = 0;
    for (int w = 0; w < q4; ++w) a = __dp4a(row[w], (int)sC7w[w * kT], a);
    sAcc[idx * kT + ll] = a;
  }
  __syncthreads();
  for (int i2 = half; i2 < p.n2; i2 += kThreads / kT) {
    reduce_cols<L>(sAcc + i2 * p.L7 * kT + ll, p, consts, pl, res);
    if (gl < p.nbp) store<L>(res, p, out, i2, gl);
  }
}

// Randomness block blk, written transposed into sB ([lane][row], stride sb):
// rows [0, kb), zero past the block's used rows. Rand-sum mode splits the
// carry-save group's participants between the two halves of the block:
// thread (h, ll) sums half h's draws of lane ll, one word group q at a
// time, so every thread makes G * ceil(gsize / 2) Philox calls. The halves'
// packed sums meet in exch ([q % 2][h][accE 0-3, accO 0-3][kT] u32: two
// buffers, one barrier per word group), and thread (h, ll) adds those of
// words 4q + 2h and 4q + 2h + 1 of lane ll, which stay carry-free (each
// 14-bit field at most gsize * 127 < 2^14), and re-splits them into sB.
__device__ void rand_block(int8_t* sB, int sb, uint32_t* exch, const Params& p, int blk, int lane0,
                           int tid) {
  const int G = (p.wpp + 3) / 4;  // Philox calls per (lane, participant)
  int used;
  if (p.mode == 1) {
    used = 8 * p.wpp;
    const int ll = tid % kT, h = tid / kT, gl = lane0 + ll;
    const int gh = (p.gsize + 1) / 2;
    const int j0 = blk * p.gsize + h * gh, j1 = blk * p.gsize + min(p.gsize, (h + 1) * gh);
    int8_t* row = sB + ll * sb;
    for (int q = 0; q < G; ++q) {
      // accT sums whole words: its bits [0, 28) are accE + (accO << 7) mod
      // 2^28, since a word's limbs 0/2 and 1/3 fill disjoint bits and its
      // top nibble adds multiples of 2^28; accE < 2^28
      uint32_t accT[4] = {0, 0, 0, 0}, accO[4] = {0, 0, 0, 0};
      if (gl < p.nbp) {
        // one call per iteration: chip_smoke.py counts this loop's SASS
#pragma unroll 1
        for (int j = j0; j < j1; ++j) {
          uint32_t c[4] = {(uint32_t)gl, (uint32_t)j, (uint32_t)q, kTag};
          philox4x32_10(c, p.seed, 0u);
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            accT[w4] += c[w4];
            accO[w4] += (c[w4] >> 7) & kMask2;
          }
        }
      }
      uint32_t* buf = exch + (q & 1) * 16 * kT + ll;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        buf[(8 * h + w4) * kT] = (accT[w4] - (accO[w4] << 7)) & 0x0FFFFFFFu;
        buf[(8 * h + 4 + w4) * kT] = accO[w4];
      }
      __syncthreads();  // both halves' sums of word group q are in buf
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int w4 = 2 * h + x, w = 4 * q + w4;
        if (w >= p.wpp) continue;
        const uint32_t accE = buf[w4 * kT] + buf[(8 + w4) * kT];
        const uint32_t accO = buf[(4 + w4) * kT] + buf[(12 + w4) * kT];
        const uint32_t s[4] = {accE & 0x3FFFu, accO & 0x3FFFu, accE >> 14, accO >> 14};
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

constexpr int kStages = 4;  // ring depth: three tiles in flight beside the MMA

// Shared memory of one block (host and device agree through this struct):
//   in the K loop: [ring: kStages stages of (raw sec tile | bigS slice:
//     MT * 16 rows)] [sB: kT rows x sb bytes]
//   in the randomness passes, over the ring: [exch: the rand-sum halves'
//     sums] [bigR's tiles for one block's kb columns: r_tiles slices like a
//     stage's bigS slice] [sB]
//   in the epilogue: [sAcc: spilled accumulator] [sC7: stage-2 planes]
//     [sBig2: big2, rows padded to whole words]
struct Layout {
  int sb;           // sB row stride (== 16 mod 32; the randomness blocks are kb wide)
  int stage_bytes;  // one ring stage
  int ring_bytes;   // the ring, or the randomness passes' buffers where those are larger
  int r_tile;       // one of bigR's tiles: MT * 16 rows x kSA bytes
  int r_tiles;      // bigR's tiles per randomness block
  int r_off;        // where bigR's tiles start
  int spill_bytes;  // sAcc
  int smem;         // the whole block
  int vec_a;        // bigS copy width: 16, 8 or 4
  int vec_b;        // sec copy width: 16, 4 or 1
  int vec_r;        // bigR copy width: 16, 8 or 4
};

template <int MT>
Layout make_layout(const Params& p, const void* sec, const void* bigs, const void* bigr) {
  Layout l;
  l.sb = (p.kb > kKT ? p.kb : kKT) + 16;
  l.stage_bytes = kRawBytes + MT * 16 * kSA;
  l.spill_bytes = (p.n > p.n2 ? p.n : p.n2) * p.L7 * kT * (int)sizeof(int32_t);
  l.r_off = p.mode == 1 ? 2 * 2 * 8 * kT * (int)sizeof(uint32_t) : 0;  // exch
  l.r_tile = MT * 16 * kSA;
  l.r_tiles = p.mode ? (p.kb + kKT - 1) / kKT : 0;
  const int ring = kStages * l.stage_bytes, passes = l.r_off + l.r_tiles * l.r_tile;
  l.ring_bytes = ring > passes ? ring : passes;
  const int loop_bytes = l.ring_bytes + kT * l.sb;
  const int q4 = (p.n * p.L7 + 3) / 4;  // words of one lane's stage-2 planes
  const int epi_bytes = l.spill_bytes + (p.n2 ? 4 * q4 * (kT + p.n2 * p.L7) : 0);
  l.smem = ((loop_bytes > epi_bytes ? loop_bytes : epi_bytes) + 15) / 16 * 16;
  const auto a = reinterpret_cast<uintptr_t>(bigs), s = reinterpret_cast<uintptr_t>(sec),
             r = reinterpret_cast<uintptr_t>(bigr);
  l.vec_a = (p.lda % 16 == 0 && a % 16 == 0) ? 16 : (p.lda % 8 == 0 && a % 8 == 0) ? 8 : 4;
  l.vec_b = (p.nbp % 16 == 0 && s % 16 == 0) ? 16 : (p.nbp % 4 == 0 && s % 4 == 0) ? 4 : 1;
  l.vec_r = (p.bigr_cols % 16 == 0 && r % 16 == 0) ? 16 : (p.bigr_cols % 8 == 0 && r % 8 == 0) ? 8 : 4;
  return l;
}

// Start the copies of bigR's tiles for columns [c0, c0 + kb): rows [0, MT *
// 16) of r_tiles slices of kKT columns.
template <int MT>
__device__ __forceinline__ void issue_bigr(int8_t* sR, const Layout& lay, const int8_t* bigr,
                                           const Params& p, int c0, int tid) {
  for (int tt = 0; tt < lay.r_tiles; ++tt) {
    int8_t* dst = sR + tt * lay.r_tile;
    const int col = c0 + tt * kKT;
    if (lay.vec_r == 16)
      ring_load_a<16, false>(dst, bigr, p.bigr_cols, MT * 16, 0, col, tid);
    else if (lay.vec_r == 8)
      ring_load_a<8, false>(dst, bigr, p.bigr_cols, MT * 16, 0, col, tid);
    else
      ring_load_a<4, false>(dst, bigr, p.bigr_cols, MT * 16, 0, col, tid);
  }
}

// Start the copies of K tile tt (sec rows and bigS columns [tt * kKT, +kKT),
// bigS rows [0, MT * 16)) into its ring stage.
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
  if (lay.vec_a == 16)
    ring_load_a<16, false>(sA, bigs, p.lda, MT * 16, 0, k0, tid);
  else if (lay.vec_a == 8)
    ring_load_a<8, false>(sA, bigs, p.lda, MT * 16, 0, k0, tid);
  else
    ring_load_a<4, false>(sA, bigs, p.lda, MT * 16, 0, k0, tid);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
mxu7_fused_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                  const int8_t* __restrict__ bigr, const int8_t* __restrict__ big2,
                  const uint32_t* __restrict__ tables, void* __restrict__ out, Params p,
                  Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int8_t* sB = reinterpret_cast<int8_t*>(smem + lay.ring_bytes);
  uint32_t* exch = reinterpret_cast<uint32_t*>(smem);        // rand-sum halves' sums
  int8_t* sR = reinterpret_cast<int8_t*>(smem + lay.r_off);  // bigR's tiles
  int32_t* sAcc = reinterpret_cast<int32_t*>(smem);          // over the ring, after the MMAs
  uint8_t* sC7 = smem + lay.spill_bytes;                     // stage-2 planes, then big2
  const int sb = lay.sb;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lane0 = blockIdx.x * kT;
  const int rows_used = p.n * p.L7;
  const int T = (p.K + kKT - 1) / kKT;

  int acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  // stage 1: bigS^T . sec through the ring
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) issue_tile<MT>(ring, lay, sec, bigs, p, s, lane0, tid);
    cp_async_commit();
  }
  int no_ones[4];  // B6 has no ones row: ring_transpose_b<false> does not touch it
  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... every thread's, and tile t - 1's stage is free
    if (t + kStages - 1 < T) issue_tile<MT>(ring, lay, sec, bigs, p, t + kStages - 1, lane0, tid);
    cp_async_commit();
    const int8_t* raw = reinterpret_cast<const int8_t*>(ring + (t % kStages) * lay.stage_bytes);
    ring_transpose_b<false>(sB, sb, raw, nullptr, no_ones, warp, lane);
    __syncwarp();
    mma_chunk<MT>(acc, raw + kRawBytes, sB, sb, 0, (min(kKT, p.K - t * kKT) + 31) / 32, warp,
                  lane);
  }
  cp_async_wait<0>();

  // in-kernel randomness: each block generated into sB, then bigR^T . block
  // against bigR's tiles, copied while the generator runs (in rand-sum mode
  // once: every block meets the same columns)
  for (int blk = 0; blk < p.n_blocks; ++blk) {
    __syncthreads();  // every warp is done with sB and bigR's tiles
    if (p.mode == 2 || blk == 0) issue_bigr<MT>(sR, lay, bigr, p, p.mode == 2 ? blk * p.kb : 0, tid);
    cp_async_commit();
    rand_block(sB, sb, exch, p, blk, lane0, tid);
    cp_async_wait<0>();
    __syncthreads();  // bigR's tiles and the block in sB are complete
    for (int kc = 0; kc < p.kb; kc += kKT)
      mma_chunk<MT>(acc, sR + kc / kKT * lay.r_tile, sB, sb, kc, min(kKT, p.kb - kc) / 32, warp,
                    lane);
  }
  __syncthreads();  // every warp is done with the ring and sB before the spill

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

  if (p.L == 2)
    epilogue<2>(p, sAcc, sC7, big2, tables, out, lane0, tid);
  else if (p.L == 4)
    epilogue<4>(p, sAcc, sC7, big2, tables, out, lane0, tid);
  else
    epilogue<8>(p, sAcc, sC7, big2, tables, out, lane0, tid);
}

template <int MT>
int set_smem(const Layout& lay) {
  return (int)cudaFuncSetAttribute(mxu7_fused_kernel<MT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
}

template <int MT>
int launch(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, const int8_t* big2,
           const uint32_t* tables, void* out, const Params& p, cudaStream_t stream) {
  const Layout lay = make_layout<MT>(p, sec, bigs, bigr);
  const int err = set_smem<MT>(lay);
  if (err) return err;
  const dim3 grid((p.nbp + kT - 1) / kT);
  mxu7_fused_kernel<MT><<<grid, kThreads, lay.smem, stream>>>(sec, bigs, bigr, big2, tables, out,
                                                              p, lay);
  return (int)cudaGetLastError();
}

template <int MT>
int occupancy(const Params& p, int* smem_bytes, int* blocks_per_sm) {
  const Layout lay = make_layout<MT>(p, nullptr, nullptr, nullptr);
  const int err = set_smem<MT>(lay);
  if (err) return err;
  *smem_bytes = lay.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, mxu7_fused_kernel<MT>,
                                                            kThreads, lay.smem);
}

// f(std::integral_constant<int, MT>) for the m16 tiles of the n * L7
// accumulator rows (at most 192).
template <typename F>
int with_mt(const Params& p, F&& f) {
  switch ((p.n * p.L7 + 15) / 16) {
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
  if ((p.L != 2 && p.L != 4 && p.L != 8) || p.L7 + 4 > kMaxLimbs || (p.lda & 31) || (p.bigr_cols & 31) ||
      (p.kb & 31) || p.mode < 0 || p.mode > 2 || (p.mode && p.n_blocks < 1) ||
      (p.n2 && p.out7) || p.chunk < 1 || 7 * p.chunk > 128 || p.n_consts * p.chunk < p.L7 + 4)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// C entry point. iparams holds the kNParams ints of Params in field order
// (seed as its 32-bit pattern). out is int32 [n_out, L, NBP], or int8
// [n_out, L7, NBP] with out7. Returns a cudaError_t (0 on success).
extern "C" int sda_mxu7_fused(const void* sec, const void* bigs, const void* bigr,
                              const void* big2, const void* tables, void* out, int n_iparams,
                              const void* iparams, void* stream) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  const auto* s = static_cast<const int8_t*>(sec);
  const auto* a = static_cast<const int8_t*>(bigs);
  const auto* r = static_cast<const int8_t*>(bigr);
  const auto* b2 = static_cast<const int8_t*>(big2);
  const auto* tb = static_cast<const uint32_t*>(tables);
  auto st = static_cast<cudaStream_t>(stream);
  return with_mt(p, [&](auto mt) { return launch<decltype(mt)::value>(s, a, r, b2, tb, out, p, st); });
}

// The launch configuration sda_mxu7_fused would use for these parameters:
// dynamic shared memory per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int sda_mxu7_occupancy(const void* iparams, int n_iparams, int* smem_bytes,
                                  int* blocks_per_sm) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  return with_mt(p, [&](auto mt) {
    return occupancy<decltype(mt)::value>(p, smem_bytes, blocks_per_sm);
  });
}
