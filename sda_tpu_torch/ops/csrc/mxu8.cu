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
//      stacked participant chunks reduced in ONE call. The TPU walked the
//      chunks as a sequential grid axis with a VMEM accumulator. Here the
//      K work of each 128-lane block is split across blocks ("split K",
//      below), and one call runs a memset and two kernels:
//        mxu8_split_kernel     grid lane_blocks x S: block (lane block b,
//                              split s) runs B1's ring K loop over its
//                              range of (chunk, K tile) and its range of
//                              (chunk, randomness draw), and adds its int32
//                              partial sums into a zeroed workspace;
//        mxu8_epilogue_kernel  one block per lane block: per chunk, the
//                              draw sums' bytes against bigR, the carry
//                              chains, stage 2 and the fold; the chunks'
//                              canonical limbs add mod p in shared memory
//                              and out is written once, after the last.
//                              bigR and big2 stay resident when they
//                              fit, else stream through two one-tile
//                              slots, so its shared memory need not grow
//                              with their columns.
//      Chunk c draws its randomness with key seed + c * seed_stride.
//   3  B1 and B3 for wide plans (more than the 192 output rows n * L8 + 1
//      that one block's MT tiles hold; combine-only, one chunk): the output
//      rows are tiled over the grid (mxu8_wide_kernel, below), and in PRNG
//      mode the randomness operand is drawn once per launch by
//      mxu8_wide_rand_kernel. No other mode's code changes with it.
//
// Split K (B2). A lane block's work is the list of n_chunks * ceil(K / 64)
// (chunk, tile) pairs; split s of S takes pairs [s * total / S, (s + 1) *
// total / S), cut where a chunk ends (each chunk has its own rows and
// seed), and likewise its share of the n_chunks * rp (chunk, draw) pairs.
// The caller chooses S (ops/mxu8.py, chunked_splits: as many as fill the
// card's block slots in one wave). The workspace is int32 [n_chunks][n * L8
// + 1 + 2 * wpp][nbp rounded up to 4]: the stage-1 rows, the ones row, then
// the draws' u32 sums accR and accO per PRNG word. Each block adds its partials
// with red.global.add (atomicAdd, result unused), from a shared-memory copy
// of its accumulator so that a warp's adds hit 32 consecutive words. This
// is exact: stage 1 accumulates int32 with wrap-around (mma.sync .s32, no
// .satfinite), the draw sums are u32 with wrap-around, and addition mod
// 2^32 is associative and commutative, so any split and any order of the
// partial sums gives the same 32-bit words as one block's loop over all of
// K and all draws (and the per-chunk carry-chain bound keeps the true
// column values below 2^32 anyway). The draws' byte extraction (accE = accR
// - (accO << 16)) is not linear, so it runs only where the sums meet, in
// the epilogue kernel, and so does bigR's pass. Per-chunk sums stay per
// chunk: chunk c's partials go to workspace slab c, and the chunks meet only
// as canonical limbs, added mod p.
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
//   * One block of 256 threads (8 warps) per tile of kT = 128 lanes (B1,
//     B3; B2's epilogue kernel), or per (tile, split) (B2's split kernel);
//     lane blocks are independent (the TPU grid carried nothing across them
//     either).
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
//     contraction (88 x 25 at the headline, scalar; in B2's epilogue kernel
//     on the tensor cores, n outputs a pass, since its 28 blocks at config 3
//     made the scalar loop as long as the whole K loop), the fold, and the
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
// bound is about 0.05 ms. Its 3,584 lanes make only 28 lane blocks for 132
// SMs; one block per lane block held it to ~0.1 TB/s, so B2 splits each
// lane block's K work S ways (S = 9 at 2 blocks per SM: 252 blocks). Its
// workspace (4.6 MB there) stays in the 50 MB L2.

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
constexpr int kWide = 3;     // B1 and B3 on wide plans
#ifndef SDA_MXU8_MODE
#define SDA_MXU8_MODE 0
#endif
constexpr int kMode = SDA_MXU8_MODE;
static_assert(kMode == kPlain || kMode == kAcc || kMode == kChunked || kMode == kWide,
              "SDA_MXU8_MODE is 0, 1, 2 or 3");

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
// out holds (sCanon, first and last unused); B2's epilogue kernel adds them
// mod p into the shared-memory accumulator sCanon ([L][n_out][kT]) and
// stores the sum only for the last chunk. Each (i, ll) belongs to one
// thread for the whole launch, so neither the accumulator nor out needs a
// barrier between its read and its write.
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
//   B1, B3: a union of
//     in the K loop and the bigR pass: [ring: kStages stages of (raw sec
//     tile | bigS slice: MT * 16 rows, then the ones row)] [sB: kT rows x
//     sb bytes]
//     in the epilogue: [sAcc: spilled accumulator] [sB1: stage-2 bytes]
//   B2's split kernel: [ring] [sB: one K tile a row], then sAcc over them
//     for the partials' adds
//   B2's epilogue kernel: [sCanon: the chunks' canonical sum] [big2's ones
//     row], then bigR and big2 resident or streamed (epilogue_smem)
struct Layout {
  int sb;           // sB row stride (== 16 mod 32)
  int stage_bytes;  // one ring stage
  int canon_bytes;  // bytes before the union: sCanon (B2's epilogue kernel), else 0
  int spill_bytes;  // sAcc
  int smem;         // the whole block
  int vec_a;        // bigS copy width: 16, 8 or 4
  int vec_b;        // sec copy width: 16, 4 or 1
};

__host__ __device__ __forceinline__ int max_of(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }

// Rows of one chunk's slab of B2's workspace: the stage-1 rows, the ones
// row, then (PRNG mode) the draws' sums accR and accO of each PRNG word.
__host__ __device__ __forceinline__ int ws_rows(const Params& p) {
  return p.n * p.L8 + 1 + (p.Kr > 0 ? 2 * p.wpp : 0);
}

// The workspace's row pitch in lanes: nbp rounded up to 4, so that the
// epilogue kernel reads a row's lanes 16 bytes at a time.
__host__ __device__ __forceinline__ int ws_pitch(const Params& p) { return (p.nbp + 3) & ~3; }

template <int MT>
Layout make_layout(const Params& p, const void* sec, const void* bigs) {
  Layout l;
  l.sb = max_of(p.Kr_pad, kKT) + 16;
  l.stage_bytes = kRawBytes + (MT * 16 + 1) * kSA;
  l.canon_bytes = 0;
  l.spill_bytes = (p.n * p.L8 + 1) * kT * 4;
  const int loop_bytes = kStages * l.stage_bytes + kT * l.sb;
  const int epi_bytes = l.spill_bytes + (p.n2 ? p.rows2 * kT : 0);
  l.smem = round16(max_of(loop_bytes, epi_bytes));
  const auto a = reinterpret_cast<uintptr_t>(bigs), s = reinterpret_cast<uintptr_t>(sec);
  l.vec_a = (p.K % 16 == 0 && a % 16 == 0) ? 16 : (p.K % 8 == 0 && a % 8 == 0) ? 8 : 4;
  l.vec_b = (p.nbp % 16 == 0 && s % 16 == 0) ? 16 : (p.nbp % 4 == 0 && s % 4 == 0) ? 4 : 1;
  return l;
}

template <int MT>
Layout split_layout(const Params& p, const void* sec, const void* bigs) {
  Layout l = make_layout<MT>(p, sec, bigs);
  l.sb = kKT + 16;  // the randomness bytes go to the epilogue kernel
  l.smem = round16(max_of(kStages * l.stage_bytes + kT * l.sb, l.spill_bytes));
  return l;
}

// Row stride of B2's stage-2 operand in shared memory: rows2 bytes rounded
// up to the MMA's k32 steps, == 16 mod 32.
__host__ __device__ __forceinline__ int stage2_stride(const Params& p) {
  return (p.rows2 + 31) / 32 * 32 + 16;
}

// One slot of B2's epilogue kernel: a tile of MT * 16 rows x kKT columns
// of bigR or big2 (row stride kSA), the layout mma_chunk reads.
template <int MT>
__host__ __device__ __forceinline__ int slot_bytes() {
  return MT * 16 * kSA;
}

// Bytes of big2's ones row in B2's epilogue kernel: rows2 rounded up,
// zero past rows2, so that dp4a reads it a word at a time.
__host__ __device__ __forceinline__ int ones2_bytes(const Params& p) {
  return p.n2 ? round16(p.rows2) : 0;
}

// K tiles of bigR (PRNG mode) and of big2 (reconstruction).
__host__ __device__ __forceinline__ int tiles_r(const Params& p) {
  return p.Kr ? (p.Kr_pad + kKT - 1) / kKT : 0;
}
__host__ __device__ __forceinline__ int tiles_2(const Params& p) {
  return p.n2 ? (p.rows2 + kKT - 1) / kKT : 0;
}

// sAcc of B2's epilogue kernel: the spilled accumulator, or, streaming,
// the two slots of big2 tiles while stage 2's MMA runs.
template <int MT>
__host__ __device__ __forceinline__ int epilogue_acc_bytes(const Params& p, bool resident) {
  return round16(max_of((p.n * p.L8 + 1) * kT * 4, resident ? 0 : 2 * slot_bytes<MT>()));
}

constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory of one block on the H100

// B2's epilogue kernel: [sCanon] [big2's ones row] then, resident, [every
// tile of bigR and big2, staged once] [a union of (sB: the randomness
// bytes) and (sAcc | sB2: the stage-1 bytes, a row per lane)]; streaming,
// [a union of (sB | two slots of bigR tiles) and (sAcc, whose first bytes
// are two slots of big2 tiles during stage 2's MMA | sB2)]. Streaming, it
// is the single-kernel B2's layout (sCanon, then B1's) less its ring, plus
// at most 6,448 B of stage-2 padding and the ones row: every plan with n2
// <= n (L8 even) that the single kernel ran fits.
template <int MT>
__host__ __device__ __forceinline__ int epilogue_smem(const Params& p, bool resident) {
  const int sb = max_of(p.Kr_pad, kKT) + 16;
  const int slots = resident ? 0 : 2 * slot_bytes<MT>();
  const int rand_bytes = p.Kr ? kT * sb + slots : 0;
  const int epi_bytes = epilogue_acc_bytes<MT>(p, resident) + (p.n2 ? kT * stage2_stride(p) : 0);
  return p.L * (p.n2 ? p.n2 : p.n) * kT * 4 + ones2_bytes(p) +
         (resident ? (tiles_r(p) + tiles_2(p)) * slot_bytes<MT>() : 0) +
         round16(max_of(rand_bytes, epi_bytes));
}

// Whether B2's epilogue kernel keeps bigR and big2 resident: when they fit
// and stage 2 is one pass (n2 <= n, so its n2 * L8 rows fit the MT tiles).
// Else they stream from L2 each pass, and stage 2 takes n outputs a pass.
template <int MT>
__host__ __device__ __forceinline__ bool epilogue_resident(const Params& p) {
  return p.n2 <= p.n && epilogue_smem<MT>(p, true) <= kMaxSmem;
}

// Resident big2 rows staged: the n2 * L8 output rows, and its ones row
// after them when that still lies inside the MT tiles (the MMA then sums
// it; else dp4a does, from big2's ones row in shared memory).
template <int MT>
__host__ __device__ __forceinline__ int resident_rows2(const Params& p) {
  return p.n2 * p.L8 + (p.n2 * p.L8 < MT * 16 ? 1 : 0);
}

template <int MT>
Layout epilogue_layout(const Params& p) {
  Layout l = make_layout<MT>(p, nullptr, nullptr);
  l.canon_bytes = p.L * (p.n2 ? p.n2 : p.n) * kT * 4;  // L limbs of n_out results a lane
  l.smem = epilogue_smem<MT>(p, epilogue_resident<MT>(p));
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

// Stage 1 over K tiles [t_begin, t_end) of one chunk through the ring: acc
// += bigS^T . sec, and ones[x] += the ones row's sums for lanes 16 warp +
// 4 (lane & 3) + x (dp4a in the transpose; the MMA covers rows < MT * 16).
// Every thread of a lane quad's column holds part of those sums. Ends with
// no copy in flight; the caller syncs before the ring is reused.
template <int MT>
__device__ __forceinline__ void k_loop(int (&acc)[MT][2][4], int (&ones)[4], unsigned char* ring,
                                       int8_t* sB, const Layout& lay, const int8_t* sec,
                                       const int8_t* bigs, const Params& p, int t_begin,
                                       int t_end, int lane0, int tid, int warp, int lane) {
  for (int s = 0; s < kStages - 1; ++s) {
    if (t_begin + s < t_end) issue_tile<MT>(ring, lay, sec, bigs, p, t_begin + s, lane0, tid);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... every thread's, and tile t - 1's stage is free
    if (t + kStages - 1 < t_end)
      issue_tile<MT>(ring, lay, sec, bigs, p, t + kStages - 1, lane0, tid);
    cp_async_commit();
    const int8_t* raw = reinterpret_cast<const int8_t*>(ring + (t % kStages) * lay.stage_bytes);
    ring_transpose_b(sB, lay.sb, raw, raw + kRawBytes + MT * 16 * kSA, ones, warp, lane);
    __syncwarp();
    mma_chunk<MT>(acc, raw + kRawBytes, sB, lay.sb, 0, (min(kKT, p.K - t * kKT) + 31) / 32, warp,
                  lane);
  }
  cp_async_wait<0>();
}

// Rows [0, ones_row) of the accumulator fragments into sAcc ([rows][kT]):
// c0/c1 at row g, c2/c3 at row g + 8 of each m16 tile.
template <int MT>
__device__ __forceinline__ void spill_acc(int32_t* sAcc, const int (&acc)[MT][2][4], int ones_row,
                                          int warp, int lane) {
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
}

// Start the copy of rows [0, min(nrows, MT * 16)) x columns [kc, kc +
// kKT) of a row-major int8 matrix with lda columns into the slot dst (row
// stride kSA; zero past lda; the rows past nrows are not written, and the
// MMA rows they make are not read). cp.async of 16, 8 or 4 bytes as the
// stride and address allow, else byte loads, eight in flight a thread.
template <int MT>
__device__ __forceinline__ void stage_tile(int8_t* dst, const int8_t* A, int lda, int nrows,
                                           int kc, int tid) {
  const int rows = min(nrows, MT * 16);
  const auto a = reinterpret_cast<uintptr_t>(A);
  const int vec = (lda % 16 == 0 && a % 16 == 0) ? 16
                  : (lda % 8 == 0 && a % 8 == 0) ? 8
                  : (lda % 4 == 0 && a % 4 == 0) ? 4 : 1;
  if (vec == 16)
    ring_load_a<16, false>(dst, A, lda, rows, 0, kc, tid);
  else if (vec == 8)
    ring_load_a<8, false>(dst, A, lda, rows, 0, kc, tid);
  else if (vec == 4)
    ring_load_a<4, false>(dst, A, lda, rows, 0, kc, tid);
  else
    for (int base = 0; base < rows * kKT; base += 8 * kThreads) {
      int8_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * kThreads + tid, col = kc + idx % kKT;
        v[u] = idx < rows * kKT && col < lda ? A[(size_t)(idx / kKT) * lda + col] : (int8_t)0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * kThreads + tid;
        if (idx < rows * kKT) dst[idx / kKT * kSA + idx % kKT] = v[u];
      }
    }
}

// Start the copies of A's first K tiles into the slots (A as stage_tile
// reads it): all T tiles when they fit the nslots slots (resident), else
// tile 0 of a double-buffered pass. The slots must be free.
template <int MT>
__device__ __forceinline__ void stream_begin(int8_t* slots, int nslots, const int8_t* A, int lda,
                                             int nrows, int tid) {
  const int T = (lda + kKT - 1) / kKT;
  for (int t = 0; t < (T <= nslots ? T : 1); ++t)
    stage_tile<MT>(slots + t * slot_bytes<MT>(), A, lda, nrows, t * kKT, tid);
  cp_async_commit();
}

// After stream_begin with the same A: acc += A[0, min(nrows, MT * 16)) x
// [0, lda) against the B operand sBop (row stride sbop, K-contiguous per
// lane). With every tile resident, one wait and one barrier; else tile t +
// 1's copy is in flight beside tile t's MMA. The first barrier publishes
// the caller's writes to sBop; ends with a barrier after the last MMA.
template <int MT>
__device__ __forceinline__ void stream_mma(int (&acc)[MT][2][4], int8_t* slots, int nslots,
                                           const int8_t* A, int lda, int nrows,
                                           const int8_t* sBop, int sbop, int tid, int warp,
                                           int lane) {
  const int T = (lda + kKT - 1) / kKT;
  if (T <= nslots) {
    cp_async_wait<0>();
    __syncthreads();
    for (int t = 0; t < T; ++t)
      mma_chunk<MT>(acc, slots + t * slot_bytes<MT>(), sBop, sbop, t * kKT,
                    (min(kKT, lda - t * kKT) + 31) / 32, warp, lane);
    __syncthreads();
    return;
  }
  for (int t = 0; t < T; ++t) {
    // the MMA of tile t - 1, which read this slot, ended at the last barrier
    if (t + 1 < T)
      stage_tile<MT>(slots + ((t + 1) & 1) * slot_bytes<MT>(), A, lda, nrows, (t + 1) * kKT, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... every thread's
    mma_chunk<MT>(acc, slots + (t & 1) * slot_bytes<MT>(), sBop, sbop, t * kKT,
                  (min(kKT, lda - t * kKT) + 31) / 32, warp, lane);
    __syncthreads();
  }
}

// B2's epilogue of one chunk over the accumulator sAcc ([n * L8 + 1][kT],
// the ones row last), two threads per lane: the stage-1 carry chains; with
// reconstruction, their bytes (biased, K-contiguous per lane in sB2)
// against big2 on the tensor cores and the stage-2 chains, n outputs a
// pass (their n * L8 rows fit the MT tiles and sAcc for any n2), big2's
// rows in s2 (resident: all its tiles, staged; else two slots over sAcc,
// restaged each pass) and its ones row (sOnes2) by dp4a; the fold; the
// chunk's canonical limbs summed in sCanon (fold_and_emit).
template <int MT>
__device__ __forceinline__ void chunk_epilogue(int32_t* sAcc, int8_t* sB2, int sb2, int8_t* s2,
                                               bool resident, const int8_t* sOnes2,
                                               const int8_t* big2,
                                               const uint32_t* tables, int32_t* out,
                                               uint32_t* sCanon, const Params& p, int lane0,
                                               int tid, int warp, int lane, bool first,
                                               bool last) {
  const int n_out = p.n2 ? p.n2 : p.n;
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
      for (int l1 = 0; l1 < L8 + p.n_res1; ++l1)
        sB2[ll * sb2 + l1 * p.n + i] = (int8_t)(bytes[l1] ^ 0x80u);
    } else if (gl < p.nbp) {
      fold_and_emit<kChunked>(bytes, L8 + p.n_res1, p, tables, out, sCanon, n_out, i, ll, gl,
                              first, last);
    }
  }
  if (!p.n2) return;
  __syncthreads();  // sB2 is complete and sAcc's stage-1 rows are read
  const int nslots = resident ? tiles_2(p) : 2;
  if (!resident) stream_begin<MT>(s2, nslots, big2, p.rows2, min(p.n, p.n2) * L8, tid);
  // big2's ones row (row n2 * L8) against lane ll's bytes: from the MMA's
  // row n2 * L8 below when it was staged, else here
  const int mma_rows = resident ? resident_rows2<MT>(p) : 0;
  int ones2 = 0;
  if (mma_rows <= p.n2 * L8) {
    const int* w = reinterpret_cast<const int*>(sOnes2);
    const int* b = reinterpret_cast<const int*>(sB2 + ll * sb2);
    for (int c = 0; c < ones2_bytes(p) / 4; ++c) ones2 = __dp4a(b[c], w[c], ones2);
  }
  const uint32_t* c2 = tables + p.off_c2;
  for (int o0 = 0; o0 < p.n2; o0 += p.n) {
    const int go = min(p.n, p.n2 - o0);
    const int8_t* A = big2 + (size_t)(o0 * L8) * p.rows2;
    if (o0) {
      __syncthreads();  // the last pass's chains are done with sAcc
      stream_begin<MT>(s2, nslots, A, p.rows2, go * L8, tid);
    }
    int acc2[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc2[mt][nt][q] = 0;
    stream_mma<MT>(acc2, s2, nslots, A, p.rows2, go * L8, sB2, sb2, tid, warp, lane);
    spill_acc<MT>(sAcc, acc2, max_of(go * L8, mma_rows), warp, lane);
    __syncthreads();
    const uint32_t s128_2 =
        (mma_rows > p.n2 * L8 ? (uint32_t)sAcc[(p.n2 * L8) * kT + ll] : (uint32_t)ones2) * 128u;
    for (int i2 = half; i2 < go; i2 += kThreads / kT) {
      uint32_t carry = 0;
      for (int c = 0; c < L8; ++c) {
        const uint32_t t =
            (uint32_t)sAcc[(i2 * L8 + c) * kT + ll] + c2[(o0 + i2) * L8 + c] + s128_2 + carry;
        bytes[c] = t & 0xFFu;
        carry = t >> 8;
      }
      for (int r = 0; r < p.n_res2; ++r) {
        bytes[L8 + r] = carry & 0xFFu;
        carry >>= 8;
      }
      if (gl < p.nbp)
        fold_and_emit<kChunked>(bytes, L8 + p.n_res2, p, tables, out, sCanon, n_out, o0 + i2, ll,
                                gl, first, last);
    }
  }
}

// B1 and B3 (MODE kPlain, kAcc): one block per 128 lanes, the whole
// pipeline. B2's kernels share its K loop and epilogue as helpers
// (k_loop, spill_acc, chunk_epilogue); this kernel keeps its own copy of
// them, as it was measured, since B1's and B3's register allocation
// (chip_smoke.py, KEPT_PTXAS) moved when it was recast into the helpers.
// For the same reason its shared memory starts at the run-time offset
// lay.canon_bytes (0 here): with the constant base, ptxas allocated
// B1's MT1 and B3's MT1 differently (64/68 -> 64/96, 64/92 -> 64/72).
template <int MT, int MODE>
__global__ void __launch_bounds__(kThreads)
mxu8_fused_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                  const int8_t* __restrict__ bigr, const int8_t* __restrict__ big2,
                  const uint32_t* __restrict__ tables, int32_t* __restrict__ out, Params p,
                  Layout lay) {
  static_assert(MODE != kChunked, "B2 runs mxu8_split_kernel and mxu8_epilogue_kernel");
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int T = (p.K + kKT - 1) / kKT;
  const int groups = (p.wpp + 3) / 4;

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
    if (s < T) issue_tile<MT>(ring, lay, sec, bigs, p, s, lane0, tid);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... every thread's, and tile t - 1's stage is free
    if (t + kStages - 1 < T) issue_tile<MT>(ring, lay, sec, bigs, p, t + kStages - 1, lane0, tid);
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
          philox4x32_10(c, p.seed, 0u);
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
        fold_and_emit<MODE>(bytes, L8 + p.n_res1, p, tables, out, nullptr, n_out, i, ll, gl,
                            true, true);
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
          fold_and_emit<MODE>(bytes, L8 + p.n_res2, p, tables, out, nullptr, n_out, i2, ll, gl,
                              true, true);
      }
    }
  }
}

// f(chunk, begin, end) for each piece of split s of S over the flattened
// list of n_chunks * per_chunk (chunk, item) pairs: pairs [s * total / S,
// (s + 1) * total / S), cut where a chunk ends.
template <typename F>
__device__ __forceinline__ void for_pieces(int per_chunk, int n_chunks, int s, int S, F&& f) {
  const long long total = (long long)per_chunk * n_chunks;
  long long i = total * s / S;
  const long long end = total * (s + 1) / S;
  while (i < end) {
    const int c = (int)(i / per_chunk), b = (int)(i % per_chunk);
    const int e = (int)min((long long)per_chunk, b + (end - i));
    f(c, b, e);
    i += e - b;
  }
}

// B2, split kernel: block (lane block blockIdx.x % lane_blocks, split
// blockIdx.x / lane_blocks). Its K tiles: stage 1 per chunk piece, the
// int32 partials (and the ones row's sums) added into the chunk's slab of
// ws. Its draws: the Philox sums accR, accO per (lane, PRNG word) added
// into the slab's randomness rows. Two blocks per SM up to MT 8 (the
// config-3 instance): 128 registers a thread.
template <int MT>
__global__ void __launch_bounds__(kThreads, MT <= 8 ? 2 : 1)
mxu8_split_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                  int32_t* __restrict__ ws, Params p, Layout lay, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int8_t* sB = reinterpret_cast<int8_t*>(smem + kStages * lay.stage_bytes);
  int32_t* sAcc = reinterpret_cast<int32_t*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lane_blocks = (p.nbp + kT - 1) / kT;
  const int s = blockIdx.x / lane_blocks, lane0 = (blockIdx.x % lane_blocks) * kT;
  const int ones_row = p.n * p.L8;
  const int rows = ws_rows(p), pitch = ws_pitch(p);

  for_pieces(
      (p.K + kKT - 1) / kKT, p.n_chunks, s, splits, [&](int ch, int t_begin, int t_end) {
        int acc[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
        int ones[4] = {0, 0, 0, 0};
        __syncthreads();  // the previous piece's adds are done with sAcc
        k_loop<MT>(acc, ones, ring, sB, lay, sec + (size_t)ch * p.K * p.nbp, bigs, p, t_begin,
                   t_end, lane0, tid, warp, lane);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) ones[x] += __shfl_xor_sync(0xFFFFFFFFu, ones[x], m);
        __syncthreads();  // every warp is done with the ring and sB
        spill_acc<MT>(sAcc, acc, ones_row, warp, lane);
        if ((lane >> 2) == 0)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            sAcc[ones_row * kT + warp * 16 + 4 * (lane & 3) + x] = ones[x];
        __syncthreads();
        int32_t* slab = ws + (size_t)ch * rows * pitch;
        for (int idx = tid; idx < (ones_row + 1) * kT; idx += kThreads) {
          const int gl = lane0 + idx % kT;
          if (gl < p.nbp) atomicAdd(slab + (size_t)(idx / kT) * pitch + gl, sAcc[idx]);
        }
      });

  if (p.Kr > 0) {
    const int groups = (p.wpp + 3) / 4;
    for_pieces(p.rp, p.n_chunks, s, splits, [&](int ch, int j_begin, int j_end) {
      const uint32_t seed_c = p.seed + (uint32_t)ch * p.seed_stride;
      auto* sums = reinterpret_cast<unsigned*>(ws + ((size_t)ch * rows + ones_row + 1) * pitch);
      for (int idx = tid; idx < kT * groups; idx += kThreads) {
        const int g = idx / kT, gl = lane0 + idx % kT;
        if (gl >= p.nbp) continue;
        uint32_t accR[4] = {0, 0, 0, 0}, accO[4] = {0, 0, 0, 0};
        // one call per iteration: chip_smoke.py counts this loop's SASS
#pragma unroll 1
        for (int j = j_begin; j < j_end; ++j) {
          uint32_t c[4] = {(uint32_t)gl, (uint32_t)j, (uint32_t)g, 0u};
          philox4x32_10(c, seed_c, 0u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accR[q] += c[q];
            accO[q] += c[q] >> 16;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int w = 4 * g + q;
          if (w >= p.wpp) continue;
          atomicAdd(sums + (size_t)w * pitch + gl, accR[q]);
          atomicAdd(sums + (size_t)(p.wpp + w) * pitch + gl, accO[q]);
        }
      }
    });
  }
}

// B2, epilogue kernel: one block per lane block, the chunks in turn. bigR
// and big2 are staged once when they fit (epilogue_resident), else
// streamed each pass, their copies started before the operand they meet
// is written. A chunk's draw sums become the biased bytes of the
// randomness operand (accE = accR - (accO << 16), exact for the whole
// sum), bigR's pass adds their product into fresh fragments, and the
// fragments plus the slab's stage-1 rows are the accumulator that
// chunk_epilogue takes.
template <int MT>
__global__ void __launch_bounds__(kThreads)
mxu8_epilogue_kernel(const int32_t* __restrict__ ws, const int8_t* __restrict__ bigr,
                     const int8_t* __restrict__ big2, const uint32_t* __restrict__ tables,
                     int32_t* __restrict__ out, Params p, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool resident = epilogue_resident<MT>(p);
  uint32_t* sCanon = reinterpret_cast<uint32_t*>(smem);
  int8_t* sOnes2 = reinterpret_cast<int8_t*>(smem + lay.canon_bytes);  // big2's ones row
  int8_t* mats = sOnes2 + ones2_bytes(p);  // resident: bigR's tiles, then big2's
  const int mats_bytes = resident ? (tiles_r(p) + tiles_2(p)) * slot_bytes<MT>() : 0;
  unsigned char* un = reinterpret_cast<unsigned char*>(mats) + mats_bytes;
  int8_t* sB = reinterpret_cast<int8_t*>(un);  // randomness bytes
  int32_t* sAcc = reinterpret_cast<int32_t*>(un);
  int8_t* sB2 = reinterpret_cast<int8_t*>(un + epilogue_acc_bytes<MT>(p, resident));  // stage 2's
  const int sb = lay.sb, sb2 = stage2_stride(p);
  int8_t* sR = resident ? mats : sB + kT * sb;  // bigR's tiles, or two slots after sB
  int8_t* s2 = resident ? mats + tiles_r(p) * slot_bytes<MT>() : reinterpret_cast<int8_t*>(sAcc);
  const int nslots_r = resident ? tiles_r(p) : 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lane0 = blockIdx.x * kT;
  const int ones_row = p.n * p.L8;
  const int rows = ws_rows(p), pitch = ws_pitch(p);
  if (p.n2) {
    const int8_t* w = big2 + (size_t)(p.n2 * p.L8) * p.rows2;
    for (int q = tid; q < ones2_bytes(p); q += kThreads) sOnes2[q] = q < p.rows2 ? w[q] : 0;
  }
  if (resident) {  // one commit group each; the first pass's wait takes both
    if (p.Kr) stream_begin<MT>(sR, nslots_r, bigr, p.Kr_pad, p.n_pad, tid);
    if (p.n2) stream_begin<MT>(s2, tiles_2(p), big2, p.rows2, resident_rows2<MT>(p), tid);
  }

  for (int ch = 0; ch < p.n_chunks; ++ch) {
    const int32_t* slab = ws + (size_t)ch * rows * pitch;
    if (ch) __syncthreads();  // the previous chunk's epilogue is done with the union
    int acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
    int rand_ones = 0;
    if (p.Kr > 0) {
      if (!resident) stream_begin<MT>(sR, 2, bigr, p.Kr_pad, p.n_pad, tid);
      const auto* sums = reinterpret_cast<const uint32_t*>(slab + (size_t)(ones_row + 1) * pitch);
#pragma unroll 4
      for (int idx = tid; idx < kT * p.wpp; idx += kThreads) {
        const int ll = idx % kT, w = idx / kT, gl = lane0 + ll;
        uint32_t accR = 0, accO = 0;
        if (gl < p.nbp) {
          accR = sums[(size_t)w * pitch + gl];
          accO = sums[(size_t)(p.wpp + w) * pitch + gl];
        }
        // accR = sum(lo) + 2^16 sum(hi) mod 2^32 and sum(lo) < 2^32: exact
        const uint32_t accE = accR - (accO << 16);
        int8_t* row = sB + ll * sb;
        for (int cb = 0; cb < p.n_bytes; ++cb) {
          row[(2 * cb) * p.wpp + w] = (int8_t)(byte_of(accE, cb) ^ 0x80u);
          row[(2 * cb + 1) * p.wpp + w] = (int8_t)(byte_of(accO, cb) ^ 0x80u);
        }
      }
      stream_mma<MT>(acc, sR, nslots_r, bigr, p.Kr_pad, p.n_pad, sB, sb, tid, warp, lane);
      if (tid < kT) {
        const int* w1 = reinterpret_cast<const int*>(bigr + (size_t)ones_row * p.Kr_pad);
        const int* b = reinterpret_cast<const int*>(sB + tid * sb);
        for (int c = 0; c < p.Kr_pad / 4; ++c) rand_ones = __dp4a(b[c], w1[c], rand_ones);
      }
      __syncthreads();  // the spill below overwrites sB
    }
    spill_acc<MT>(sAcc, acc, ones_row, warp, lane);
    if (tid < kT) sAcc[ones_row * kT + tid] = rand_ones;
    __syncthreads();
    // the split blocks' sums, 16 bytes a load, eight loads in flight a
    // thread (the pitch's lanes past nbp hold zeros)
    const int n_acc4 = (ones_row + 1) * (kT / 4);
    for (int base = 0; base < n_acc4; base += 8 * kThreads) {
      int4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * kThreads + tid, gl = lane0 + 4 * (idx % (kT / 4));
        v[u] = idx < n_acc4 && gl < pitch
                   ? *reinterpret_cast<const int4*>(slab + (size_t)(idx / (kT / 4)) * pitch + gl)
                   : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * kThreads + tid;
        if (idx >= n_acc4) continue;
        int4* d = reinterpret_cast<int4*>(sAcc) + idx;
        const int4 x = *d;
        *d = make_int4(x.x + v[u].x, x.y + v[u].y, x.z + v[u].z, x.w + v[u].w);
      }
    }
    __syncthreads();
    chunk_epilogue<MT>(sAcc, sB2, sb2, s2, resident, sOnes2, big2, tables, out, sCanon, p, lane0,
                       tid, warp, lane, ch == 0, ch == p.n_chunks - 1);
  }
}

#if SDA_MXU8_MODE == 3
// ------------------------------------------------------------ wide plans
//
// B1 and B3 (mode 3) for plans of more than 192 output rows, combine-only
// and one chunk. One block of 256 threads (two warpgroups) computes
// kWideRows = 256 of the n * L8 rows for kT = 128 lanes at a time. The grid
// is (row slices, groups of lane blocks) and fills the SMs once: each block
// takes its group's lane blocks in turn, so that the slices of a lane block
// run side by side and read its sec tiles from L2 at about the same time. A
// slice holds whole clerks: rows [r0, r0 + (256 / L8) * L8). Warp w' of
// warpgroup wg owns the rows 128 wg + 64 i + 16 w' + [0, 16) for i = 0, 1
// and all 128 lanes: the accumulator layout of wgmma's m64n128, which the
// mma.sync segments keep too (two m16 tiles, sixteen n8 tiles).
//
// K runs as one or two segments, each a pipeline of raw operand tiles that
// every warp transposes into sB:
//   * randomness (PRNG mode): the biased bytes that mxu8_wide_rand_kernel
//     drew into rand8 ([Kr_pad][nbp]) against bigR, whose 256 rows' tile is
//     staged with each raw tile; mma.sync (wide_segment_mma), one barrier
//     a K tile, the transposes of tile t beside the MMA of tile t - 1;
//   * the participants' rows against bigS: where bigS's columns repeat with
//     every participant (the period, sec's rows a participant) and one
//     period of the block's rows fits in shared memory, bigS is staged once
//     and read at column c mod period by wgmma (wide_segment_wgmma: steps
//     of two K tiles, the warpgroup's m64n128k32 products running on the
//     tensor cores while the warps transpose the next step; one barrier a
//     step); else as the randomness, bigS staged with each tile.
// On the H100, at 728 clerks and a launch of 128 participants x 10,496
// lanes, mma.sync alone (no loads, no transposes) reached 30 % of the int8
// peak; with wgmma a launch took 5.5 ms, where the mma.sync kernel took 9.6.
// The ones row of bigS and bigR is 1 at every column that meets an operand
// row, and the operands are zero past their rows (rand8's rows past Kr are
// written zero), so its sums take a row of ones: dp4a in the transposes.
// The accumulators, spilled to shared memory, feed B1's carry chains and
// fold; B3 adds the canonical limbs onto out.

constexpr int kWideRows = 256;                    // output rows of one block
constexpr int kWideNT = 16;                       // n8 tiles of one warp: the 128 lanes
constexpr int kWideRing = 4;                      // mma.sync segments: ring stages, two in flight
constexpr int kStepTiles = 2;                     // K tiles a step of the wgmma segment
constexpr int kStepRing = 4;                      // wgmma segment: raw steps staged, three in flight
constexpr int kSBufs = 3;                         // wgmma segment: sB buffers
constexpr int kWideSB = kKT + 16;                 // mma.sync segments: sB's row stride
constexpr int kWideTileA = kWideRows * kSA;       // one streamed A tile, row stride kSA
constexpr int kCore = 128;                        // a core matrix: 8 rows x 16 bytes
constexpr int kBChunk = kT / 8 * kCore;           // 16 K columns of sBw: 16 core matrices
constexpr int kBBytes = kStepTiles * kKT / 16 * kBChunk;  // one sBw buffer (16 KB)
constexpr int kAChunk = kWideRows / 8 * kCore;    // 16 columns of the staged bigS (4 KB)
// shared memory: [raw ring][sB buffers][A: bigS staged, or the A ring] ... [a row of ones]
constexpr int kWideRaw = kStepRing * kStepTiles * kRawBytes;
constexpr int kWideA = kWideRaw + kSBufs * kBBytes;

struct WideLayout {
  int resident;  // bigS's period staged once (the wgmma segment)
  int period;    // sec rows a participant: bigS's column period
  int smem;      // the whole block
  int vec_a;     // bigS copy width: 16, 8 or 4
  int vec_r;     // bigR copy width
  int vec_b;     // sec copy width: 16, 4 or 1
  int vec_rb;    // rand8 copy width
};

inline int vec_cols(int cols, const void* a) {
  const auto x = reinterpret_cast<uintptr_t>(a);
  if (cols % 16 == 0 && x % 16 == 0) return 16;
  if (cols % 8 == 0 && x % 8 == 0) return 8;
  return 4;
}

inline int vec_lanes(int nbp, const void* a) {
  const auto x = reinterpret_cast<uintptr_t>(a);
  return (nbp % 16 == 0 && x % 16 == 0) ? 16 : (nbp % 4 == 0 && x % 4 == 0) ? 4 : 1;
}

WideLayout wide_layout(const Params& p, int period, const void* sec, const void* bigs,
                       const void* bigr, const void* rand8) {
  WideLayout l;
  l.period = period;
  l.vec_a = vec_cols(p.K, bigs);
  l.vec_r = vec_cols(p.Kr_pad, bigr);
  l.vec_b = vec_lanes(p.nbp, sec);
  l.vec_rb = vec_lanes(p.nbp, rand8);
  // the staged period: its 16-column chunks, and the first once more after the last
  const int staged = (period / 16 + 1) * kAChunk;
  l.resident = period > 0 && period % 16 == 0 && p.K % period == 0 && l.vec_a == 16 &&
               kWideA + staged + kKT <= kMaxSmem;
  const int ring_a = (p.Kr > 0 || !l.resident) ? kWideRing * kWideTileA : 0;
  l.smem = round16(max_of(kWideA + max_of(l.resident ? staged : 0, ring_a) + kKT,
                          (kWideRows + 1) * kT * 4));
  return l;
}

// Start the copy of rows [0, kWideRows) x columns [c0, c0 + kKT) of a
// row-major int8 matrix with lda columns into dst (row stride kSA), zero at
// rows past a_rows and columns past lda. VEC divides lda and c0.
template <int VEC>
__device__ __forceinline__ void wide_load_a(int8_t* dst, const int8_t* A, int lda, int a_rows,
                                            int c0, int tid) {
  constexpr int kPerRow = kKT / VEC;
  for (int idx = tid; idx < kWideRows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * VEC, col = c0 + c;
    const bool in = r < a_rows && col < lda;
    cp_async(dst + r * kSA + c, in ? A + (size_t)r * lda + col : A, VEC, in ? VEC : 0);
  }
}

__device__ __forceinline__ void wide_copy_a(int vec, int8_t* dst, const int8_t* A, int lda,
                                            int a_rows, int c0, int tid) {
  if (vec == 16)
    wide_load_a<16>(dst, A, lda, a_rows, c0, tid);
  else if (vec == 8)
    wide_load_a<8>(dst, A, lda, a_rows, c0, tid);
  else
    wide_load_a<4>(dst, A, lda, a_rows, c0, tid);
}

__device__ __forceinline__ void wide_copy_raw(int vec, int8_t* raw, const int8_t* B, int K,
                                              int nbp, int k0, int lane0, int tid) {
  if (vec == 16)
    ring_load_raw<16>(raw, B, K, nbp, k0, lane0, tid);
  else if (vec == 4)
    ring_load_raw<4>(raw, B, K, nbp, k0, lane0, tid);
  else
    ring_load_raw<1>(raw, B, K, nbp, k0, lane0, tid);
}

// Four 8x8 b16 matrices from shared memory (ldmatrix.x4): lanes 8 q to 8 q
// + 7 give the row addresses of matrix q, and each thread receives its
// fragment word of every matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// mma.sync over one kKT tile: acc[i][j] += sA's rows 128 wg + 64 i + 16 w'
// + [0, 16) (row stride kSA) . sB's lanes 8 j + [0, 8) (row stride
// kWideSB). Each k step loads its fragments first, with ldmatrix: an A
// tile's four 8x8 matrices are its a0..a3, and two n8 tiles' b0, b1 make
// four more.
__device__ __forceinline__ void wide_mma(int (&acc)[2][kWideNT][4], const int8_t* sA,
                                         const int8_t* sB, int warp, int lane) {
  const int q = lane >> 3, r8 = lane & 7;
  const int row0 = (warp >> 2) * 128 + (warp & 3) * 16;
#pragma unroll
  for (int ks = 0; ks < kKT / 32; ++ks) {
    uint32_t a[2][4], b[kWideNT / 2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(a[i], sA + (row0 + 64 * i + (q & 1) * 8 + r8) * kSA + ks * 32 + (q >> 1) * 16);
#pragma unroll
    for (int np = 0; np < kWideNT / 2; ++np)
      ldmatrix_x4(b[np], sB + (np * 16 + (q >> 1) * 8 + r8) * kWideSB + ks * 32 + (q & 1) * 16);
#pragma unroll
    for (int j = 0; j < kWideNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j >> 1][2 * (j & 1)],
               b[j >> 1][2 * (j & 1) + 1]);
  }
}

// A segment on mma.sync: acc += A's block rows (a_rows of them real, A
// offset to the block's first row) . B's K rows of this block's lanes, A's
// tile staged with each raw tile in ring slot t % kWideRing of sA; ones[x]
// += the ones row's sums for lanes 16 warp + 4 (lane & 3) + x (each thread
// of a lane quad's column a part). Tile t waits for its copies, passes the
// barrier, starts tile t + 2's (its slots last held tile t - 2's, done with
// at the barrier), is transposed into sB[t & 1], and the MMA of tile t - 1
// runs from sB[(t - 1) & 1]. Ends after a barrier, with no copy in flight.
__device__ void wide_segment_mma(int (&acc)[2][kWideNT][4], int (&ones)[4],
                                 unsigned char* rawring, int8_t* sB, const int8_t* w1,
                                 int8_t* sA, const int8_t* B, int K, int vec_b, const int8_t* A,
                                 int lda, int a_rows, int vec_a, int nbp, int lane0, int tid,
                                 int warp, int lane) {
  const int T = (K + kKT - 1) / kKT;
  auto issue = [&](int t) {
    wide_copy_raw(vec_b, reinterpret_cast<int8_t*>(rawring + (t % kWideRing) * kRawBytes), B, K,
                  nbp, t * kKT, lane0, tid);
    wide_copy_a(vec_a, sA + (t % kWideRing) * kWideTileA, A, lda, a_rows, t * kKT, tid);
  };
  for (int s = 0; s < 2; ++s) {
    if (s < T) issue(s);
    cp_async_commit();
  }
  for (int t = 0; t <= T; ++t) {
    if (t < T) cp_async_wait<1>();  // tile t has landed (this thread's copies)
    __syncthreads();                // ... every thread's; tile t - 1's sB and t - 2's slots are done
    if (t + 2 < T) issue(t + 2);
    cp_async_commit();
    if (t < T)
      ring_transpose_b(sB + (t & 1) * kT * kWideSB, kWideSB,
                       reinterpret_cast<const int8_t*>(rawring + (t % kWideRing) * kRawBytes), w1,
                       ones, warp, lane);
    if (t > 0)
      wide_mma(acc, sA + ((t - 1) % kWideRing) * kWideTileA, sB + ((t - 1) & 1) * kT * kWideSB,
               warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------- wgmma segment

// Start the copy of warp w's K rows of a wgmma step, [16 w, 16 w + 16) of
// its kStepTiles * kKT from k_step, x the block's 128 lanes into the step's
// raw stage, where ring_load_raw puts them (zero past K and nbp): each warp
// then transposes only the rows it copied.
template <int VEC>
__device__ __forceinline__ void warp_load_raw(unsigned char* stage, const int8_t* B, int K,
                                              int nbp, int k_step, int lane0, int warp,
                                              int lane) {
  constexpr int kPerRow = kT / VEC;
  int8_t* raw = reinterpret_cast<int8_t*>(stage) + (warp >> 2) * kRawBytes;
  const int k0 = k_step + (warp >> 2) * kKT;
  for (int idx = lane; idx < 16 * kPerRow; idx += 32) {
    const int r = (warp & 3) * 16 + idx / kPerRow, c = (idx % kPerRow) * VEC;
    const int k = k0 + r, ln = lane0 + c;
    const bool in = k < K && ln < nbp;
    int8_t* dst = raw + r * kT + 16 * raw_chunk(r, c >> 4) + (c & 15);
    if constexpr (VEC == 1)
      *dst = in ? B[(size_t)k * nbp + ln] : (int8_t)0;
    else
      cp_async(dst, in ? B + (size_t)k * nbp + ln : B, VEC, in ? VEC : 0);
  }
}

// A wgmma matrix descriptor without swizzle (core matrices of 8 rows x 16
// bytes, each stored as 128 contiguous bytes): the start address, lbo the
// bytes from one core matrix to the next along K, sbo along M or N.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving other instructions that read or write the
// accumulators across this point (wgmma reads and writes them
// asynchronously).
__device__ __forceinline__ void fence_operands(int (&acc)[2][kWideNT][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kWideNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(acc[i][j][q])::"memory");
}

// Shared-memory writes of the generic proxy (stores, cp.async), before the
// tensor cores read them through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A (64 rows x 32 K, descriptor da) . B (128 lanes x 32 K, descriptor
// db): the warpgroup's m64n128k32 int8 product, asynchronous until
// wgmma_wait. d[j][q] is mma.sync's C fragment of n8 tile j.
__device__ __forceinline__ void wgmma_64x128x32(int (&d)[kWideNT][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// Step t's kStepTiles raw tiles (kStepTiles * kKT K rows x 128 lanes) into
// sBw, wgmma's B layout: 16 K columns a chunk (kBChunk bytes), in it the
// lanes' 16 core matrices of 8 lanes, each lane's 16 bytes a row. Warp w
// takes K rows [16 w, 16 w + 16), thread l the lanes [4 l, 4 l + 4): 16
// word reads (each a whole raw row across the warp), four 4x4 byte
// transposes, and four 16-byte stores, turned so that a quarter warp's fall
// on distinct banks. ones[x] += the 16 bytes of lane 4 l + x.
__device__ __forceinline__ void wide_transpose_cm(int8_t* sBw, const unsigned char* raw,
                                                  int (&ones)[4], int warp, int lane) {
  const unsigned char* rt = raw + (warp >> 2) * kRawBytes;
  const int k0 = (warp & 3) * 16;
  uint32_t o[4][4];  // [lane x][K word]
#pragma unroll
  for (int kw = 0; kw < 4; ++kw) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * kw + i;
      r[i] = *reinterpret_cast<const uint32_t*>(rt + k * kT + 16 * raw_chunk(k, lane >> 2) +
                                                4 * (lane & 3));
    }
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
    o[0][kw] = __byte_perm(t0, t2, 0x5410);
    o[1][kw] = __byte_perm(t0, t2, 0x7632);
    o[2][kw] = __byte_perm(t1, t3, 0x5410);
    o[3][kw] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int kw = 0; kw < 4; ++kw) ones[x] = __dp4a((int)o[x][kw], 0x01010101, ones[x]);
  const int turn = (lane >> 1) & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int x = (s + turn) & 3, l = 4 * lane + x;
    const uint4 v = x == 0   ? make_uint4(o[0][0], o[0][1], o[0][2], o[0][3])
                    : x == 1 ? make_uint4(o[1][0], o[1][1], o[1][2], o[1][3])
                    : x == 2 ? make_uint4(o[2][0], o[2][1], o[2][2], o[2][3])
                             : make_uint4(o[3][0], o[3][1], o[3][2], o[3][3]);
    *reinterpret_cast<uint4*>(sBw + warp * kBChunk + (l >> 3) * kCore + (l & 7) * 16) = v;
  }
}

// The participants' segment on wgmma: bigS's period (rows of the block, A
// offset to its first) staged once into sAw as wgmma's A layout (16-column
// chunks of kAChunk bytes, the rows' 32 core matrices in each, and chunk 0
// once more after the last, so that a k32 step starting at the last chunk
// reads on into the first); then steps of kStepTiles K tiles. Each warp
// copies and transposes its own 16 K rows of a step, so a step needs one
// block barrier: step t waits for the warp's copies (a warp barrier),
// starts step t + 3's into step t - 1's stage, is transposed into
// sBw[t % 3] (ones[x] for lanes 4 lane + x), passes the barrier (sBw[t %
// 3] whole; the products of step t - 3, which read it, done before the
// last barrier), and its products are issued: for each k32 step the
// warpgroup's two m64 tiles against the 128 lanes, bigS's columns from
// (32 ks + start) mod period. They run while the warps go on to step t +
// 1; the wait after the issue leaves one step in flight. Ends after a
// barrier, with no copy or product in flight.
__device__ void wide_segment_wgmma(int (&acc)[2][kWideNT][4], int (&ones)[4],
                                   unsigned char* rawring, int8_t* sBw, int8_t* sAw, int period,
                                   const int8_t* B, int K, int vec_b, const int8_t* A, int lda,
                                   int a_rows, int nbp, int lane0, int tid, int warp, int lane) {
  constexpr int KI = kStepTiles * kKT, STAGE = kStepTiles * kRawBytes;
  const int T = (K + KI - 1) / KI, chunks = period / 16, wg = warp >> 2;
  auto issue = [&](int t) {
    unsigned char* stage = rawring + (t % kStepRing) * STAGE;
    if (vec_b == 16)
      warp_load_raw<16>(stage, B, K, nbp, t * KI, lane0, warp, lane);
    else if (vec_b == 4)
      warp_load_raw<4>(stage, B, K, nbp, t * KI, lane0, warp, lane);
    else
      warp_load_raw<1>(stage, B, K, nbp, t * KI, lane0, warp, lane);
  };
  for (int idx = tid; idx < kWideRows * (chunks + 1); idx += kThreads) {
    const int r = idx % kWideRows, c = idx / kWideRows;
    const bool in = r < a_rows;
    cp_async(sAw + c * kAChunk + (r >> 3) * kCore + (r & 7) * 16,
             in ? A + (size_t)r * lda + 16 * (c % chunks) : A, 16, in ? 16 : 0);
  }
  for (int s = 0; s < kStepRing - 1; ++s) {
    if (s < T) issue(s);
    cp_async_commit();
  }
  int start = 0;  // step t's first column of bigS, mod period
  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStepRing - 2>();  // this thread's copies of step t (and, first, of bigS)
    __syncwarp();                    // ... its warp's
    if (t + kStepRing - 1 < T) issue(t + kStepRing - 1);
    cp_async_commit();
    int8_t* sb = sBw + (t % kSBufs) * kBBytes;
    wide_transpose_cm(sb, rawring + (t % kStepRing) * STAGE, ones, warp, lane);
    fence_proxy_async();  // the stores above, and bigS's copies, before the tensor cores' reads
    __syncthreads();
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KI / 32; ++ks) {
      int c = start / 16 + 2 * ks;
      while (c >= chunks) c -= chunks;
      const uint64_t db = gmma_desc(sb + 2 * ks * kBChunk, kBChunk, kCore);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wgmma_64x128x32(acc[i], gmma_desc(sAw + c * kAChunk + (16 * wg + 8 * i) * kCore, kAChunk,
                                          kCore),
                        db);
    }
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();
    start += KI;
    while (start >= period) start -= period;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// One lane block of mxu8_wide_kernel (lanes [lane0, lane0 + kT)).
template <bool RESIDENT>
__device__ void wide_lane_block(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                                const int8_t* __restrict__ bigr, const int8_t* __restrict__ rand8,
                                const uint32_t* __restrict__ tables, int32_t* __restrict__ out,
                                const Params& p, const WideLayout& lay, int accumulate,
                                unsigned char* smem, const int8_t* w1, int lane0, int i0, int r0,
                                int a_rows, int tid, int warp, int lane) {
  unsigned char* rawring = smem;
  int8_t* sB = reinterpret_cast<int8_t*>(smem + kWideRaw);
  int8_t* sA = reinterpret_cast<int8_t*>(smem + kWideA);
  int32_t* sAcc = reinterpret_cast<int32_t*>(smem);  // after the K loop
  const int L8 = p.L8, per_slice = kWideRows / L8;

  int acc[2][kWideNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kWideNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
  // the ones row's sums: of the mma.sync segments for lanes 16 warp + 4
  // (lane & 3) + x, of the wgmma segment for lanes 4 lane + x
  int ones_m[4] = {0, 0, 0, 0}, ones_w[4] = {0, 0, 0, 0};
  // the wgmma segment first, while nothing else has written the
  // accumulators (ptxas serializes the products otherwise)
  if constexpr (RESIDENT)
    wide_segment_wgmma(acc, ones_w, rawring, sB, sA, lay.period, sec, p.K, lay.vec_b,
                       bigs + (size_t)r0 * p.K, p.K, a_rows, p.nbp, lane0, tid, warp, lane);
  else
    wide_segment_mma(acc, ones_m, rawring, sB, w1, sA, sec, p.K, lay.vec_b,
                     bigs + (size_t)r0 * p.K, p.K, a_rows, lay.vec_a, p.nbp, lane0, tid, warp,
                     lane);
  if (p.Kr > 0)
    wide_segment_mma(acc, ones_m, rawring, sB, w1, sA, rand8, p.Kr_pad, lay.vec_rb,
                     bigr + (size_t)r0 * p.Kr_pad, p.Kr_pad, a_rows, lay.vec_r, p.nbp, lane0, tid,
                     warp, lane);
  // every thread of a lane quad's column (lane & 3) holds part of its sums
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) ones_m[x] += __shfl_xor_sync(0xFFFFFFFFu, ones_m[x], m);

  // spill this slice's rows (the segments ended with a barrier): c0/c1 at
  // row g, c2/c3 at row g + 8 of each m16 tile; the ones row after them
  int32_t* sOnes = sAcc + kWideRows * kT;
  if (tid < kT) sOnes[tid] = 0;
  __syncthreads();
  const int rows = min(per_slice, p.n - i0) * L8;
  {
    const int g = lane >> 2, t = lane & 3;
    const int row0 = (warp >> 2) * 128 + (warp & 3) * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kWideNT; ++j) {
        const int r = row0 + 64 * i + g, col = 8 * j + 2 * t;
        if (r < rows) {
          sAcc[r * kT + col] = acc[i][j][0];
          sAcc[r * kT + col + 1] = acc[i][j][1];
        }
        if (r + 8 < rows) {
          sAcc[(r + 8) * kT + col] = acc[i][j][2];
          sAcc[(r + 8) * kT + col + 1] = acc[i][j][3];
        }
      }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (g == 0) atomicAdd(sOnes + warp * 16 + 4 * t + x, ones_m[x]);
      atomicAdd(sOnes + 4 * lane + x, ones_w[x]);
    }
  }
  __syncthreads();
  // epilogue: two threads per lane. Below 2^32, with chains of at most 8
  // bytes, the column value v is a uint64 and its residue v mod p, the
  // canonical result every fold reaches, is taken at once: the byte folds
  // cost 1.9 ms a launch of 128 participants at 728 clerks a lane.
  const int ll = tid % kT, half = tid / kT, gl = lane0 + ll;
  const uint32_t* c1 = tables + p.off_c1;
  const uint32_t* pl = tables + p.off_p;
  const uint32_t s128 = (uint32_t)sOnes[ll] * 128u;
  const bool narrow = p.L <= 2 && L8 + p.n_res1 <= 8;
  const uint64_t pm = pl[0] | (p.L > 1 ? (uint64_t)pl[1] << 16 : 0);
  uint32_t bytes[kMaxB];
  for (int i = half; i * L8 < rows; i += kThreads / kT) {
    if (narrow) {
      uint64_t v = 0;
      uint32_t carry = 0;
      for (int c = 0; c < L8; ++c) {
        const uint32_t t =
            (uint32_t)sAcc[(i * L8 + c) * kT + ll] + c1[(i0 + i) * L8 + c] + s128 + carry;
        v |= (uint64_t)(t & 0xFFu) << (8 * c);
        carry = t >> 8;
      }
      if (gl >= p.nbp) continue;
      uint64_t r = (v + ((uint64_t)carry << (8 * L8))) % pm;
      int32_t* o = out + (size_t)(i0 + i) * p.nbp + gl;  // limb l at o + l * n * nbp
      const size_t limb = (size_t)p.n * p.nbp;
      if (accumulate) {
        r += (uint32_t)o[0] | (p.L > 1 ? (uint64_t)(uint32_t)o[limb] << 16 : 0);
        if (r >= pm) r -= pm;
      }
      o[0] = (int32_t)(r & 0xFFFFu);
      if (p.L > 1) o[limb] = (int32_t)(r >> 16);
      continue;
    }
    uint32_t carry = 0;
    for (int c = 0; c < L8; ++c) {
      const uint32_t t =
          (uint32_t)sAcc[(i * L8 + c) * kT + ll] + c1[(i0 + i) * L8 + c] + s128 + carry;
      bytes[c] = t & 0xFFu;
      carry = t >> 8;
    }
    for (int r = 0; r < p.n_res1; ++r) {
      bytes[L8 + r] = carry & 0xFFu;
      carry >>= 8;
    }
    if (gl >= p.nbp) continue;
    if (accumulate)
      fold_and_emit<kAcc>(bytes, L8 + p.n_res1, p, tables, out, nullptr, p.n, i0 + i, ll, gl,
                          true, true);
    else
      fold_and_store(bytes, L8 + p.n_res1, p, tables, out, p.n, i0 + i, gl);
  }
  __syncthreads();  // the next lane block's copies land where sAcc lies
}


// Block (slice blockIdx.x, group blockIdx.y) takes the lane blocks
// blockIdx.y, + gridDim.y, ... in turn (the grid fills the SMs once, so
// that the slices of a lane block run side by side and share its sec tiles
// in L2): for each, stage 1 for its clerks' rows through the segments, then
// B1's carry chains and fold; with `accumulate` (B3) the canonical limbs
// are added mod p onto out.
template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
mxu8_wide_kernel(const int8_t* __restrict__ sec, const int8_t* __restrict__ bigs,
                 const int8_t* __restrict__ bigr, const int8_t* __restrict__ rand8,
                 const uint32_t* __restrict__ tables, int32_t* __restrict__ out, Params p,
                 WideLayout lay, int accumulate) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* w1 = reinterpret_cast<int8_t*>(smem + lay.smem - kKT);  // kKT ones, past the epilogue's

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L8 = p.L8, per_slice = kWideRows / L8;
  const int i0 = blockIdx.x * per_slice, r0 = i0 * L8;
  const int a_rows = min(kWideRows, p.n_pad - r0);
  if (tid < kKT / 4) reinterpret_cast<uint32_t*>(w1)[tid] = 0x01010101u;
  for (int lb = blockIdx.y; lb * kT < p.nbp; lb += gridDim.y)
    wide_lane_block<RESIDENT>(sec, bigs, bigr, rand8, tables, out, p, lay, accumulate, smem, w1,
                              lb * kT, i0, r0, a_rows, tid, warp, lane);
}

// PRNG mode of a wide launch: the randomness operand of every lane into
// rand8 ([Kr_pad][nbp], biased bytes in bigR's (c, parity, w) row order).
// Thread (lane gl, word group blockIdx.y) sums its rp draws as B1 does
// (accR, accO per PRNG word, the same Philox counters), then writes the
// bytes of accE = accR - (accO << 16) and accO; rows [Kr, Kr_pad), bigR's
// zero columns, are written zero.
__global__ void __launch_bounds__(kT)
mxu8_wide_rand_kernel(int8_t* __restrict__ rand8, Params p) {
  const int gl = blockIdx.x * kT + threadIdx.x, g = blockIdx.y;
  if (gl >= p.nbp) return;
  uint32_t accR[4] = {0, 0, 0, 0}, accO[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int j = 0; j < p.rp; ++j) {
    uint32_t c[4] = {(uint32_t)gl, (uint32_t)j, (uint32_t)g, 0u};
    philox4x32_10(c, p.seed, 0u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      accR[q] += c[q];
      accO[q] += c[q] >> 16;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int w = 4 * g + q;
    if (w >= p.wpp) break;
    // accR = sum(lo) + 2^16 sum(hi) mod 2^32 and sum(lo) < 2^32: exact
    const uint32_t accE = accR[q] - (accO[q] << 16);
    for (int cb = 0; cb < p.n_bytes; ++cb) {
      rand8[(size_t)((2 * cb) * p.wpp + w) * p.nbp + gl] = (int8_t)(byte_of(accE, cb) ^ 0x80u);
      rand8[(size_t)((2 * cb + 1) * p.wpp + w) * p.nbp + gl] =
          (int8_t)(byte_of(accO[q], cb) ^ 0x80u);
    }
  }
  if (g == 0)
    for (int r = p.Kr; r < p.Kr_pad; ++r) rand8[(size_t)r * p.nbp + gl] = 0;
}

template <bool RESIDENT>
int run_wide(dim3 grid, const int8_t* sec, const int8_t* bigs, const int8_t* bigr,
             const int8_t* rand8, const uint32_t* tables, int32_t* out, const Params& p,
             const WideLayout& lay, int accumulate, cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(
      mxu8_wide_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
  if (err) return err;
  mxu8_wide_kernel<RESIDENT><<<grid, kThreads, lay.smem, stream>>>(sec, bigs, bigr, rand8, tables,
                                                                   out, p, lay, accumulate);
  return (int)cudaGetLastError();
}

// Mode 3's launch: the randomness kernel (PRNG mode), then the wide kernel
// on (slices, lane blocks); period is sec's rows a participant.
int launch_wide(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, int8_t* rand8,
                const uint32_t* tables, int32_t* out, const Params& p, int period,
                int accumulate, cudaStream_t stream) {
  if (p.n2 || p.n_chunks != 1 || (p.Kr > 0 && !rand8)) return (int)cudaErrorInvalidValue;
  const WideLayout lay = wide_layout(p, period, sec, bigs, bigr, rand8);
  if (lay.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int lane_blocks = (p.nbp + kT - 1) / kT, per_slice = kWideRows / p.L8;
  if (p.Kr > 0) {
    mxu8_wide_rand_kernel<<<dim3(lane_blocks, (p.wpp + 3) / 4), kT, 0, stream>>>(rand8, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  // the grid fills the SMs once: every slice, and as many groups of lane
  // blocks as leave one block an SM
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int slices = (p.n + per_slice - 1) / per_slice;
  const dim3 grid(slices, min(lane_blocks, max_of(1, sms / slices)));
  return lay.resident
             ? run_wide<true>(grid, sec, bigs, bigr, rand8, tables, out, p, lay, accumulate, stream)
             : run_wide<false>(grid, sec, bigs, bigr, rand8, tables, out, p, lay, accumulate,
                               stream);
}

#endif  // SDA_MXU8_MODE == 3

// Raise a kernel's dynamic shared memory limit to lay.smem.
template <typename Kernel>
int set_smem(Kernel kernel, const Layout& lay) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
}

template <int MT>
int launch(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, const int8_t* big2,
           const uint32_t* tables, int32_t* out, const Params& p, cudaStream_t stream) {
  const Layout lay = make_layout<MT>(p, sec, bigs);
  const int err = set_smem(mxu8_fused_kernel<MT, kMode>, lay);
  if (err) return err;
  const dim3 grid((p.nbp + kT - 1) / kT);
  mxu8_fused_kernel<MT, kMode><<<grid, kThreads, lay.smem, stream>>>(sec, bigs, bigr, big2, tables,
                                                                     out, p, lay);
  return (int)cudaGetLastError();
}

// B2: zero the workspace, then the split kernel (lane_blocks x splits
// blocks) and the epilogue kernel (lane_blocks blocks), in stream order.
template <int MT>
int launch_chunked(const int8_t* sec, const int8_t* bigs, const int8_t* bigr, const int8_t* big2,
                   const uint32_t* tables, int32_t* ws, int32_t* out, const Params& p, int splits,
                   cudaStream_t stream) {
  const Layout ls = split_layout<MT>(p, sec, bigs), le = epilogue_layout<MT>(p);
  int err = set_smem(mxu8_split_kernel<MT>, ls);
  if (!err) err = set_smem(mxu8_epilogue_kernel<MT>, le);
  if (!err)
    err = (int)cudaMemsetAsync(ws, 0, sizeof(int32_t) * p.n_chunks * ws_rows(p) *
                                          (size_t)ws_pitch(p), stream);
  if (err) return err;
  const int lane_blocks = (p.nbp + kT - 1) / kT;
  mxu8_split_kernel<MT><<<lane_blocks * splits, kThreads, ls.smem, stream>>>(sec, bigs, ws, p, ls,
                                                                            splits);
  err = (int)cudaGetLastError();
  if (err) return err;
  mxu8_epilogue_kernel<MT><<<lane_blocks, kThreads, le.smem, stream>>>(ws, bigr, big2, tables, out,
                                                                      p, le);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int occupancy_of(Kernel kernel, const Layout& lay, int* smem_bytes, int* blocks_per_sm) {
  const int err = set_smem(kernel, lay);
  if (err) return err;
  *smem_bytes = lay.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                            lay.smem);
}

// Dynamic shared memory per block and resident blocks per SM of the launch;
// for B2, of its split kernel (epilogue = 0) or its epilogue kernel (1).
template <int MT>
int occupancy(const Params& p, int epilogue, int* smem_bytes, int* blocks_per_sm) {
  if constexpr (kMode == kChunked) {
    if (epilogue)
      return occupancy_of(mxu8_epilogue_kernel<MT>, epilogue_layout<MT>(p), smem_bytes,
                          blocks_per_sm);
    return occupancy_of(mxu8_split_kernel<MT>, split_layout<MT>(p, nullptr, nullptr), smem_bytes,
                        blocks_per_sm);
  } else {
    if (epilogue) return (int)cudaErrorInvalidValue;
    return occupancy_of(mxu8_fused_kernel<MT, kMode>, make_layout<MT>(p, nullptr, nullptr),
                        smem_bytes, blocks_per_sm);
  }
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

#if SDA_MXU8_MODE == 3
// C entry point of B1 and B3 on wide plans (SDA_MXU8_MODE 3): the
// arguments of sda_mxu8_fused, plus rand8, an int8 [Kr_pad][nbp] scratch
// operand that PRNG mode fills (unused, and may be null, with caller
// randomness), period, sec's rows a participant, and accumulate (B3: out
// holds the running sums on entry). Returns a cudaError_t.
extern "C" int sda_mxu8_wide(const void* sec, const void* bigs, const void* bigr, void* rand8,
                             const void* tables, void* out, const void* iparams, int n_iparams,
                             int period, int accumulate, void* stream) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  return launch_wide(static_cast<const int8_t*>(sec), static_cast<const int8_t*>(bigs),
                     static_cast<const int8_t*>(bigr), static_cast<int8_t*>(rand8),
                     static_cast<const uint32_t*>(tables), static_cast<int32_t*>(out), p, period,
                     accumulate, static_cast<cudaStream_t>(stream));
}

#elif SDA_MXU8_MODE != 2
// C entry point of B1 and B3 (SDA_MXU8_MODE 0 and 1). iparams holds the
// kNParams ints of Params in field order (seed and seed_stride as their
// 32-bit patterns). For B3, out holds the running sums on entry. Returns a
// cudaError_t (0 on success).
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
#else
// C entry point of B2 (SDA_MXU8_MODE 2): the same arguments as
// sda_mxu8_fused, plus ws, an int32 workspace of n_chunks * (n * L8 + 1 +
// 2 * wpp) * pitch words (wpp: 0 without in-kernel randomness; pitch: nbp
// rounded up to 4), 16-byte aligned, that the call zeroes and fills, and
// splits >= 1, the split count S of every lane block's work. Returns a
// cudaError_t (0 on success).
extern "C" int sda_mxu8_chunked(const void* sec, const void* bigs, const void* bigr,
                                const void* big2, const void* tables, void* ws, void* out,
                                const void* iparams, int n_iparams, int splits, void* stream) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const int8_t*>(sec);
  const auto* a = static_cast<const int8_t*>(bigs);
  const auto* r = static_cast<const int8_t*>(bigr);
  const auto* b2 = static_cast<const int8_t*>(big2);
  const auto* tb = static_cast<const uint32_t*>(tables);
  auto* w = static_cast<int32_t*>(ws);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return with_mt(p, [&](auto mt) {
    return launch_chunked<decltype(mt)::value>(s, a, r, b2, tb, w, o, p, splits, st);
  });
}
#endif

#if SDA_MXU8_MODE != 3
// The launch configuration the entry point would use for these parameters:
// dynamic shared memory per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); for B2 of its split
// kernel (epilogue = 0) or its epilogue kernel (epilogue = 1). Returns a
// cudaError_t.
extern "C" int sda_mxu8_occupancy(const void* iparams, int n_iparams, int epilogue,
                                  int* smem_bytes, int* blocks_per_sm) {
  Params p;
  const int bad = parse_params(iparams, n_iparams, p);
  if (bad) return bad;
  return with_mt(p, [&](auto mt) {
    return occupancy<decltype(mt)::value>(p, epilogue, smem_bytes, blocks_per_sm);
  });
}
#endif
