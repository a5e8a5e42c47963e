// Device code shared by the port's kernels (each .cu file is its own build
// and includes this header): the Philox4x32-10 generator, 16-bit-limb
// Montgomery arithmetic, and the int8 tensor-core pipeline of the fused
// kernels (mxu8.cu, mxu7.cu): the cp.async ring that streams the sec
// operand's K loop (its A-matrix copy also stages mxu7.cu's bigR tiles),
// plain-load staging of mxu8.cu's bigR tiles, and
// mma.sync.m16n8k32.s32.s8.s8.s32 over those tiles.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sda {

// ----------------------------------------------------------------- Philox

// Philox4x32-10 (Salmon et al., SC'11): c is the counter on entry and the
// four output words on return; (k0, k1) the key.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// ------------------------------------------------------- limb arithmetic

constexpr int kMaxL = 8;  // 16-bit limbs per element (128-bit moduli)

// Subtract p if (carry, s) >= p (s: L lanes of 16 bits).
__device__ inline void cond_sub(uint32_t* s, uint32_t carry, const uint32_t* pl, int L) {
  uint32_t d[kMaxL];
  uint32_t borrow = 0;
  for (int j = 0; j < L; ++j) {
    const uint32_t t = s[j] - pl[j] - borrow;
    d[j] = t & 0xFFFFu;
    borrow = (t >> 16) & 1u;
  }
  if (carry > 0 || borrow == 0)
    for (int j = 0; j < L; ++j) s[j] = d[j];
}

__device__ inline void add_mod(uint32_t* a, const uint32_t* b, const uint32_t* pl, int L) {
  uint32_t carry = 0;
  for (int j = 0; j < L; ++j) {
    const uint32_t t = a[j] + b[j] + carry;
    a[j] = t & 0xFFFFu;
    carry = t >> 16;
  }
  cond_sub(a, carry, pl, L);
}

// CIOS Montgomery product a * b * 2^(-16L) mod p; every step fits uint32.
__device__ inline void mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                const uint32_t* pl, uint32_t p_inv_w, int L) {
  uint32_t T[kMaxL + 2];
  for (int j = 0; j < L + 2; ++j) T[j] = 0;
  for (int i = 0; i < L; ++i) {
    uint32_t c = 0, t;
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
  cond_sub(T, T[L], pl, L);
  for (int j = 0; j < L; ++j) out[j] = T[j];
}

// ------------------------------------------------- int8 MMA pipeline

constexpr int kT = 128;        // lanes per block
constexpr int kThreads = 256;  // 8 warps x 16 lanes
constexpr int kKT = 64;        // K rows per staged tile
constexpr int kSA = kKT + 16;  // sA row stride in bytes (== 16 mod 32: conflict-free fragments)

// A tile: rows [0, rows) x columns [col0, col0 + kKT) of a row-major int8
// matrix with lda columns (lda, col0 multiples of 4); zero outside.
__device__ inline void load_a_tile(int8_t* sA, const int8_t* A, int lda, int nrows, int rows,
                                   int col0, int tid) {
  constexpr int kWords = kKT / 4;
  for (int idx = tid; idx < rows * kWords; idx += kThreads) {
    const int r = idx / kWords, q = idx % kWords, col = col0 + 4 * q;
    uint32_t w = 0;
    if (r < nrows && col < lda) w = *reinterpret_cast<const uint32_t*>(A + (size_t)r * lda + col);
    *reinterpret_cast<uint32_t*>(sA + r * kSA + 4 * q) = w;
  }
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[mt][nt] += sA[mt tile] . sB[warp's nt tile], over ksteps steps of 32.
template <int MT>
__device__ __forceinline__ void mma_chunk(int (&acc)[MT][2][4], const int8_t* sA, const int8_t* sB,
                                          int sb, int boff, int ksteps, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int8_t* bp = sB + (warp * 16 + nt * 8 + g) * sb + boff + ks * 32 + 4 * t;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(bp);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* ap = sA + (mt * 16 + g) * kSA + ks * 32 + 4 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * kSA);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * kSA + 16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_s8(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
    }
  }
}

// ------------------------------------------------------ cp.async ring
//
// The K loop's staging (mxu8.cu, mxu7.cu): each ring stage holds a raw sec
// tile (kKT rows x kT lanes, lane-contiguous as in device memory) and the
// matching kKT columns of the A matrix, copied with cp.async while the
// tensor cores work on an earlier stage. Each warp transposes its own 16
// lanes of a landed raw tile into sB, so the transpose needs no block
// barrier.

constexpr int kRawBytes = kKT * kT;  // one raw sec tile, 8 KB

// cp.async of 16, 8 or 4 bytes; the bytes past src_bytes (0 or the size)
// are zero-filled and not read.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int size, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes) : "memory");
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte chunk c of raw row r lies at chunk c ^ ((r >> 2) & 7) of the row:
// a warp's transposing reads (one chunk, rows of eight k quads) then fall
// on 32 distinct banks.
__device__ __forceinline__ int raw_chunk(int r, int c) { return c ^ ((r >> 2) & 7); }

// Start the copy of rows [0, rows) x columns [col0, col0 + kKT) of a
// row-major int8 matrix with lda columns into sA (row stride kSA), and, with
// EXTRA (mxu8's ones row), of row extra_row into row `rows` of sA; zero past
// lda. VEC (16, 8 or 4) divides lda and the matrix's address.
template <int VEC, bool EXTRA = true>
__device__ __forceinline__ void ring_load_a(int8_t* sA, const int8_t* A, int lda, int rows,
                                            int extra_row, int col0, int tid) {
  constexpr int kPerRow = kKT / VEC;
  for (int idx = tid; idx < (rows + (EXTRA ? 1 : 0)) * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = idx % kPerRow, col = col0 + c * VEC;
    const bool in = col < lda;
    const int src_row = r < rows ? r : extra_row;
    cp_async(sA + r * kSA + c * VEC, in ? A + (size_t)src_row * lda + col : A, VEC, in ? VEC : 0);
  }
}

// Start the copy of sec rows [k0, k0 + kKT) x lanes [lane0, lane0 + kT) into
// the raw tile, zero past K and past nbp. VEC 16 or 4 (dividing nbp and
// sec's address) copies with cp.async; VEC 1 with plain byte loads and
// stores, which the block barrier after the wait publishes all the same.
template <int VEC>
__device__ __forceinline__ void ring_load_raw(int8_t* raw, const int8_t* sec, int K, int nbp,
                                              int k0, int lane0, int tid) {
  constexpr int kPerRow = kT / VEC;
  for (int idx = tid; idx < kKT * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = idx % kPerRow, k = k0 + r, lane = lane0 + c * VEC;
    const bool in = k < K && lane < nbp;
    int8_t* dst = raw + r * kT + 16 * raw_chunk(r, (c * VEC) >> 4) + ((c * VEC) & 15);
    if constexpr (VEC == 1)
      *dst = in ? sec[(size_t)k * nbp + lane] : (int8_t)0;
    else
      cp_async(dst, in ? sec + (size_t)k * nbp + lane : sec, VEC, in ? VEC : 0);
  }
}

// Warp `warp`'s 16 lanes of a landed raw tile into rows [16 warp, 16 warp +
// 16) of sB (row stride sb, sb / 4 == 4 mod 8), K-contiguous, with 4x4 byte
// transposes (__byte_perm). Lane quads 1 and 2 store their four rows in the
// order 2, 3, 0, 1, so that each store instruction hits 32 distinct banks.
// With ONES (mxu8's ones row), each transposed word (4 k of one lane) also
// adds its dot product with the tile's row w1 (kKT int8 weights) into
// wsum[x] of its lane 4 (lane & 3) + x; without, w1 and wsum are not read.
template <bool ONES = true>
__device__ __forceinline__ void ring_transpose_b(int8_t* sB, int sb, const int8_t* raw,
                                                 const int8_t* w1, int (&wsum)[4], int warp,
                                                 int lane) {
  const int lq = lane & 3, sw = sb / 4;
  const bool swap = ((lq ^ (lq >> 1)) & 1) != 0;
  const int x0 = swap ? 2 : 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kq = (lane >> 2) + 8 * j;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(raw + 4 * kq * kT + 16 * (warp ^ (kq & 7))) + lq;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = src[i * (kT / 4)];
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
    if constexpr (ONES) {
      const int w = *reinterpret_cast<const int*>(w1 + 4 * kq);
#pragma unroll
      for (int x = 0; x < 4; ++x) wsum[x] = __dp4a((int)o[x], w, wsum[x]);
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(sB + (warp * 16 + 4 * lq) * sb + 4 * kq);
    dst[x0 * sw] = swap ? o[2] : o[0];
    dst[(x0 + 1) * sw] = swap ? o[3] : o[1];
    dst[(x0 ^ 2) * sw] = swap ? o[0] : o[2];
    dst[((x0 ^ 2) + 1) * sw] = swap ? o[1] : o[3];
  }
}

}  // namespace sda
